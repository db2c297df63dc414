"""The stores of ``repro.core.groundtruth``: the kernel find-db
(``KernelConfigDB``, the golden table ``export_golden``/``load_golden``)
and PipeTune's ground-truth store (``GroundTruth``).

The golden JSON is the reference's format byte for byte
(``repro.kernel-golden/1``, ``json.dump(..., indent=1, sort_keys=True)``),
so a table written by either package loads in the other: it is the state
the kernel tuner carries across, as ``weights.from_jax`` is for the models.

The ground-truth store of PipeTune (paper §5.4) is copied too: ``KMeans``
(kmeans++ init + Lloyd iterations, fixed seeds), ``CentroidModel`` and
``GroundTruth``. The similarity threshold follows the paper: the distance
of a new profile to its nearest centroid is compared against the model's
inertia-derived radius; within the radius the stored optimal system config
is reused (no probing), otherwise the job is probed and the store is refit.
``save``/``load`` keep the reference's format 2, so a store saved by
either package loads in the other.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np


class KMeans:
    """kmeans++ / Lloyd. Deterministic under `seed`."""

    def __init__(self, k: int = 2, seed: int = 0, max_iter: int = 100,
                 tol: float = 1e-6):
        self.k, self.seed, self.max_iter, self.tol = k, seed, max_iter, tol
        self.centroids: Optional[np.ndarray] = None
        self.inertia_: float = float("inf")

    def _init_centroids(self, X, rng):
        n = X.shape[0]
        first = rng.randint(n)
        cents = [X[first]]
        for _ in range(1, self.k):
            d2 = np.min(
                ((X[:, None, :] - np.asarray(cents)[None]) ** 2).sum(-1), 1)
            total = d2.sum()
            if total <= 1e-12:                   # all points coincide
                cents.append(X[rng.randint(n)])
            else:
                cents.append(X[rng.choice(n, p=d2 / total)])
        return np.asarray(cents)

    def fit(self, X: np.ndarray) -> "KMeans":
        X = np.asarray(X, np.float64)
        k = min(self.k, X.shape[0])
        rng = np.random.RandomState(self.seed)
        cents = self._init_centroids(X, rng)[:k]
        for _ in range(self.max_iter):
            d2 = ((X[:, None, :] - cents[None]) ** 2).sum(-1)
            assign = d2.argmin(1)
            new = np.array([X[assign == j].mean(0) if (assign == j).any()
                            else cents[j] for j in range(k)])
            shift = np.abs(new - cents).max()
            cents = new
            if shift < self.tol:
                break
        self.centroids = cents
        d2 = ((X[:, None, :] - cents[None]) ** 2).sum(-1)
        self.labels_ = d2.argmin(1)
        self.inertia_ = float(d2.min(1).sum())
        return self

    def predict(self, x: np.ndarray) -> Tuple[int, float]:
        """(cluster, distance) for a single profile vector."""
        d2 = ((self.centroids - x[None]) ** 2).sum(-1)
        j = int(d2.argmin())
        return j, float(np.sqrt(d2[j]))


@dataclasses.dataclass
class GTEntry:
    profile: np.ndarray
    workload: str
    sys_config: dict
    objective: float


class GroundTruthError(RuntimeError):
    """A persisted ground-truth store could not be read back."""


@dataclasses.dataclass
class CentroidModel:
    """The pure, immutable lookup state of a fitted store: everything a
    ``lookup`` needs and nothing else, so it can be shipped to remote
    clients (``repro_torch.service``) and evaluated there with *identical*
    arithmetic to a server-side lookup.

    ``configs[j]`` is the best-objective member config of cluster ``j``.
    """
    version: int
    centroids: np.ndarray                   # (k, d) in normalized space
    radius: float
    configs: List[Optional[dict]]
    mu: Optional[np.ndarray] = None
    sigma: Optional[np.ndarray] = None

    def evaluate(self, profile: np.ndarray
                 ) -> Tuple[float, Optional[dict]]:
        """Same contract as ``GroundTruth.lookup`` minus the hit/miss
        bookkeeping (callers count on their side of the wire)."""
        x = np.asarray(profile, np.float64)
        if self.mu is not None:
            x = (x - self.mu) / self.sigma
        d2 = ((self.centroids - x[None]) ** 2).sum(-1)
        j = int(d2.argmin())
        dist = float(np.sqrt(d2[j]))
        r = self.radius
        if r <= 0 or dist > r or self.configs[j] is None:
            return 0.0, None
        return 1.0 - dist / r, dict(self.configs[j])

    def evaluate_many(self, profiles
                      ) -> List[Tuple[float, Optional[dict]]]:
        """Vectorized ``evaluate`` over a batch of profiles — one numpy
        pass instead of per-call dispatch overhead. Bit-identical to
        ``[self.evaluate(p) for p in profiles]``: the normalization,
        squared-distance reduction (numpy reduces the trailing axis with
        the same pairwise order whatever the leading shape), argmin,
        sqrt, and score arithmetic are the same IEEE-754 operations."""
        X = np.asarray(profiles, np.float64)
        if X.ndim == 1:
            X = X[None]
        if X.shape[0] == 0:
            return []
        if self.mu is not None:
            X = (X - self.mu) / self.sigma
        d2 = ((self.centroids[None] - X[:, None]) ** 2).sum(-1)  # (n, k)
        js = d2.argmin(1)
        dists = np.sqrt(d2[np.arange(len(js)), js])
        r = self.radius
        out: List[Tuple[float, Optional[dict]]] = []
        for j, dist in zip(js, dists):
            dist = float(dist)
            cfg = self.configs[int(j)]
            if r <= 0 or dist > r or cfg is None:
                out.append((0.0, None))
            else:
                out.append((1.0 - dist / r, dict(cfg)))
        return out

    def to_payload(self) -> dict:
        return {"version": self.version,
                "centroids": self.centroids.tolist(),
                "radius": self.radius,
                "configs": [None if c is None else dict(c)
                            for c in self.configs],
                "mu": None if self.mu is None else self.mu.tolist(),
                "sigma": None if self.sigma is None else self.sigma.tolist()}

    @classmethod
    def from_payload(cls, payload: dict) -> "CentroidModel":
        return cls(
            version=int(payload["version"]),
            centroids=np.asarray(payload["centroids"], np.float64),
            radius=float(payload["radius"]),
            configs=[None if c is None else dict(c)
                     for c in payload["configs"]],
            mu=None if payload.get("mu") is None
            else np.asarray(payload["mu"], np.float64),
            sigma=None if payload.get("sigma") is None
            else np.asarray(payload["sigma"], np.float64))


GOLDEN_FORMAT = "repro.kernel-golden/1"


class KernelConfigDB:
    """Kernel find-db: ``(kernel, shape_key, hardware_key) -> best config``.

    The MIOpen/MITuna find-db story for the port's own CUDA kernels: a tuner
    measures kernel variants once per workload shape, the winning config is
    persisted here, and every later call resolves it with a plain dict read
    (``lookup_or_default`` — never a trial, never a network round-trip).
    Pure store, no policy: stdlib only.

    ``hardware="any"`` entries are wildcard fallbacks: an exact hardware
    match wins, then ``"any"``, then the caller's default. Rows are plain
    JSON-able dicts (``{kernel, shape, hardware, config, objective}``) so
    they ride the wire codecs and the golden export format unchanged.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: Dict[Tuple[str, str, str], dict] = {}

    @staticmethod
    def _row(kernel: str, shape: str, hardware: str, config: dict,
             objective: Optional[float]) -> dict:
        return {"kernel": str(kernel), "shape": str(shape),
                "hardware": str(hardware), "config": dict(config),
                "objective": None if objective is None else float(objective)}

    def put(self, kernel: str, shape: str, config: dict, *,
            hardware: str = "any",
            objective: Optional[float] = None) -> None:
        row = self._row(kernel, shape, hardware, config, objective)
        with self._lock:
            self._entries[(row["kernel"], row["shape"],
                           row["hardware"])] = row

    def get(self, kernel: str, shape: str,
            hardware: str = "any") -> Optional[dict]:
        """Best-known config or None. Exact hardware match wins over the
        ``"any"`` wildcard; a miss is just None (callers fall back to their
        built-in defaults — a cold db never blocks anything)."""
        with self._lock:
            row = self._entries.get((str(kernel), str(shape), str(hardware)))
            if row is None and hardware != "any":
                row = self._entries.get((str(kernel), str(shape), "any"))
        return None if row is None else dict(row["config"])

    def lookup_or_default(self, kernel: str, shape: str, default: dict,
                          hardware: str = "any") -> dict:
        """``default`` overlaid with any tuned entry — the kernel-call fast
        path. Always returns a complete config, immediately."""
        cfg = self.get(kernel, shape, hardware)
        merged = dict(default)
        if cfg:
            merged.update(cfg)
        return merged

    def rows(self) -> List[dict]:
        """Every entry as a JSON-able row, in a stable (sorted-key) order."""
        with self._lock:
            items = sorted(self._entries.items())
        return [dict(row, config=dict(row["config"])) for _, row in items]

    def merge_rows(self, rows) -> int:
        """Bulk-apply rows (golden import / journal replay); returns the
        number applied. Later rows win on key collision, matching replay
        order semantics."""
        n = 0
        for row in rows:
            self.put(row["kernel"], row["shape"], dict(row["config"]),
                     hardware=row.get("hardware", "any"),
                     objective=row.get("objective"))
            n += 1
        return n

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


def export_golden(rows: List[dict], path: str) -> int:
    """Write a golden config table (MITuna's shippable known-good db).
    Atomic replace; returns the row count."""
    payload = {"format": GOLDEN_FORMAT, "entries": list(rows)}
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return len(payload["entries"])


def load_golden(path: str) -> List[dict]:
    """Read a golden config table back; hard error on anything malformed
    (shipping a truncated golden table would silently untune a fleet)."""
    try:
        with open(path) as f:
            payload = json.load(f)
        if not isinstance(payload, dict) or \
                payload.get("format") != GOLDEN_FORMAT:
            raise ValueError(
                f"not a {GOLDEN_FORMAT} file "
                f"(format={payload.get('format')!r})"
                if isinstance(payload, dict) else
                f"unexpected top-level {type(payload).__name__}")
        rows = []
        for i, row in enumerate(payload["entries"]):
            rows.append(KernelConfigDB._row(
                row["kernel"], row["shape"], row.get("hardware", "any"),
                row["config"], row.get("objective")))
        return rows
    except (OSError, ValueError, KeyError, TypeError) as e:
        raise GroundTruthError(
            f"corrupt kernel golden table at {path!r} ({e}); re-export it "
            "with `python -m repro_torch.kernels.tune export`") from None


class GroundTruth:
    """Profile -> known-optimal system config, privacy-preserving (§5.5):
    only low-level profile vectors are stored, never model/dataset identity
    (the `workload` tag is an opaque id used for evaluation bookkeeping)."""

    def __init__(self, k: int = 2, seed: int = 0, radius_factor: float = 1.5,
                 min_radius: float = 8.0, min_sigma: float = 0.1,
                 path: Optional[str] = None):
        self.k, self.seed = k, seed
        self.radius_factor = radius_factor
        # floors keep small stores usable: profile events are log1p-compressed
        # so min_sigma=0.1 ~= 10% jitter tolerance per event; min_radius ~=
        # sqrt(58 dims) z-units accepts same-workload jitter while different
        # workload types sit hundreds of z-units away
        self.min_radius = min_radius
        self.min_sigma = min_sigma
        self.entries: List[GTEntry] = []
        self.kmeans: Optional[KMeans] = None
        self._mu = None
        self._sigma = None
        self.path = path
        self.hits = 0
        self.misses = 0
        self.version = 0                 # bumped on every refit (monotonic)
        self._model: Optional[CentroidModel] = None
        if path and os.path.exists(path):
            self.load(path)

    # --------------------------------------------------------- normalization
    def _normalize(self, X):
        if self._mu is None:
            return X
        return (X - self._mu) / self._sigma

    def _fit_kmeans(self) -> Optional[KMeans]:
        """Fit on the current entries under the *current* normalization
        (load() restores a saved mu/sigma and must not recompute them)."""
        if not self.entries:
            return None
        X = np.stack([e.profile for e in self.entries])
        Xn = self._normalize(X)
        k = min(max(1, self.k), len(self.entries))
        return KMeans(k=k, seed=self.seed).fit(Xn)

    def _bump(self):
        self.version += 1
        self._model = None

    def refit(self):
        if not self.entries:
            self.kmeans = None
        else:
            X = np.stack([e.profile for e in self.entries])
            self._mu = X.mean(0)
            self._sigma = np.maximum(X.std(0), self.min_sigma)
            self.kmeans = self._fit_kmeans()
        self._bump()

    # --------------------------------------------------------------- queries
    @property
    def radius(self) -> float:
        """Mean within-cluster distance, scaled — the paper's inertia-based
        reliability threshold."""
        if self.kmeans is None or not self.entries:
            return 0.0
        mean_d2 = self.kmeans.inertia_ / max(1, len(self.entries))
        return max(self.radius_factor * float(np.sqrt(mean_d2)),
                   self.min_radius)

    def centroid_model(self) -> Optional[CentroidModel]:
        """The pure lookup state at the current version (None while unfit).
        Rebuilt lazily after each refit; remote clients cache the payload and
        re-fetch only when the version bumps."""
        if self.kmeans is None or not self.entries:
            return None
        if self._model is None:
            labels = self.kmeans.labels_
            # entries appended with refit=False since the last fit have no
            # label yet: they are invisible until the next refit (len(labels)
            # is the fitted prefix — add() only ever appends)
            n_fit = min(len(labels), len(self.entries))
            configs: List[Optional[dict]] = []
            for j in range(len(self.kmeans.centroids)):
                members = [self.entries[i] for i in range(n_fit)
                           if labels[i] == j]
                best = max(members, key=lambda e: e.objective, default=None)
                configs.append(dict(best.sys_config) if best else None)
            self._model = CentroidModel(
                version=self.version, centroids=self.kmeans.centroids,
                radius=self.radius, configs=configs,
                mu=self._mu, sigma=self._sigma)
        return self._model

    def lookup(self, profile: np.ndarray) -> Tuple[float, Optional[dict]]:
        """Returns (similarity score in [0,1], config or None).

        score > 0 iff the profile sits within the cluster radius; the config
        returned is the best-objective entry of the matched cluster.
        """
        model = self.centroid_model()
        score, cfg = (0.0, None) if model is None else model.evaluate(profile)
        if cfg is None:
            self.misses += 1
        else:
            self.hits += 1
        return score, cfg

    def add(self, profile: np.ndarray, workload: str, sys_config: dict,
            objective: float, refit: bool = True):
        self.entries.append(GTEntry(np.asarray(profile, np.float64), workload,
                                    dict(sys_config), float(objective)))
        if refit:
            self.refit()
        if self.path:
            self.save(self.path)

    # ------------------------------------------------------------------- io
    def save(self, path: str):
        payload = {
            "format": 2,
            "entries": [{"profile": e.profile.tolist(),
                         "workload": e.workload,
                         "sys_config": e.sys_config,
                         "objective": e.objective} for e in self.entries],
            # hit-rate counters + normalization state ride along so a
            # reloaded store reports honest statistics and reproduces
            # lookups exactly without recomputing mu/sigma
            "hits": self.hits, "misses": self.misses,
            "version": self.version,
            "mu": None if self._mu is None else np.asarray(
                self._mu, np.float64).tolist(),
            "sigma": None if self._sigma is None else np.asarray(
                self._sigma, np.float64).tolist(),
        }
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)

    def load(self, path: str):
        """Restore a saved store. A corrupt/truncated file is a hard error
        (``GroundTruthError``): silently starting empty would quietly throw
        away every profiled optimum and re-probe all recurring jobs."""
        try:
            with open(path) as f:
                payload = json.load(f)
            if isinstance(payload, list):      # format-1 files: entries only
                payload = {"entries": payload}
            self.entries = [GTEntry(np.asarray(p["profile"], np.float64),
                                    p["workload"], dict(p["sys_config"]),
                                    float(p["objective"]))
                            for p in payload["entries"]]
            self.hits = int(payload.get("hits", 0))
            self.misses = int(payload.get("misses", 0))
            mu, sigma = payload.get("mu"), payload.get("sigma")
            if mu is not None and sigma is not None:
                self._mu = np.asarray(mu, np.float64)
                self._sigma = np.asarray(sigma, np.float64)
                self.kmeans = self._fit_kmeans()
                self._model = None
                self.version = int(payload.get("version", 0))
            else:
                self.refit()                   # format-1: derive everything
        except (OSError, ValueError, KeyError, TypeError,
                AttributeError) as e:
            raise GroundTruthError(
                f"corrupt ground-truth store at {path!r} ({e}); fix or "
                "delete the file to start from an empty store") from None
