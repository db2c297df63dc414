"""Sharded trial execution: one experiment's waves fanned across backends;
the counterpart of ``repro.service.sharded``.

``ShardedTrialExecutor`` extends the event-driven ``ClusterTrialExecutor``
with a backend-per-node-group model: every shard is a registered backend
(or a backend instance) with a node capacity, each simulated node carries
its shard's tag, and trials are bound shard-by-shard in deterministic
round-robin over submission order. The binding sticks — rung-resumed
epochs and PBT clones return to the backend that holds their state — and
results still merge in proposal order, so ``"sharded"`` with a single
backend is bit-identical to ``"serial"`` on a deterministic backend (the
regression anchor the tests assert).

Cross-shard tuning state is whatever store client the runner carries:
point PipeTune at a ``repro_torch.service.StoreClient`` and every shard's
probe results feed one ``GroundTruthService`` (in-proc or remote), which
is what makes the fan-out *share* instead of merely parallelize.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.cluster.engine import ClusterConfig
from repro_torch.cluster.executor import ClusterTrialExecutor
from repro_torch.core.schedulers import TrialProposal

__all__ = ["ShardedTrialExecutor"]

BackendsSpec = Union[None, Dict[str, Any], Sequence[Union[str, tuple]]]


def _resolve_backends(backends: BackendsSpec) -> List[Tuple[str, Any]]:
    """Normalize a backends spec to ordered ``(tag, backend)`` pairs.

    Accepts a dict ``{tag: backend}``, a sequence of registry names and/or
    ``(tag, backend)`` tuples, or None (one anonymous shard running on the
    runner's own backend). Duplicate names get ``#i`` suffixes so each
    shard keeps a distinct node tag.
    """
    if backends is None:
        return [("default", None)]
    if isinstance(backends, dict):
        pairs = list(backends.items())
    else:
        pairs = []
        for item in backends:
            if isinstance(item, str):
                # lazy import: registry itself registers this executor
                from repro_torch.api.registry import make_backend
                pairs.append((item, make_backend(item)))
            else:
                tag, be = item
                pairs.append((str(tag), be))
    seen: Dict[str, int] = {}
    out = []
    for tag, be in pairs:
        n = seen.get(tag, 0)
        seen[tag] = n + 1
        out.append((f"{tag}#{n}" if n else tag, be))
    return out


class ShardedTrialExecutor(ClusterTrialExecutor):
    """Fan one experiment's waves across several backends (see module doc).

    ``backends``: dict ``{tag: backend}``, sequence of registry names /
    ``(tag, backend)`` pairs, or None for a single shard on the runner's
    own backend. ``capacity``: simulated nodes per shard — an int for all,
    or ``{tag: int}``. Fault/timing knobs (``straggler_prob``, ``seed``,
    ...) pass through to ``ClusterConfig``.
    """

    def __init__(self, backends: BackendsSpec = None,
                 capacity: Union[int, Dict[str, int]] = 1,
                 default_sys: Optional[dict] = None, **cfg_kw):
        for reserved in ("n_nodes", "node_tags"):
            if reserved in cfg_kw:
                raise ValueError(f"{reserved} is derived from backends/"
                                 "capacity; pass those instead")
        shards = _resolve_backends(backends)
        if not shards:
            raise ValueError("need at least one backend shard")
        self._shards: Dict[str, Any] = dict(shards)
        self._order: List[str] = [tag for tag, _ in shards]

        def cap(tag: str) -> int:
            c = capacity.get(tag, 1) if isinstance(capacity, dict) \
                else int(capacity)
            if c < 1:
                raise ValueError(f"shard {tag!r} capacity must be >= 1")
            return c

        tags: List[str] = []
        for tag in self._order:
            tags.extend([tag] * cap(tag))
        cfg = ClusterConfig(n_nodes=len(tags), node_tags=tuple(tags),
                            **cfg_kw)
        super().__init__(cluster=cfg, default_sys=default_sys)
        self._bindings: Dict[str, str] = {}     # trial_id -> shard tag
        self._next_shard = 0

    # ------------------------------------------------------------ placement
    def _placement(self, runner, p: TrialProposal):
        tag = self._bindings.get(p.trial_id)
        if tag is None and p.clone_from is not None:
            # a PBT clone inherits its source's state, which lives on the
            # source's backend
            tag = self._bindings.get(p.clone_from)
        if tag is None:
            tag = self._order[self._next_shard % len(self._order)]
            self._next_shard += 1
        self._bindings[p.trial_id] = tag
        return tag, self._shards[tag]

    @property
    def shard_tags(self) -> List[str]:
        return list(self._order)

    def shard_of(self, trial_id: str) -> Optional[str]:
        return self._bindings.get(trial_id)
