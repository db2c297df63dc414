"""Checkpoint manager: the counterpart of ``repro.checkpoint.manager``, in
the reference's on-disk format, so that a train state saved by either
package restores in the other.

The format:
  * ``step_{step:010d}/`` holds ``leaf_{i:05d}.npy`` per leaf (``np.save``,
    ``allow_pickle=False``, C order), ``manifest.json`` (per leaf: index,
    path, file, dtype, shape, sha256 of the file) and, when given,
    ``metadata.json`` (written through ``metadata.json.tmp``);
  * leaves are numbered in JAX's flatten order: dict keys sorted, lists by
    index, the path the keys joined with "/" (``params/layers/attn/wq``).
    The port's trees keep insertion order, so this module flattens them
    itself; on load each manifest path is checked against the target's;
  * a Python int leaf (the train step) is a 0-d int32 array, as the
    reference's ``jnp.zeros((), jnp.int32)``, and restores as an int;
  * a bf16 leaf is written as ``ml_dtypes`` writes it, raw 2-byte records
    (``'<V2'``) under manifest dtype ``"bfloat16"``, and read back through
    that dtype (no ``ml_dtypes`` needed). The reference's own
    ``load_pytree`` cannot read such a leaf (ROADMAP.md §C).

As in the reference: writes are atomic (``<dir>.tmp``, then
``os.replace``), one writer thread drains a queue and its errors are raised
again on ``wait()``, restore checks every leaf's sha256, and keep-N
retention removes the oldest steps. Unlike it, a checkpoint's leaves are
written, hashed (from memory, as they are written) and read on
``_IO_WORKERS`` threads, each file read once.

The port's train step updates parameters and adamw's moments in place, so
``CheckpointManager.save`` copies the tree to host memory before it
returns (synchronous device-to-host copies); the writer thread only ever
sees that copy. ``placements`` (``repro_torch.distributed.sharding.named``)
restore every leaf straight onto a device mesh: the counterpart of the
reference's ``shardings=``.
"""
from __future__ import annotations

import hashlib
import io
import json
import math
import os
import queue
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import device as device_lib

_BF16 = "bfloat16"
# Leaves are written and read (sha256 included) on this many threads:
# hashing runs at about 1.2 GB/s a core on the card's host, which has 8.
_IO_WORKERS = 4
# a version 1.0 .npy header is at most 65535 bytes after its 10-byte prefix
_NPY_HEADER_MAX = 65545


def leaves_with_paths(tree, path: Tuple[str, ...] = ()
                      ) -> Iterator[Tuple[str, Any]]:
    """(path, leaf) in JAX's flatten order: dict keys sorted, list items by
    index; a path is the keys and indices joined with "/"."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_paths(tree[k], path + (str(k),))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaves_with_paths(v, path + (str(i),))
    else:
        yield "/".join(path), tree


def _rebuild(like, leaves: Dict[str, Any], path: Tuple[str, ...] = ()):
    """``like``'s structure (its own key order) with the leaves by path."""
    if isinstance(like, dict):
        return {k: _rebuild(v, leaves, path + (str(k),))
                for k, v in like.items()}
    if isinstance(like, list):
        return [_rebuild(v, leaves, path + (str(i),))
                for i, v in enumerate(like)]
    return leaves["/".join(path)]


def _snapshot(leaf):
    """A host copy of one leaf that later in-place updates cannot reach."""
    if isinstance(leaf, torch.Tensor):
        out = torch.empty(leaf.shape, dtype=leaf.dtype, device="cpu")
        return out.copy_(leaf.detach())
    return leaf


def _pool_map(fn, items) -> list:
    """``fn`` over ``items`` on ``_IO_WORKERS`` threads, in order; the
    first exception is raised again here."""
    with ThreadPoolExecutor(_IO_WORKERS) as pool:
        return list(pool.map(fn, items))


def _as_array(path: str, leaf) -> Tuple[np.ndarray, str, str]:
    """(C-order array, .npy descr, manifest dtype) of one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "<V2", _BF16
        arr = t.numpy()
    elif isinstance(leaf, int) and not isinstance(leaf, bool):
        arr = np.asarray(leaf, np.int32)
    else:
        raise TypeError(f"{path}: a leaf must be a tensor or an int, not "
                        f"{type(leaf).__name__}")
    return arr, np.lib.format.dtype_to_descr(arr.dtype), str(arr.dtype)


def _write_leaf(fpath: str, path: str, leaf) -> Tuple[str, List[int], str]:
    """Write one leaf as ``np.save`` would; returns (manifest dtype, shape,
    sha256 of the file), hashed from memory as it is written."""
    arr, descr, dtype = _as_array(path, leaf)
    header = io.BytesIO()
    np.lib.format.write_array_header_1_0(
        header, {"descr": descr, "fortran_order": False,
                 "shape": arr.shape})
    digest = hashlib.sha256(header.getvalue())
    data = memoryview(arr).cast("B")
    digest.update(data)
    with open(fpath, "wb") as f:
        f.write(header.getvalue())
        f.write(data)
    return dtype, list(arr.shape), digest.hexdigest()


def save_pytree(tree, directory: str):
    """Atomic synchronous save of a tree of tensors and ints."""
    tmp = directory + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = list(leaves_with_paths(tree))

    def write(item):
        i, (path, leaf) = item
        return _write_leaf(os.path.join(tmp, f"leaf_{i:05d}.npy"), path,
                           leaf)
    manifest = {"leaves": [
        {"index": i, "path": path, "file": f"leaf_{i:05d}.npy",
         "dtype": dtype, "shape": shape, "sha256": digest}
        for i, ((path, _), (dtype, shape, digest)) in enumerate(
            zip(flat, _pool_map(write, enumerate(flat))))]}
    # the reference writes str(treedef), which its own load never reads
    manifest["treedef"] = "repro_torch: " + ", ".join(p for p, _ in flat)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(directory):
        shutil.rmtree(directory)
    os.replace(tmp, directory)


def _parse_npy(buf: bytearray) -> np.ndarray:
    """The array of a whole .npy file in memory, as a view of ``buf``."""
    head = io.BytesIO(bytes(memoryview(buf)[:_NPY_HEADER_MAX]))
    version = np.lib.format.read_magic(head)
    read_header = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                   else np.lib.format.read_array_header_2_0)
    shape, fortran, dtype = read_header(head)
    arr = np.frombuffer(buf, dtype=dtype, count=math.prod(shape),
                        offset=head.tell())
    return arr.reshape(shape, order="F" if fortran else "C")


def _read_leaf(fpath: str, rec: dict, target, device, verify: bool):
    """One leaf file, its digest checked, in the target's type: an int for
    an int, else a tensor of the target's dtype on ``device``."""
    with open(fpath, "rb") as f:
        buf = bytearray(os.fstat(f.fileno()).st_size)
        f.readinto(buf)
    if verify and hashlib.sha256(buf).hexdigest() != rec["sha256"]:
        raise IOError(f"digest mismatch for {rec['path']}")
    arr = _parse_npy(buf)
    shape = tuple(target.shape) if isinstance(target, torch.Tensor) else ()
    if arr.shape != shape:
        raise ValueError(f"shape mismatch for {rec['path']}: "
                         f"{arr.shape} vs {shape}")
    if not isinstance(target, torch.Tensor):
        return int(arr)
    if rec["dtype"] == _BF16:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=device, dtype=target.dtype)


def load_pytree(directory: str, like: Any, *, device=None,
                placements: Any = None, verify: bool = True):
    """Restore into the structure of ``like``: a tree of tensors and ints
    of which only the structure, dtypes and shapes are read (the live state
    or meta tensors will do, as ``jax.eval_shape`` in the reference).
    Tensors land on ``device`` (cuda unless asked, ``device.resolve``); with
    ``placements`` (a tree like ``like`` of ``sharding.named`` leaves) each
    tensor is distributed onto its mesh instead: the elastic-restore path
    (any mesh, any device count). Raises ``IOError`` on a digest mismatch,
    ``ValueError`` on a leaf count, path or shape mismatch."""
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    flat_like = list(leaves_with_paths(like))
    if len(manifest["leaves"]) != len(flat_like):
        raise ValueError(
            f"checkpoint has {len(manifest['leaves'])} leaves, target "
            f"structure has {len(flat_like)}")
    for rec, (path, _) in zip(manifest["leaves"], flat_like):
        if rec["path"] != path:
            raise ValueError(f"leaf {rec['index']} is {rec['path']} in the "
                             f"checkpoint, {path} in the target")
    dev = "cpu" if placements is not None else device_lib.resolve(device)

    def read(item):
        rec, (_, target) = item
        return _read_leaf(os.path.join(directory, rec["file"]), rec, target,
                          dev, verify)
    leaves = dict(zip((p for p, _ in flat_like),
                      _pool_map(read, zip(manifest["leaves"], flat_like))))
    if placements is not None:
        for path, place in leaves_with_paths(placements):
            if isinstance(leaves[path], torch.Tensor):
                leaves[path] = place.distribute(leaves[path])
    return _rebuild(like, leaves)


class CheckpointManager:
    def __init__(self, root: str, keep: int = 3, async_writes: bool = True):
        self.root = root
        self.keep = keep
        os.makedirs(root, exist_ok=True)
        self._queue: "queue.Queue" = queue.Queue()
        self._async = async_writes
        self._errors: List[BaseException] = []
        if async_writes:
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()

    # ----------------------------------------------------------------- paths
    def _dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:010d}")

    def steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.root):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree, metadata: Optional[dict] = None,
             blocking: bool = False):
        """Queue (or, with ``blocking``, write) ``tree`` as step ``step``.
        The host copy is finished before this returns, so the caller may
        update the tree's tensors in place at once."""
        flat = list(leaves_with_paths(tree))
        host_tree = _rebuild(tree, dict(zip(
            (p for p, _ in flat),
            _pool_map(_snapshot, (leaf for _, leaf in flat)))))
        if self._async and not blocking:
            self._queue.put((step, host_tree, metadata))
        else:
            self._write(step, host_tree, metadata)

    def _worker(self):
        while True:
            item = self._queue.get()
            try:
                self._write(*item)
            except Exception as e:   # raised again by wait()
                self._errors.append(e)
            finally:
                self._queue.task_done()

    def _write(self, step: int, tree, metadata):
        d = self._dir(step)
        save_pytree(tree, d)
        if metadata is not None:
            tmp = os.path.join(d, "metadata.json.tmp")
            with open(tmp, "w") as f:
                json.dump(metadata, f)
            os.replace(tmp, os.path.join(d, "metadata.json"))
        self._gc()

    def _gc(self):
        steps = self.steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self._dir(s), ignore_errors=True)

    def wait(self):
        """Drain pending async writes; re-raise any writer error."""
        self._queue.join()
        if self._errors:
            raise self._errors[0]

    # --------------------------------------------------------------- restore
    def restore(self, like, step: Optional[int] = None, *, device=None,
                placements=None):
        """(tree, metadata) of ``step`` (default the latest), or (None,
        None) when there is no checkpoint; ``device`` and ``placements`` as
        in ``load_pytree``."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None, None
        d = self._dir(step)
        tree = load_pytree(d, like, device=device, placements=placements)
        meta = None
        mpath = os.path.join(d, "metadata.json")
        if os.path.exists(mpath):
            with open(mpath) as f:
                meta = json.load(f)
        return tree, meta

