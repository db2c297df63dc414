"""The model's sharded path: DTensors on a ``DeviceMesh``, each rank
computing on its own shards.

The reference states its layout as sharding constraints and lets GSPMD
place every operation. DTensor propagates placements op by op too, but for
a product it may choose to gather the activations rather than the weights
(as GSPMD may replicate the batch, ``repro/models/layers.py:109-121``). So
every product of the dense path with a weight goes through ``contract``,
which fixes the choice: a weight's FSDP dim (over the batch axes) is
gathered, its tensor-parallel dim is kept, and each rank multiplies its own
rows. The embedding and the loss keep the vocab split (``embed``,
``vocab_stats``).

``local_apply`` runs a plain function on each rank's shards and wraps the
results with their GLOBAL shapes. ``local_map`` infers a result's global
shape as the local one times the mesh dim, which is wrong for an uneven
split: K = 8 kv heads over a model dim of 16 leave ranks 8-15 with none
(``torch.chunk``'s pieces, as ``sharding.placements`` describes). Norms,
RoPE, the SwiGLU gate, decode attention, the cache writes and the
optimizer's update run shard by shard too (``rowwise``, ``rope_pieces``,
``write_row``, ``elementwise``): DTensor picks a placement strategy for
each new op by a search that costs 2-400 ms on a 2-D or 3-D mesh, and
propagating them one by one would spend a step's time there. What is left
to DTensor (residual adds, casts, the loss's reductions, the plain
attention path) meets plain tensors under implicit replication
(``replication``).

On plain tensors none of this runs: each helper (or its caller) checks
``is_dtensor`` first and takes the plain operation, so the unsharded path
is unchanged.
"""
from __future__ import annotations

import contextlib
import math
from typing import Sequence

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard


def is_dtensor(*xs) -> bool:
    return any(isinstance(x, DTensor) for x in xs)


@contextlib.contextmanager
def _implicit_replication():
    """DTensor's ``implicit_replication``, restoring the setting it found
    (the library's context clears it on exit, which ends an outer one)."""
    dispatcher = DTensor._op_dispatcher
    before = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = before


def replication(*xs):
    """Implicit replication where one of ``xs`` (tensors or trees of them)
    holds a DTensor, else a null context. Only for the forward: a plain
    tensor that an op saves for its backward is made a DTensor first
    (``replicated``), since the backward may run on another thread."""
    from repro_torch.tree import tree_leaves
    for x in xs:
        leaves = tree_leaves(x) if isinstance(x, (dict, list, tuple)) else [x]
        if is_dtensor(*leaves):
            return _implicit_replication()
    return contextlib.nullcontext()


def replicated(t: torch.Tensor, like) -> torch.Tensor:
    """``t`` (the same on every rank) as a replicated DTensor on ``like``'s
    mesh where ``like`` is a DTensor, else ``t``."""
    if not isinstance(like, DTensor):
        return t
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim,
                              run_check=False)


def placed(x: DTensor, placements: Sequence) -> DTensor:
    """``x`` redistributed to ``placements`` (itself if already there)."""
    placements = tuple(placements)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


def _contiguous_stride(shape):
    stride, acc = [], 1
    for s in reversed(shape):
        stride.append(acc)
        acc *= s
    return tuple(reversed(stride))


def wrap(local: torch.Tensor, mesh, placements, shape) -> DTensor:
    """A rank's shard as a DTensor of the given global ``shape``."""
    shape = tuple(shape)
    return DTensor.from_local(local, mesh, tuple(placements),
                              run_check=False, shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def local_apply(fn, args, placements, out_placements, out_shapes):
    """``fn`` on each rank's shards of ``args`` (DTensors, redistributed to
    ``placements`` first); its results (one tensor or a tuple) wrapped with
    ``out_placements`` and the global ``out_shapes``. Differentiable
    through ``to_local``/``from_local``: an input replicated on a mesh dim
    whose results are split there gets a partial gradient on each rank
    (its rows' or columns' share), so its gradient is ``Partial`` there."""
    mesh = args[0].device_mesh
    single = isinstance(out_shapes[0], int) if out_shapes else True
    outs_pl = [out_placements] if single else list(out_placements)
    split = [any(not pl[i].is_replicate() for pl in outs_pl)
             for i in range(mesh.ndim)]
    local = []
    for a, pl in zip(args, placements):
        a = placed(a, pl)
        grad = tuple(Partial() if p.is_replicate() and split[i] else p
                     for i, p in enumerate(a.placements))
        local.append(a.to_local(grad_placements=grad))
    outs = fn(*local)
    if single:
        return wrap(outs, mesh, out_placements, out_shapes)
    return tuple(wrap(o, mesh, p, s)
                 for o, p, s in zip(outs, out_placements, out_shapes))


def local_heads(fn, q, k, v):
    """``fn(q, k, v)`` on each rank's own rows and kv heads of DTensors q
    (B, S, K, G, D) and k, v (B, T, K, D): a mesh dim that splits q's
    batch (dim 0) or kv heads (dim 2) keeps that split on all three, any
    other placement is gathered, so the softmax never crosses a device. A
    rank whose share is empty (an uneven split) computes on empty shards
    and launches no kernel."""
    keep = [p if p.is_shard(0) or p.is_shard(2) else Replicate()
            for p in q.placements]
    return local_apply(fn, (q, k, v), (keep, keep, keep), keep, q.shape)


def rowwise(fn, x, *args):
    """``fn(x, *args)`` on each rank's rows of DTensor ``x`` whose last dim
    is whole (split on leading dims only, no partial sums); ``args`` (a
    norm's scale, positions shared by every row) are gathered whole. The
    result has ``x``'s shape and placements. Returns None where ``x``'s
    placements do not allow it: the caller then runs ``fn`` on the
    DTensors, op by op. One local call costs DTensor one dispatch where
    the ops would cost one each."""
    last = x.ndim - 1
    if not all(p.is_replicate() or (p.is_shard() and p.dim < last)
               for p in x.placements):
        return None
    mesh = x.device_mesh
    whole = (Replicate(),) * mesh.ndim
    args = [a if isinstance(a, DTensor) else replicated(a, x) for a in args]
    return local_apply(fn, (x, *args), (x.placements,) + (whole,) * len(args),
                       x.placements, x.shape)


def _replicated(p):
    """A placement that is not a Shard resolves to Replicate (a Partial is
    reduced)."""
    return p if p.is_shard() else Replicate()


def resolved(x):
    """DTensor ``x`` with every partial sum reduced (its splits kept): the
    one reduce a ``local_apply`` with ``Partial`` results needs."""
    return placed(x, [_replicated(p) for p in x.placements])


def batch_mean(x):
    """The mean of every element of ``x``, as a scalar: ``x.mean()`` on a
    plain tensor; on a DTensor split on leading dims only (rows over the
    batch axes, equal rows a rank), each rank's mean weighted by its share,
    the pieces summed into a replicated scalar."""
    if not is_dtensor(x):
        return x.mean()
    n = x.numel()
    out = [Partial() if p.is_shard() else Replicate() for p in x.placements]
    y = local_apply(lambda a: a.mean() * (a.numel() / n), (x,),
                    (x.placements,), out, ())
    return resolved(y)


def contract(x, w, n: int):
    """x (*lead, *c) · w (*c, *o) -> (*lead, *o), ``c`` the last ``n``
    dims of ``x`` and the first ``n`` of ``w``; the product accumulates in
    the operands' dtype, as ``x @ w``.

    Plain tensors: one matrix product over the flattened dims. DTensors,
    mesh dim by mesh dim:
      * ``x`` split on a leading dim (the batch over the data axes): ``w``
        is gathered there (FSDP), and the result keeps the split;
      * ``x`` split on a contracted dim (the heads after attention): ``w``
        split on the same dim, the result a partial sum, reduced;
      * else ``w`` split on an output dim (column-parallel): ``x``
        replicated, the result split on that output dim;
      * else ``w`` split on a contracted dim (a batch too small to split
        meets an FSDP weight): ``x`` sliced alike, the result reduced;
      * else both replicated.
    The reductions leave the result replicated on that mesh dim.
    """
    if not is_dtensor(x, w):
        lead, out = x.shape[:x.ndim - n], w.shape[n:]
        c = math.prod(w.shape[:n])
        # sizes spelled out: a rank without heads has c = 0, and its
        # product (zeros) stays in the graph, so its backward takes part in
        # the same collectives as the other ranks'
        return (x.reshape(math.prod(lead), c) @ w.reshape(c, math.prod(out))
                ).reshape(lead + out)
    lead = x.ndim - n
    xp, wp, op = [], [], []
    for xm, wm in zip(x.placements, w.placements):
        if xm.is_shard() and xm.dim < lead:
            xp.append(xm), wp.append(Replicate()), op.append(xm)
        elif xm.is_shard():
            xp.append(xm), wp.append(Shard(xm.dim - lead))
            op.append(Partial())
        elif wm.is_shard() and wm.dim >= n:
            xp.append(Replicate()), wp.append(wm)
            op.append(Shard(lead + wm.dim - n))
        elif wm.is_shard():
            xp.append(Shard(lead + wm.dim)), wp.append(wm)
            op.append(Partial())
        else:
            xp.append(Replicate()), wp.append(Replicate())
            op.append(Replicate())
    shape = tuple(x.shape[:lead]) + tuple(w.shape[n:])
    return resolved(local_apply(lambda a, b: contract(a, b, n), (x, w),
                                (xp, wp), op, shape))


def embed(table, tokens):
    """``table[tokens]``. On DTensors with the table's rows (the vocab)
    split: each rank looks up the tokens that fall in its rows, zeros
    elsewhere, and the pieces are summed (a vocab-parallel embedding); the
    table is never gathered."""
    if not is_dtensor(table, tokens):
        return table[tokens]
    tp, kp, op = [], [], []
    for t, k in zip(table.placements, tokens.placements):
        k = _replicated(k)
        kp.append(k)
        if t.is_shard(0):
            tp.append(t), op.append(Partial())
        else:
            tp.append(Replicate()), op.append(k)
    mesh = table.device_mesh
    n_rows = table.shape[0]
    starts = _row_starts(mesh, tp, n_rows)

    def lookup(tab, tok):
        lo = starts
        hit = (tok >= lo) & (tok < lo + tab.shape[0])
        rows = torch.where(hit, tok - lo, 0)
        if tab.shape[0] == 0:
            return tab.new_zeros(tok.shape + tab.shape[1:])
        return tab[rows] * hit[..., None].to(tab.dtype)
    return resolved(local_apply(lookup, (table, tokens), (tp, kp), op,
                                tuple(tokens.shape) + tuple(table.shape[1:])))


def _row_starts(mesh, placements, n_rows, dim=0) -> int:
    """The first global index of this rank's piece of ``dim`` (of size
    ``n_rows``) split by ``placements`` (mesh dims in order, each a
    ``torch.chunk`` of the last's piece)."""
    return piece(mesh, placements, n_rows, dim)[0]


def piece(mesh, placements, n: int, dim: int = 0):
    """(first index, length) of this rank's piece of ``dim`` (of size
    ``n``) split by ``placements``, as ``_row_starts`` reckons it."""
    start, size = 0, n
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements):
        if p.is_shard(dim):
            k = mesh.size(i)
            chunk = -(-size // k)
            lo = min(coord[i] * chunk, size)
            start += lo
            size = min(chunk, size - lo)
    return start, size


def vocab_stats(logits, labels):
    """(logsumexp, the logit at each label, argmax) over the last dim of
    DTensor ``logits`` (B, S, V), with the vocab split as the LM head left
    it; ``labels`` (B, S) are clamped at 0. The vocab is never gathered:
    each rank reduces its own columns and the pieces meet in reductions of
    (B, S) tensors (max, sum, min), as a vocab-parallel loss does. The
    argmax is the first index of the maximum, as ``torch.argmax``'s."""
    mesh = logits.device_mesh
    last = logits.ndim - 1
    lp = [p if p.is_shard() else Replicate() for p in logits.placements]
    vocab = [p.is_shard(last) and mesh.size(i) > 1 for i, p in enumerate(lp)]
    kp = [Replicate() if p.is_shard(last) else p for p in lp]
    rows = tuple(logits.shape[:-1])
    if not any(vocab):
        # the vocab whole on every rank (a 1x1 mesh): the plain reductions
        def plain(a, lab):
            gold = a.gather(-1, lab.clamp(min=0)[..., None])[..., 0]
            return torch.logsumexp(a, dim=-1), gold, a.detach().argmax(-1)
        return local_apply(plain, (logits, labels), (kp, kp), (kp,) * 3,
                           (rows,) * 3)
    lo = _row_starts(mesh, lp, logits.shape[-1], last)

    def reduced(op):
        return [Partial(op) if v else p for p, v in zip(kp, vocab)]

    def whole(x):
        return placed(x, kp)

    m = whole(local_apply(lambda a: a.detach().amax(-1), (logits,), (lp,),
                          reduced("max"), rows))
    sumexp = whole(local_apply(
        lambda a, b: (a - b[..., None]).exp().sum(-1), (logits, m),
        (lp, kp), reduced("sum"), rows))

    def gold_of(a, lab):
        idx = lab.clamp(min=0) - lo
        hit = (idx >= 0) & (idx < a.shape[-1])
        picked = a.gather(-1, idx.clamp(0, max(a.shape[-1] - 1, 0))[..., None])
        return picked[..., 0] * hit.to(a.dtype)
    gold = whole(local_apply(gold_of, (logits, labels), (lp, kp),
                             reduced("sum"), rows))

    def first_max(a, b):
        at = a.detach() == b[..., None]
        first = at.to(torch.uint8).argmax(-1) + lo
        return torch.where(at.any(-1), first, logits.shape[-1])
    top = whole(local_apply(first_max, (logits, m), (lp, kp), reduced("min"),
                            rows))
    return sumexp.log() + m, gold, top


def whole_pairs(x):
    """``x`` with every split of its last dim into pieces of whole (2i,
    2i+1) pairs that split evenly (RoPE's pair view needs them); a split
    that does not is gathered. Plain tensors pass through."""
    if not is_dtensor(x):
        return x
    last, n = x.ndim - 1, x.shape[-1]
    out = []
    for i, p in enumerate(x.placements):
        if p.is_shard(last):
            size = x.device_mesh.size(i)
            if (n // 2) % size:
                p = Replicate()
            else:
                n //= size
        out.append(p)
    return placed(x, out)


def rope_pieces(x, positions):
    """(x, positions, the first pair of this rank's piece of x's last dim)
    for RoPE on shards: x's last dim split into whole pairs
    (``whole_pairs``), any partial sum reduced; positions (B or 1, S) a
    DTensor split as x's rows where it has one row per sequence, else
    replicated."""
    x = whole_pairs(x)
    x = placed(x, [_replicated(p) for p in x.placements])
    mesh, last = x.device_mesh, x.ndim - 1
    if not isinstance(positions, DTensor):
        positions = replicated(positions, x)
    rows = positions.shape[0] == x.shape[0] and x.shape[0] > 1
    positions = placed(positions, [
        Shard(0) if rows and p.is_shard(0) else Replicate()
        for p in x.placements])
    lo = _row_starts(mesh, x.placements, x.shape[-1], last)
    return x, positions, lo // 2


def write_row(dst, index: int, src) -> None:
    """``dst[:, index] = src`` (a decode cache's slot), in place. On
    DTensors each rank writes its own shard of ``src`` (redistributed to
    ``dst``'s split, less dim 1) into its own shard of ``dst``: DTensor's
    own ``__setitem__`` would make every slot a new op to propagate."""
    if not is_dtensor(dst):
        dst[:, index] = src
        return
    pl = [Shard(p.dim - 1) if p.is_shard() and p.dim > 1 else p
          for p in dst.placements]
    dst.to_local()[:, index] = placed(src, pl).to_local()


def stack(xs):
    """``torch.stack(xs)``; DTensors of one placement are stacked shard by
    shard, each split moving one dim down."""
    if not is_dtensor(*xs):
        return torch.stack(xs)
    x = xs[0]
    pl = [Shard(p.dim + 1) if p.is_shard() else p for p in x.placements]
    return wrap(torch.stack([t.to_local() for t in xs]), x.device_mesh, pl,
                (len(xs),) + tuple(x.shape))


def locals_of(ts):
    """Each tensor's local shard (a plain tensor as it is): for in-place
    ``torch._foreach_*`` over DTensors that share placements."""
    return [t.to_local() if isinstance(t, DTensor) else t for t in ts]


def elementwise(fn, *xs):
    """``fn`` on the local shards of DTensors ``xs`` of one placement (and
    plain scalars or tensors, passed as they are); the result placed as
    ``xs[0]``. Outside autograd (an optimizer's update)."""
    lead = next(x for x in xs if isinstance(x, DTensor))
    out = fn(*(x.to_local() if isinstance(x, DTensor) else x for x in xs))
    return wrap(out, lead.device_mesh, lead.placements, lead.shape)


def sum_of_squares(ts):
    """Σ over ``ts`` of the sum of their squares in fp32, as a scalar: a
    plain tensor, or a replicated DTensor where ``ts`` are DTensors (each
    placement group's local sums added, then reduced once)."""
    plain = [t for t in ts if not isinstance(t, DTensor)]
    if len(plain) < len(ts) and all(
            t.device_mesh.size() == 1 for t in ts if isinstance(t, DTensor)):
        # one rank holds everything: the plain sum, in the same order
        local = sum(t.float().square().sum() for t in locals_of(ts))
        return replicated(local, next(t for t in ts
                                      if isinstance(t, DTensor)))
    total = sum(t.float().square().sum() for t in plain)
    groups = {}
    for t in ts:
        if isinstance(t, DTensor):
            groups.setdefault(tuple(t.placements), []).append(t)
    for pl, group in groups.items():
        mesh = group[0].device_mesh
        local = sum(t.to_local().float().square().sum() for t in group)
        part = DTensor.from_local(
            local, mesh, [Partial() if p.is_shard() else Replicate()
                          for p in pl], run_check=False)
        total = total + placed(part, (Replicate(),) * mesh.ndim)
    return total


def mesh_size(mesh, axes) -> int:
    names = mesh.mesh_dim_names
    return math.prod(mesh.size(names.index(a)) for a in axes if a in names)


def rows_only(placements):
    """``placements`` with every split but a split of dim 0 (the batch)
    gathered: each rank holds its own rows whole."""
    return tuple(p if p.is_shard(0) else Replicate() for p in placements)


def channels(placements, ndim: int, dim: int = 0):
    """The placements of a per-channel parameter (its channels at ``dim``)
    meeting an activation of ``ndim`` dims placed ``placements``: split
    where the activation's last dim (the channels) is, else whole."""
    return tuple(Shard(dim) if p.is_shard(ndim - 1) else Replicate()
                 for p in placements)


def channel_group(x, dim: int):
    """(the mesh dim that splits DTensor ``x``'s ``dim``, its size), or
    (None, 1) where no mesh dim of more than one rank does."""
    for i, p in enumerate(x.placements):
        if p.is_shard(dim) and x.device_mesh.size(i) > 1:
            return i, x.device_mesh.size(i)
    return None, 1


def gather_last(t, mesh, mesh_dim, size: int):
    """A rank's columns ``t`` (..., n) made whole, (..., size * n), in the
    ranks' order along ``mesh_dim`` of ``mesh``: one functional all-gather
    on local tensors, for a loop that must not dispatch DTensor ops. Its
    backward sums the ranks' gradients and keeps each rank's columns (a
    reduce-scatter). ``mesh_dim`` None: ``t`` as it is."""
    if mesh_dim is None:
        return t
    from torch.distributed import _functional_collectives as fc
    rows = t.reshape(-1, t.shape[-1]).contiguous()
    gather = getattr(fc, "all_gather_single_autograd", None) or \
        fc.all_gather_tensor_autograd
    g = gather(rows, 0, (mesh, mesh_dim))
    g = g.reshape((size,) + rows.shape).movedim(0, 1)
    return g.reshape(t.shape[:-1] + (size * t.shape[-1],))

