"""Cost of a step counted op by op as it runs: the counterpart of
``repro.analysis.hlo_analysis``.

The reference compiles a step and walks its optimized HLO; the port runs
eagerly, so ``CostMode`` (a ``TorchDispatchMode``) sees every aten op the
step issues, on meta tensors for a dry-run or on real ones, with loops,
microbatches and the backward already unrolled. It keeps the reference's
conventions:

  * flops: a matrix product or convolution = 2 * out * contracted (shapes
    from ``torch.utils.flop_counter``'s registry); an arithmetic
    elementwise op = its output elements (transcendentals counted apart
    too); a reduction = its input elements; the fused ops of ``_FUSED``
    by the elementwise steps they stand for.
  * bytes: operand + result bytes of every aten op that is not a view or
    an alias (in eager each op is one kernel, the reference's fusion
    boundary); an in-place op reads and writes its target. ``empty`` and
    its kin allocate and move nothing.
  * score_bytes: the bytes of ops whose result is attention-score-class
    (``_is_score_like``), which a flash kernel keeps on chip.
  * collectives: operand bytes per kind, c10d and functional alike (the
    autograd functional ops, ``_c10d_functional_autograd``, that a loop on
    local tensors issues inside ``spmd.local_apply`` too), and DTensor's
    own all-to-all (``_dtensor.shard_dim_alltoall``).
  * kernels: the hand-written kernels run behind ctypes, out of the mode's
    sight, so their wrappers' meta branches report their work
    (``report_kernel``; ``analysis.roofline.Work``), counted per kernel.
  * memory: a live-storage tracker (``peak_bytes``), keyed on each
    storage's own life through a weak reference to it.

The numbers describe one device's program; ``analysis.roofline`` turns
them into times on the card.

DTensors (the sharded step, on a mesh): the mode passes an op on DTensors
to DTensor's own dispatch and counts the ops it issues on the local shards
and the collectives of its redistributions, so the counts are one rank's.
DTensor works out each result's global shape by running the op on fake
tensors; those runs are not the rank's work and are not counted. Argument
and output bytes are the local shards'.
"""
from __future__ import annotations

import dataclasses
import functools
import weakref
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.analysis import roofline

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")

# collective op name (c10d, _c10d_functional[_autograd], or DTensor's own
# _dtensor.shard_dim_alltoall) -> kind, first match wins
_COLLECTIVE_NAMES = (
    ("reduce_scatter", "reduce-scatter"), ("allreduce", "all-reduce"),
    ("all_reduce", "all-reduce"), ("allgather", "all-gather"),
    ("all_gather", "all-gather"), ("alltoall", "all-to-all"),
    ("all_to_all", "all-to-all"), ("reduce_", "all-reduce"),
    ("broadcast", "collective-permute"), ("send", "collective-permute"),
    ("recv", "collective-permute"))
# the schema arguments a collective sends (the rest are outputs or options)
_COLLECTIVE_INPUTS = ("input_tensors", "input_tensor", "input", "inputs",
                      "tensors", "tensor", "self")

_ALLOCATORS = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "empty_permuted"}

# ops that wrap their input for autograd (a functional collective's
# result): a new storage object over no new memory, counted as a view
_WRAPPERS = {"_wrap_tensor_autograd"}

_TRANSCENDENTAL = {"exp", "exp2", "expm1", "log", "log2", "log10", "log1p",
                   "tanh", "sigmoid", "sin", "cos", "tan", "erf", "erfc",
                   "erfinv", "rsqrt", "sqrt", "pow", "silu", "gelu",
                   "softplus", "logit", "atan", "atan2"}

# pointwise ops that stand for several elementwise steps: (flops,
# transcendentals) an output element, as XLA's decomposition counts them
_POINTWISE_STEPS = {"silu": (2, 1), "silu_backward": (4, 1),
                    "gelu": (8, 1), "gelu_backward": (12, 1),
                    "sigmoid_backward": (2, 0), "tanh_backward": (2, 0),
                    "addcmul": (2, 0), "addcdiv": (2, 0), "lerp": (2, 0)}

# fused non-pointwise ops: (flops, transcendentals) an element of their
# first tensor input
_FUSED = {"_softmax": (5, 1), "_log_softmax": (5, 1),
          "_softmax_backward_data": (4, 0),
          "_log_softmax_backward_data": (4, 1),
          "native_layer_norm": (7, 0), "native_layer_norm_backward": (10, 0),
          "cumsum": (1, 0), "cumprod": (1, 0), "nll_loss_forward": (0, 0),
          "embedding_dense_backward": (1, 0)}

# Autograd formulas that make zeros of their own and scatter into them in
# place (gather's backward: new_zeros, then scatter_add_; index's:
# index_put_), by their node's name. Under a tensor subclass or a dispatch
# mode (``isTensorSubclassLike``), and this mode is one, they take the
# out-of-place scatter instead. The step run without the mode writes into
# the zeros in place, and nothing but the formula holds them, so there the
# scatter's result takes the zeros' storage over. Zeros made anywhere
# else, and scatters anywhere else, count as they run.
_SCATTER_NODES = {"GatherBackward0": "scatter_add",
                  "IndexBackward0": "index_put"}
_ZEROS = {"new_zeros", "zeros", "zeros_like"}
_INTO_ZEROS = set(_SCATTER_NODES.values())

# in-place accumulations: flops = the elements of their source
_ACCUMULATE = {"index_add": "source", "index_add_": "source",
               "scatter_add": "src", "scatter_add_": "src",
               "index_put_": "values", "index_put": "values"}


def _is_score_like(*shapes: Sequence[int]) -> bool:
    """Attention-score-class result: rank >= 4 with two square-ish trailing
    dims >= 512 (q_chunk x kv_chunk blocks and their masks/exponentials)."""
    for d in shapes:
        d = tuple(d)
        if len(d) >= 4 and d[-1] >= 512 and d[-2] >= 512 \
                and max(d[-1], d[-2]) <= 2 * min(d[-1], d[-2]):
            return True
    return False


def _nbytes(t: torch.Tensor) -> int:
    """Bytes a kernel moves to read or write ``t``: its distinct elements
    (a broadcast dim, of stride 0, counts once) times the item size."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _tensors(tree, out=None) -> List[torch.Tensor]:
    """The tensors in nested tuples, lists and dicts (an op's arguments and
    results), in order; a DTensor as its local shard."""
    out = [] if out is None else out
    if isinstance(tree, DTensor):
        out.append(tree.to_local())
    elif isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    score_bytes: float = 0.0     # attention-score-class traffic (see above)
    transcendentals: float = 0.0
    coll: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {c: 0.0 for c in _COLLECTIVES})
    coll_count: float = 0.0
    fp32_flops: float = 0.0      # the part of flops at the fp32 peak
    # kernel id -> {"calls", "flops", "bytes"} of the work kernels reported
    kernels: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)

    def add(self, other: "Cost", mult: float = 1.0):
        self.flops += other.flops * mult
        self.bytes += other.bytes * mult
        self.score_bytes += other.score_bytes * mult
        self.transcendentals += other.transcendentals * mult
        for k in self.coll:
            self.coll[k] += other.coll[k] * mult
        self.coll_count += other.coll_count * mult
        self.fp32_flops += other.fp32_flops * mult
        for name, work in other.kernels.items():
            mine = self.kernels.setdefault(
                name, {"calls": 0, "flops": 0.0, "bytes": 0.0})
            for k in mine:
                mine[k] += work[k] * mult

    @property
    def kernelized_bytes(self) -> float:
        """Traffic with the score-class tensors kept on chip, as a flash
        kernel keeps them: ``bytes`` less exactly the score-shaped ops'."""
        return self.bytes - self.score_bytes

    @property
    def coll_bytes(self) -> float:
        return sum(self.coll.values())

    def kernel_calls(self) -> Dict[str, int]:
        return {k: int(v["calls"]) for k, v in sorted(self.kernels.items())}


_ACTIVE: List["CostMode"] = []


def report_kernel(name: str, work: roofline.Work) -> None:
    """A kernel wrapper's meta branch reports one call's work to every
    active ``CostMode``."""
    one = Cost(flops=work.flops, bytes=work.bytes,
               fp32_flops=(work.flops if work.peak == roofline.PEAK_FP32_FLOPS
                           else 0.0),
               kernels={name: {"calls": 1, "flops": work.flops,
                               "bytes": work.bytes}})
    for mode in _ACTIVE:
        mode.cost.add(one)


class CostMode(TorchDispatchMode):
    """Counts every aten op run inside it into ``self.cost`` and tracks
    the bytes of the storages the ops allocate.

    ``arguments(tree)`` registers the step's inputs, whose storages live
    through the step (``argument_bytes``); ``unused_argument_bytes`` are
    the registered storages that no op read (a view is no read), the
    arguments a jitted step would drop (``jax.jit``'s ``keep_unused=False``:
    the vlm's embedding table in a prefill, the encoder in whisper's
    decode). Every storage an op allocates
    counts from the op until it dies, and ``peak_bytes`` is the most such
    bytes alive at once: the step's temporaries, its outputs among them.
    """

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self.argument_bytes = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._args: Dict[int, int] = {}
        self._read = set()
        self._live: Dict[int, int] = {}
        self._refs: Dict[int, weakref.ref] = {}
        self._pins: Dict[int, torch.UntypedStorage] = {}
        self._zeros: Dict[int, str] = {}
        self._layouts: Dict[tuple, tuple] = {}

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    # ------------------------------------------------------------ memory
    def arguments(self, tree) -> int:
        """Register ``tree``'s tensors as the step's arguments; returns
        their bytes (each storage once)."""
        for t in _tensors(tree):
            key = _storage_key(t)
            if key not in self._args:
                self._args[key] = t.untyped_storage().nbytes()
                self.argument_bytes += self._args[key]
        return self.argument_bytes

    def mark_read(self, tree=None, like: Optional["CostMode"] = None):
        """Count ``tree``'s storages, and those ``like`` read, as read: a
        step counted by other runs (an extrapolated train cell)."""
        self._read.update(_storage_key(t) for t in _tensors(tree))
        if like is not None:
            self._read |= like._read

    @property
    def unused_argument_bytes(self) -> int:
        return sum(n for key, n in self._args.items()
                   if key not in self._read)

    def output_bytes(self, tree) -> int:
        """Bytes of ``tree``'s storages that are not arguments."""
        seen, total = set(), 0
        for t in _tensors(tree):
            key = _storage_key(t)
            if key not in self._args and key not in seen:
                seen.add(key)
                total += t.untyped_storage().nbytes()
        return total

    def _freed(self, key, _ref):
        self.live_bytes -= self._live.pop(key, 0)
        self._refs.pop(key, None)
        self._zeros.pop(key, None)

    def _track(self, t: torch.Tensor):
        storage = t.untyped_storage()
        key = storage._cdata
        if key in self._args or key in self._live:
            return
        n = storage.nbytes()
        self._live[key] = n
        self._refs[key] = weakref.ref(storage,
                                      functools.partial(self._freed, key))
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _pointwise_meta(self, func, args, kwargs):
        """A pointwise op on meta tensors, its output made from the layout
        it had at the same input layouts before: meta pointwise ops run
        Python shape functions that cost more than the counting, and a
        step repeats a few hundred distinct ones. None when the op is not
        such an op or not seen yet (then it runs and is remembered)."""
        rule = _rule(func)
        if not rule.pure_pointwise:
            return None
        try:
            key = (func, _layout_key(args), _layout_key(kwargs))
        except TypeError:             # an argument that is not a layout
            return None
        layout = self._layouts.get(key)
        if layout is None:
            out = func(*args, **kwargs)
            if isinstance(out, torch.Tensor) and out.device.type == "meta":
                self._layouts[key] = (out.shape, out.stride(), out.dtype)
            return out
        shape, stride, dtype = layout
        return torch.empty_strided(shape, stride, dtype=dtype,
                                   device="meta")

    # ------------------------------------------------------------- costs
    def _count(self, func, args, kwargs, out, outs):
        c = self.cost
        rule = _rule(func)
        if rule.allocates:
            return
        ins = _tensors((args, kwargs))
        if not rule.view:
            self._read.update(k for k in map(_storage_key, ins)
                              if k in self._args)
        if rule.collective is not None:
            sent = _named_tensors(func, args, kwargs, _COLLECTIVE_INPUTS)
            c.coll[rule.collective] += sum(_nbytes(t) for t in sent or ins)
            c.coll_count += 1
        aliases = rule.view
        if not aliases and not rule.writes and outs:
            in_keys = {_storage_key(t) for t in ins}
            aliases = all(_storage_key(t) in in_keys for t in outs)
        if not aliases:
            b = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
            c.bytes += b
            if b and _is_score_like(*(t.shape for t in outs)):
                c.score_bytes += b
        if rule.kind == "matmul":
            flops = float(flop_registry[func.overloadpacket](
                *args, **kwargs, out_val=out))
            c.flops += flops
            if ins and ins[0].dtype == torch.float32:
                c.fp32_flops += flops
            return
        if rule.kind == "foreach":
            n = _elems(_tensors(args[0]))
        elif rule.kind == "pointwise":
            n = _elems(outs)
        elif rule.kind in ("reduction", "fused"):
            n = ins[0].numel() if ins else 0
        elif rule.kind == "accumulate":
            n = _elems(_named_tensors(func, args, kwargs, (rule.source,)))
        else:
            return
        c.flops += rule.flops * n
        c.transcendentals += rule.transcendentals * n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented        # DTensor's dispatch, then its ops
        if torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.FAKE) is not None:
            return func(*args, **kwargs)     # DTensor's shape propagation
        if _rule(func).decompose:
            # a composite that reached the mode whole (autograd's
            # decomposition skipped, as under inference_mode): count the
            # ops it stands for, which are what a device runs
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = self._pointwise_meta(func, args, kwargs)
        if out is None:
            out = func(*args, **kwargs)
        outs = _tensors(out)
        self._count(func, args, kwargs, out, outs)
        name = func.overloadpacket.__name__
        if _rule(func).view:
            self._pin(_tensors((args, kwargs)), outs)
        elif name in _INTO_ZEROS and len(outs) == 1 and self._take_over(
                name, args[0], outs[0]):
            pass
        else:
            for t in outs:
                self._track(t)
            node = _autograd_node() if name in _ZEROS else None
            if node in _SCATTER_NODES:
                self._zeros.update((_storage_key(t), node) for t in outs)
        return out

    def _take_over(self, name, zeros, result) -> bool:
        """``result`` (``name``, a scatter into ``zeros``) takes the live
        bytes of ``zeros``' storage over, as the in-place scatter would;
        False unless ``zeros`` are the current autograd formula's own (one
        of ``_SCATTER_NODES``, ``name`` its scatter) of the same bytes."""
        src = _storage_key(zeros)
        node = self._zeros.get(src)
        if node is None or _SCATTER_NODES[node] != name or \
                _autograd_node() != node or src not in self._live or \
                zeros.untyped_storage().nbytes() != \
                result.untyped_storage().nbytes():
            return False
        del self._zeros[src]
        storage = result.untyped_storage()
        key = storage._cdata
        self._live[key] = self._live.pop(src)
        self._refs.pop(src, None)
        self._refs[key] = weakref.ref(storage,
                                      functools.partial(self._freed, key))
        return True

    def _pin(self, ins, outs):
        """A view whose result has a storage object of its own over its
        input's memory (a functional collective's autograd wrapper; on
        meta tensors its result is all the step goes on using, where a
        device's goes on using the collective's own output): the input's
        storage is kept alive, and counted, while the result lives."""
        live = [t.untyped_storage() for t in ins
                if _storage_key(t) in self._live]
        if not live:
            return
        keys = {_storage_key(t) for t in ins}
        for t in outs:
            key = _storage_key(t)
            if key in keys or key in self._pins or key in self._live \
                    or key in self._args:
                continue
            self._pins[key] = live[0]
            weakref.finalize(t.untyped_storage(), self._pins.pop, key, None)


def _autograd_node():
    """The name of the autograd node whose formula is running, or None."""
    node = torch._C._current_autograd_node()
    return None if node is None else node.name()


class _Rule(NamedTuple):
    """How an op counts, worked out once per op overload."""
    allocates: bool            # empty and its kin: no bytes, no flops
    view: bool
    writes: bool               # mutates an argument (in place, out=)
    collective: Optional[str]  # kind, for c10d and functional collectives
    kind: Optional[str]        # matmul | foreach | pointwise | reduction |
    #                            fused | accumulate | None (no flops)
    flops: int = 0             # a counted element
    transcendentals: int = 0
    source: str = ""           # accumulate: the argument summed in
    pure_pointwise: bool = False   # pointwise, functional, one output
    decompose: bool = False    # a composite with no kernel of its own


@functools.lru_cache(maxsize=None)
def _rule(func) -> _Rule:
    name = func.overloadpacket.__name__
    collective = None
    if func.namespace in ("c10d", "_c10d_functional",
                          "_c10d_functional_autograd", "_dtensor"):
        collective = next((k for n, k in _COLLECTIVE_NAMES if n in name),
                          None)
    writes = any(r.alias_info is not None and r.alias_info.is_write
                 for r in func._schema.returns)
    base = name.rstrip("_")

    def steps(op):
        return _POINTWISE_STEPS.get(op, (1, int(op in _TRANSCENDENTAL)))
    kind, per, trans, source = None, 0, 0, ""
    if func.overloadpacket in flop_registry:
        kind = "matmul"
    elif name.startswith("_foreach_"):
        kind = "foreach"
        per, trans = steps(base[len("_foreach_"):])
    elif torch.Tag.pointwise in func.tags:
        kind = "pointwise"
        per, trans = steps(base)
    elif torch.Tag.reduction in func.tags:
        kind, per = "reduction", 1
    elif name in _FUSED:
        kind = "fused"
        per, trans = _FUSED[name]
    elif name in _ACCUMULATE:
        kind, per, source = "accumulate", 1, _ACCUMULATE[name]
    pure = (kind == "pointwise" and not writes and not func.is_view
            and len(func._schema.returns) == 1
            and str(func._schema.returns[0].type) == "Tensor")
    return _Rule(allocates=name in _ALLOCATORS,
                 view=func.is_view or name in _WRAPPERS,
                 writes=writes, collective=collective, kind=kind, flops=per,
                 transcendentals=trans, source=source, pure_pointwise=pure,
                 decompose=func._can_decompose() and not
                 torch._C._dispatch_has_kernel_for_dispatch_key(func.name(),
                                                                "Meta"))


def _layout_key(tree):
    """A hashable key of an op's arguments: each tensor by its layout
    (shape, strides, dtype, device; meta tensors only), everything else by
    its value. TypeError for anything else."""
    if isinstance(tree, torch.Tensor):
        if tree.device.type != "meta":
            raise TypeError("not a meta tensor")
        return (tuple(tree.shape), tree.stride(), tree.dtype)
    if isinstance(tree, (tuple, list)):
        return tuple(_layout_key(x) for x in tree)
    if isinstance(tree, dict):
        return tuple((k, _layout_key(v)) for k, v in tree.items())
    if tree is None or isinstance(tree, (bool, int, float, str,
                                         torch.dtype, torch.device,
                                         torch.memory_format,
                                         torch.layout)):
        return (type(tree), tree)
    raise TypeError(f"{type(tree).__name__} is not a layout")


def _named_tensors(func, args, kwargs, names) -> List[torch.Tensor]:
    """The tensors of the first schema argument in ``names`` that the call
    passed (a collective's input, an accumulation's source)."""
    bound = {a.name: v for a, v in zip(func._schema.arguments, args)}
    bound.update(kwargs)
    for name in names:
        if name in bound:
            return _tensors(bound[name])
    return []


def _elems(ts: Iterable[torch.Tensor]) -> int:
    return sum(t.numel() for t in ts)


def count(fn, *args, **kwargs):
    """(fn's result, its ``CostMode``) with ``args`` registered as the
    arguments."""
    with CostMode() as mode:
        mode.arguments((args, kwargs))
        out = fn(*args, **kwargs)
    return out, mode
