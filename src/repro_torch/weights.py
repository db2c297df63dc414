"""Parameters from the JAX reference's tree into the port's, leaf by leaf.

The port keeps the reference's parameter layout (dense weights ``(in, out)``
used as ``x @ W``, layers stacked on a leading axis), so a leaf carries over
as it is, but for the small workloads' conv weights
(``models/small.py``): the reference's HWIO (LeNet) and WIO (TextCNN) become
OIHW and OIW, the layouts of ``F.conv2d``/``F.conv1d``. ``leaf_shapes`` is
the layout map: every leaf path the port knows, with its shape in the
port. ``from_jax`` accepts exactly the reference's paths and shapes and
raises on an unknown, missing or misshapen leaf; ``state_from_jax`` carries
a whole train state (parameters, optimizer moments such as SGD's ``mu``,
step) over the same map.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import moe as moe_lib
from repro_torch.models import recurrent as rec_lib
from repro_torch.models.transformer import require_ported


def _small_layout(cfg) -> Dict[str, Tuple[Tuple[int, ...],
                                          Optional[Tuple[int, ...]]]]:
    """Leaf path -> (the reference's shape, the permutation of its axes
    into the port's layout, or None), for ``models/small.py``."""
    C, E, H = cfg.n_classes, cfg.embed_dim, cfg.hidden
    if cfg.kind == "lenet":
        hwio_to_oihw = (3, 2, 0, 1)
        layout = {"c1/w": ((5, 5, 1, 6), hwio_to_oihw), "c1/b": ((6,), None),
                  "c2/w": ((5, 5, 6, 16), hwio_to_oihw),
                  "c2/b": ((16,), None),
                  "f1/w": ((16 * 4 * 4, 120), None), "f1/b": ((120,), None),
                  "f2/w": ((120, 84), None), "f2/b": ((84,), None)}
        feat = 84
    elif cfg.kind == "textcnn":
        layout = {"embed": ((cfg.vocab, E), None)}
        for i, k in enumerate((3, 4, 5)):
            layout[f"convs/{i}/w"] = ((k, E, H), (2, 1, 0))   # WIO -> OIW
            layout[f"convs/{i}/b"] = ((H,), None)
        feat = 3 * H
    elif cfg.kind == "lstm":
        layout = {"embed": ((cfg.vocab, E), None), "w_ih": ((E, 4 * H), None),
                  "w_hh": ((H, 4 * H), None), "b": ((4 * H,), None)}
        feat = H
    else:
        raise ValueError(f"unknown small model kind {cfg.kind!r}")
    layout.update({"out/w": ((feat, C), None), "out/b": ((C,), None)})
    return layout


def _layout(cfg):
    family = getattr(cfg, "family", None)
    if family == "small":
        return _small_layout(cfg)
    shapes = _encdec_shapes(cfg) if family == "audio" else _lm_shapes(cfg)
    return {p: (s, None) for p, s in shapes.items()}


def leaf_shapes(cfg) -> Dict[str, Tuple[int, ...]]:
    """Leaf path ("a/b/c") -> shape in the port, for every model family
    and the small workloads."""
    return {p: s if perm is None else tuple(s[i] for i in perm)
            for p, (s, perm) in _layout(cfg).items()}


def _lm_shapes(cfg) -> Dict[str, Tuple[int, ...]]:
    require_ported(cfg)
    L, d, F, V = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.padded_vocab
    K, D = cfg.n_kv_heads, cfg.resolved_head_dim
    G = cfg.n_heads // K
    shapes = {"embed": (V, d), "final_norm/scale": (d,)}
    if cfg.takes_embeddings:
        shapes["adapter"] = (d, d)
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, V)
    if cfg.family == "ssm":
        shapes.update(_ssm_shapes(cfg))
        return shapes
    layer = {"attn_norm/scale": (d,), "mlp_norm/scale": (d,),
             "attn/wq": (d, K, G, D), "attn/wk": (d, K, D),
             "attn/wv": (d, K, D), "attn/wo": (K, G, D, d)}
    if cfg.family == "moe":
        E = cfg.n_experts
        layer.update({"moe/router": (d, E), "moe/w_gate": (E, d, F),
                      "moe/w_up": (E, d, F), "moe/w_down": (E, F, d)})
        if cfg.n_shared:
            sf = moe_lib.shared_d_ff(cfg.moe_cfg())
            layer.update({"moe/shared/w_gate": (d, sf),
                          "moe/shared/w_up": (d, sf),
                          "moe/shared/w_down": (sf, d)})
    else:
        layer.update({"mlp/w_gate": (d, F), "mlp/w_up": (d, F),
                      "mlp/w_down": (F, d)})
    if cfg.qkv_bias:
        layer.update({"attn/bq": (K, G, D), "attn/bk": (K, D),
                      "attn/bv": (K, D)})
    if cfg.qk_norm:
        layer.update({"attn/q_norm/scale": (D,), "attn/k_norm/scale": (D,)})
    if cfg.family != "hybrid":
        shapes.update({f"layers/{p}": (L,) + s for p, s in layer.items()})
        return shapes
    # hybrid: groups stack (rec_per_attn recurrent blocks, one attention
    # block) as layers/recs/... and layers/attn/...; the tail's recurrent
    # blocks stack as tail/...
    g, n_rec, R = cfg.hybrid_groups, cfg.rec_per_attn, cfg.d_rnn or d
    rec = {"rec_norm/scale": (d,), "mlp_norm/scale": (d,),
           "rec/w_in_x": (d, R), "rec/w_in_gate": (d, R),
           "rec/conv_w": (rec_lib.CONV_WIDTH, R), "rec/conv_b": (R,),
           "rec/w_a": (R, R), "rec/b_a": (R,), "rec/w_x": (R, R),
           "rec/b_x": (R,), "rec/Lambda": (R,), "rec/w_out": (R, d),
           "mlp/w_gate": (d, F), "mlp/w_up": (d, F), "mlp/w_down": (F, d)}
    shapes.update({f"layers/recs/{p}": (g, n_rec) + s
                   for p, s in rec.items()})
    shapes.update({f"layers/attn/{p}": (g,) + s for p, s in layer.items()})
    if cfg.hybrid_tail:
        shapes.update({f"tail/{p}": (cfg.hybrid_tail,) + s
                       for p, s in rec.items()})
    return shapes


def _ssm_shapes(cfg) -> Dict[str, Tuple[int, ...]]:
    """ssm groups: layers/mlstms/... at (G, M, ...) and layers/slstm/...
    at (G, ...), each block a pre-norm "norm" and its "cell"."""
    mcfg = cfg.mlstm_cfg()
    d, di, H, D = mcfg.d_model, mcfg.d_inner, mcfg.n_heads, mcfg.head_dim
    g, m = cfg.ssm_groups, cfg.mlstm_per_slstm
    mlstm = {"norm/scale": (d,), "cell/w_up": (d, di),
             "cell/w_gate": (d, di), "cell/conv_w": (mcfg.conv_width, di),
             "cell/conv_b": (di,), "cell/wq": (di, H, D),
             "cell/wk": (di, H, D), "cell/wv": (di, H, D),
             "cell/w_if": (di, H, 2), "cell/b_if": (H, 2),
             "cell/out_norm/scale": (D,), "cell/w_down": (di, d)}
    slstm = {"norm/scale": (d,), "cell/w_in": (d, 4 * di),
             "cell/w_rec": (di, 4 * di), "cell/b": (4 * di,),
             "cell/out_norm/scale": (di,), "cell/w_down": (di, d)}
    shapes = {f"layers/mlstms/{p}": (g, m) + s for p, s in mlstm.items()}
    shapes.update({f"layers/slstm/{p}": (g,) + s for p, s in slstm.items()})
    return shapes


def _encdec_shapes(cfg) -> Dict[str, Tuple[int, ...]]:
    """The encoder-decoder: embed, enc_layers/... and dec_layers/...
    stacked on the layer axis, enc_norm and dec_norm."""
    L, d, F = cfg.n_layers, cfg.d_model, cfg.d_ff
    H, D = cfg.n_heads, cfg.head_dim
    norm = {"scale": (d,), "bias": (d,)}
    mha = {"wq": (d, H, D), "wk": (d, H, D), "wv": (d, H, D),
           "wo": (H, D, d)}
    block = {"mlp/w_up": (d, F), "mlp/b_up": (F,), "mlp/w_down": (F, d),
             "mlp/b_down": (d,)}
    parts = {"self_norm": norm, "self": mha, "mlp_norm": norm}
    enc = dict(block, **{f"{n}/{k}": s for n, leaves in parts.items()
                         for k, s in leaves.items()})
    dec = dict(enc, **{f"cross_norm/{k}": s for k, s in norm.items()},
               **{f"cross/{k}": s for k, s in mha.items()})
    shapes = {"embed": (cfg.padded_vocab, d)}
    shapes.update({f"enc_layers/{p}": (L,) + s for p, s in enc.items()})
    shapes.update({f"dec_layers/{p}": (L,) + s for p, s in dec.items()})
    for n in ("enc_norm", "dec_norm"):
        shapes.update({f"{n}/{k}": s for k, s in norm.items()})
    return shapes


def flatten(tree, prefix: str = "") -> Dict[str, object]:
    """Nested dicts and lists -> {"a/b/c": leaf}; a list's items are keyed
    by their index ("convs/0/w")."""
    if isinstance(tree, list):
        tree = {str(i): v for i, v in enumerate(tree)}
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _lists(node):
    """Dicts keyed "0".."n-1" back into lists."""
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if node and sorted(node) == sorted(str(i) for i in range(len(node))):
        return [node[str(i)] for i in range(len(node))]
    return node


def unflatten(flat):
    """{"a/b/c": leaf} -> nested dicts and lists (the inverse of
    ``flatten``)."""
    tree = {}
    for path, leaf in flat.items():
        *parents, last = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return _lists(tree)


_FP32_LEAVES = ("layers/moe/router", "layers/recs/rec/Lambda",
                "tail/rec/Lambda", "layers/mlstms/cell/w_if",
                "layers/mlstms/cell/b_if")


def from_jax(params_np, cfg, device, dtype=None):
    """The reference's parameter tree (numpy leaves) -> the port's tensors.

    dtype defaults to ``cfg.dtype``, but for the MoE router, the RG-LRU's
    ``Lambda`` and the mLSTM's gate projection ``w_if`` and bias ``b_if``,
    which stay fp32 as the reference's init keeps them. bf16
    leaves (ml_dtypes) pass through float32, which holds them exactly.
    """
    flat = flatten(params_np)
    layout = _layout(cfg)
    unknown = sorted(set(flat) - set(layout))
    missing = sorted(set(layout) - set(flat))
    if unknown or missing:
        raise KeyError(f"leaf paths not in the layout map: {unknown}; "
                       f"missing: {missing}")
    out = {}
    for path, leaf in flat.items():
        arr = np.asarray(leaf)
        shape, perm = layout[path]
        if arr.shape != shape:
            raise ValueError(f"{path}: shape {arr.shape}, expected {shape}")
        if perm is not None:
            arr = arr.transpose(perm)
        t = torch.from_numpy(np.array(arr, dtype=np.float32))
        leaf_dtype = dtype or (torch.float32 if path in _FP32_LEAVES
                               else cfg.dtype)
        out[path] = t.to(device=device, dtype=leaf_dtype)
    return unflatten(out)


def state_from_jax(state_np, cfg, device):
    """The reference's train state (numpy leaves) -> the port's.

    ``{"params", "opt", "step"}`` as ``repro.launch.steps.make_train_state``
    builds it: the parameters take ``cfg.dtype`` as in ``from_jax``; every
    optimizer moment tree (adamw's ``m`` and ``v``, sgd's ``mu``) has the
    parameters' layout and stays fp32; the step becomes a Python int.
    """
    return {"params": from_jax(state_np["params"], cfg, device),
            "opt": {name: from_jax(tree, cfg, device, torch.float32)
                    for name, tree in state_np["opt"].items()},
            "step": int(np.asarray(state_np["step"]))}
