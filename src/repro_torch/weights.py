"""Parameters from the JAX reference's tree into the port's, leaf by leaf.

The port keeps the reference's parameter layout (dense weights ``(in, out)``
used as ``x @ W``, layers stacked on a leading axis), so a leaf carries over
as it is. ``leaf_shapes`` is the layout map: every leaf path the port knows,
with its shape. ``from_jax`` accepts exactly those paths and raises on an
unknown, missing or misshapen leaf; ``state_from_jax`` carries a whole train
state (parameters, optimizer moments, step) over the same map.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.models.transformer import require_dense


def leaf_shapes(cfg) -> Dict[str, Tuple[int, ...]]:
    """Leaf path ("a/b/c") -> shape, for the dense family."""
    require_dense(cfg)
    L, d, F, V = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.padded_vocab
    K, D = cfg.n_kv_heads, cfg.resolved_head_dim
    G = cfg.n_heads // K
    shapes = {"embed": (V, d), "final_norm/scale": (d,)}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, V)
    layer = {"attn_norm/scale": (d,), "mlp_norm/scale": (d,),
             "attn/wq": (d, K, G, D), "attn/wk": (d, K, D),
             "attn/wv": (d, K, D), "attn/wo": (K, G, D, d),
             "mlp/w_gate": (d, F), "mlp/w_up": (d, F), "mlp/w_down": (F, d)}
    if cfg.qkv_bias:
        layer.update({"attn/bq": (K, G, D), "attn/bk": (K, D),
                      "attn/bv": (K, D)})
    if cfg.qk_norm:
        layer.update({"attn/q_norm/scale": (D,), "attn/k_norm/scale": (D,)})
    shapes.update({f"layers/{p}": (L,) + s for p, s in layer.items()})
    return shapes


def flatten(tree, prefix: str = "") -> Dict[str, object]:
    """Nested dicts -> {"a/b/c": leaf}."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def unflatten(flat):
    """{"a/b/c": leaf} -> nested dicts (the inverse of ``flatten``)."""
    tree = {}
    for path, leaf in flat.items():
        *parents, last = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return tree


def from_jax(params_np, cfg, device, dtype=None):
    """The reference's parameter tree (numpy leaves) -> the port's tensors.

    dtype defaults to ``cfg.dtype``. bf16 leaves (ml_dtypes) pass through
    float32, which holds them exactly.
    """
    flat = flatten(params_np)
    expected = leaf_shapes(cfg)
    unknown = sorted(set(flat) - set(expected))
    missing = sorted(set(expected) - set(flat))
    if unknown or missing:
        raise KeyError(f"leaf paths not in the layout map: {unknown}; "
                       f"missing: {missing}")
    dtype = cfg.dtype if dtype is None else dtype
    out = {}
    for path, leaf in flat.items():
        arr = np.asarray(leaf)
        if arr.shape != expected[path]:
            raise ValueError(f"{path}: shape {arr.shape}, expected "
                             f"{expected[path]}")
        t = torch.from_numpy(np.array(arr, dtype=np.float32))
        out[path] = t.to(device=device, dtype=dtype)
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
