"""The benchmark's inputs, made on the device from the seed: the initial
weights (fp32 masters, in the program's layout of nested dicts with the
layers stacked on a leading axis) and the token batches.

All fan-in weights are drawn in one call into one flat buffer (a
truncated normal, ±3σ) and each leaf is a view of it scaled by
1/sqrt(fan_in); the embedding is one normal call; norm scales are ones.
The same seed gives the same tensors, so the reference regenerates the
initial weights instead of keeping a copy."""
from __future__ import annotations

import hashlib
import math
from typing import Dict, Tuple

import torch

from bench.harness.yardstick import head_dim, padded_vocab


def stream_seed(seed: int, *names) -> int:
    """A 63-bit seed for one named stream of ``seed``."""
    h = hashlib.sha256(repr((int(seed),) + names).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(device, seed: int, *names) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        stream_seed(seed, *names))


def layout(cfg: dict) -> Dict[str, Tuple[tuple, object]]:
    """Leaf path -> (shape, init): init is "ones", "embed" or the fan-in of
    a truncated-normal weight. The layout is the program's."""
    L, d, f = cfg["num_hidden_layers"], cfg["hidden_size"], \
        cfg["intermediate_size"]
    H, K, D = cfg["num_attention_heads"], cfg["num_key_value_heads"], \
        head_dim(cfg)
    G, V = H // K, padded_vocab(cfg)
    out = {"embed": ((V, d), "embed"),
           "final_norm/scale": ((d,), "ones"),
           "lm_head": ((d, V), d),
           "layers/attn_norm/scale": ((L, d), "ones"),
           "layers/mlp_norm/scale": ((L, d), "ones"),
           "layers/attn/wq": ((L, d, K, G, D), d),
           "layers/attn/wk": ((L, d, K, D), d),
           "layers/attn/wv": ((L, d, K, D), d),
           "layers/attn/wo": ((L, K, G, D, d), K * G * D),
           "layers/mlp/w_gate": ((L, d, f), d),
           "layers/mlp/w_up": ((L, d, f), d),
           "layers/mlp/w_down": ((L, f, d), f)}
    return out


def unflatten(flat: dict) -> dict:
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = leaf
    return tree


def flatten(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, path + "/"))
        else:
            out[path] = v
    return out


def init_params(cfg: dict, seed: int, device, *names) -> dict:
    """The initial fp32 weights of ``cfg`` for ``seed`` (and the stream
    ``names``, one per trial), as a flat {path: tensor} dict."""
    lay = layout(cfg)
    gen = generator(device, seed, "weights", *names)
    fan = {p: s for p, s in lay.items() if not isinstance(s[1], str)}
    total = sum(math.prod(s) for s, _ in fan.values())
    flat = torch.empty(total, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -3.0, 3.0, generator=gen)
    out, at = {}, 0
    for p, (shape, fan_in) in fan.items():
        n = math.prod(shape)
        out[p] = flat[at:at + n].view(shape).mul_(1.0 / math.sqrt(fan_in))
        at += n
    eshape = lay["embed"][0]
    out["embed"] = torch.randn(eshape, generator=gen, dtype=torch.float32,
                               device=device).mul_(0.02)
    for p, (shape, init) in lay.items():
        if init == "ones":
            out[p] = torch.ones(shape, dtype=torch.float32, device=device)
    return {p: out[p] for p in lay}


def batches(cfg: dict, seed: int, device, batch: int, seq: int, *names):
    """An endless stream of {"tokens", "labels"} batches (B, S) int64 drawn
    from the seed: ids uniform over the configuration's vocabulary (its
    slice), the labels the tokens shifted by one, as the program's
    launcher pairs them."""
    gen = generator(device, seed, "data", *names)
    V = cfg["vocab_size"]
    while True:
        toks = torch.randint(0, V, (batch, seq), generator=gen,
                             device=device, dtype=torch.long)
        yield {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}
