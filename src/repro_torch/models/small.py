"""The paper's small workloads (Table 3): the counterpart of
``repro.models.small``.

Type-I:  LeNet5 on MNIST-like 28x28 images (and FASHION-like).
Type-II: TextCNN and LSTM classifiers on News20-like token sequences.

Plain functions over a params dict with the reference's leaf names
(``c1/w``, ``convs/0/w``, ``w_ih``, ...), exposing the reference's
``init``/``forward``/``loss_fn`` surface so the trial runner is
model-agnostic. Hyperparameters (dropout, embedding dim) are config fields
because the paper tunes them. Layouts differ from the reference only where
PyTorch's convolutions want it: conv weights are OIHW (LeNet) and OIW
(TextCNN) where the reference has HWIO and WIO (``weights.from_jax`` maps
them); dense weights are ``(in, out)`` used as ``x @ W``. No TPU kernel is
on this path: convolutions are ``F.conv2d``/``F.conv1d``, as the
reference's are ``lax.conv_general_dilated``.

Dropout draws its mask from a ``torch.Generator`` seeded by ``rng`` (an int
derived from the trial seed, epoch and step) and the reference's salt per
model (LeNet 0, TextCNN 1, LSTM 2). The keep rate and the scaling are the
reference's; the masks are not bit-equal to ``jax.random``'s, which a
``torch.Generator`` cannot reproduce.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from repro_torch.models import layers


@dataclasses.dataclass(frozen=True)
class SmallConfig:
    name: str
    kind: str                    # lenet | textcnn | lstm
    n_classes: int = 10
    image_size: int = 28
    vocab: int = 4096
    seq_len: int = 128
    embed_dim: int = 100         # hyperparameter (paper: 50-300)
    hidden: int = 128
    dropout: float = 0.0         # hyperparameter (paper: 0.0-0.5)
    dtype: Any = torch.float32
    family: str = "small"


def _zeros(n, cfg, gen):
    return torch.zeros((n,), dtype=cfg.dtype, device=gen.device)


# ---------------------------------------------------------------------------
# LeNet5
# ---------------------------------------------------------------------------

def init_lenet(gen: torch.Generator, cfg: SmallConfig):
    d = cfg.dtype
    # conv weights drawn in the reference's HWIO order, stored OIHW
    c1 = layers.dense_init(gen, (5, 5, 1, 6), in_axis_size=25, dtype=d)
    c2 = layers.dense_init(gen, (5, 5, 6, 16), in_axis_size=150, dtype=d)
    return {
        "c1": {"w": c1.permute(3, 2, 0, 1).contiguous(),
               "b": _zeros(6, cfg, gen)},
        "c2": {"w": c2.permute(3, 2, 0, 1).contiguous(),
               "b": _zeros(16, cfg, gen)},
        "f1": {"w": layers.dense_init(gen, (16 * 4 * 4, 120), dtype=d),
               "b": _zeros(120, cfg, gen)},
        "f2": {"w": layers.dense_init(gen, (120, 84), dtype=d),
               "b": _zeros(84, cfg, gen)},
        "out": {"w": layers.dense_init(gen, (84, cfg.n_classes), dtype=d),
                "b": _zeros(cfg.n_classes, cfg, gen)},
    }


def forward_lenet(params, batch, cfg: SmallConfig, *, train=False, rng=None):
    x = batch["images"].to(params["c1"]["w"].dtype)       # (B, 28, 28, 1)
    x = x.permute(0, 3, 1, 2)                              # NCHW
    x = torch.tanh(F.conv2d(x, params["c1"]["w"], params["c1"]["b"]))
    x = F.max_pool2d(x, 2, 2)
    x = torch.tanh(F.conv2d(x, params["c2"]["w"], params["c2"]["b"]))
    x = F.max_pool2d(x, 2, 2)
    # flatten in the reference's NHWC order: f1/w's rows are (h, w, c)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    x = torch.tanh(x @ params["f1"]["w"] + params["f1"]["b"])
    x = _dropout(x, cfg.dropout, train, rng, 0)
    x = torch.tanh(x @ params["f2"]["w"] + params["f2"]["b"])
    return x @ params["out"]["w"] + params["out"]["b"]


# ---------------------------------------------------------------------------
# TextCNN / LSTM classifiers
# ---------------------------------------------------------------------------

def init_textcnn(gen: torch.Generator, cfg: SmallConfig):
    d, E = cfg.dtype, cfg.embed_dim
    embed = layers.embed_init(gen, (cfg.vocab, E), d)
    convs = []
    for k in (3, 4, 5):
        w = layers.dense_init(gen, (k, E, cfg.hidden), in_axis_size=k * E,
                              dtype=d)                     # WIO
        convs.append({"w": w.permute(2, 1, 0).contiguous(),  # OIW
                      "b": _zeros(cfg.hidden, cfg, gen)})
    return {
        "embed": embed,
        "convs": convs,
        "out": {"w": layers.dense_init(gen, (3 * cfg.hidden, cfg.n_classes),
                                       dtype=d),
                "b": _zeros(cfg.n_classes, cfg, gen)},
    }


def forward_textcnn(params, batch, cfg: SmallConfig, *, train=False,
                    rng=None):
    x = params["embed"][batch["tokens"].long()]           # (B, S, E)
    x = x.transpose(1, 2)                                  # (B, E, S)
    feats = []
    for conv in params["convs"]:
        h = torch.relu(F.conv1d(x, conv["w"], conv["b"]))  # (B, H, S-k+1)
        feats.append(h.amax(dim=2))                        # global max pool
    h = torch.cat(feats, dim=-1)
    h = _dropout(h, cfg.dropout, train, rng, 1)
    return h @ params["out"]["w"] + params["out"]["b"]


def init_lstm(gen: torch.Generator, cfg: SmallConfig):
    d, E, H = cfg.dtype, cfg.embed_dim, cfg.hidden
    return {
        "embed": layers.embed_init(gen, (cfg.vocab, E), d),
        "w_ih": layers.dense_init(gen, (E, 4 * H), dtype=d),
        "w_hh": layers.dense_init(gen, (H, 4 * H), dtype=d),
        "b": _zeros(4 * H, cfg, gen),
        "out": {"w": layers.dense_init(gen, (H, cfg.n_classes), dtype=d),
                "b": _zeros(cfg.n_classes, cfg, gen)},
    }


class _LSTMRecurrence(torch.autograd.Function):
    """The LSTM's time loop: the last hidden state of
    c_t = f_t c_{t-1} + i_t g_t, h_t = o_t tanh(c_t) from h_0 = c_0 = 0,
    with z_t = xw_t + h_{t-1} @ w_hh split into gates i, f, g, o (sigmoid,
    sigmoid, tanh, sigmoid).

    Written as one autograd node with its own backward through time
    because on the card a step is a few small kernels and the host's launch
    rate sets the time: a forward step is one ``addmm`` and six elementwise
    kernels writing into preallocated buffers; a backward step is two
    elementwise kernels, a concatenation and one product, with the
    activations' derivatives and ``w_hh``'s gradient computed once over all
    steps."""

    @staticmethod
    def forward(ctx, xw, w_hh):
        B, S, G = xw.shape
        H = G // 4
        xw = xw.transpose(0, 1).contiguous()                  # (S, B, 4H)
        hs = xw.new_zeros((S + 1, B, H))                      # h_0 .. h_S
        cs = xw.new_zeros((S + 1, B, H))
        acts = torch.empty_like(xw)                           # i, f, g, o
        for t in range(S):
            z = torch.addmm(xw[t], hs[t], w_hh)
            a = acts[t]
            torch.sigmoid(z, out=a)
            torch.tanh(z[:, 2 * H:3 * H], out=a[:, 2 * H:3 * H])
            i, f, g, o = a.chunk(4, dim=-1)
            torch.addcmul(f * cs[t], i, g, out=cs[t + 1])
            torch.mul(o, torch.tanh(cs[t + 1]), out=hs[t + 1])
        ctx.save_for_backward(w_hh, hs, cs, acts)
        return hs[S].clone()

    @staticmethod
    @once_differentiable
    def backward(ctx, dh):
        w_hh, hs, cs, acts = ctx.saved_tensors
        S, B, G = acts.shape
        H = G // 4
        i, f, g, o = acts.chunk(4, dim=-1)
        tc = torch.tanh(cs[1:])
        dact = acts * (1 - acts)                  # sigmoid' of i, f, o
        dact[..., 2 * H:3 * H] = 1 - g * g         # tanh' of g
        # dz_t = [dc, dc, dc, dh] * M_t
        mult = torch.cat([g, cs[:-1], i, tc], dim=-1) * dact
        o_dtc = o * (1 - tc * tc)                  # dh_t -> dc_t
        dz = torch.empty_like(acts)
        dc = torch.zeros_like(dh)
        w_hh_t = w_hh.t()
        for t in range(S - 1, -1, -1):
            dc = torch.addcmul(dc, dh, o_dtc[t])
            torch.mul(torch.cat([dc, dc, dc, dh], dim=-1), mult[t], out=dz[t])
            dh = dz[t] @ w_hh_t
            dc = dc * f[t]
        dw_hh = hs[:-1].reshape(S * B, H).t() @ dz.reshape(S * B, G)
        return dz.transpose(0, 1), dw_hh


def forward_lstm(params, batch, cfg: SmallConfig, *, train=False, rng=None):
    """Gates i, f, g, o with ``sigmoid(f + 1.0)``, as the reference's scan:
    the input projection of every step, with ``b`` and the forget gate's
    +1.0 folded in, is one product before the loop (``_LSTMRecurrence``)."""
    x = params["embed"][batch["tokens"].long()]           # (B, S, E)
    H = cfg.hidden
    forget_one = torch.zeros(4 * H, dtype=x.dtype, device=x.device)
    forget_one[H:2 * H] = 1.0
    xw = x @ params["w_ih"] + (params["b"] + forget_one)
    h = _LSTMRecurrence.apply(xw, params["w_hh"])
    h = _dropout(h, cfg.dropout, train, rng, 2)
    return h @ params["out"]["w"] + params["out"]["b"]


# ---------------------------------------------------------------------------
# shared surface
# ---------------------------------------------------------------------------

_INIT = {"lenet": init_lenet, "textcnn": init_textcnn, "lstm": init_lstm}
_FWD = {"lenet": forward_lenet, "textcnn": forward_textcnn,
        "lstm": forward_lstm}


def _dropout(x, rate, train, rng: Optional[int], salt: int):
    """Inverted dropout: keep with probability 1 - rate, scale by
    1 / (1 - rate). The mask comes from a generator on ``x``'s device
    seeded by (rng, salt), so a recompute (remat) draws the same mask."""
    if not train or rate <= 0.0 or rng is None:
        return x
    gen = torch.Generator(device=x.device)
    gen.manual_seed((int(rng) * 1000003 + salt) % 2**63)
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def init(gen: torch.Generator, cfg: SmallConfig):
    """Parameters of ``cfg`` drawn from ``gen``, on ``gen``'s device. The
    distributions are the reference's; the numbers differ, since a
    ``torch.Generator`` is not ``jax.random``."""
    return _INIT[cfg.kind](gen, cfg)


def forward(params, batch, cfg: SmallConfig, *, train=False, rng=None):
    return _FWD[cfg.kind](params, batch, cfg, train=train, rng=rng)


def loss_fn(params, batch, cfg: SmallConfig, rng=None):
    """(mean cross-entropy, {"loss", "accuracy"}) of a training forward."""
    logits = forward(params, batch, cfg, train=True, rng=rng)
    labels = batch["labels"].long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[:, None])[:, 0]
    loss = torch.mean(lse - gold)
    acc = torch.mean((torch.argmax(logits, -1) == labels).float())
    return loss, {"loss": loss, "accuracy": acc}
