"""Step functions: the counterpart of ``repro.launch.steps`` for every
model family: the LM families of ``models.transformer`` and the
encoder-decoder of ``models.encdec`` (``is_encdec``). As in the reference:
a hybrid's prefill returns only its attention caches (stacked over groups)
and an ssm's none, so their decode starts from ``transformer.init_cache``;
a vlm's prompt is ``batch["embeddings"]``; an encoder-decoder's prefill
encodes ``batch["frames"]``, runs the decoder over ``batch["tokens"]`` and
returns its self-attention cache prompt-long, whatever ``max_len`` says,
with the cross cache.

``make_train_state``, ``make_train_step``, ``make_prefill_step`` and
``make_decode_step`` keep the reference's signatures, less the mesh (a
train step sharded over a mesh is not ported: ROADMAP.md, "Distributed")
and with an explicit ``torch.Generator`` and device in place of a PRNG key.
PyTorch runs eagerly, so the returned functions need no ``jit``; prefill
and decode run under ``torch.inference_mode()``.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch import weights
from repro_torch.models import encdec, transformer
from repro_torch.models.transformer import SystemConfig
from repro_torch.optim import optimizers
from repro_torch.tree import tree_leaves


def is_encdec(cfg) -> bool:
    return isinstance(cfg, encdec.EncDecConfig)


def model_loss(params, batch, cfg, sys):
    if is_encdec(cfg):
        return encdec.loss_fn(params, batch, cfg, sys)
    return transformer.loss_fn(params, batch, cfg, sys)


def model_init(gen: torch.Generator, cfg, device=None):
    if is_encdec(cfg):
        return encdec.init(gen, cfg, device)
    return transformer.init(gen, cfg, device)


def make_train_state(gen: torch.Generator, cfg, opt: optimizers.Optimizer,
                     device=None):
    """{"params", "opt", "step"}: parameters from ``model_init``, the
    optimizer's state, and the step as a Python int."""
    params = model_init(gen, cfg, device)
    return {"params": params, "opt": opt.init(params), "step": 0}


def make_train_step(cfg, sys: SystemConfig,
                    opt: optimizers.Optimizer) -> Callable:
    """Returns train_step(state, batch) -> (state, {"loss", "accuracy"}).

    Gradients accumulate over ``sys.microbatches`` (the batch split along
    its first axis) as fp32 sums divided by their number, with loss and
    accuracy averaged over them. The update is applied to the parameters in
    place and ``state`` is returned updated: the counterpart of the
    reference's donated state. A leaf the loss does not use (the vlm's
    ``embed``: its forward starts from the adapter) gets a zero gradient,
    as under ``jax.grad``, and the optimizer still updates it.
    """
    if not is_encdec(cfg):
        transformer.require_ported(cfg)
    n_micro = sys.microbatches

    def grads_of(params, batch):
        flat = {path: leaf.detach().requires_grad_()
                for path, leaf in weights.flatten(params).items()}
        loss, metrics = model_loss(weights.unflatten(flat), batch, cfg, sys)
        grads = torch.autograd.grad(loss, list(flat.values()),
                                    allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), metrics["accuracy"], list(grads), list(flat)

    def train_step(state, batch):
        params = state["params"]
        if n_micro > 1:
            B = next(iter(batch.values())).shape[0]
            if B % n_micro:
                raise ValueError(f"batch {B} does not split into {n_micro} "
                                 "microbatches")
            g_sum, loss_sum, acc_sum = None, 0.0, 0.0
            for i in range(n_micro):
                mb = {k: x.reshape((n_micro, B // n_micro) + x.shape[1:])[i]
                      for k, x in batch.items()}
                loss, acc, grads, paths = grads_of(params, mb)
                if g_sum is None:
                    g_sum = grads
                else:
                    torch._foreach_add_(g_sum, grads)
                loss_sum, acc_sum = loss_sum + loss, acc_sum + acc
            torch._foreach_mul_(g_sum, 1.0 / n_micro)
            grads = g_sum
            loss, acc = loss_sum / n_micro, acc_sum / n_micro
        else:
            loss, acc, grads, paths = grads_of(params, batch)
        grads = weights.unflatten(dict(zip(paths, grads)))
        updates, state["opt"] = opt.update(grads, state["opt"], params,
                                           state["step"])
        with torch.no_grad():
            torch._foreach_add_(tree_leaves(params), tree_leaves(updates))
        state["step"] += 1
        return state, {"loss": loss, "accuracy": acc}

    return train_step


def make_prefill_step(cfg, sys: SystemConfig, max_len: Optional[int] = None
                      ) -> Callable:
    """prefill(params, batch) -> (last-token logits, decode cache).

    max_len sizes the (full-attention) decode cache; default = prompt length.
    An encoder-decoder ignores it, as the reference does.
    """
    if is_encdec(cfg):
        @torch.inference_mode()
        def prefill(params, batch):
            dtype = sys.compute_dtype
            cparams = transformer._cast(params, dtype)
            enc = encdec.encode(cparams, batch["frames"].to(dtype), cfg, sys)
            logits, sk, sv = encdec.decode_train(
                cparams, batch["tokens"], enc, cfg, sys, collect_cache=True,
                last_only=True)
            ck, cv = encdec.build_cross_cache(cparams, enc, cfg)
            return logits, {"self_k": sk, "self_v": sv, "cross_k": ck,
                            "cross_v": cv}
        return prefill
    transformer.require_ported(cfg)

    @torch.inference_mode()
    def prefill(params, batch):
        S = (batch["tokens"].shape[1] if "tokens" in batch
             else batch["embeddings"].shape[1])
        logits, _, cache = transformer.forward(
            params, batch, cfg, sys, collect_cache=True, last_only=True,
            max_cache=max_len or S)
        return logits, cache
    return prefill


def make_decode_step(cfg, sys: SystemConfig) -> Callable:
    """decode(params, cache, tokens, pos) -> (logits, cache)."""
    if is_encdec(cfg):
        @torch.inference_mode()
        def decode(params, cache, tokens, pos):
            return encdec.decode_step(params, cache, tokens, pos, cfg, sys)
        return decode
    transformer.require_ported(cfg)

    @torch.inference_mode()
    def decode(params, cache, tokens, pos):
        return transformer.decode_step(params, cache, tokens, pos, cfg, sys)
    return decode
