"""Step functions: the counterpart of ``repro.launch.steps`` for the dense,
moe and hybrid families. As in the reference, a hybrid's prefill returns
only its attention caches (stacked over groups); its decode starts from
``transformer.init_cache``.

``make_train_state``, ``make_train_step``, ``make_prefill_step`` and
``make_decode_step`` keep the reference's signatures, less the mesh (the
distributed slice brings it, ROADMAP.md queue A) and with an explicit
``torch.Generator`` and device in place of a PRNG key. PyTorch runs eagerly,
so the returned functions need no ``jit``; prefill and decode run under
``torch.inference_mode()``.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch import weights
from repro_torch.models import transformer
from repro_torch.models.transformer import SystemConfig
from repro_torch.optim import optimizers
from repro_torch.tree import tree_leaves


def make_train_state(gen: torch.Generator, cfg, opt: optimizers.Optimizer,
                     device=None):
    """{"params", "opt", "step"}: parameters from ``transformer.init``, the
    optimizer's state, and the step as a Python int."""
    params = transformer.init(gen, cfg, device)
    return {"params": params, "opt": opt.init(params), "step": 0}


def make_train_step(cfg, sys: SystemConfig,
                    opt: optimizers.Optimizer) -> Callable:
    """Returns train_step(state, batch) -> (state, {"loss", "accuracy"}).

    Gradients accumulate over ``sys.microbatches`` (the batch split along
    its first axis) as fp32 sums divided by their number, with loss and
    accuracy averaged over them. The update is applied to the parameters in
    place and ``state`` is returned updated: the counterpart of the
    reference's donated state.
    """
    transformer.require_ported(cfg)
    n_micro = sys.microbatches

    def grads_of(params, batch):
        flat = {path: leaf.detach().requires_grad_()
                for path, leaf in weights.flatten(params).items()}
        loss, metrics = transformer.loss_fn(weights.unflatten(flat), batch,
                                            cfg, sys)
        grads = torch.autograd.grad(loss, list(flat.values()))
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
    """
    transformer.require_ported(cfg)

    @torch.inference_mode()
    def prefill(params, batch):
        S = batch["tokens"].shape[1]
        logits, _, cache = transformer.forward(
            params, batch, cfg, sys, collect_cache=True, last_only=True,
            max_cache=max_len or S)
        return logits, cache
    return prefill


def make_decode_step(cfg, sys: SystemConfig) -> Callable:
    """decode(params, cache, tokens, pos) -> (logits, cache)."""
    transformer.require_ported(cfg)

    @torch.inference_mode()
    def decode(params, cache, tokens, pos):
        return transformer.decode_step(params, cache, tokens, pos, cfg, sys)
    return decode
