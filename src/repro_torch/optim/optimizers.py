"""Optax-style optimizers over nested dicts of tensors: the counterpart of
``repro.optim.optimizers``.

An ``Optimizer`` is (init, update):

    state = opt.init(params)
    updates, state = opt.update(grads, state, params, step)
    params = apply_updates(params, updates)

``update`` is functional, as in the reference: it returns new moments and
updates and changes none of its arguments (the train step then adds the
updates to the parameters in place). The step is a Python int and a schedule
maps it to a Python float, so a new learning rate needs no new tensor. The
order of work is the reference's: clip by global norm, fp32 moments, bias
correction, then weight decay on the parameter before the update.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.tree import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable
    # (grads, state, params, step, lr_scale) -> (updates, state)
    update: Callable


def _zeros_like(params):
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


def constant_schedule(lr):
    return lambda step: float(lr)


def cosine_schedule(lr, total_steps, final_frac=0.1):
    def f(step):
        t = min(step / max(1, total_steps), 1.0)
        return lr * (final_frac + (1 - final_frac)
                     * 0.5 * (1 + math.cos(math.pi * t)))
    return f


def warmup_cosine(lr, warmup_steps, total_steps, final_frac=0.1):
    cos = cosine_schedule(lr, max(1, total_steps - warmup_steps), final_frac)

    def f(step):
        if step < warmup_steps:
            return lr * min(1.0, step / max(1, warmup_steps))
        return cos(step - warmup_steps)
    return f


def clip_by_global_norm(grads, max_norm):
    """(grads scaled to a global L2 norm of at most max_norm, the norm)."""
    gnorm = torch.sqrt(sum(g.float().square().sum()
                           for g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), gnorm


def adamw(schedule, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0,
          clip_norm: Optional[float] = 1.0):
    schedule = schedule if callable(schedule) else constant_schedule(schedule)

    def init(params):
        return {"m": _zeros_like(params), "v": _zeros_like(params)}

    def update(grads, state, params, step, lr_scale=1.0):
        if clip_norm is not None:
            grads, _ = clip_by_global_norm(grads, clip_norm)
        lr = schedule(step) * lr_scale
        t = float(step) + 1.0
        m = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(),
                     state["m"], grads)
        v = tree_map(lambda v, g: b2 * v + (1 - b2) * g.float().square(),
                     state["v"], grads)
        mhat_scale = 1.0 / (1.0 - b1 ** t)
        vhat_scale = 1.0 / (1.0 - b2 ** t)

        def upd(p, m, v):
            u = (m * mhat_scale) / (torch.sqrt(v * vhat_scale) + eps)
            if weight_decay:
                u = u + weight_decay * p.float()
            return (-lr * u).to(p.dtype)
        return tree_map(upd, params, m, v), {"m": m, "v": v}

    return Optimizer(init, update)


def sgd(schedule, momentum=0.9, nesterov=False,
        clip_norm: Optional[float] = None):
    schedule = schedule if callable(schedule) else constant_schedule(schedule)

    def init(params):
        return {"mu": _zeros_like(params)}

    def update(grads, state, params, step, lr_scale=1.0):
        if clip_norm is not None:
            grads, _ = clip_by_global_norm(grads, clip_norm)
        lr = schedule(step) * lr_scale
        mu = tree_map(lambda mu, g: momentum * mu + g.float(), state["mu"],
                      grads)
        if nesterov:
            upd = tree_map(lambda g, mu: g.float() + momentum * mu, grads, mu)
        else:
            upd = mu
        updates = tree_map(lambda p, u: (-lr * u).to(p.dtype), params, upd)
        return updates, {"mu": mu}

    return Optimizer(init, update)


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)
