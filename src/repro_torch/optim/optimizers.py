"""Optax-style optimizers over nested dicts of tensors: the counterpart of
``repro.optim.optimizers``.

An ``Optimizer`` is (init, update):

    state = opt.init(params)
    updates, state = opt.update(grads, state, params, step)
    params = apply_updates(params, updates)

``update`` returns the updates and the state, as in the reference (the
train step then adds the updates to the parameters in place). Both
optimizers write their new moments (adamw's m and v, sgd's mu) into the
state's own tensors, leaf by leaf, and return that state: the counterpart
of the reference's donated train state, which no caller reads again. With
functional moments an adamw step would hold the old and the new m and v and
a clipped copy of the gradients at once, five fp32 copies of the parameters
beside them (about 60 GB more at 2.99 B parameters, more than an 80 GB
card holds). The step is a Python int and a schedule
maps it to a Python float, so a new learning rate needs no new tensor. The
order of work is the reference's: clip by global norm, fp32 moments, bias
correction, then weight decay on the parameter before the update. DTensor
leaves (the sharded step) update shard by shard, the clip's norm taken over
every shard.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch import spmd
from repro_torch.obs import spans
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


def _clip_scale(grads, max_norm):
    """(the factor that brings grads to a global L2 norm of at most
    max_norm, the norm). DTensor gradients: the norm over every shard."""
    gnorm = torch.sqrt(spmd.sum_of_squares(tree_leaves(grads)))
    return torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0), gnorm


def _leafwise(upd, *args):
    """``upd(param, grad, *moments, scale)`` of one leaf; DTensor leaves
    (all of one placement, the scale replicated) shard by shard."""
    if spmd.is_dtensor(args[0]):
        return spmd.elementwise(upd, *args)
    return upd(*args)


def _clipped(g, scale):
    """One gradient leaf in fp32, scaled by ``_clip_scale``'s factor first
    (``scale`` None: no clipping)."""
    return (g if scale is None else g * scale).float()


def clip_by_global_norm(grads, max_norm):
    """(grads scaled to a global L2 norm of at most max_norm, the norm)."""
    scale, gnorm = _clip_scale(grads, max_norm)
    return tree_map(lambda g: g * scale, grads), gnorm


def adamw(schedule, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0,
          clip_norm: Optional[float] = 1.0):
    schedule = schedule if callable(schedule) else constant_schedule(schedule)

    def init(params):
        return {"m": _zeros_like(params), "v": _zeros_like(params)}

    def update(grads, state, params, step, lr_scale=1.0):
        """The updates; state's m and v are overwritten in place, one leaf
        at a time (module docstring)."""
        with spans.span("optim.clip"):
            scale = (_clip_scale(grads, clip_norm)[0]
                     if clip_norm is not None else None)
        lr = schedule(step) * lr_scale
        t = float(step) + 1.0
        mhat_scale = 1.0 / (1.0 - b1 ** t)
        vhat_scale = 1.0 / (1.0 - b2 ** t)

        def upd(p, g, m, v, scale):
            g = _clipped(g, scale)
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * g.square())
            u = (m * mhat_scale) / (torch.sqrt(v * vhat_scale) + eps)
            if weight_decay:
                u = u + weight_decay * p.float()
            return (-lr * u).to(p.dtype)
        with spans.span("optim.update"), torch.no_grad():
            updates = tree_map(lambda *a: _leafwise(upd, *a, scale), params,
                               grads, state["m"], state["v"])
        return updates, state

    return Optimizer(init, update)


def sgd(schedule, momentum=0.9, nesterov=False,
        clip_norm: Optional[float] = None):
    schedule = schedule if callable(schedule) else constant_schedule(schedule)

    def init(params):
        return {"mu": _zeros_like(params)}

    def update(grads, state, params, step, lr_scale=1.0):
        """The updates; state's mu is overwritten in place, one leaf at a
        time (module docstring)."""
        with spans.span("optim.clip"):
            scale = (_clip_scale(grads, clip_norm)[0]
                     if clip_norm is not None else None)
        lr = schedule(step) * lr_scale

        def upd(p, g, mu, scale):
            g = _clipped(g, scale)
            mu.copy_(momentum * mu + g)
            u = g + momentum * mu if nesterov else mu
            return (-lr * u).to(p.dtype)
        with spans.span("optim.update"), torch.no_grad():
            updates = tree_map(lambda *a: _leafwise(upd, *a, scale), params,
                               grads, state["mu"])
        return updates, state

    return Optimizer(init, update)


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)
