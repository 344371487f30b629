"""Minimal optimizers over trees of tensors — port of
``repro/optim/optimizers.py``.

The API mirrors optax: ``init(params) -> state``, ``update(grads, state,
params) -> (updates, state)``; apply with ``apply_updates``.  Every
function is pure: it returns new tensors and changes none it was given.

Capture: the step count is a 0-d int32 tensor on the params' device, and
the learning rate and Adam's bias corrections are computed from it on the
device.  Every constant is a device fill, so an update is safe to record
as a CUDA graph (``core/driver.py``) and reads nothing back to the host.
Divisions are by tensors, as ``jnp`` divides, since CUDA turns a division
by a Python scalar into a multiply by its reciprocal.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch import tree


class SGDState(NamedTuple):
    momentum: Any
    count: torch.Tensor


class AdamState(NamedTuple):
    mu: Any
    nu: Any
    count: torch.Tensor


def _full(like, value):
    """A 0-d fp32 device fill on ``like``'s device."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def _zeros_like(params):
    return tree.map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


def _count0(params):
    return torch.zeros((), dtype=torch.int32,
                       device=tree.leaves(params)[0].device)


def global_norm(t):
    ls = tree.leaves(t)
    total = torch.zeros((), dtype=torch.float32, device=ls[0].device)
    for leaf in ls:
        total = total + torch.sum(torch.square(leaf.float()))
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm):
    norm = global_norm(grads)
    scale = torch.clamp(_full(norm, max_norm) / torch.clamp(norm, min=1e-12),
                        max=1.0)
    return tree.map(lambda g: g * scale.to(g.dtype), grads), norm


def sgd(lr_fn, momentum=0.9):
    def init(params):
        return SGDState(_zeros_like(params), _count0(params))

    def update(grads, state, params=None):
        mu = tree.map(lambda m, g: momentum * m + g.float(), state.momentum,
                      grads)
        lr = lr_fn(state.count)
        upd = tree.map(lambda m: -lr * m, mu)
        return upd, SGDState(mu, state.count + 1)

    return init, update


def adamw(lr_fn, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0):
    def init(params):
        return AdamState(_zeros_like(params), _zeros_like(params),
                         _count0(params))

    def update(grads, state, params):
        c = state.count + 1
        mu = tree.map(lambda m, g: b1 * m + (1 - b1) * g.float(), state.mu,
                      grads)
        nu = tree.map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()),
                      state.nu, grads)
        one = _full(c, 1.0)
        bc1 = one - torch.pow(_full(c, b1), c.float())
        bc2 = one - torch.pow(_full(c, b2), c.float())
        lr = lr_fn(state.count)

        def upd(m, v, p):
            step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                step = step + weight_decay * p.float()
            return -lr * step

        return tree.map(upd, mu, nu, params), AdamState(mu, nu, c)

    return init, update


def apply_updates(params, updates):
    return tree.map(lambda p, u: (p.float() + u).to(p.dtype), params, updates)


def make_optimizer(train_cfg):
    lr_fn = warmup_cosine(train_cfg.lr, train_cfg.warmup_steps,
                          train_cfg.total_steps)
    if train_cfg.optimizer == "sgd":
        return sgd(lr_fn)
    if train_cfg.optimizer in ("adam", "adamw"):
        wd = train_cfg.weight_decay if train_cfg.optimizer == "adamw" else 0.0
        return adamw(lr_fn, train_cfg.b1, train_cfg.b2, train_cfg.eps, wd)
    raise ValueError(train_cfg.optimizer)


def warmup_cosine(peak, warmup, total):
    """Linear warm-up to ``peak`` over ``warmup`` steps, then a cosine decay
    to 0 at ``total``; ``lr(count)`` of a 0-d int tensor, on its device."""
    def lr(step):
        step = step.float()
        warm = peak * (step + 1) / _full(step, max(warmup, 1))
        prog = torch.clamp((step - warmup) / _full(step, max(total - warmup,
                                                             1)), 0.0, 1.0)
        cos = peak * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)

    return lr
