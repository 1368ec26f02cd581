"""Optimizers on pytrees of tensors: SGD with momentum, Adam and AdamW (the
counterpart of ``repro/optim/optimizers.py``).

They serve as the server optimizer of the FedAdam baseline (Reddi et al.
2021) that Section 7.3 of the paper compares against, as the conjugate
update of FedMM-OT (``core/fedmm_ot.py``), and as substrate for the
examples. Every function is pure: it returns new trees and touches none
of its arguments, so it composes under ``torch.func`` transforms.

Adam's bias corrections are computed in float32 from the int32 step
count, as the reference's ``b1 ** count.astype(float32)`` does: a Python
double would drift from it as the count grows (b2 = 0.999 at count 1,000).
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from ..tree import tree_leaves, tree_map

Pytree = Any


class AdamState(NamedTuple):
    m: Pytree
    v: Pytree
    count: torch.Tensor     # int32, the number of updates taken


def adam_init(params) -> AdamState:
    """Zero moments like ``params``; the count on the first leaf's device."""
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return AdamState(m=tree_map(torch.zeros_like, params),
                     v=tree_map(torch.zeros_like, params),
                     count=torch.zeros((), dtype=torch.int32, device=dev))


def adam_update(params, grads, state: AdamState, lr, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-8,
                weight_decay: float = 0.0):
    """One Adam (AdamW with ``weight_decay``) step: ``(new params, new
    state)``."""
    count = state.count + 1
    m = tree_map(lambda mm, g: b1 * mm + (1 - b1) * g, state.m, grads)
    v = tree_map(lambda vv, g: b2 * vv + (1 - b2) * g * g, state.v, grads)
    t = count.to(torch.float32)
    c1 = 1 - torch.pow(b1, t)
    c2 = 1 - torch.pow(b2, t)

    def upd(p, mm, vv):
        step = lr * (mm / c1) / (torch.sqrt(vv / c2) + eps)
        if weight_decay:
            step = step + lr * weight_decay * p
        return p - step

    return tree_map(upd, params, m, v), AdamState(m=m, v=v, count=count)


class SGDState(NamedTuple):
    momentum: Pytree


def sgd_init(params) -> SGDState:
    return SGDState(momentum=tree_map(torch.zeros_like, params))


def sgd_update(params, grads, state: SGDState, lr, beta: float = 0.0):
    """One SGD step with heavy-ball momentum ``beta``."""
    mom = tree_map(lambda m, g: beta * m + g, state.momentum, grads)
    new_params = tree_map(lambda p, m: p - lr * m, params, mom)
    return new_params, SGDState(momentum=mom)


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """Linear warmup over ``warmup`` steps, then a cosine decay to 0 at
    ``total``: ``lr(step)`` returns a float32 tensor."""
    def lr(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = 0.5 * base_lr * (1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)
    return lr

