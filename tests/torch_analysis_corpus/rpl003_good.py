# ruff: noqa
"""RPL003 non-firing: static tests, `is None`, torch.where, and data-
dependent flow where it is allowed (grad and checkpoint run eagerly)."""
import torch
from torch.utils.checkpoint import checkpoint


def reduce_leading(xs):
    def one(x, v=None):
        if x.dim() > 1:       # shape / ndim / dtype tests are static
            x = x.sum(0)
        if v is not None:     # an identity test reads no data
            x = x + v
        return x

    return torch.func.vmap(one)(xs)


def clip_if_large(xs, thresh):
    return torch.func.vmap(
        lambda x: torch.where(x.sum() > thresh, x * 0.5, x))(xs)


def relu_grad(x):
    # torch.func.grad runs the body eagerly: branching on data is fine
    def f(t):
        if t.sum() > 0:
            return (t ** 2).sum()
        return t.sum()

    return torch.func.grad(f)(x)


def remat(x):
    def body(h):
        if h.abs().max() > 1.0:   # checkpoint recomputes eagerly: fine
            h = h / h.abs().max()
        return h

    return checkpoint(body, x, use_reentrant=False)


def host_extract(t):
    return float(t[0])        # not traced: fine
