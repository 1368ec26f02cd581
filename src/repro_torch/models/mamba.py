"""Mamba-1 selective SSM block (the port of ``repro/models/mamba.py``, for
the Jamba hybrid, arXiv:2403.19887).

  x -> in_proj -> (u, z); causal depthwise conv1d on u; selective SSM with
  input-dependent (Delta, B, C) and diagonal A; gate with silu(z); out_proj.

Recurrence (per channel c, state dim n):
  h_t = exp(Delta_t A) h_{t-1} + Delta_t B_t u_t
  y_t = <C_t, h_t> + D u_t

The reference's scan is plain jnp (no Pallas kernel), and so is the
port's: PyTorch operators, differentiable by autograd (the trainer runs
it under ``torch.utils.checkpoint``; no ``out=`` and no in-place update
of a tensor autograd saves). A full sequence runs in chunks of ``CHUNK``
steps: each chunk's transition tensors dA and dBu (B, ch, di, n) at once,
then one ``torch.addcmul`` a step, then one product with C for the
chunk's states. The recurrence is elementwise, so the chunk length
changes no bit of a state, and y only by the rounding of its sum over n:
the port's scan gives the same values at any S, where the reference
halves its chunk until it divides S (chunks of 1 at an odd S). A decode
step is the plain single-step update, as in the reference.

What the port keeps of the reference's rounding:

* ``A_log`` is float32 in a tree of any dtype; ``dt_bias`` is -4.6 in the
  model dtype;
* the conv state is the raw ``in_proj`` slice before ``silu``, in the
  model dtype, and the new state is the last ``d_conv - 1`` rows of
  ``[state; u]``; the conv is the reference's Python sum of ``d_conv``
  products (each rounded to the model dtype);
* ``softplus`` runs in the model dtype and its result is cast to float32.
  ``F.softplus`` returns x itself above 20, where the reference's
  ``log1p(exp(x))`` adds exp(-x) < 2.1e-9 (below float32's resolution at
  20);
* u, B and C go to float32 for the recurrence; y is cast back to the
  model dtype and only then adds ``u * D`` (in the model dtype);
* decode makes dBu in float32 from the model-dtype B and u, and takes the
  product with C in float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ops
from .layers import dense_init
from .sharding import is_dtensor, like

# the scan's chunk: how many steps' transition tensors exist at a time
CHUNK = 64
# the PyTorch calls the full-sequence scan issued (each one kernel launch
# or more on the card), summed over every ``_ssm_scan`` call since the last
# reset: per chunk, its transition tensors (four calls) and its product
# with C (two), and one ``addcmul`` per step
LAUNCHES = {"ssm_scan": 0}
CALLS_PER_CHUNK = 6


def mamba_init(gen: torch.Generator, cfg, dtype):
    """The reference's tree and leaf names, drawn on ``gen``'s device one
    matrix at a time; ``A_log`` float32 whatever ``dtype``."""
    d = cfg.d_model
    di = cfg.expand * d
    n = cfg.d_state
    dt_rank = max(1, d // 16)
    dev = gen.device
    in_proj = dense_init(gen, d, 2 * di, dtype)
    conv_w = torch.randn((cfg.d_conv, di), generator=gen, device=dev)
    conv_w = conv_w.mul_(0.2).to(dtype)
    w_bc = dense_init(gen, di, 2 * n, dtype)
    w_dt1 = dense_init(gen, di, dt_rank, dtype)
    w_dt2 = dense_init(gen, dt_rank, di, dtype)
    out_proj = dense_init(gen, di, d, dtype)
    a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                   device=dev)).expand(di, n).clone()
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((di,), dtype=dtype, device=dev),
        "w_bc": w_bc,
        "w_dt1": w_dt1,
        "w_dt2": w_dt2,
        "dt_bias": torch.full((di,), -4.6, dtype=dtype, device=dev),
        "A_log": a_log,
        "D": torch.ones((di,), dtype=dtype, device=dev),
        "out_proj": out_proj,
    }


def _conv_causal(u, w, b, conv_state=None):
    """Depthwise causal conv. u: (B, S, di); w: (K, di). conv_state:
    (B, K-1, di) carried tail from previous tokens (decode) or zeros.
    Returns (out, the new state: the last K-1 rows of [state; u], a copy,
    so that a cache does not hold the whole padded sequence)."""
    K, S = w.shape[0], u.shape[1]
    if conv_state is None:
        conv_state = like(u.new_zeros((u.shape[0], K - 1, u.shape[2])), u)
    xpad = torch.cat([conv_state, u], dim=1)                 # (B, S+K-1, di)
    out = xpad[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + xpad[:, i:i + S] * w[i]
    return out + b, xpad[:, -(K - 1):].clone()


def _ssm_scan(u, dt, B, C, A, D, chunk: int = CHUNK):
    """u: (B, S, di) model dtype; dt: (B, S, di) float32; B, C: (B, S, n);
    A: (di, n) float32. Returns (y (B, S, di) in u's dtype, final h
    (B, di, n) float32)."""
    if is_dtensor(u):
        # DTensors: each rank's block of batch rows and channels (the
        # recurrence is per (row, channel), so the blocks need nothing
        # from each other, and a chunk costs a few local calls where a
        # DTensor call costs milliseconds); B, C (B, S, n) split by row,
        # A (di, n) and D (di,) by channel, h (B, di, n) by both
        return ops.on_blocks(
            lambda *a: _ssm_scan(*a, chunk=chunk), (u, dt, B, C, A, D), u,
            {0: (u.shape[0],), 2: (u.shape[2],)},
            (ops.SEQ_DIMS,) * 2 + ({0: 0},) * 2 + ({2: 0},) * 2,
            (ops.SEQ_DIMS, {0: 0, 2: 1}))
    Bb, S, di = u.shape
    n = A.shape[1]
    u32, B32, C32 = u.float(), B.float(), C.float()
    h = like(u32.new_zeros((Bb, di, n)), u32)
    ys = []
    for s in range(0, S, chunk):
        e = min(s + chunk, S)
        dt_c = dt[:, s:e, :, None]                            # (B, ch, di, 1)
        dA = torch.exp(dt_c * A)                              # (B, ch, di, n)
        dBu = dt_c * B32[:, s:e, None, :] * u32[:, s:e, :, None]
        # unbind, not an index a step: autograd then stacks the steps'
        # gradients once a chunk, where an index's backward would write
        # each step's into a zero tensor of the whole chunk
        if u.device.type == "meta":
            # shape-only: the chunk's states in one call (their shapes and
            # bytes, without a call a step; the steps count no flops)
            chunk_states = torch.addcmul(dBu, dA, h[:, None])
            h = chunk_states[:, -1]
        else:
            states = []
            for dA_t, dBu_t in zip(dA.unbind(1), dBu.unbind(1)):
                h = torch.addcmul(dBu_t, dA_t, h)             # dA h + dBu
                states.append(h)
            chunk_states = torch.stack(states, 1)
        ys.append(torch.einsum("bldn,bln->bld", chunk_states, C32[:, s:e]))
        LAUNCHES["ssm_scan"] += CALLS_PER_CHUNK + (e - s)
    y = torch.cat(ys, dim=1).to(u.dtype) + u * D
    return y, h


def mamba_block(params, cfg, x, state=None, single_step=False):
    """x: (B, S, d). state = dict(conv, ssm) or None. Returns (y, new
    state {"conv": (B, d_conv - 1, di) model dtype, "ssm": (B, di, n)
    float32})."""
    di = cfg.expand * x.shape[-1]
    uz = x @ params["in_proj"]
    u, z = uz[..., :di], uz[..., di:]
    conv_state = None if state is None else state["conv"]
    u, new_conv = _conv_causal(u, params["conv_w"], params["conv_b"],
                               conv_state)
    u = F.silu(u)

    bc = u @ params["w_bc"]
    n = cfg.d_state
    Bm, Cm = bc[..., :n], bc[..., n:]
    dt = F.softplus((u @ params["w_dt1"]) @ params["w_dt2"]
                    + params["dt_bias"]).float()
    A = -torch.exp(params["A_log"])

    if single_step:
        if state is None:
            raise ValueError("a decode step needs the layer's state")
        dt0 = dt[:, 0, :, None]
        dA = torch.exp(dt0 * A)
        dBu = dt0 * Bm[:, 0, None, :].float() * u[:, 0, :, None].float()
        h = dA * state["ssm"] + dBu
        y = torch.einsum("bdn,bn->bd", h, Cm[:, 0].float())
        y = (y.to(u.dtype) + u[:, 0] * params["D"])[:, None]
        new_ssm = h
    else:
        y, new_ssm = _ssm_scan(u, dt, Bm, Cm, A, params["D"])

    y = y * F.silu(z)
    return y @ params["out_proj"], {"conv": new_conv, "ssm": new_ssm}
