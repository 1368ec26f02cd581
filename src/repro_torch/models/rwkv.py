"""RWKV6 "Finch" block (the port of ``repro/models/rwkv.py``, arXiv
2404.05892): attention-free token mixing with data-dependent per-channel
decay, plus the RWKV channel-mix FFN.

  time-mix:  token-shift interpolation; projections r,k,v,g; data-dependent
             decay w_t = exp(-exp(w_proj(x_t) + w_bias)); per-head linear
             "WKV" recurrence with state S in R^{hd x hd}:
                 y_t = r_t . (S_t + diag(u) k_t^T v_t)
                 S_{t+1} = diag(w_t) S_t + k_t^T v_t
  channel-mix: token-shift + squared-relu FFN (d -> d_ff -> d).

A full sequence runs the WKV6 kernel (``ops.rwkv_wkv``) where the
reference runs its ``jax.lax.scan``; a decode step stays the plain
``wkv_step``, as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ops
from .layers import dense_init, rmsnorm, rmsnorm_init
from .sharding import like, merge_heads, splittable


def rwkv_block_init(gen, cfg, dtype):
    d, ff = cfg.d_model, cfg.d_ff
    hd = cfg.rwkv_head_dim
    H = d // hd
    dev = gen.device

    def full(value):
        return torch.full((d,), value, dtype=dtype, device=dev)

    u = torch.randn((H, hd), generator=gen, device=dev).mul_(0.1).to(dtype)
    return {
        "tm_norm": rmsnorm_init(d, dtype, dev),
        "cm_norm": rmsnorm_init(d, dtype, dev),
        "mix_r": full(0.5), "mix_k": full(0.5), "mix_v": full(0.5),
        "mix_w": full(0.5), "mix_c": full(0.5),
        "wr": dense_init(gen, d, d, dtype),
        "wk": dense_init(gen, d, d, dtype),
        "wv": dense_init(gen, d, d, dtype),
        "wg": dense_init(gen, d, d, dtype),
        "ww": dense_init(gen, d, d, dtype),   # data-dependent decay proj
        "w_bias": full(-2.0),
        "u": u,
        "wo": dense_init(gen, d, d, dtype),
        "w_in": dense_init(gen, d, ff, dtype),
        "w_out": dense_init(gen, ff, d, dtype),
    }


def _token_shift(x, prev):
    """x: (B, S, d); prev: (B, d) last token of the previous chunk."""
    return torch.cat([prev[:, None], x[:, :-1]], dim=1)


def wkv_step(state, r, k, v, w, u):
    """Single-token decode step. r,k,v,w: (B, H, hd). state: (B, H, hd, hd)."""
    kv = k[..., :, None] * v[..., None, :]
    y = torch.einsum("bhk,bhkv->bhv", r, state + u[None, :, :, None] * kv)
    state = w[..., :, None] * state + kv
    return state, y


def time_mix(params, cfg, x, shift_state, wkv_state=None, single_step=False):
    """x: (B, S, d) (S = 1 when single_step). Returns (y, new_shift, new_wkv)."""
    B, S, d = x.shape
    hd = cfg.rwkv_head_dim
    H = d // hd
    xs = _token_shift(x, shift_state) if not single_step else shift_state[:, None]

    def mixed(mix):
        return x * mix + xs * (1.0 - mix)

    def heads(t):
        return splittable(t, H).reshape(B, S, H, hd)

    r = heads(mixed(params["mix_r"]) @ params["wr"])
    k = heads(mixed(params["mix_k"]) @ params["wk"])
    v = heads(mixed(params["mix_v"]) @ params["wv"])
    # the gate mixes with mix_v (there is no mix_g), as in the reference
    g = F.silu(mixed(params["mix_v"]) @ params["wg"])
    w_raw = mixed(params["mix_w"]) @ params["ww"] + params["w_bias"]
    w = heads(torch.exp(-torch.exp(w_raw.to(torch.float32))))

    if single_step:
        if wkv_state is None:
            raise ValueError("a single step needs the WKV state")
        f32 = torch.float32
        new_state, y = wkv_step(wkv_state, r[:, 0].to(f32), k[:, 0].to(f32),
                                v[:, 0].to(f32), w[:, 0],
                                params["u"].to(f32))
        y = y[:, None].to(x.dtype)
    else:
        # the decay is cast to r's dtype before the scan, as the reference
        # casts it: the state follows the reference's rounding
        y, new_state = ops.rwkv_wkv(r, k, v, w.to(r.dtype), params["u"])
    y = (merge_heads(y) * g) @ params["wo"]
    # a copy of the last row: a view would keep all of x alive in the cache
    return y, x[:, -1].clone(), new_state


def channel_mix(params, cfg, x, shift_state, single_step=False):
    xs = _token_shift(x, shift_state) if not single_step else shift_state[:, None]
    xk = x * params["mix_c"] + xs * (1.0 - params["mix_c"])
    h = torch.square(torch.relu(xk @ params["w_in"]))
    return h @ params["w_out"], x[:, -1].clone()


def rwkv_block(params, cfg, x, state=None, single_step=False):
    """Full RWKV6 block. state = dict(shift_tm, shift_cm, wkv) or None.
    Returns (x_out, new_state)."""
    B = x.shape[0]
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    H = d // hd
    if state is None:
        state = {
            "shift_tm": torch.zeros((B, d), dtype=x.dtype, device=x.device),
            "shift_cm": torch.zeros((B, d), dtype=x.dtype, device=x.device),
            "wkv": torch.zeros((B, H, hd, hd), dtype=torch.float32,
                               device=x.device),
        }
        state = {key: like(t, x) for key, t in state.items()}
    y, new_tm, new_wkv = time_mix(params, cfg, rmsnorm(params["tm_norm"], x),
                                  state["shift_tm"], state["wkv"], single_step)
    x = x + y
    y, new_cm = channel_mix(params, cfg, rmsnorm(params["cm_norm"], x),
                            state["shift_cm"], single_step)
    x = x + y
    new_state = {"shift_tm": new_tm, "shift_cm": new_cm, "wkv": new_wkv}
    return x, new_state
