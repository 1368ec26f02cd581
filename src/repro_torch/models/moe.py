"""Mixture-of-Experts layer (the port of ``repro/models/moe.py``): a top-k
router over token groups with capacity dropping, and SwiGLU experts.

The function is the reference's. Tokens go in groups of g (at most
``cfg.moe_group``, halved until it divides S; a group never spans two
batch rows). Within a group, the (token, choice) pairs are taken in the
order ``t * k + j``; a pair's position in its expert is the number of
earlier pairs of the group that chose the same expert, and the pair is
kept where that position is below the capacity C = max(1, int(g * k / E
* capacity_factor)). A dropped pair adds nothing, so a token whose
choices all drop gives 0. The gates are the top-k probabilities,
renormalised, rounded to the model dtype before the combine, as the
reference casts its combine tensor. The load-balance loss is E * sum(me
* ce): me the mean probability over all tokens, ce the mean count among
each token's k choices.

The reference dispatches with one-hot einsums, which GSPMD can shard, at
O(g * E * C * d) extra work and a (G, g, E, C) tensor. The port instead
gives each kept pair a row of an expert-major buffer (E, M, d), M the
most pairs any expert keeps (not E * G * C rows: under a no-drop
capacity C = g * k, that would be k * E times the pairs):

* the dispatch scatters the token tensor, expanded k times, into those
  unique rows (a dropped pair into a spare row past the buffer, never
  read), so its backward is a gather and a sum over k, with no atomics;
* one batched product per expert weight (``torch.bmm``);
* the combine gathers each pair's row and sums the k rows times the
  gates in one batched product per token (f32 accumulation, one
  rounding): the sum runs over the choices in top-k order, where the
  reference's einsum sums over (expert, slot).

The router's product is full float32 on every device: TF32 would move
a logit by more than the gap between two experts' probabilities, and the
top-k selection turns that into another expert.

On shape-only ``meta`` tensors no count can be read: the buffer then has
the capacity's rows, M = G * C (every expert full in every group, the
size of the reference's one-hot buffer), and ``DISPATCH`` is not
updated. The buffer's expert dim is laid out over 'experts' (``shard``,
the reference's constraint; the identity without rules).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .sharding import like, shard, whole

# (token, choice) pairs routed and kept, summed over every moe_block call
# since the last reset_dispatch(): the share that capacity dropped
DISPATCH = {"pairs": 0, "kept": 0}


def reset_dispatch() -> None:
    for key in DISPATCH:
        DISPATCH[key] = 0


def moe_init(gen: torch.Generator, cfg, dtype):
    """``"router"`` (d, E) in float32 whatever ``dtype``; ``"experts"``
    ``w_gate``, ``w_in`` (E, d, ff) and ``w_out`` (E, ff, d) in
    ``dtype``. N(0, 1/d_in), drawn on ``gen``'s device one matrix at a
    time, as ``layers.dense_init``."""
    E, d, ff = cfg.n_experts, cfg.d_model, cfg.d_ff

    def matrix(din, dout, dt):
        w = torch.randn((din, dout), generator=gen, device=gen.device)
        return w.mul_(1.0 / math.sqrt(din)).to(dt)

    def stack(din, dout):
        out = torch.empty((E, din, dout), dtype=dtype, device=gen.device)
        for e in range(E):
            out[e] = matrix(din, dout, dtype)
        return out

    return {"router": matrix(d, E, torch.float32),
            "experts": {"w_gate": stack(d, ff), "w_in": stack(d, ff),
                        "w_out": stack(ff, d)}}


def group_size(S: int, group: int) -> int:
    """The reference's ``_group_tokens`` size: ``group`` (at most S),
    halved until it divides S."""
    g = min(group, S)
    while S % g:
        g //= 2
    return g


def _router_logits(xg, router):
    """``xg.float() @ router`` in full float32, TF32 off for the call."""
    x32 = xg.to(torch.float32)
    if x32.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return x32 @ router
        finally:
            torch.backends.cuda.matmul.allow_tf32 = True
    return x32 @ router


def _one_hot(idx, E: int):
    """``F.one_hot(idx, E)``'s int64 values by comparison, a form that a
    ``DTensor`` (no strategy for one_hot's range check) and a ``meta``
    tensor take too."""
    experts = like(torch.arange(E, device=idx.device), idx)
    return (idx[..., None] == experts).to(torch.int64)


def route(params, cfg, x, group: int = 0):
    """The router's decisions for x (B, S, d): ``(g, probs (G, g, E) f32,
    gate (G, g, k) f32 renormalised, eid (G, g, k), pos (G, g, k) the
    position in the expert, C)``."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    g = group_size(S, group or getattr(cfg, "moe_group", 256) or 256)
    G = B * (S // g)
    probs = torch.softmax(_router_logits(x.reshape(G, g, d),
                                         params["router"]), dim=-1)
    gate, eid = torch.topk(probs, k, dim=-1)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    # an exclusive count over the group's pairs in (token, choice) order
    onehot = _one_hot(eid.reshape(G, g * k), E)
    before = onehot.cumsum(1) - onehot
    pos = before.gather(2, eid.reshape(G, g * k, 1)).reshape(G, g, k)
    C = max(1, int(g * k / E * cfg.capacity_factor))
    return g, probs, gate, eid, pos, C


def balance_loss(probs, eid, E: int):
    """E * sum(me * ce), float32: me the mean probability of each expert,
    ce the mean over tokens of its count among the token's k choices."""
    me = probs.mean(dim=(0, 1))
    n_tokens = probs.shape[0] * probs.shape[1]
    # bincount's counts (a DTensor has no strategy for bincount, meta no
    # kernel)
    counts = _one_hot(eid.reshape(-1), E).sum(0)
    ce = counts.to(torch.float32) / n_tokens
    return E * torch.sum(me * ce)


def moe_block(params, cfg, x, group: int = 0):
    """x: (B, S, d) -> (y (B, S, d), aux): the reference's function, with
    the scatter dispatch of the module docstring."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    g, probs, gate, eid, pos, C = route(params, cfg, x, group)
    aux = balance_loss(probs, eid, E)
    G, N = probs.shape[0], B * S

    keep = pos < C                                       # (G, g, k)
    # a kept pair's row within its expert: the pairs its expert keeps in
    # earlier groups, then its position in its own group
    # (counted out of place: a DTensor's in-place scatter into a tensor of
    # another layout has no strategy)
    kept = (_one_hot(eid.reshape(G, g * k), E)
            * keep.reshape(G, g * k, 1)).sum(1)
    earlier = kept.cumsum(0) - kept
    if x.device.type == "meta":
        M = G * C
    else:
        totals = kept.sum(0)
        M, n_kept = (int(v) for v in whole(torch.stack(
            [totals.max(), totals.sum()])).tolist())
        DISPATCH["pairs"] += N * k
        DISPATCH["kept"] += n_kept
    row = eid * M + earlier.gather(1, eid.reshape(G, g * k)) \
        .reshape(G, g, k) + pos
    row = row.reshape(N, k)
    keep = keep.reshape(N, k)

    # dispatch: every kept pair into its own row, dropped ones into the
    # spare row E * M
    xe = x.reshape(N, 1, d).expand(N, k, d)
    buf = x.new_zeros((E * M + 1, d)).index_put(
        (torch.where(keep, row, E * M),), xe)
    buf = shard(buf[:E * M].view(E, M, d), "experts", None, None)

    w = params["experts"]
    h = F.silu(torch.bmm(buf, w["w_gate"])) * torch.bmm(buf, w["w_in"])
    out = torch.bmm(h, w["w_out"]).reshape(E * M, d)

    # combine: each pair's row (a dropped pair reads row 0 at gate 0)
    got = out[torch.where(keep, row, 0)]                 # (N, k, d)
    wts = torch.where(keep, gate.reshape(N, k), 0.0).to(x.dtype)
    y = torch.bmm(wts.unsqueeze(1), got).reshape(B, S, d)
    return y, aux


def moe_block_dense(params, cfg, x, group: int = 0):
    """The reference's one-hot einsum dispatch and combine, written
    densely (a (G, g, E, C) tensor): the plain check of ``moe_block`` in
    the tests. Nothing on the model's path calls it."""
    B, S, d = x.shape
    E = cfg.n_experts
    g, probs, gate, eid, pos, C = route(params, cfg, x, group)
    aux = balance_loss(probs, eid, E)
    G = probs.shape[0]
    mask = F.one_hot(eid, E).to(torch.float32)              # (G, g, k, E)
    keep = (pos < C).to(torch.float32)
    slot = F.one_hot(torch.clamp(pos, max=C - 1), C).to(torch.float32) \
        * keep[..., None]
    dispatch = torch.einsum("ntke,ntkc->ntec", mask, slot).to(x.dtype)
    combine = torch.einsum("ntke,ntkc->ntec", mask * gate[..., None],
                           slot).to(x.dtype)
    xg = x.reshape(G, g, d)
    buf = torch.einsum("ntec,ntd->necd", dispatch, xg)
    w = params["experts"]
    h = F.silu(torch.einsum("necd,edf->necf", buf, w["w_gate"])) \
        * torch.einsum("necd,edf->necf", buf, w["w_in"])
    out_buf = torch.einsum("necf,efd->necd", h, w["w_out"])
    y = torch.einsum("ntec,necd->ntd", combine, out_buf)
    return y.reshape(B, S, d), aux
