"""The H100's roofline (the counterpart of ``repro/launch/roofline.py``).

Three terms per (arch x shape x mesh), all in seconds per device:

    compute    = flops / PEAK_FLOPS_BF16
    memory     = bytes / HBM_BW
    collective = collective_bytes / COLLECTIVE_BW

The card's peaks, from NVIDIA's data sheet of the H100 SXM5 80GB at
700 W: bf16 tensor cores 989e12 FLOP/s (dense), float32 67e12 FLOP/s
(non-tensor-core) and HBM3 3.35e12 B/s. ``chip_smoke.py`` states its
kernels' bounds with the same constants.

``COLLECTIVE_BW`` is 50e9 B/s: one 400 Gb/s NDR InfiniBand port a GPU, as
a DGX H100 is built (eight ConnectX-7 ports for eight GPUs). A dim of 16
of the production mesh spans two 8-GPU NVLink domains, so the slower
link sets the pace of its collectives. ``NVLINK_BW`` (NVLink 4, 450e9 B/s
a direction a GPU) is recorded beside it and used for nothing, as the
reference keeps its one ``ICI_BW``.

The reference reads flops and collective bytes off XLA's partitioned HLO
(``hlo_accounting``, ``collective_bytes_from_hlo``), which PyTorch does
not have. ``count_step`` runs the step instead, under counters that see
each rank's local operations (``DTensor``'s own dispatch desugars into
them):

* flops: ``torch.utils.flop_counter``'s formulas (``flop_registry``, the
  table ``FlopCounterMode`` reads, with the sequence kernels' formulas
  registered by their modules) summed over the local operations;
* collective bytes ``by_kind`` and ``counts`` (all-gather, all-reduce,
  reduce-scatter, all-to-all) from the ``_c10d_functional`` operations
  that ``DTensor`` dispatches, the max of operand and result bytes per
  op, as the reference does. An all-to-all that a CPU mesh replaces by
  an all-gather and a chunk is counted as the all-to-all ``DTensor``
  asked for;
* the peak of live bytes on the device, from
  ``torch.distributed._tools.mem_tracker.MemTracker`` (a private
  PyTorch API): the step's arguments plus what it allocates, local
  shards only.

No HLO exists here, so the reference's loop trip counts have no
counterpart: the port's layers are a Python loop, and every layer runs
and is counted.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..models.sharding import is_dtensor

PEAK_FLOPS_BF16 = 989e12       # bf16 tensor cores, dense
PEAK_FLOPS_F32 = 67e12         # float32, not on the tensor cores
HBM_BW = 3.35e12               # HBM3, bytes/s
COLLECTIVE_BW = 50e9           # one 400 Gb/s NDR port a GPU, bytes/s
NVLINK_BW = 450e9              # NVLink 4, a direction a GPU (not used)

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all")
_OP_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}
# shape queries that carry no work (FlopCounterMode skips them too)
_QUERIES = ("size", "sym_size", "stride", "sym_stride", "storage_offset",
            "sym_storage_offset", "numel", "sym_numel", "dim",
            "is_contiguous", "sym_is_contiguous", "is_strides_like_format",
            "is_non_overlapping_and_dense", "layout")


def _bytes(tree) -> int:
    leaves, _ = tree_flatten(tree)
    return sum(t.numel() * t.element_size() for t in leaves
               if isinstance(t, torch.Tensor))


class _Counters(TorchDispatchMode):
    """Flops and collective bytes of the local operations run inside it
    (``DTensor`` operations are handed back, so their desugaring is seen
    instead)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.flops = 0
        self.by_kind = {k: 0 for k in KINDS}
        self.counts = {k: 0 for k in KINDS}
        self.in_alltoall = False

    def collective(self, kind: str, args, out) -> None:
        self.by_kind[kind] += max(_bytes(args), _bytes(out))
        self.counts[kind] += 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(t is DTensor for t in types):
            return NotImplemented
        name = func._opname if hasattr(func, "_opname") else ""
        if name in _QUERIES:
            return func(*args, **kwargs)
        packet = func._overloadpacket
        if packet not in self.registry:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        if packet in self.registry:
            self.flops += int(self.registry[packet](*args, **kwargs,
                                                    out_val=out))
        kind = _OP_KIND.get(name)
        if (kind is not None and not self.in_alltoall
                and func.namespace in ("_c10d_functional", "c10d_functional",
                                       "_dtensor")):
            self.collective(kind, (args, kwargs), out)
        return out


def _alltoall_counted(counters: _Counters):
    """A stand-in for ``DTensor``'s shard-dim all-to-all that records it as
    one all-to-all whatever the mesh's backend does for it."""
    from torch.distributed.tensor import placement_types as pt
    inner = pt.shard_dim_alltoall

    def counted(input, gather_dim, shard_dim, mesh, mesh_dim):
        counters.in_alltoall = True
        try:
            out = inner(input, gather_dim, shard_dim, mesh, mesh_dim)
        finally:
            counters.in_alltoall = False
        counters.collective("all-to-all", input, out)
        return out

    return pt, inner, counted


def _patched(counters: _Counters):
    """The stand-ins that ``count_step`` installs, as (owner, name, new):
    the counted all-to-all, and ``DTensor``'s sharding propagation run with
    no dispatch mode active (it runs the op on global shapes to learn the
    output's: work no rank does)."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.utils._python_dispatch import _disable_current_modes
    pt, _, counted = _alltoall_counted(counters)
    prop = ShardingPropagator.propagate_op_sharding_non_cached

    def quiet(self, *args, **kwargs):
        with _disable_current_modes():
            return prop(self, *args, **kwargs)

    return [(pt, "shard_dim_alltoall", counted),
            (ShardingPropagator, "propagate_op_sharding_non_cached", quiet)]


def count_step(fn, *args, external=(), peak: bool = True, **kwargs):
    """``fn(*args, **kwargs)`` run under the counters: ``(result,
    {"flops", "collective_bytes", "by_kind", "counts", "peak_bytes"})``,
    all per device (this rank's local operations). ``external``: the
    tensors alive before the call that the peak counts (the step's
    arguments; for a ``DTensor``, its local shard). ``peak=False`` tracks
    no memory (about half the time) and reports a peak of None."""
    import contextlib
    counters = _Counters()
    tracker = None
    if peak:
        # MemTracker is a private PyTorch API (torch.distributed._tools)
        from torch.distributed._tools.mem_tracker import MemTracker
        tracker = MemTracker()
        local = [t.to_local() if is_dtensor(t) else t for t in external]
        if local:
            tracker.track_external(*local)
    patches = _patched(counters)
    kept = [(owner, name, getattr(owner, name)) for owner, name, _ in patches]
    for owner, name, new in patches:
        setattr(owner, name, new)
    try:
        with tracker or contextlib.nullcontext(), counters:
            out = fn(*args, **kwargs)
    finally:
        for owner, name, old in kept:
            setattr(owner, name, old)
    top = None
    if tracker is not None:
        top = max((int(snap.get("Total", 0)) for snap in
                   tracker.get_tracker_snapshot("peak").values()), default=0)
    by_kind = {k: float(v) for k, v in counters.by_kind.items() if v}
    return out, {
        "flops": float(counters.flops),
        "collective_bytes": float(sum(by_kind.values())),
        "by_kind": by_kind,
        "counts": {k: v for k, v in counters.counts.items() if v},
        "peak_bytes": top}


def roofline_terms(flops_per_device: float, bytes_per_device: float,
                   collective_bytes_per_device: float, n_chips: int) -> Dict:
    """The three terms of the counts per device; the chip count enters
    only through the partitioning itself."""
    compute_s = flops_per_device / PEAK_FLOPS_BF16
    memory_s = bytes_per_device / HBM_BW
    collective_s = collective_bytes_per_device / COLLECTIVE_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dominant = max(terms, key=terms.get)
    return {**terms, "dominant": dominant.replace("_s", ""),
            "n_chips": n_chips}


def analytic_bytes(cfg, shape, n_params: int, n_clients: int = 1,
                   client_mode: str = "physical", dp: int = 16,
                   tp: int = 16, n_chips: int = 256) -> float:
    """First-order per-device HBM traffic model (the roofline memory term),
    the reference's arithmetic:

      weights/pass/device = P_bytes / TP   (2-D sharded, fsdp-gathered slab)
      train  = 3 passes x weights x (n sequential clients if logical)
               + FedMM state R/W + activation traffic (c ~= 30 tensor
                 touches/layer incl. backward)
      prefill = weights + activations (c ~= 12) + cache write
      decode  = weights (all experts touched at B*topk >= E) + cache read
    """
    P_b = n_params * 2.0
    d, L = cfg.d_model, cfg.n_layers
    GB, S = shape.global_batch, shape.seq_len
    w_pass = P_b / tp

    att_layers = L
    if cfg.attn_every:
        att_layers = L // cfg.attn_every
    win = cfg.window or S
    cache_b = 0.0
    if cfg.n_heads:
        glob = L // cfg.global_every if cfg.global_every else att_layers
        loc = (L - glob) if cfg.global_every else 0
        kv_bytes = 1 if cfg.kv_dtype == "int8" else 2
        cache_b = (glob * S + loc * min(win, S)) * GB \
            * cfg.n_kv_heads * cfg.hd * 2 * kv_bytes

    if shape.kind == "train":
        tokens_dev = GB * S / dp
        acts = tokens_dev * d * 2 * L * 30
        if client_mode == "logical":
            w = 3 * w_pass * n_clients
            fed = (4 + 3 * n_clients) * P_b / n_chips
        else:
            w = 3 * w_pass
            fed = 8 * P_b / tp
        return w + fed + acts
    if shape.kind == "prefill":
        tokens_dev = GB * S / dp
        return w_pass + tokens_dev * d * 2 * L * 12 + cache_b / n_chips
    # decode: one token per sequence
    return P_b / tp + cache_b / n_chips + GB / dp * d * 2 * L * 12


def model_flops_estimate(cfg, shape, n_params: int) -> float:
    """MODEL_FLOPS = 6 N D (dense) or 6 N_active D (MoE) for training;
    2 N D for a forward-only step (prefill), 2 N_active per decoded token."""
    if cfg.n_experts:
        # active params: replace the E-expert FFN stack by top_k experts
        shapes_factor = cfg.top_k / cfg.n_experts
        # rough split: expert params dominate MoE configs
        expert_params = (cfg.n_layers // cfg.moe_every) * cfg.n_experts \
            * 3 * cfg.d_model * cfg.d_ff
        n_active = n_params - expert_params * (1.0 - shapes_factor)
    else:
        n_active = n_params
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch  # decode: one token/sequence
