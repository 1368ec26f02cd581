"""The A/B driver over the port's FedMM paths and the dry run's variant
pairs (the counterpart of the reference's ``benchmarks/perf_iterations.py``):
hypothesis -> change -> measure -> validate, one row per variant in
``results/perf_log_torch.json``.

``--pair decode|train|moe`` counts an (arch x shape) pair with each of its
variant levers (``launch.dryrun.compile_one(variant=...)``) beside the
paper-faithful baseline and prints each roofline term's ratio to the
baseline's. It touches no device: ``compile_one`` counts one rank's work on
``meta`` tensors under a fake process group of 256 (512 with
``--multi-pod``) ranks, so its rows are counts, not times. A record that
is already in the log for the same pair, variant and mesh is not counted
again; the baseline is counted first::

    python -m repro_torch.benchmarks.perf_iterations --pair decode
    python -m repro_torch.benchmarks.perf_iterations --pair train --variant no_cv

The six timed modes run on the GPU unless ``--device cpu`` is given (they
never fall back to the CPU), each with the reference's sizes, and replace
only their own pair's rows in the log:

- ``--driver``: rounds/s of ``api.run`` on the federated dictionary
  learning workload, and a hand loop of ``api.step`` over the same draws,
  which must end bit for bit where ``api.run`` ends.
- ``--wire``: the code-space aggregation of 32 clients x 262,144
  coordinates at b 8 and b 4 (``block_quant(b, 256, dither="hash")``): the
  dequantized client stack against the packed codes + scales (footprints
  off the actual buffers), and the time of one quantize + aggregate round
  on each path.
- ``--collective``: the mesh driver's two uplinks (``"gather"``, bit for
  bit the single-device run; ``"reduce"``, allclose to it) on a
  ``"clients"`` mesh over every rank, with the bytes each collective
  moved.
- ``--hier``: the two-tier topology (raw and re-encoded backbone) against
  the flat driver: uplink and backbone bytes a round.
- ``--scheduler``: ``CohortScheduler`` at a population of 256 and of 2,048
  under cohorts of 64, the device's allocated bytes sampled as each
  cohort's data are made, and the bounded-staleness async window.
- ``--faults``: the checksummed wire plus a snapshot every round against
  the bare scheduler.

::

    python -m repro_torch.benchmarks.perf_iterations --wire
    python -m repro_torch.benchmarks.perf_iterations --scheduler --device cpu --log /tmp/perf.json

Departures from the reference, each kept in the rows (``ADDED_KEYS``
lists the keys the port adds to a pair's ``result``; every row also
carries ``"card"``, the ``nvidia-smi`` name and power limit, null off the
GPU):

- ``--driver``: the port has no trajectory ``lax.scan``; its ``api.run``
  is the reference's ``scan=False`` loop over rounds. So
  ``rounds_per_sec_python_loop`` is ``api.run``'s, ``rounds_per_sec_scan``
  and ``speedup`` are null with the reason in ``"scan"``, and
  ``scan_compile_s`` holds the first run's seconds (its warm-up). The hand
  loop's rounds/s and its bit-identity are added.
- ``--wire``: on the GPU the kernels run (the default
  ``KERNEL_DISPATCH_MIN``, where the reference pinned its jnp route): the
  dequantized path launches ``qb_quantize``, the code-space path
  ``qb_encode``. A third path, the compressor's own fused
  ``decode_reduce`` (``qb_decode_reduce`` on the GPU) after the same
  encodes, is timed as ``us_code_space_fused`` with its largest gap from
  the code-space aggregate and whether it is within rtol 1e-5 / atol
  1e-6 of it. The dequantized and code-space rounds are also timed on
  the plain route (``kernel_threshold=1 << 62``, the reference's
  setting), and ``plain_route_bit_identical`` holds both aggregates
  against the plain route's bit for bit. The round's kernel launches
  and the dispatch threshold are recorded.
- ``--collective``/``--hier``: the world is the running process group's
  (under ``torchrun``), or a one-rank group started here (NCCL on the GPU,
  gloo on the CPU) and destroyed at the end; its backend is recorded.
- ``--hier``: the port's two-tier step draws its edge seeds from the
  round's generator, so free runs of flat and two-tier see other draws
  from round 2 on. ``max_abs_diff_vs_flat`` (and the 0.05 test on it)
  is taken from runs on the same draws, off the mesh, with the edge
  seeds from a lane of their own, as the reference's come from a private
  lane (``paired_runs``).
- ``--scheduler``: the peak is ``torch.cuda.memory_allocated`` sampled
  where the reference sampled ``jax.live_arrays()`` (with no garbage
  collection before each sample); on the CPU the two peaks and their
  ratio are null (no device bytes to read).
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import socket
import tempfile
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import api
from ..core import compression as C
from ..core.quadratic import quadratic_for_objective
from ..core.variational import DictLearnSpec, make_dictlearn
from ..data.synthetic import (balanced_kmeans_split, client_minibatch_fn,
                              dictlearn_data, iid_split)
from ..kernels import quantize_block as qb
from ..sched import CohortScheduler, staleness
from ..tree import tree_leaves
from .check_kernel_bench import _card, write_log

DEFAULT_LOG = "results/perf_log_torch.json"

PAIRS = {
    # (arch, shape, [(variant-name, variant-dict, hypothesis)...])
    "decode": ("mistral-large-123b", "decode_32k", [
        ("int8_kv_cache", {"kv_dtype": "int8"},
         "decode is memory-bound on the 1.5TB cache read; int8 codes+scales "
         "halve cache bytes -> memory term ~-40% (weights unchanged)"),
        ("tp_resident", {"fsdp_off": True, "kv_dtype": "int8"},
         "the collective term (~0.6s/token) is FSDP weight all-gathers; "
         "keeping weights TP-resident (P/16 = 15.4 GiB/device) removes them "
         "entirely. Napkin: collective -> ~activation psums only (ms); "
         "memory/device rises to weights+int8 cache ~ 18 GiB (v5p-class, "
         "or combine with int8 weights - future work)"),
        ("tp_megatron", {"fsdp_off": True, "kv_dtype": "int8",
                         "mlp_mode": "megatron"},
         "additionally pair w_out row-parallel: one all-reduce per block "
         "on (B,1,d) activations instead of resharding"),
    ]),
    "train": ("phi3-medium-14b", "train_4k", [
        ("mlp_megatron", {"mlp_mode": "megatron"},
         "generic 2-D layout shards w_out's ff dim over FSDP while the "
         "incoming activations are ff-over-TP from the column-parallel "
         "w_in -> GSPMD reshards every block; pairing w_out row-parallel "
         "over TP leaves ONE all-reduce per block. Napkin: MLP resharding "
         "is ~1/3 of per-layer gathers -> collective -15-20%"),
        ("attn_replicated", {"attn_mode": "replicated"},
         "column-parallel attention (40 heads !% 16) forces per-layer "
         "activation regathers; replicating the 4 attention projections "
         "over 'model' (~25% more weight memory) removes them -> "
         "collective term down"),
        ("megatron_plus_attn", {"mlp_mode": "megatron",
                                "attn_mode": "replicated"},
         "combine both: expected roughly additive collective win"),
        ("no_cv", {"use_cv": False},
         "alpha=0 regime: drop V/V_i -> ~2x params less state (memory "
         "term down) at the cost of Theorem-1 heterogeneity robustness"),
        ("quant4", {"quant_bits": 4},
         "halve the uplink payload accounting 8b->4b: the aggregation "
         "all-reduce itself moves dequantized bf16 under XLA, so the "
         "predicted ICI win is ~0 unless the wire format changes -> "
         "expect REFUTED (documents why a quantized-collective schedule "
         "needs a custom reduction, cf. DESIGN.md hardware note)"),
    ]),
    "moe": ("qwen3-moe-235b-a22b", "train_4k", [
        ("moe_group_1024", {"moe_group": 1024},
         "larger dispatch groups quadruple the one-hot dispatch flops "
         "(O(g) per token) but reduce group-count overhead -> compute "
         "term up, collective roughly flat: expect net LOSS (validates "
         "the group=256 default)"),
        ("no_cv", {"use_cv": False},
         "drop V/V_i on the 235B config: state 5x->3x params; memory "
         "term and temp bytes down enough to approach a 16GB chip"),
        ("mlp_megatron", {"mlp_mode": "megatron"},
         "pair the dense (non-expert) w_out row-parallel as in the phi3 "
         "iteration; experts already contract shard-aligned, so expect a "
         "smaller relative win than phi3's -18%"),
    ]),
}

# the keys each timed pair's ``result`` adds to the reference's (the
# module docstring says why)
ADDED_KEYS = {
    "driver": {"scan", "rounds_per_sec_hand_loop", "hand_loop_bit_identical"},
    "wire": {"device", "kernel_threshold", "launches"},
    "wire_bits": {"us_code_space_fused", "fused_max_abs_diff_vs_code_space",
                  "fused_allclose_vs_code_space", "us_dequant_plain",
                  "us_code_space_plain", "plain_route_bit_identical"},
    "collective": {"backend"},
    "hier": {"backend"},
    "scheduler": set(),
    "faults": set(),
}

SCAN_NOTE = ("the port has no trajectory lax.scan: api.run is the "
             "reference's scan=False per-round loop")
PAIR_NOTE = ("counted on the host on meta tensors under a fake process "
             "group (launch.dryrun.compile_one): counts, no time on a card")

# the reference's fixed sizes of the scheduler mode (a quadratic of
# SCHED_DIM coordinates, cohorts of SCHED_COHORT) and of the faults mode
# (dictlearn p FAULTS_P, K FAULTS_K, FAULTS_SAMPLES samples a client,
# cohorts of FAULTS_COHORT)
SCHED_DIM, SCHED_COHORT = 1 << 14, 64
FAULTS_P, FAULTS_K, FAULTS_SAMPLES, FAULTS_COHORT = 256, 16, 512, 64


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------

def card(dev: torch.device) -> Optional[str]:
    """The GPU's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them; None
    off the GPU."""
    return _card() if dev.type == "cuda" else None


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def bits_equal(a, b) -> bool:
    """Two pytrees of tensors equal bit for bit, leaf by leaf."""
    def same(x, y):
        if not isinstance(x, torch.Tensor):
            return x == y
        if not (isinstance(y, torch.Tensor) and x.shape == y.shape
                and x.dtype == y.dtype):
            return False
        if x.is_floating_point():     # the bits, as integers of the width
            ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
            as_int = ints[x.element_size()]
            x, y = x.view(as_int), y.view(as_int)
        return bool(torch.equal(x, y))
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(same(x, y) for x, y in zip(la, lb))


def _max_abs_diff(a, b) -> float:
    return max(float(torch.max(torch.abs(x - y)))
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _launch_delta(before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in qb.LAUNCHES.items()
            if v - before.get(k, 0)}


def dictlearn_workload(seed: int, n_clients: int, dev: torch.device) -> dict:
    """The Fig. 1 dictionary-learning workload of the driver, collective
    and hier modes (p 30, K 8, 30 ISTA iterations): 2,000 samples drawn on
    the host from ``seed``, a
    balanced k-means split over ``n_clients`` (5 iterations), minibatches
    of 50, ``decaying_stepsize(0.05)``, and the start ``s_bar`` of 64
    samples at a dictionary of N(0, 0.01)."""
    gen = torch.Generator().manual_seed(seed)
    spec = DictLearnSpec(p=30, K=8, lam=0.1, eta=0.2, ista_iters=30)
    z, _ = dictlearn_data(gen, 2000, spec.p, spec.K, device=dev)
    split_seed = int(torch.randint(0, 2**31 - 1, (), generator=gen))
    clients = balanced_kmeans_split(split_seed, z, n_clients=n_clients,
                                    n_iters=5)
    theta0 = (torch.randn((spec.p, spec.K), generator=gen) * 0.1).to(dev)
    problem = api.as_problem(make_dictlearn(spec))
    return {"problem": problem, "z": z,
            "batch_fn": client_minibatch_fn(clients, batch_size=50),
            "gamma": api.decaying_stepsize(0.05),
            "s0": problem.s_bar(z[:64], theta0)}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def process_group(dev: torch.device):
    """Yields the world size of the running process group. Where none
    runs, one is started here and destroyed on exit: from ``torchrun``'s
    environment where it set one, else a one-rank group on a free
    ``localhost`` port; NCCL on the GPU (each rank on its local card),
    gloo on the CPU."""
    started = not dist.is_initialized()
    if started:
        backend = "nccl" if dev.type == "cuda" else "gloo"
        under_torchrun = "RANK" in os.environ and "WORLD_SIZE" in os.environ
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0))
                                  if under_torchrun else 0)
        if under_torchrun:
            dist.init_process_group(backend)
        else:
            dist.init_process_group(
                backend, init_method=f"tcp://localhost:{_free_port()}",
                rank=0, world_size=1)
    try:
        # repro: allow[RPL001] the benchmark lays its client mesh over the whole job, as the reference sizes it off every device
        yield dist.get_world_size()
    finally:
        if started:
            dist.destroy_process_group()


def _timed_run(dev, problem, s0, batch_fn, gamma, **common):
    """``api.run`` twice: the first run warms up, the second is timed.
    Returns (rounds/s, first run's seconds, state, metrics)."""
    t0 = time.perf_counter()
    state, hist = api.run(problem, s0, batch_fn, gamma, **common)
    _sync(dev)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    state, hist = api.run(problem, s0, batch_fn, gamma, **common)
    _sync(dev)
    return common["n_rounds"] / (time.perf_counter() - t0), first_s, \
        state, hist


# ---------------------------------------------------------------------------
# the timed modes
# ---------------------------------------------------------------------------

def bench_driver(rounds: int = 200, log_path: str = DEFAULT_LOG,
                 seed: int = 0, device=None) -> dict:
    """``api.run`` (the per-round loop, with the loss and the mirror
    movement tracked) on the federated dictionary-learning workload (10
    clients, p 0.5, alpha 0.01, ``block_quant(8, 128)``), and a hand loop
    of ``api.step`` over the same generator chain, which must end bit for
    bit equal. Records a ``pair="driver"`` row; returns the entry."""
    dev = api.resolve_device(device)
    gpu = card(dev)
    w = dictlearn_workload(seed, 10, dev)
    fed = api.FederationSpec(n_clients=10, participation=0.5, alpha=0.01,
                             compressor=C.block_quant(8, 128))
    rps_run, first_s, state, _ = _timed_run(
        dev, w["problem"], w["s0"], w["batch_fn"], w["gamma"], spec=fed,
        key=seed, n_rounds=rounds, eval_batch=w["z"][:512],
        track_mirror=True, device=dev)

    gen = torch.Generator().manual_seed(seed)
    gammas = api.resolve_schedule(w["gamma"], rounds)
    loop = api.init(w["problem"], w["s0"], fed, device=dev)
    t0 = time.perf_counter()
    for t in range(rounds):
        loop, _ = api.step(w["problem"], fed, loop, w["batch_fn"](t, gen),
                           gammas[t], gen, device=dev)
    _sync(dev)
    rps_loop = rounds / (time.perf_counter() - t0)
    identical = bits_equal(state, loop)
    entry = {"pair": "driver", "variant": "scan_vs_python_loop",
             "hypothesis": "one lax.scan over the trajectory removes "
             "per-round dispatch + host metric sync -> rounds/sec up",
             "multi_pod": False, "card": gpu,
             "result": {"status": "ok", "rounds": rounds,
                        "rounds_per_sec_python_loop": rps_run,
                        "rounds_per_sec_scan": None, "speedup": None,
                        "scan_compile_s": first_s, "scan": SCAN_NOTE,
                        "rounds_per_sec_hand_loop": rps_loop,
                        "hand_loop_bit_identical": identical}}
    print(f"[driver] rounds/sec: api.run={rps_run:.1f}  hand loop="
          f"{rps_loop:.1f}  (first run {first_s:.1f}s, {rounds} rounds)  "
          f"bit-identical={identical}")
    write_log(log_path, "driver", [entry])
    return entry


def encode_stack(comp, xs, seeds):
    """Each client's payload (``comp.encode`` with its seed), stacked along
    a leading client axis."""
    return C.stack_payloads([comp.encode([s], x) for s, x in zip(seeds, xs)])


def wire_round(comp, xs, seeds, mu, path: str):
    """One client-quantize + server-aggregate round of the wire mode:
    ``"dequant"`` (each client's ``apply``, the f32 stack, a tensordot
    with ``mu``), ``"code_space"`` (the payload stack, ``decode``, the
    tensordot) or ``"fused"`` (the payload stack, ``decode_reduce``).
    ``seeds``: one 32-bit dither seed a client."""
    if path == "dequant":
        q = torch.stack([comp.apply([s], x) for s, x in zip(seeds, xs)])
        return torch.tensordot(mu, q, dims=1)
    payload = encode_stack(comp, xs, seeds)
    if path == "code_space":
        return torch.tensordot(mu, comp.decode(payload), dims=1)
    if path == "fused":
        return comp.decode_reduce(payload, mu)
    raise ValueError(f"unknown wire path {path!r}")


def bench_wire(log_path: str = DEFAULT_LOG, n_clients: int = 32,
               dim: int = 1 << 18, seed: int = 0, device=None) -> dict:
    """Code-space vs dequant-materialized server aggregation. Both paths
    give the same aggregate bit for bit (decode . encode == apply); what
    changes is the n-client stack: n f32 updates against packed codes +
    per-group scales, measured off the actual buffers. Each path is timed
    as the mean of 5 rounds after one warm-up (µs), on inputs and per-client
    dither seeds drawn on the host from ``seed``: on the default dispatch
    (the kernels on the GPU) and, for the dequantized and code-space
    paths, on the plain route (``kernel_threshold=1 << 62``, the
    reference's setting), whose aggregates the default's must equal bit
    for bit. Records a ``pair="wire"`` row; returns the entry."""
    dev = api.resolve_device(device)
    gpu = card(dev)
    gen = torch.Generator().manual_seed(seed)
    xs = torch.randn((n_clients, dim), generator=gen).to(dev)
    seeds = torch.randint(0, 1 << 32, (n_clients,), generator=gen,
                          dtype=torch.int64).tolist()
    mu = torch.full((n_clients,), 1.0 / n_clients, device=dev)
    f32_stack_bytes = n_clients * dim * 4

    def timed(path, comp, reps=5):
        out = wire_round(comp, xs, seeds, mu, path)
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            out = wire_round(comp, xs, seeds, mu, path)
        _sync(dev)
        return (time.perf_counter() - t0) / reps * 1e6, out

    before = dict(qb.LAUNCHES)
    result = {"status": "ok", "n_clients": n_clients, "dim": dim,
              "f32_stack_bytes": f32_stack_bytes, "device": dev.type,
              "kernel_threshold": C.KERNEL_DISPATCH_MIN}
    for bits in (8, 4):
        comp = C.block_quant(bits, 256, dither="hash")
        plain = C.block_quant(bits, 256, dither="hash",
                              kernel_threshold=1 << 62)
        payload_bytes = comp.encoded_bytes(encode_stack(comp, xs, seeds))
        us_deq, agg_d = timed("dequant", comp)
        us_wire, agg_w = timed("code_space", comp)
        us_fused, agg_f = timed("fused", comp)
        us_deq_plain, plain_d = timed("dequant", plain)
        us_wire_plain, plain_w = timed("code_space", plain)
        exact = bits_equal(agg_d, agg_w)
        as_plain = bits_equal(agg_d, plain_d) and bits_equal(agg_w, plain_w)
        gap = float(torch.max(torch.abs(agg_f - agg_w)))
        close = bool(torch.allclose(agg_f, agg_w, rtol=1e-5, atol=1e-6))
        result[f"b{bits}"] = {
            "payload_stack_bytes": int(payload_bytes),
            "footprint_ratio_vs_f32": f32_stack_bytes / payload_bytes,
            "us_dequant_materialized": us_deq,
            "us_code_space": us_wire,
            "aggregate_bit_identical": exact,
            "us_code_space_fused": us_fused,
            "fused_max_abs_diff_vs_code_space": gap,
            "fused_allclose_vs_code_space": close,
            "us_dequant_plain": us_deq_plain,
            "us_code_space_plain": us_wire_plain,
            "plain_route_bit_identical": as_plain,
        }
        print(f"[wire] b={bits}: payload stack {payload_bytes / 2**20:.1f} "
              f"MiB vs f32 {f32_stack_bytes / 2**20:.1f} MiB "
              f"({f32_stack_bytes / payload_bytes:.2f}x smaller)  agg "
              f"{us_deq:.0f}us (dequant) vs {us_wire:.0f}us (code-space) vs "
              f"{us_fused:.0f}us (fused)  bit-identical={exact}  fused gap "
              f"{gap:.2e}  plain route {us_deq_plain:.0f}us / "
              f"{us_wire_plain:.0f}us, bit-identical={as_plain}")
    result["launches"] = _launch_delta(before)

    entry = {"pair": "wire", "variant": "code_space_aggregation",
             "hypothesis": "packed codes + per-group scales at the vmap "
             "boundary shrink the n-client payload stack ~4x (b8) / ~8x "
             "(b4) vs the dequantized f32 stack; round time is comparable "
             "— int8 decode fuses into the reduction (b8 measured "
             "slightly faster, b4 pays the nibble-unpack on CPU)",
             "multi_pod": False, "card": gpu, "result": result}
    write_log(log_path, "wire", [entry])
    return entry


def bench_collective(rounds: int = 100, log_path: str = DEFAULT_LOG,
                     seed: int = 0, device=None) -> list:
    """The mesh driver's two uplinks (the code-space all-gather and the
    fused rank-local reduce) against the single-device path on the Fig. 1
    dictionary-learning workload (p 0.5, alpha 0.01, ``block_quant(8,
    128)``). "gather" is bit for bit the single-device run; "reduce" is
    allclose to it (rtol 1e-5, atol 1e-6: the all-reduce's order). Records
    the rounds/s of each and the bytes each collective moved
    (``collective_payload_bytes``) as two ``pair="collective"`` rows;
    returns them."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = api.resolve_device(device)
    gpu = card(dev)
    with process_group(dev) as n_devices:
        rank = dist.get_rank()
        n_clients = 8 if 8 % n_devices == 0 else n_devices
        w = dictlearn_workload(seed, n_clients, dev)
        comp = C.block_quant(8, 128)
        fed = api.FederationSpec(n_clients=n_clients, participation=0.5,
                                 alpha=0.01, compressor=comp)
        mesh = init_device_mesh(dev.type, (n_devices,),
                                mesh_dim_names=("clients",))
        backend = dist.get_backend(mesh.get_group("clients"))

        def timed(**kw):
            rps, _, state, hist = _timed_run(
                dev, w["problem"], w["s0"], w["batch_fn"], w["gamma"],
                spec=fed, key=seed, n_rounds=rounds, device=dev, **kw)
            return rps, state, hist

        rps_single, st_s, _ = timed()
        rps_gather, st_g, hist_g = timed(mesh=mesh)
        rps_reduce, st_r, hist_r = timed(mesh=mesh, uplink="reduce")
        axis = mesh.size(0)
    gather_identical = bits_equal(st_s.x, st_g.x)
    reduce_close = all(bool(torch.allclose(x, y, rtol=1e-5, atol=1e-6))
                       for x, y in zip(tree_leaves(st_s.x),
                                       tree_leaves(st_r.x)))
    bytes_gather = float(hist_g["collective_payload_bytes"][0])
    bytes_reduce = float(hist_r["collective_payload_bytes"][0])
    s0 = w["s0"]
    model_bytes = sum(x.numel() * x.element_size() for x in tree_leaves(s0))
    f32_stack = n_clients * sum(x.numel() * 4 for x in tree_leaves(s0))
    payload_c = comp.payload_bytes(s0)
    common_r = {"status": "ok", "rounds": rounds, "n_devices": n_devices,
                "n_clients": n_clients,
                "rounds_per_sec_single_device": rps_single,
                "backend": backend}
    entry_g = {
        "pair": "collective", "variant": "uplink_gather",
        "hypothesis": "the uplink as a real code-space all_gather over "
        "the client mesh axis: wire bytes = packed codes + scales (~1/4 "
        "of f32 at b8), trajectory bit-identical; every device holds the "
        "full n-client packed stack and pays the per-round collective "
        "dispatch",
        "multi_pod": False, "card": gpu,
        "result": dict(common_r,
                       rounds_per_sec_shard_mapped=rps_gather,
                       trajectory_bit_identical=gather_identical,
                       collective_wire_bytes_per_round=bytes_gather,
                       per_device_stack_bytes=bytes_gather,
                       f32_stack_bytes_per_round=f32_stack,
                       wire_vs_f32_ratio=f32_stack / bytes_gather)}
    entry_r = {
        "pair": "collective", "variant": "uplink_reduce",
        "hypothesis": "decode + mask + mu-weighted partial-reduce run "
        "shard-local and ONE model-shaped psum crosses the mesh: the "
        "per-device collective operand drops from n*payload to the "
        "model bytes (n/axis_size*payload + model peak), trajectory "
        "allclose to gather (psum reduction order)",
        "multi_pod": False, "card": gpu,
        "result": dict(common_r,
                       rounds_per_sec_shard_mapped=rps_reduce,
                       trajectory_allclose_vs_single=reduce_close,
                       psum_operand_bytes_per_device=bytes_reduce,
                       per_device_memory_bound_bytes=(
                           n_clients / axis * payload_c + model_bytes),
                       gathered_stack_bytes_gone=bytes_reduce < bytes_gather,
                       gather_stack_vs_psum_ratio=bytes_gather
                       / bytes_reduce)}
    print(f"[collective] devices={n_devices} clients={n_clients} "
          f"({backend}): rounds/sec single={rps_single:.1f} "
          f"gather={rps_gather:.1f} reduce={rps_reduce:.1f}")
    print(f"[collective] per-device collective operand: gather stack "
          f"{bytes_gather:.0f}B vs reduce psum {bytes_reduce:.0f}B "
          f"({bytes_gather / bytes_reduce:.2f}x smaller)  "
          f"bit-identical(gather)={gather_identical} "
          f"allclose(reduce)={reduce_close}")
    if rank == 0:
        write_log(log_path, "collective", [entry_g, entry_r])
    return [entry_g, entry_r]


def bench_hier(rounds: int = 100, log_path: str = DEFAULT_LOG,
               seed: int = 0, device=None) -> list:
    """The two-tier (edge -> root) topology against the flat driver on the
    Fig. 1 dictionary-learning workload at full participation (the
    n-client worst case of the uplink). Two-tier ends client payloads at
    the edge tier and ships one buffer an edge over the backbone: the raw
    f32 partial, or with ``reencode=True`` the partial re-quantized
    through the compressor's tier-boundary hook. On a world of an even
    size of at least 2 the run is on the ``(edge, client)`` mesh of half
    as many edges; otherwise 4 edges off the mesh, the same accounting.
    The gap to flat is taken off the mesh on the same draws
    (``paired_runs``). Records two ``pair="hier"`` rows (raw /
    re-encoded); returns them."""
    from ..launch.mesh import make_edge_mesh

    dev = api.resolve_device(device)
    gpu = card(dev)
    with process_group(dev) as n_devices:
        rank = dist.get_rank()
        backend = dist.get_backend()
        if n_devices >= 2 and n_devices % 2 == 0:
            n_edges = n_devices // 2
            mesh_kw = {"mesh": make_edge_mesh(n_edges, 2, device=dev),
                       "client_axis": "client"}
        else:
            n_edges, mesh_kw = 4, {}   # off the mesh: the same accounting
        n_clients = 8 if 8 % n_devices == 0 else n_devices
        w = dictlearn_workload(seed, n_clients, dev)
        comp = C.block_quant(8, 128)

        def fed_for(topo):
            return api.FederationSpec(n_clients=n_clients, participation=1.0,
                                      alpha=0.01, compressor=comp,
                                      topology=topo)

        def timed(topo):
            rps, _, _, hist = _timed_run(
                dev, w["problem"], w["s0"], w["batch_fn"], w["gamma"],
                spec=fed_for(topo), key=seed, n_rounds=rounds, device=dev,
                **mesh_kw)
            return rps, hist

        topos = (api.Topology.flat(), api.Topology.two_tier(n_edges),
                 api.Topology.two_tier(n_edges, reencode=True))
        (rps_flat, hist_f), (rps_raw, hist_r), (rps_re, hist_e) = (
            timed(topo) for topo in topos)

    # both two-tier variants sit within about one 8-bit quantization step
    # of flat: the edge-wise sum's other order flips quantization buckets
    # in the NEXT round's encode, so the gap saturates at the wire's
    # granularity. The free runs above draw their edge seeds from the
    # round's generator (the reference's come from a private lane), so
    # from round 2 they see other minibatches and dithers than flat; the
    # gap is taken from runs on the same draws (``paired_runs``)
    x_f, x_r, x_e = paired_runs(w, [fed_for(topo) for topo in topos],
                                rounds, seed, dev)
    gap_raw, gap_re = _max_abs_diff(x_f, x_r), _max_abs_diff(x_f, x_e)
    uplink = float(hist_f["uplink_bytes"][0])
    bb_raw = float(hist_r["backbone_bytes"][0])
    bb_re = float(hist_e["backbone_bytes"][0])
    common_r = {"status": "ok", "rounds": rounds, "n_devices": n_devices,
                "n_clients": n_clients, "n_edges": n_edges,
                "on_mesh": bool(mesh_kw),
                "rounds_per_sec_flat": rps_flat,
                "uplink_bytes_per_round": uplink,
                "flat_backbone_bytes": float(hist_f["backbone_bytes"][0]),
                "backend": backend}
    entry_raw = {
        "pair": "hier", "variant": "two_tier_raw",
        "hypothesis": "terminating client payloads at the edge tier "
        "leaves ONE f32 model-shaped buffer per edge on the backbone: "
        "backbone bytes = n_edges * model f32, independent of n_clients "
        "— trajectory within one 8-bit quant step of flat (edge-wise "
        "reassociation flips encode buckets, bounded by the wire "
        "granularity)",
        "multi_pod": False, "card": gpu,
        "result": dict(common_r,
                       rounds_per_sec_two_tier=rps_raw,
                       backbone_bytes_per_round=bb_raw,
                       max_abs_diff_vs_flat=gap_raw,
                       trajectory_within_quant_step=gap_raw < 0.05)}
    entry_re = {
        "pair": "hier", "variant": "two_tier_reencode",
        "hypothesis": "the compressor's tier-boundary reencode hook "
        "requantizes each edge partial back into wire format (fresh "
        "digests re-stamped), so the backbone ships n_edges * wire "
        "bytes < the n_clients * wire uplink — at the price of one "
        "extra 8-bit quantization step per round on the trajectory",
        "multi_pod": False, "card": gpu,
        "result": dict(common_r,
                       rounds_per_sec_two_tier=rps_re,
                       backbone_bytes_per_round=bb_re,
                       backbone_vs_uplink_ratio=uplink / bb_re,
                       backbone_below_uplink=bb_re < uplink,
                       backbone_vs_raw_ratio=bb_raw / bb_re,
                       max_abs_diff_vs_flat=gap_re,
                       trajectory_within_quant_step=gap_re < 0.05)}
    print(f"[hier] devices={n_devices} clients={n_clients} "
          f"edges={n_edges} mesh={'on' if mesh_kw else 'off'}: "
          f"rounds/sec flat={rps_flat:.1f} two-tier={rps_raw:.1f} "
          f"reencode={rps_re:.1f}")
    print(f"[hier] per-round bytes: uplink {uplink:.0f}B, backbone raw "
          f"{bb_raw:.0f}B, backbone reencoded {bb_re:.0f}B "
          f"({uplink / bb_re:.2f}x below the uplink)")
    if rank == 0:
        write_log(log_path, "hier", [entry_raw, entry_re])
    return [entry_raw, entry_re]


def paired_runs(w: dict, specs: list, rounds: int, seed: int,
                dev: torch.device) -> list:
    """The final iterate of ``rounds`` rounds of ``api.step`` for each
    federation of ``specs`` (one start, off the mesh), every round on the
    same draws: the minibatch, mask and dither seeds from one generator
    chain seeded by ``seed``, as a flat round draws them, and the
    tier-boundary seeds from a lane of their own (``seed + 1``), as the
    reference's edge keys come from a private lane."""
    gen = torch.Generator().manual_seed(seed)
    lane = torch.Generator().manual_seed(seed + 1)
    problem, batch_fn = w["problem"], w["batch_fn"]
    n_leaves = len(tree_leaves(w["s0"]))
    gammas = api.resolve_schedule(w["gamma"], rounds)
    states = [api.init(problem, w["s0"], spec, device=dev) for spec in specs]
    n_edges = max(spec.topology.n_edges for spec in specs)
    for t in range(rounds):
        batch = batch_fn(t, gen)
        active, seeds = api.participation_draw(gen, specs[0], n_leaves)
        edge_seeds = [C.leaf_seeds(lane, n_leaves) for _ in range(n_edges)]
        states = [api.step(problem, spec, st, batch, gammas[t],
                           active=active, seeds=seeds,
                           edge_seeds=(edge_seeds
                                       if spec.topology.is_two_tier
                                       else None), device=dev)[0]
                  for spec, st in zip(specs, states)]
    return [st.x for st in states]


def bench_scheduler(rounds: int = 20, log_path: str = DEFAULT_LOG,
                    seed: int = 0, device=None) -> dict:
    """``CohortScheduler``: population streaming against the stacked
    driver. The scheduler streams ceil(n/C) cohorts of C clients through
    the client stage and keeps the per-client state in the host arena, so
    the device should hold O(C) whatever n. Records the rounds/s at a
    population of 4 C and of 32 C under the same C (64; dim 16,384, a
    quadratic), the peak of the device's allocated bytes sampled as each
    cohort's data are made (null on the CPU), and the async pipelined
    throughput (a window of two passes, staleness at most 2). Records a
    ``pair="scheduler"`` row; returns the entry."""
    dev = api.resolve_device(device)
    gpu = card(dev)
    dim, csize = SCHED_DIM, SCHED_COHORT

    def loss(b, theta):
        return 0.5 * torch.mean((b - theta) ** 2)

    problem = api.as_problem(quadratic_for_objective(loss, rho=0.05))
    base = torch.from_numpy(
        np.linspace(-1.0, 1.0, dim).astype(np.float32)).to(dev)
    on_gpu = dev.type == "cuda"

    def run_one(n_total, mode="sync", **kw):
        spec = api.FederationSpec(
            n_clients=n_total, participation=0.5, alpha=0.1,
            compressor=C.block_quant(8, 256),
            staleness_weight=(staleness.polynomial(0.5) if mode == "async"
                              else None),
            max_staleness=2 if mode == "async" else None)
        sched = CohortScheduler(problem, spec, cohort_size=csize, device=dev)
        peak = [0]

        def data_fn(t, gen, ids):
            # no collection before the sample (the reference's before
            # jax.live_arrays): torch frees a tensor with its last
            # reference, and the scheduler collects the one cycle that
            # torch.func leaves, after its first cohort
            if on_gpu:
                peak[0] = max(peak[0], torch.cuda.memory_allocated(dev))
            ids = torch.as_tensor(np.asarray(ids), device=dev)
            return base[None, :] + (ids % 13).to(torch.float32)[:, None]

        common = dict(key=seed, n_rounds=rounds, mode=mode, **kw)
        x0 = torch.zeros(dim, device=dev)
        sched.run(x0, data_fn, 0.1, **common)     # warm-up
        t0 = time.perf_counter()
        sched.run(x0, data_fn, 0.1, **common)
        _sync(dev)
        rps = rounds / (time.perf_counter() - t0)
        del sched
        gc.collect()
        return rps, (peak[0] if on_gpu else None)

    n_small, n_big = 4 * csize, 32 * csize
    rps_small, peak_small = run_one(n_small)
    rps_big, peak_big = run_one(n_big)
    k_big = -(-n_big // csize)
    rps_async, _ = run_one(n_big, mode="async", max_inflight=2 * k_big,
                           buffer_cohorts=k_big)
    ratio = peak_big / max(peak_small, 1) if on_gpu else None
    entry = {
        "pair": "scheduler", "variant": "population_streaming",
        "hypothesis": "streaming cohorts of C clients through the driver's "
        "client stage keeps device memory O(C * model + C * payload) while "
        "the population (host variate arena) grows freely; rounds/sec "
        "scales ~1/cohort-count (same total client work, more dispatches), "
        "and the bounded-staleness async window overlaps waves without "
        "growing the device working set",
        "multi_pod": False, "card": gpu,
        "result": {"status": "ok", "rounds": rounds, "dim": dim,
                   "cohort_size": csize,
                   "n_small": n_small, "n_big": n_big,
                   "rounds_per_sec_small": rps_small,
                   "rounds_per_sec_big": rps_big,
                   "rounds_per_sec_async_pipelined_big": rps_async,
                   "peak_device_bytes_small": peak_small,
                   "peak_device_bytes_big": peak_big,
                   "peak_bytes_ratio_big_vs_small": ratio}}
    peaks = ("" if not on_gpu else
             f" peaks {peak_small / 2**20:.1f} vs {peak_big / 2**20:.1f} "
             f"MiB ({ratio:.2f}x)")
    print(f"[scheduler] C={csize} dim={dim}: n={n_small} {rps_small:.1f} "
          f"rounds/s vs n={n_big} {rps_big:.1f} rounds/s, async-2x "
          f"{rps_async:.1f} rounds/s{peaks}")
    write_log(log_path, "scheduler", [entry])
    return entry


def bench_faults(rounds: int = 20, log_path: str = DEFAULT_LOG,
                 seed: int = 0, device=None) -> dict:
    """The fault-tolerance hardening priced against the bare scheduler on
    the same workload: the checksummed wire (a per-leaf uint32 digest on
    every packed payload, verified on decode, 4 B a leaf and client
    billed) and a crash-consistent snapshot after EVERY server update
    (the state, the population arena and the generator chain, published
    atomically; the last 3 kept), into a temporary directory. The
    workload is the Fig. 1 dictionary learning at a population's scale:
    p 256, K 16, 30 ISTA iterations a client round, 256 clients of 512
    samples (an iid split, on the host), cohorts of 64 (the ``FAULTS_*``
    sizes; the population is 4 cohorts). The durability claim is an
    overhead under 5% of rounds/s. Records a ``pair="faults"`` row;
    returns the entry."""
    dev = api.resolve_device(device)
    gpu = card(dev)
    csize = FAULTS_COHORT
    n_total = 4 * csize
    dls = DictLearnSpec(p=FAULTS_P, K=FAULTS_K, lam=0.1, eta=0.2,
                        ista_iters=30)
    gen = torch.Generator().manual_seed(seed)
    z, _ = dictlearn_data(gen, n_total * FAULTS_SAMPLES, dls.p, dls.K,
                          device="cpu")
    clients = iid_split(gen, z, n_total)       # (n, samples, p), host
    on_gpu = dev.type == "cuda"
    if on_gpu:
        clients = clients.pin_memory()
    problem = api.as_problem(make_dictlearn(dls))
    theta0 = torch.randn((dls.p, dls.K), generator=gen) * 0.1
    x0 = problem.s_bar(z[:64].to(dev), theta0.to(dev))

    def data_fn(t, g, ids):
        rows = torch.as_tensor(np.asarray(ids), dtype=torch.int64)
        return clients[rows].to(dev, non_blocking=on_gpu)

    def run_one(checksum, ckpt_dir=None):
        spec = api.FederationSpec(
            n_clients=n_total, participation=0.5, alpha=0.01,
            compressor=C.block_quant(8, 128, checksum=checksum))
        sched = CohortScheduler(problem, spec, cohort_size=csize, device=dev)
        common = dict(key=seed, n_rounds=rounds)
        if ckpt_dir is not None:
            common.update(checkpoint_dir=ckpt_dir, checkpoint_every=1)
        sched.run(x0, data_fn, 0.05, **common)       # warm-up
        t0 = time.perf_counter()
        sched.run(x0, data_fn, 0.05, **common)
        _sync(dev)
        return rounds / (time.perf_counter() - t0)

    rps_bare = run_one(checksum=False)
    with tempfile.TemporaryDirectory() as d:
        rps_hard = run_one(checksum=True, ckpt_dir=d)
        ckpt_files = len([f for f in os.listdir(d) if f.endswith(".snap")])
    overhead = 1.0 - rps_hard / rps_bare
    entry = {
        "pair": "faults", "variant": "checksum_plus_checkpointing",
        "hypothesis": "wire checksums (4 B/leaf/client, verified per "
        "decode) and an atomic fsync'd recovery snapshot every round "
        "price durability at <5% rounds/sec on the cohort scheduler — "
        "the snapshot is host numpy copies of O(model + arena) bytes "
        "and the checksum folds into the already-memory-bound decode",
        "multi_pod": False, "card": gpu,
        "result": {"status": "ok", "rounds": rounds,
                   "workload": f"dictlearn p={dls.p} K={dls.K} "
                   f"ista_iters={dls.ista_iters}",
                   "cohort_size": csize, "n_clients": n_total,
                   "checkpoint_every": 1,
                   "checkpoints_retained": ckpt_files,
                   "rounds_per_sec_bare": rps_bare,
                   "rounds_per_sec_hardened": rps_hard,
                   "overhead_frac": overhead,
                   "overhead_budget_met": bool(overhead < 0.05)}}
    print(f"[faults] dictlearn p={dls.p} K={dls.K} C={csize} n={n_total}: "
          f"bare {rps_bare:.1f} rounds/s vs checksum+ckpt {rps_hard:.1f} "
          f"rounds/s -> overhead {overhead * 100:.1f}% "
          f"(budget <5%: {overhead < 0.05}, {ckpt_files} snapshots kept)")
    write_log(log_path, "faults", [entry])
    return entry


# ---------------------------------------------------------------------------
# the dry run's variant pairs
# ---------------------------------------------------------------------------

def run_pair(pair: str, variant: Optional[str] = None,
             multi_pod: bool = False, log_path: str = DEFAULT_LOG) -> list:
    """Count ``pair``'s baseline (first, where the log lacks it) and each
    variant (only ``variant`` where given) that the log lacks for this
    mesh, appending each record to the log as it is counted, then print
    each counted record's three roofline terms beside their ratio to the
    baseline's. Returns the log's records of the pair on this mesh."""
    from ..launch import dryrun

    arch, shape, variants = PAIRS[pair]
    log = []
    if os.path.exists(log_path):
        with open(log_path) as f:
            log = json.load(f)

    def have(name):
        return any(e["pair"] == pair and e["variant"] == name
                   and e["multi_pod"] == multi_pod for e in log)

    def record(name, hypothesis, var):
        print(f"[{pair}] counting {name} ...", flush=True)
        t0 = time.perf_counter()
        r = dryrun.compile_one(arch, shape, multi_pod, variant=var)
        r["seconds"] = time.perf_counter() - t0
        log.append({"pair": pair, "arch": arch, "shape": shape,
                    "variant": name, "hypothesis": hypothesis,
                    "multi_pod": multi_pod, "card": None,
                    "counted": PAIR_NOTE, "result": r})
        write_log(log_path, pair, [e for e in log if e["pair"] == pair])
        if r["status"] == "ok":
            t = r["roofline"]
            print(f"  -> c={t['compute_s']:.4f}s m={t['memory_s']:.4f}s "
                  f"i={t['collective_s']:.4f}s dom={t['dominant']} "
                  f"peak={r['memory']['peak_bytes'] / 2**30:.1f}GiB "
                  f"({r['seconds']:.1f}s)", flush=True)
        else:
            print(f"  -> {r['status']}: {r.get('error', '')[:200]}",
                  flush=True)

    try:
        if not have("baseline"):
            record("baseline", "paper-faithful configuration", {})
        for name, var, hyp in variants:
            if variant and name != variant:
                continue
            if not have(name):
                record(name, hyp, var)
    finally:
        if dist.is_initialized() and dist.get_backend() == "fake":
            dist.destroy_process_group()

    mine = [e for e in log if e["pair"] == pair
            and e["multi_pod"] == multi_pod]
    base = next(e["result"] for e in mine if e["variant"] == "baseline")
    print(f"\n=== {pair}: {arch} x {shape} ===")
    if base["status"] != "ok":
        print(f"baseline {base['status']}: {base.get('error', '')[:200]}")
        return mine
    bt = base["roofline"]
    for e in mine:
        r = e["result"]
        if r["status"] != "ok":
            print(f"{e['variant']:18s} {r['status']}: {r.get('op')} at "
                  f"{r.get('where')}")
            continue
        t = r["roofline"]
        print(f"{e['variant']:18s} c={t['compute_s']:.4f} "
              f"({t['compute_s'] / max(bt['compute_s'], 1e-12):5.2f}x)  "
              f"m={t['memory_s']:.4f} "
              f"({t['memory_s'] / max(bt['memory_s'], 1e-12):5.2f}x)  "
              f"i={t['collective_s']:.4f} "
              f"({t['collective_s'] / max(bt['collective_s'], 1e-12):5.2f}x)"
              f"  peak={r['memory']['peak_bytes'] / 2**30:7.1f}GiB")
    return mine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pair", choices=list(PAIRS))
    ap.add_argument("--driver", action="store_true",
                    help="time api.run against a hand loop of api.step "
                    "over the same draws (rounds/sec, bit-identity)")
    ap.add_argument("--wire", action="store_true",
                    help="measure the code-space aggregation payload "
                    "footprint + round time vs the dequant-materialized "
                    "path and the fused decode + reduce")
    ap.add_argument("--collective", action="store_true",
                    help="A/B the mesh driver's gather vs reduce uplinks "
                    "against the single-device path + record the measured "
                    "collective bytes of each (two pair='collective' rows)")
    ap.add_argument("--hier", action="store_true",
                    help="A/B the two-tier (edge -> root) topology vs the "
                    "flat driver: per-round uplink vs backbone bytes (raw "
                    "+ reencoded tier boundary) and rounds/sec (two "
                    "pair='hier' rows)")
    ap.add_argument("--scheduler", action="store_true",
                    help="time the cohort scheduler at a small vs 8x "
                    "population under the same cohort size + sample the "
                    "peak allocated device bytes of each (pair='scheduler' "
                    "row)")
    ap.add_argument("--faults", action="store_true",
                    help="price the hardening: checksummed wire + atomic "
                    "per-round recovery snapshots vs the bare scheduler, "
                    "<5%% rounds/sec budget (pair='faults' row)")
    ap.add_argument("--rounds", type=int, default=200,
                    help="trajectory length to time (capped at 200 for "
                    "--collective/--hier, 50 for --scheduler/--faults)")
    ap.add_argument("--variant", default=None,
                    help="run only this named variant (plus baseline if "
                    "missing from the log)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--log", default=DEFAULT_LOG)
    ap.add_argument("--device", default=None,
                    help="the timed modes' device (default: the GPU; "
                    "'cpu' only on request)")
    args = ap.parse_args(argv)
    kw = dict(log_path=args.log, device=args.device)

    if args.driver:
        bench_driver(rounds=args.rounds, **kw)
    elif args.wire:
        bench_wire(**kw)
    elif args.collective:
        bench_collective(rounds=min(args.rounds, 200), **kw)
    elif args.hier:
        bench_hier(rounds=min(args.rounds, 200), **kw)
    elif args.scheduler:
        bench_scheduler(rounds=min(args.rounds, 50), **kw)
    elif args.faults:
        bench_faults(rounds=min(args.rounds, 50), **kw)
    elif args.pair is None:
        ap.error("--pair is required unless --driver/--wire/--collective/"
                 "--hier/--scheduler/--faults is given")
    else:
        run_pair(args.pair, args.variant, args.multi_pod, args.log)


if __name__ == "__main__":
    main()
