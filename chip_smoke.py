#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port on one GPU and check it.

    python3 chip_smoke.py            # what the checks need
    python3 chip_smoke.py --profile  # and a torch.profiler breakdown

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit. It builds the five kernel sources of
``src/repro_torch/kernels/csrc/`` (one ``nvcc`` each, started together),
checks every kernel against its plain PyTorch version at the main paths'
shapes and times both, then drives the port's paths through their entry
points at full width and checks what comes out:

1. one FedMM round of Algorithm 2 (``repro_torch.api.run``/``step`` and
   the ``Compressor`` methods), which runs the quantizer kernels; then
   the same workload on the mesh paths (the ``mesh`` phase:
   ``torch.distributed`` started in this process at world size 1 over
   NCCL, a CUDA ``DeviceMesh``, ``uplink="gather"`` and ``"reduce"``,
   the two-tier topology off and on a 1 x 1 ``(edge, client)`` mesh,
   the per-shard quantizer wrappers on a ``DTensor``), which runs the
   fused decode + reduce kernel inside every reduce round; then the same
   workload through the cohort scheduler (the ``sched`` phase:
   ``repro_torch.sched.CohortScheduler`` in sync and async mode at cohort
   sizes 16 and 4, a population of 256 clients, the fault axis, a kill
   and ``resume()``, the reduce uplink on the mesh and the two-tier
   topology), which runs the encode kernel in every cohort and the fused
   decode + reduce in every cohort of a reduce uplink; and, right after
   the first rounds, the runtime checks (the ``sanitize`` phase): two
   rounds with ``sanitize=True, audit_keys=True`` bit for bit the first
   two of the plain run (the comm-bytes audit on the kernel-encoded
   buffers), a NaN planted in one client's oracle output flagged at the
   ``oracle`` stage (and laundered, finite, without the flag), one
   audited and sanitized scheduler round bit for bit the plain one, and
   ``check_compressor`` of the in-kernel-dither quantizer over
   gemma3-12b's full-width parameter tree on ``meta`` tensors (a child
   process run beside the build, which first runs the port's linter, as
   ``python -m repro_torch.analysis src/repro_torch --strict``: the
   ``lint`` record, exit 0 required);
2. serving (``repro_torch.launch.serve.serve``: prefill, then greedy
   decode with the ring-buffer KV cache) of phi3-medium-14b (40 layers,
   bf16, the flash-attention kernel in every prefill layer; then the
   int8 KV cache), of rwkv6-3b (32 layers, bf16, the WKV6 kernel in
   every prefill layer) and of gemma3-12b (48 layers, hd 256, bf16: the
   flash kernel in every prefill layer, 40 of them with the local window
   of 1024 and a ring cache, 8 global; then the int8 KV cache) and of
   qwen3-moe-235b-a22b (8 of its 94 layers, bf16: flash at a GQA group
   of 16 in every prefill layer, then the mixture of experts, 128
   experts, top 8; then the int8 KV cache) and of jamba-1.5-large-398b
   (layers 4-7 of its first period, bf16: three Mamba layers, whose
   selective scan is plain PyTorch as in the reference, and one attention
   layer without RoPE, flash at a GQA group of 8; the mixture of experts,
   16 experts, top 2, in layers 5 and 7; then the int8 KV cache) and of
   internvl2-26b (48 layers, 256 stub patch embeddings before each
   prompt: flash at a GQA group of 6 over 2,304 positions; then the int8
   KV cache), random weights from a seed, batch 4, 2048-token prompts;
   and of whisper-base (6 encoder layers over 1,500 stub frame
   embeddings, non-causal, and 6 decoder layers, each with a causal
   self-attention and a cross attention over the frames: 18 flash
   launches a prefill, hd 64; no int8 cache, ROADMAP Queue C item 7),
   batch 16, 227-token prompts (whisper's longest prefill), 221 new
   tokens; plus a decode-consistency check of each
   on a full-width two-layer float32 build (gemma3's one local and one
   global layer, at prompts of 2048, 1500 and 600 tokens; qwen3's and
   jamba's with a capacity that drops nothing; internvl's with its
   patches; whisper's at full depth); and before them the default serve
   command (``--preset smoke``, reduced float32 configs) of each arch,
   llama4-maverick-400b-a17b's too;
3. the paper's figures (``repro_torch.benchmarks``): Fig. 1 (FedMM against
   naive parameter-space aggregation) and Fig. 2 (control variates) of
   federated dictionary learning at the paper's sizes on its three data
   settings over 150 of its 300 rounds, with the figures' outcomes as
   gates, and 10 FedMM rounds run on the GPU and on the CPU from the same
   data and draws; then Fig. 3 (FedMM-OT, Algorithm 3, against FedAdam:
   ICNN potentials, L2-UVP against the closed-form Gaussian map) at the
   paper's ``--full`` sizes, dims 16, 32 and 64, gated at d = 16 over the
   paper's 100 rounds (32 and 64, reported only, over 20), with 10
   FedMM-OT rounds run on the GPU and on the CPU from the same draws.
   These run in a child process of the script (``start_figures``) beside
   phase 1's mesh and scheduler runs, which like them are bound by the
   host and gate no time, and their records are printed after phase 1's;
   their leaves are too small for the kernel route, so they launch no
   kernel of the port; after the child has ended, the A/B driver's six
   timed modes (the ``perf_iterations`` phase: ``repro_torch.benchmarks.
   perf_iterations`` at the reference's sizes over a few of its rounds,
   its log in a temporary file): ``api.run`` against a hand loop of
   ``api.step``, the wire mode's 32 x 262,144 stacks at b 8 and b 4
   (``qb_quantize``, ``qb_encode`` and ``qb_decode_reduce``, the
   aggregates bit for bit the plain route's), the mesh
   uplinks on a one-rank NCCL group, two-tier against flat, the
   scheduler's device peak at populations of 256 and 2,048, and the price
   of checksums and a snapshot every round; the reference's byte counts
   and the trajectories' agreement are its gates;
4. training (the ``train`` phase, after serving): the backward kernels of
   flash attention (fed the forward's log-sum-exp, the same bits on a
   second launch) and WKV6 against their plain versions, FedMM training
   of gemma3-12b (6 layers), rwkv6-3b (8 layers), qwen3-moe-235b-a22b
   (1 layer), jamba-1.5-large-398b (its first layer, a Mamba layer),
   whisper-base (full depth, 448 tokens and 1,500 frames a client) and
   internvl2-26b (4 of 48 layers, 256 patches and 2,048 tokens a client)
   at full width through ``repro_torch.fed.trainer.make_train_step``
   (the forward and backward kernels in every attention or rwkv layer,
   ``qb_encode`` on every leaf of at least 65,536 elements whose group
   is not 1); then ``train_mesh``: gemma3-12b's run again, its model,
   initial iterate and batches, as 2 physical silos off the mesh and on
   a one-rank NCCL ``DeviceMesh`` with the gather and the reduce uplink,
   each round from one state with the same draws (the fused decode +
   reduce on each layer's ``wq`` in every reduce round);
   ``repro_torch.launch.train`` at the ``100m`` and ``smoke`` presets,
   and three smoke rounds on the card against the CPU; then the kernel
   microbenchmarks (the ``kernel_bench`` phase: ``repro_torch.
   benchmarks.kernel_bench``'s ``--smoke`` rows, once, each kernel row
   launching its CUDA kernel; times only, no gate; then each kernel
   row's call held against its plain version on the same tensors);
5. the roofline (the ``roofline`` phase, the card idle): each timed
   prefill and train round beside the same step counted on ``meta``
   tensors at one chip (the dry run's ``count_serve`` and
   ``count_train_step``) in a child process that starts beside the
   kernels' build and counts once the train phase is over; and the dry
   run's whisper-base ``decode_32k`` (the ``dryrun`` phase), a child
   process run beside the build and joined here.

Each phase prints one JSON line, and a line on standard error with the
seconds since the start; the last line is ``{"ok": true,
"device": {...}}``. Any failed check raises and the script exits
non-zero; so does a run still going after 1170 s, which first prints
every thread's stack on standard error. Without a CUDA device it exits
non-zero and prints no result.
TF32 is off for every float32 product (``allow_tf32 = False`` for matmul
and cuDNN).

The FedMM workload: the quadratic surrogate (Example 1) of a federated
multi-output least-squares objective
``loss(batch, theta) = 1/2 mean_b ||x_b @ theta["w"] + theta["b"] - y_b||^2``
whose iterate is one full-width phi3-medium-14b MLP projection
(``configs/phi3_medium_14b.py``: d_model 5120, d_ff 17920), so
``theta["w"]`` is (5120, 17920) float32, 91,750,400 elements, and takes the
kernel route; ``theta["b"]`` (17920,) takes the plain route. 16 clients
(the trainer's silo count at this size), participation 0.5, alpha 0.1,
control variates from zero, ``block_quant(8, 256, dither="hash")``,
256 examples per client, weights and data random from a seed. Reduced:
one projection instead of the model's 40 layers x 7 matrices.
"""
from __future__ import annotations

import atexit
import ctypes
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

# deterministic cuBLAS workspaces: the "kernel" and "hash" runs compare bits
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

D_MODEL, D_FF = 5120, 17920       # configs/phi3_medium_14b.py
N_CLIENTS, BATCH = 16, 256
PARTICIPATION, ALPHA = 0.5, 0.1
BITS, BLOCK = 8, 256
ROUNDS = 5
MESH_ROUNDS = 3
GAMMA = 0.5
RHO = 0.02                        # <= 1 / L: L ~ 30 for unit-normal x
SEED = 0

# the serving path: batch, prompt and new tokens of every serve phase
SERVE_BATCH, PROMPT_LEN, NEW_TOKENS, NEW_TOKENS_INT8 = 4, 2048, 32, 8
# qwen3-moe-235b-a22b served at full width, 8 of its 94 layers: 19.9 B
# layer parameters and 1.25 B of embedding and head, 42 GB in bf16
SERVE_QWEN3 = {"n_layers": 8}
# jamba-1.5-large-398b served at full width, layers 4-7 of its first period
# of 8 ([mamba_mlp, mamba_moe, mamba_mlp, attn_moe]: every kind it has, in
# the period's order, 23.0 B parameters, 46 GB in bf16; the whole period,
# 45.2 B, does not fit one card)
SERVE_JAMBA = {"n_layers": 4, "attn_every": 4}
# whisper-base served at full width and depth (6 encoder and 6 decoder
# layers, 109.9 M parameters), batch 16, 1,500 frames a request, with the
# longest request whisper's own decoder makes (openai/whisper,
# whisper/decoding.py, DecodingTask): _get_initial_tokens keeps the last
# n_text_ctx // 2 - 1 = 223 prompt tokens after sot_prev and before the
# 3-token SOT sequence (start, language, task), a 227-token prefill;
# _main_loop samples at most sample_len = n_text_ctx // 2 = 224 tokens
# and stops when the sequence outgrows the 448-token text context: 221
# new tokens. Training fills the text context.
WHISPER_TEXT_CTX = 448
WHISPER_BATCH, WHISPER_PROMPT = 16, 1 + (WHISPER_TEXT_CTX // 2 - 1) + 3
WHISPER_NEW_TOKENS = WHISPER_TEXT_CTX - WHISPER_PROMPT
# the serve runs: phase -> ``serve_model``'s arguments, the arch and what
# differs from the defaults (batch 4, PROMPT_LEN, NEW_TOKENS, then
# NEW_TOKENS_INT8 with the int8 cache, a two-layer decode check at
# PROMPT_LEN). gemma3's check at a multiple of its window (2048), above
# it (1500) and below it (600); rwkv6 keeps a state, not a KV cache;
# whisper has no int8 cache (ROADMAP Queue C item 7) and its check runs
# at full depth; internvl at full depth, 256 patches before each prompt
SERVE_RUNS = {
    "serve_phi3": {"arch": "phi3-medium-14b"},
    "serve_rwkv6": {"arch": "rwkv6-3b", "int8_tokens": 0},
    "serve_gemma3": {"arch": "gemma3-12b",
                     "prompts": (PROMPT_LEN, 1500, 600)},
    "serve_qwen3": {"arch": "qwen3-moe-235b-a22b", "overrides": SERVE_QWEN3},
    "serve_jamba": {"arch": "jamba-1.5-large-398b",
                    "overrides": SERVE_JAMBA},
    "serve_whisper": {"arch": "whisper-base", "batch_size": WHISPER_BATCH,
                      "prompt_len": WHISPER_PROMPT,
                      "new_tokens": WHISPER_NEW_TOKENS, "int8_tokens": 0,
                      "prompts": (WHISPER_PROMPT,),
                      "consistency_layers": None},
    "serve_internvl": {"arch": "internvl2-26b"},
}
CONSISTENCY_TOL = 5e-3            # tests/test_models_smoke.py, float32
# kernel against plain version, |got - want| <= atol + rtol |want|. Both
# sides compute in float32 and differ only in the order of their sums, so
# a bf16 output may differ by the rounding of that result: one bf16 ulp is
# 2^-8 to 2^-7 of |want| (rtol 1.6e-2 leaves two to four), and atol covers
# outputs that cancel to near zero. float32: tests/test_kernels.py.
BF16_TOL = {"atol": 4e-3, "rtol": 1.6e-2}
FLASH_TOL = {"float32": {"atol": 2e-5, "rtol": 2e-4}, "bfloat16": BF16_TOL}
RWKV_TOL = {"y": BF16_TOL, "state": {"atol": 1e-4, "rtol": 1e-4}}
RWKV_F32_TOL = {"y": FLASH_TOL["float32"], "state": RWKV_TOL["state"]}
# the old bf16 limit (rtol = atol = 3e-2), reported beside the planted
# faults to show what it let through
LOOSE_BF16_TOL = {"atol": 3e-2, "rtol": 3e-2}

# the H100 SXM's memory rate, float32 (non-tensor-core) rate and bf16
# tensor-core rate, from NVIDIA's data sheet: the card the bounds are
# stated for (repro_torch.launch.roofline, which the dry run reads too);
# the one timer and bound of the port's kernel measurements, and the
# quantizer kernels' operations per element (repro_torch.benchmarks.
# timing, which kernel_bench shares)
sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
from repro_torch.launch.roofline import (  # noqa: E402
    HBM_BW as H100_BYTES_PER_S, PEAK_FLOPS_BF16 as BF16_OPS_PER_S,
    PEAK_FLOPS_F32 as F32_OPS_PER_S)
from repro_torch.benchmarks.timing import (  # noqa: E402
    OPS_DEQ, OPS_HASH, OPS_REDUCE, OPS_ROUND, bound, time_ms)
# bit-for-bit equality of two trees of tensors, and a free localhost port
# for a one-rank process group (the A/B driver's own)
from repro_torch.benchmarks.perf_iterations import (  # noqa: E402
    _free_port, bits_equal)

REPLACES = {
    "quantize": "src/repro/kernels/quantize_block.py:205",
    "quantize_block": "src/repro/kernels/quantize_block.py:332",
    "quantize_seeded": "src/repro/kernels/quantize_block.py:195",
    "encode": "src/repro/kernels/quantize_block.py:257",
    "encode_seeded": "src/repro/kernels/quantize_block.py:247",
    # groups below 128: the reference encodes them in jnp, not in :247
    "encode_seeded_small": "src/repro/core/compression.py:698",
    "encode_seeded_small_g16": "src/repro/core/compression.py:698",
    "decode_reduce": "src/repro/kernels/quantize_block.py:318",
    "decode_reduce_wq": "src/repro/kernels/quantize_block.py:318",
    "flash_attention": "src/repro/kernels/flash_attention.py:93",
    "rwkv_scan": "src/repro/kernels/rwkv_scan.py:68",
}
# the kernels line's rows over the quantizer's LAUNCHES counts, where a row
# takes more than its own: the flat stream (quantize_block, the reference's
# :332) reaches the streamed pallas_call at :205, so its launches are that
# row's launches too
ROW_COUNTS = {"quantize": ("quantize", "quantize_block")}
SOURCE = "src/repro_torch/kernels/csrc/quantize_block.cu"
LM_SOURCES = {"flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
              "rwkv_scan": "src/repro_torch/kernels/csrc/rwkv_scan.cu",
              "flash_attention_bwd":
                  "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
              "rwkv_scan_bwd": "src/repro_torch/kernels/csrc/rwkv_scan_bwd.cu"}

# the figures phase: the paper's --full sizes (configs/dictlearn.py, the
# reference's benchmarks/run.py) over FIG_ROUNDS of its 300 rounds (the
# run's time limit; a trajectory's first rounds do not depend on its
# length), the Fig. 2 alphas, and the GPU-vs-CPU check: 10 FedMM rounds,
# identity compressor, losses within DEVICE_RTOL, the port's parity
# tolerance where ISTA's iterations compound (RTOL_ISTA in
# tests/test_torch_figures.py)
FIG_ROUNDS = 150
FIG2_ALPHAS = (0.0, 0.01)
FIG2_LOSS_RTOL = 0.01
DEVICE_CHECK_ROUNDS, DEVICE_RTOL = 10, 1e-4
# Fig. 3 at the reference's benchmarks/run.py --full: dims and rounds; the
# gates and the GPU-vs-CPU check (10 FedMM-OT rounds, L2-UVP within
# DEVICE_RTOL) at FIG3_GATE_DIM. The wider dims, reported and not gated
# (FedMM-OT is not finite there from round 2 or 3), run FIG3_WIDE_ROUNDS
# of the 100: the run's time limit
FIG3_DIMS, FIG3_ROUNDS, FIG3_GATE_DIM = (16, 32, 64), 100, 16
FIG3_WIDE_ROUNDS = 20


# the script has 1200 s: a run still going after WATCHDOG_S prints every
# thread's stack to standard error and exits non-zero
WATCHDOG_S = 1170
T_START = time.perf_counter()
# the argument that makes this script the child of start_figures
FIGURES_CHILD = "--figures-child"
PROGRESS_TAG = ["chip_smoke"]


def progress(what: str) -> None:
    """One line on standard error with the seconds since the script began:
    where a run that was stopped stood, and how long each phase took."""
    print(f"{PROGRESS_TAG[0]} {time.perf_counter() - T_START:8.1f} s  "
          f"{what}", file=sys.stderr, flush=True)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)
    if isinstance(obj, dict) and "phase" in obj:
        took = obj.get("seconds")
        progress(f"{obj['phase']} done" + (
            f" ({took:.1f} s)" if isinstance(took, float) else ""))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def ptxas_report(report: str, entry: str, smem_bytes: int) -> dict:
    """ptxas' report of the entry functions whose mangled name holds
    ``entry`` (the largest over them): registers, spill and stack bytes,
    static shared memory, whether ptxas serialized their wgmmas (C7512),
    and ``smem_bytes``, the dynamic shared memory a launch asks for."""
    regs = spill_st = spill_ld = stack = smem = 0
    for block in report.split("Compiling entry function '")[1:]:
        if entry not in block.split("'", 1)[0]:
            continue
        num = lambda pat: max(map(int, re.findall(pat, block)), default=0)
        regs = max(regs, num(r"Used (\d+) registers"))
        spill_st = max(spill_st, num(r"(\d+) bytes spill stores"))
        spill_ld = max(spill_ld, num(r"(\d+) bytes spill loads"))
        stack = max(stack, num(r"(\d+) bytes stack frame"))
        smem = max(smem, num(r"(\d+) bytes smem"))
    serialized = any("C7512" in line and entry in line
                     for line in report.splitlines())
    return {"registers": regs, "spill_store_bytes": spill_st,
            "spill_load_bytes": spill_ld, "stack_bytes": stack,
            "static_smem_bytes": smem, "dynamic_smem_bytes": smem_bytes,
            "wgmma_serialized": serialized}


def max_abs_err(a, b) -> float:
    import torch
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())


def worst_ratio(got, want, tol: dict) -> float:
    """max |got - want| / (atol + rtol |want|), in float64: the check
    passes where this is at most 1."""
    import torch
    g, w = got.to(torch.float64), want.to(torch.float64)
    return float(((g - w).abs() / (tol["atol"] + tol["rtol"] * w.abs()))
                 .max())


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version, at the main path's shapes
# ---------------------------------------------------------------------------

SMALL_GROUP_SHAPE, SMALL_GROUP = (262144, 3840), 8
# qwen3-moe's expert leaves w_gate and w_in, (128, 4096, 1536), as the
# encode takes them: rows of 1536, shard-safe group 16
EXPERT_LEAF_SHAPE, EXPERT_GROUP = (128 * 4096, 1536), 16
# past 2^31 elements: the last row starts at element 2^31
BIG_SHAPE = (2 ** 31 // 4096 + 1, 4096)
# gemma3-12b's wq (d 3,840 x 16 heads of 256, bf16), the one leaf of the
# train_mesh path whose shard-safe group (4,096 / 32 = 128) the fused
# decode + reduce takes, over its 2 clients
WQ_SHAPE, WQ_GROUP, WQ_CLIENTS = (3840, 4096), 128, 2
# the bf16 rounding of a dequantized element: an add, a shift, an and and
# a mask, per element and client
OPS_BF16 = 4


def encode_past_2_31(qb, gen, seed) -> dict:
    """One seeded group-8 encode of BIG_SHAPE (2^31 + 4,096 elements,
    about 12 GB with its codes and scales), whose tiles form 64-bit bases
    and 32-bit indices inside: the rows around element 2^31 and the last
    row, bit for bit against the plain encode of those rows with the
    dither of their global indices."""
    import torch
    R, D = BIG_SHAPE
    x = torch.randn(BIG_SHAPE, generator=gen, device="cuda")
    x[R - 1, :SMALL_GROUP] = 0.0                 # one all-zero group
    codes, scales = qb.quantize_encode_grouped(x, bits=BITS,
                                               group=SMALL_GROUP, seed=seed)
    torch.cuda.synchronize()
    rows = [2 ** 31 // D - 2, 2 ** 31 // D - 1, R - 1]
    idx = (torch.tensor(rows, device="cuda")[:, None] * D
           + torch.arange(D, device="cuda"))
    u = qb.ref.hash_uniform(idx, seed & 0xFFFFFFFF)
    want = qb.quantize_encode_grouped_plain(x[rows], u, bits=BITS,
                                            group=SMALL_GROUP)
    got = (codes[rows], scales[rows])
    require(all(bits_equal(a, b) for a, b in zip(got, want)),
            f"encode_seeded_small past 2^31 elements: rows {rows} differ "
            f"from the plain encode")
    del x, codes, scales, got, want
    torch.cuda.empty_cache()
    return {"shape": list(BIG_SHAPE), "group": SMALL_GROUP, "rows": rows,
            "bit_exact": True}


def kernel_checks(qb):
    """Each kernel on the w leaf's (358400, 256) rows (the reduce over a
    16-client stack of them; the flat-stream route on the same elements as
    one stream; the small-group encode on the train path's largest leaf)
    against its plain version: bits, times and the bound. Returns one
    record per kernel."""
    import torch
    from repro_torch.kernels import ops as kernel_ops
    device, g = "cuda", BLOCK
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    x = torch.randn((D_MODEL * D_FF // g, g), generator=gen,
                    device=device) * 3.0
    x[7] = 0.0                                   # one all-zero group
    u = qb.kernel_dither_plain(x.shape, 12345, device)
    n = x.numel()
    seed = 0x9E3779B9                            # a seed >= 2^31
    results = {}

    def record(name, kern, plain, err, nbytes, ops, iters):
        entry = {"name": name, "route": "cuda", "source": SOURCE,
                 "replaces": REPLACES[name], "max_abs_err": err,
                 "library_ms": None}
        entry["bound_ms"], entry["bound_by"] = bound(nbytes, ops,
                                                     F32_OPS_PER_S)
        entry["ms"] = time_ms(kern, iters)
        entry["plain_ms"] = time_ms(plain, max(2, iters // 10), 1)
        results[name] = entry

    cases = {
        "quantize": (lambda: qb.quantize_grouped(x, u, bits=BITS, group=g),
                     lambda: qb.quantize_grouped_plain(x, u, bits=BITS,
                                                       group=g),
                     12 * n, (OPS_ROUND + OPS_DEQ) * n),
        "quantize_seeded": (
            lambda: qb.quantize_grouped(x, bits=BITS, group=g, seed=seed),
            lambda: qb.quantize_grouped_plain(x, bits=BITS, group=g,
                                              seed=seed),
            8 * n, (OPS_ROUND + OPS_DEQ + OPS_HASH) * n),
        "encode": (
            lambda: qb.quantize_encode_grouped(x, u, bits=BITS, group=g),
            lambda: qb.quantize_encode_grouped_plain(x, u, bits=BITS,
                                                     group=g),
            9 * n + 4 * n // g, OPS_ROUND * n),
        "encode_seeded": (
            lambda: qb.quantize_encode_grouped(x, bits=BITS, group=g,
                                               seed=seed),
            lambda: qb.quantize_encode_grouped_plain(x, bits=BITS, group=g,
                                                     seed=seed),
            5 * n + 4 * n // g, (OPS_ROUND + OPS_HASH) * n),
        # the flat stream (D == g): the w leaf as Compressor.apply sends it
        "quantize_block": (
            lambda: kernel_ops.quantize_dequantize_with_dither(
                x.reshape(-1), u.reshape(-1), bits=BITS, block=g),
            lambda: qb.ref.quantize_block_ref(x.reshape(-1), u.reshape(-1),
                                              bits=BITS, block=g),
            12 * n, (OPS_ROUND + OPS_DEQ) * n),
    }
    for name, (kern, plain, nbytes, ops) in cases.items():
        got, want = kern(), plain()
        if isinstance(got, tuple):
            same = all(bits_equal(a, b) for a, b in zip(got, want))
            err = max(max_abs_err(a, b) for a, b in zip(got, want))
        else:
            same, err = bits_equal(got, want), max_abs_err(got, want)
        require(same, f"{name}: kernel differs from its plain version")
        record(name, kern, plain, err, nbytes, ops, iters=20)
        del got, want

    # the encode with a group below 128 at the train path's largest leaf:
    # gemma3-12b's embedding (262144, 3840), shard-safe group 8
    xe = torch.randn(SMALL_GROUP_SHAPE, generator=gen, device=device)
    xe[3, :SMALL_GROUP] = 0.0                    # one all-zero group
    ge, ne = SMALL_GROUP, xe.numel()
    kern = lambda: qb.quantize_encode_grouped(xe, bits=BITS, group=ge,
                                              seed=seed)
    plain = lambda: qb.quantize_encode_grouped_plain(xe, bits=BITS, group=ge,
                                                     seed=seed)
    got, want = kern(), plain()
    require(all(bits_equal(a, b) for a, b in zip(got, want)),
            "encode_seeded_small: kernel differs from its plain version")
    err = max(max_abs_err(a, b) for a, b in zip(got, want))
    del got, want
    record("encode_seeded_small", kern, plain, err, 5 * ne + 4 * ne // ge,
           (OPS_ROUND + OPS_HASH) * ne, iters=10)
    results["encode_seeded_small"].update(
        shape=list(SMALL_GROUP_SHAPE), group=ge,
        pct_of_bound=100 * results["encode_seeded_small"]["bound_ms"]
        / results["encode_seeded_small"]["ms"])
    del xe
    torch.cuda.empty_cache()

    # the same kernel at qwen3-moe's expert leaves, group 16: its own row,
    # whose launches are the train path's group-16 encodes
    xq = torch.randn(EXPERT_LEAF_SHAPE, generator=gen, device=device)
    xq[5, :EXPERT_GROUP] = 0.0                   # one all-zero group
    gq, nq = EXPERT_GROUP, xq.numel()
    kern = lambda: qb.quantize_encode_grouped(xq, bits=BITS, group=gq,
                                              seed=seed)
    plain = lambda: qb.quantize_encode_grouped_plain(xq, bits=BITS,
                                                     group=gq, seed=seed)
    got, want = kern(), plain()
    require(all(bits_equal(a, b) for a, b in zip(got, want)),
            "encode_seeded_small at group 16: kernel differs from its plain "
            "version")
    err = max(max_abs_err(a, b) for a, b in zip(got, want))
    del got, want
    name = f"encode_seeded_small_g{gq}"
    record(name, kern, plain, err, 5 * nq + 4 * nq // gq,
           (OPS_ROUND + OPS_HASH) * nq, iters=10)
    results[name].update(shape=list(EXPERT_LEAF_SHAPE), group=gq,
                         pct_of_bound=100 * results[name]["bound_ms"]
                         / results[name]["ms"])
    del xq
    torch.cuda.empty_cache()
    results["encode_seeded_small"]["past_2_31"] = encode_past_2_31(qb, gen,
                                                                   seed)

    # the reduce over a C-client stack of payloads encoded by the kernel
    rows = x.shape[0]
    codes = torch.empty((N_CLIENTS, rows, g), dtype=torch.int8, device=device)
    scales = torch.empty((N_CLIENTS, rows, 1), device=device)
    for c in range(N_CLIENTS):
        codes[c], scales[c] = qb.quantize_encode_grouped(
            x * (1.0 + 0.1 * c), bits=BITS, group=g, seed=seed + c)
    scales[3, 11] = 0.0                          # a dropped group
    w = torch.rand((N_CLIENTS,), generator=gen, device=device)
    w[5] = 0.0                                   # a masked-out client
    kern = lambda: qb.decode_reduce_grouped(codes, scales, w, bits=BITS,
                                            group=g)
    plain = lambda: qb.decode_reduce_grouped_plain(codes, scales, w,
                                                   bits=BITS, group=g)
    got, want = kern(), plain()
    require(bits_equal(got, want),
            "decode_reduce: kernel differs from its plain version")
    stack = torch.stack([qb.ref.decode_groups_ref(codes[c], scales[c], BITS)
                         for c in range(N_CLIENTS)])
    dot = torch.tensordot(w, stack, dims=1)
    require(bool(torch.allclose(got, dot, rtol=1e-5, atol=1e-5)),
            "decode_reduce: disagrees with a tensordot over the stack")
    del stack, dot
    record("decode_reduce", kern, plain, max_abs_err(got, want),
           N_CLIENTS * (n + 4 * n // g) + 4 * N_CLIENTS + 4 * n,
           OPS_REDUCE * N_CLIENTS * n, iters=10)
    del codes, scales, got, want
    same = decode_reduce_wq(qb, gen, seed, record)
    wq = results["decode_reduce_wq"]
    wq.update(shape=list(WQ_SHAPE), group=WQ_GROUP, clients=WQ_CLIENTS,
              round_to="bfloat16", bits_equal_stack_tensordot=same,
              pct_of_bound=100 * wq["bound_ms"] / wq["ms"])
    return results


def decode_reduce_wq(qb, gen, seed, record) -> dict:
    """The fused decode + reduce at the train_mesh path's leaf: gemma3's
    ``wq`` (WQ_SHAPE, group WQ_GROUP) over WQ_CLIENTS clients of weight
    1/2, each dequantized element rounded to bf16 (the leaf's dtype, as
    ``decode`` rounds it): bit for bit its plain version, and equal to the
    decoded bf16 stack reduced by a tensordot; ``record`` keeps its
    times. Returns whether it equals the tensordot bit for bit (two
    weights of 1/2: one rounding of an exact sum on both sides)."""
    import torch
    device, g, C = "cuda", WQ_GROUP, WQ_CLIENTS
    R, D = WQ_SHAPE
    n = R * D
    x = torch.randn(WQ_SHAPE, generator=gen, device=device) * 0.02
    codes = torch.empty((C, R, D), dtype=torch.int8, device=device)
    scales = torch.empty((C, R, D // g), device=device)
    for c in range(C):
        codes[c], scales[c] = qb.quantize_encode_grouped(
            x * (1.0 + 0.1 * c), bits=BITS, group=g, seed=seed + c)
    w = torch.full((C,), 1.0 / C, device=device)
    kern = lambda: qb.decode_reduce_grouped(codes, scales, w, bits=BITS,
                                            group=g, round_to=torch.bfloat16)
    plain = lambda: qb.decode_reduce_grouped_plain(
        codes, scales, w, bits=BITS, group=g, round_to=torch.bfloat16)
    got, want = kern(), plain()
    require(bits_equal(got, want),
            "decode_reduce at wq: kernel differs from its plain version")
    stack = torch.stack([qb.ref.decode_groups_ref(
        codes[c].reshape(R, D // g, g), scales[c].reshape(R, D // g, 1),
        BITS).reshape(R, D).to(torch.bfloat16) for c in range(C)])
    dot = torch.tensordot(w, stack.float(), dims=1)
    require(bool(torch.allclose(got, dot, rtol=1e-6, atol=1e-9)),
            "decode_reduce at wq: disagrees with the decoded bf16 stack's "
            "tensordot")
    same = bits_equal(got, dot)
    err = max_abs_err(got, want)
    del stack, dot, got, want
    record("decode_reduce_wq", kern, plain, err,
           C * (n + 4 * n // g) + 4 * C + 4 * n,
           (OPS_REDUCE + OPS_BF16) * C * n, iters=20)
    return same


# ---------------------------------------------------------------------------
# phase 3: the slice, through the port's entry points
# ---------------------------------------------------------------------------

def make_workload():
    """Random weights and data from SEED: client c's targets are
    x @ W* + b_c + noise (heterogeneous offsets b_c)."""
    import torch
    device = "cuda"
    gen = torch.Generator(device=device).manual_seed(SEED)
    xs = torch.randn((N_CLIENTS, BATCH, D_MODEL), generator=gen,
                     device=device)
    w_star = torch.randn((D_MODEL, D_FF), generator=gen,
                         device=device) / D_MODEL ** 0.5
    b_c = torch.randn((N_CLIENTS, 1, D_FF), generator=gen, device=device)
    ys = xs @ w_star + b_c
    ys += 0.1 * torch.randn(ys.shape, generator=gen, device=device)
    del w_star
    return xs, ys


def loss_fn(batch, theta):
    import torch
    xb, yb = batch
    r = xb @ theta["w"] + theta["b"] - yb
    return 0.5 * torch.mean(torch.sum(r * r, dim=-1))


def drive_slice(keep: dict):
    """The main path: ROUNDS vmap rounds with the hash dither (made in the
    kernel on the card), the same rounds with the in-kernel dither, with
    the hash streamed through the plain route (the bits before the kernel
    route made the hash itself) and with the uniform dither (streamed into
    the kernels), one round's drift and payload through the Compressor's
    entry points, and one scan round. Returns the phase's JSON record;
    fills ``keep`` with the workload, the problem, the hash-dither spec
    and that run's metrics (``sanitize_phase``'s reference)."""
    import torch
    from repro_torch import api
    from repro_torch.core import compression as C
    from repro_torch.core.quadratic import quadratic_for_objective
    from repro_torch.core.surrogate import tree_sub
    from repro_torch.kernels import quantize_block as qb
    from repro_torch.tree import tree_leaves, tree_map

    device = "cuda"
    sync = torch.cuda.synchronize
    xs, ys = make_workload()
    problem = api.as_problem(quadratic_for_objective(loss_fn, rho=RHO))
    x0 = {"w": torch.zeros((D_MODEL, D_FF), device=device),
          "b": torch.zeros((D_FF,), device=device)}
    eval_batch = (xs.reshape(-1, D_MODEL), ys.reshape(-1, D_FF))

    def spec_for(dither, plain=False):
        # plain: no leaf reaches the kernels (the oracle on every leaf)
        kw = {"kernel_threshold": 1 << 62} if plain else {}
        return api.FederationSpec(
            n_clients=N_CLIENTS, participation=PARTICIPATION, alpha=ALPHA,
            variates="zero", compressor=C.block_quant(BITS, BLOCK,
                                                      dither=dither, **kw))

    def run(dither, n_rounds=ROUNDS, plain=False):
        torch.cuda.reset_peak_memory_stats()
        sync()
        t0 = time.perf_counter()
        state, hist = api.run(problem, x0, (xs, ys), GAMMA,
                              spec=spec_for(dither, plain), key=SEED,
                              n_rounds=n_rounds, eval_batch=eval_batch,
                              device=device, client_mode="vmap")
        sync()
        secs = time.perf_counter() - t0
        return state, hist, secs, torch.cuda.max_memory_allocated()

    def same_run(a, b, what):
        (state_a, hist_a), (state_b, hist_b) = a, b
        for x, y in zip(tree_leaves(tuple(state_a)[:3]),
                        tree_leaves(tuple(state_b)[:3])):
            require(bits_equal(x, y), f"{what}: the states differ")
        for k in hist_a:
            require(torch.equal(hist_a[k], hist_b[k]),
                    f"{what}: metric {k} differs")

    out = {"phase": "slice"}
    # one untimed round of each dither first: cuBLAS and torch.func set-up
    # is paid here, not in the timed rounds
    for dither in ("hash", "kernel", "uniform"):
        _, _, secs, _ = run(dither, 1)
        out[f"seconds_first_round_{dither}"] = secs
    qb.reset_launches()

    # -- the hash-dither rounds ------------------------------------------
    state_h, hist_h, secs_h, peak_h = run("hash")
    keep.update(problem=problem, x0=x0, xs=xs, ys=ys, eval_batch=eval_batch,
                spec=spec_for("hash"), hist=hist_h)
    loss = hist_h["loss"].tolist()
    require(all(map(lambda v: v == v and abs(v) < float("inf"), loss)),
            "loss not finite")
    require(loss[-1] < loss[0], f"loss did not fall: {loss}")
    n_kernel_leaves = sum(1 for leaf in tree_leaves(x0)
                          if leaf.numel() >= C.KERNEL_DISPATCH_MIN)
    expect = ROUNDS * N_CLIENTS * n_kernel_leaves
    require(qb.LAUNCHES["encode_seeded"] == expect
            and qb.LAUNCHES["encode"] == 0,
            f"hash-dither encode launches {qb.LAUNCHES} != rounds x "
            f"clients x kernel-route leaves, all with the in-kernel dither")
    enc_after_run = qb.LAUNCHES["encode_seeded"]

    # -- the same rounds on the plain route, the hash streamed in plain
    # PyTorch: the bits before the kernel made the hash dither
    state_p, hist_p, secs_p, peak_p = run("hash", plain=True)
    same_run((state_h, hist_h), (state_p, hist_p),
             "the hash made in the kernel vs the hash streamed, plain")
    require(qb.LAUNCHES["encode_seeded"] == enc_after_run
            and qb.LAUNCHES["encode"] == 0, "the plain route launched")
    out.update(seconds_per_round_hash_plain=secs_p / ROUNDS,
               peak_bytes_hash_plain=peak_p, hash_equals_plain=True)
    del state_p, hist_p

    # -- the same rounds with the dither made in the kernel -------------
    enc_before = qb.LAUNCHES["encode_seeded"]
    state_k, hist_k, secs_k, peak_k = run("kernel")
    same_run((state_h, hist_h), (state_k, hist_k),
             "dither='kernel' vs dither='hash'")
    require(qb.LAUNCHES["encode_seeded"] - enc_before == expect,
            f"in-kernel-dither encode launches {qb.LAUNCHES}")
    out.update(seconds_per_round_kernel=secs_k / ROUNDS,
               peak_bytes_kernel=peak_k, kernel_equals_hash=True)
    del state_k, hist_k

    # -- the same rounds with the uniform dither, streamed into the
    # kernels (its own draws: another trajectory)
    state_u, hist_u, secs_u, peak_u = run("uniform")
    loss_u = hist_u["loss"].tolist()
    require(all(map(lambda v: v == v and abs(v) < float("inf"), loss_u))
            and loss_u[-1] < loss_u[0],
            f"uniform-dither loss not finite or not falling: {loss_u}")
    require(qb.LAUNCHES["encode"] == expect,
            f"streamed encode launches {qb.LAUNCHES}")
    out.update(seconds_per_round_uniform=secs_u / ROUNDS,
               peak_bytes_uniform=peak_u, loss_uniform=loss_u)
    del state_u, hist_u

    # comm_bytes against the buffers of one measured client payload
    comp_h = spec_for("hash").compressor
    probe = comp_h.encode(torch.Generator().manual_seed(1),
                          tree_map(torch.zeros_like, x0))
    per_client = C._tree_bytes(probe)
    require(per_client == comp_h.payload_bytes(x0),
            "payload_bytes != the encoded buffer bytes")
    # the driver bills in float32, as the reference does
    billed = torch.tensor(float(per_client)) * hist_h["n_active"]
    require(torch.equal(hist_h["comm_bytes"], billed),
            "comm_bytes != measured payload bytes x active clients")
    w_payload = probe["w"]
    out.update(
        rounds=ROUNDS, seconds_per_round_hash=secs_h / ROUNDS,
        peak_bytes_hash=peak_h, loss=loss,
        n_active=hist_h["n_active"].tolist(),
        comm_bytes=hist_h["comm_bytes"].tolist(),
        payload_bytes_per_client=per_client,
        w_payload_codes_bytes=w_payload.codes.numel(),
        w_payload_scales_bytes=4 * w_payload.scales.numel())
    del probe, w_payload

    # -- one round's drift and payload through the Compressor -----------
    state = state_h
    view = problem.T(state.x)
    gen = torch.Generator().manual_seed(SEED + 2)
    n_leaves = len(tree_leaves(x0))
    active, seeds = api.participation_draw(gen, spec_for("hash"), n_leaves)
    mu = api.FederationSpec(n_clients=N_CLIENTS).client_weights(device)
    w = mu * active.to(device, torch.float32)

    def drift(c):
        s_c = problem.s_bar((xs[c], ys[c]), view)
        return tree_sub(tree_sub(s_c, state.x),
                        tree_map(lambda v: v[c], state.v_i))

    d0 = drift(0)
    key = seeds[0].tolist()
    for dither in ("hash", "kernel", "plain", "uniform"):
        comp = (spec_for("hash", plain=True) if dither == "plain"
                else spec_for(dither)).compressor
        applied = comp.apply(key, d0)
        decoded = comp.decode(comp.encode(key, d0))
        for k in applied:
            require(bits_equal(applied[k], decoded[k]),
                    f"decode(encode(x)) != apply(x) for {k}, {dither}")
        if dither == "hash":
            applied_h = applied
        if dither != "uniform":
            for k in applied:
                require(bits_equal(applied[k], applied_h[k]),
                        f"apply(x) with the {dither} dither != the hash's")
    del d0, applied, decoded, applied_h
    parts = []
    for c in range(N_CLIENTS):
        parts.append(comp_h.encode(seeds[c].tolist(), drift(c)))
    stack = C.stack_payloads(parts)
    del parts
    reduced = comp_h.decode_reduce(stack, w)
    p = stack["w"]
    plain = qb.decode_reduce_grouped_plain(
        p.codes.reshape(N_CLIENTS, -1, BLOCK),
        p.scales.reshape(N_CLIENTS, -1, 1), w, bits=BITS, group=BLOCK)
    n_w = D_MODEL * D_FF
    require(bits_equal(reduced["w"], plain.reshape(-1)[:n_w].reshape(p.shape)),
            "decode_reduce(payload, mu * mask) != its plain version")
    gathered = torch.tensordot(w, comp_h.decode(stack)["w"], dims=1)
    require(bool(torch.allclose(reduced["w"], gathered, rtol=1e-5,
                                atol=1e-6)),
            "decode_reduce disagrees with the gather path's tensordot")
    out["payload_stack_bytes"] = C._tree_bytes(stack)
    del stack, reduced, plain, gathered, p

    # -- one scan round at the same width, against a vmap round ---------
    gamma = torch.tensor(GAMMA, dtype=torch.float32)
    spec = spec_for("hash")
    sync()
    t0 = time.perf_counter()
    st_scan, m_scan = api.step(problem, spec, state, (xs, ys), gamma,
                               torch.Generator().manual_seed(SEED + 3),
                               device=device, client_mode="scan")
    sync()
    secs_scan = time.perf_counter() - t0
    st_vmap, m_vmap = api.step(problem, spec, state, (xs, ys), gamma,
                               torch.Generator().manual_seed(SEED + 3),
                               device=device, client_mode="vmap")
    # the two modes take the oracles' products through different cuBLAS
    # kernels, so a few codes sitting on a rounding edge flip by one level;
    # the rounds agree to a small fraction of the round's own update
    for a, b, x_prev in zip(tree_leaves(st_scan.x), tree_leaves(st_vmap.x),
                            tree_leaves(state.x)):
        require(bool(torch.isfinite(a).all()), "scan round not finite")
        gap = float(torch.linalg.vector_norm(a - b))
        moved = float(torch.linalg.vector_norm(b - x_prev))
        require(gap <= 1e-3 * moved, f"scan round disagrees with the vmap "
                f"round: |scan - vmap| {gap} vs update {moved}")
    require(float(m_scan["comm_bytes"]) == float(m_vmap["comm_bytes"]),
            "scan and vmap rounds bill different bytes")
    launches = {name: sum(qb.LAUNCHES[k] for k in ROW_COUNTS.get(name,
                                                                 (name,)))
                for name in qb.LAUNCHES}
    out.update(seconds_scan_round=secs_scan,
               encode_launches_hash_run=enc_after_run,
               launches=launches, launch_counts=dict(qb.LAUNCHES))
    for name, count in launches.items():
        # groups below 128 are the train path's (the slice's are 256)
        require(count > 0 or name.endswith("_small"), f"kernel {name} was "
                f"not launched on the main path")
    return out


# ---------------------------------------------------------------------------
# the sanitize phase: the runtime checks on the slice's workload
# ---------------------------------------------------------------------------

SANITIZE_ROUNDS = 2
# the planted NaN's client, and the scheduler round's cohort size (two
# cohorts: the later one's data drawn again from the wave's state)
NAN_CLIENT, SANITIZE_COHORT = 3, N_CLIENTS // 2
# the argument that makes this script the child of start_contracts, and
# the config whose full-width parameter tree it checks
CONTRACTS_CHILD, CONTRACTS_ARCH = "--contracts-child", "gemma3-12b"


def lint_record() -> dict:
    """``python -m repro_torch.analysis src/repro_torch --strict``, called
    in this process (standard library only: it needs neither JAX nor the
    card): its exit code, files, active findings, allow-pragmas and
    seconds."""
    import contextlib
    import io
    import tempfile
    from repro_torch.analysis.__main__ import main as lint_main
    tree = str(Path(__file__).resolve().parent / "src" / "repro_torch")
    out = io.StringIO()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, \
            contextlib.redirect_stdout(out), contextlib.redirect_stderr(out):
        rc = lint_main([tree, "--strict", "--json", f"{tmp}/lint.json"])
        report = json.loads(Path(tmp, "lint.json").read_text())
    return {"phase": "lint", "rc": rc, "files": len(report["files"]),
            "findings": report["n_findings"], "pragmas": report["n_pragmas"],
            "output": out.getvalue().splitlines()[-20:],
            "seconds": time.perf_counter() - t0}


def contracts_child() -> dict:
    """``check_compressor`` of the slice's quantizer with the dither made
    in the kernel over CONTRACTS_ARCH's full-width, full-depth parameter
    tree on ``meta`` tensors (no card; nothing allocated, no launch); and
    before it the linter's record (``lint_record``)."""
    from repro_torch import configs
    from repro_torch.analysis import check_compressor
    from repro_torch.core import compression as C
    from repro_torch.kernels import quantize_block as qb
    from repro_torch.launch.dryrun import meta_params
    from repro_torch.tree import tree_leaves
    lint = lint_record()
    t0 = time.perf_counter()
    tree = meta_params(configs.get(CONTRACTS_ARCH))
    report = check_compressor(C.block_quant(BITS, BLOCK, dither="kernel"),
                              tree)
    return {"arch": CONTRACTS_ARCH, "report": report.to_json(),
            "leaves": len(tree_leaves(tree)),
            "parameters": sum(x.numel() for x in tree_leaves(tree)),
            "launches": sum(qb.LAUNCHES.values()),
            "seconds": time.perf_counter() - t0, "lint": lint}


def start_contracts():
    """``contracts_child`` in a child process of this script started
    beside the kernels' build, its output written under ``build/``:
    (child, output paths)."""
    root = Path(__file__).resolve().parent
    logs = (root / "build" / "contracts.out", root / "build" / "contracts.err")
    logs[0].parent.mkdir(exist_ok=True)
    with open(logs[0], "w") as so, open(logs[1], "w") as se:
        child = subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                  CONTRACTS_CHILD], stdout=so, stderr=se)
    atexit.register(lambda: child.poll() is None and child.kill())
    return child, logs


def join_contracts(started) -> dict:
    """The child of ``start_contracts``: its record, whose report must be
    ``ok`` with every contract of a wire-format compressor checked and no
    kernel launched, and whose lint record must show the linter's
    ``--strict`` run exiting 0; and how long the join waited."""
    child, logs = started
    t0 = time.perf_counter()
    try:
        child.wait(timeout=CHILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        child.kill()
        child.wait()
        raise AssertionError(f"the contracts check took over "
                             f"{CHILD_TIMEOUT_S} s")
    stdout, stderr = (p.read_text() for p in logs)
    require(child.returncode == 0, f"the contracts child failed (exit "
            f"{child.returncode}): {stderr[-2000:]}")
    for p in logs:
        p.unlink()
    record = json.loads(stdout.strip().splitlines()[-1])
    report = record["report"]
    require(report["ok"] and set(report["checked"]) >= {
        "apply-roundtrip", "encode-decode-roundtrip", "packed-layout",
        "payload-bytes", "decode-reduce", "reencode"},
        f"check_compressor over {CONTRACTS_ARCH}'s tree: {report}")
    require(record["launches"] == 0, "check_compressor launched a kernel")
    lint = record["lint"]
    require(lint["rc"] == 0 and lint["files"] > 0,
            f"the port's linter --strict: {lint}")
    return dict(record, wait_seconds=time.perf_counter() - t0)


def sanitize_phase(ctx: dict, contracts) -> dict:
    """The runtime checks on the slice's workload (``ctx``, filled by
    ``drive_slice``): SANITIZE_ROUNDS rounds plain and with ``sanitize=True,
    audit_keys=True`` (timed; bit for bit each other and the first rounds
    of the slice's hash-dither run from the same seed, the sanitized ones
    encoding on the kernel route under the comm-bytes audit), a NaN
    planted in client NAN_CLIENT's data (its oracle output NaN) that the
    sanitizer flags at the ``oracle`` stage of round 0 and that the plain
    round launders, finite; one CohortScheduler round of SANITIZE_COHORT
    clients a cohort, plain and audited and sanitized, bit for bit; and
    the contracts child's record. Returns the phase's JSON record."""
    import torch
    from repro_torch import api
    from repro_torch.analysis import KeyAudit
    from repro_torch.analysis.runtime import SanitizerError
    from repro_torch.core import compression as C
    from repro_torch.kernels import quantize_block as qb
    from repro_torch.sched import CohortScheduler
    from repro_torch.tree import tree_leaves

    sync = torch.cuda.synchronize
    problem, x0, xs, ys, spec = (ctx[k] for k in ("problem", "x0", "xs",
                                                  "ys", "spec"))
    out = {"phase": "sanitize", "rounds": SANITIZE_ROUNDS}
    qb.reset_launches()

    def same(a, b, what):
        for x, y in zip(tree_leaves(a), tree_leaves(b)):
            require(bits_equal(x, y), f"{what}: the states differ")

    def rounds(**kw):
        sync()
        t0 = time.perf_counter()
        state, hist = api.run(problem, x0, (xs, ys), GAMMA, spec=spec,
                              key=SEED, n_rounds=SANITIZE_ROUNDS,
                              eval_batch=ctx["eval_batch"], device="cuda",
                              client_mode="vmap", **kw)
        sync()
        return state, hist, time.perf_counter() - t0

    st_p, h_p, secs_p = rounds()
    enc = qb.LAUNCHES["encode_seeded"]
    audit = KeyAudit()
    st_s, h_s, secs_s = rounds(sanitize=True, audit_keys=audit)
    kernel_leaves = sum(1 for leaf in tree_leaves(x0)
                        if leaf.numel() >= C.KERNEL_DISPATCH_MIN)
    require(qb.LAUNCHES["encode_seeded"] - enc
            == SANITIZE_ROUNDS * N_CLIENTS * kernel_leaves,
            "the sanitized rounds did not encode on the kernel route")
    require(len(audit.report) > 0 and not audit.reuse_events,
            f"the key audit: {len(audit.report)} draws, reuse "
            f"{audit.reuse_events}")
    # each check alone, for where the checks' time goes
    st_c, h_c, secs_c = rounds(sanitize=True)
    st_a, h_a, secs_a = rounds(audit_keys=True)
    for what, st, h in (("sanitize and audit_keys", st_s, h_s),
                        ("sanitize", st_c, h_c), ("audit_keys", st_a, h_a)):
        same(tuple(st_p)[:3], tuple(st)[:3], f"{what} on")
        for k in ctx["hist"]:
            require(torch.equal(h[k], h_p[k])
                    and torch.equal(h[k], ctx["hist"][k][:SANITIZE_ROUNDS]),
                    f"metric {k} differs with {what} on")
    out.update(seconds_plain=secs_p, seconds_sanitized=secs_s,
               seconds_sanitize_only=secs_c, seconds_audit_only=secs_a,
               seconds_per_round_plain=secs_p / SANITIZE_ROUNDS,
               seconds_per_round_sanitized=secs_s / SANITIZE_ROUNDS,
               draws_audited=len(audit.report))
    del st_p, st_s, st_c, st_a

    # -- a NaN planted in one client's oracle output ---------------------
    xs_bad = xs.clone()
    xs_bad[NAN_CLIENT, 0, 0] = float("nan")
    state0 = api.init(problem, x0, spec, device="cuda")
    caught = None
    sync()
    t0 = time.perf_counter()
    try:
        api.step(problem, spec, state0, (xs_bad, ys), GAMMA,
                 torch.Generator().manual_seed(SEED), device="cuda",
                 sanitize=True)
    except SanitizerError as e:
        caught = str(e)
    out["seconds_nan_round_sanitized"] = time.perf_counter() - t0
    require(caught is not None and "round 0, stage 'oracle'" in caught,
            f"the planted NaN was not flagged at the oracle: {caught}")
    st_nan, _ = api.step(problem, spec, state0, (xs_bad, ys), GAMMA,
                         torch.Generator().manual_seed(SEED), device="cuda")
    require(all(bool(torch.isfinite(x).all()) for x in tree_leaves(st_nan.x)),
            "the plain round did not launder the planted NaN")
    out.update(nan_flagged=caught, nan_laundered_finite=True)
    del xs_bad, state0, st_nan

    # -- one scheduler round, audited and sanitized ----------------------
    sched_spec = api.FederationSpec(
        n_clients=N_CLIENTS, participation=PARTICIPATION, variates="off",
        compressor=spec.compressor)

    def data_fn(t, gen, ids):
        idx = torch.as_tensor(ids, device=xs.device)
        return xs[idx], ys[idx]

    def sched_round(**kw):
        sched = CohortScheduler(problem, sched_spec,
                                cohort_size=SANITIZE_COHORT, device="cuda")
        sync()
        t0 = time.perf_counter()
        state, _, hist = sched.run(x0, data_fn, GAMMA, key=SEED, n_rounds=1,
                                   **kw)
        sync()
        return state, hist, time.perf_counter() - t0

    sa, ha, secs_a = sched_round()
    sb, hb_, secs_b = sched_round(sanitize=True, audit_keys=True)
    same(sa.x, sb.x, "the scheduler round, audited and sanitized")
    for k in ha:
        require(torch.equal(ha[k], hb_[k]), f"scheduler metric {k} differs "
                f"audited and sanitized")
    out.update(seconds_sched_round_plain=secs_a,
               seconds_sched_round_sanitized=secs_b,
               launches={"sanitize": dict(qb.LAUNCHES)},
               contracts=join_contracts(contracts))
    return out


# ---------------------------------------------------------------------------
# the mesh phase: the multi-GPU uplinks and the two-tier topology over NCCL
# ---------------------------------------------------------------------------

def _compare(a, b, rtol: float, atol: float):
    """``(allclose, largest |a - b|)`` over the leaves of two trees, on the
    card; a client-stacked leaf one client at a time (whole, its
    temporaries would be several GB)."""
    import torch
    from repro_torch.tree import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    if len(la) != len(lb) or any(x.shape != y.shape for x, y in zip(la, lb)):
        return False, float("inf")
    ok, gap = True, 0.0
    for x, y in zip(la, lb):
        for p, q in (zip(x, y) if x.ndim == 3 else ((x, y),)):
            p, q = p.to("cuda"), q.to("cuda")
            ok = ok and bool(torch.allclose(p, q, rtol=rtol, atol=atol))
            gap = max(gap, max_abs_err(p, q))
    return ok, gap


def mesh_phase():
    """Phase 1's workload on the mesh paths at world size 1 over NCCL: a
    CUDA ``DeviceMesh`` with a "clients" dim and a 1 x 1 ``(edge,
    client)`` one, the process group started in this process. Gates (each
    raises): gather on the mesh bit-identical to the single-device run with
    the gathered stack's bytes; reduce allclose to gather with the float32
    partial's bytes and one fused decode + reduce launch per round for w;
    two-tier off the mesh (4 edges of 4 clients) with exact backbone bytes
    and the 4 tier-boundary encodes per round; two-tier on the 1 x 1 mesh
    matching off the mesh; the per-shard wrappers on a Shard(0) DTensor
    bit-identical to the unsharded kernel and to the plain version.

    Every gate reads free runs of ``api.run`` (MESH_ROUNDS rounds from
    SEED), but two, which are stepped from one state with the same draws,
    round by round (``lockstep``), and whose free runs' gaps are recorded
    beside the lockstep's: two-tier raw against flat, whose free runs
    draw different masks from round 2 (the two-tier run draws its edge
    seeds from the round's generator), and the one-edge reduce against
    off the mesh, which sum in another order, so that a drift element
    that moves by one ulp can cross a rounding edge and move its code a
    whole level in the next round. The kernels' launches are
    counted per path (``launches``: the mesh runs, the two-tier runs off
    the mesh) over the free runs of that path only, the counts zeroed
    just before each run; the single-device runs that the gates compare
    with are left out. Returns the phase's record."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor
    from repro_torch import api
    from repro_torch.core import compression as C
    from repro_torch.core.quadratic import quadratic_for_objective
    from repro_torch.kernels import ops as kernel_ops
    from repro_torch.kernels import quantize_block as qb
    from repro_torch.launch.mesh import make_edge_mesh
    from repro_torch.tree import tree_leaves, tree_map

    device, sync = "cuda", torch.cuda.synchronize
    torch.cuda.set_device(0)
    out = {"phase": "mesh", "rounds": MESH_ROUNDS, "world_size": 1,
           "backend": "nccl"}
    t0 = time.perf_counter()
    dist.init_process_group("nccl",
                            init_method=f"tcp://localhost:{_free_port()}",
                            rank=0, world_size=1)
    try:
        probe = torch.ones(1, device=device)
        dist.all_reduce(probe)
        sync()
        out["nccl_init_seconds"] = time.perf_counter() - t0
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("clients",))
        emesh = make_edge_mesh(1, 1)
        require(dist.get_backend(mesh.get_group("clients")) == "nccl",
                "the client dim's group is not NCCL")

        xs, ys = make_workload()
        problem = api.as_problem(quadratic_for_objective(loss_fn, rho=RHO))
        x0 = {"w": torch.zeros((D_MODEL, D_FF), device=device),
              "b": torch.zeros((D_FF,), device=device)}
        n_leaves = len(tree_leaves(x0))
        gates, seconds, peaks, launches, gaps = {}, {}, {}, {}, {}
        paths = {"mesh": {}, "two_tier": {}}

        def spec_for(variates="zero", checksum=False, edges=None,
                     reencode=False):
            topo = ({} if edges is None else
                    {"topology": api.Topology.two_tier(edges,
                                                       reencode=reencode)})
            return api.FederationSpec(
                n_clients=N_CLIENTS, participation=PARTICIPATION,
                alpha=0.0 if variates == "off" else ALPHA,
                variates=variates,
                compressor=C.block_quant(BITS, BLOCK, dither="kernel",
                                         checksum=checksum), **topo)

        def free_run(name, path, spec, **kw):
            """MESH_ROUNDS rounds through api.run: seconds per round, peak
            memory, kernel launches per round; ``path`` ("mesh",
            "two_tier" or "single_device") takes the run's launches."""
            _free()
            qb.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            sync()
            t = time.perf_counter()
            state, hist = api.run(problem, x0, (xs, ys), GAMMA, spec=spec,
                                  key=SEED, n_rounds=MESH_ROUNDS,
                                  device=device, **kw)
            sync()
            seconds[name] = (time.perf_counter() - t) / MESH_ROUNDS
            peaks[name] = torch.cuda.max_memory_allocated()
            counts = {k: v for k, v in qb.LAUNCHES.items() if v}
            launches[name] = {k: v / MESH_ROUNDS for k, v in counts.items()}
            for k, v in counts.items():
                if path in paths:
                    paths[path][k] = paths[path].get(k, 0) + v
            # compared on the host, so that a state kept for a comparison
            # does not sit in the next run's peak
            return tree_map(lambda t: t.cpu(), state), hist, counts

        def lockstep(spec, first, other, check):
            """MESH_ROUNDS rounds, each from one state with the same draws:
            ``first`` (step kwargs), whose state carries on, then
            ``other``; ``check(first_out, other_out)`` holds each round (an
            out is (state, metrics))."""
            state = api.init(problem, x0, spec, device=device)
            gen = torch.Generator().manual_seed(SEED + 7)

            def one(kw, active, seeds, edge_seeds):
                kw = dict(kw)
                step_spec = kw.pop("spec", spec)
                e = (edge_seeds[:step_spec.topology.n_edges]
                     if step_spec.topology.is_two_tier else None)
                return api.step(
                    problem, step_spec, state, (xs, ys), torch.tensor(GAMMA),
                    None, active=active, seeds=seeds, edge_seeds=e,
                    device=device, **kw)

            for _ in range(MESH_ROUNDS):
                active, seeds = api.participation_draw(gen, spec, n_leaves)
                edge_seeds = torch.tensor(
                    [C.leaf_seeds(gen, n_leaves) for _ in range(4)])
                ref = one(first, active, seeds, edge_seeds)
                check(ref, one(other, active, seeds, edge_seeds))
                _free()
                state = ref[0]
                del ref
                _free()

        def gate(name, ok):
            gates[name] = gates.get(name, True) and bool(ok)

        def metrics_equal(h, g, keys):
            return all(torch.equal(h[k], g[k]) for k in keys)

        # -- 1. gather on the mesh: bit for bit the single-device run ----
        spec = spec_for()
        st_1, h_1, _ = free_run("single_device", "single_device", spec)
        st_g, h_g, _ = free_run("gather", "mesh", spec, mesh=mesh)
        gate("gather_bit_identical",
             bits_equal(tuple(st_1)[:3], tuple(st_g)[:3])
             and metrics_equal(h_1, h_g, h_1))
        per_client = spec.compressor.payload_bytes(x0)
        out["payload_bytes_per_client"] = per_client
        out["gather_collective_bytes"] = h_g[
            "collective_payload_bytes"].tolist()
        gate("gather_collective_bytes", torch.equal(
            h_g["collective_payload_bytes"],
            torch.full((MESH_ROUNDS,), float(N_CLIENTS * per_client)))
            and N_CLIENTS * per_client == 1_491_235_200)
        del st_1, h_1

        # -- 2. reduce on the mesh, variates zero and off ----------------
        partial_bytes = float((D_MODEL * D_FF + D_FF) * 4)
        for variates in ("zero", "off"):
            spec = spec_for(variates)
            if variates == "off":
                st_g, h_g, _ = free_run("gather_off", "mesh", spec, mesh=mesh)
            st_r, h_r, n_r = free_run(f"reduce_{variates}", "mesh", spec,
                                      mesh=mesh, uplink="reduce")
            gate(f"reduce_{variates}_collective_bytes", torch.equal(
                h_r["collective_payload_bytes"],
                torch.full((MESH_ROUNDS,), partial_bytes))
                and partial_bytes == 367_073_280)
            gate(f"reduce_{variates}_counts_equal_gather",
                 metrics_equal(h_r, h_g, ("n_active", "comm_bytes")))
            # x, and with variates on v and v_i
            ok, gaps[f"reduce_{variates}_vs_gather"] = _compare(
                tuple(st_r)[:3], tuple(st_g)[:3], 1e-5, 1e-6)
            gate(f"reduce_{variates}_allclose_to_gather", ok)
            if variates == "off":
                # the fused decode + reduce, once per round, for w (b's
                # 17,920 elements stay under the kernel route)
                gate("reduce_off_one_decode_reduce_per_round",
                     n_r.get("decode_reduce", 0) == MESH_ROUNDS)
            del st_r, st_g

        # -- 3. two-tier off the mesh, 4 edges of 4 clients --------------
        flat = spec_for(checksum=True)
        raw = spec_for(checksum=True, edges=4)
        re_ = spec_for(checksum=True, edges=4, reencode=True)
        per_edge = C._tree_bytes(re_.compressor.encode([0, 0], x0))
        out["reencoded_edge_payload_bytes"] = per_edge
        st_f, h_f, _ = free_run("flat_checksum", "single_device", flat)
        st_t, h_t, _ = free_run("two_tier_raw", "two_tier", raw)
        st_e, h_e, n_e = free_run("two_tier_reencode", "two_tier", re_)
        # recorded only: from round 2 the free runs draw different masks
        # (the two-tier run's edge seeds come from the same generator)
        gaps["free_two_tier_raw_vs_flat"] = dict(zip(
            ("allclose", "gap"),
            _compare(tuple(st_t)[:3], tuple(st_f)[:3], 1e-5, 1e-6)),
            n_active_equal=bool(torch.equal(h_t["n_active"],
                                            h_f["n_active"])))
        gate("two_tier_raw_backbone_bytes", torch.equal(
            h_t["backbone_bytes"], torch.full((MESH_ROUNDS,),
                                              4 * partial_bytes))
             and 4 * partial_bytes == 1_468_293_120)
        ok, gaps["two_tier_reencode_vs_raw"] = _compare(st_e.x, st_t.x,
                                                        0.0, 0.02)
        n_active = h_e["n_active"]
        gate("two_tier_reencode_within_lossy_bound",
             ok and all(bool(torch.isfinite(v).all())
                        for v in tree_leaves(st_e.x)))
        # the backbone undercuts the raw partials, and the uplink where
        # more clients sent than there are edges
        gate("two_tier_reencode_backbone_bytes",
             torch.equal(h_e["backbone_bytes"],
                         torch.full((MESH_ROUNDS,), 4.0 * per_edge))
             and 4 * per_edge < 4 * partial_bytes
             and bool(((n_active <= 4)
                       | (4 * per_edge < h_e["uplink_bytes"])).all()))
        gate("two_tier_reencode_encode_launches",
             n_e.get("encode_seeded", 0) == (N_CLIENTS + 4) * MESH_ROUNDS)
        out.update(two_tier_backbone_bytes_raw=h_t["backbone_bytes"].tolist(),
                   two_tier_backbone_bytes_reencode=h_e[
                       "backbone_bytes"].tolist())
        del st_f, st_t, st_e

        def check_flat(ref, got):
            (sr, mr), (sf, mf) = ref, got
            ok, gap = _compare(tuple(sr)[:3], tuple(sf)[:3], 1e-5, 1e-6)
            gate("two_tier_raw_allclose_to_flat", ok and metrics_equal(
                mr, mf, ("n_active", "uplink_bytes")))
            gaps.setdefault("lockstep_two_tier_raw_vs_flat", []).append(gap)

        lockstep(raw, {}, dict(spec=flat), check_flat)

        # -- 4. two-tier on the 1 x 1 (edge, client) mesh ----------------
        one = spec_for(edges=1)
        on_emesh = dict(mesh=emesh, client_axis="client")
        st_o, h_o, _ = free_run("two_tier_one_edge_off_mesh", "two_tier", one)
        st_m, h_m, _ = free_run("two_tier_one_edge_gather", "mesh", one,
                                **on_emesh)
        gate("one_edge_mesh_gather_bit_identical",
             bits_equal(tuple(st_o)[:3], tuple(st_m)[:3])
             and metrics_equal(h_o, h_m, h_o))
        del st_m
        st_r, h_r, _ = free_run("two_tier_one_edge_reduce", "mesh", one,
                                uplink="reduce", **on_emesh)
        bill = ("n_active", "uplink_bytes", "backbone_bytes", "comm_bytes")
        gate("one_edge_mesh_reduce_counts_equal",
             metrics_equal(h_r, h_o, bill))
        gaps["free_one_edge_reduce_vs_off_mesh"] = dict(zip(
            ("allclose", "gap"),
            _compare(tuple(st_r)[:3], tuple(st_o)[:3], 1e-5, 1e-6)))
        del st_o, st_r

        def compare_one(ref, got):
            (so, mo), (sr, mr) = ref, got
            ok, gap = _compare(tuple(sr)[:3], tuple(so)[:3], 1e-5, 1e-6)
            gate("one_edge_mesh_reduce_allclose",
                 ok and metrics_equal(mr, mo, bill))
            gaps.setdefault("lockstep_one_edge_reduce_vs_off_mesh",
                            []).append(gap)

        lockstep(one, {}, dict(uplink="reduce", **on_emesh), compare_one)

        # -- 5. the per-shard wrappers on a Shard(0) DTensor of w --------
        # against the unsharded kernel and the plain version, at the
        # kernel's group (BLOCK): block_quant(shard_safe=True) picks the
        # group that survives 32-way sharding of d_ff 17,920, which is 16
        # and off the kernel route; its DTensor route is checked too
        _free()
        gen = torch.Generator(device=device).manual_seed(SEED + 9)
        w = torch.randn((D_MODEL, D_FF), generator=gen, device=device) * 3.0
        seed = 0x9E3779B9
        g = BLOCK
        u = C.hash_dither(seed, w.shape, device=device)
        ws = distribute_tensor(w, mesh, [Shard(0)], src_data_rank=None)
        qb.reset_launches()
        got_q = kernel_ops.quantize_dequantize_sharded(ws, u, bits=BITS,
                                                       group=g)
        got_c, got_s = kernel_ops.quantize_encode_sharded(ws, u, bits=BITS,
                                                          group=g)
        out["per_shard_wrapper_launches"] = {
            k: v for k, v in qb.LAUNCHES.items() if v}
        gate("per_shard_wrappers_one_launch_each",
             out["per_shard_wrapper_launches"] == {"quantize": 1,
                                                   "encode": 1})
        groups = (D_MODEL, D_FF // g, g)
        plain_q = qb.ref.quantize_groups_ref(
            w.reshape(groups), u.reshape(groups), BITS).reshape(w.shape)
        plain_c, plain_s = qb.ref.encode_groups_ref(
            w.reshape(groups), u.reshape(groups), BITS)
        kern_q = qb.quantize_grouped(w, u, bits=BITS, group=g)
        kern_c, kern_s = qb.quantize_encode_grouped(w, u, bits=BITS, group=g)
        for name, got, wants in (
                ("quantize", got_q, (kern_q, plain_q)),
                ("codes", got_c, (kern_c, plain_c.reshape(w.shape))),
                ("scales", got_s, (kern_s, plain_s.reshape(groups[:2])))):
            local = got.to_local()
            gate(f"per_shard_{name}_bit_identical",
                 got.placements == (Shard(0),)
                 and all(bits_equal(local, want) for want in wants))
        del got_q, got_c, got_s, plain_q, plain_c, plain_s, kern_q, kern_c
        del kern_s, u
        comp = C.block_quant(BITS, BLOCK, dither="hash", shard_safe=True)
        applied = comp.apply([seed], ws)
        gate("shard_safe_dtensor_apply_bit_identical",
             applied.placements == (Shard(0),)
             and bits_equal(applied.to_local(), comp.apply([seed], w)))
        del w, ws, applied

        out.update(gates=gates, seconds_per_round=seconds,
                   peak_bytes=peaks, launches_per_round=launches,
                   max_abs_gap=gaps, launches=paths)
        for name, ok in gates.items():
            require(ok, f"mesh phase: gate {name} failed")
        for path, names in (("mesh", ("encode_seeded", "decode_reduce")),
                            ("two_tier", ("encode_seeded",))):
            for name in names:
                require(paths[path].get(name, 0) > 0,
                        f"mesh phase: kernel {name} was not launched on "
                        f"the {path} path")
        out["seconds"] = time.perf_counter() - t0
        return out
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the sched phase: the cohort scheduler, the fault axis and resume
# ---------------------------------------------------------------------------

SCHED_ROUNDS = 3
SCHED_POPULATION = 256


def sched_phase():
    """Phase 1's workload (in-kernel dither) through
    ``repro_torch.sched.CohortScheduler``. Each run is timed with the host
    clock around ``run`` ending in a synchronise, its peak read after a
    reset, its kernel launches counted from 0 (the scheduler's runs only:
    the ``api.run`` runs that gates compare with are left out). Gates
    (each raises):

    - sync, C = 16 (one full cohort), variates zero: bit for bit the
      port's ``api.run`` with the same seed (x, v, the arena against
      ``v_i``, every metric);
    - sync, C = 4: round 1 in lockstep with the C = 16 run's round 1
      (rtol 1e-5 / atol 1e-6); ``n_active`` and the bytes equal to the
      C = 16 run's in every round of the free run, whose gap is reported;
      peak at most half the C = 16 peak;
    - async with the defaults, C = 4: bit for bit the sync C = 4 run;
      pipelined (``max_inflight`` 8, ``buffer_cohorts`` 2, ``max_staleness``
      2, ``staleness.polynomial(0.5)``, 4 updates): staleness at most 2,
      finite;
    - a population of 256 clients, C = 16, variates off, 2 rounds, each
      cohort's data made on demand from its clients' stable seeds: peak
      within 5% of a 16-client run of the same kind;
    - faults (``checksum=True``, dropout 0.125, corrupt 0.125, cohort_fail
      0.25, 2 retries), C = 4: ``n_active`` and the billed bytes as the
      draws say, every flagged row and no other failing verification,
      finite; zero-probability faults bit for bit ``faults=None``; each
      corrupt kind at probability 1 caught in every row;
    - kill at round 2 of 4 (variates off, sync, C = 4) and ``resume()``:
      bit for bit the uninterrupted run;
    - the reduce uplink on a one-rank NCCL mesh, variates off, C = 8: one
      ``qb_decode_reduce`` a cohort a round, within rtol 1e-5 / atol 1e-6
      of the gather scheduler off the mesh (stepped in lockstep; the free
      runs' gap reported);
    - two-tier (4 edges of 4 clients), re-encoded, C = 4, 2 rounds: the
      backbone exactly 4 x 93,202,208 bytes a round; with C = 16, bit for
      bit the port's two-tier ``api.run``.
    Returns the phase's record."""
    import shutil
    import tempfile
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch import api
    from repro_torch.api import driver as driver_mod
    from repro_torch.core import compression as C
    from repro_torch.core.quadratic import quadratic_for_objective
    from repro_torch.faults import FaultSpec, ServerKilled
    from repro_torch.kernels import quantize_block as qb
    from repro_torch.sched import ClientPopulation, CohortScheduler, staleness
    from repro_torch.sched import scheduler as sched_mod
    from repro_torch.tree import tree_leaves, tree_map

    device, sync = "cuda", torch.cuda.synchronize
    t_phase = time.perf_counter()
    out = {"phase": "sched", "rounds": SCHED_ROUNDS, "clients": N_CLIENTS}
    xs, ys = make_workload()
    problem = api.as_problem(quadratic_for_objective(loss_fn, rho=RHO))
    x0 = {"w": torch.zeros((D_MODEL, D_FF), device=device),
          "b": torch.zeros((D_FF,), device=device)}
    n_leaves = len(tree_leaves(x0))
    gates, seconds, peaks, launches, gaps = {}, {}, {}, {}, {}
    sched_counts = {}

    def gate(name, ok):
        gates[name] = gates.get(name, True) and bool(ok)

    def spec_for(variates="zero", checksum=False, faults=None, n=N_CLIENTS,
                 edges=None, **kw):
        topo = ({} if edges is None else
                {"topology": api.Topology.two_tier(edges, reencode=True)})
        return api.FederationSpec(
            n_clients=n, participation=PARTICIPATION,
            alpha=0.0 if variates == "off" else ALPHA, variates=variates,
            compressor=C.block_quant(BITS, BLOCK, dither="kernel",
                                     checksum=checksum),
            faults=faults, **topo, **kw)

    def data_fn(t, gen, ids):
        idx = torch.as_tensor(ids, device=device)
        return xs[idx], ys[idx]

    def host(tree):
        return tree_map(lambda t: t.cpu(), tree)

    def timed(name, fn, rounds, count=True):
        """Run ``fn`` (a scheduler or api.run call), host-clocked to a
        synchronise, its peak after a reset; with ``count`` its quantizer
        launches go to the sched path."""
        _free()
        qb.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        sync()
        t = time.perf_counter()
        res = fn()
        sync()
        seconds[name] = (time.perf_counter() - t) / rounds
        peaks[name] = torch.cuda.max_memory_allocated()
        counts = {k: v for k, v in qb.LAUNCHES.items() if v}
        launches[name] = counts
        if count:
            for k, v in counts.items():
                sched_counts[k] = sched_counts.get(k, 0) + v
        return res

    def sched_run(name, spec, cohort_size, rounds=SCHED_ROUNDS, mesh=None,
                  uplink="gather", data=data_fn, **kw):
        sched = CohortScheduler(problem, spec, cohort_size=cohort_size,
                                mesh=mesh, uplink=uplink, device=device)
        st, pop, hist = timed(name, lambda: sched.run(
            x0, data, GAMMA, key=SEED, n_rounds=rounds, **kw), rounds)
        return host(st), pop, hist

    def same_bits(a, b):
        return bits_equal(host(a), host(b))

    def metrics_equal(h, g, keys):
        return all(torch.equal(h[k], g[k]) for k in keys)

    # -- 1. one full cohort: bit for bit the port's api.run -----------------
    spec = spec_for()
    st_r, h_r = timed("api_run_c16", lambda: api.run(
        problem, x0, (xs, ys), GAMMA, spec=spec, key=SEED,
        n_rounds=SCHED_ROUNDS, device=device), SCHED_ROUNDS, count=False)
    st_r = host(st_r)
    st16, pop16, h16 = sched_run("sync_c16", spec, N_CLIENTS)
    gate("c16_bit_identical_to_api_run",
         same_bits(tuple(st_r)[:2], tuple(st16)[:2])
         and same_bits(st_r.v_i, pop16.variates())
         and metrics_equal(h_r, h16, h_r))
    del st_r, pop16

    # -- 2. C = 4: round 1 in lockstep, the free run's accounting -----------
    one16 = sched_run("sync_c16_round1", spec, N_CLIENTS, rounds=1)
    one4 = sched_run("sync_c4_round1", spec, 4, rounds=1)
    ok, gaps["c4_vs_c16_round1"] = _compare(
        (one4[0].x, one4[0].v, one4[1].variates()),
        (one16[0].x, one16[0].v, one16[1].variates()), 1e-5, 1e-6)
    gate("c4_round1_lockstep_allclose", ok)
    del one16, one4
    st4, pop4, h4 = sched_run("sync_c4", spec, 4)
    gate("c4_counts_equal_c16", metrics_equal(
        h4, h16, ("n_active", "uplink_bytes", "comm_bytes")))
    gaps["c4_vs_c16_free"] = _compare((st4.x, st4.v), (st16.x, st16.v),
                                      1e-5, 1e-6)[1]
    gate("c4_peak_at_most_half_c16",
         peaks["sync_c4"] <= 0.5 * peaks["sync_c16"])
    del st16

    # -- 3. async: the defaults are sync; a pipelined window is bounded -----
    st_a, pop_a, h_a = sched_run("async_c4", spec, 4, mode="async")
    gate("async_defaults_bit_identical_to_sync",
         same_bits(tuple(st4)[:2], tuple(st_a)[:2])
         and same_bits(pop4.variates(), pop_a.variates())
         and metrics_equal(h4, h_a, h4))
    del st_a, pop_a, pop4, st4
    spec_p = spec_for(max_staleness=2,
                      staleness_weight=staleness.polynomial(0.5))
    st_p, _, h_p = sched_run("async_c4_pipelined", spec_p, 4, rounds=4,
                             mode="async", max_inflight=8, buffer_cohorts=2)
    out["pipelined_staleness_max"] = h_p["staleness_max"].tolist()
    gate("pipelined_staleness_bounded",
         float(h_p["staleness_max"].max()) <= 2.0
         and all(bool(torch.isfinite(t).all()) for t in tree_leaves(st_p.x)))
    del st_p

    # -- 4. 256 clients at C = 16, data made from the clients' seeds --------
    _free()
    gen = torch.Generator(device=device).manual_seed(SEED + 11)
    w_star = torch.randn((D_MODEL, D_FF), generator=gen,
                         device=device) / D_MODEL ** 0.5

    def on_demand(pop):
        def make(t, chain, ids):
            xb, yb = [], []
            for g in pop.client_generators(ids, device=device):
                x = torch.randn((BATCH, D_MODEL), generator=g, device=device)
                b = torch.randn((1, D_FF), generator=g, device=device)
                y = x @ w_star + b
                y += 0.1 * torch.randn(y.shape, generator=g, device=device)
                xb.append(x)
                yb.append(y)
            return torch.stack(xb), torch.stack(yb)
        return make

    for n in (N_CLIENTS, SCHED_POPULATION):
        spec_n = spec_for("off", n=n)
        pop = ClientPopulation(spec_n, x0, device=device)
        st_n, pop, h_n = sched_run(f"population_{n}_c16", spec_n, N_CLIENTS,
                                   rounds=2, population=pop,
                                   data=on_demand(pop))
        gate(f"population_{n}_finite",
             all(bool(torch.isfinite(t).all()) for t in tree_leaves(st_n.x))
             and int(pop.participation_counts.sum()) == int(
                 h_n["n_active"].sum()))
        del st_n, pop
    del w_star
    gate("population_256_peak_within_5pct",
         peaks[f"population_{SCHED_POPULATION}_c16"]
         <= 1.05 * peaks[f"population_{N_CLIENTS}_c16"])
    # what api.run would stack for 256 clients: the f32 drift stack alone
    # (one iterate per client), which one 80 GB card cannot hold
    iterate_bytes = (D_MODEL * D_FF + D_FF) * 4
    out["stacked_256_drift_bytes"] = SCHED_POPULATION * iterate_bytes

    # -- 5. faults ------------------------------------------------------------
    fs = FaultSpec(dropout=0.125, corrupt=0.125, cohort_fail=0.25,
                   max_retries=2)
    spec_f = spec_for(checksum=True, faults=fs)
    per_client = spec_f.compressor.payload_bytes(x0)
    out["checksummed_payload_bytes_per_client"] = per_client
    k_cohorts = N_CLIENTS // 4
    # the scheduler's own draws, made again: data_fn takes nothing from the
    # chain (key=SEED, a CPU generator), so each round's mask is the next
    # participation draw; the fault lanes are seeded by (SEED, round)
    gen_d = torch.Generator().manual_seed(SEED)
    drawn = []
    for t in range(SCHED_ROUNDS):
        active, _ = api.participation_draw(gen_d, spec_f, n_leaves)
        drop, corr = fs.client_draw(SEED, t, N_CLIENTS)
        fail_u, _ = fs.cohort_draw(SEED, t, k_cohorts)
        drawn.append({"active": active, "drop": drop, "corrupt": corr,
                      "fail_u": fail_u})
    verdicts = []
    real_corrupt, real_verify = driver_mod.corrupt_payload, \
        driver_mod.verify_payload
    last_flags = []

    def spy_corrupt(payload, flags, kind):
        last_flags.append(torch.as_tensor(flags).cpu())
        return real_corrupt(payload, flags, kind)

    def spy_verify(payload):
        ok = real_verify(payload)
        flags = last_flags.pop() if last_flags else None
        verdicts.append((flags, ok.cpu()))
        return ok

    driver_mod.corrupt_payload, driver_mod.verify_payload = \
        spy_corrupt, spy_verify
    try:
        st_f, pop_f, h_f = sched_run("faults_c4", spec_f, 4)
        flagged = [(f, ok) for f, ok in verdicts]
        gate("faults_flagged_rows_and_only_they_fail",
             len(flagged) == SCHED_ROUNDS * k_cohorts
             and all(f is not None and torch.equal(ok, ~f)
                     for f, ok in flagged))
        out["faults_rows_flagged"] = int(sum(int(f.sum())
                                             for f, _ in flagged))
        # each corrupt kind at probability one: every row caught
        for kind in ("flip", "truncate", "scales"):
            verdicts.clear()
            spec_k = spec_for(checksum=True, faults=FaultSpec(
                corrupt=1.0, corrupt_kind=kind))
            st_k, _, h_k = sched_run(f"corrupt_all_{kind}", spec_k, 4,
                                     rounds=1)
            gate(f"corrupt_all_{kind}_caught",
                 float(h_k["n_active"][0]) == 0.0
                 and all(not bool(ok.any()) for _, ok in verdicts)
                 and all(bool(torch.isfinite(t).all())
                         for t in tree_leaves(st_k.x)))
            del st_k
    finally:
        driver_mod.corrupt_payload, driver_mod.verify_payload = \
            real_corrupt, real_verify
    exp_active, exp_bytes, exp_retries, exp_abandoned = [], [], [], []
    for t, d in enumerate(drawn):
        sent = d["active"] & ~d["drop"]
        counted, billed, retries, abandoned = 0, 0, 0, 0
        for c in range(k_cohorts):
            rows = slice(4 * c, 4 * c + 4)
            fails = 0
            while fails < 3 and float(d["fail_u"][c, fails]) < 0.25:
                fails += 1
            n_sent = int(sent[rows].sum())
            retries += fails
            if fails == 3:
                abandoned += 1
                billed += 3 * n_sent
                continue
            billed += (fails + 1) * n_sent
            counted += int((sent & ~d["corrupt"])[rows].sum())
        exp_active.append(counted)
        exp_bytes.append(billed * per_client)
        exp_retries.append(retries)
        exp_abandoned.append(abandoned)
    out.update(faults_n_active=h_f["n_active"].tolist(),
               faults_expected_n_active=exp_active,
               faults_uplink_bytes=h_f["uplink_bytes"].tolist(),
               faults_expected_uplink_bytes=exp_bytes,
               faults_retries=h_f["fault_retries"].tolist(),
               faults_abandoned=h_f["fault_abandoned"].tolist())
    # the draws reach every fault path: drops, corrupt rows and retries
    gate("faults_draws_exercised",
         out["faults_rows_flagged"] > 0 and sum(exp_retries) > 0
         and any(bool(d["drop"].any()) for d in drawn))
    gate("faults_n_active_as_drawn",
         h_f["n_active"].tolist() == [float(v) for v in exp_active])
    # the exact bill, rounded once to the metric's float32
    gate("faults_bytes_as_drawn", torch.equal(
        h_f["uplink_bytes"], torch.tensor(exp_bytes, dtype=torch.float32)))
    gate("faults_retries_as_drawn",
         h_f["fault_retries"].tolist() == [float(v) for v in exp_retries]
         and h_f["fault_abandoned"].tolist() == [float(v)
                                                 for v in exp_abandoned])
    gate("faults_finite",
         all(bool(torch.isfinite(t).all())
             for t in tree_leaves((st_f.x, st_f.v))))
    del st_f, pop_f
    zero = [sched_run(f"zero_prob_{name}", spec_for(checksum=True, faults=f),
                      4, rounds=1)
            for name, f in (("none", None), ("faultspec", FaultSpec()))]
    gate("zero_prob_faults_bit_identical",
         same_bits(tuple(zero[0][0])[:2], tuple(zero[1][0])[:2])
         and same_bits(zero[0][1].variates(), zero[1][1].variates())
         and metrics_equal(zero[0][2], zero[1][2], zero[0][2]))
    del zero

    # -- 6. kill at round 2 of 4, then resume ----------------------------------
    spec_off = spec_for("off")
    st_u, _, h_u = sched_run("uninterrupted_c4", spec_off, 4, rounds=4)
    writes = []
    real_save = sched_mod.save_snapshot

    def timed_save(path, snap):
        t = time.perf_counter()
        real_save(path, snap)
        writes.append((os.path.getsize(path), time.perf_counter() - t))

    build_dir = Path(__file__).resolve().parent / "build"
    build_dir.mkdir(exist_ok=True)
    ck = tempfile.mkdtemp(prefix="sched_ck_", dir=str(build_dir))
    sched_mod.save_snapshot = timed_save
    try:
        spec_kill = spec_for("off", faults=FaultSpec(kill_round=2))
        killer = CohortScheduler(problem, spec_kill, cohort_size=4,
                                 device=device)
        killed_at = None
        try:
            timed("killed_c4", lambda: killer.run(
                x0, data_fn, GAMMA, key=SEED, n_rounds=4,
                checkpoint_dir=ck), 2)
        except ServerKilled as e:
            killed_at = e.round_index
        st_k, _, h_k = timed("resumed_c4", lambda: killer.resume(
            x0, data_fn, GAMMA, checkpoint_dir=ck, n_rounds=4), 2)
    finally:
        sched_mod.save_snapshot = real_save
        shutil.rmtree(ck, ignore_errors=True)
    gate("killed_at_round_2", killed_at == 2)
    gate("resume_bit_identical", same_bits(tuple(st_u)[:1], tuple(st_k)[:1])
         and metrics_equal(h_u, h_k, h_u))
    out.update(snapshot_bytes=[b for b, _ in writes],
               snapshot_write_seconds=[s for _, s in writes])
    del st_u, st_k

    # -- 7. the reduce uplink on a one-rank NCCL mesh, C = 8 --------------------
    torch.cuda.set_device(0)
    dist.init_process_group("nccl",
                            init_method=f"tcp://localhost:{_free_port()}",
                            rank=0, world_size=1)
    try:
        probe = torch.ones(1, device=device)
        dist.all_reduce(probe)        # NCCL's set-up, outside the timings
        sync()
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("clients",))
        st_g, _, h_g = sched_run("gather_c8_off", spec_off, 8)
        st_m, _, h_m = sched_run("mesh_reduce_c8_off", spec_off, 8,
                                 mesh=mesh, uplink="reduce")
        gate("mesh_reduce_one_decode_reduce_per_cohort_round",
             launches["mesh_reduce_c8_off"].get("decode_reduce", 0)
             == SCHED_ROUNDS * 2)
        gate("mesh_reduce_counts_equal_gather",
             metrics_equal(h_m, h_g, ("n_active", "comm_bytes")))
        gaps["free_mesh_reduce_vs_gather"] = _compare(st_m.x, st_g.x, 1e-5,
                                                      1e-6)[1]
        del st_g, st_m
        # lockstep: each round from one state with the same draws
        gen_l = torch.Generator().manual_seed(SEED + 17)
        state = None
        for t in range(SCHED_ROUNDS):
            active, seeds = api.participation_draw(gen_l, spec_off, n_leaves)
            d = {"active": active, "seeds": seeds}
            kw = dict(rounds=1, draws=lambda i, d=d: d, state0=state)
            ref = sched_run(f"gather_c8_off_lockstep_{t}", spec_off, 8, **kw)
            got = sched_run(f"mesh_reduce_c8_off_lockstep_{t}", spec_off, 8,
                            mesh=mesh, uplink="reduce", **kw)
            ok, gap = _compare(got[0].x, ref[0].x, 1e-5, 1e-6)
            gate("mesh_reduce_lockstep_allclose", ok)
            gaps.setdefault("lockstep_mesh_reduce_vs_gather", []).append(gap)
            state = ref[0]
            del ref, got
    finally:
        dist.destroy_process_group()

    # -- 8. two-tier, 4 edges of 4 clients, re-encoded ---------------------------
    spec_t = spec_for(checksum=True, edges=4)
    per_edge = C._tree_bytes(spec_t.compressor.encode([0, 0], x0))
    st_t4, _, h_t4 = sched_run("two_tier_c4", spec_t, 4, rounds=2)
    gate("two_tier_backbone_bytes", torch.equal(
        h_t4["backbone_bytes"], torch.full((2,), 4.0 * per_edge))
        and per_edge == 93_202_208)
    del st_t4
    st_tr, h_tr = timed("two_tier_api_run", lambda: api.run(
        problem, x0, (xs, ys), GAMMA, spec=spec_t, key=SEED, n_rounds=2,
        device=device), 2, count=False)
    st_tr = host(st_tr)
    st_t16, pop_t16, h_t16 = sched_run("two_tier_c16", spec_t, N_CLIENTS,
                                       rounds=2)
    gate("two_tier_c16_bit_identical_to_api_run",
         same_bits(tuple(st_tr)[:2], tuple(st_t16)[:2])
         and same_bits(st_tr.v_i, pop_t16.variates())
         and metrics_equal(h_tr, h_t16, h_tr))
    out["two_tier_backbone_bytes"] = h_t4["backbone_bytes"].tolist()
    del st_tr, st_t16, pop_t16, xs, ys

    out.update(gates=gates, seconds_per_round=seconds, peak_bytes=peaks,
               launches_per_run=launches, max_abs_gap=gaps,
               launches={"sched": sched_counts})
    failed = [name for name, ok in gates.items() if not ok]
    if failed:
        emit(dict(out, card=card_line()))
    require(not failed, f"sched phase: gates {failed} failed")
    for name in ("encode_seeded", "decode_reduce"):
        require(sched_counts.get(name, 0) > 0,
                f"sched phase: kernel {name} was not launched on the "
                f"sched path")
    out["seconds"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------------
# phase 4: the LM kernels against their plain versions, at the path's shapes
# ---------------------------------------------------------------------------

def _randn(shape, gen, dtype):
    import torch
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _attention_keeping(q, k, v, keep):
    """Plain float32 GQA attention over the (Sq, Sk) pairs ``keep`` marks,
    cast to q's dtype."""
    import torch
    Bq, Sq, H, hd = q.shape
    KV = k.shape[2]
    qg = q.float().reshape(Bq, Sq, KV, H // KV, hd)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float()) / hd ** 0.5
    logits.masked_fill_(~keep, -1e9)
    w = torch.softmax(logits, dim=-1)
    del logits
    out = torch.einsum("bkgqs,bskh->bqkgh", w, v.float())
    return out.reshape(q.shape).to(q.dtype)


def planted_attention_faults(q, k, v, want, window: int = 0):
    """Outputs that a wrong causal kernel (``window``: of that sliding
    window) would give at the path's shape, held against the plain
    version ``want`` with the bf16 limit, which must fail each of them: a
    late 64-key tile (keys S/2 .. S/2 + 63) skipped by every query past
    it, and a normalizer 3% off. Returns a record per fault, with the
    ratio under the old 3e-2 limit beside."""
    import torch
    S = q.shape[1]
    pos = torch.arange(S, device=q.device)
    keep = pos[None, :] <= pos[:, None]
    if window:
        keep &= pos[None, :] > pos[:, None] - window
    lo = S // 2
    keep[lo + 64:, lo:lo + 64] = False
    faults = {"late 64-key tile skipped": _attention_keeping(q, k, v, keep),
              "normalizer 3% off": (want.float() * 1.03).to(want.dtype)}
    records = []
    for fault, got in faults.items():
        ratio = worst_ratio(got, want, BF16_TOL)
        require(ratio > 1.0, f"the bf16 limit passes a planted fault "
                f"({fault}): {ratio} x the tolerance")
        records.append({"fault": fault, "max_abs_err": max_abs_err(got, want),
                        "worst_ratio": ratio,
                        "worst_ratio_old_limit": worst_ratio(got, want,
                                                             LOOSE_BF16_TOL)})
    return records


def planted_scan_faults(r, k, v, w, u, y_want, st_want):
    """Outputs that a wrong WKV6 kernel would give at the path's shape,
    held against the plain version's with the unchanged limits, which must
    fail each of them: the u bonus dropped, and the decay of one step (the
    middle one) skipped. Returns a record per fault."""
    import torch
    from repro_torch.kernels import rwkv_scan as rs
    w_skip = w.clone()
    w_skip[:, w.shape[1] // 2] = 1.0
    faults = {"u bonus dropped": (r, k, v, w, torch.zeros_like(u)),
              "one step's decay skipped": (r, k, v, w_skip, u)}
    records = []
    for fault, args in faults.items():
        y, st = rs.rwkv_scan_plain(*args)
        ratio_y = worst_ratio(y, y_want, RWKV_TOL["y"])
        ratio_st = worst_ratio(st, st_want, RWKV_TOL["state"])
        require(ratio_y > 1.0, f"the bf16 limit passes a planted scan fault "
                f"({fault}): {ratio_y} x the tolerance")
        records.append({"fault": fault, "max_abs_err_y": max_abs_err(y, y_want),
                        "worst_ratio_y": ratio_y,
                        "worst_ratio_state": ratio_st})
    return records


def sdpa_backend(fn) -> str:
    """The kernel that one call of ``fn`` (a scaled_dot_product_attention
    call) spends most device time in, from torch.profiler: which of
    PyTorch's attention backends the dispatcher chose."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if "CUDA" in str(getattr(e, "device_type", ""))]
    dev = lambda e: float(getattr(e, "self_device_time_total",
                                  getattr(e, "self_cuda_time_total", 0.0)))
    return max(events, key=dev).key[:100] if events else "not measured"


def gemma3_attention_checks(gen, checks: list) -> dict:
    """Flash attention at gemma3-12b's prefill shapes (B 4, S 2048, H 16,
    KV 8, hd 256): the global layers' causal shape, the local layers'
    window of 1024, and a ragged 2047-token one with a window of 1000
    (its edge inside a 64-key tile), each in bf16 and float32 against the
    plain version at FLASH_TOL. At the global and local shapes the planted
    faults, the kernel's time against its bound, and SDPA's time beside
    (K/V expanded; is_causal at the global shape, a boolean attn_mask at
    the local one) with the backend it ran. Returns the hd-256 records."""
    import torch
    import torch.nn.functional as F
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa

    cfg = configs.get("gemma3-12b")
    B, S = SERVE_BATCH, PROMPT_LEN
    H, KV, hd, W = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.window
    records = {}
    for name, Sq, window in (("gemma3 global", S, 0), ("gemma3 local", S, W),
                             ("gemma3 ragged window", S - 1, 1000)):
        for dtype in (torch.bfloat16, torch.float32):
            q = _randn((B, Sq, H, hd), gen, dtype)
            k = _randn((B, Sq, KV, hd), gen, dtype)
            v = _randn((B, Sq, KV, hd), gen, dtype)
            got = fa.flash_attention(q, k, v, causal=True, window=window)
            want = fa.flash_attention_plain(q, k, v, causal=True,
                                            window=window)
            tol = FLASH_TOL[str(dtype).split(".")[1]]
            err, ratio = max_abs_err(got, want), worst_ratio(got, want, tol)
            require(ratio <= 1.0,
                    f"flash attention ({name}, {dtype}) differs from its "
                    f"plain version: max abs err {err}, {ratio} x {tol}")
            rec = {"case": name, "shape": [B, Sq, Sq, H, KV, hd],
                   "causal": True, "window": window, "dtype": str(dtype),
                   "max_abs_err": err, "worst_ratio": ratio, "tol": tol}
            checks.append(rec)
            del got
            if Sq != S:
                continue
            call = lambda: fa.flash_attention(q, k, v, causal=True,
                                              window=window)
            if dtype == torch.float32:
                records[name]["f32_ms"] = time_ms(call, 3)
                continue
            rec["planted_faults"] = planted_attention_faults(q, k, v, want,
                                                             window)
            pos = torch.arange(S, device="cuda")
            keep = pos[None, :] <= pos[:, None]
            if window:
                keep &= pos[None, :] > pos[:, None] - window
            pairs = int(keep.sum())                       # valid (q, k)
            nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
            flops = fa.forward_flops(B, S, S, H, hd, True, window)
            entry = {"window": window, "pairs": pairs, "flop": flops,
                     "max_abs_err": err}
            entry["bound_ms"], entry["bound_by"] = bound(nbytes, flops,
                                                         BF16_OPS_PER_S)
            entry["ms"] = time_ms(call, 10)
            # the same launch writing each row's log-sum-exp (the train
            # path's forward)
            entry["ms_with_lse"] = time_ms(lambda: fa.flash_attention(
                q, k, v, causal=True, window=window, return_lse=True), 10)
            entry["pct_of_bound"] = 100 * entry["bound_ms"] / entry["ms"]
            entry["tflops"] = flops / (entry["ms"] * 1e-3) / 1e12
            entry["plain_ms"] = time_ms(
                lambda: fa.flash_attention_plain(q, k, v, causal=True,
                                                 window=window), 2, 1)
            qh = q.transpose(1, 2).contiguous()
            kh = k.repeat_interleave(H // KV, dim=2).transpose(1, 2) \
                .contiguous()
            vh = v.repeat_interleave(H // KV, dim=2).transpose(1, 2) \
                .contiguous()
            if window:
                lib = lambda: F.scaled_dot_product_attention(
                    qh, kh, vh, attn_mask=keep)
            else:
                lib = lambda: F.scaled_dot_product_attention(
                    qh, kh, vh, is_causal=True)
            r = worst_ratio(lib().transpose(1, 2), want, BF16_TOL)
            require(r <= 1.0, f"flash attention ({name}) disagrees with "
                    f"scaled_dot_product_attention: {r} x the tolerance")
            rec["sdpa_worst_ratio"] = r
            entry["library_ms"] = time_ms(lib, 10)
            entry["library_backend"] = sdpa_backend(lib)
            records[name] = entry
            del qh, kh, vh, keep
        del q, k, v, want
        _free()
    return records


def attention_times(q, k, v, pairs: int, check: dict,
                    causal: bool = True) -> dict:
    """The bf16 flash kernel on q, k, v (causal or not): its time against
    its bound (``pairs`` valid (q, k) pairs), the plain version's time,
    and SDPA's (the library yardstick: one PyTorch call on the same
    inputs, K/V expanded to the query heads outside the timed call) with
    the backend it ran, after holding SDPA's output against the kernel's
    at BF16_TOL (the worst ratio goes into ``check``)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa

    B, Sq, H, hd = q.shape
    group = H // k.shape[2]
    flops = fa.forward_flops(B, Sq, k.shape[1], H, hd, causal)
    require(flops == 4 * hd * pairs * B * H,
            f"flash's flops {flops} against {pairs} kept pairs")
    out = {"flop": flops}
    out["bound_ms"], out["bound_by"] = bound(
        2 * (2 * q.numel() + k.numel() + v.numel()), flops, BF16_OPS_PER_S)
    out["ms"] = time_ms(lambda: fa.flash_attention(q, k, v, causal=causal),
                        10)
    out["pct_of_bound"] = 100 * out["bound_ms"] / out["ms"]
    out["tflops"] = flops / (out["ms"] * 1e-3) / 1e12
    out["plain_ms"] = time_ms(lambda: fa.flash_attention_plain(
        q, k, v, causal=causal), 2, 1)
    qh = q.transpose(1, 2).contiguous()
    kh = k.repeat_interleave(group, dim=2).transpose(1, 2).contiguous()
    vh = v.repeat_interleave(group, dim=2).transpose(1, 2).contiguous()
    lib = lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                 is_causal=causal)
    ratio = worst_ratio(lib().transpose(1, 2),
                        fa.flash_attention(q, k, v, causal=causal), BF16_TOL)
    require(ratio <= 1.0, f"flash attention (group {group}, causal "
            f"{causal}) disagrees with scaled_dot_product_attention: "
            f"{ratio} x the tolerance")
    check["sdpa_worst_ratio"] = ratio
    out["library_ms"] = time_ms(lib, 10)
    out["library_backend"] = sdpa_backend(lib)
    return out


def lm_kernel_checks():
    """Flash attention at phi3's prefill shape (bf16, B 4, S 2048, H 40,
    KV 10, hd 128, causal), qwen3-moe's (H 64 over KV 4, a GQA group of
    16), jamba's (H 64 over KV 8, a group of 8), whisper-base's encoder
    (B 16, 1,500 frames, H 8 = KV 8, hd 64, non-causal) and cross
    attention (227 queries over the 1,500 frames, non-causal) and
    internvl2-26b's prefill (B 4, S 2,304, H 48 over KV 8, a group of 6,
    causal), each timed by
    ``attention_times``, a sliding-window and
    a ragged non-causal shape, and gemma3-12b's hd-256 shapes
    (``gemma3_attention_checks``);
    the WKV6 scan at rwkv6's prefill shape (bf16, B 4, S 2048, H 40,
    hd 64). Each against its plain version, with its time, bound and, for
    attention, the library call's time. Returns (phase record, kernel
    records)."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rwkv_scan as rs

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    bf16 = torch.bfloat16
    phi3, rwkv = configs.get("phi3-medium-14b"), configs.get("rwkv6-3b")
    checks = []

    def attention_case(name, B, Sq, Sk, H, KV, hd, causal, window, dtype):
        q = _randn((B, Sq, H, hd), gen, dtype)
        k = _randn((B, Sk, KV, hd), gen, dtype)
        v = _randn((B, Sk, KV, hd), gen, dtype)
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        want = fa.flash_attention_plain(q, k, v, causal=causal,
                                        window=window)
        tol = FLASH_TOL[str(dtype).split(".")[1]]
        err, ratio = max_abs_err(got, want), worst_ratio(got, want, tol)
        require(ratio <= 1.0,
                f"flash attention ({name}) differs from its plain version: "
                f"max abs err {err}, {ratio} x the tolerance {tol}")
        checks.append({"case": name, "shape": [B, Sq, Sk, H, KV, hd],
                       "causal": causal, "window": window,
                       "dtype": str(dtype), "max_abs_err": err,
                       "worst_ratio": ratio, "tol": tol})
        return q, k, v, want, err

    # the path's shape first: its record carries the times
    B, S = SERVE_BATCH, PROMPT_LEN
    H, KV, hd = phi3.n_heads, phi3.n_kv_heads, phi3.hd
    q, k, v, want, err = attention_case("phi3 prefill", B, S, S, H, KV, hd,
                                        True, 0, bf16)
    checks[-1]["planted_faults"] = planted_attention_faults(q, k, v, want)
    del want
    pos = torch.arange(S, device="cuda")
    pairs = int((pos[None, :] <= pos[:, None]).sum())      # valid (q, k)
    flash = {"name": "flash_attention", "route": "cuda",
             "source": LM_SOURCES["flash_attention"],
             "replaces": REPLACES["flash_attention"], "max_abs_err": err,
             **attention_times(q, k, v, pairs, checks[-1])}
    flash["ms_with_lse"] = time_ms(lambda: fa.flash_attention(
        q, k, v, return_lse=True), 10)
    del q, k, v
    # qwen3-moe's prefill: 64 query heads over 4 KV heads, a group of 16
    qwen3 = configs.get("qwen3-moe-235b-a22b")
    H, KV, hd = qwen3.n_heads, qwen3.n_kv_heads, qwen3.hd
    q, k, v, want, err = attention_case("qwen3 prefill", B, S, S, H, KV, hd,
                                        True, 0, bf16)
    del want
    flash["qwen3_group16"] = {
        "shape": [B, S, S, H, KV, hd], "group": H // KV, "max_abs_err": err,
        **attention_times(q, k, v, pairs, checks[-1])}
    del q, k, v
    # jamba's prefill: 64 query heads over 8 KV heads, a group of 8
    jamba = configs.get("jamba-1.5-large-398b")
    H, KV, hd = jamba.n_heads, jamba.n_kv_heads, jamba.hd
    q, k, v, want, err = attention_case("jamba prefill", B, S, S, H, KV, hd,
                                        True, 0, bf16)
    del want
    flash["jamba_group8"] = {
        "shape": [B, S, S, H, KV, hd], "group": H // KV, "max_abs_err": err,
        **attention_times(q, k, v, pairs, checks[-1])}
    del q, k, v
    # the frontend families: whisper-base's encoder (non-causal over its
    # 1,500 frames) and cross attention (227 prompt tokens over them), hd
    # 64, 8 heads over 8; internvl2-26b's prefill over 256 patches and
    # 2,048 tokens, 48 query heads over 8 KV heads (a group of 6), hd 128
    whisper = configs.get("whisper-base")
    internvl = configs.get("internvl2-26b")
    frames = whisper.n_frontend_tokens
    for name, Bq, Sq, Sk, cfg, causal in (
            ("whisper_encoder", WHISPER_BATCH, frames, frames, whisper, False),
            ("whisper_cross", WHISPER_BATCH, WHISPER_PROMPT, frames, whisper,
             False),
            ("internvl_group6", B, internvl.n_frontend_tokens + S,
             internvl.n_frontend_tokens + S, internvl, True)):
        H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        q, k, v, want, err = attention_case(name.replace("_", " "), Bq, Sq,
                                            Sk, H, KV, hd, causal, 0, bf16)
        del want
        pos_q, pos_k = (torch.arange(n, device="cuda") for n in (Sq, Sk))
        pairs = (int((pos_k[None, :] <= pos_q[:, None]).sum()) if causal
                 else Sq * Sk)
        flash[name] = {"shape": [Bq, Sq, Sk, H, KV, hd], "group": H // KV,
                       "causal": causal, "pairs": pairs, "max_abs_err": err,
                       **attention_times(q, k, v, pairs, checks[-1],
                                         causal)}
        del q, k, v
        _free()
    attention_case("sliding window", 2, 1024, 1024, 16, 4, 64, True, 256,
                   bf16)
    attention_case("non-causal ragged", 2, 333, 1000, 8, 4, 32, False, 0,
                   torch.float32)
    flash["hd256"] = gemma3_attention_checks(gen, checks)

    # the WKV6 scan at rwkv6's prefill shape: decays as the model makes
    # them, exp(-exp(w_raw)) with w_raw near the -2 bias
    hd = rwkv.rwkv_head_dim
    H = rwkv.d_model // hd
    r, kk, vv = (_randn((B, S, H, hd), gen, bf16) for _ in range(3))
    w = torch.exp(-torch.exp(_randn((B, S, H, hd), gen, torch.float32)
                             - 2.0)).to(bf16)
    u = _randn((H, hd), gen, bf16) * 0.1
    y, st = rs.rwkv_scan(r, kk, vv, w, u)
    y_want, st_want = rs.rwkv_scan_plain(r, kk, vv, w, u)
    err_y, err_st = max_abs_err(y, y_want), max_abs_err(st, st_want)
    ratio_y = worst_ratio(y, y_want, RWKV_TOL["y"])
    ratio_st = worst_ratio(st, st_want, RWKV_TOL["state"])
    require(ratio_y <= 1.0, f"WKV6 y differs from its plain version: max "
            f"abs err {err_y}, {ratio_y} x the tolerance")
    require(ratio_st <= 1.0, f"WKV6 state differs from its plain version: "
            f"max abs err {err_st}, {ratio_st} x the tolerance")
    checks.append({"case": "rwkv6 prefill", "shape": [B, S, H, hd],
                   "dtype": "torch.bfloat16", "max_abs_err_y": err_y,
                   "max_abs_err_state": err_st, "worst_ratio_y": ratio_y,
                   "worst_ratio_state": ratio_st, "tol": RWKV_TOL,
                   "planted_faults": planted_scan_faults(
                       r, kk, vv, w, u, y_want, st_want)})
    del y_want, st_want
    n = r.numel()
    scan = {"name": "rwkv_scan", "route": "cuda",
            "source": LM_SOURCES["rwkv_scan"],
            "replaces": REPLACES["rwkv_scan"],
            "max_abs_err": max(err_y, err_st), "library_ms": None}
    # r, k, v, w read and y written (bf16), u read and the state written
    # (f32). The function's float32 operations: per state element and
    # step, S <- w S + k v (a multiply and an FMA) and r . S (an FMA),
    # 5 FLOP; the u bonus is rank one, (sum_k r_k u_k k_k) v, 5 FLOP per
    # (step, head, channel)
    scan["bound_ms"], scan["bound_by"] = bound(
        2 * 5 * n + 4 * (u.numel() + st.numel()), rs.forward_flops(*r.shape),
        F32_OPS_PER_S)
    scan["ms"] = time_ms(lambda: rs.rwkv_scan(r, kk, vv, w, u), 10)
    scan["plain_ms"] = time_ms(lambda: rs.rwkv_scan_plain(r, kk, vv, w, u),
                               2, 1)
    # batch row 0 alone: its H blocks get an SM each, so this is one
    # block's time, against the card's in scan["ms"]
    ms_one = time_ms(lambda: rs.rwkv_scan(r[:1], kk[:1], vv[:1], w[:1], u),
                     10)
    return ({"phase": "lm_kernels_vs_plain", "checks": checks,
             "rwkv_scan_us_per_step": scan["ms"] * 1e3 / S,
             "rwkv_scan_ms_batch_1": ms_one,
             "times_ms": {e["name"]: {f: e[f] for f in (
                 "ms", "plain_ms", "bound_ms", "library_ms")}
                 for e in (flash, scan)}},
            {"flash_attention": flash, "rwkv_scan": scan})


# ---------------------------------------------------------------------------
# phases 5 and 6: serving phi3-medium-14b and rwkv6-3b
# ---------------------------------------------------------------------------

def _free() -> None:
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def start_figures(profile: bool):
    """The figures and Fig. 3 phases in a child process of this script
    (``FIGURES_CHILD``), started beside the mesh and scheduler phases:
    both are bound by the host, neither gates a time, and the figures
    launch no kernel of the port. Returns (process, its stdout lines as
    a reader thread collects them, the thread)."""
    import threading
    cmd = [sys.executable, str(Path(__file__).resolve()), FIGURES_CHILD]
    child = subprocess.Popen(cmd + (["--profile"] if profile else []),
                             stdout=subprocess.PIPE, text=True)
    lines: list = []
    reader = threading.Thread(target=lambda: lines.extend(child.stdout),
                              daemon=True)
    reader.start()
    return child, lines, reader


def join_figures(started) -> None:
    """Wait for the child of ``start_figures`` and print its records here,
    in the order of the phases; its failure (a gate, a crash) fails the
    run, with its stack on standard error."""
    child, lines, reader = started
    rc = child.wait()
    reader.join()
    for line in lines:
        print(line, end="", flush=True)
    require(rc == 0, f"the figures phases failed (exit {rc})")


def stop_figures(started) -> None:
    """Stop the child of ``start_figures`` if it still runs."""
    child = started[0]
    if child.poll() is None:
        child.kill()
        child.wait()


def figures_child(profile: bool) -> int:
    """The child of ``start_figures``: the figures and Fig. 3 phases,
    their records on standard output. It dies with this script (Linux's
    parent-death signal), so a run stopped early leaves no process."""
    import signal
    libc = ctypes.CDLL(None, use_errno=True)
    libc.prctl(1, int(signal.SIGKILL))           # PR_SET_PDEATHSIG
    if os.getppid() == 1:                         # the parent is gone
        return 1
    PROGRESS_TAG[0] = "chip_smoke[figures]"
    card = card_line()
    figures(card, profile)
    _free()
    fig3_phase(card, profile)
    return 0


def _check_served(cfg, toks, info, new_tokens, batch=SERVE_BATCH) -> None:
    require(tuple(toks.shape) == (batch, new_tokens),
            f"{cfg.name}: generated ids of shape {tuple(toks.shape)}")
    require(bool(((toks >= 0) & (toks < cfg.vocab)).all()),
            f"{cfg.name}: a generated id outside [0, vocab)")
    require(info["logits_finite"], f"{cfg.name}: a logit is not finite")


def serve_smoke_presets():
    """The port's default serve command, ``python -m
    repro_torch.launch.serve --arch A`` (``--preset smoke``: the reduced
    float32 config, two layers; rwkv6's head dim 16, phi3's, gemma3's and
    the MoE archs' 32, gemma3's layers [swa_mlp, attn_mlp] with a window
    of 16, qwen3-moe's and llama4's 4 experts, top 2 and top 1, jamba's
    [mamba_mlp, attn_moe], whisper's 2 encoder and 2 decoder layers over
    8 frames, internvl's 2 layers over 8 patches), for every ported arch,
    through ``launch/serve.py:main`` on the card: ids in [0, vocab),
    finite logits, the kernel's launches in the one prefill as
    ``transformer.prefill_kernel_launches`` counts them (counts set to 0
    just before, read just after)."""
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import mamba
    from repro_torch.models import transformer as T

    out = {"phase": "serve_smoke_preset", "archs": {}}
    for aid in ("phi3-medium-14b", "rwkv6-3b", "gemma3-12b",
                "qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b",
                "jamba-1.5-large-398b", "whisper-base", "internvl2-26b"):
        cfg = configs.get(aid).reduced()
        counter, key = sequence_kernel(cfg)
        want = T.prefill_kernel_launches(cfg)
        counter[key] = 0
        mamba.LAUNCHES["ssm_scan"] = 0
        toks, info = serve.main(["--arch", aid, "--device", "cuda"])
        require(bool(((toks >= 0) & (toks < cfg.vocab)).all()),
                f"{aid} smoke: a generated id outside [0, vocab)")
        require(info["logits_finite"], f"{aid} smoke: a logit is not finite")
        require(counter[key] == want,
                f"{aid} smoke: {counter[key]} {key} launches in one prefill, "
                f"want {want}")
        out["archs"][aid] = {"hd": cfg.rwkv_head_dim if cfg.family == "ssm"
                             else cfg.hd, "dtype": cfg.dtype,
                             "pattern": T.layer_pattern(cfg),
                             "launches": counter[key],
                             "ssm_scan_calls": mamba.LAUNCHES["ssm_scan"],
                             "ids_seq0": toks[0].tolist(),
                             "prefill_seconds": info["prefill_seconds"]}
    return out


def sequence_kernel(cfg) -> tuple:
    """The launch counter and key of the arch's sequence kernel: the WKV6
    scan's for rwkv, flash attention's otherwise."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rwkv_scan as rs
    return ((rs.LAUNCHES, "rwkv_scan") if cfg.family == "ssm"
            else (fa.LAUNCHES, "flash_attention"))


def scan_calls_per_prefill(cfg, seq_len: int) -> int:
    """What ``mamba.LAUNCHES["ssm_scan"]`` counts for one forward of every
    Mamba layer of ``cfg`` over ``seq_len`` tokens."""
    from repro_torch.models import mamba
    from repro_torch.models import transformer as T
    n = sum(kind in T.MAMBA_KINDS for kind in T.layer_pattern(cfg))
    chunks = -(-seq_len // mamba.CHUNK)
    return n * (mamba.CALLS_PER_CHUNK * chunks + seq_len)


def decode_consistency(cfg, recurrent: bool, prompts=(PROMPT_LEN,),
                       layers=2):
    """A full-width float32 build of ``cfg`` at ``layers`` layers (None:
    its full depth; gemma3's two with ``global_every=2``: one local layer,
    window 1024, and one global; jamba's two with ``attn_every=2``, its
    ``reduced()`` pattern [mamba_mlp, attn_moe]; an MoE's with the no-drop
    capacity factor E, as the reference's check: dropping by capacity is
    not causal): decode(prefill(x[:S]), x[S], pos=S) against
    prefill(x[:S+1])'s last logits at each S of ``prompts``, within
    CONSISTENCY_TOL (tests/test_models_smoke.py's checks; the attention
    cache is allocated S + 8 long). A request of audio or vlm carries its
    frontend in both, and vlm's positions and cache count its patches.
    Reports the peak memory."""
    import dataclasses
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.models.model import (FRONTEND_KEYS, build_model,
                                          make_batch, n_prefix)

    cfg2 = dataclasses.replace(cfg, n_layers=layers or cfg.n_layers,
                               dtype="float32",
                               global_every=min(cfg.global_every, 2),
                               attn_every=min(cfg.attn_every, 2))
    if cfg.n_experts:
        cfg2 = dataclasses.replace(cfg2,
                                   capacity_factor=float(cfg.n_experts))
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg2, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    params = model.init(gen)
    full = make_batch(gen, cfg2, SERVE_BATCH, max(prompts) + 1)
    toks, front = full["tokens"], {k: full[k] for k in full
                                   if k in FRONTEND_KEYS.values()}
    P = n_prefix(cfg2)
    out = {"layers": T.layer_pattern(cfg2), "dtype": "float32",
           "encoder_layers": cfg2.n_encoder_layers if front else 0,
           "frontend_tokens": cfg2.n_frontend_tokens if front else 0,
           "parameters": sum(p.numel() for p in params.parameters()),
           "capacity_factor": cfg2.capacity_factor, "tol": CONSISTENCY_TOL,
           "checks": []}
    for S in prompts:
        cache_len = None if recurrent else P + S + 8
        _, cache = model.prefill(params, {"tokens": toks[:, :S], **front},
                                 cache_len=cache_len)
        got, _ = model.decode(params, cache, toks[:, S:S + 1], P + S)
        want, _ = model.prefill(params, {"tokens": toks[:, :S + 1],
                                         **front})
        got, want = got[..., :cfg.vocab], want[..., :cfg.vocab]
        err = max_abs_err(got, want)
        require(bool(torch.isfinite(got).all()), "decode logits not finite")
        require(worst_ratio(got, want, {"atol": CONSISTENCY_TOL,
                                        "rtol": CONSISTENCY_TOL}) <= 1.0,
                f"{cfg.name}: decode disagrees with prefill at a "
                f"{S}-token prompt: {err}")
        out["checks"].append({"prompt": S, "position": P + S,
                              "cache_len": cache_len, "max_abs_err": err})
        del cache, got, want
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    del params
    _free()
    return out


def cache_bytes_by_kind(cfg, batch: int, seq_len: int) -> dict:
    """The bytes of each layer kind's KV cache (or state) for ``batch``
    sequences of ``seq_len`` positions: ``init_cache``'s layout, built on
    the meta device (no memory)."""
    from repro_torch.models import transformer as T
    from repro_torch.models.model import build_model
    caches = build_model(cfg, device="meta").init_cache(batch, seq_len)
    out = {}
    for kind, cache in zip(T.layer_pattern(cfg), caches):
        out[kind] = out.get(kind, 0) + sum(
            t.numel() * t.element_size() for t in cache.values())
    return out


def serve_model(phase: str, profile: bool, arch: str, overrides=None,
                batch_size=SERVE_BATCH, prompt_len=PROMPT_LEN,
                new_tokens=NEW_TOKENS, int8_tokens=NEW_TOKENS_INT8,
                prompts=(PROMPT_LEN,), consistency_layers=2):
    """The serving path for one architecture at full width and depth (or
    the depth that the config ``overrides`` give), one row of SERVE_RUNS:
    random bf16 weights on the card from SEED (one matrix at a time), a
    warm-up request, then ``batch_size`` requests of ``prompt_len``-token
    prompts (and, for audio and vlm, their stub frontend: ``make_batch``'s
    frames or patches) with ``new_tokens`` greedy tokens, and
    (``int8_tokens`` > 0) the same batch with the int8 KV cache; the
    cache's bytes by layer kind; peak memory under 80 GB; for an MoE, the
    share of (token, choice) pairs its capacity dropped in the measured
    prefill, over its MoE layers; for Mamba layers, the scan's calls in
    that prefill; then ``decode_consistency`` at ``prompts`` and
    ``consistency_layers``. The sequence kernel's counter is set to 0 just
    before the measured requests and read just after; it must count
    ``transformer.prefill_kernel_launches`` a prefill."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.launch.serve import serve
    from repro_torch.models import mamba, moe
    from repro_torch.models import transformer as T
    from repro_torch.models.model import build_model, make_batch, n_prefix

    cfg = dataclasses.replace(configs.get(arch), **(overrides or {}))
    pattern = T.layer_pattern(cfg)
    launches, per_prefill_name = sequence_kernel(cfg)
    n_kernel = T.prefill_kernel_launches(cfg)
    n_moe = sum(kind in T.MOE_KINDS for kind in pattern)
    # the positions a request fills: vlm's patches, then the prompt
    positions = n_prefix(cfg) + prompt_len
    model = build_model(cfg, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model.init(gen)
    torch.cuda.synchronize()
    out = {"phase": phase, "arch": arch, "kernel": per_prefill_name,
           "layers": cfg.n_layers, "pattern": pattern,
           "init_seconds": time.perf_counter() - t0,
           "parameters": sum(p.numel() for p in params.parameters()),
           "parameter_bytes": sum(p.numel() * p.element_size()
                                  for p in params.parameters()),
           "batch": batch_size, "prompt_len": prompt_len,
           "prefix_positions": n_prefix(cfg)}
    if cfg.family == "audio":
        out.update(encoder_layers=cfg.n_encoder_layers,
                   frames=cfg.n_frontend_tokens)
    batch = make_batch(gen, cfg, batch_size, prompt_len)
    # warm-up: cuBLAS handles and the kernels' libraries load here
    serve(model, params, batch, 2)

    launches[per_prefill_name] = 0
    moe.reset_dispatch()
    mamba.LAUNCHES["ssm_scan"] = 0
    torch.cuda.reset_peak_memory_stats()
    toks, info = serve(model, params, batch, new_tokens)
    peak = torch.cuda.max_memory_allocated()
    out["bf16_kv"] = dict(info, new_tokens=new_tokens,
                          launches=launches[per_prefill_name],
                          ssm_scan_calls=mamba.LAUNCHES["ssm_scan"],
                          peak_bytes=peak,
                          cache_bytes=cache_bytes_by_kind(
                              cfg, batch_size, positions + new_tokens),
                          ids_seq0=toks[0].tolist())
    _check_served(cfg, toks, info, new_tokens, batch_size)
    require(peak < 80e9, f"{arch}: peak {peak} bytes")
    # the scan runs in a prefill only: a decode step is one update
    want_scan = scan_calls_per_prefill(cfg, prompt_len)
    require(mamba.LAUNCHES["ssm_scan"] == want_scan,
            f"{arch}: {mamba.LAUNCHES['ssm_scan']} scan calls in one "
            f"prefill, want {want_scan}")
    if n_moe:
        # a decode step's group is one token, which never drops: every
        # dropped pair is the prefill's
        prefill_pairs = batch_size * prompt_len * cfg.top_k * n_moe
        decode_pairs = batch_size * cfg.top_k * n_moe * (new_tokens - 1)
        require(moe.DISPATCH["pairs"] == prefill_pairs + decode_pairs,
                f"{arch}: {moe.DISPATCH} routed pairs, want {prefill_pairs} "
                f"+ {decode_pairs}")
        dropped = moe.DISPATCH["pairs"] - moe.DISPATCH["kept"]
        out["bf16_kv"].update(moe_layers=n_moe,
                              moe_pairs_prefill=prefill_pairs,
                              moe_pairs_dropped=dropped,
                              moe_dropped_share=dropped / prefill_pairs)
    require(launches[per_prefill_name] == n_kernel,
            f"{per_prefill_name}: {launches[per_prefill_name]} launches in "
            f"one prefill, want {n_kernel} (prefill_kernel_launches)")
    if int8_tokens:
        model8 = build_model(dataclasses.replace(cfg, kv_dtype="int8"),
                             device="cuda")
        torch.cuda.reset_peak_memory_stats()
        toks8, info8 = serve(model8, params, batch, int8_tokens)
        _check_served(cfg, toks8, info8, int8_tokens, batch_size)
        out["int8_kv"] = dict(info8, new_tokens=int8_tokens,
                              peak_bytes=torch.cuda.max_memory_allocated(),
                              cache_bytes=cache_bytes_by_kind(
                                  model8.cfg, batch_size,
                                  positions + int8_tokens),
                              ids_seq0=toks8[0].tolist())
    count = launches[per_prefill_name]
    n_prefills = 2 if int8_tokens else 1
    require(count == n_prefills * n_kernel,
            f"{per_prefill_name}: {count} launches in {n_prefills} prefills")
    out["launches"] = count
    if profile:
        emit(profile_serving(model, params, batch))
    del params, batch
    _free()
    out["decode_consistency"] = decode_consistency(
        cfg, cfg.family == "ssm", prompts, consistency_layers)
    return out


# ---------------------------------------------------------------------------
# the paper's figures (Fig. 1 and Fig. 2 at the paper's sizes)
# ---------------------------------------------------------------------------

def _finite_history(hist) -> bool:
    import math
    return all(math.isfinite(v) for h in hist for v in h.values())


def figures(card: str, profile: bool) -> list:
    """Fig. 1 and Fig. 2 of the paper at ``--full`` on the GPU, each data
    setting built once and reused, with the reference's outcomes as gates;
    then the GPU-vs-CPU check. Returns the phase's JSON records."""
    from repro_torch.benchmarks import fig1_dictlearn as fig1
    from repro_torch.benchmarks import fig2_control_variates as fig2
    from repro_torch.kernels import quantize_block as qb

    device = "cuda"
    kernel_launches0 = sum(qb.LAUNCHES.values())
    t0 = time.perf_counter()
    settings = {exp.name: fig1.make_setting(exp, seed=SEED, reduced=False,
                                            device=device)
                for exp in fig1.SETTINGS}
    build_s = time.perf_counter() - t0
    records = []
    for exp in fig1.SETTINGS:
        setting = settings[exp.name]
        out = fig1.run_setting(exp, rounds=FIG_ROUNDS, reduced=False,
                               seed=SEED, device=device, setting=setting)
        row = fig1.summary(exp, out)
        require(_finite_history(out["fedmm"]) and _finite_history(out["naive"]),
                f"fig1 {exp.name}: a metric is not finite")
        require(row["fedmm_loss_last"] < row["fedmm_loss_first"],
                f"fig1 {exp.name}: FedMM's loss did not fall: {row}")
        require(row["naive_loss_last"] > row["fedmm_loss_last"],
                f"fig1 {exp.name}: naive ended at or below FedMM: {row}")
        records.append(dict(
            row, phase="fig1", rounds=FIG_ROUNDS, p=setting.spec.p,
            K=setting.spec.K, clients=tuple(setting.clients.shape),
            seconds_fedmm=out["seconds_fedmm"],
            seconds_naive=out["seconds_naive"],
            rounds_per_s_fedmm=FIG_ROUNDS / out["seconds_fedmm"],
            rounds_per_s_naive=FIG_ROUNDS / out["seconds_naive"],
            card=card))
        emit(records[-1])
    for exp in fig1.SETTINGS:
        hists, secs = {}, {}
        for alpha in FIG2_ALPHAS:
            t1 = time.perf_counter()
            hists[alpha] = fig2.run_setting(
                exp, alpha=alpha, rounds=FIG_ROUNDS, reduced=False,
                seed=SEED, device=device, setting=settings[exp.name])
            secs[alpha] = time.perf_counter() - t1
            require(_finite_history(hists[alpha]),
                    f"fig2 {exp.name} alpha {alpha}: a metric is not finite")
        tails = {a: fig2.es_tail(h, FIG_ROUNDS) for a, h in hists.items()}
        losses = {a: h[-1]["loss"] for a, h in hists.items()}
        a0, a1 = FIG2_ALPHAS
        loss_gap = abs(losses[a1] - losses[a0]) / abs(losses[a0])
        if exp.split != "homogeneous":
            require(tails[a1] < tails[a0],
                    f"fig2 {exp.name}: control variates did not lower the "
                    f"E^s tail: {tails}")
        require(loss_gap <= FIG2_LOSS_RTOL,
                f"fig2 {exp.name}: losses differ by {loss_gap:.3%}: {losses}")
        records.append({
            "phase": "fig2", "setting": exp.name, "rounds": FIG_ROUNDS,
            "es_tail_alpha0": tails[a0], "es_tail_alpha001": tails[a1],
            "loss_alpha0": losses[a0], "loss_alpha001": losses[a1],
            "loss_gap": loss_gap,
            "seconds_alpha0": secs[a0], "seconds_alpha001": secs[a1],
            "rounds_per_s": 2 * FIG_ROUNDS / (secs[a0] + secs[a1]),
            "card": card})
        emit(records[-1])
    records.append(device_consistency(settings, card))
    emit(records[-1])
    if profile:
        records.append(profile_figure_rounds(settings, card))
        emit(records[-1])
    launched = sum(qb.LAUNCHES.values()) - kernel_launches0
    require(launched == 0, f"the figures launched {launched} quantizer "
            f"kernels; their leaves are below the kernel route")
    records.append({"phase": "figures", "setting_build_seconds": build_s,
                    "seconds": time.perf_counter() - t0,
                    "kernel_launches": launched, "card": card})
    emit(records[-1])
    return records


def device_consistency(settings, card: str) -> dict:
    """DEVICE_CHECK_ROUNDS FedMM rounds on the MovieLens-like setting with
    the identity compressor, on the GPU and on the CPU, from the same data,
    participation masks and seeds (``key=SEED`` is a CPU generator on both,
    and the minibatch indices are drawn on it): the losses agree within
    DEVICE_RTOL, or a cuSOLVER / cuBLAS path differs from the CPU's."""
    from repro_torch import api
    from repro_torch.benchmarks import fig1_dictlearn as fig1
    from repro_torch.configs.dictlearn import MOVIELENS
    from repro_torch.core import compression as C

    def history(device):
        setting = settings["movielens"]
        setting = fig1.Setting(setting.spec,
                               *(x.to(device) for x in setting[1:]))
        sur, x0, data, gamma, kw = fig1.algorithm_args(
            MOVIELENS, setting, C.identity())["fedmm"]
        _, hist = api.run(sur, x0, data, gamma, key=SEED,
                          n_rounds=DEVICE_CHECK_ROUNDS, device=device, **kw)
        return api.history_list(hist)

    gpu, cpu = history("cuda"), history("cpu")
    rel = max(abs(g["loss"] - c["loss"]) / abs(c["loss"])
              for g, c in zip(gpu, cpu))
    same_mask = all(g["n_active"] == c["n_active"] for g, c in zip(gpu, cpu))
    require(same_mask, "GPU and CPU runs drew different participation")
    require(rel <= DEVICE_RTOL,
            f"GPU and CPU losses differ by {rel:.3e} > {DEVICE_RTOL}")
    return {"phase": "figures_device_consistency", "setting": "movielens",
            "rounds": DEVICE_CHECK_ROUNDS, "max_rel_loss_gap": rel,
            "rtol": DEVICE_RTOL, "loss_gpu": [g["loss"] for g in gpu],
            "loss_cpu": [c["loss"] for c in cpu], "card": card}


def profile_figure_rounds(settings, card: str) -> dict:
    """``--profile``: one warm round of FedMM and one of naive at the
    MovieLens-like setting, each under torch.profiler: seconds, kernels
    launched, the device's idle share."""
    from repro_torch import api
    from repro_torch.benchmarks import fig1_dictlearn as fig1
    from repro_torch.configs.dictlearn import MOVIELENS as exp
    from repro_torch.core import compression as C

    out = {"phase": "profile_figures", "setting": "movielens", "card": card}
    for name, (sur, x0, data, gamma, kw) in fig1.algorithm_args(
            exp, settings["movielens"],
            C.block_quant(exp.quant_bits, 128)).items():
        def one_round(state0):
            return api.run(sur, x0, data, gamma, key=SEED, n_rounds=1,
                           state0=state0, device="cuda", **kw)[0]
        warm = one_round(None)
        one_round(warm)
        out[name] = profiled(lambda: one_round(warm))
    return out


# ---------------------------------------------------------------------------
# Fig. 3: FedMM-OT against FedAdam at the paper's sizes
# ---------------------------------------------------------------------------

def fig3_phase(card: str, profile: bool) -> list:
    """Fig. 3 at ``--full`` on the GPU through ``fig3_ot.main``: one record
    per dim with both L2-UVP curves (every 10 rounds), each algorithm's
    first non-finite round and rounds/s (host clock around its
    trajectory). Gates at FIG3_GATE_DIM: every round's L2-UVP of both
    algorithms finite, each curve's last point below its first; then the
    GPU-vs-CPU check. Reported, not gated: which algorithm ends lower, and
    whether the larger dims diverge (the reference's FedMM-OT does, on a
    CPU). Returns the phase's records."""
    from repro_torch.benchmarks import fig3_ot as fig3
    from repro_torch.kernels import quantize_block as qb

    kernel_launches0 = sum(qb.LAUNCHES.values())
    t0 = time.perf_counter()
    rounds = {d: FIG3_ROUNDS if d == FIG3_GATE_DIM else FIG3_WIDE_ROUNDS
              for d in FIG3_DIMS}
    rows = [row for d in FIG3_DIMS
            for row in fig3.main(dims=(d,), rounds=rounds[d], device="cuda")]
    records = []
    for row in rows:
        mm, fa = row["fedmm_ot_curve"], row["fedadam_curve"]
        finite = (row["fedmm_ot_first_nonfinite"] is None
                  and row["fedadam_first_nonfinite"] is None)
        n_rounds = rounds[row["dim"]]
        records.append({
            "phase": "fig3", "dim": row["dim"], "rounds": n_rounds,
            "fedmm_ot_curve": mm, "fedadam_curve": fa,
            "fedmm_ot_first_nonfinite": row["fedmm_ot_first_nonfinite"],
            "fedadam_first_nonfinite": row["fedadam_first_nonfinite"],
            "fedmm_ot_ends_below_fedadam": mm[-1] < fa[-1] if finite
            else None,
            "seconds_fedmm_ot": row["seconds_fedmm_ot"],
            "seconds_fedadam": row["seconds_fedadam"],
            "rounds_per_s_fedmm_ot": n_rounds / row["seconds_fedmm_ot"],
            "rounds_per_s_fedadam": n_rounds / row["seconds_fedadam"],
            "card": card})
        emit(records[-1])
        if row["dim"] == FIG3_GATE_DIM:
            require(finite, f"fig3 d={row['dim']}: an L2-UVP is not finite: "
                    f"{records[-1]}")
            for name, curve in (("FedMM-OT", mm), ("FedAdam", fa)):
                require(curve[-1] < curve[0], f"fig3 d={row['dim']}: "
                        f"{name}'s L2-UVP did not fall: {curve}")
    records.append(fig3_device_consistency(card))
    emit(records[-1])
    if profile:
        records.append(profile_fig3_rounds(card))
        emit(records[-1])
    launched = sum(qb.LAUNCHES.values()) - kernel_launches0
    require(launched == 0, f"fig3 launched {launched} quantizer kernels; "
            f"it runs the identity compressor")
    records.append({"phase": "fig3_total", "seconds": time.perf_counter() - t0,
                    "kernel_launches": launched, "card": card})
    emit(records[-1])
    return records


def _fig3_start(device):
    """Fig. 3's data and both algorithms' starts at FIG3_GATE_DIM from
    SEED, drawn on the host: the same on every device."""
    from repro_torch.benchmarks import fig3_ot as fig3

    prob = fig3.make_problem(FIG3_GATE_DIM, SEED, device=device)
    spec, cfg = fig3.setup(FIG3_GATE_DIM)
    return (prob, spec, cfg) + fig3.initial_states(spec, cfg, SEED, device)


def fig3_device_consistency(card: str) -> dict:
    """DEVICE_CHECK_ROUNDS FedMM-OT rounds at FIG3_GATE_DIM on the GPU and
    on the CPU from the same host draws: every round's L2-UVP within
    DEVICE_RTOL."""
    from repro_torch.benchmarks import fig3_ot as fig3

    def uvp(device):
        prob, spec, cfg, st0, _ = _fig3_start(device)
        return fig3.run_fedmm_ot(prob, spec, cfg, st0, DEVICE_CHECK_ROUNDS,
                                 SEED, device)[0]

    gpu, cpu = uvp("cuda"), uvp("cpu")
    rel = max(abs(g - c) / abs(c) for g, c in zip(gpu, cpu))
    require(rel <= DEVICE_RTOL, f"fig3: GPU and CPU L2-UVP differ by "
            f"{rel:.3e} > {DEVICE_RTOL}: {gpu} vs {cpu}")
    return {"phase": "fig3_device_consistency", "dim": FIG3_GATE_DIM,
            "rounds": DEVICE_CHECK_ROUNDS, "max_rel_uvp_gap": rel,
            "rtol": DEVICE_RTOL, "uvp_gpu": gpu, "uvp_cpu": cpu,
            "card": card}


def profile_fig3_rounds(card: str) -> dict:
    """``--profile``: one warm FedMM-OT round (with its L2-UVP) and one
    warm FedAdam round (with its L2-UVP) at FIG3_GATE_DIM under
    torch.profiler: seconds, kernels launched, the device's idle share."""
    from repro_torch import api
    from repro_torch.benchmarks import fig3_ot as fig3

    prob, spec, cfg, st0, fa0 = _fig3_start("cuda")

    def fedmm_round(state0):
        problem, x0, data, schedule, kw = fig3.fedmm_ot_args(
            prob, spec, cfg, state0, SEED)
        return api.run(problem, x0, data, schedule, n_rounds=1,
                       device="cuda", **kw)[0]

    def fedadam_round(state):
        return fig3.fedadam_round(prob, spec, state, SEED, "cuda")[0]

    warm = fedmm_round(fedmm_round(st0))
    fa = fedadam_round(fedadam_round(fa0))
    return {"phase": "profile_fig3", "dim": FIG3_GATE_DIM, "card": card,
            "fedmm_ot": profiled(lambda: fedmm_round(warm)),
            "fedadam": profiled(lambda: fedadam_round(fa))}


# ---------------------------------------------------------------------------
# --profile: where the time goes
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# the train phase: the backward kernels, FedMM training at full width, the
# entry point, the card against the CPU
# ---------------------------------------------------------------------------

# backward kernel against plain version: max |got - want| <= tol max |want|
# per output; both accumulate in float32, the sums of a backward pass in
# another order over thousands of terms; bf16 outputs are rounded to bf16
BWD_TOL = {"float32": 1e-3, "bfloat16": 2e-2}
# the train runs: 1 warm-up round and TRAIN_ROUNDS timed, hash dither,
# 8 bits, block 256, rho 0.05, gamma 0.5 / sqrt(1 + t), p 1.0, seed 0
TRAIN_ROUNDS, TRAIN_SEQ, TRAIN_RHO, TRAIN_GAMMA = 3, 2048, 0.05, 0.5
TRAIN_RUNS = {
    # name: (arch, layers kept, clients, variates on, tokens a client)
    "train_gemma3": ("gemma3-12b", 6, 2, False, TRAIN_SEQ),
    "train_rwkv6": ("rwkv6-3b", 8, 4, True, TRAIN_SEQ),
    "train_qwen3": ("qwen3-moe-235b-a22b", 1, 2, False, TRAIN_SEQ),
    # the first layer, mamba_mlp: 2.10 B parameters with embedding and head
    "train_jamba": ("jamba-1.5-large-398b", 1, 2, False, TRAIN_SEQ),
    # full depth (6 encoder and 6 decoder layers, 109.9 M parameters),
    # whisper's text context of 448 tokens and its 1,500 frames a client
    "train_whisper": ("whisper-base", 6, 4, True, WHISPER_TEXT_CTX),
    # 4 of 48 layers: 2.70 B parameters with embedding and head; 256
    # patches before each client's tokens
    "train_internvl": ("internvl2-26b", 4, 2, False, TRAIN_SEQ),
}
# the entry point's runs (python -m repro_torch.launch.train)
ENTRY_STEPS = 20
ENTRY_ARCHS = ("phi3-medium-14b", "gemma3-12b", "rwkv6-3b",
               "qwen3-moe-235b-a22b", "jamba-1.5-large-398b", "whisper-base",
               "internvl2-26b")
CARD_VS_CPU_ROUNDS, CARD_VS_CPU_LOSS_RTOL = 3, 1e-4
REPLACES_BWD = {
    # the reference differentiates jnp code: what the backward kernels
    # take the place of on the training path is jax.grad of it
    "flash_attention_bwd": "src/repro/models/layers.py:266",
    "rwkv_scan_bwd": "src/repro/models/rwkv.py:53",
}


def _bwd_ratios(got, want):
    """Per output: max |got - want| / max |want|."""
    return [max_abs_err(g, w) / max(float(w.float().abs().max()), 1e-30)
            for g, w in zip(got, want)]


def _wkv6_backward_faulty(r, k, v, w, u, dy, fault: str, chunk: int):
    """``ref.rwkv_scan_backward_plain`` with one planted fault: "skip G" (the
    state's gradient not updated at the middle step), "dw from S_t+1"
    (dw_t taken against the state after step t) or "chunk carry dropped"
    (the state and its gradient reset to zero at the kernel's chunk
    boundary nearest the middle, ``chunk`` steps a chunk). dr, dk, dv, dw,
    du."""
    import torch
    f32 = torch.float32
    B, S, H, hd = r.shape
    rf, kf, vf, wf, dyf = (t.to(f32) for t in (r, k, v, w, dy))
    uf = u.to(f32)[None]
    cut = chunk * (-(-S // chunk) // 2) if fault == "chunk carry dropped" \
        else -1
    states = [torch.zeros((B, H, hd, hd), dtype=f32, device=r.device)]
    for t in range(S):
        if t == cut:
            states[-1] = torch.zeros_like(states[-1])
        states.append(wf[:, t, :, :, None] * states[-1]
                      + kf[:, t, :, :, None] * vf[:, t, :, None, :])
    G = torch.zeros_like(states[0])
    grads = [torch.zeros_like(rf) for _ in range(4)]
    du = torch.zeros((H, hd), dtype=f32, device=r.device)
    for t in reversed(range(S)):
        r_t, k_t, v_t, dy_t = rf[:, t], kf[:, t], vf[:, t], dyf[:, t]
        vdy = (v_t * dy_t).sum(-1, keepdim=True)
        s_t = states[t + 1] if fault == "dw from S_t+1" else states[t]
        grads[1][:, t] = torch.einsum("bhij,bhj->bhi", G, v_t) \
            + r_t * uf * vdy
        grads[2][:, t] = torch.einsum("bhij,bhi->bhj", G, k_t) \
            + (r_t * uf * k_t).sum(-1, keepdim=True) * dy_t
        grads[3][:, t] = (G * s_t).sum(-1)
        grads[0][:, t] = torch.einsum("bhij,bhj->bhi", states[t], dy_t) \
            + uf * k_t * vdy
        du += (r_t * k_t * vdy).sum(0)
        if not (fault == "skip G" and t == S // 2):
            G = wf[:, t, :, :, None] * G + r_t[..., None] * dy_t[..., None, :]
        if t == cut:
            G = torch.zeros_like(G)
    return (*(g.to(r.dtype) for g in grads), du)


def backward_kernel_checks(profile: bool = False):
    """The two backward kernels against their plain versions at the train
    path's shapes, float32 and bf16: flash at gemma3's (B 1, S 2048, H 16,
    KV 8, hd 256; causal, and the window of 1024), phi3's (H 40, KV 10,
    hd 128, causal), qwen3-moe's (H 64, KV 4: a GQA group of 16, hd
    128, causal), whisper-base's (H 8 = KV 8, hd 64: its decoder's
    self-attention over 448 tokens, causal; its cross attention, 448
    queries over 1,500 frames, and its encoder over the frames, both
    non-causal) and internvl2-26b's (S 2,304, H 48 over KV 8: a group of
    6, hd 128, causal), fed the forward's log-sum-exp and held against the
    plain backward that computes its own; WKV6 at rwkv6's (B 1, S 2048,
    H 40, hd 64). Two flash launches on the same inputs must give the
    same bits (no atomics). In bf16 the planted faults (flash: one 64-key
    tile's share of dK dropped, the window's edge moved by one, a 64-row
    query tile's lse taken from its neighbour, run through the kernels;
    WKV6: one step of G skipped, dw taken from S_{t+1}, one chunk's carry
    dropped) must fail the limit. Times, bounds and SDPA's backward
    beside; with ``profile``, the WKV6 backward's three phases' device
    times. Returns (phase record, kernel rows)."""
    import torch
    import torch.nn.functional as F
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv_scan as rs

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    bf16 = torch.bfloat16
    gemma, phi3, rwkv, qwen3 = (configs.get(a) for a in (
        "gemma3-12b", "phi3-medium-14b", "rwkv6-3b", "qwen3-moe-235b-a22b"))
    S = TRAIN_SEQ
    checks, timings = [], {}

    def judged(case, dtype, got, want, names):
        tol = BWD_TOL[str(dtype).split(".")[1]]
        ratios = _bwd_ratios(got, want)
        require(max(ratios) <= tol, f"{case} ({dtype}): backward kernel "
                f"differs from its plain version: {dict(zip(names, ratios))}"
                f" x max|want|, limit {tol}")
        return {"case": case, "dtype": str(dtype), "tol": tol,
                "max_abs_err": max(max_abs_err(g, w)
                                   for g, w in zip(got, want)),
                "err_over_max": dict(zip(names, ratios))}

    def caught(fault, dtype, got, want, names):
        tol = BWD_TOL[str(dtype).split(".")[1]]
        ratios = _bwd_ratios(got, want)
        require(max(ratios) > tol, f"the limit passes a planted backward "
                f"fault ({fault}): {ratios}")
        return {"fault": fault, "err_over_max": dict(zip(names, ratios)),
                "times_the_limit": max(ratios) / tol}

    names = ("dq", "dk", "dv")
    whisper, internvl = (configs.get(a) for a in ("whisper-base",
                                                  "internvl2-26b"))
    frames, text = whisper.n_frontend_tokens, WHISPER_TEXT_CTX
    S_vlm = internvl.n_frontend_tokens + S
    # (case, config, query and key positions, causal, window)
    for case, cfg, Sq, Sk, causal, window in (
            ("gemma3 global", gemma, S, S, True, 0),
            ("gemma3 local", gemma, S, S, True, gemma.window),
            ("phi3", phi3, S, S, True, 0), ("qwen3", qwen3, S, S, True, 0),
            ("whisper self", whisper, text, text, True, 0),
            ("whisper cross", whisper, text, frames, False, 0),
            ("whisper encoder", whisper, frames, frames, False, 0),
            ("internvl", internvl, S_vlm, S_vlm, True, 0)):
        H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        for dtype in (torch.float32, bf16):
            q = _randn((1, Sq, H, hd), gen, dtype)
            k = _randn((1, Sk, KV, hd), gen, dtype)
            v = _randn((1, Sk, KV, hd), gen, dtype)
            do = _randn((1, Sq, H, hd), gen, dtype)
            o, lse = fa.flash_attention(q, k, v, causal=causal,
                                        window=window, return_lse=True)
            got = fa.flash_attention_backward(q, k, v, o, lse, do, causal,
                                              window)
            want = ref.flash_attention_backward_plain(q, k, v, o, do, causal,
                                                      window)
            rec = judged(case, dtype, got, want, names)
            rec["shape"] = [1, Sq, Sk, H, KV, hd]
            rec["causal"], rec["window"] = causal, window
            again = fa.flash_attention_backward(q, k, v, o, lse, do, causal,
                                                window)
            rec["bits_repeat"] = all(bits_equal(a, b)
                                     for a, b in zip(got, again))
            require(rec["bits_repeat"], f"{case} ({dtype}): two backward "
                    f"launches on the same inputs differ")
            del again
            checks.append(rec)
            if dtype == torch.float32:
                del got, want
                continue
            if case.startswith("gemma3"):
                dk = want[1].clone()
                dk[:, S // 2:S // 2 + 64] = 0.0
                faults = [caught("one 64-key tile's share of dK dropped",
                                 dtype, (want[0], dk, want[2]), want,
                                 names)]
                if window:
                    faults.append(caught(
                        "the window's edge moved by one", dtype,
                        ref.flash_attention_backward_plain(
                            q, k, v, o, do, True, window + 1), want, names))
                # query rows 64-127 given the lse of rows 128-191
                bad = lse.clone()
                bad[:, :, 64:128] = lse[:, :, 128:192]
                faults.append(caught(
                    "a 64-row query tile's lse taken from its neighbour",
                    dtype, fa.flash_attention_backward(q, k, v, o, bad, do,
                                                       True, window),
                    want, names))
                del bad
                rec["planted_faults"] = faults
            del got, want
            # the time of the path's bf16 backward, its bound and SDPA's
            keep = ref.attention_keep(Sq, Sk, causal, window, "cuda")
            pairs = int(keep.sum())
            # the function's five products (S, dP, dV, dQ, dK): 10 hd flop
            # per kept pair and head; the bytes: q, k, v, o, do read, dq,
            # dk, dv written once
            nbytes = 2 * (4 * q.numel() + 4 * k.numel())
            t = {"ms": time_ms(lambda: fa.flash_attention_backward(
                q, k, v, o, lse, do, causal, window), 20),
                 "shape": rec["shape"], "causal": causal, "pairs": pairs}
            t["bound_ms"], t["bound_by"] = bound(
                nbytes, fa.backward_flops(q.shape[0], Sq, Sk, H, hd, causal,
                                          window), BF16_OPS_PER_S)
            t["pct_of_bound"] = 100 * t["bound_ms"] / t["ms"]
            t["plain_ms"] = time_ms(lambda: ref.flash_attention_backward_plain(
                q, k, v, o, do, causal, window), 2, 1)
            qh, kh, vh = (x.transpose(1, 2).contiguous().requires_grad_()
                          for x in (q, k.repeat_interleave(H // KV, dim=2),
                                    v.repeat_interleave(H // KV, dim=2)))
            mask = None if not window else keep
            lib = F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask,
                is_causal=causal and mask is None)
            doh = do.transpose(1, 2).contiguous()
            t["library_ms"] = time_ms(lambda: torch.autograd.grad(
                lib, (qh, kh, vh), doh, retain_graph=True), 5)
            t["library"] = ("scaled_dot_product_attention backward, K/V "
                            "expanded, " + (
                                "boolean mask" if mask is not None else
                                "is_causal" if causal else "no mask"))
            timings[case] = t
            del q, k, v, o, lse, do, qh, kh, vh, lib, doh, keep
            _free()

    # WKV6 at rwkv6's shape: decays as the model makes them
    hd = rwkv.rwkv_head_dim
    H = rwkv.d_model // hd
    names_w = ("dr", "dk", "dv", "dw", "du")
    for dtype in (torch.float32, bf16):
        r, kk, vv, dy = (_randn((1, S, H, hd), gen, dtype) for _ in range(4))
        w = torch.exp(-torch.exp(_randn((1, S, H, hd), gen, torch.float32)
                                 - 2.0)).to(dtype)
        u = _randn((H, hd), gen, torch.float32) * 0.1
        got = rs.rwkv_scan_backward(r, kk, vv, w, u, dy)
        want = ref.rwkv_scan_backward_plain(r, kk, vv, w, u, dy)
        rec = judged("rwkv6", dtype, got, want, names_w)
        rec["shape"] = [1, S, H, hd]
        checks.append(rec)
        if dtype == bf16:
            chunk = rs._bwd_lib().wkv6_backward_chunk(hd)
            rec["planted_faults"] = [
                caught(fault, dtype, _wkv6_backward_faulty(
                    r, kk, vv, w, u, dy, fault, chunk), want, names_w)
                for fault in ("skip G", "dw from S_t+1",
                              "chunk carry dropped")]
            n = r.numel()
            t = {"ms": time_ms(lambda: rs.rwkv_scan_backward(
                r, kk, vv, w, u, dy), 5)}
            # per state element and step: the state rebuilt (2 flop), dk,
            # dv, dw, dr (2 each) and G (2): 12 flop, float32; the bytes:
            # r, k, v, w, dy read, four gradients written (bf16), u, du
            t["bound_ms"], t["bound_by"] = bound(
                2 * 9 * n + 8 * u.numel(), rs.backward_flops(*r.shape),
                F32_OPS_PER_S)
            t["plain_ms"] = time_ms(lambda: ref.rwkv_scan_backward_plain(
                r, kk, vv, w, u, dy), 1, 0)
            t["library_ms"] = None
            t["chunk_steps"] = chunk
            if profile:
                # each phase's time and grid from the profiler's trace;
                # phases 1 and 3 launch a block per (batch, head, chunk)
                t["phases"] = kernel_trace(lambda: rs.rwkv_scan_backward(
                    r, kk, vv, w, u, dy), r"wkv6_bwd_[a-z]+", 5)
                for name in ("wkv6_bwd_summary", "wkv6_bwd_chunk"):
                    grid = t["phases"].get(name, {}).get("grid") or [[]]
                    require(not isinstance(grid[0], list)
                            and grid[0] * grid[1] * grid[2]
                            == H * -(-S // chunk),
                            f"{name} launched the grid {grid}, not a block "
                            f"per (batch, head, chunk): {t['phases']}")
            timings["rwkv6"] = t
        del r, kk, vv, dy, w, u, got, want
        _free()

    flash = {"name": "flash_attention_bwd", "route": "cuda",
             "source": LM_SOURCES["flash_attention_bwd"],
             "replaces": REPLACES_BWD["flash_attention_bwd"],
             "max_abs_err": max(c["max_abs_err"] for c in checks
                                if c["case"] == "gemma3 global"
                                and c["dtype"] == str(bf16)),
             **{k: timings["gemma3 global"][k] for k in (
                 "ms", "bound_ms", "bound_by", "plain_ms", "library_ms")},
             "at": "gemma3 global, bf16, B 1, S 2048, H 16, KV 8, hd 256",
             "other_shapes": {k: v for k, v in timings.items()
                              if k not in ("gemma3 global", "rwkv6")}}
    scan = {"name": "rwkv_scan_bwd", "route": "cuda",
            "source": LM_SOURCES["rwkv_scan_bwd"],
            "replaces": REPLACES_BWD["rwkv_scan_bwd"],
            "max_abs_err": max(c["max_abs_err"] for c in checks
                               if c["case"] == "rwkv6"
                               and c["dtype"] == str(bf16)),
            **{k: timings["rwkv6"][k] for k in (
                "ms", "bound_ms", "bound_by", "plain_ms", "library_ms")},
            "at": "bf16, B 1, S 2048, H 40, hd 64"}
    return ({"phase": "backward_kernels_vs_plain", "checks": checks,
             "times_ms": timings},
            {"flash_attention_bwd": flash, "rwkv_scan_bwd": scan})


def _launch_counters():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import quantize_block as qb
    from repro_torch.kernels import rwkv_scan as rs
    from repro_torch.models import mamba
    return {"flash_attention": fa.LAUNCHES, "rwkv_scan": rs.LAUNCHES,
            "quantize": qb.LAUNCHES,
            "quantize_by_group": qb.LAUNCHES_BY_GROUP,
            "ssm_scan": mamba.LAUNCHES}


def _zero_counts() -> None:
    for counter in _launch_counters().values():
        for key in counter:
            counter[key] = 0


def _read_counts() -> dict:
    return {k: v for counter in _launch_counters().values()
            for k, v in counter.items() if v}


def _route_leaves(name: str, leaves) -> tuple:
    """(groups of the leaves of at least KERNEL_DISPATCH_MIN elements,
    the kernel-route leaves among them, those with groups below 128).
    Every such leaf is encoded by the kernel, whatever its shard-safe group
    (the largest power of two dividing D / 32, at most BLOCK: 1 to 256
    here); a group of 1 travels raw, as in the reference (jamba's w_bc and
    A_log)."""
    from repro_torch.core import compression as C
    from repro_torch.kernels import quantize_block as qb
    large = [x for x in leaves if x.numel() >= C.KERNEL_DISPATCH_MIN]
    groups = [C.group_size(x.shape[-1], BLOCK) for x in large]
    require(all(qb.kernel_group_ok(g) for g in groups),
            f"{name}: a large leaf's group {groups} is not the kernel's")
    return (groups, sum(1 for g in groups if g >= 2),
            sum(1 for g in groups if 2 <= g < 128))


def train_run(name: str, profile: bool, keep: dict = None) -> dict:
    """FedMM training of one arch at full width through
    ``fed.trainer.make_train_step``: 1 warm-up round, then TRAIN_ROUNDS
    timed (the counters zeroed just before them), each client a batch of
    1 x the run's tokens (+1 for the labels; audio's frames or vlm's
    patches beside them, from ``sample_batch``). Gates: finite losses, peak
    under 80 GB, per client and round two forward and one backward launch
    of the layer's kernel per layer that runs it (the step and its
    rematerialisation; a Mamba layer runs the plain scan twice), one
    encode per kernel-route leaf, uplink bytes equal to
    ``payload_bytes``. ``keep``, when given, receives the model, the
    initial iterate (on the host, copied before the timed rounds) and the
    batches, for ``train_mesh``."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.core import compression as C
    from repro_torch.fed import trainer as FT
    from repro_torch.launch.train import sample_batch
    from repro_torch.models import transformer as T
    from repro_torch.models.model import build_model
    from repro_torch.tree import tree_leaves, tree_map

    arch, layers, n, variates, seq = TRAIN_RUNS[name]
    cfg = dataclasses.replace(configs.get(arch), n_layers=layers)
    model = build_model(cfg, device="cuda")
    fcfg = FT.FedLMConfig(n_clients=n, rho=TRAIN_RHO, p=1.0, alpha=0.1,
                          quant_bits=BITS, quant_block=BLOCK,
                          quant_dither="hash", client_mode="logical",
                          use_cv=variates)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = FT.init_state(
        model, torch.Generator(device="cuda").manual_seed(SEED), fcfg)
    torch.cuda.synchronize()
    leaves = tree_leaves(state.s_hat)
    out = {"phase": name, "arch": arch, "layers": layers,
           "pattern": T.layer_pattern(cfg), "clients": n,
           "variates": fcfg.federation_spec().variates,
           "tokens_per_client": seq,
           "encoder_layers": cfg.n_encoder_layers,
           "frontend_tokens": cfg.n_frontend_tokens,
           "init_seconds": time.perf_counter() - t0,
           "parameters": sum(x.numel() for x in leaves),
           "parameter_bytes": sum(x.numel() * x.element_size()
                                  for x in leaves)}
    comp = fcfg.federation_spec().compressor
    payload = comp.payload_bytes(state.s_hat)
    groups, kernel_leaves, small_leaves = _route_leaves(name, leaves)
    # the counts stay, the first iterate's tensors go with the state: a
    # list of them kept here would hold a copy of the parameters through
    # the timed rounds
    del leaves
    step = FT.make_train_step(model, fcfg)
    data_gen = torch.Generator().manual_seed(SEED)
    round_gen = torch.Generator().manual_seed(SEED + 1)
    batches = [sample_batch(data_gen, cfg, n, 1, seq, model.device)
               for _ in range(TRAIN_ROUNDS + 1)]
    if keep is not None:
        keep.update(model=model, batches=batches,
                    s_hat=tree_map(lambda x: x.to("cpu"), state.s_hat))

    def one_round(t):
        gamma = TRAIN_GAMMA / (1.0 + t) ** 0.5
        return step(state, batches[t], round_gen, gamma)

    state, m = one_round(0)                      # warm-up
    torch.cuda.synchronize()
    if profile:
        # one warm round, its new state dropped
        emit({"phase": f"profile_{name}",
              **profiled(lambda: one_round(1), watch="small_quant_kernel")})
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    losses, seconds, billed = [], [], []
    for t in range(1, TRAIN_ROUNDS + 1):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, m = one_round(t)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t1)
        billed.append((m["comm_bytes"], m["n_active"]))
    counts = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    # one client's payload, measured off its encoded buffers; the driver
    # bills bytes x active clients in float32, as the reference does
    probe = comp.encode(torch.Generator().manual_seed(1),
                        tree_map(torch.zeros_like, state.s_hat))
    per_client = C._tree_bytes(probe)
    del probe
    comm_ok = per_client == payload and all(
        torch.equal(c.cpu(), torch.tensor(float(per_client)) * a.cpu())
        for c, a in billed)
    comm = [float(c) for c, _ in billed]
    per = {k: v / (n * TRAIN_ROUNDS) for k, v in counts.items()}
    fwd, bwd = (("rwkv_scan", "rwkv_scan_bwd") if cfg.family == "ssm"
                else ("flash_attention", "flash_attention_bwd"))
    n_kernel = T.prefill_kernel_launches(cfg)
    want_scan = 2 * scan_calls_per_prefill(cfg, seq)
    out.update(loss=losses, seconds_per_round=seconds,
               mean_seconds_per_round=sum(seconds) / len(seconds),
               tokens_per_s=n * seq * len(seconds) / sum(seconds),
               peak_bytes=peak, uplink_bytes_per_client=per_client,
               comm_bytes_billed=comm, payload_bytes=payload,
               kernel_route_leaves=kernel_leaves,
               kernel_route_groups=sorted(set(groups)),
               large_leaves_by_group={str(g): groups.count(g)
                                      for g in sorted(set(groups))},
               launches=counts, launches_per_client_round=per)
    require(all(v == v and abs(v) < float("inf") for v in losses),
            f"{name}: a loss is not finite: {losses}")
    require(peak < 80e9, f"{name}: peak {peak} bytes")
    require(per.get(fwd, 0) == 2 * n_kernel and per.get(bwd, 0) == n_kernel,
            f"{name}: {fwd} / {bwd} launches per client and round {per}, "
            f"want {2 * n_kernel} / {n_kernel}")
    require(per.get("ssm_scan", 0) == want_scan,
            f"{name}: scan calls per client and round {per}, want "
            f"{want_scan}")
    require(per.get("encode_seeded_small", 0) == small_leaves
            and per.get("encode_seeded", 0) == kernel_leaves - small_leaves
            and per.get("encode", 0) == per.get("encode_small", 0) == 0,
            f"{name}: encode launches per client and round {per}, want "
            f"{kernel_leaves} with the in-kernel dither, {small_leaves} of "
            f"them with groups below 128")
    require(comm_ok, f"{name}: uplink bytes: one client's payload "
            f"{per_client} B, payload_bytes {payload}, billed {comm}")
    del state, batches
    _free()
    return out


# train_mesh: train_gemma3's model, initial iterate and batches, stepped
# as physical silos off the mesh and on a one-rank NCCL mesh with each
# uplink, round by round from one state with the same draws
TRAIN_MESH_RUN, TRAIN_MESH_ROUNDS = "train_gemma3", 2
# a mesh round against the off-mesh round from the same state: the
# reference pins its vmap client stage to its scan (tests/test_fed_trainer.py,
# float32) at rtol 1e-5 / atol 1e-6, the rounding of one reduction in
# another order. In bf16 that rounding is of the aggregate h, at most one
# bf16 ulp of it (2^-7 |h| at worst), and the step x + gamma h can then
# round to the neighbouring bf16 value: |got - want| <= 2^-7 (|want| +
# |want - x|), gamma |h| being |want - x|
MESH_BF16_ULP = 2.0 ** -7


def _within_bf16_step(got, want, prev, chunk: int = 1 << 26):
    """(every element within MESH_BF16_ULP (|want| + |want - prev|),
    largest |got - want|, elements that differ) over three trees, a
    flat chunk of each leaf at a time."""
    from repro_torch.tree import tree_leaves
    ok, gap, differ = True, 0.0, 0
    for a, b, x in zip(tree_leaves(got), tree_leaves(want),
                       tree_leaves(prev)):
        a, b, x = a.reshape(-1), b.reshape(-1), x.reshape(-1)
        for i in range(0, a.numel(), chunk):
            ac, bc, xc = (t[i:i + chunk].float() for t in (a, b, x))
            d = (ac - bc).abs()
            tol = MESH_BF16_ULP * (bc.abs() + (bc - xc).abs())
            ok = ok and bool((d <= tol).all())
            gap = max(gap, float(d.max()))
            differ += int((d > 0).sum())
    return ok, gap, differ


def train_mesh(ctx: dict) -> dict:
    """gemma3-12b (6 of 48 layers, full width, bf16) as 2 physical silos,
    variates off, ``block_quant(8, 256, "hash")``, 1 x 2,048 tokens a
    client: ``train_gemma3``'s model, initial iterate and batches. Each of
    TRAIN_MESH_ROUNDS rounds runs three times from the same state with
    the same draws (``active=``, ``seeds=``): off the mesh (the driver's
    scan), then on a one-rank NCCL ``DeviceMesh`` ``("clients",)`` with
    ``uplink="gather"`` and with ``"reduce"`` (the rank's silos in
    sequence, their payloads stacked, then the driver's mesh tail); the
    next round starts from the off-mesh result. The process group starts
    here and is destroyed at the end. Gates: each mesh iterate within
    MESH_BF16_ULP of the off-mesh round's (``_within_bf16_step``); finite
    losses; each run's peak under 80 GB (the off-mesh result is kept on
    the card beside a mesh run: its bytes are in that peak); uplink bytes
    a client equal to ``payload_bytes``; ``collective_payload_bytes`` the
    gathered stack's (2 payloads) and the float32 partial's (4 bytes a
    parameter); a client and round, the flash and encode launches of
    ``train_gemma3``; a reduce round one ``qb_decode_reduce`` per leaf
    whose group is a multiple of 128 (each layer's ``wq``), a gather or
    off-mesh round none."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch import api
    from repro_torch.fed import trainer as FT
    from repro_torch.kernels import quantize_block as qb
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves, tree_map

    arch, layers, n, _, seq = TRAIN_RUNS[TRAIN_MESH_RUN]
    model, batches = ctx["model"], ctx["batches"]
    cfg = model.cfg
    fcfg = FT.FedLMConfig(n_clients=n, rho=TRAIN_RHO, p=1.0, alpha=0.1,
                          quant_bits=BITS, quant_block=BLOCK,
                          quant_dither="hash", client_mode="physical",
                          use_cv=False)
    spec = fcfg.federation_spec()
    comp = spec.compressor
    state = FT.FedLMState(
        s_hat=tree_map(lambda x: x.to("cuda"), ctx.pop("s_hat")), v=(),
        v_i=(), step=torch.zeros((), dtype=torch.int64))
    leaves = tree_leaves(state.s_hat)
    n_leaves, params = len(leaves), sum(x.numel() for x in leaves)
    payload = comp.payload_bytes(state.s_hat)
    groups, kernel_leaves, small_leaves = _route_leaves("train_mesh",
                                                        leaves)
    reduce_leaves = sum(1 for g in groups if qb.reduce_group_ok(g))
    del leaves                  # the first iterate goes with its state
    n_kernel = T.prefill_kernel_launches(cfg)
    out = {"phase": "train_mesh", "arch": arch, "layers": layers,
           "clients": n, "variates": spec.variates,
           "tokens_per_client": seq, "rounds": TRAIN_MESH_ROUNDS,
           "world_size": 1, "backend": "nccl", "parameters": params,
           "payload_bytes": payload, "decode_reduce_leaves": reduce_leaves,
           "tolerance": "|mesh - off| <= 2^-7 (|off| + |off - x|)"}
    torch.cuda.set_device(0)
    t0 = time.perf_counter()
    dist.init_process_group("nccl",
                            init_method=f"tcp://localhost:{_free_port()}",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("clients",))
        require(dist.get_backend(mesh.get_group("clients")) == "nccl",
                "the client dim's group is not NCCL")
        out["nccl_init_seconds"] = time.perf_counter() - t0
        steps = {"off": FT.make_train_step(model, fcfg)}
        for uplink in ("gather", "reduce"):
            steps[uplink] = FT.make_train_step(model, fcfg, mesh=mesh,
                                               uplink=uplink)
        runs = {k: {"seconds": [], "peak_bytes": [], "loss": [],
                    "launches_per_client_round": [], "comm_bytes": []}
                for k in steps}
        for k in ("gather", "reduce"):
            runs[k].update(collective_payload_bytes=[], within=[],
                           max_abs_gap=[], elements_differ=[])
        launches = {}
        draws = torch.Generator().manual_seed(SEED + 2)
        for t in range(TRAIN_MESH_ROUNDS):
            active, seeds = api.participation_draw(draws, spec, n_leaves)
            gamma = TRAIN_GAMMA / (1.0 + t) ** 0.5
            ref = None
            for k, step in steps.items():
                _free()
                torch.cuda.reset_peak_memory_stats()
                _zero_counts()
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                new, m = step(state, batches[t], None, gamma, active=active,
                              seeds=seeds)
                torch.cuda.synchronize()
                r = runs[k]
                r["seconds"].append(time.perf_counter() - t1)
                r["peak_bytes"].append(torch.cuda.max_memory_allocated())
                counts = _read_counts()
                per = {c: v / n for c, v in counts.items()
                       if c != "decode_reduce"}
                per["decode_reduce_per_round"] = counts.get("decode_reduce", 0)
                r["launches_per_client_round"].append(per)
                if k != "off":
                    for c, v in counts.items():
                        c = "decode_reduce_wq" if c == "decode_reduce" else c
                        launches[c] = launches.get(c, 0) + v
                loss = float(m["loss"])
                r["loss"].append(loss)
                r["comm_bytes"].append(float(m["comm_bytes"]))
                require(loss == loss and abs(loss) < float("inf"),
                        f"train_mesh {k}: loss {loss}")
                require(r["peak_bytes"][-1] < 80e9,
                        f"train_mesh {k}: peak {r['peak_bytes'][-1]}")
                require(torch.equal(m["comm_bytes"].cpu(),
                                    torch.tensor(float(payload))
                                    * m["n_active"].cpu()),
                        f"train_mesh {k}: uplink bytes {m['comm_bytes']}, "
                        f"payload_bytes {payload}")
                require(per.get("flash_attention", 0) == 2 * n_kernel
                        and per.get("flash_attention_bwd", 0) == n_kernel,
                        f"train_mesh {k}: flash launches per client and "
                        f"round {per}, want {2 * n_kernel} / {n_kernel}")
                require(per.get("encode_seeded_small", 0) == small_leaves
                        and per.get("encode_seeded", 0)
                        == kernel_leaves - small_leaves
                        and per.get("encode", 0) == 0,
                        f"train_mesh {k}: encode launches per client and "
                        f"round {per}, want {kernel_leaves}, {small_leaves} "
                        f"of them with groups below 128")
                want = reduce_leaves if k == "reduce" else 0
                require(per["decode_reduce_per_round"] == want,
                        f"train_mesh {k}: {per['decode_reduce_per_round']} "
                        f"decode + reduce launches, want {want}")
                if k == "off":
                    ref = new
                    continue
                stack = (float(n * payload) if k == "gather"
                         else float(4 * params))
                got_bytes = m["collective_payload_bytes"].cpu()
                r["collective_payload_bytes"].append(float(got_bytes))
                require(torch.equal(got_bytes, torch.tensor(
                    stack, dtype=torch.float32)),
                        f"train_mesh {k}: collective bytes {got_bytes}, "
                        f"want {stack}")
                ok, gap, differ = _within_bf16_step(new.s_hat, ref.s_hat,
                                                    state.s_hat)
                r["within"].append(ok)
                r["max_abs_gap"].append(gap)
                r["elements_differ"].append(differ)
                require(ok, f"train_mesh {k} round {t}: the iterate parts "
                        f"from off the mesh by {gap} ({differ} elements)")
                del new
            state = ref
            del ref
        out.update(runs=runs, launches=launches,
                   kept_bytes=sum(x.numel() * x.element_size()
                                  for x in tree_leaves(state.s_hat)))
    finally:
        dist.destroy_process_group()
    del state
    ctx.clear()
    _free()
    return out


def heldout_losses(arch: str, preset: str, state) -> list:
    """The loss of T(Shat) on one held-out batch (four times the entry
    point's default batch of 8 rows of 128 tokens, its streams seeded
    apart from the training batches) at the entry point's initial state
    (made again from its seed 0) and at ``state``, without a gradient."""
    import torch
    from repro_torch import configs
    from repro_torch.fed import trainer as FT
    from repro_torch.launch.train import preset_config, sample_batch
    from repro_torch.models.model import build_model
    cfg = preset_config(configs.get(arch), preset)
    model = build_model(cfg, device="cuda")
    fcfg = FT.FedLMConfig(n_clients=4, rho=TRAIN_RHO,  # the CLI's
                          client_mode="logical")
    first = FT.init_state(model, torch.Generator(device="cuda").manual_seed(
        0), fcfg)
    batch = sample_batch(torch.Generator().manual_seed(2), cfg, 4, 8, 128,
                         model.device)
    flat = {k: v.reshape((-1,) + tuple(v.shape[2:])) for k, v in batch.items()}
    with torch.no_grad():
        return [float(model.loss_fn(FT.T_map(s.s_hat, fcfg), flat))
                for s in (first, state)]


def entry_point_runs() -> dict:
    """``python -m repro_torch.launch.train --arch A --preset P --steps
    ENTRY_STEPS`` (through ``main``) on the card for ENTRY_ARCHS at
    the ``100m`` (float32, hd 64) and ``smoke`` presets. Gates: every loss
    finite, and the held-out batch's loss at the returned state below its
    loss at the initial one (on an H100 it fell by 1.3e-3 to 1.1e-2 for
    every arch and preset). Each step's loss is on a fresh batch, whose
    noise exceeds 20 steps' progress at the smoke preset, in the
    reference's trainer as in the port's on the same tokens
    (``tests/torch_train_witness.py``): the first and last are reported,
    and whether the last is below."""
    from repro_torch.launch import train as launch_train
    runs = []
    for preset in ("100m", "smoke"):
        for arch in ENTRY_ARCHS:
            t0 = time.perf_counter()
            out = launch_train.main(["--arch", arch, "--preset", preset,
                                     "--steps", str(ENTRY_STEPS),
                                     "--log-every", str(ENTRY_STEPS)])
            seconds = time.perf_counter() - t0
            losses = [m["loss"] for m in out["history"]]
            before, after = heldout_losses(arch, preset, out["state"])
            require(all(v == v and abs(v) < float("inf")
                        for v in losses + [before, after]),
                    f"launch.train {arch} {preset}: loss not finite")
            require(after < before, f"launch.train {arch} {preset}: the "
                    f"held-out loss did not fall: {before} -> {after}")
            runs.append({"arch": arch, "preset": preset,
                         "first_loss": losses[0], "last_loss": losses[-1],
                         "last_below_first": losses[-1] < losses[0],
                         "heldout_loss": [before, after],
                         "seconds": seconds})
            del out
            _free()
    return {"phase": "train_entry_point", "steps": ENTRY_STEPS, "runs": runs}


def train_card_vs_cpu() -> dict:
    """CARD_VS_CPU_ROUNDS rounds of each arch's smoke preset with the
    identity compressor on the card and on the CPU, from the same weights
    (drawn on the CPU) and batches: the losses within CARD_VS_CPU_LOSS_RTOL,
    every leaf of the final iterate within rtol 1e-5 / atol 1e-6 (the CPU
    parity tests' tolerance, ``tests/_torch_parity.py``)."""
    import torch
    from repro_torch import configs
    from repro_torch.fed import trainer as FT
    from repro_torch.launch.train import sample_batch
    from repro_torch.models.model import build_model
    from repro_torch.tree import tree_leaves, tree_map

    records = []
    for arch in ENTRY_ARCHS:
        cfg = configs.get(arch).reduced()
        fcfg = FT.FedLMConfig(n_clients=4, rho=TRAIN_RHO, quant_bits=0,
                              client_mode="logical")
        cpu_model = build_model(cfg, device="cpu")
        state0 = FT.init_state(cpu_model, torch.Generator().manual_seed(SEED),
                               fcfg)
        batches = [sample_batch(torch.Generator().manual_seed(SEED + t), cfg,
                                4, 2, 64, "cpu")
                   for t in range(CARD_VS_CPU_ROUNDS)]
        runs = {}
        for device in ("cuda", "cpu"):
            model = build_model(cfg, device=device)
            step = FT.make_train_step(model, fcfg)
            state = FT.FedLMState(*(tree_map(lambda x: x.to(device), f)
                                    for f in state0))
            losses = []
            for t, batch in enumerate(batches):
                state, m = step(state, batch, torch.Generator().manual_seed(
                    SEED + t), TRAIN_GAMMA / (1.0 + t) ** 0.5)
                losses.append(float(m["loss"]))
            runs[device] = (losses, state)
        (lc, sc), (lp, sp) = runs["cuda"], runs["cpu"]
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(lc, lp))
        worst = max(float(((a.cpu() - b).abs() / (1e-6 + 1e-5 * b.abs()))
                          .max())
                    for a, b in zip(tree_leaves(sc.s_hat),
                                    tree_leaves(sp.s_hat)))
        require(loss_gap <= CARD_VS_CPU_LOSS_RTOL,
                f"{arch}: card and CPU losses part by {loss_gap}")
        require(worst <= 1.0, f"{arch}: the card's iterate differs from the "
                f"CPU's by {worst} x the tolerance")
        records.append({"arch": arch, "losses_card": lc, "losses_cpu": lp,
                        "max_loss_rel_gap": loss_gap,
                        "iterate_worst_ratio": worst})
    return {"phase": "train_card_vs_cpu", "rounds": CARD_VS_CPU_ROUNDS,
            "records": records}


def train_phase(card: str, profile: bool) -> tuple:
    """The train phase: the backward kernels against their plain versions,
    the full-width train runs (``train_mesh`` after ``train_gemma3``),
    the entry point and the card against the CPU. Emits each part's
    record; returns the backward kernels' rows, each kernel's launches
    over the train runs and over ``train_mesh``'s mesh rounds, and each
    train run's mean seconds a timed round."""
    rec, rows = backward_kernel_checks(profile)
    emit(dict(rec, card=card))
    _free()
    launches, seconds = {}, {}
    for name in TRAIN_RUNS:
        keep = {} if name == TRAIN_MESH_RUN else None
        out = train_run(name, profile, keep)
        emit(dict(out, card=card))
        seconds[name] = out["mean_seconds_per_round"]
        for k, v in out["launches"].items():
            launches[k] = launches.get(k, 0) + v
        if keep is not None:
            mesh_out = train_mesh(keep)
            emit(dict(mesh_out, card=card))
    emit(dict(entry_point_runs(), card=card))
    emit(dict(train_card_vs_cpu(), card=card))
    return rows, launches, mesh_out["launches"], seconds


# ---------------------------------------------------------------------------
# the roofline of the timed phases, and one dry-run combination
# ---------------------------------------------------------------------------

# a share of the roofline above this would mean a counting error: no card
# does its work faster than its peaks allow
ROOFLINE_SHARE_MAX = 1.05
# the dry run's quick combination (the reference's own), in a child
# process started beside the kernels' build (it needs no card, and a fake
# process group never starts beside NCCL)
DRYRUN_ARCH, DRYRUN_SHAPE = "whisper-base", "decode_32k"
# the time limit of the join of each child on the host (the dry run's, the
# roofline counts')
CHILD_TIMEOUT_S = 120
# the argument that makes this script the child of start_roofline, and
# the processes it counts in
ROOFLINE_CHILD, ROOFLINE_WORKERS = "--roofline-child", 7


def start_dryrun():
    """``python -m repro_torch.launch.dryrun`` of DRYRUN_ARCH x
    DRYRUN_SHAPE in a child process (CPU and ``meta`` tensors under a
    fake process group), its record and output written under ``build/``:
    (child, record path, output paths)."""
    root = Path(__file__).resolve().parent
    out = root / "build" / "dryrun_smoke.json"
    out.parent.mkdir(exist_ok=True)
    logs = (out.with_suffix(".out"), out.with_suffix(".err"))
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           DRYRUN_ARCH, "--shape", DRYRUN_SHAPE, "--out", str(out)]
    with open(logs[0], "w") as so, open(logs[1], "w") as se:
        child = subprocess.Popen(cmd, env=env, stdout=so, stderr=se)
    # a run that fails before the join leaves no child behind
    atexit.register(lambda: child.poll() is None and child.kill())
    return child, out, logs


def join_dryrun(started) -> dict:
    """The child of ``start_dryrun``: its summary and record, which must
    be ``ok``, its combination's seconds and how long the join waited."""
    child, path, logs = started
    t0 = time.perf_counter()
    try:
        child.wait(timeout=CHILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        child.kill()
        child.wait()
        raise AssertionError(f"the dry run took over {CHILD_TIMEOUT_S} s")
    stdout, stderr = (p.read_text() for p in logs)
    require(child.returncode == 0, f"the dry run failed (exit "
            f"{child.returncode}): {stdout[-1000:]} {stderr[-2000:]}")
    record = json.loads(path.read_text())[0]
    for p in (path,) + logs:
        p.unlink()
    require(record["status"] == "ok", f"the dry run's record: {record}")
    return {"phase": "dryrun", "arch": DRYRUN_ARCH, "shape": DRYRUN_SHAPE,
            "summary": stdout.strip().splitlines()[-1],
            "status": record["status"],
            "combination_seconds": record["seconds"],
            "wait_seconds": time.perf_counter() - t0,
            "flops_per_device": record["flops_per_device"],
            "collectives": record["collectives"],
            "memory": record["memory"], "roofline": record["roofline"]}


def _counted_row(cfg, shape, n_params: int, flops: float,
                 **bytes_kw) -> dict:
    """One phase's roofline at one chip: its counted flops and the
    reference's estimate, the compute and memory terms at the card's
    peaks."""
    from repro_torch.launch import roofline as RL
    compute_s = flops / RL.PEAK_FLOPS_BF16
    memory_s = RL.analytic_bytes(cfg, shape, n_params, dp=1, tp=1,
                                 n_chips=1, **bytes_kw) / RL.HBM_BW
    return {"flops": flops,
            "model_flops": RL.model_flops_estimate(cfg, shape, n_params),
            "compute_s": compute_s, "memory_s": memory_s,
            "dominant": "compute" if compute_s >= memory_s else "memory"}


def _phase_of(name: str):
    """(cfg, InputShape, analytic_bytes keywords, clients) of a timed serve
    prefill or train round."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.configs.base import InputShape
    if name in SERVE_RUNS:
        run = SERVE_RUNS[name]
        cfg = dataclasses.replace(configs.get(run["arch"]),
                                  **(run.get("overrides") or {}))
        shape = InputShape(name, run.get("prompt_len", PROMPT_LEN),
                           run.get("batch_size", SERVE_BATCH), "prefill")
        return cfg, shape, {}, 0
    arch, layers, n, _, seq = TRAIN_RUNS[name]
    cfg = dataclasses.replace(configs.get(arch), n_layers=layers)
    return (cfg, InputShape(name, seq, n, "train"),
            {"n_clients": n, "client_mode": "logical"}, n)


def roofline_tasks(names) -> list:
    """The counts that give the serve prefills and train rounds ``names``
    (of SERVE_RUNS and TRAIN_RUNS), each at its own depth, batch and
    length: (name, weight, cfg, layer kinds, clients) for each point of
    the dry run's ``depth_line`` and, for a round, its ``client_line``
    (clients 0: a prefill); a phase's counts are the weighted sum of its
    points'."""
    from repro_torch.launch import dryrun as D
    tasks = []
    for name in names:
        cfg, _, _, n = _phase_of(name)
        clients = D.client_line(n) if n else [(1.0, 0)]
        for wd, cfg_d, pattern in D.depth_line(cfg):
            tasks += [(name, wd * wc, cfg_d, pattern, m) for wc, m in clients]
    return tasks


def roofline_count(task) -> dict:
    """One point of ``roofline_tasks`` counted on ``meta`` tensors at one
    chip (the dry run's ``count_serve`` or ``count_train_step``: the
    kernels' formulas, the flops of every other operation; no memory
    tracked): {"flops", "n_params"}."""
    import dataclasses
    from repro_torch.fed import trainer as FT
    from repro_torch.launch import dryrun as D
    from repro_torch.tree import tree_leaves
    name, _, cfg, pattern, n = task
    _, shape, _, _ = _phase_of(name)
    params = D.meta_params(cfg, pattern)
    if n:
        fcfg = FT.FedLMConfig(
            n_clients=n, rho=TRAIN_RHO, p=1.0, alpha=0.1, quant_bits=BITS,
            quant_block=BLOCK, quant_dither="hash", client_mode="logical",
            use_cv=TRAIN_RUNS[name][3])
        counts, _ = D.count_train_step(
            cfg, fcfg, dataclasses.replace(shape, global_batch=n),
            params=params, pattern=pattern, peak=False)
    else:
        counts, _ = D.count_serve(cfg, shape, params=params, pattern=pattern,
                                  peak=False)
    return {"flops": counts["flops"],
            "n_params": sum(x.numel() for x in tree_leaves(params))}


def roofline_child(names, wait) -> dict:
    """``roofline_tasks`` of ``names`` counted: the cheapest prefill first
    (it imports and warms what every count runs, and runs no backward:
    autograd refuses to run in a process forked from one where it ran),
    then ``wait()``, then the rest in ROOFLINE_WORKERS processes forked
    from this one, the longest first: {name: {"flops", "n_params"}}, each
    the weighted sum of its points'."""
    import multiprocessing
    import torch
    torch.set_num_threads(1)
    tasks = roofline_tasks(names)

    def cost(task):
        _, _, cfg, pattern, n = task
        return (len(pattern) + cfg.n_encoder_layers) * max(n, 1) * (
            2 if n else 1)

    tasks.sort(key=cost, reverse=True)
    first = min((t for t in tasks if not t[4]), key=cost)
    rest = [t for t in tasks if t is not first]
    counts = [roofline_count(first)]
    wait()
    with multiprocessing.get_context("fork").Pool(ROOFLINE_WORKERS) as pool:
        counts += pool.map(roofline_count, rest, chunksize=1)
    out = {name: {"flops": 0.0, "n_params": 0.0} for name in names}
    for (name, w, *_), c in zip([first] + rest, counts):
        for key in out[name]:
            out[name][key] += w * c[key]
    return {name: {"flops": c["flops"], "n_params": int(round(c["n_params"]))}
            for name, c in out.items()}


def start_roofline():
    """``roofline_child`` of every timed phase in a child process of this
    script (``ROOFLINE_CHILD``), its output written under ``build/``. It
    imports and warms its counters, then waits for ``join_roofline`` to
    write "go" to it: (child, output paths)."""
    root = Path(__file__).resolve().parent
    logs = (root / "build" / "roofline.out", root / "build" / "roofline.err")
    logs[0].parent.mkdir(exist_ok=True)
    names = ",".join(list(SERVE_RUNS) + list(TRAIN_RUNS))
    with open(logs[0], "w") as so, open(logs[1], "w") as se:
        child = subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                  ROOFLINE_CHILD, names], stdin=subprocess.PIPE,
                                 stdout=so, stderr=se, text=True)
    atexit.register(lambda: child.poll() is None and child.kill())
    return child, logs


def join_roofline(started, serve_seconds: dict,
                  train_seconds: dict) -> dict:
    """The child's counts beside the seconds each phase measured: the
    model flops' share of the bf16 peak (``mfu``) and the larger term's
    share of the time (``roofline_share``). A share above
    ROOFLINE_SHARE_MAX fails the run."""
    from repro_torch.launch.roofline import PEAK_FLOPS_BF16
    child, logs = started
    t0 = time.perf_counter()
    try:
        child.stdin.write("go\n")
        child.stdin.close()
    except BrokenPipeError:
        pass                      # it has ended: its exit code says how
    try:
        child.wait(timeout=CHILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        child.kill()
        child.wait()
        raise AssertionError(f"the roofline counts took over "
                             f"{CHILD_TIMEOUT_S} s")
    stdout, stderr = (p.read_text() for p in logs)
    require(child.returncode == 0, f"the roofline child failed (exit "
            f"{child.returncode}): {stderr[-2000:]}")
    for p in logs:
        p.unlink()
    counts = json.loads(stdout.strip().splitlines()[-1])
    out = {"phase": "roofline", "prefill": {}, "train": {}}
    for part, seconds in (("prefill", serve_seconds),
                          ("train", train_seconds)):
        for name, t in seconds.items():
            cfg, shape, kw, _ = _phase_of(name)
            row = _counted_row(cfg, shape, counts[name]["n_params"],
                               counts[name]["flops"], **kw)
            row["seconds"] = t
            row["mfu"] = row["model_flops"] / t / PEAK_FLOPS_BF16
            row["roofline_share"] = max(row["compute_s"],
                                        row["memory_s"]) / t
            out[part][name] = row
    over = {k: r["roofline_share"] for part in ("prefill", "train")
            for k, r in out[part].items()
            if not r["roofline_share"] <= ROOFLINE_SHARE_MAX}
    require(not over, f"a roofline share over {ROOFLINE_SHARE_MAX}: {over}")
    out["seconds"] = time.perf_counter() - t0
    return out


def profiled(fn, top: int = 12, watch: str = ""):
    """Run ``fn`` once under torch.profiler; its wall time, the device's
    busy and idle share, and the top operators and kernels by device
    time; with ``watch``, the device time and launches of the kernels
    whose names hold it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(ev):
        for name in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(ev, name):
                return float(getattr(ev, name))
        return 0.0

    events = prof.key_averages()
    # kernels (device events) give the busy time; the operators that
    # launched them (host events) give the readable breakdown
    on_device = [e for e in events
                 if "CUDA" in str(getattr(e, "device_type", ""))]
    busy_s = sum(dev_us(e) for e in on_device) / 1e6
    ops = sorted(((dev_us(e), e.key, e.count) for e in events
                  if e not in on_device), reverse=True)
    out = {}
    if watch:
        hits = [e for e in on_device if watch in e.key]
        out["watched"] = {"kernel": watch, "calls": sum(e.count for e in hits),
                          "ms": sum(dev_us(e) for e in hits) / 1e3}
    return {**out, "seconds": wall, "device_busy_seconds": busy_s,
            "idle_share": max(0.0, 1.0 - busy_s / wall),
            "kernel_launches": sum(e.count for e in on_device),
            "top_ops": [{"name": k[:60], "ms": us / 1e3, "calls": n}
                        for us, k, n in ops[:top] if us > 0],
            "top_kernels": [{"name": e.key[:60], "ms": dev_us(e) / 1e3,
                             "calls": e.count} for e in sorted(
                                 on_device, key=dev_us, reverse=True)[:top]]}


def kernel_trace(fn, pattern: str, calls: int) -> dict:
    """Run ``fn`` ``calls`` times under torch.profiler and read its trace:
    for each kernel whose name matches ``pattern``, its mean device time
    per launch (ms), the launches the trace holds (it may miss the first
    call's), and the grids and blocks they were launched with."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import build

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    path = build.BUILD_DIR / f"trace_{os.getpid()}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    try:
        events = json.loads(path.read_text()).get("traceEvents", [])
    finally:
        path.unlink(missing_ok=True)
    out = {}
    for ev in events:
        m = re.search(pattern, str(ev.get("name", "")))
        if ev.get("cat") != "kernel" or not m:
            continue
        rec = out.setdefault(m.group(0), {"us": 0.0, "n": 0, "grids": set(),
                                          "blocks": set()})
        rec["us"] += float(ev.get("dur", 0.0))
        rec["n"] += 1
        args = ev.get("args", {})
        rec["grids"].add(tuple(args.get("grid", ())))
        rec["blocks"].add(tuple(args.get("block", ())))
    return {name: {"ms": rec["us"] / rec["n"] / 1e3,
                   "launches_traced": rec["n"], "calls": calls,
                   "grid": (list(*rec["grids"]) if len(rec["grids"]) == 1
                            else sorted(map(list, rec["grids"]))),
                   "block": (list(*rec["blocks"]) if len(rec["blocks"]) == 1
                             else sorted(map(list, rec["blocks"])))}
            for name, rec in out.items()}


def profile_serving(model, params, batch):
    """One warm prefill of the whole batch and one decode step after it."""
    from repro_torch.models.model import n_prefix
    state = {}
    start = n_prefix(model.cfg) + batch["tokens"].shape[1]

    def prefill():
        state["logits"], state["cache"] = model.prefill(
            params, batch, cache_len=start + 2)

    def decode():
        tok = state["logits"][..., :model.cfg.vocab].argmax(-1)
        model.decode(params, state["cache"], tok, start)

    return {"phase": "profile_serve", "arch": model.cfg.name,
            "prefill": profiled(prefill), "decode_step": profiled(decode)}


def profile_rounds():
    """``--profile``: one warm round of each dither under torch.profiler;
    the device time by kernel and the device's idle share of the round;
    then the sanitize phase's rounds, plain and with the stage checks."""
    import torch
    from repro_torch import api
    from repro_torch.core import compression as C
    from repro_torch.core.quadratic import quadratic_for_objective

    device = "cuda"
    xs, ys = make_workload()
    problem = api.as_problem(quadratic_for_objective(loss_fn, rho=RHO))
    x0 = {"w": torch.zeros((D_MODEL, D_FF), device=device),
          "b": torch.zeros((D_FF,), device=device)}
    gamma = torch.tensor(GAMMA, dtype=torch.float32)
    for dither in ("hash", "kernel"):
        spec = api.FederationSpec(
            n_clients=N_CLIENTS, participation=PARTICIPATION, alpha=ALPHA,
            compressor=C.block_quant(BITS, BLOCK, dither=dither))
        state = api.init(problem, x0, spec, device=device)
        state, _ = api.step(problem, spec, state, (xs, ys), gamma,
                            torch.Generator().manual_seed(0), device=device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rec = profiled(lambda: api.step(
            problem, spec, state, (xs, ys), gamma,
            torch.Generator().manual_seed(1), device=device))
        emit({"phase": "profile", "dither": dither,
              "round_seconds": rec.pop("seconds"),
              "step_peak_bytes": torch.cuda.max_memory_allocated(), **rec})
        del state
    # where the stage checks' time goes: the sanitize phase's rounds (hash
    # dither, variates "zero"), plain and with sanitize=True, twice each
    spec = api.FederationSpec(
        n_clients=N_CLIENTS, participation=PARTICIPATION, alpha=ALPHA,
        variates="zero", compressor=C.block_quant(BITS, BLOCK, dither="hash"))
    eval_batch = (xs.reshape(-1, D_MODEL), ys.reshape(-1, D_FF))
    for sanitize in (False, True, False, True):
        rec = profiled(lambda: api.run(
            problem, x0, (xs, ys), GAMMA, spec=spec, key=SEED,
            n_rounds=SANITIZE_ROUNDS, eval_batch=eval_batch, device=device,
            client_mode="vmap", sanitize=sanitize), top=20)
        emit({"phase": "profile_sanitize", "sanitize": sanitize,
              "rounds": SANITIZE_ROUNDS, **rec})


# ---------------------------------------------------------------------------
# the kernel_bench phase: the kernel microbenchmarks' --smoke rows
# ---------------------------------------------------------------------------

# each kernel row of kernel_bench --smoke and the launch counter its
# wrapper adds to (quantize_block.LAUNCHES, flash_attention.LAUNCHES,
# rwkv_scan.LAUNCHES)
BENCH_ROW_COUNTERS = {
    "quantize_block_cuda_4k": "quantize_block",
    "quantize_grouped_streamed_dither_16x1024": "quantize",
    "quantize_grouped_kernel_dither_16x1024": "quantize_seeded",
    "quantize_encode_streamed_dither_16x1024": "encode",
    "quantize_encode_kernel_dither_16x1024": "encode_seeded",
    "flash_attention_cuda_128": "flash_attention",
    "rwkv_scan_cuda_64": "rwkv_scan",
}


# the perf_iterations phase: the A/B driver's rounds, cut through its own
# rounds= argument (the sizes are the reference's) to keep the phase
# near 20 s on the H100 (each mode's time is mostly fixed: PERF.md), and
# its gates' byte counts: the reference's committed rows at these sizes
# (results/perf_log.json, pairs "wire", "collective" and "hier")
PERF_ROUNDS = {"driver": 5, "collective": 2, "hier": 2, "scheduler": 1,
               "faults": 3}
PERF_WIRE_BYTES = {"b8": 8_519_680, "b4": 4_325_376, "f32": 33_554_432}
PERF_COLLECTIVE_BYTES = {"gather": 3168, "reduce": 1216, "f32": 9728}
PERF_HIER_BYTES = {"uplink": 3168, "raw": 4864, "reencode": 1584}
PERF_PEAK_RATIO_MAX = 1.1


def perf_iterations_phase() -> dict:
    """``repro_torch.benchmarks.perf_iterations``' six timed modes on the
    card, each once at the reference's sizes over ``PERF_ROUNDS`` rounds
    (``--faults`` over 3, the fewest at which the 3 snapshots it keeps
    exist), the log in a temporary file. The kernels' launches are
    counted over the whole phase (``launches``), from 0. Gates (each
    raises): ``api.run`` and the hand loop of ``api.step`` end bit for
    bit equal; the wire mode's dequantized and code-space aggregates bit
    for bit at b 8 and b 4, each also bit for bit the plain route's on
    the same inputs (``kernel_threshold=1 << 62``: the quantizer kernels
    against their plain versions at b 8 and b 4), its fused one within
    rtol 1e-5 / atol 1e-6, its stacks' bytes ``PERF_WIRE_BYTES``, and
    ``qb_quantize``,
    ``qb_encode`` and ``qb_decode_reduce`` each launched; gather bit for
    bit and reduce allclose (rtol 1e-5 / atol 1e-6) to the single-device
    run with ``PERF_COLLECTIVE_BYTES``; two-tier's ``PERF_HIER_BYTES``
    and both within 0.05 of flat; the scheduler's device peak at 2,048
    clients at most ``PERF_PEAK_RATIO_MAX`` times that at 256; 3
    snapshots kept. The rounds/s, µs and the durability overhead are
    reported, not gated: they are the host's. Returns the phase's
    record."""
    import tempfile
    import torch
    from repro_torch.benchmarks import perf_iterations as P
    from repro_torch.kernels import quantize_block as qb

    t_phase = time.perf_counter()
    seconds, rows = {}, {}
    qb.reset_launches()
    with tempfile.TemporaryDirectory() as d:
        log = os.path.join(d, "perf_log_torch.json")
        for name, fn in (("driver", P.bench_driver), ("wire", P.bench_wire),
                         ("collective", P.bench_collective),
                         ("hier", P.bench_hier),
                         ("scheduler", P.bench_scheduler),
                         ("faults", P.bench_faults)):
            kw = ({"rounds": PERF_ROUNDS[name]} if name in PERF_ROUNDS
                  else {})
            t = time.perf_counter()
            out = fn(log_path=log, **kw)
            torch.cuda.synchronize()
            seconds[name] = time.perf_counter() - t
            rows[name] = ([e["result"] for e in out] if isinstance(out, list)
                          else out["result"])
            progress(f"perf_iterations {name} ({seconds[name]:.1f} s)")
        logged = sorted(e["pair"] for e in json.load(open(log)))
    launches = {k: v for k, v in qb.LAUNCHES.items() if v}
    require(logged == sorted(["collective", "collective", "driver", "faults",
                              "hier", "hier", "scheduler", "wire"]),
            f"perf_iterations: the log holds {logged}")

    driver, wire, sched, faults = (rows[k] for k in ("driver", "wire",
                                                     "scheduler", "faults"))
    require(driver["hand_loop_bit_identical"],
            "perf_iterations --driver: api.run and the hand loop of "
            "api.step part")
    require(wire["f32_stack_bytes"] == PERF_WIRE_BYTES["f32"],
            f"perf_iterations --wire: f32 stack {wire['f32_stack_bytes']}")
    for b in ("b8", "b4"):
        r = wire[b]
        require(r["aggregate_bit_identical"]
                and r["plain_route_bit_identical"]
                and r["fused_allclose_vs_code_space"]
                and r["payload_stack_bytes"] == PERF_WIRE_BYTES[b],
                f"perf_iterations --wire {b}: {r}")
    for k in ("quantize_seeded", "encode_seeded", "decode_reduce"):
        require(wire["launches"].get(k, 0) > 0,
                f"perf_iterations --wire did not launch {k}: "
                f"{wire['launches']}")
    gather, reduce = rows["collective"]
    require(gather["trajectory_bit_identical"]
            and reduce["trajectory_allclose_vs_single"]
            and (gather["collective_wire_bytes_per_round"],
                 reduce["psum_operand_bytes_per_device"],
                 gather["f32_stack_bytes_per_round"]) == (
                PERF_COLLECTIVE_BYTES["gather"],
                PERF_COLLECTIVE_BYTES["reduce"], PERF_COLLECTIVE_BYTES["f32"]),
            f"perf_iterations --collective: {rows['collective']}")
    raw, reenc = rows["hier"]
    require((raw["uplink_bytes_per_round"], raw["backbone_bytes_per_round"],
             reenc["backbone_bytes_per_round"]) == (
                PERF_HIER_BYTES["uplink"], PERF_HIER_BYTES["raw"],
                PERF_HIER_BYTES["reencode"])
            and raw["max_abs_diff_vs_flat"] < 0.05
            and reenc["max_abs_diff_vs_flat"] < 0.05,
            f"perf_iterations --hier: {rows['hier']}")
    require(sched["peak_bytes_ratio_big_vs_small"] <= PERF_PEAK_RATIO_MAX,
            f"perf_iterations --scheduler: peak ratio "
            f"{sched['peak_bytes_ratio_big_vs_small']}")
    require(faults["checkpoints_retained"] == 3,
            f"perf_iterations --faults: {faults['checkpoints_retained']} "
            f"snapshots kept")
    return {"phase": "perf_iterations", "rounds": PERF_ROUNDS,
            "rows": rows, "mode_seconds": seconds, "launches": launches,
            "seconds": time.perf_counter() - t_phase}


def kernel_bench_phase() -> dict:
    """``kernel_bench.run(smoke=True)`` on the card, once, with every
    launch count set to 0 before it: its rows, each kernel row's launches
    (each must have launched its CUDA kernel), and both ``wire_bytes``
    rows' ``analytic_match=1``. The rows are times and pass or fail no
    gate (``check_kernel_bench`` is not run here). After the counts are
    read, each kernel row's call is held against its plain version on
    the same tensors (``kernel_bench.pairs``): the quantizers bit for
    bit, flash attention and the WKV6 scan (float32) at FLASH_TOL and
    RWKV_F32_TOL."""
    import torch
    from repro_torch.benchmarks import kernel_bench
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import quantize_block as qb
    from repro_torch.kernels import rwkv_scan as rs
    for mod in (qb, fa, rs):
        mod.reset_launches()
    t0 = time.perf_counter()
    rows = kernel_bench.run(smoke=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {**qb.LAUNCHES, **fa.LAUNCHES, **rs.LAUNCHES}
    names = [name for name, _, _ in rows]
    for name, counter in BENCH_ROW_COUNTERS.items():
        require(name in names and launches[counter] > 0,
                f"kernel_bench: row {name} did not launch its kernel "
                f"({counter}: {launches[counter]})")
    wire = {name: derived for name, _, derived in rows
            if name.startswith("wire_bytes_")}
    require(len(wire) == 2 and all("analytic_match=1" in d
                                   for d in wire.values()),
            f"kernel_bench: wire_bytes rows {wire}")
    checks = []
    for name, kern, plain in kernel_bench.pairs(smoke=True):
        got, want = kern(), plain()
        got, want = ((got, want) if isinstance(got, tuple)
                     else ((got,), (want,)))
        check = {"row": name, "max_abs_err": max(
            max_abs_err(a, b) for a, b in zip(got, want))}
        if name.startswith("quantize_"):
            check["bits_equal"] = all(bits_equal(a, b)
                                      for a, b in zip(got, want))
            ok = check["bits_equal"]
        else:
            tols = ((FLASH_TOL["float32"],) if name.startswith("flash_")
                    else (RWKV_F32_TOL["y"], RWKV_F32_TOL["state"]))
            check["worst_ratio"] = max(worst_ratio(a, b, tol) for a, b, tol
                                       in zip(got, want, tols))
            check["tol"] = tols
            ok = all(a.dtype == b.dtype and a.shape == b.shape
                     for a, b in zip(got, want)) and \
                check["worst_ratio"] <= 1.0
        require(ok, f"kernel_bench: {name} differs from its plain version "
                    f"({check})")
        checks.append(check)
    require(sorted(c["row"] for c in checks) == sorted(BENCH_ROW_COUNTERS),
            f"kernel_bench: checked rows {[c['row'] for c in checks]}")
    return {"phase": "kernel_bench", "smoke": True,
            "rows": [{"name": n, "us": us, "derived": d}
                     for n, us, d in rows],
            "launches": {k: v for k, v in launches.items() if v},
            "checks": checks, "seconds": seconds,
            "check_seconds": time.perf_counter() - t0 - seconds}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    if FIGURES_CHILD in sys.argv[1:]:
        return figures_child("--profile" in sys.argv[1:])
    if CONTRACTS_CHILD in sys.argv[1:]:
        print(json.dumps(contracts_child()), flush=True)
        return 0
    if ROOFLINE_CHILD in sys.argv[1:]:
        names = sys.argv[sys.argv.index(ROOFLINE_CHILD) + 1].split(",")

        def wait():
            # the parent's "go" once its timed phases are over; end
            # without counting if it went away
            if sys.stdin.readline() != "go\n":
                sys.exit(1)

        print(json.dumps(roofline_child(names, wait)), flush=True)
        return 0
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import quantize_block as qb
    from repro_torch.kernels import rwkv_scan as rs

    import faulthandler
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    t_start = time.perf_counter()
    profile = "--profile" in sys.argv[1:]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    device_kind = torch.cuda.get_device_name(0)
    # the host's children need no card: beside the build, the dry run runs
    # and the roofline's counter starts, then waits for the timed phases
    dryrun, counting = start_dryrun(), start_roofline()
    contracts = start_contracts()
    t0 = time.perf_counter()
    # one nvcc per source, started together
    sources = [qb.SOURCE, fa.SOURCE, rs.SOURCE, fa.SOURCE_BWD, rs.SOURCE_BWD]
    libs = build.build_many([(src, build.BASE_FLAGS) for src in sources],
                            force=True)
    for load in (qb._lib, fa._lib, rs._lib, fa._bwd_lib, rs._bwd_lib):
        load()
    ptxas = {}
    for src in sources:
        report = build.BUILD_INFO.get(src.name, "")
        ptxas[src.name] = {
            "max_registers": max(map(int, re.findall(
                r"Used (\d+) registers", report)), default=None),
            "spill_bytes": sum(map(int, re.findall(
                r"(\d+) bytes spill stores", report)))}
    # the backward kernels' instances at the paths' head dims: flash bf16
    # (wgmma) at phi3's 128 and gemma3's 256, float32 at 256; WKV6 below.
    # The bf16 flash instances must neither spill nor have
    # their wgmmas serialized (C7512), and must be launched with the 168
    # registers a thread that setmaxnreg's 24 / 240 split assumes
    fa_bwd = build.BUILD_INFO.get(fa.SOURCE_BWD.name, "")
    instances = {}
    for kind, hd, entries in (
            ("bf16", 128, ("fa_bwd_dq_hopper", "fa_bwd_dkdv_hopper")),
            ("bf16", 256, ("fa_bwd_dq_hopper", "fa_bwd_dkdv_hopper")),
            ("f32", 256, ("fa_bwd_dq_kernel", "fa_bwd_dkdv_kernel"))):
        dq_smem, dkv_smem = ctypes.c_int(0), ctypes.c_int(0)
        build.check(fa._bwd_lib().fa_backward_smem_bytes(
            int(kind == "bf16"), hd, ctypes.byref(dq_smem),
            ctypes.byref(dkv_smem)), "smem query")
        for part, entry, smem in zip(("dq", "dkdv"), entries,
                                     (dq_smem.value, dkv_smem.value)):
            rec = ptxas_report(fa_bwd, f"{entry}ILi{hd}E", smem)
            instances[f"fa_bwd_{part}_hd{hd}_{kind}"] = rec
            if kind == "bf16":
                require(rec["registers"] == 168
                        and rec["spill_store_bytes"] == 0
                        and rec["spill_load_bytes"] == 0
                        and not rec["wgmma_serialized"],
                        f"the bf16 flash backward {part} at hd {hd} spills, "
                        f"serializes its wgmmas or is not launched with 168 "
                        f"registers: {rec}")
    # the WKV6 backward's three phases at every head dim and type the
    # dispatch builds (the carry has no type): none may spill
    wkv_bwd = build.BUILD_INFO.get(rs.SOURCE_BWD.name, "")
    for hd in rs.HEAD_DIMS:
        for phase, kernel in enumerate(("summary", "carry", "chunk"), 1):
            kinds = ((("", ""),) if kernel == "carry" else
                     (("_f32", "f"), ("_bf16", "13__nv_bfloat16")))
            for kind, mangled in kinds:
                rec = ptxas_report(
                    wkv_bwd, f"wkv6_bwd_{kernel}I{mangled}Li{hd}E",
                    rs._bwd_lib().wkv6_backward_phase_smem_bytes(hd, phase))
                instances[f"wkv6_bwd_{kernel}_hd{hd}{kind}"] = rec
    spilled = {key: rec for key, rec in instances.items()
               if key.startswith("wkv6_bwd_") and (
                   rec["registers"] == 0 or rec["spill_store_bytes"]
                   or rec["spill_load_bytes"])}
    require(not spilled, f"WKV6 backward kernels spill or are missing: "
            f"{spilled}")
    ptxas["backward_instances"] = instances
    # the small-group quantizer's instances (encode or not, dither made or
    # streamed, group 2^0 .. 2^6): none may spill
    qb_report = build.BUILD_INFO.get(qb.SOURCE.name, "")
    small = {f"small_quant_kernel_{e}{s}_g{2 ** lg}": ptxas_report(
        qb_report, f"small_quant_kernelILb{e}ELb{s}ELi{lg}E", 0)
        for e in (0, 1) for s in (0, 1) for lg in range(7)}
    require(all(rec["registers"] > 0 and not rec["spill_store_bytes"]
                and not rec["spill_load_bytes"] for rec in small.values()),
            f"small-group quantizer kernels spill or are missing: {small}")
    ptxas["small_quant_registers"] = {k: rec["registers"]
                                      for k, rec in small.items()}
    emit({"phase": "setup", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "tf32": False,
          "build_seconds": time.perf_counter() - t0,
          "libraries": [lib.name for lib in libs], "ptxas": ptxas,
          "memory_bytes_per_s": H100_BYTES_PER_S,
          "f32_ops_per_s": F32_OPS_PER_S,
          "bf16_ops_per_s": BF16_OPS_PER_S})

    kernels = kernel_checks(qb)
    emit({"phase": "kernels_vs_plain", "card": card,
          "rows": D_MODEL * D_FF // BLOCK, "group": BLOCK,
          "clients": N_CLIENTS,
          "bit_exact": True,
          "times_ms": {k: {f: v[f] for f in ("ms", "plain_ms", "bound_ms")}
                       for k, v in kernels.items()}})
    torch.cuda.empty_cache()

    keep = {}
    slice_out = drive_slice(keep)
    emit(dict(slice_out, card=card))
    sanitize_out = sanitize_phase(keep, contracts)
    lint = sanitize_out["contracts"].pop("lint")
    emit(dict(sanitize_out, card=card))
    emit(lint)
    del keep

    _free()
    # the figures and Fig. 3 run in a child process beside the mesh and
    # scheduler phases, after every kernel of phases 1-2 has been timed
    started = start_figures(profile)
    try:
        mesh_out = mesh_phase()
        emit(dict(mesh_out, card=card))
        _free()
        sched_out = sched_phase()
        emit(dict(sched_out, card=card))
        join_figures(started)
    finally:
        stop_figures(started)
    _free()
    perf_out = perf_iterations_phase()
    emit(dict(perf_out, card=card))

    # the quantizer rows count their launches on each FedMM path apart:
    # the single-device rounds, the runtime checks' rounds, the mesh runs,
    # the two-tier runs off the mesh and the scheduler's runs; "launches"
    # is their sum
    for k, entry in kernels.items():
        by_path = {"slice": slice_out["launches"].get(k, 0)}
        for path, counts in {**sanitize_out["launches"],
                             **mesh_out["launches"],
                             **sched_out["launches"]}.items():
            by_path[path] = sum(counts.get(c, 0)
                                for c in ROW_COUNTS.get(k, (k,)))
        entry.update(launches=sum(by_path.values()),
                     launches_by_path=by_path)
    if profile:
        torch.cuda.empty_cache()
        profile_rounds()
    _free()

    lm_phase, lm_kernels = lm_kernel_checks()
    # the bf16 kernel at the paths' head dims (phi3's 128, gemma3's 256),
    # and the float32 kernel at 256, with the blocks an SM holds
    flash = lm_kernels["flash_attention"]
    fa_report = build.BUILD_INFO.get(fa.SOURCE.name, "")
    flash["ptxas"] = ptxas_report(fa_report, "fa_hopper_kernelILi128E",
                                  fa._lib().fa_smem_bytes(128))
    flash["ptxas_hd256"] = {
        "bf16": dict(ptxas_report(fa_report, "fa_hopper_kernelILi256E",
                                  fa._lib().fa_smem_bytes(256)),
                     blocks_per_sm=fa.blocks_per_sm(torch.bfloat16, 256)),
        "f32": dict(ptxas_report(fa_report, "flash_fwd_kernelIfLi256E", 0),
                    blocks_per_sm=fa.blocks_per_sm(torch.float32, 256))}
    hd256 = flash["ptxas_hd256"]["bf16"]
    require(hd256["registers"] > 0 and hd256["spill_store_bytes"] == 0
            and hd256["spill_load_bytes"] == 0,
            f"the bf16 hd-256 flash kernel spills: {hd256}")
    # the scan at the path's shape (bf16, hd 64)
    lm_kernels["rwkv_scan"]["ptxas"] = ptxas_report(
        build.BUILD_INFO.get(rs.SOURCE.name, ""),
        "wkv6_kernelI13__nv_bfloat16Li64E", rs._lib().wkv6_smem_bytes(1, 64))
    emit(dict(lm_phase, card=card))
    _free()
    emit(dict(serve_smoke_presets(), card=card))
    serve_seconds = {}
    for name, run in SERVE_RUNS.items():
        served = serve_model(name, profile, **run)
        emit(dict(served, card=card))
        serve_seconds[name] = served["bf16_kv"]["prefill_seconds"]
        # the serve path's launches: the sum over the archs of the row's
        # kernel, each counted from 0 over its own measured requests
        n = served["launches"]
        row = lm_kernels[served["kernel"]]
        by_arch = row.setdefault("launches_by_arch", {})
        by_arch[served["arch"]] = n
        total = sum(by_arch.values())
        row.update(launches=total, launches_by_path={"serve": total})
    _free()
    bwd_rows, train_launches, mesh_launches, train_seconds = train_phase(
        card, profile)
    bench = kernel_bench_phase()
    emit(dict(bench, card=card))
    # nothing runs on the card from here: the counts on meta tensors, side
    # by side on the host
    try:
        emit(dict(join_roofline(counting, serve_seconds, train_seconds),
                  card=card))
        emit(dict(join_dryrun(dryrun), card=card))
    finally:
        for child in (dryrun[0], counting[0]):
            if child.poll() is None:
                child.kill()
                child.wait()
    # the train paths' launches: the full-width runs' timed rounds, and
    # train_mesh's mesh rounds (its decode + reduce at wq counted on the
    # decode_reduce_wq row)
    for key, row in (list(lm_kernels.items()) + list(kernels.items())
                     + list(bwd_rows.items())):
        by_path = row.setdefault("launches_by_path", {})
        for path, counts in (("train", train_launches),
                             ("train_mesh", mesh_launches),
                             ("kernel_bench", bench["launches"]),
                             ("perf_iterations", perf_out["launches"])):
            n = sum(counts.get(c, 0) for c in ROW_COUNTS.get(key, (key,)))
            if n:
                by_path[path] = n
        # the microbenchmarks' and the A/B driver's launches are reported
        # beside the paths', not added to them
        row["launches"] = sum(n for path, n in by_path.items()
                              if path not in ("kernel_bench",
                                              "perf_iterations"))
    for key in ("quantize_seeded", "encode_seeded", "decode_reduce"):
        require(kernels[key]["launches_by_path"].get("perf_iterations", 0)
                > 0, f"{key} was not launched on the perf_iterations path")
    for key, row in bwd_rows.items():
        require(row["launches_by_path"].get("train", 0) > 0,
                f"{key} was not launched on the train path")
    require(kernels["decode_reduce_wq"]["launches_by_path"].get(
        "train_mesh", 0) > 0, "decode_reduce was not launched on the "
            "train_mesh path")
    kernels.update(lm_kernels)
    kernels.update(bwd_rows)
    emit({"kernels": list(kernels.values())})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": device_kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
