"""The H100 roofline (``repro_torch/launch/roofline.py``) and the input
shapes (``configs/base.py``) against the reference's, and the counters
that stand in for its HLO parsing: flops of local operations, the
collectives a ``DTensor`` redistribution asks for (in a subprocess, under
a fake process group of 16 ranks) and the sequence kernels' shape-only
route with its FLOP formulas."""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

import repro.configs as JC
from repro.configs.base import INPUT_SHAPES as J_SHAPES
from repro.launch import roofline as JR

import repro_torch.configs as TC
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rwkv_scan as trs
from repro_torch.launch import roofline as TR

ROOT = Path(__file__).resolve().parents[1]
# (dp, tp, chips) of the 256- and 512-rank meshes
MESHES = ((16, 16, 256), (32, 16, 512))
N_PARAMS = 12_345_678_901


def test_input_shapes_equal_the_reference():
    assert list(INPUT_SHAPES) == list(J_SHAPES)
    for name, shape in INPUT_SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(
            J_SHAPES[name])


@pytest.mark.parametrize("arch", JC.ARCH_IDS)
def test_arithmetic_equals_the_reference(arch):
    """``is_subquadratic``, ``model_flops_estimate`` and ``analytic_bytes``
    (every shape, both meshes, both client modes) are the reference's."""
    tcfg, jcfg = TC.get(arch), JC.get(arch)
    assert tcfg.is_subquadratic == jcfg.is_subquadratic
    for name in INPUT_SHAPES:
        ts, js = INPUT_SHAPES[name], J_SHAPES[name]
        assert TR.model_flops_estimate(tcfg, ts, N_PARAMS) == \
            JR.model_flops_estimate(jcfg, js, N_PARAMS)
        for dp, tp, chips in MESHES:
            for n, mode in ((16, "physical"), (4, "logical")):
                kw = dict(n_clients=n, client_mode=mode, dp=dp, tp=tp,
                          n_chips=chips)
                assert TR.analytic_bytes(tcfg, ts, N_PARAMS, **kw) == \
                    JR.analytic_bytes(jcfg, js, N_PARAMS, **kw)


def test_roofline_terms_dominance_at_the_h100_peaks():
    t = TR.roofline_terms(989e12, 0.0, 0.0, n_chips=256)    # 1 s of compute
    assert t["dominant"] == "compute"
    assert t["compute_s"] == pytest.approx(1.0)
    t = TR.roofline_terms(0.0, 3.35e12, 0.0, n_chips=256)
    assert t["dominant"] == "memory" and t["memory_s"] == pytest.approx(1.0)
    t = TR.roofline_terms(0.0, 3.35e12, 50e9 * 2, n_chips=256)
    assert t["dominant"] == "collective"
    assert t["collective_s"] == pytest.approx(2.0)
    assert (TR.PEAK_FLOPS_BF16, TR.PEAK_FLOPS_F32, TR.HBM_BW,
            TR.COLLECTIVE_BW) == (989e12, 67e12, 3.35e12, 50e9)


def test_flop_counter_on_a_dense_product():
    m, k, n = 96, 160, 224
    a = torch.empty((m, k), device="meta")
    b = torch.empty((k, n), device="meta")
    out, c = TR.count_step(lambda: a @ b, external=(a, b))
    assert out.shape == (m, n)
    assert c["flops"] == 2 * m * n * k
    assert c["collective_bytes"] == 0 and c["by_kind"] == {}
    # the arguments and the product are alive at the peak
    assert c["peak_bytes"] >= 4 * (m * k + k * n + m * n)


@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (7, 7, True, 0), (64, 64, True, 16), (33, 50, False, 0),
    (50, 33, True, 0), (40, 40, False, 9), (1, 300, True, 0)])
def test_kept_pairs_counts_the_masks(Sq, Sk, causal, window):
    keep = tref.attention_keep(Sq, Sk, causal, window, "cpu")
    assert tfa.kept_pairs(Sq, Sk, causal, window) == int(keep.sum())


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 48),
                                           (False, 0)])
def test_flash_meta_route_counts_the_kernel(causal, window):
    """On meta tensors flash attention makes no launch, returns the
    kernel's shapes and counts 4 hd flop per kept pair and head forward,
    10 hd backward (through ops.flash_attention under autograd)."""
    B, S, H, KV, hd = 2, 200, 8, 2, 64
    before = dict(tfa.LAUNCHES)
    q = torch.empty((B, S, H, hd), dtype=torch.bfloat16, device="meta",
                    requires_grad=True)
    k, v = (torch.empty((B, S, KV, hd), dtype=torch.bfloat16, device="meta",
                        requires_grad=True) for _ in range(2))
    out, lse = tfa.flash_attention(q, k, v, causal, window, return_lse=True)
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    pairs = int(tref.attention_keep(S, S, causal, window, "cpu").sum())
    _, c = TR.count_step(lambda: tops.flash_attention(q, k, v, causal,
                                                      window))
    assert c["flops"] == 4 * hd * pairs * B * H
    assert c["flops"] == tfa.forward_flops(B, S, S, H, hd, causal, window)

    def grad():
        y = tops.flash_attention(q, k, v, causal, window)
        return torch.autograd.grad(y, (q, k, v), torch.empty_like(y))

    grads, c = TR.count_step(grad)
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
    assert c["flops"] == (4 + 10) * hd * pairs * B * H
    assert tfa.LAUNCHES == before


def test_wkv6_meta_route_counts_the_kernel():
    B, S, H, hd = 2, 96, 4, 32
    before = dict(trs.LAUNCHES)
    r, k, v, w = (torch.empty((B, S, H, hd), dtype=torch.bfloat16,
                              device="meta", requires_grad=True)
                  for _ in range(4))
    u = torch.empty((H, hd), dtype=torch.bfloat16, device="meta",
                    requires_grad=True)
    (y, st), c = TR.count_step(lambda: tops.rwkv_wkv(r, k, v, w, u))
    assert y.shape == r.shape and y.dtype == torch.bfloat16
    assert st.shape == (B, H, hd, hd) and st.dtype == torch.float32
    n = B * S * H * hd
    assert c["flops"] == 5 * n * hd + 5 * n == trs.forward_flops(B, S, H, hd)

    def grad():
        y, _ = tops.rwkv_wkv(r, k, v, w, u)
        return torch.autograd.grad(y, (r, k, v, w, u), torch.empty_like(y))

    grads, c = TR.count_step(grad)
    assert [g.shape for g in grads] == [t.shape for t in (r, k, v, w, u)]
    assert grads[-1].dtype == torch.bfloat16
    assert c["flops"] == trs.forward_flops(B, S, H, hd) + 12 * n * hd
    assert trs.LAUNCHES == before


def test_meta_route_keeps_the_kernels_checks():
    q = torch.empty((1, 8, 4, 64), dtype=torch.float16, device="meta")
    with pytest.raises(TypeError, match="bfloat16"):
        tfa.flash_attention(q, q, q)
    bad = torch.empty((1, 8, 3, 64), device="meta")
    kv = torch.empty((1, 8, 2, 64), device="meta")
    with pytest.raises(ValueError, match="multiple"):
        tfa.flash_attention(bad, kv, kv)
    r = torch.empty((1, 8, 2, 16), device="meta")
    with pytest.raises(TypeError):
        trs.rwkv_scan(r, r, r, r.to(torch.bfloat16),
                      torch.empty((2, 16), device="meta"))


COLLECTIVES = textwrap.dedent("""
    import json, sys
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard, distribute_tensor)
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.roofline import count_step

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=16)
    mesh = DeviceMesh("cpu", torch.arange(16), mesh_dim_names=("x",))
    full = torch.empty((64, 32), dtype=torch.float32, device="meta")
    sharded = distribute_tensor(full, mesh, [Shard(0)], src_data_rank=None)
    local = torch.empty((64, 32), dtype=torch.float32, device="meta")
    partial = DTensor.from_local(local, mesh, [Partial()], run_check=False)
    out = {}
    for name, x, to in (("gather", sharded, [Replicate()]),
                        ("reduce", partial, [Replicate()]),
                        ("scatter", partial, [Shard(0)]),
                        ("alltoall", sharded, [Shard(1)])):
        y, c = count_step(lambda: x.redistribute(mesh, to).to_local())
        out[name] = [c["by_kind"], c["counts"], list(y.shape)]
    dist.destroy_process_group()
    print(json.dumps(out))
""")


def test_collective_counter_on_a_fake_group():
    """Each redistribution of a (64, 32) float32 DTensor over 16 ranks
    asks for one collective of known bytes (the max of operand and
    result): all-gather 8192 (512 a rank in), all-reduce 8192,
    reduce-scatter 8192 (512 a rank out), all-to-all 512 (the CPU mesh's
    all-gather stand-in is not what is counted)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run([sys.executable, "-c", COLLECTIVES], env=env,
                         capture_output=True, text=True, timeout=240)
    assert run.returncode == 0, run.stderr[-4000:]
    out = json.loads(run.stdout.strip().splitlines()[-1])
    assert out["gather"] == [{"all-gather": 8192.0}, {"all-gather": 1},
                             [64, 32]]
    assert out["reduce"] == [{"all-reduce": 8192.0}, {"all-reduce": 1},
                             [64, 32]]
    assert out["scatter"] == [{"reduce-scatter": 8192.0},
                              {"reduce-scatter": 1}, [4, 32]]
    assert out["alltoall"] == [{"all-to-all": 512.0}, {"all-to-all": 1},
                               [64, 2]]
