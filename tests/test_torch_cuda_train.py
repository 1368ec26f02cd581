"""Training on the card: the forward's log-sum-exp and the backward
kernels of flash attention and the WKV6 scan against their plain versions
(every head dim, dtype and mask they take; flash at qwen3-moe's GQA
group of 16), the flash backward's bits run
to run, their launch counts through autograd, the refusal of what they do
not take, a smoke-preset train step and the training example.
Every test here is marked ``cuda`` and skips without a CUDA device; the
module imports no JAX, so it also runs on a machine without it:

    python -m pytest -q -m cuda tests/test_torch_cuda_train.py

Tolerances, each output against the plain version on the same inputs,
max |got - want| <= tol * max |want|: 1e-3 in float32 (both accumulate in
float32, the sums of a backward pass in another order over thousands of
terms), 2e-2 in bfloat16 (the gradients are rounded to bf16, a bf16 ulp
is 2^-8 to 2^-7 of the value).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels import rwkv_scan as trs
from repro_torch.tree import tree_leaves

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-3, torch.bfloat16: 2e-2}


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


def _normal(shape, seed, dtype, dev):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(dev, dtype)


def _close(got, want, dtype, what=""):
    assert got.dtype == want.dtype, what
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    assert err <= TOL[dtype] * scale, (what, err, scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("hd", [32, 64, 128, 256])
@pytest.mark.parametrize("B,Sq,Sk,H,KV,causal,window", [
    (2, 200, 200, 4, 2, True, 0),       # ragged against the 64-row tile
    (1, 256, 256, 8, 2, True, 48),      # sliding window
    (1, 300, 300, 4, 1, True, 200),     # the window ends inside a tile
    (2, 77, 130, 4, 4, False, 0),       # non-causal, Sq != Sk
    (1, 130, 77, 6, 2, True, 0),        # causal, Sq > Sk
])
def test_flash_backward_kernel_matches_plain(B, Sq, Sk, H, KV, causal,
                                             window, hd, dtype):
    dev = _cuda()
    q = _normal((B, Sq, H, hd), 0, dtype, dev)
    k = _normal((B, Sk, KV, hd), 1, dtype, dev)
    v = _normal((B, Sk, KV, hd), 2, dtype, dev)
    do = _normal((B, Sq, H, hd), 3, dtype, dev)
    o, lse = tfa.flash_attention(q, k, v, causal=causal, window=window,
                                 return_lse=True)
    got = tfa.flash_attention_backward(q, k, v, o, lse, do, causal=causal,
                                       window=window)
    torch.cuda.synchronize()
    want = ref.flash_attention_backward_plain(q, k, v, o, do, causal=causal,
                                              window=window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close(g, w, dtype, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,Sq,Sk,H,KV,causal", [
    (1, 333, 333, 16, 1, True),         # ragged against both tiles
    (2, 200, 450, 32, 2, False),        # non-causal, Sq != Sk
    (1, 2048, 2048, 64, 4, True),       # qwen3-moe's train shape
])
def test_flash_backward_gqa_group_16(B, Sq, Sk, H, KV, causal, dtype):
    """The backward at qwen3-moe's GQA group of 16 (64 query heads over 4
    KV heads) and hd 128: the dk/dv kernel sums 16 heads' query tiles."""
    dev = _cuda()
    q = _normal((B, Sq, H, 128), 10, dtype, dev)
    k = _normal((B, Sk, KV, 128), 11, dtype, dev)
    v = _normal((B, Sk, KV, 128), 12, dtype, dev)
    do = _normal((B, Sq, H, 128), 13, dtype, dev)
    o, lse = tfa.flash_attention(q, k, v, causal=causal, return_lse=True)
    got = tfa.flash_attention_backward(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    want = ref.flash_attention_backward_plain(q, k, v, o, do, causal=causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close(g, w, dtype, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("hd", [32, 64, 128, 256])
@pytest.mark.parametrize("B,Sq,Sk,H,KV,causal,window", [
    (2, 200, 200, 4, 2, True, 0),
    (1, 300, 300, 4, 1, True, 200),
    (1, 40, 90, 2, 1, False, 16),       # rows past the last key: +inf
    (1, 130, 77, 6, 2, True, 0),
])
def test_flash_forward_lse_matches_plain(B, Sq, Sk, H, KV, causal, window,
                                         hd, dtype):
    """The forward kernels' log-sum-exp against ``ref.flash_attention_lse``
    of the same inputs: +inf on exactly the rows with no key kept, the
    others within 1e-4 (float32) or 1e-3 (bf16: the kernel's scores of
    bf16 inputs are summed on the tensor cores) of |want| + 1; the output
    is the one a forward without the lse gives, bit for bit."""
    dev = _cuda()
    q = _normal((B, Sq, H, hd), 0, dtype, dev)
    k = _normal((B, Sk, KV, hd), 1, dtype, dev)
    v = _normal((B, Sk, KV, hd), 2, dtype, dev)
    out, lse = tfa.flash_attention(q, k, v, causal=causal, window=window,
                                   return_lse=True)
    torch.cuda.synchronize()
    assert lse.shape == (B, H, Sq) and lse.dtype == torch.float32
    want = ref.flash_attention_lse(q, k, causal=causal, window=window)
    empty = torch.isposinf(want)
    assert torch.equal(torch.isposinf(lse), empty)
    tol = 1e-4 if dtype == torch.float32 else 1e-3
    err = (lse[~empty] - want[~empty]).abs() / (want[~empty].abs() + 1)
    assert err.numel() == 0 or float(err.max()) <= tol
    assert torch.equal(out, tfa.flash_attention(q, k, v, causal=causal,
                                                window=window))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("hd", [64, 256])
def test_flash_backward_bits_repeat(hd, dtype):
    """No atomics: two launches on the same inputs give the same bits."""
    dev = _cuda()
    q = _normal((1, 333, 8, hd), 0, dtype, dev)
    k = _normal((1, 333, 2, hd), 1, dtype, dev)
    v = _normal((1, 333, 2, hd), 2, dtype, dev)
    do = _normal((1, 333, 8, hd), 3, dtype, dev)
    o, lse = tfa.flash_attention(q, k, v, causal=True, window=100,
                                 return_lse=True)
    first = tfa.flash_attention_backward(q, k, v, o, lse, do, True, 100)
    second = tfa.flash_attention_backward(q, k, v, o, lse, do, True, 100)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.int16 if a.element_size() == 2
                                  else torch.int32),
                           b.view(torch.int16 if b.element_size() == 2
                                  else torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("with_dstate", [False, True],
                         ids=["no-dstate", "dstate"])
@pytest.mark.parametrize("case", ["ragged", "one-step", "below-chunk", "long",
                                  "decay-0-and-1"])
def test_wkv6_backward_kernel_matches_plain(hd, dtype, with_dstate, case):
    """The kernel's chunks are 16 or 32 steps (``wkv6_backward_chunk``):
    ``ragged``, several chunks and a ragged last one; ``one-step``, S = 1;
    ``below-chunk``, S = 13, one chunk short of its end; ``long``, S = 8192
    (hundreds of chunks carried); ``decay-0-and-1``, the ragged shape with
    w = 0 exactly at step 3 and w = 1 over steps 40-109, across chunk
    boundaries."""
    dev = _cuda()
    B, S, H = {"ragged": (2, 4096 // hd + 37, 3), "one-step": (2, 1, 3),
               "below-chunk": (2, 13, 3), "long": (1, 8192, 2),
               "decay-0-and-1": (2, 4096 // hd + 37, 3)}[case]
    r, k, v = (_normal((B, S, H, hd), i, dtype, dev) for i in range(3))
    w = torch.exp(-torch.exp(_normal((B, S, H, hd), 3, torch.float32, dev)
                             - 2.0))
    if case == "decay-0-and-1":
        w[:, 3] = 0.0
        w[:, 40:110] = 1.0
    w = w.to(dtype)
    u = 0.3 * _normal((H, hd), 4, torch.float32, dev)
    dy = _normal((B, S, H, hd), 5, dtype, dev)
    dstate = _normal((B, H, hd, hd), 6, torch.float32, dev) \
        if with_dstate else None
    got = trs.rwkv_scan_backward(r, k, v, w, u, dy, dstate)
    torch.cuda.synchronize()
    want = trs.ref.rwkv_scan_backward_plain(r, k, v, w, u, dy, dstate)
    for name, g, wnt in zip(("dr", "dk", "dv", "dw", "du"), got, want):
        _close(g, wnt, dtype if name != "du" else torch.float32, name)


def test_autograd_launches_forward_and_backward_kernels():
    """Through ``ops``, a forward launches its kernel once and the backward
    its backward kernel once; the gradients are the plain backward's."""
    dev = _cuda()
    tfa.reset_launches()
    trs.reset_launches()
    q = _normal((1, 128, 4, 64), 0, torch.float32, dev).requires_grad_()
    k = _normal((1, 128, 2, 64), 1, torch.float32, dev).requires_grad_()
    v = _normal((1, 128, 2, 64), 2, torch.float32, dev).requires_grad_()
    out = ops.flash_attention(q, k, v, causal=True, window=40)
    assert isinstance(out, torch.Tensor) and out.shape == q.shape
    assert tfa.LAUNCHES == {"flash_attention": 1, "flash_attention_bwd": 0}
    do = torch.ones_like(out)
    grads = torch.autograd.grad(out, (q, k, v), do)
    assert tfa.LAUNCHES == {"flash_attention": 1, "flash_attention_bwd": 1}
    want = ref.flash_attention_backward_plain(q.detach(), k.detach(),
                                              v.detach(), out.detach(), do,
                                              causal=True, window=40)
    for g, w in zip(grads, want):
        _close(g, w, torch.float32)

    r, kk, vv = (_normal((1, 64, 2, 16), i, torch.bfloat16,
                         dev).requires_grad_() for i in range(3))
    w = torch.full((1, 64, 2, 16), 0.9, dtype=torch.bfloat16, device=dev,
                   requires_grad=True)
    u = _normal((2, 16), 4, torch.bfloat16, dev).requires_grad_()
    y, _ = ops.rwkv_wkv(r, kk, vv, w, u)
    assert trs.LAUNCHES == {"rwkv_scan": 1, "rwkv_scan_bwd": 0}
    gr = torch.autograd.grad(y.float().sum(), (r, kk, vv, w, u))
    assert trs.LAUNCHES == {"rwkv_scan": 1, "rwkv_scan_bwd": 1}
    # u's gradient comes back in u's dtype through the cast outside the
    # Function
    assert gr[4].dtype == torch.bfloat16 and gr[4].shape == u.shape


def test_backward_refuses_what_the_kernels_do_not_take():
    """A CUDA tensor never falls back: a head dim outside the kernels'
    raises in the backward wrappers, as does a float16 tensor and an lse
    of the wrong shape, dtype, layout or device."""
    dev = _cuda()
    q = _normal((1, 16, 2, 48), 0, torch.float32, dev)
    k = _normal((1, 16, 1, 48), 1, torch.float32, dev)
    lse = torch.zeros((1, 2, 16), dtype=torch.float32, device=dev)
    with pytest.raises(ValueError, match="hd"):
        tfa.flash_attention_backward(q, k, k, q, lse, q)
    q = _normal((1, 16, 2, 64), 0, torch.bfloat16, dev)
    k = _normal((1, 16, 1, 64), 1, torch.bfloat16, dev)
    for bad, err in ((lse.transpose(1, 2), ValueError),
                     (lse.to(torch.bfloat16), TypeError),
                     (lse[:, :1], ValueError),
                     (lse.repeat(1, 1, 2)[..., ::2], ValueError),
                     (lse.cpu(), ValueError)):
        with pytest.raises(err):
            tfa.flash_attention_backward(q, k, k, q, bad, q)
    r = _normal((1, 8, 1, 24), 0, torch.float32, dev)
    u = _normal((1, 24), 1, torch.float32, dev)
    with pytest.raises(ValueError, match="hd"):
        trs.rwkv_scan_backward(r, r, r, r, u, r)
    h = _normal((1, 16, 2, 64), 0, torch.float16, dev)
    with pytest.raises(TypeError):
        tfa.flash_attention_backward(h, h[:, :, :1], h[:, :, :1], h, lse, h)


def test_smoke_train_step_on_the_card():
    """One FedMM round of the reduced gemma3 (hd 32, window 16), rwkv6
    (hd 16), qwen3-moe and llama4 (4 experts, top 2 and top 1) on the
    card: finite loss, every flash layer launched twice forward (the step
    and its rematerialisation) and once backward per client, the uplink
    encoded."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.fed import trainer as FT
    from repro_torch.launch.train import sample_batch
    from repro_torch.models.model import build_model
    _cuda()
    for arch, counter, fwd, bwd in (
            ("gemma3-12b", tfa.LAUNCHES, "flash_attention",
             "flash_attention_bwd"),
            ("rwkv6-3b", trs.LAUNCHES, "rwkv_scan", "rwkv_scan_bwd"),
            ("qwen3-moe-235b-a22b", tfa.LAUNCHES, "flash_attention",
             "flash_attention_bwd"),
            ("llama4-maverick-400b-a17b", tfa.LAUNCHES, "flash_attention",
             "flash_attention_bwd")):
        cfg = dataclasses.replace(configs.get(arch).reduced(), vocab=512)
        model = build_model(cfg)
        fcfg = FT.FedLMConfig(n_clients=2, rho=0.05, quant_bits=8,
                              client_mode="logical")
        state = FT.init_state(
            model, torch.Generator(device="cuda").manual_seed(0), fcfg)
        batch = sample_batch(torch.Generator().manual_seed(0), cfg, 2, 2, 64,
                             model.device)
        step = FT.make_train_step(model, fcfg)
        for key in list(counter):
            counter[key] = 0
        state, m = step(state, batch, torch.Generator().manual_seed(1), 0.5)
        torch.cuda.synchronize()
        assert np.isfinite(float(m["loss"]))
        assert counter[fwd] == 2 * 2 * cfg.n_layers
        assert counter[bwd] == 2 * cfg.n_layers
        assert float(m["comm_bytes"]) > 0
        assert all(bool(torch.isfinite(x).all())
                   for x in tree_leaves(state.s_hat))


def _heldout_losses(arch, preset, state, seed=0):
    """The loss of T(Shat) on one held-out batch (four times the entry
    point's default batch of 8 rows of 128 tokens, from seed + 2) at the
    entry point's initial state (made again from ``seed``) and at
    ``state``."""
    from repro_torch import configs
    from repro_torch.fed import trainer as FT
    from repro_torch.launch.train import preset_config, sample_batch
    from repro_torch.models.model import build_model
    cfg = preset_config(configs.get(arch), preset)
    model = build_model(cfg, device="cuda")
    fcfg = FT.FedLMConfig(n_clients=4, rho=0.05,  # the CLI's
                          client_mode="logical")
    first = FT.init_state(model, torch.Generator(device="cuda").manual_seed(
        seed), fcfg)
    batch = sample_batch(torch.Generator().manual_seed(seed + 2), cfg, 4, 8,
                         128, model.device)
    flat = {k: v.reshape((-1,) + tuple(v.shape[2:])) for k, v in batch.items()}
    with torch.no_grad():
        return [float(model.loss_fn(FT.T_map(s.s_hat, fcfg), flat))
                for s in (first, state)]


def test_train_lm_example_on_the_card():
    """``examples/train_lm.py`` (the ``100m`` preset by default) trains on
    the card: finite losses, the held-out loss falls."""
    _cuda()
    from repro_torch.examples.train_lm import run
    out = run(["--arch", "rwkv6-3b", "--steps", "20", "--log-every", "10"])
    losses = [m["loss"] for m in out["history"]]
    assert all(np.isfinite(losses))
    before, after = _heldout_losses("rwkv6-3b", "100m", out["state"])
    assert after < before


def _one_rank_nccl():
    """A one-rank NCCL process group in this process, and its mesh."""
    import datetime
    import socket
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    return init_device_mesh("cuda", (1,), mesh_dim_names=("clients",))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_trainer_on_a_one_rank_nccl_mesh(dtype):
    """gemma3-12b's reduced config (bf16 with 16 heads of 256, so that
    each layer's ``wq`` (128, 4096) has the shard-safe group 128 of the
    fused decode + reduce), physical silos, 2 clients, p 1, variates off,
    ``block_quant(8, 256, "hash")``: each of 2 rounds stepped from the
    off-mesh run's state with the same draws, on a one-rank NCCL mesh with
    the gather and the reduce uplink. With two clients of weight 1/2 each
    sum is exact before its one rounding, so both are held to the
    off-mesh round at rtol 1e-5 / atol 1e-6 (f32) or one bf16 rounding of
    the new iterate and of its step (bf16); the reduce launches one
    ``qb_decode_reduce`` a ``wq`` in bf16; the collective's bytes are the
    gathered stack's and the float32 partial's."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch import api, configs
    from repro_torch.core import compression as C
    from repro_torch.fed import trainer as FT
    from repro_torch.kernels import quantize_block as qb
    from repro_torch.launch.train import sample_batch
    from repro_torch.models.model import build_model
    _cuda()
    cfg = configs.get("gemma3-12b").reduced()
    if dtype == "bfloat16":
        cfg = dataclasses.replace(cfg, dtype=dtype, n_heads=16, n_kv_heads=8,
                                  head_dim=256)
    model = build_model(cfg, device="cuda")
    fcfg = FT.FedLMConfig(n_clients=2, rho=0.05, p=1.0, use_cv=False,
                          client_mode="physical")
    spec = fcfg.federation_spec()
    state = FT.init_state(model, torch.Generator(device="cuda").manual_seed(0),
                          fcfg)
    n_leaves = len(tree_leaves(state.s_hat))
    comp = spec.compressor
    payload = comp.payload_bytes(state.s_hat)
    params = sum(x.numel() for x in tree_leaves(state.s_hat))
    wq = sum(1 for layer in state.s_hat["layers"]
             if C.group_size(layer["attn"]["wq"].shape[-1], 256) == 128)
    assert wq == (2 if dtype == "bfloat16" else 0)
    mesh = _one_rank_nccl()
    try:
        off = FT.make_train_step(model, fcfg)
        steps = {u: FT.make_train_step(model, fcfg, mesh=mesh, uplink=u)
                 for u in ("gather", "reduce")}
        gen = torch.Generator().manual_seed(3)
        for t in range(2):
            batch = sample_batch(torch.Generator().manual_seed(t), cfg, 2, 1,
                                 64, "cuda")
            active, seeds = api.participation_draw(gen, spec, n_leaves)
            ref, _ = off(state, batch, None, 0.5, active=active, seeds=seeds)
            for uplink, step in steps.items():
                qb.reset_launches()
                got, m = step(state, batch, None, 0.5, active=active,
                              seeds=seeds)
                torch.cuda.synchronize()
                for a, b, x in zip(tree_leaves(got.s_hat),
                                   tree_leaves(ref.s_hat),
                                   tree_leaves(state.s_hat)):
                    a, b, x = a.float(), b.float(), x.float()
                    if dtype == "float32":
                        assert torch.allclose(a, b, rtol=1e-5, atol=1e-6)
                    else:
                        tol = 2.0 ** -7 * (b.abs() + (b - x).abs())
                        assert bool(((a - b).abs() <= tol).all())
                stack = 2 * payload if uplink == "gather" else 4 * params
                assert float(m["collective_payload_bytes"]) == stack
                launched = qb.LAUNCHES["decode_reduce"]
                assert launched == (wq if uplink == "reduce" else 0), uplink
            state = ref
    finally:
        dist.destroy_process_group()
