"""The port's flash-attention (hd 32 to 256) and RWKV6 kernels against
their plain PyTorch versions, on the card, and the serve paths that run
them (each arch's smoke preset; gemma3-12b at full width, one cycle of
six layers and, through the example, all 48), flash at qwen3-moe's GQA
group of 16, the MoE block and a reduced qwen3-moe prefill on the
card against the CPU, and the Mamba block (its plain scan: prefill,
decode, gradients) and a reduced jamba prefill on the card against the
CPU, and the frontend families: flash forward and backward at
whisper-base's and internvl2-26b's shapes, and their reduced prefills on
the card against the CPU. Every test here is marked
``cuda`` and
skips without a CUDA device; the module imports no JAX, so it also runs
on a machine without it:

    python -m pytest -q -m cuda tests/test_torch_cuda_lm.py

Tolerances: float32 at the reference's attention tolerance (2e-4 / 2e-5,
``tests/test_kernels.py``); bfloat16 outputs within a few bf16 ulps
(rtol 1.6e-2, atol 4e-3): both sides compute in float32 and round the
result to bf16, the sums in another order, and one bf16 ulp is 2^-8 to
2^-7 of the value; the WKV6 state at 1e-4.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import rwkv_scan as trs
from repro_torch.models import transformer as T

pytestmark = pytest.mark.cuda

F32_TOL = dict(rtol=2e-4, atol=2e-5)
BF16_TOL = dict(rtol=1.6e-2, atol=4e-3)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


def _normal(shape, seed, dtype, dev):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(dev, dtype)


def _close(got, want, dtype):
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("hd", [32, 64, 128, 256])
@pytest.mark.parametrize("B,Sq,Sk,H,KV,causal,window", [
    (2, 200, 200, 4, 2, True, 0),       # ragged against the 64-row tile
    (1, 256, 256, 8, 2, True, 48),      # sliding window
    (2, 77, 130, 4, 4, False, 0),       # non-causal, Sq != Sk
    (1, 130, 77, 6, 2, True, 0),        # causal, Sq > Sk
    # the bf16 kernel's 128-row / 128-key tiles (64-key at hd 256): one
    # row short, exact and one row over, GQA groups 1, 4 and 8
    (1, 127, 129, 4, 4, False, 0),
    (2, 128, 128, 8, 2, True, 0),
    (1, 129, 127, 8, 1, True, 0),       # causal, Sq > Sk
    (1, 2048, 2048, 8, 2, True, 0),
    (1, 300, 300, 8, 1, True, 200),     # the window ends inside a tile
])
def test_flash_matches_plain(B, Sq, Sk, H, KV, causal, window, hd, dtype):
    dev = _cuda()
    q = _normal((B, Sq, H, hd), 0, dtype, dev)
    k = _normal((B, Sk, KV, hd), 1, dtype, dev)
    v = _normal((B, Sk, KV, hd), 2, dtype, dev)
    got = tfa.flash_attention(q, k, v, causal=causal, window=window)
    want = tfa.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,Sq,Sk,H,KV,causal", [
    (1, 333, 333, 16, 1, True),         # ragged against both tiles
    (2, 200, 450, 32, 2, False),        # non-causal, Sq != Sk
    (1, 130, 77, 16, 1, True),          # causal, Sq > Sk
    (4, 2048, 2048, 64, 4, True),       # qwen3-moe's prefill
])
def test_flash_gqa_group_16(B, Sq, Sk, H, KV, causal, dtype):
    """qwen3-moe's GQA group of 16 query heads a KV head (64 over 4) at
    its hd 128."""
    dev = _cuda()
    q = _normal((B, Sq, H, 128), 4, dtype, dev)
    k = _normal((B, Sk, KV, 128), 5, dtype, dev)
    v = _normal((B, Sk, KV, 128), 6, dtype, dev)
    got = tfa.flash_attention(q, k, v, causal=causal)
    want = tfa.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    _close(got, want, dtype)


def test_flash_reads_strided_inputs():
    """q, k, v as views of one fused projection (strided along heads and
    sequence), as a packed qkv layout would give them: the bf16 kernel's
    tensor maps carry those strides."""
    dev = _cuda()
    B, S, H, KV, hd = 2, 96, 4, 2, 64
    qkv = _normal((B, S, H + 2 * KV, hd), 3, torch.bfloat16, dev)
    q, k, v = qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:]
    got = tfa.flash_attention(q, k, v)
    want = tfa.flash_attention_plain(q, k, v)
    _close(got, want, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_refuses_unsupported_head_dim(dtype):
    """An hd the kernel does not take (96) raises on a CUDA tensor: no
    launch, and no fall back to the plain version."""
    dev = _cuda()
    q = torch.zeros((1, 8, 2, 96), device=dev, dtype=dtype)
    before = tfa.LAUNCHES["flash_attention"]
    with pytest.raises(ValueError, match="hd"):
        tfa.flash_attention(q, q[:, :, :1], q[:, :, :1])
    assert tfa.LAUNCHES["flash_attention"] == before


def _check_rwkv(B, S, H, hd, dtype, w):
    dev = _cuda()
    r, k, v = (_normal((B, S, H, hd), s, dtype, dev) for s in range(3))
    w = w(_normal((B, S, H, hd), 3, torch.float32, dev)).to(dtype)
    u = _normal((H, hd), 4, torch.float32, dev) * 0.1
    y, st = trs.rwkv_scan(r, k, v, w, u)
    y_want, st_want = trs.rwkv_scan_plain(r, k, v, w, u)
    torch.cuda.synchronize()
    assert y.dtype == dtype and st.dtype == torch.float32
    _close(y, y_want, dtype)
    torch.testing.assert_close(st, st_want, rtol=1e-4, atol=1e-4)


# sequence lengths against the kernel's chunk of 2048 / hd steps
_STEPS = {"1": lambda c: 1, "chunk-1": lambda c: c - 1, "chunk": lambda c: c,
          "chunk+1": lambda c: c + 1, "203": lambda c: 203}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("S", list(_STEPS))
def test_rwkv_matches_plain(S, hd, dtype):
    """The kernel stages chunks of 2048 / hd steps: one step, a chunk one
    step short, exact and one step over, and S = 203, no multiple of any
    chunk (128, 64, 32 or 16 steps)."""
    _check_rwkv(2, _STEPS[S](2048 // hd), 3, hd, dtype, torch.sigmoid)


def test_rwkv_long_prompt_with_model_decays():
    """A 2048-step bf16 prompt at rwkv6's head dim, with the decays the
    model makes, exp(-exp(w_raw)) with w_raw near the -2 bias."""
    _check_rwkv(1, 2048, 4, 64, torch.bfloat16,
                lambda x: torch.exp(-torch.exp(x - 2.0)))


def test_rwkv_refuses_misaligned_input():
    """The kernel stages with 16-byte copies: a view that starts off a
    16-byte boundary is refused, not read wrongly."""
    dev = _cuda()
    flat = torch.zeros(2 * 8 * 2 * 32 + 1, dtype=torch.bfloat16, device=dev)
    x = flat[1:].view(2, 8, 2, 32)
    with pytest.raises(ValueError, match="16-byte"):
        trs.rwkv_scan(x, x, x, x, torch.zeros((2, 32), device=dev))


def test_launch_counters_move():
    dev = _cuda()
    x = _normal((1, 64, 2, 64), 0, torch.bfloat16, dev)
    fa_before = tfa.LAUNCHES["flash_attention"]
    rs_before = trs.LAUNCHES["rwkv_scan"]
    tfa.flash_attention(x, x, x)
    trs.rwkv_scan(x, x, x, torch.sigmoid(x), x[0, 0])
    tfa.flash_attention_plain(x, x, x)
    trs.rwkv_scan_plain(x, x, x, torch.sigmoid(x), x[0, 0])
    assert tfa.LAUNCHES["flash_attention"] == fa_before + 1
    assert trs.LAUNCHES["rwkv_scan"] == rs_before + 1


@pytest.mark.parametrize("arch", ["rwkv6-3b", "phi3-medium-14b",
                                  "gemma3-12b", "qwen3-moe-235b-a22b",
                                  "llama4-maverick-400b-a17b",
                                  "jamba-1.5-large-398b", "whisper-base",
                                  "internvl2-26b"])
def test_serve_smoke_preset(arch):
    """The port's default serve command (``--preset smoke``, the reduced
    float32 config: rwkv6's head dim 16, phi3's and gemma3's 32; jamba's
    [mamba_mlp, attn_moe]; whisper's 2 encoder and 2 decoder layers over 8
    frames; internvl's 2 layers over 8 patches) on the card through
    ``launch/serve.py``: ids in [0, vocab), finite logits, and the
    kernel's launches in the one prefill (``transformer.prefill_kernel_launches``)."""
    from repro_torch import configs
    from repro_torch.launch import serve

    _cuda()
    cfg = configs.get(arch).reduced()
    counter, key = ((trs.LAUNCHES, "rwkv_scan") if cfg.family == "ssm"
                    else (tfa.LAUNCHES, "flash_attention"))
    counter[key] = 0
    toks, info = serve.main(["--arch", arch, "--device", "cuda"])
    assert counter[key] == T.prefill_kernel_launches(cfg)
    assert info["logits_finite"]
    assert bool(((toks >= 0) & (toks < cfg.vocab)).all())


# the frontend families' attention shapes: (B, Sq, Sk, H, KV, hd, causal)
FRONTEND_SHAPES = {
    # whisper-base's encoder over its 1,500 frames and its cross attention
    # (227 prompt tokens over them: whisper's longest prefill), its
    # decoder's self-attention over its 448-token text context
    "whisper encoder": (16, 1500, 1500, 8, 8, 64, False),
    "whisper cross": (16, 227, 1500, 8, 8, 64, False),
    "whisper self": (16, 448, 448, 8, 8, 64, True),
    # internvl2-26b's prefill: 256 patches and 2,048 tokens, 48 query heads
    # over 8 KV heads (a group of 6)
    "internvl prefill": (4, 2304, 2304, 48, 8, 128, True),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", sorted(FRONTEND_SHAPES))
def test_flash_at_frontend_shapes(shape, dtype):
    """Flash forward at whisper's and internvl's serving shapes against
    its plain version."""
    dev = _cuda()
    B, Sq, Sk, H, KV, hd, causal = FRONTEND_SHAPES[shape]
    q = _normal((B, Sq, H, hd), 20, dtype, dev)
    k = _normal((B, Sk, KV, hd), 21, dtype, dev)
    v = _normal((B, Sk, KV, hd), 22, dtype, dev)
    got = tfa.flash_attention(q, k, v, causal=causal)
    want = tfa.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", sorted(FRONTEND_SHAPES))
def test_flash_backward_at_frontend_train_shapes(shape, dtype):
    """Flash backward at the train path's batch of one (whisper's self
    attention over 448 tokens, its cross attention and its encoder;
    internvl's 2,304 positions at a group of 6), fed the forward's
    log-sum-exp, against the plain backward: each gradient within 1e-3
    (float32) / 2e-2 (bf16) of its largest entry, as
    ``tests/test_torch_cuda_train.py`` holds it."""
    from repro_torch.kernels import ref
    dev = _cuda()
    _, Sq, Sk, H, KV, hd, causal = FRONTEND_SHAPES[shape]
    if shape == "whisper cross":
        Sq = 448
    q = _normal((1, Sq, H, hd), 23, dtype, dev)
    k = _normal((1, Sk, KV, hd), 24, dtype, dev)
    v = _normal((1, Sk, KV, hd), 25, dtype, dev)
    do = _normal((1, Sq, H, hd), 26, dtype, dev)
    o, lse = tfa.flash_attention(q, k, v, causal=causal, return_lse=True)
    got = tfa.flash_attention_backward(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    want = ref.flash_attention_backward_plain(q, k, v, o, do, causal=causal)
    tol = 1e-3 if dtype == torch.float32 else 2e-2
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        err = float((g.float() - w.float()).abs().max())
        assert err <= tol * float(w.float().abs().max()), (name, err)


@pytest.mark.parametrize("arch", ["whisper-base", "internvl2-26b"])
def test_frontend_two_layer_prefill_card_matches_cpu(arch):
    """The reduced whisper (2 encoder and 2 decoder layers over 8 frames)
    and internvl (2 layers over 8 patches), float32, prefilled on the card
    and on the CPU from the same weights and batch: logits and caches
    within 1e-4, the flash launches of one prefill, and one decode step
    at the position past the prompt (and the patches)."""
    from repro_torch import configs
    from repro_torch.models.model import build_model, make_batch, n_prefix
    from repro_torch.tree import tree_map
    dev = _cuda()
    cfg = configs.get(arch).reduced()
    cpu = build_model(cfg, device="cpu")
    gen = torch.Generator().manual_seed(2)
    params = cpu.init(gen)
    batch = make_batch(gen, cfg, 2, 96)
    pos = n_prefix(cfg) + 96
    want, want_cache = cpu.prefill(params, batch, cache_len=pos + 4)
    want_cache = tree_map(torch.clone, want_cache)
    tok = want[..., :cfg.vocab].argmax(-1)
    want_step, _ = cpu.decode(params, tree_map(torch.clone, want_cache),
                              tok, pos)
    card = build_model(cfg, device=dev)
    tfa.LAUNCHES["flash_attention"] = 0
    params = params.to(dev)                 # the module moves in place
    got, got_cache = card.prefill(params, tree_map(
        lambda t: t.to(dev), batch), cache_len=pos + 4)
    assert tfa.LAUNCHES["flash_attention"] == T.prefill_kernel_launches(cfg)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    for a, b in zip(got_cache, want_cache):
        assert sorted(a) == sorted(b)
        for key in b:
            torch.testing.assert_close(a[key].cpu(), b[key], rtol=1e-4,
                                       atol=1e-4)
    got_step, _ = card.decode(params, got_cache, tok.to(dev), pos)
    torch.testing.assert_close(got_step.cpu(), want_step, rtol=1e-4,
                               atol=1e-4)


def test_gemma3_one_cycle_at_full_width():
    """gemma3-12b at full width, bf16, cut to one cycle of six layers
    (five local, window 1024, and one global; hd 256): batch 2, a
    1500-token prompt (no multiple of the window), 4 greedy tokens; one
    flash launch per layer in the prefill, ids in [0, vocab), finite
    logits."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.launch.serve import serve
    from repro_torch.models.model import build_model, make_batch

    _cuda()
    cfg = dataclasses.replace(configs.get("gemma3-12b"), n_layers=6)
    model = build_model(cfg, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init(gen)
    batch = make_batch(gen, cfg, 2, 1500)
    tfa.LAUNCHES["flash_attention"] = 0
    toks, info = serve(model, params, batch, 4)
    assert tfa.LAUNCHES["flash_attention"] == 6
    assert info["logits_finite"]
    assert toks.shape == (2, 4)
    assert bool(((toks >= 0) & (toks < cfg.vocab)).all())


def test_serve_batched_example_full_preset():
    """``python -m repro_torch.examples.serve_batched --arch gemma3-12b
    --preset full`` (all 48 layers at full width, bf16, random weights)
    through its ``main``, with a short prompt: one flash launch per
    layer, ids in [0, vocab), finite logits."""
    from repro_torch import configs
    from repro_torch.examples import serve_batched

    _cuda()
    cfg = configs.get("gemma3-12b")
    tfa.LAUNCHES["flash_attention"] = 0
    toks, info = serve_batched.main(["--arch", "gemma3-12b", "--preset",
                                     "full", "--batch", "2", "--prompt-len",
                                     "300", "--new-tokens", "3"])
    assert tfa.LAUNCHES["flash_attention"] == cfg.n_layers
    assert info["logits_finite"] and toks.shape == (2, 3)
    assert bool(((toks >= 0) & (toks < cfg.vocab)).all())


def _moe_cfg(capacity_factor):
    """qwen3-moe's reduced config widened to 16 experts, top 4, so that
    groups of 64 tokens drop pairs at ``capacity_factor`` 0.5."""
    import dataclasses
    from repro_torch import configs
    return dataclasses.replace(configs.get("qwen3-moe-235b-a22b").reduced(),
                               d_model=256, d_ff=192, n_experts=16, top_k=4,
                               moe_group=64, capacity_factor=capacity_factor)


def _assert_top_k_gap(params, cfg, x, gap=1e-5):
    """Every token's k-th and (k+1)-th router probability over ``gap``
    apart (on the CPU): a one-ulp difference cannot flip an expert."""
    from repro_torch.models import moe
    with torch.no_grad():
        _, probs, *_ = moe.route(params, cfg, x)
    top = probs.topk(cfg.top_k + 1, dim=-1).values
    assert float((top[..., -2] - top[..., -1]).min()) > gap


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_block_card_matches_cpu(capacity_factor, dtype):
    """``models.moe.moe_block`` on the card against the same on the CPU
    (the same weights and tokens): y, the balance loss and the gradient
    of sum(y * r) / tokens + aux by x and every weight. The router's
    product is float32 without TF32 on the card too, so both pick the
    same experts; the expert products differ only in their sums' order
    (float32 at 1e-4 of the largest entry, bf16 at 2e-2)."""
    from repro_torch.models import moe
    from repro_torch.tree import tree_flatten, tree_map, tree_unflatten
    dev = _cuda()
    cfg = _moe_cfg(capacity_factor)
    params = moe.moe_init(torch.Generator().manual_seed(0), cfg, dtype)
    x = _normal((2, 256, cfg.d_model), 7, torch.float32, "cpu").to(dtype)
    r = _normal((2, 256, cfg.d_model), 8, torch.float32, "cpu")
    _assert_top_k_gap(params, cfg, x)
    outs = {}
    for where in ("cpu", dev):
        leaves, treedef = tree_flatten(tree_map(lambda t: t.to(where),
                                                params))
        live = [t.clone().requires_grad_() for t in leaves]
        xl = x.to(where).requires_grad_()
        moe.reset_dispatch()
        y, aux = moe.moe_block(tree_unflatten(treedef, live), cfg, xl)
        kept = moe.DISPATCH["kept"]
        loss = (y.float() * r.to(where)).sum() / 512 + aux
        grads = torch.autograd.grad(loss, live + [xl])
        outs[str(where)] = (y, aux, grads, kept)
    (y, aux, grads, kept), (yc, auxc, gradsc, keptc) = outs.values()
    assert kept == keptc
    if capacity_factor < 1:
        assert kept < 2 * 256 * cfg.top_k
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for name, a, b in [("y", y, yc), ("aux", aux, auxc)] + [
            (f"grad {i}", a, b) for i, (a, b) in enumerate(zip(grads,
                                                               gradsc))]:
        err = float((a.float() - b.float().to(a.device)).abs().max())
        assert err <= tol * float(b.float().abs().max()) + 1e-6, (name, err)


def test_qwen3_two_layer_prefill_card_matches_cpu():
    """The reduced qwen3-moe (two attn_moe layers, float32) prefilled on
    the card and on the CPU from the same weights and tokens: logits and
    caches within 1e-4, one flash launch per layer on the card."""
    from repro_torch import configs
    from repro_torch.models.model import build_model, make_batch
    from repro_torch.tree import tree_map
    dev = _cuda()
    cfg = configs.get("qwen3-moe-235b-a22b").reduced()
    cpu = build_model(cfg, device="cpu")
    gen = torch.Generator().manual_seed(1)
    params = cpu.init(gen)
    batch = make_batch(gen, cfg, 2, 96)
    want, want_cache = cpu.prefill(params, batch, cache_len=100)
    card = build_model(cfg, device=dev)
    tfa.LAUNCHES["flash_attention"] = 0
    got, got_cache = card.prefill(params.to(dev), tree_map(
        lambda t: t.to(dev), batch), cache_len=100)
    assert tfa.LAUNCHES["flash_attention"] == cfg.n_layers
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    for a, b in zip(got_cache, want_cache):
        for key in b:
            torch.testing.assert_close(a[key].cpu(), b[key], rtol=1e-4,
                                       atol=1e-4)


def test_router_stays_float32_under_tf32():
    """With TF32 turned on for float32 products, the router's logits on
    the card are still the full float32 product (the CPU's within float32
    rounding, the same experts chosen), and the setting is restored."""
    from repro_torch.models import moe
    dev = _cuda()
    cfg = _moe_cfg(1.25)
    params = moe.moe_init(torch.Generator().manual_seed(2), cfg,
                          torch.float32)
    x = _normal((2, 256, cfg.d_model), 10, torch.float32, "cpu")
    _assert_top_k_gap(params, cfg, x)
    card = {"router": params["router"].to(dev)}
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        _, probs, _, eid, pos, _ = moe.route(card, cfg, x.to(dev))
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    _, want, _, eid_cpu, pos_cpu, _ = moe.route(params, cfg, x)
    assert torch.equal(eid.cpu(), eid_cpu) and torch.equal(pos.cpu(),
                                                            pos_cpu)
    torch.testing.assert_close(probs.cpu(), want, rtol=1e-5, atol=1e-7)


def test_mamba_block_card_matches_cpu():
    """jamba's reduced Mamba block (float32) on the card against the CPU
    from the same weights: a prefill longer than two scan chunks, its
    state, a decode step from it, and the gradients of a mean scalar by
    x and every leaf, within 1e-4 of each output's largest entry."""
    from repro_torch import configs
    from repro_torch.models import mamba
    from repro_torch.tree import tree_leaves, tree_map
    dev = _cuda()
    cfg = configs.get("jamba-1.5-large-398b").reduced()
    params = mamba.mamba_init(torch.Generator().manual_seed(3), cfg,
                              torch.float32)
    S = 2 * mamba.CHUNK + 5
    x = _normal((2, S + 1, cfg.d_model), 11, torch.float32, "cpu")
    r = _normal((2, S, cfg.d_model), 12, torch.float32, "cpu")
    outs = []
    for device in ("cpu", dev):
        p = tree_map(lambda t: t.to(device).requires_grad_(), params)
        xx = x.to(device).requires_grad_()
        y, state = mamba.mamba_block(p, cfg, xx[:, :S])
        grads = torch.autograd.grad((y * r.to(device)).mean(),
                                    tree_leaves(p) + [xx])
        with torch.no_grad():
            step, new = mamba.mamba_block(p, cfg, xx[:, S:], state=state,
                                          single_step=True)
        outs.append([y, state["conv"], state["ssm"], step, new["conv"],
                     new["ssm"], *grads])
    for i, (want, got) in enumerate(zip(*outs)):
        err = float((got.detach().cpu() - want.detach()).abs().max())
        assert err <= 1e-4 * float(want.abs().max()) + 1e-6, (i, err)


def test_jamba_two_layer_prefill_card_matches_cpu():
    """The reduced jamba ([mamba_mlp, attn_moe], float32, no RoPE)
    prefilled on the card and on the CPU from the same weights and
    tokens: logits and caches (the Mamba state and the attention cache)
    within 1e-4, one flash launch in the prefill, and one decode step."""
    from repro_torch import configs
    from repro_torch.models.model import build_model, make_batch
    from repro_torch.tree import tree_map
    dev = _cuda()
    cfg = configs.get("jamba-1.5-large-398b").reduced()
    cpu = build_model(cfg, device="cpu")
    gen = torch.Generator().manual_seed(1)
    params = cpu.init(gen)
    batch = make_batch(gen, cfg, 2, 96)
    want, want_cache = cpu.prefill(params, batch, cache_len=100)
    want_cache = tree_map(torch.clone, want_cache)
    tok = want[..., :cfg.vocab].argmax(-1)
    # decode writes its slot into the cache it is given
    want_step, _ = cpu.decode(params, tree_map(torch.clone, want_cache),
                              tok, 96)
    card = build_model(cfg, device=dev)
    tfa.LAUNCHES["flash_attention"] = 0
    params = params.to(dev)                 # the module moves in place
    got, got_cache = card.prefill(params, tree_map(
        lambda t: t.to(dev), batch), cache_len=100)
    assert tfa.LAUNCHES["flash_attention"] == 1
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    for a, b in zip(got_cache, want_cache):
        assert sorted(a) == sorted(b)
        for key in b:
            torch.testing.assert_close(a[key].cpu(), b[key], rtol=1e-4,
                                       atol=1e-4)
    got_step, _ = card.decode(params, got_cache, tok.to(dev), 96)
    torch.testing.assert_close(got_step.cpu(), want_step, rtol=1e-4,
                               atol=1e-4)
