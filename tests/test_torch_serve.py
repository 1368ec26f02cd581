"""The port's serving path against the JAX package on the CPU.

For the two architectures of the reference's fast tier (phi3-medium-14b,
dense GQA; rwkv6-3b, RWKV6), the two MoE archs (qwen3-moe-235b-a22b,
llama4-maverick-400b-a17b) and the hybrid (jamba-1.5-large-398b, at its
reduced pattern [mamba_mlp, attn_moe] and at the four-layer pattern
[mamba_mlp, mamba_moe, mamba_mlp, attn_moe] of ``attn_every=4``; every
input asserts the reference's top-k gap at each MoE call), reduced (2
layers, d_model 128, float32): the
JAX ``model.init(PRNGKey(0))`` weights are carried across with
``interop.model_params_to_torch`` and both models get the same numpy
tokens. Compared: the prefill's last logits and its caches, four greedy
decode steps (equal tokens, close logits), and the int8 KV cache. A
bfloat16 variant checks that bf16 weights cross bit for bit and that the
logits agree within the reference's bf16 tolerance. Then the port's own
decode-consistency checks (``tests/test_models_smoke.py``'s, at its
5e-3), and ``python -m repro_torch.launch.serve --device cpu`` to the end.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JCFG
from repro.models.model import build_model as j_build
import repro_torch.configs as TCFG
from repro_torch import interop
from repro_torch.launch import serve as tserve
from repro_torch.models.model import build_model as t_build, make_batch

from _torch_parity import (assert_bits_equal, assert_gaps, np_of,
                           spy_reference_moe_gaps)

ROOT = Path(__file__).resolve().parents[1]
# float32 through two layers: the sums run in another order (XLA vs ATen)
F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)     # tests/test_kernels.py, bfloat16
CONSISTENCY_TOL = dict(rtol=5e-3, atol=5e-3)   # tests/test_models_smoke.py
B, S, NEW = 2, 16, 4


def _cfgs(aid, **changes):
    return (dataclasses.replace(JCFG.get(aid).reduced(), **changes),
            dataclasses.replace(TCFG.get(aid).reduced(), **changes))


def _pair(aid, **changes):
    """Both models with the reference's weights carried across."""
    jcfg, tcfg = _cfgs(aid, **changes)
    jmodel = j_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)
    tmodel = t_build(tcfg, device="cpu")
    tparams = interop.model_params_to_torch(tcfg, np_params, device="cpu")
    return jmodel, jparams, np_params, tmodel, tparams


def _tokens(vocab, seq=S, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, seq))


def _f32(x):
    return np_of(x.float()) if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


JAMBA = "jamba-1.5-large-398b"
# the hybrid patterns: jamba's reduced() ([mamba_mlp, attn_moe]) and layers
# 4-7 of its first period ([mamba_mlp, mamba_moe, mamba_mlp, attn_moe])
HYBRID = {"reduced": {}, "four-layer": dict(n_layers=4, attn_every=4)}


def _stacked(caches, cycle=1):
    """The port's per-layer caches stacked like the reference's: one tree
    per cycle position, each with a leading axis over the cycle's
    blocks."""
    return [{k: torch.stack([c[k] for c in caches[pos::cycle]])
             for k in caches[pos]} for pos in range(cycle)]


def _bits16(x):
    return np_of(x.view(torch.int16)) if isinstance(x, torch.Tensor) \
        else np.asarray(x).view(np.int16)


@pytest.mark.parametrize("aid,kv_dtype", [("phi3-medium-14b", ""),
                                          ("phi3-medium-14b", "int8"),
                                          ("rwkv6-3b", ""),
                                          ("qwen3-moe-235b-a22b", ""),
                                          ("qwen3-moe-235b-a22b", "int8"),
                                          ("llama4-maverick-400b-a17b", "")])
def test_prefill_and_greedy_decode_match(aid, kv_dtype):
    _check_prefill_and_decode(aid, kv_dtype=kv_dtype)


@pytest.mark.parametrize("kv_dtype", ["", "int8"])
@pytest.mark.parametrize("pattern", sorted(HYBRID))
def test_hybrid_prefill_and_greedy_decode_match(monkeypatch, pattern,
                                                kv_dtype):
    """jamba: the Mamba layers' states (conv, ssm) beside the attention
    caches, no RoPE, the MoE every other layer."""
    gaps = spy_reference_moe_gaps(monkeypatch)
    _check_prefill_and_decode(JAMBA, kv_dtype=kv_dtype, **HYBRID[pattern])
    assert_gaps(gaps, 1 + NEW)


def _check_prefill_and_decode(aid, frontend=None, n_prefix=0, **changes):
    """``frontend``: an optional (key, numpy (B, F, d)) handed to both
    models in the batch (audio's frames, vlm's patches); ``n_prefix``: the
    positions it takes before the tokens (vlm's F), by which the cache
    grows and every decode position moves."""
    jmodel, jparams, _, tmodel, tparams = _pair(aid, **changes)
    toks = _tokens(jmodel.cfg.vocab)
    cache_len = n_prefix + S + NEW
    jbatch, tbatch = {"tokens": jnp.asarray(toks)}, {"tokens":
                                                     torch.tensor(toks)}
    if frontend is not None:
        key, arr = frontend
        jbatch[key], tbatch[key] = jnp.asarray(arr), torch.tensor(arr)
    jprefill = jax.jit(jmodel.prefill, static_argnames=("cache_len",))
    jdecode = jax.jit(jmodel.decode)
    jlogits, jcache = jprefill(jparams, jbatch, cache_len=cache_len)
    tlogits, tcache = tmodel.prefill(tparams, tbatch, cache_len=cache_len)
    np.testing.assert_allclose(np_of(tlogits), np.asarray(jlogits), **F32_TOL)
    cycle = len(jcache)                         # one tree a cycle position
    for stacked, jpos in zip(_stacked(tcache, cycle), jcache):
        assert sorted(stacked) == sorted(jpos)
        for key, want in jpos.items():
            got, want = stacked[key], np.asarray(want)
            assert tuple(got.shape) == want.shape, key
            if key in ("k_scale", "v_scale"):
                # bf16 scales of K/V that agree to float32 rounding: within
                # one bf16 step
                np.testing.assert_allclose(_f32(got),
                                           want.astype(np.float32), rtol=1e-2)
            elif got.dtype == torch.int8:
                assert np.abs(np_of(got).astype(int) - want).max() <= 1, key
            else:
                np.testing.assert_allclose(np_of(got), want, **F32_TOL)

    vocab = jmodel.cfg.vocab
    jtok = jnp.argmax(jlogits[..., :vocab], axis=-1).astype(jnp.int32)
    ttok = torch.argmax(tlogits[..., :vocab], dim=-1)
    for i in range(NEW):
        np.testing.assert_array_equal(np_of(ttok), np.asarray(jtok))
        pos = n_prefix + S + i
        jlogits, jcache = jdecode(jparams, jcache, jtok,
                                  jnp.asarray(pos, jnp.int32))
        tlogits, tcache = tmodel.decode(tparams, tcache, ttok, pos)
        np.testing.assert_allclose(np_of(tlogits), np.asarray(jlogits),
                                   **F32_TOL)
        jtok = jnp.argmax(jlogits[..., :vocab], axis=-1).astype(jnp.int32)
        ttok = torch.argmax(tlogits[..., :vocab], dim=-1)


@pytest.mark.parametrize("aid", ["phi3-medium-14b", "rwkv6-3b",
                                 "qwen3-moe-235b-a22b", JAMBA])
def test_bfloat16_weights_cross_bit_for_bit(aid):
    jmodel, jparams, np_params, tmodel, tparams = _pair(aid,
                                                        dtype="bfloat16")
    emb = np_params["embedding"]["embed"]
    assert emb.dtype.name == "bfloat16"
    assert tparams["embedding"]["embed"].dtype == torch.bfloat16
    assert_bits_equal(_bits16(tparams["embedding"]["embed"]), _bits16(emb))
    n_layers = jmodel.cfg.n_layers
    cycle = len(np_params["stack"])
    for i in range(n_layers):
        layer = tparams["layers"][i]
        for name, param in layer.named_parameters():
            node = np_params["stack"][i % cycle]
            for part in name.split("."):
                node = node[part]
            assert_bits_equal(_bits16(param), _bits16(node[i // cycle]),
                              name)
    toks = _tokens(jmodel.cfg.vocab, seed=1)
    jlogits, _ = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)})
    tlogits, _ = tmodel.prefill(tparams, {"tokens": torch.tensor(toks)})
    assert tlogits.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(tlogits), _f32(jlogits), **BF16_TOL)


# ---------------------------------------------------------------------------
# the port on its own
# ---------------------------------------------------------------------------

def _port(aid, **changes):
    tcfg = dataclasses.replace(TCFG.get(aid).reduced(), **changes)
    model = t_build(tcfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    return model, model.init(gen), make_batch(gen, tcfg, B, S + 1)


def test_decode_consistency_recurrent():
    """rwkv6: decode(prefill(x[:S]), x[S]) == prefill(x[:S+1]) last
    logits (the state carry is exact)."""
    model, params, batch = _port("rwkv6-3b")
    toks = batch["tokens"]
    _, cache = model.prefill(params, {"tokens": toks[:, :S]})
    logits, _ = model.decode(params, cache, toks[:, S:S + 1], S)
    want, _ = model.prefill(params, {"tokens": toks})
    np.testing.assert_allclose(np_of(logits), np_of(want), **CONSISTENCY_TOL)


def test_decode_consistency_attention():
    """phi3: decode(prefill(x[:S], cache_len=S+8), x[S], pos=S) ==
    prefill(x[:S+1]) last logits: position i sits at slot i, unwritten
    slots are masked by the slot <= pos rule."""
    model, params, batch = _port("phi3-medium-14b")
    toks = batch["tokens"]
    _, cache = model.prefill(params, {"tokens": toks[:, :S]},
                             cache_len=S + 8)
    logits, _ = model.decode(params, cache, toks[:, S:S + 1], S)
    want, _ = model.prefill(params, {"tokens": toks})
    np.testing.assert_allclose(np_of(logits), np_of(want), **CONSISTENCY_TOL)


@pytest.mark.parametrize("aid", ["qwen3-moe-235b-a22b",
                                 "llama4-maverick-400b-a17b"])
def test_decode_consistency_moe(aid):
    """The MoE archs as ``test_decode_consistency_attention``, rebuilt
    with the no-drop capacity factor (E) as the reference's own check
    does: dropping by capacity is not causal (a later token can take an
    earlier one's slot), so decode matches prefill only when nothing
    drops."""
    n_experts = TCFG.get(aid).reduced().n_experts
    model, params, batch = _port(aid, capacity_factor=float(n_experts))
    toks = batch["tokens"]
    _, cache = model.prefill(params, {"tokens": toks[:, :S]},
                             cache_len=S + 8)
    logits, _ = model.decode(params, cache, toks[:, S:S + 1], S)
    want, _ = model.prefill(params, {"tokens": toks})
    np.testing.assert_allclose(np_of(logits), np_of(want), **CONSISTENCY_TOL)


@pytest.mark.parametrize("pattern", sorted(HYBRID))
def test_decode_consistency_hybrid(pattern):
    """jamba as ``test_decode_consistency_moe``, at both hybrid patterns and
    at an odd prompt (the Mamba state carry is exact)."""
    n_experts = TCFG.get(JAMBA).reduced().n_experts
    model, params, batch = _port(JAMBA, capacity_factor=float(n_experts),
                                 **HYBRID[pattern])
    toks = batch["tokens"]
    for prompt in (S, S - 3):
        _, cache = model.prefill(params, {"tokens": toks[:, :prompt]},
                                 cache_len=S + 8)
        logits, _ = model.decode(params, cache,
                                 toks[:, prompt:prompt + 1], prompt)
        want, _ = model.prefill(params, {"tokens": toks[:, :prompt + 1]})
        np.testing.assert_allclose(np_of(logits), np_of(want),
                                   **CONSISTENCY_TOL)


def test_ring_buffer_wraps():
    """Past the cache's end the slot is pos % S_cache and every slot is
    valid: a cache of S slots decodes position S into slot 0."""
    model, params, batch = _port("phi3-medium-14b")
    toks = batch["tokens"]
    _, cache = model.prefill(params, {"tokens": toks[:, :S]})
    before = cache[0]["k"][:, 1:].clone()
    logits, cache = model.decode(params, cache, toks[:, S:S + 1], S)
    assert torch.isfinite(logits).all()
    assert torch.equal(cache[0]["k"][:, 1:], before)


def test_init_cache_matches_prefill_layout():
    for aid, changes in (("phi3-medium-14b", {}), ("rwkv6-3b", {}),
                         ("qwen3-moe-235b-a22b", {}),
                         *((JAMBA, c) for c in HYBRID.values())):
        model, params, batch = _port(aid, **changes)
        _, cache = model.prefill(params, {"tokens": batch["tokens"]},
                                 cache_len=S + 3)
        zero = model.init_cache(B, S + 3)
        assert len(cache) == len(zero) == model.cfg.n_layers
        for got, want in zip(cache, zero):
            assert {k: (v.shape, v.dtype) for k, v in got.items()} == \
                {k: (v.shape, v.dtype) for k, v in want.items()}


@pytest.mark.parametrize("aid,full,reduced", [
    ("phi3-medium-14b", 40, 2), ("rwkv6-3b", 32, 2), ("gemma3-12b", 48, 2),
    ("jamba-1.5-large-398b", 9, 1), ("whisper-base", 6 + 2 * 6, 2 + 2 * 2),
    ("internvl2-26b", 48, 2)])
def test_prefill_kernel_launches(aid, full, reduced):
    """The sequence kernel's launches a prefill, as chip_smoke.py and the
    card's tests count them: one a scan or attention layer (none a Mamba
    layer, jamba's 9 attention layers of 72), one an audio encoder layer,
    two a cross_mlp layer."""
    from repro_torch.models import transformer as T
    cfg = TCFG.get(aid)
    assert T.prefill_kernel_launches(cfg) == full
    assert T.prefill_kernel_launches(cfg.reduced()) == reduced


def _whisper_int8():
    return _cfgs("whisper-base", kv_dtype="int8")


def test_reference_fault_whisper_int8_decode():
    """A fault of the reference, recorded (ROADMAP Queue C item 7): its
    reduced whisper with the int8 KV cache prefills, but its cross_mlp
    prefill keeps bf16 k/v with no scales, so its first decode step reads
    ``cache["k_scale"]`` and raises ``KeyError``. If the reference
    changes, this test shows it."""
    jcfg, _ = _whisper_int8()
    jmodel = j_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    toks = _tokens(jcfg.vocab)
    frames = np.zeros((B, jcfg.n_frontend_tokens, jcfg.d_model), np.float32)
    logits, cache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks),
                                             "frames": jnp.asarray(frames)},
                                   cache_len=S + NEW)
    assert "k_scale" not in cache[0] and cache[0]["k"].dtype != jnp.int8
    with pytest.raises(KeyError, match="k_scale"):
        jmodel.decode(jparams, cache, jnp.asarray(toks[:, :1], jnp.int32),
                      jnp.asarray(S, jnp.int32))


def test_port_refuses_audio_with_int8_kv():
    """The port adds no feature the reference lacks: audio with the int8
    KV cache raises at build time, naming Queue C item 7; its bf16 cache
    and vlm's int8 one build."""
    _, tcfg = _whisper_int8()
    with pytest.raises(NotImplementedError, match="Queue C item 7"):
        t_build(tcfg, device="cpu")
    t_build(dataclasses.replace(tcfg, kv_dtype=""), device="cpu")
    t_build(_cfgs("internvl2-26b", kv_dtype="int8")[1], device="cpu")


def test_entry_points_default_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_build(TCFG.get("phi3-medium-14b").reduced())


def test_serve_function_and_int8_kv():
    """``serve`` returns new_tokens ids in the vocabulary and its timings;
    the int8 cache serves through the same function."""
    for kv in ("", "int8"):
        tcfg = dataclasses.replace(TCFG.get("phi3-medium-14b").reduced(),
                                   kv_dtype=kv)
        model = t_build(tcfg, device="cpu")
        gen = torch.Generator().manual_seed(1)
        params = model.init(gen)
        toks, info = tserve.serve(model, params,
                                  make_batch(gen, tcfg, B, S), NEW)
        assert toks.shape == (B, NEW)
        assert bool(((toks >= 0) & (toks < tcfg.vocab)).all())
        assert info["logits_finite"] and info["decode_steps"] == NEW - 1


def test_serve_cli_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for arch in ("phi3-medium-14b", "rwkv6-3b", JAMBA):
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--device",
             "cpu", "--arch", arch, "--batch", "2", "--prompt-len", "8",
             "--new-tokens", "3", "--int8-kv"],
            capture_output=True, text=True, env=env, cwd=str(ROOT),
            timeout=300)
        assert out.returncode == 0, out.stderr
        assert "generated token ids (seq 0):" in out.stdout
