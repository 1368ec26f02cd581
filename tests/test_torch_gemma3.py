"""gemma3-12b's serving path in the port against the JAX package on the CPU.

The reduced config (``configs/base.py`` ``reduced``: two layers
``[swa_mlp, attn_mlp]``, d_model 128, H 4, KV 2, hd 32, window 16,
float32) with the reference's ``init(PRNGKey(0))`` weights carried across
by ``interop.model_params_to_torch``; both models get the same numpy
tokens. Compared at prompts of 16 and 32 (multiples of the window, where
the port's local ring is the reference's cache slot for slot): the
prefill's last logits at F32_TOL, the caches (the layout exactly, the
values at F32_TOL; int8 codes within one level, bf16 scales within one
bf16 step), and four greedy decode steps (equal tokens, close logits);
the same at hd 256 (the flash kernel's new head dim), and a 12-layer
build with ``global_every=6``, the full model's cycle of six.

Then the port on its own: decode against its own prefill at prompts of
20 and 10 (not multiples of the window; below it with ``cache_len``),
and the reference's own departure there, recorded as a fault of the
reference (ROADMAP Queue C item 5): if the reference changes, the test
shows it; the local ring's layout; and the port's
``examples/serve_batched.py`` for gemma3 to the end.
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
from repro_torch.models import transformer as T
from repro_torch.models.model import build_model as t_build

from _torch_parity import np_of

ROOT = Path(__file__).resolve().parents[1]
ARCH = "gemma3-12b"
# float32 through two layers: the sums run in another order (XLA vs ATen)
F32_TOL = dict(rtol=1e-4, atol=1e-4)
CONSISTENCY_TOL = dict(rtol=5e-3, atol=5e-3)   # tests/test_models_smoke.py
B, NEW = 2, 4


def _pair(**changes):
    """Both models, the reference's weights carried across."""
    jcfg = dataclasses.replace(JCFG.get(ARCH).reduced(), **changes)
    tcfg = dataclasses.replace(TCFG.get(ARCH).reduced(), **changes)
    jmodel = j_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)
    tmodel = t_build(tcfg, device="cpu")
    tparams = interop.model_params_to_torch(tcfg, np_params, device="cpu")
    return jmodel, jparams, tmodel, tparams


def _tokens(vocab, seq, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, seq))


def _f32(x):
    return np_of(x.float()) if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _check_caches(jcache, tcache, pattern):
    """The reference's caches, one tree per cycle position stacked over
    its blocks, against the port's per-layer caches."""
    c = len(jcache)
    assert pattern == pattern[:c] * (len(pattern) // c)
    for pos, jtree in enumerate(jcache):
        layers = [tcache[i] for i in range(pos, len(pattern), c)]
        assert sorted(jtree) == sorted(layers[0])
        for key, want in jtree.items():
            got, want = torch.stack([t[key] for t in layers]), np.asarray(want)
            assert tuple(got.shape) == want.shape, (pattern[pos], key)
            assert str(got.dtype).split(".")[1] == want.dtype.name, key
            if key in ("k_scale", "v_scale"):
                np.testing.assert_allclose(_f32(got), want.astype(np.float32),
                                           rtol=1e-2)
            elif got.dtype == torch.int8:
                assert np.abs(np_of(got).astype(int) - want).max() <= 1, key
            else:
                np.testing.assert_allclose(np_of(got), want, **F32_TOL)


def _match(S, **changes):
    jmodel, jparams, tmodel, tparams = _pair(**changes)
    vocab = jmodel.cfg.vocab
    toks = _tokens(vocab, S)
    cache_len = S + NEW
    jprefill = jax.jit(jmodel.prefill, static_argnames=("cache_len",))
    jdecode = jax.jit(jmodel.decode)
    jlogits, jcache = jprefill(jparams, {"tokens": jnp.asarray(toks)},
                               cache_len=cache_len)
    tlogits, tcache = tmodel.prefill(tparams, {"tokens": torch.tensor(toks)},
                                     cache_len=cache_len)
    np.testing.assert_allclose(np_of(tlogits), np.asarray(jlogits), **F32_TOL)
    pattern = T.layer_pattern(tmodel.cfg)
    _check_caches(jcache, tcache, pattern)
    jtok = jnp.argmax(jlogits[..., :vocab], axis=-1).astype(jnp.int32)
    ttok = torch.argmax(tlogits[..., :vocab], dim=-1)
    for i in range(NEW):
        np.testing.assert_array_equal(np_of(ttok), np.asarray(jtok))
        jlogits, jcache = jdecode(jparams, jcache, jtok,
                                  jnp.asarray(S + i, jnp.int32))
        tlogits, tcache = tmodel.decode(tparams, tcache, ttok, S + i)
        np.testing.assert_allclose(np_of(tlogits), np.asarray(jlogits),
                                   **F32_TOL)
        jtok = jnp.argmax(jlogits[..., :vocab], axis=-1).astype(jnp.int32)
        ttok = torch.argmax(tlogits[..., :vocab], dim=-1)
    _check_caches(jcache, tcache, pattern)


@pytest.mark.parametrize("kv_dtype", ["", "int8"], ids=["f32_kv", "int8_kv"])
@pytest.mark.parametrize("S", [16, 32])
@pytest.mark.parametrize("hd", [32, 256])
def test_prefill_caches_and_greedy_decode_match(hd, S, kv_dtype):
    """The reduced pattern [swa_mlp, attn_mlp] at the reduced hd 32 and at
    the full model's hd 256."""
    _match(S, head_dim=hd, kv_dtype=kv_dtype)


def test_cycle_of_six_unstacks():
    """12 layers with global_every 6: the reference stacks two blocks of a
    six-kind cycle (five local, one global), the port keeps one tree per
    layer (layer i is block i // 6 of position i % 6)."""
    _, jparams, tmodel, tparams = _pair(n_layers=12, global_every=6)
    pattern = T.layer_pattern(tmodel.cfg)
    assert pattern == (["swa_mlp"] * 5 + ["attn_mlp"]) * 2
    assert T._cycle(pattern) == 6 and len(jparams["stack"]) == 6
    for i, layer in enumerate(tparams["layers"]):
        for name, param in layer.named_parameters():
            node = jparams["stack"][i % 6]
            for part in name.split("."):
                node = node[part]
            np.testing.assert_array_equal(np_of(param),
                                          np.asarray(node[i // 6]))
    _match(32, n_layers=12, global_every=6)


# ---------------------------------------------------------------------------
# decode against prefill at lengths that are not multiples of the window
# ---------------------------------------------------------------------------

def _port_gap(tmodel, tparams, toks, S):
    """max |decode(prefill(x[:S]), x[S]) - prefill(x[:S + 1])| of the port,
    the cache allocated S + 8 long."""
    _, cache = tmodel.prefill(tparams, {"tokens": torch.tensor(toks[:, :S])},
                              cache_len=S + 8)
    got, _ = tmodel.decode(tparams, cache, torch.tensor(toks[:, S:S + 1]), S)
    want, _ = tmodel.prefill(tparams, {"tokens": torch.tensor(toks)})
    return np_of(got), np_of(want)


def _reference_gap(jmodel, jparams, toks, S):
    _, cache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks[:, :S])},
                              cache_len=S + 8)
    got, _ = jmodel.decode(jparams, cache, jnp.asarray(toks[:, S:S + 1]),
                           jnp.asarray(S, jnp.int32))
    want, _ = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)})
    return np.asarray(got), np.asarray(want)


@pytest.mark.parametrize("S", [20, 10, 16, 32])
def test_port_decode_agrees_with_its_prefill(S):
    """20: above the window of 16, not a multiple (the ring has wrapped);
    10: below it, the ring cache_len-sized (16 slots, 11 used)."""
    jmodel, _, tmodel, tparams = _pair()
    toks = _tokens(jmodel.cfg.vocab, S + 1, seed=1)
    got, want = _port_gap(tmodel, tparams, toks, S)
    np.testing.assert_allclose(got, want, **CONSISTENCY_TOL)


def test_reference_fault_local_ring_misaligned():
    """A fault of the reference, recorded (ROADMAP Queue C item 5): its
    prefill keeps a local layer's last window keys at slots 0, 1, ... and
    its decode writes position p at slot p % S_cache, so decode departs
    from its own prefill unless the prompt is a multiple of the window
    (by 0.49 at S = 20 here; within 5e-3 at S = 32), where the port's
    agrees at both."""
    jmodel, jparams, tmodel, tparams = _pair()
    toks = _tokens(jmodel.cfg.vocab, 33, seed=1)
    got, want = _reference_gap(jmodel, jparams, toks[:, :21], 20)
    assert np.abs(got - want).max() > 0.1
    got, want = _reference_gap(jmodel, jparams, toks, 32)
    np.testing.assert_allclose(got, want, **CONSISTENCY_TOL)
    got, want = _port_gap(tmodel, tparams, toks[:, :21], 20)
    np.testing.assert_allclose(got, want, **CONSISTENCY_TOL)


@pytest.mark.parametrize("kv_dtype", ["", "int8"])
def test_init_cache_matches_prefill_layout(kv_dtype):
    """Below the window (10 of 16, cache_len 13) and above it (40, the ring
    stays 16 slots): init_cache(B, cache_len) is prefill's layout."""
    tcfg = dataclasses.replace(TCFG.get(ARCH).reduced(), kv_dtype=kv_dtype)
    model = t_build(tcfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    for S, cache_len in ((10, 13), (40, 43)):
        toks = torch.tensor(_tokens(tcfg.vocab, S))
        _, cache = model.prefill(params, {"tokens": toks}, cache_len=cache_len)
        zero = model.init_cache(B, cache_len)
        assert len(cache) == len(zero) == tcfg.n_layers
        for got, want in zip(cache, zero):
            assert {k: (v.shape, v.dtype) for k, v in got.items()} == \
                {k: (v.shape, v.dtype) for k, v in want.items()}
        assert cache[0]["k"].shape[1] == min(tcfg.window, cache_len)
        assert cache[1]["k"].shape[1] == cache_len


def test_local_ring_layout():
    """Prefill puts position p of a local layer at slot p % R and leaves
    the slots past the prompt zero: the first layer's keys, made here from
    its weights, against its ring at S = 20 (wrapped: 16 slots, positions
    4..19) and at S = 10 with cache_len 18 (16 slots, 10 used)."""
    from repro_torch.models import layers as L
    tcfg = TCFG.get(ARCH).reduced()
    model = t_build(tcfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    W, KV, hd = tcfg.window, tcfg.n_kv_heads, tcfg.hd
    toks = torch.tensor(_tokens(tcfg.vocab, 20))
    layer = params["layers"][0]
    x = L.embed(params["embedding"], toks)
    k = (L.rmsnorm(layer["norm1"], x) @ layer["attn"]["wk"]).reshape(
        B, 20, KV, hd)
    k = L.rope(k, torch.arange(20)[None], tcfg.rope_theta)
    _, ring = model.prefill(params, {"tokens": toks}, cache_len=28)
    assert ring[0]["k"].shape[1] == W
    for p in range(20 - W, 20):
        torch.testing.assert_close(ring[0]["k"][:, p % W], k[:, p])
    _, short = model.prefill(params, {"tokens": toks[:, :10]}, cache_len=18)
    assert short[0]["k"].shape[1] == W
    assert torch.count_nonzero(short[0]["k"][:, 10:]) == 0
    torch.testing.assert_close(short[0]["k"][:, :10], k[:, :10])


def test_serve_batched_example_runs_on_the_cpu():
    """``python -m repro_torch.examples.serve_batched --arch gemma3-12b
    --preset smoke --device cpu`` (the reduced config), with the int8
    cache and a prompt that is no multiple of the window."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.serve_batched",
         "--arch", ARCH, "--preset", "smoke", "--device", "cpu",
         "--batch", "2", "--prompt-len", "20", "--new-tokens", "4",
         "--int8-kv"],
        capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=300)
    assert out.returncode == 0, out.stderr
    assert "arch=gemma3-12b kv=int8" in out.stdout
    assert "generated token ids (seq 0):" in out.stdout
