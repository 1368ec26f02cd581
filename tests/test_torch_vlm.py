"""The port's vlm family (internvl2-26b: stub patch embeddings put before
the token embeddings, a causal ``attn_mlp`` stack over both) against the
JAX package on the CPU, reduced (2 layers, 8 patches, d_model 128,
float32); the checks and their tolerances are in
``tests/_torch_frontend.py``: prefill logits, the caches and four greedy
decode steps at positions past the patches at 1e-4 (bf16 and int8
caches), ``loss_fn`` (over the tokens' positions only) and its gradient,
the interop round trip, a bf16 build's weights bit for bit, decode
against the port's own prefill at 5e-3, two trainer rounds against the
reference's, and the serve and train entry points on the CPU.
"""
import jax.numpy as jnp
import numpy as np
import torch

import _torch_frontend as FE
from _torch_frontend import SRV
from repro_torch import interop

ARCH = "internvl2-26b"


def test_prefill_cache_and_greedy_decode_match():
    FE.check_prefill_and_decode(ARCH)


def test_int8_cache_prefill_and_decode_match():
    """The int8 KV cache: prefill's logits at 1e-4, its codes within one
    step and its scales within one bf16 step of the reference's, then four
    greedy decode steps, each from the reference's cache carried across
    (a code on a rounding tie may round the other way: one of 3,584 here
    moves the next logits by 2.3e-4, where the same cache gives 6e-7),
    the logits at 1e-4 and the cache slot written as the reference
    writes it."""
    jmodel, jparams, _, tmodel, tparams = SRV._pair(ARCH, kv_dtype="int8")
    cfg, S, P = tmodel.cfg, SRV.S, tmodel.cfg.n_frontend_tokens
    key, arr = FE.frontend(cfg, (SRV.B,), 5)
    toks = SRV._tokens(cfg.vocab)
    jlogits, jcache = jmodel.prefill(
        jparams, {"tokens": jnp.asarray(toks), key: jnp.asarray(arr)},
        cache_len=P + S + SRV.NEW)
    tlogits, tcache = tmodel.prefill(
        tparams, {"tokens": torch.tensor(toks), key: torch.tensor(arr)},
        cache_len=P + S + SRV.NEW)
    np.testing.assert_allclose(SRV.np_of(tlogits), np.asarray(jlogits),
                               **SRV.F32_TOL)

    def crossed(jc):
        return [{k: interop.to_torch(np.asarray(v[i]), device="cpu")
                 for k, v in jc[0].items()} for i in range(cfg.n_layers)]

    def codes_close(got, want):
        for g, w in zip(got, want):
            for k in ("k", "v"):
                assert int((g[k].int() - w[k].int()).abs().max()) <= 1, k
            for k in ("k_scale", "v_scale"):
                torch.testing.assert_close(g[k].float(), w[k].float(),
                                           rtol=1e-2, atol=0)

    codes_close(tcache, crossed(jcache))
    tok = jnp.argmax(jlogits[..., :cfg.vocab], -1).astype(jnp.int32)
    for i in range(SRV.NEW):
        pos = P + S + i
        tlogits, tcache = tmodel.decode(tparams, crossed(jcache),
                                        torch.tensor(np.asarray(tok)), pos)
        jlogits, jcache = jmodel.decode(jparams, jcache, tok,
                                        jnp.asarray(pos, jnp.int32))
        np.testing.assert_allclose(SRV.np_of(tlogits), np.asarray(jlogits),
                                   **SRV.F32_TOL)
        codes_close(tcache, crossed(jcache))
        tok = jnp.argmax(jlogits[..., :cfg.vocab], -1).astype(jnp.int32)


def test_loss_fn_value_and_grad_match_reference():
    FE.check_loss_and_grads(ARCH)


def test_model_params_round_trip():
    FE.check_round_trip(ARCH)


def test_bfloat16_weights_cross_bit_for_bit():
    FE.check_bfloat16(ARCH)


def test_decode_agrees_with_its_prefill():
    FE.check_decode_consistency(ARCH)


def test_init_cache_matches_prefill_layout():
    FE.check_init_cache_layout(ARCH)


def test_prefill_flash_calls(monkeypatch):
    """One causal flash call per layer over the patches and the tokens."""
    cfg, calls = FE.flash_calls(monkeypatch, ARCH)
    n = cfg.n_frontend_tokens + SRV.S + 1
    assert calls == [(n, n, True)] * cfg.n_layers


def test_train_step_matches_reference():
    FE.check_trainer_round(ARCH, use_cv=False)


def test_serve_cli_runs_on_the_cpu():
    FE.check_serve_cli(ARCH)


def test_launch_train_main_runs_on_the_cpu():
    FE.check_launch_train(ARCH)
