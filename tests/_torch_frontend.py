"""The checks that hold the port's frontend families (audio: whisper-base's
encoder-decoder; vlm: internvl2-26b's patch prefix) against the JAX
package on the CPU, shared by ``tests/test_torch_whisper.py`` and
``tests/test_torch_vlm.py``. Reduced configs (2 decoder layers, whisper's
2 encoder layers, 8 frontend tokens, d_model 128, float32); the frontend
arrays and the tokens come from a numpy seed and are handed to both
packages. Tolerances: the serve path's ``F32_TOL`` (1e-4) and
``CONSISTENCY_TOL`` (5e-3) and its bf16 one (``tests/test_torch_serve.py``);
the loss within 1e-5 relative and each gradient leaf within 1e-4 of its
largest entry, the trainer's trajectory at ``assert_tree_close``'s
defaults (``tests/test_torch_train.py``).
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import api as japi
from repro.fed import trainer as JFT
from repro_torch import interop
from repro_torch.fed import trainer as TFT
from repro_torch.kernels import ops
from repro_torch.models.layers import params_tree
from repro_torch.models import model as TM
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

from _torch_parity import assert_bits_equal, assert_tree_close, client_seeds
import test_torch_serve as SRV
import test_torch_train as TRN


def frontend(cfg, lead, seed):
    """(batch key, float32 numpy (*lead, F, d) * 0.02) for ``cfg``'s family,
    as its ``make_batch`` draws them."""
    key = TM.FRONTEND_KEYS[cfg.family]
    arr = np.random.default_rng(seed).standard_normal(
        tuple(lead) + (cfg.n_frontend_tokens, cfg.d_model))
    return key, (0.02 * arr).astype(np.float32)


def batches(cfg, toks, seed):
    """(..., S + 1) tokens and a frontend from ``seed`` -> the reference's
    and the port's batches."""
    jb, tb = TRN._batches(toks)
    key, arr = frontend(cfg, toks.shape[:-1], seed)
    jb[key], tb[key] = jnp.asarray(arr), torch.tensor(arr)
    return jb, tb


def check_prefill_and_decode(aid):
    """Prefill logits and every cache leaf, then four greedy decode steps
    (equal ids, logits at 1e-4), at vlm's offset positions."""
    cfg = SRV._cfgs(aid)[1]
    SRV._check_prefill_and_decode(aid, frontend=frontend(cfg, (SRV.B,), 5),
                                  n_prefix=TM.n_prefix(cfg))


def check_loss_and_grads(aid, S=21):
    """``loss_fn`` and its gradient (the encoder's leaves too, for audio)
    against ``jax.value_and_grad``, at a sequence off the xent's chunk."""
    jm, tm, jp, tp = TRN._models(aid)
    jb, tb = batches(jm.cfg, TRN._tokens((2, S + 1), jm.cfg.vocab, 3), 6)
    jl, jg = jax.value_and_grad(jm.loss_fn)(jp, jb)
    leaves, treedef = tree_flatten(tp)
    live = [x.clone().requires_grad_() for x in leaves]
    tl = tm.loss_fn(tree_unflatten(treedef, live), tb)
    grads = torch.autograd.grad(tl, live)
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    back = interop.model_params_to_numpy(
        tm.cfg, tree_unflatten(treedef, list(grads)))
    jg = jax.tree.map(np.asarray, jg)
    assert jax.tree.structure(back) == jax.tree.structure(jg)
    TRN._grad_close(back, jg, msg=aid)
    return back


def check_round_trip(aid, **changes):
    """Reference weights -> the port's per-layer trees -> back, bit for
    bit, at 4 decoder layers (and the ``changes``)."""
    jcfg, tcfg = TRN._configs(aid, n_layers=4, **changes)
    jp = jax.tree.map(np.asarray,
                      TRN.j_build(jcfg).init(jax.random.PRNGKey(1)))
    tp = interop.model_params_to_torch(tcfg, jp, device="cpu")
    back = interop.model_params_to_numpy(tcfg, tp)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    return tp


def check_bfloat16(aid):
    """A bf16 build: every weight (the encoder's too) crosses bit for bit,
    and the prefill's logits agree within the reference's bf16
    tolerance."""
    jmodel, jparams, np_params, tmodel, tparams = SRV._pair(
        aid, dtype="bfloat16")
    want = jax.tree.leaves(interop._unstack(tmodel.cfg, np_params))
    got = tree_leaves(params_tree(tparams))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and b.dtype.name == "bfloat16"
        assert_bits_equal(SRV._bits16(a), SRV._bits16(b))
    toks = SRV._tokens(jmodel.cfg.vocab, seed=1)
    key, arr = frontend(jmodel.cfg, (SRV.B,), 7)
    jlogits, _ = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks),
                                          key: jnp.asarray(arr)})
    tlogits, _ = tmodel.prefill(tparams, {"tokens": torch.tensor(toks),
                                          key: torch.tensor(arr)})
    assert tlogits.dtype == torch.bfloat16
    np.testing.assert_allclose(SRV._f32(tlogits), SRV._f32(jlogits),
                               **SRV.BF16_TOL)


def check_decode_consistency(aid, prompts=(SRV.S, SRV.S - 3)):
    """decode(prefill(x[:S]), x[S]) against prefill(x[:S + 1])'s last
    logits, the frontend the same in both, within 5e-3, at the port's
    own weights."""
    model, params, batch = SRV._port(aid)
    toks, n_prefix = batch["tokens"], TM.n_prefix(model.cfg)
    key = TM.FRONTEND_KEYS[model.cfg.family]
    for S in prompts:
        _, cache = model.prefill(params, {"tokens": toks[:, :S],
                                          key: batch[key]},
                                 cache_len=n_prefix + S + 8)
        got, _ = model.decode(params, cache, toks[:, S:S + 1], n_prefix + S)
        want, _ = model.prefill(params, {"tokens": toks[:, :S + 1],
                                         key: batch[key]})
        np.testing.assert_allclose(got.numpy(), want.numpy(),
                                   **SRV.CONSISTENCY_TOL)


def check_init_cache_layout(aid):
    """``init_cache(B, cache_len)`` is prefill's layout: vlm's cache_len
    counts the patches, audio's ek/ev hold the frames."""
    model, params, batch = SRV._port(aid)
    cache_len = TM.n_prefix(model.cfg) + SRV.S + 3
    _, cache = model.prefill(params, batch, cache_len=cache_len)
    zero = model.init_cache(SRV.B, cache_len)
    assert len(cache) == len(zero) == model.cfg.n_layers
    for got, want in zip(cache, zero):
        assert {k: (v.shape, v.dtype) for k, v in got.items()} == \
            {k: (v.shape, v.dtype) for k, v in want.items()}


def flash_calls(monkeypatch, aid):
    """The flash calls of one prefill, as (Sq, Sk, causal) from
    ``ops.flash_attention``'s arguments (the CPU takes the plain version,
    which counts no launch)."""
    calls = []
    orig = ops.flash_attention

    def spy(q, k, v, causal=True, window=0, **kw):
        calls.append((q.shape[1], k.shape[1], causal))
        return orig(q, k, v, causal=causal, window=window, **kw)

    monkeypatch.setattr(ops, "flash_attention", spy)
    model, params, batch = SRV._port(aid)
    model.prefill(params, batch)
    return model.cfg, calls


def check_trainer_round(aid, use_cv=True):
    """Two rounds of the FedMM LM trainer (identity compressor) against the
    reference's, its draws handed over, every client's batch with its
    frontend: losses within 1e-5, the iterate and variates at
    ``assert_tree_close``'s tolerance."""
    jm, tm, jf, tf, js = TRN._trainer_pair(aid, quant_bits=0, use_cv=use_cv)
    ts = TRN._to_port_state(tm.cfg, js)
    jstep = jax.jit(JFT.make_train_step(jm, jf))
    tstep = TFT.make_train_step(tm, tf)
    n_leaves = len(tree_leaves(ts.s_hat))
    for t in range(2):
        k = jax.random.PRNGKey(50 + t)
        gamma = 0.5 / (1.0 + t) ** 0.5
        jb, tb = batches(jm.cfg, TRN._tokens(
            (TRN.N_CLIENTS, TRN.B_LOCAL, TRN.SEQ + 1), jm.cfg.vocab, 10 + t),
            20 + t)
        js, jmet = jstep(js, jb, k, gamma)
        active, qkeys = japi.participation_draw(k, jf.federation_spec())
        ts, tmet = tstep(ts, tb, None, gamma, active=np.asarray(active),
                         seeds=client_seeds(qkeys, n_leaves))
        assert abs(float(tmet["loss"]) - float(jmet["loss"])) <= \
            1e-5 * abs(float(jmet["loss"])), t
        want = TRN._to_port_state(tm.cfg, js)
        assert_tree_close(ts.s_hat, want.s_hat, msg=f"s_hat round {t}")
        if use_cv:
            assert_tree_close(ts.v, want.v, msg=f"v round {t}")
            assert_tree_close(ts.v_i, want.v_i, msg=f"v_i round {t}")
    return ts


def check_serve_cli(aid):
    """``python -m repro_torch.launch.serve --device cpu --arch A`` (the
    smoke preset) to its end."""
    env = dict(os.environ, PYTHONPATH=str(SRV.ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", aid, "--batch", "2", "--prompt-len", "8",
         "--new-tokens", "3"],
        capture_output=True, text=True, env=env, cwd=str(SRV.ROOT),
        timeout=300)
    assert out.returncode == 0, out.stderr
    assert "generated token ids (seq 0):" in out.stdout


def check_launch_train(aid):
    """``launch.train.main`` at the smoke preset on the CPU: finite losses,
    all clients active, and a finite final iterate."""
    from repro_torch.launch import train as ttrain
    out = ttrain.main(["--device", "cpu", "--preset", "smoke", "--arch", aid,
                       "--steps", "3", "--seq", "32", "--log-every", "3"])
    losses = [m["loss"] for m in out["history"]]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert all(m["n_active"] == 4 for m in out["history"])
    assert all(bool(torch.isfinite(x).all())
               for x in tree_leaves(out["state"].s_hat))
    return out["state"]
