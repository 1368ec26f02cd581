"""Training with the port (ROADMAP Queue A item 11b) against the JAX
reference, on the CPU at small sizes: the chunked cross-entropy, the
model's ``loss_fn`` and its gradient against ``jax.value_and_grad``, the
token streams, the FedMM LM trainer's rounds (``fed/trainer.py``), its
helpers and the ``launch.train`` entry point.

Weights cross with ``interop.model_params_to_torch`` and gradients come
back with ``interop.model_params_to_numpy``; the trainer's state crosses
with ``interop.fedlm_state_to_torch``. Tolerances: the loss within 1e-5
relative, each gradient leaf within 1e-4 of its largest entry (+1e-6):
both sides compute in float32, the sums in another order. The trainer's
trajectory with the identity compressor at ``assert_tree_close``'s rtol
1e-5 / atol 1e-6; with ``block_quant(8, 256, "hash")`` each round, from
the reference's state, within one quantization level per group (the
port's per-leaf dither seeds are its own: it keeps one tree per layer
where the reference stacks a cycle's layers into one leaf).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro import api as japi
from repro.data.synthetic import token_stream as j_token_stream
from repro.fed import trainer as JFT
from repro.models.model import build_model as j_build

import repro_torch.configs as TC
from repro_torch import interop
from repro_torch.core import compression as TCMP
from repro_torch.data.synthetic import token_logits, token_stream
from repro_torch.fed import trainer as TFT
from repro_torch.launch import train as ttrain
from repro_torch.models import layers as TL
from repro_torch.models.model import build_model as t_build
from repro_torch.tree import (tree_flatten, tree_leaves, tree_map,
                              tree_unflatten)

from _torch_parity import (assert_gaps, assert_tree_close, client_seeds,
                           spy_reference_moe_gaps)

ARCHS = ["phi3-medium-14b", "gemma3-12b", "rwkv6-3b"]
N_CLIENTS, B_LOCAL, SEQ = 4, 2, 24
JAMBA = "jamba-1.5-large-398b"
# the hybrid patterns: jamba's reduced() ([mamba_mlp, attn_moe]) and layers
# 4-7 of its first period ([mamba_mlp, mamba_moe, mamba_mlp, attn_moe])
HYBRID = {"reduced": {}, "four-layer": dict(n_layers=4, attn_every=4)}


def _configs(arch, **kw):
    return (dataclasses.replace(JC.get(arch).reduced(), **kw),
            dataclasses.replace(TC.get(arch).reduced(), **kw))


def _models(arch, **kw):
    jcfg, tcfg = _configs(arch, **kw)
    jm, tm = j_build(jcfg), t_build(tcfg, device="cpu")
    jp = jm.init(jax.random.PRNGKey(0))
    tp = TL.params_tree(interop.model_params_to_torch(
        tcfg, jax.tree.map(np.asarray, jp), device="cpu"))
    return jm, tm, jp, tp


def _tokens(shape, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape)


def _batches(toks):
    """(..., S + 1) tokens -> the reference's and the port's batches."""
    j = {"tokens": jnp.asarray(toks[..., :-1], jnp.int32),
         "labels": jnp.asarray(toks[..., 1:], jnp.int32)}
    t = {"tokens": torch.tensor(toks[..., :-1]),
         "labels": torch.tensor(toks[..., 1:])}
    return j, t


def _grad_close(got, want, msg=""):
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-4 * np.abs(w).max() + 1e-6,
                                   err_msg=msg)


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,vocab", [(300, 500), (128, 512), (60, 384)],
                         ids=["remainder-padded", "one-chunk", "short"])
def test_chunked_softmax_xent_value_and_grad(S, vocab):
    """Value and gradient (x and the head) against the reference, with a
    remainder chunk (300 = 2 x 128 + 44) and a padded vocab (500 -> 512)."""
    from repro.models import layers as JLm
    jcfg, tcfg = _configs("phi3-medium-14b", vocab=vocab)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    head = (0.05 * rng.standard_normal((jcfg.padded_vocab, jcfg.d_model))
            ).astype(np.float32)
    labels = rng.integers(0, vocab, (2, S))

    def jloss(x, head):
        return JLm.chunked_softmax_xent({"lm_head": head}, x,
                                        jnp.asarray(labels, jnp.int32), jcfg)

    jl, (jgx, jgh) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(head))
    tx = torch.tensor(x, requires_grad=True)
    th = torch.tensor(head, requires_grad=True)
    tl = TL.chunked_softmax_xent({"lm_head": th}, tx, torch.tensor(labels),
                                 tcfg)
    gx, gh = torch.autograd.grad(tl, (tx, th))
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    _grad_close([gx.numpy(), gh.numpy()], [jgx, jgh])
    # without autograd: the same value, no checkpoint
    with torch.no_grad():
        assert torch.equal(TL.chunked_softmax_xent(
            {"lm_head": th}, tx, torch.tensor(labels), tcfg), tl.detach())


@pytest.mark.parametrize("arch,S", [("phi3-medium-14b", 40),
                                    ("gemma3-12b", 40), ("gemma3-12b", 12),
                                    ("rwkv6-3b", 40),
                                    ("qwen3-moe-235b-a22b", 40)])
def test_loss_fn_value_and_grad_match_reference(arch, S):
    """The port's ``loss_fn`` and its ``torch.autograd`` gradient against
    ``jax.value_and_grad`` of the reference's: dense, sliding-window
    (gemma3's [swa_mlp, attn_mlp], window 16, S above and below it),
    rwkv6 and qwen3's MoE (the loss with its 0.01 x balance term)."""
    jm, tm, jp, tp = _models(arch)
    jb, tb = _batches(_tokens((2, S + 1), jm.cfg.vocab, 3))
    jl, jg = jax.value_and_grad(jm.loss_fn)(jp, jb)
    leaves, treedef = tree_flatten(tp)
    live = [x.clone().requires_grad_() for x in leaves]
    tl = tm.loss_fn(tree_unflatten(treedef, live), tb)
    grads = torch.autograd.grad(tl, live)
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    back = interop.model_params_to_numpy(
        tm.cfg, tree_unflatten(treedef, list(grads)))
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, jg))
    _grad_close(back, jg, msg=arch)


@pytest.mark.parametrize("pattern", sorted(HYBRID))
def test_hybrid_loss_fn_value_and_grad_match_reference(monkeypatch,
                                                       pattern):
    """jamba's ``loss_fn`` and its gradient (every Mamba leaf, ``A_log``
    in float32 among them) against ``jax.value_and_grad``, at an odd
    sequence length (the reference scans in chunks of 1 there), with the
    reference's top-k gap asserted at each MoE call."""
    gaps = spy_reference_moe_gaps(monkeypatch)
    jm, tm, jp, tp = _models(JAMBA, **HYBRID[pattern])
    jb, tb = _batches(_tokens((2, 25 + 1), jm.cfg.vocab, 4))
    jl, jg = jax.value_and_grad(jm.loss_fn)(jp, jb)
    assert_gaps(gaps)
    leaves, treedef = tree_flatten(tp)
    live = [x.clone().requires_grad_() for x in leaves]
    tl = tm.loss_fn(tree_unflatten(treedef, live), tb)
    grads = torch.autograd.grad(tl, live)
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    back = interop.model_params_to_numpy(
        tm.cfg, tree_unflatten(treedef, list(grads)))
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, jg))
    _grad_close(back, jg, msg=pattern)


# ---------------------------------------------------------------------------
# interop round trips
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["gemma3-12b", "rwkv6-3b",
                                  "qwen3-moe-235b-a22b", JAMBA])
def test_model_params_round_trip(arch):
    jcfg, tcfg = _configs(arch, n_layers=4)
    jp = jax.tree.map(np.asarray, j_build(jcfg).init(jax.random.PRNGKey(1)))
    back = interop.model_params_to_numpy(
        tcfg, interop.model_params_to_torch(tcfg, jp, device="cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_fedlm_state_round_trip():
    """The reference's ``FedLMState`` (v_i client-stacked on the cycle-
    stacked layout) -> the port's per-layer trees -> back, bit for bit;
    empty variates become ``()``."""
    jcfg, tcfg = _configs("gemma3-12b", n_layers=4)
    jm = j_build(jcfg)
    for use_cv in (True, False):
        fc = JFT.FedLMConfig(n_clients=3, use_cv=use_cv, quant_bits=0)
        js = JFT.init_state(jm, jax.random.PRNGKey(2), fc)
        js = js._replace(v_i=jax.tree.map(
            lambda x: x + jnp.arange(3, dtype=x.dtype).reshape(
                (3,) + (1,) * (x.ndim - 1)), js.v_i))
        np_state = jax.tree.map(np.asarray, js)
        ts = interop.fedlm_state_to_torch(tcfg, np_state, device="cpu")
        assert isinstance(ts, TFT.FedLMState)
        back = interop.model_params_to_numpy(tcfg, ts.s_hat)
        for a, b in zip(jax.tree.leaves(back),
                        jax.tree.leaves(np_state.s_hat)):
            assert np.array_equal(a, b)
        if not use_cv:
            assert ts.v == () and ts.v_i == ()
            continue
        for c in range(3):
            row = tree_map(lambda x, c=c: x[c], ts.v_i)
            back = interop.model_params_to_numpy(tcfg, row)
            want = jax.tree.map(lambda x, c=c: x[c], np_state.v_i)
            for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
                assert np.array_equal(a, b)


# ---------------------------------------------------------------------------
# token streams
# ---------------------------------------------------------------------------

def _reference_logits(n_clients, vocab, client_skew=0.8):
    """The reference's per-client logits: the body of its
    ``token_stream``'s ``one``, in jnp."""
    def one(c):
        base = 1.0 / (jnp.arange(vocab) + 10.0)
        center = (c + 0.5) / n_clients * vocab
        width = vocab / n_clients / (1.0 - client_skew + 1e-3)
        boost = jnp.exp(-0.5 * ((jnp.arange(vocab) - center) / width) ** 2)
        return jnp.log(base + client_skew * boost)
    return np.asarray(jax.vmap(one)(jnp.arange(n_clients)))


@pytest.mark.parametrize("n,vocab", [(2, 512), (4, 32768), (1, 1000)])
def test_token_logits_match_reference(n, vocab):
    want = _reference_logits(n, vocab)
    got = token_logits(n, vocab).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_token_stream_draws_follow_the_logits():
    """The port's draws and the reference's follow the same per-row
    distribution: each row's histogram over 8 bins within 0.03 (total
    variation) of softmax(logits), and the rows' bands order their
    means."""
    n, vocab, S = 4, 512, 20000
    probs = torch.softmax(token_logits(n, vocab), -1).reshape(n, 8, -1)
    want = probs.sum(-1).numpy()
    ours = token_stream(torch.Generator().manual_seed(0), n, S, vocab)
    theirs = np.asarray(j_token_stream(jax.random.PRNGKey(0), n, S, vocab))
    assert tuple(ours.shape) == (n, S) and ours.dtype == torch.int64
    assert int(ours.min()) >= 0 and int(ours.max()) < vocab
    for draws in (ours.numpy(), theirs):
        hist = np.stack([np.bincount(row // (vocab // 8), minlength=8) / S
                         for row in draws])
        assert np.abs(hist - want).sum(-1).max() / 2 < 0.03
        means = draws.mean(-1)
        assert np.all(np.diff(means) > 0)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

def _trainer_pair(arch, model_kw=None, **fkw):
    jm, tm, jp, tp = _models(arch, **(model_kw or {}))
    jf = JFT.FedLMConfig(n_clients=N_CLIENTS, rho=0.05, client_mode="logical",
                         **fkw)
    tf = TFT.FedLMConfig(n_clients=N_CLIENTS, rho=0.05, client_mode="logical",
                         **fkw)
    js = JFT.init_state(jm, jax.random.PRNGKey(0), jf)
    return jm, tm, jf, tf, js


def _to_port_state(tcfg, js):
    return interop.fedlm_state_to_torch(tcfg, jax.tree.map(np.asarray, js),
                                        device="cpu")


def _round_batches(t, vocab):
    return _batches(_tokens((N_CLIENTS, B_LOCAL, SEQ + 1), vocab, 10 + t))


def _n_leaves(tree):
    return len(tree_leaves(tree))


@pytest.mark.parametrize("arch", ["phi3-medium-14b", "rwkv6-3b",
                                  "qwen3-moe-235b-a22b"])
def test_train_step_identity_matches_reference(arch):
    """Three free rounds with the identity compressor: the port's
    trajectory (iterate, variates) and losses follow the reference's."""
    jm, tm, jf, tf, js = _trainer_pair(arch, quant_bits=0)
    ts = _to_port_state(tm.cfg, js)
    jstep = jax.jit(JFT.make_train_step(jm, jf))
    tstep = TFT.make_train_step(tm, tf)
    key = jax.random.PRNGKey(5)
    n_leaves = _n_leaves(ts.s_hat)
    for t in range(3):
        key, k = jax.random.split(key)
        gamma = 0.5 / (1.0 + t) ** 0.5
        jb, tb = _round_batches(t, jm.cfg.vocab)
        js, jmet = jstep(js, jb, k, gamma)
        active, qkeys = japi.participation_draw(k, jf.federation_spec())
        ts, tmet = tstep(ts, tb, None, gamma, active=np.asarray(active),
                         seeds=client_seeds(qkeys, n_leaves))
        assert abs(float(tmet["loss"]) - float(jmet["loss"])) <= \
            1e-5 * abs(float(jmet["loss"])), t
        assert float(tmet["n_active"]) == float(jmet["n_active"])
        want = _to_port_state(tm.cfg, js)
        assert_tree_close(ts.s_hat, want.s_hat, msg=f"s_hat round {t}")
        assert_tree_close(ts.v, want.v, msg=f"v round {t}")
        assert_tree_close(ts.v_i, want.v_i, msg=f"v_i round {t}")
    assert int(ts.step) == 3


@pytest.mark.parametrize("pattern", sorted(HYBRID))
def test_hybrid_train_step_matches_reference(monkeypatch, pattern):
    """jamba: two rounds with the identity compressor and control
    variates, the reference's draws handed over, and the reference's
    top-k gap asserted at each MoE call of its clients."""
    gaps = spy_reference_moe_gaps(monkeypatch)
    jm, tm, jf, tf, js = _trainer_pair(JAMBA, HYBRID[pattern], quant_bits=0)
    ts = _to_port_state(tm.cfg, js)
    jstep = jax.jit(JFT.make_train_step(jm, jf))
    tstep = TFT.make_train_step(tm, tf)
    n_leaves = _n_leaves(ts.s_hat)
    for t in range(2):
        k = jax.random.PRNGKey(40 + t)
        gamma = 0.5 / (1.0 + t) ** 0.5
        jb, tb = _round_batches(t, jm.cfg.vocab)
        js, jmet = jstep(js, jb, k, gamma)
        active, qkeys = japi.participation_draw(k, jf.federation_spec())
        ts, tmet = tstep(ts, tb, None, gamma, active=np.asarray(active),
                         seeds=client_seeds(qkeys, n_leaves))
        assert abs(float(tmet["loss"]) - float(jmet["loss"])) <= \
            1e-5 * abs(float(jmet["loss"])), t
        want = _to_port_state(tm.cfg, js)
        assert_tree_close(ts.s_hat, want.s_hat, msg=f"s_hat round {t}")
        assert_tree_close(ts.v, want.v, msg=f"v round {t}")
        assert_tree_close(ts.v_i, want.v_i, msg=f"v_i round {t}")
    assert_gaps(gaps)


def _level_bound(problem, tf, ts, tb, block=256):
    """Per element, the largest quantization level (group max-abs / 127)
    of any client's drift this round, from the port's own drifts."""
    view = TFT.T_map(ts.s_hat, tf)
    bound = None
    for c in range(N_CLIENTS):
        batch = {k: v[c] for k, v in tb.items()}
        s_c = problem.s_bar(batch, view)
        leaves = []
        for s, x, v in zip(tree_leaves(s_c), tree_leaves(ts.s_hat),
                           tree_leaves(ts.v_i)):
            d = s - x - v[c]
            D = d.shape[-1]
            g = TCMP.group_size(D, block)
            if d.ndim == 0 or g < 2:
                leaves.append(torch.zeros_like(d))
                continue
            grp = d.reshape(d.shape[:-1] + (D // g, g)).abs().amax(
                -1, keepdim=True) / 127.0
            leaves.append(grp.expand(d.shape[:-1] + (D // g, g)).reshape(
                d.shape))
        bound = leaves if bound is None else [torch.maximum(a, b) for a, b
                                              in zip(bound, leaves)]
    return bound


def test_train_step_hash_dither_within_one_level():
    """``block_quant(8, 256, "hash")``: each of three rounds, run from the
    reference's state on both sides, lands the port's iterate within
    gamma times one quantization level of each group of the reference's
    (the codes differ: the port seeds its own leaves), and the control
    variates within alpha times that level."""
    jm, tm, jf, tf, js = _trainer_pair("phi3-medium-14b", quant_bits=8)
    assert tf.federation_spec().compressor.name.startswith("block_quant")
    jstep = jax.jit(JFT.make_train_step(jm, jf))
    tstep = TFT.make_train_step(tm, tf)
    problem = TFT.make_problem(tm, tf)
    key = jax.random.PRNGKey(7)
    for t in range(3):
        ts = _to_port_state(tm.cfg, js)
        key, k = jax.random.split(key)
        gamma = 0.5 / (1.0 + t) ** 0.5
        jb, tb = _round_batches(t, jm.cfg.vocab)
        bound = _level_bound(problem, tf, ts, tb)
        js, jmet = jstep(js, jb, k, gamma)
        _, qkeys = japi.participation_draw(k, jf.federation_spec())
        ts, tmet = tstep(ts, tb, None, gamma,
                         active=np.ones(N_CLIENTS, bool),
                         seeds=client_seeds(qkeys, _n_leaves(ts.s_hat)))
        want = _to_port_state(tm.cfg, js)
        assert float(tmet["comm_bytes"]) == float(jmet["comm_bytes"])
        for name, got_t, want_t, coef in (
                ("s_hat", ts.s_hat, want.s_hat, gamma),
                ("v", ts.v, want.v, tf.alpha)):
            for got, ref, lvl in zip(tree_leaves(got_t), tree_leaves(want_t),
                                     bound):
                slack = 1e-5 * ref.abs() + 1e-6
                assert bool(((got - ref).abs() <= coef * lvl * 1.001
                             + slack).all()), (name, t)


def test_server_momentum_in_trainer_config_matches_reference():
    """``FedLMConfig(server_momentum=)``: the momentum buffer starts at
    zero, and two rounds (identity compressor) follow the reference's
    iterate and buffer."""
    jm, tm, jf, tf, js = _trainer_pair("phi3-medium-14b", quant_bits=0,
                                       server_momentum=0.7)
    ts = _to_port_state(tm.cfg, js)
    own = TFT.init_state(tm, torch.Generator().manual_seed(0), tf)
    assert all(float(x.abs().max()) == 0.0 for x in tree_leaves(own.opt))
    assert _n_leaves(own.opt) == _n_leaves(own.s_hat)
    jstep = jax.jit(JFT.make_train_step(jm, jf))
    tstep = TFT.make_train_step(tm, tf)
    n_leaves = _n_leaves(ts.s_hat)
    for t in range(2):
        k = jax.random.PRNGKey(20 + t)
        jb, tb = _round_batches(t, jm.cfg.vocab)
        js, _ = jstep(js, jb, k, 0.4)
        _, qkeys = japi.participation_draw(k, jf.federation_spec())
        ts, _ = tstep(ts, tb, None, 0.4, active=np.ones(N_CLIENTS, bool),
                      seeds=client_seeds(qkeys, n_leaves))
    want = _to_port_state(tm.cfg, js)
    assert_tree_close(ts.s_hat, want.s_hat, msg="s_hat")
    assert_tree_close(ts.opt, want.opt, msg="momentum")
    assert float(max(x.abs().max() for x in tree_leaves(ts.opt))) > 0.0


def test_no_variates_mode_drops_its_state():
    """``use_cv=False``: no V and no V_i, before and after rounds, and the
    iterate follows the reference's."""
    jm, tm, jf, tf, js = _trainer_pair("gemma3-12b", quant_bits=0,
                                       use_cv=False)
    assert tf.federation_spec().variates == "off"
    ts = TFT.init_state(tm, torch.Generator().manual_seed(0), tf)
    assert ts.v == () and ts.v_i == () and ts.opt == ()
    ts = _to_port_state(tm.cfg, js)
    assert ts.v == () and ts.v_i == ()
    tstep = TFT.make_train_step(tm, tf)
    jstep = jax.jit(JFT.make_train_step(jm, jf))
    n_leaves = _n_leaves(ts.s_hat)
    for t in range(2):
        k = jax.random.PRNGKey(30 + t)
        jb, tb = _round_batches(t, jm.cfg.vocab)
        js, _ = jstep(js, jb, k, 0.5)
        _, qkeys = japi.participation_draw(k, jf.federation_spec())
        ts, m = tstep(ts, tb, None, 0.5, active=np.ones(N_CLIENTS, bool),
                      seeds=client_seeds(qkeys, n_leaves))
        assert ts.v == () and ts.v_i == ()
        assert np.isfinite(float(m["loss"]))
    assert_tree_close(ts.s_hat, _to_port_state(tm.cfg, js).s_hat)


def test_t_map_choose_client_layout_and_param_count():
    tf = TFT.FedLMConfig(n_clients=2, rho=0.05, weight_decay=0.1)
    jf = JFT.FedLMConfig(n_clients=2, rho=0.05, weight_decay=0.1)
    rng = np.random.default_rng(4)
    tree = {"a": rng.standard_normal((3, 5)).astype(np.float32),
            "b": [rng.standard_normal(7).astype(np.float32)]}
    want = jax.tree.map(np.asarray, JFT.T_map(
        jax.tree.map(jnp.asarray, tree), jf))
    got = TFT.T_map(jax.tree.map(torch.tensor, tree), tf)
    assert_tree_close(got, want, rtol=0, atol=0)
    for n in (1e9, 2.0e10, 2.1e10, 1.5e11, 1.6e11, 4e11):
        for multi in (False, True):
            assert TFT.choose_client_layout(n, multi) == \
                JFT.choose_client_layout(n, multi)
    for arch in ARCHS:
        jcfg, tcfg = _configs(arch)
        assert TFT.param_count(t_build(tcfg, device="cpu")) == \
            JFT.param_count(j_build(jcfg))
    # full width, counted without drawing a weight
    assert TFT.param_count(t_build(TC.get("gemma3-12b"), device="cpu")) == \
        JFT.param_count(j_build(JC.get("gemma3-12b")))


def test_physical_mode_with_a_mesh_raises():
    """What the trainer refuses on a mesh: a mesh that is not a
    ``DeviceMesh`` (``TypeError``) and logical clients on one
    (``ValueError``, as the reference's ``api.step`` refuses its sequential
    mode on a mesh); physical silos take it (``tests/test_torch_train_
    mesh.py`` runs them), and without a mesh run in sequence, as
    logical."""
    import datetime
    import socket
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    _, tm, _, tf, _ = _trainer_pair("phi3-medium-14b", quant_bits=0)
    physical = dataclasses.replace(tf, client_mode="physical")
    with pytest.raises(TypeError, match="DeviceMesh"):
        TFT.make_train_step(tm, physical, mesh=object())
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("clients",))
        with pytest.raises(ValueError, match="logical"):
            TFT.make_train_step(tm, tf, mesh=mesh)
        TFT.make_train_step(tm, physical, mesh=mesh)
    finally:
        dist.destroy_process_group()
    TFT.make_train_step(tm, physical)


def test_launch_train_main_loss_falls():
    """The entry point on the CPU: the smoke preset trains with a falling
    loss (the reference's CLI run: 6.2713 -> 6.2543 over 20 steps for
    gemma3-12b) and returns its final state."""
    out = ttrain.main(["--device", "cpu", "--preset", "smoke", "--arch",
                       "gemma3-12b", "--steps", "8", "--seq", "64",
                       "--log-every", "4"])
    losses = [m["loss"] for m in out["history"]]
    assert len(losses) == 8 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert all(m["n_active"] == 4 for m in out["history"])
    assert int(out["state"].step) == 8
    assert all(bool(torch.isfinite(x).all())
               for x in tree_leaves(out["state"].s_hat))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,cols", [(300, 3840), (40, 2560), (400, 192)])
def test_small_group_kernel_route_matches_reference(monkeypatch, dtype,
                                                    rows, cols):
    """A shard-safe leaf at LM width whose group is below 128 (D = 3840
    gives 8, as gemma3's embedding; 2560 gives 16; 192 gives 2) reaches
    the encode and quantize kernel wrappers (their plain versions here),
    where the reference takes jnp, and gives the reference's codes, scales
    and ``apply`` bit for bit."""
    from repro.core import compression as JCMP
    from _torch_parity import assert_bits_equal, folded_seed
    calls = []
    for name in ("quantize_encode_grouped", "quantize_grouped"):
        def spy(*a, _orig=getattr(TCMP.kernel_ops.qb, name), _name=name,
                **kw):
            calls.append((_name, kw["group"]))
            return _orig(*a, **kw)
        monkeypatch.setattr(TCMP.kernel_ops.qb, name, spy)
    x = np.random.default_rng(3).standard_normal((rows, cols)).astype(
        np.float32)
    jx = jnp.asarray(x, dtype)
    tx = interop.to_torch(np.asarray(jx), device="cpu")
    key = jax.random.PRNGKey(11)
    seed = folded_seed(jax.random.split(key, 1)[0])
    jc = JCMP.block_quant(8, 256, dither="hash", shard_safe=True)
    tc = TCMP.block_quant(8, 256, dither="hash", shard_safe=True)
    g = TCMP.group_size(cols, 256)
    jp = jc.encode(key, {"e": jx})["e"]
    tp = tc.encode([seed], {"e": tx})["e"]
    ja = jc.apply(key, {"e": jx})["e"]
    ta = tc.apply([seed], {"e": tx})["e"]
    assert g < 128 and sorted(calls) == sorted(
        [("quantize_encode_grouped", g), ("quantize_grouped", g)])
    assert_bits_equal(tp.codes, np.asarray(jp.codes))
    assert_bits_equal(tp.scales, np.asarray(jp.scales))

    def bits(t):
        return t.view(torch.int16 if t.dtype == torch.bfloat16
                      else torch.int32)

    assert torch.equal(bits(ta), bits(interop.to_torch(np.asarray(ja),
                                                       device="cpu")))
    assert torch.equal(bits(tc.decode({"e": tp})["e"]), bits(ta))
