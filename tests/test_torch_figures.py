"""The paper's figure problem in the port against the JAX package:
dictionary learning (``core/variational.py``), FedMM and naive dictlearn
trajectories with the reference's draws, and the Fig. 1 / Fig. 2 harness
at a tiny size. The EM problems and the shims are in
``tests/test_torch_em.py``.

Tolerances, stated once:

- ``RTOL, ATOL = 1e-5, 1e-6`` (as in ``tests/test_torch_driver.py``)
  for the closed forms without an iterative solve: the dictlearn ``T`` and
  ``project``.
- ``RTOL_ISTA = 1e-4`` where ISTA's 100 iterations (dictlearn ``s_bar`` and
  ``loss``) and, across rounds, ``eigh`` in ``project_psd`` add up: XLA and
  PyTorch round each product differently in the last ulp, and those ulps
  compound. It holds the dictlearn trajectories' losses, and their states
  (x and the control variates) element by element within ``RTOL_ISTA`` of
  the element or of its leaf's largest element: an element that cancels
  to near zero carries the absolute error of its leaf's scale.
- The per-round movement ``e_s = ||x_{t+1} - x_t||^2 / gamma^2`` is a
  difference of two states about 100x larger than it, so the states' gap
  enters it amplified; it is held through the triangle inequality,
  ``|sqrt(e) - sqrt(e_ref)| <= (|dx_{t+1}| + |dx_t|) / gamma`` with the
  measured state gaps ``dx``, plus ``RTOL`` for its own rounding.
- ``block_quant(8, 128)``: with ``dither="hash"`` both packages draw the same
  dither, so a code differs only where a rounding edge falls within an ulp
  (one level, 1/127 of a group's scale); the loss is held at
  ``RTOL_ISTA``. With the default ``dither="uniform"`` the two packages draw
  independent dithers (threefry against a seeded ``torch.Generator``), so
  the trajectories are two draws of the same process: the loss is held per
  round within ``RTOL_UNIFORM = 2e-2`` (the gap measured at this size is
  below 0.4%, the quantizer's own noise).
"""
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.configs.dictlearn import SYNTH_HETEROGENEOUS as J_HET
from repro.core import compression as JC
from repro.core import variational as jvar
from repro.data import synthetic as jsyn
from repro_torch import api as tapi
from repro_torch.benchmarks import fig1_dictlearn as tfig1
from repro_torch.benchmarks import fig2_control_variates as tfig2
from repro_torch.configs.dictlearn import (MOVIELENS, SYNTH_HETEROGENEOUS,
                                           SYNTH_HOMOGENEOUS)
from repro_torch.core import compression as TC
from repro_torch.core import fedmm as tfedmm
from repro_torch.core import naive as tnaive
from repro_torch.core import sassmm as tsassmm
from repro_torch.core import variational as tvar

from _torch_parity import assert_tree_close, np_of, round_draws, to_torch

KEY = jax.random.PRNGKey(0)
RTOL, ATOL = 1e-5, 1e-6
RTOL_ISTA = 1e-4
RTOL_UNIFORM = 2e-2


def _close_leafwise(a, b, rtol, msg=""):
    """Each element within ``rtol`` of itself or of its leaf's largest."""
    la = jax.tree.leaves(jax.tree.map(np_of, a))
    lb = jax.tree.leaves(jax.tree.map(np_of, b))
    assert len(la) == len(lb), msg
    for x, y in zip(la, lb):
        np.testing.assert_allclose(x, y, rtol=rtol,
                                   atol=rtol * float(np.max(np.abs(y))),
                                   err_msg=msg)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _gap(a, b) -> float:
    """|| a - b || over all leaves, in float64."""
    la = jax.tree.leaves(jax.tree.map(np_of, a))
    lb = jax.tree.leaves(jax.tree.map(np_of, b))
    return float(np.sqrt(sum(np.sum((x.astype(np.float64) - y) ** 2)
                             for x, y in zip(la, lb))))


# ---------------------------------------------------------------------------
# problems
# ---------------------------------------------------------------------------

def _dictlearn(p=20, K=5, b=32, ista_iters=100):
    spec_kw = dict(p=p, K=K, lam=0.1, eta=0.2, ista_iters=ista_iters)
    jsur = jvar.make_dictlearn(jvar.DictLearnSpec(**spec_kw))
    tsur = tvar.make_dictlearn(tvar.DictLearnSpec(**spec_kw))
    z, _ = jsyn.dictlearn_data(KEY, b, p, K)
    theta = jax.random.normal(jax.random.PRNGKey(1), (p, K)) * 0.5
    return jsur, tsur, np.asarray(z), np.asarray(theta)


@pytest.mark.parametrize("batch_as", ["array", "dict"])
def test_dictlearn_oracle_and_loss(batch_as):
    jsur, tsur, z, theta = _dictlearn()
    jb, tb = ((jnp.asarray(z), to_torch(z)) if batch_as == "array"
              else ({"z": jnp.asarray(z)}, {"z": to_torch(z)}))
    assert_tree_close(tsur.s_bar(tb, to_torch(theta)), jsur.s_bar(jb, jnp.asarray(theta)),
           rtol=RTOL_ISTA, msg="s_bar")
    assert_tree_close(tsur.loss(tb, to_torch(theta)), jsur.loss(jb, jnp.asarray(theta)),
           rtol=RTOL_ISTA, msg="loss")
    assert_tree_close(tvar.sparse_code(to_torch(z), to_torch(theta),
                            tvar.DictLearnSpec(20, 5)),
           jvar.sparse_code(jnp.asarray(z), jnp.asarray(theta),
                            jvar.DictLearnSpec(20, 5)),
           rtol=RTOL_ISTA, msg="sparse_code")


def test_dictlearn_T_and_project():
    jsur, tsur, z, theta = _dictlearn()
    s = _np(jsur.s_bar(jnp.asarray(z), jnp.asarray(theta)))
    rng = np.random.default_rng(0)
    # a symmetric s1 pushed off the PSD cone, as quantization noise does
    off = rng.standard_normal((5, 5)).astype(np.float32)
    s_off = {"s1": s["s1"] + (off + off.T), "s2": s["s2"]}
    for name, ss in (("on-cone", s), ("off-cone", s_off)):
        assert_tree_close(tsur.T(to_torch(ss)), jsur.T(jax.tree.map(jnp.asarray, ss)),
               msg=f"T {name}")
        assert_tree_close(tsur.project(to_torch(ss)),
               jsur.project(jax.tree.map(jnp.asarray, ss)), atol=1e-5,
               msg=f"project {name}")
    w = torch.linalg.eigvalsh(tsur.project(to_torch(s_off))["s1"])
    assert float(w.min()) > -1e-5


# ---------------------------------------------------------------------------
# dictlearn trajectories with the reference's draws
# ---------------------------------------------------------------------------

P, K, N_CLIENTS, ROUNDS, BATCH = 20, 5, 4, 10, 16


def _trajectory(mode, aggregation, jcomp, tcomp):
    """Ten rounds of the reference's jitted ``step`` (its ``run`` without
    the scan) and of the port's ``api.step`` with the reference's mask,
    seeds and minibatches. Returns per-round (states, losses, movement)
    of both, and the schedule."""
    z, _ = jsyn.dictlearn_data(KEY, 400, P, K)
    clients = jsyn.balanced_kmeans_split(KEY, z, N_CLIENTS, n_iters=5)
    spec = dict(p=P, K=K, lam=0.1, eta=0.2, ista_iters=100)
    jp = japi.as_problem(jvar.make_dictlearn(jvar.DictLearnSpec(**spec)))
    tp = tapi.as_problem(tvar.make_dictlearn(tvar.DictLearnSpec(**spec)))
    theta0 = jax.random.normal(KEY, (P, K)) * 0.1
    x0 = (jp.s_bar(z[:128], theta0) if aggregation == "surrogate"
          else theta0)
    kw = dict(n_clients=N_CLIENTS, participation=0.5, alpha=0.01,
              aggregation=aggregation)
    jspec = japi.FederationSpec(compressor=jcomp, **kw)
    tspec = tapi.FederationSpec(compressor=tcomp, **kw)
    gammas = np.asarray(japi.resolve_schedule(
        lambda t: 0.02 / jnp.sqrt(0.02 + t), ROUNDS))
    batch_fn = jsyn.client_minibatch_fn(clients, BATCH)
    ev = z[:128]
    tev = to_torch(np.asarray(ev))
    mkey = "e_p" if aggregation == "parameter" else "e_s"
    jstep = jax.jit(lambda st, b, g, k: japi.step(jp, jspec, st, b, g, k,
                                                  client_mode=mode))

    def theta(prob, x):
        return x if aggregation == "parameter" else prob.T(x)

    jst = japi.init(jp, x0, jspec)
    tst = tapi.init(tp, to_torch(_np(x0)), tspec, device="cpu")
    out = {"j": [jst], "t": [tst], "jloss": [], "tloss": [], "jm": [],
           "tm": []}
    key, n_leaves = KEY, len(jax.tree.leaves(x0))
    for t in range(ROUNDS):
        key, k_round, k_batch, active, seeds = round_draws(key, jspec,
                                                           n_leaves)
        batch = batch_fn(t, k_batch)
        jst, jm = jstep(jst, batch, gammas[t], k_round)
        tst, tm = tapi.step(tp, tspec, tst, to_torch(np.asarray(batch)),
                            torch.tensor(gammas[t]), None,
                            active=torch.tensor(active), seeds=seeds,
                            device="cpu", client_mode=mode)
        out["j"].append(jst)
        out["t"].append(tst)
        out["jloss"].append(float(jp.loss(ev, theta(jp, jst.x))))
        out["tloss"].append(float(tp.loss(tev, theta(tp, tst.x))))
        out["jm"].append(float(jm[mkey]))
        out["tm"].append(float(tm[mkey]))
        assert float(tm["n_active"]) == float(jm["n_active"])
        assert float(tm["comm_bytes"]) == float(jm["comm_bytes"])
    return out, gammas


@pytest.mark.parametrize("aggregation", ["surrogate", "parameter"])
@pytest.mark.parametrize("mode", ["vmap", "scan"])
def test_dictlearn_trajectory_identity(mode, aggregation):
    """FedMM (surrogate) and naive (parameter) with the identity
    compressor: every round's state, variates and loss within
    ``RTOL_ISTA``; the movement through the state gaps (module doc)."""
    out, gammas = _trajectory(mode, aggregation, JC.identity(), TC.identity())
    gaps = []
    for t, (js, ts) in enumerate(zip(out["j"], out["t"])):
        for f in ("x", "v", "v_i"):
            _close_leafwise(getattr(ts, f), getattr(js, f), RTOL_ISTA,
                            msg=f"round {t} {f}")
        gaps.append(_gap(ts.x, js.x))
    np.testing.assert_allclose(out["tloss"], out["jloss"], rtol=RTOL_ISTA,
                               err_msg="loss")
    for t in range(ROUNDS):
        bound = (gaps[t + 1] + gaps[t]) / gammas[t]
        got, want = np.sqrt(out["tm"][t]), np.sqrt(out["jm"][t])
        assert abs(got - want) <= bound + RTOL * want, (t, got, want, bound)
    assert out["jloss"][-1] < out["jloss"][0]


@pytest.mark.parametrize("aggregation", ["surrogate", "parameter"])
@pytest.mark.parametrize("dither", ["hash", "uniform"])
def test_dictlearn_trajectory_block_quant(dither, aggregation):
    """``block_quant(8, 128)``, the figures' compressor: the loss of every
    round within ``RTOL_ISTA`` of the reference's for the shared hash
    dither, within ``RTOL_UNIFORM`` for the independent uniform dithers
    (module doc)."""
    out, _ = _trajectory("vmap", aggregation,
                         JC.block_quant(8, 128, dither=dither),
                         TC.block_quant(8, 128, dither=dither))
    rtol = RTOL_ISTA if dither == "hash" else RTOL_UNIFORM
    np.testing.assert_allclose(out["tloss"], out["jloss"], rtol=rtol,
                               err_msg="loss")


# ---------------------------------------------------------------------------
# the figure harness at a tiny size
# ---------------------------------------------------------------------------

def _tiny(exp, **kw):
    return dataclasses.replace(exp, n_clients=8, **kw)


def test_fig1_run_setting_tiny(monkeypatch):
    """Fig. 1's outcome on each setting at a tiny size (8 clients, 25
    rounds; MovieLens-like p 40, K 8): FedMM's loss falls and ends below
    the naive baseline's, every metric finite. On the synthetic
    heterogeneous setting the reference's ``run_setting`` at the same
    sizes gives the same outcome."""
    rounds = 25
    exps = (_tiny(SYNTH_HOMOGENEOUS, n_samples=120),
            _tiny(SYNTH_HETEROGENEOUS, n_samples=400),
            _tiny(MOVIELENS, p=40, K=8, n_samples=400))
    for exp in exps:
        out = tfig1.run_setting(exp, rounds=rounds, reduced=exp is not exps[2],
                                device="cpu")
        row = tfig1.summary(exp, out)
        assert all(np.isfinite(v) for k, v in row.items() if k != "setting")
        assert all(np.isfinite(h[k]) for hist in (out["fedmm"], out["naive"])
                   for h in hist for k in h), exp.name
        assert row["fedmm_loss_last"] < row["fedmm_loss_first"], row
        assert row["naive_loss_last"] > row["fedmm_loss_last"], row
        assert len(out["fedmm"]) == len(out["naive"]) == rounds
    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))
    from benchmarks import fig1_dictlearn as jfig1
    jout = jfig1.run_setting(_tiny(J_HET, n_samples=400), rounds=rounds)
    f, n = jout["fedmm"], jout["naive"]
    assert f[-1]["loss"] < f[0]["loss"] and n[-1]["loss"] > f[-1]["loss"]


def test_fig2_run_setting_tiny():
    """Fig. 2's outcome at a tiny size on the heterogeneous setting: alpha
    = 0.01 lowers the E^s tail against alpha = 0 and leaves the loss
    within 1%."""
    rounds = 36
    exp = _tiny(SYNTH_HETEROGENEOUS, n_samples=400)
    setting = tfig1.make_setting(exp, seed=0, reduced=True, device="cpu")
    h0, h1 = (tfig2.run_setting(exp, alpha=a, rounds=rounds, device="cpu",
                                setting=setting) for a in (0.0, 0.01))
    assert tfig2.es_tail(h1, rounds) < tfig2.es_tail(h0, rounds)
    assert abs(h1[-1]["loss"] - h0[-1]["loss"]) < 0.01 * h0[-1]["loss"]
    assert all(np.isfinite(h["e_s"]) and np.isfinite(h["loss"])
               for h in h0 + h1)


def test_make_setting_is_the_same_on_every_call():
    exp = _tiny(SYNTH_HETEROGENEOUS, n_samples=200)
    a = tfig1.make_setting(exp, seed=3, device="cpu")
    b = tfig1.make_setting(exp, seed=3, device="cpu")
    for x, y in zip(a[1:], b[1:]):
        assert torch.equal(x, y)
    assert tuple(a.clients.shape) == (8, 25, 50)
    assert a.spec.ista_iters == 50


def test_entry_points_default_to_the_gpu():
    """The figure scripts, the examples and the shims run on the GPU
    unless asked for the CPU; with no GPU they raise."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the defaults run there")
    from repro_torch.examples import federated_em_gmm, quickstart
    exp = _tiny(SYNTH_HOMOGENEOUS, n_samples=40)
    sur = tvar.make_dictlearn(tvar.DictLearnSpec(4, 2))
    s0 = {"s1": torch.eye(2), "s2": torch.zeros(4, 2)}
    for call in (lambda: tfig1.make_setting(exp),
                 lambda: tfig1.run_setting(exp, rounds=1),
                 lambda: tfig2.run_setting(exp, alpha=0.0, rounds=1),
                 lambda: quickstart.main(["--rounds", "1"]),
                 lambda: federated_em_gmm.main(["--rounds", "1"]),
                 lambda: tsassmm.init(sur, s0),
                 lambda: tfedmm.init(sur, s0, tfedmm.FedMMConfig(2)),
                 lambda: tnaive.init(sur, torch.zeros(4, 2),
                                     tfedmm.FedMMConfig(2))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
