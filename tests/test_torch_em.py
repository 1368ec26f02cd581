"""The port's EM problems (``core/jensen.py``: Poisson EM and GMM EM) and
the SA-SSMM / FedMM / naive shims (``core/sassmm.py``, ``fedmm.py``,
``naive.py``) against the JAX package's, on the same numpy inputs.

Tolerance: ``RTOL, ATOL = 1e-5, 1e-6`` throughout (as in
``tests/test_torch_driver.py``): these are closed forms (a Cholesky, a
triangular solve, a logsumexp, a batched solve) with no iterative solver,
so the two packages differ in the last ulps only. The FedMM and naive
shims' ``step`` get the reference's participation mask and dither seeds
(``active=``, ``seeds=``); their ``run`` is compared end to end under full
participation and the identity compressor, where no draw enters.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fedmm as jfedmm
from repro.core import jensen as jjensen
from repro.core import naive as jnaive
from repro.core import sassmm as jsassmm
from repro.data import synthetic as jsyn
from repro_torch.core import fedmm as tfedmm
from repro_torch.core import jensen as tjensen
from repro_torch.core import naive as tnaive
from repro_torch.core import sassmm as tsassmm

from _torch_parity import assert_tree_close, round_draws, to_torch

KEY = jax.random.PRNGKey(0)
RTOL, ATOL = 1e-5, 1e-6


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_poisson_em():
    mean_z, lam = 3.0, 2.0
    jsur, tsur = (jjensen.make_poisson_em(mean_z, lam),
                  tjensen.make_poisson_em(mean_z, lam))
    h = np.random.default_rng(0).standard_normal(64).astype(np.float32)
    assert_tree_close(tsur.s_bar({"h": to_torch(h)}, None),
           jsur.s_bar({"h": jnp.asarray(h)}, None), msg="s_bar")
    s = np.array([-60.0, -3.0, -0.5, -1e-9, 0.2], np.float32)
    assert_tree_close(tsur.project(to_torch(s)), jsur.project(jnp.asarray(s)),
           msg="project")
    sp = s[:3]
    assert_tree_close(tsur.T(to_torch(sp)), jsur.T(jnp.asarray(sp)), msg="T")
    assert_tree_close(tjensen.poisson_em_metric(mean_z, lam)(to_torch(sp)),
           jjensen.poisson_em_metric(mean_z, lam)(jnp.asarray(sp)), msg="B")
    th = np.array([-1.0, 0.3], np.float32)
    assert_tree_close(tsur.psi(to_torch(th)), jsur.psi(jnp.asarray(th)), msg="psi")
    assert_tree_close(tsur.phi(to_torch(th)), jsur.phi(jnp.asarray(th)), msg="phi")


def _gmm(n=600, p=2, L=3, lam=0.01):
    means_true = np.array([[-4.0, 0.0], [0.0, 4.0], [4.0, 0.0]],
                          np.float32)[:L, :p]
    rng = np.random.default_rng(0)
    a = rng.standard_normal((L, p, p)).astype(np.float32) * 0.3
    covs = (np.eye(p, dtype=np.float32) + a @ a.transpose(0, 2, 1))
    weights = np.array([0.5, 0.3, 0.2], np.float32)[:L]
    z = np.asarray(jsyn.gmm_data(KEY, n, jnp.asarray(means_true),
                                 jnp.asarray(covs), jnp.asarray(weights)))
    jspec = jjensen.GMMSpec(weights=jnp.asarray(weights),
                            covs=jnp.asarray(covs), lam=lam)
    tspec = tjensen.GMMSpec(weights=to_torch(weights), covs=to_torch(covs),
                            lam=lam)
    return z, means_true, jspec, tspec


def test_gmm_em_oracle_T_loss():
    z, means_true, jspec, tspec = _gmm()
    jsur, tsur = jjensen.make_gmm_em(jspec), tjensen.make_gmm_em(tspec)
    means = means_true + 0.7
    js = jsur.s_bar(jnp.asarray(z), jnp.asarray(means))
    ts = tsur.s_bar(to_torch(z), to_torch(means))
    assert_tree_close(ts, js, msg="s_bar")
    assert_tree_close(tsur.T(to_torch(_np(js))), jsur.T(js), msg="T")
    assert_tree_close(tsur.project(to_torch(_np(js))), jsur.project(js), msg="project")
    assert_tree_close(tsur.loss({"z": to_torch(z)}, to_torch(means)),
           jsur.loss({"z": jnp.asarray(z)}, jnp.asarray(means)), msg="loss")
    assert_tree_close(tjensen.gmm_neg_loglik(to_torch(z), to_torch(means), tspec),
           jjensen.gmm_neg_loglik(jnp.asarray(z), jnp.asarray(means), jspec),
           msg="neg_loglik")


def test_gmm_em_oracle_under_vmap():
    """``api.step``'s ``client_mode="vmap"`` runs ``s_bar`` through
    ``torch.func.vmap``: per client, the same as one call each."""
    z, means_true, _, tspec = _gmm(n=600)
    tsur = tjensen.make_gmm_em(tspec)
    zc = to_torch(z.reshape(3, 200, 2))
    means = to_torch(means_true + 0.5)
    got = torch.func.vmap(lambda b: tsur.s_bar(b, means))(zc)
    for c in range(3):
        assert_tree_close({k: v[c] for k, v in got.items()}, tsur.s_bar(zc[c], means),
               msg=f"client {c}")


# ---------------------------------------------------------------------------
# the shims
# ---------------------------------------------------------------------------

def test_sassmm_shim_steps_and_run():
    """Full-batch EM steps (gamma = 1) and a run with a decaying schedule,
    against the reference's SA-SSMM on the same GMM data."""
    z, means_true, jspec, tspec = _gmm()
    jsur, tsur = jjensen.make_gmm_em(jspec), tjensen.make_gmm_em(tspec)
    s0 = _np(jsur.s_bar(jnp.asarray(z), jnp.asarray(means_true + 1.5)))
    jst = jsassmm.init(jsur, jax.tree.map(jnp.asarray, s0))
    tst = tsassmm.init(tsur, to_torch(s0), device="cpu")
    for _ in range(5):
        jst, jm = jsassmm.step(jsur, jst, jnp.asarray(z), 1.0)
        tst, tm = tsassmm.step(tsur, tst, to_torch(z), 1.0)
        assert_tree_close(tst.s_hat, jst.s_hat, msg="s_hat")
        assert int(tst.step) == int(jst.step)
    batches = np.split(z, 6)
    gam = jsassmm.decaying_stepsize(0.5)
    jst, jh = jsassmm.run(jsur, jax.tree.map(jnp.asarray, s0),
                          [jnp.asarray(b) for b in batches], gam)
    tst, th = tsassmm.run(tsur, to_torch(s0), [to_torch(b) for b in batches],
                          tsassmm.decaying_stepsize(0.5), device="cpu")
    assert_tree_close(tst.s_hat, jst.s_hat, msg="run s_hat")
    for k in ("e_s", "loss"):
        np.testing.assert_allclose([h[k] for h in th], [h[k] for h in jh],
                                   rtol=RTOL, atol=ATOL, err_msg=k)


def _gmm_clients(n_clients=3):
    z, means_true, jspec, tspec = _gmm(n=600)
    d = ((z[:, None] - means_true[None]) ** 2).sum(-1)
    comp = d.argmin(1)
    per = min(int((comp == c).sum()) for c in range(n_clients))
    clients = np.stack([z[comp == c][:per] for c in range(n_clients)])
    return z, clients, means_true, jspec, tspec


@pytest.mark.parametrize("which", ["fedmm", "naive"])
def test_fedmm_and_naive_shim_steps(which):
    """The shims' ``step`` against the reference's, with the reference's
    participation mask and seeds handed over (``active=``, ``seeds=``)."""
    z, clients, means_true, jspec, tspec = _gmm_clients()
    jsur, tsur = jjensen.make_gmm_em(jspec), tjensen.make_gmm_em(tspec)
    jmod, tmod = (jfedmm, tfedmm) if which == "fedmm" else (jnaive, tnaive)
    jcfg = jfedmm.FedMMConfig(n_clients=3, p=0.5, alpha=0.1)
    tcfg = tfedmm.FedMMConfig(n_clients=3, p=0.5, alpha=0.1)
    x0 = (_np(jsur.s_bar(jnp.asarray(z), jnp.asarray(means_true + 1.0)))
          if which == "fedmm" else means_true + 1.0)
    jst = jmod.init(jsur, jax.tree.map(jnp.asarray, x0), jcfg)
    tst = tmod.init(tsur, to_torch(x0), tcfg, device="cpu")
    aggregation = "surrogate" if which == "fedmm" else "parameter"
    jspec_f = jcfg.as_spec(aggregation)
    n_leaves = len(jax.tree.leaves(x0))
    key = KEY
    for t in range(4):
        gamma = np.float32(0.5 / np.sqrt(t + 1))
        key, k_round, _, active, seeds = round_draws(key, jspec_f, n_leaves)
        jst, jm = jmod.step(jsur, jst, jnp.asarray(clients), gamma, k_round,
                            jcfg)
        tst, tm = tmod.step(tsur, tst, to_torch(clients), torch.tensor(gamma),
                            None, tcfg, active=torch.tensor(active),
                            seeds=seeds, device="cpu")
        assert type(tst).__name__ == type(jst).__name__
        for f in jst._fields:
            assert_tree_close(getattr(tst, f), getattr(jst, f), msg=f"round {t} {f}")
        assert float(tm["n_active"]) == float(jm["n_active"])


@pytest.mark.parametrize("which", ["fedmm", "naive"])
def test_fedmm_and_naive_shim_runs(which):
    """The shims' ``run`` against the reference's, end to end, on the
    static GMM client data with full participation and the identity
    compressor (so no draw enters): the final state and every per-round
    metric, the movement diagnostics ``e_p_s`` (FedMM's mirror) and
    ``e_s_p`` (naive's cross-space diagnostic) among them."""
    z, clients, means_true, jspec, tspec = _gmm_clients()
    jsur, tsur = jjensen.make_gmm_em(jspec), tjensen.make_gmm_em(tspec)
    jcfg = jfedmm.FedMMConfig(n_clients=3, p=1.0, alpha=0.1)
    tcfg = tfedmm.FedMMConfig(n_clients=3, p=1.0, alpha=0.1)
    rounds, ev = 6, z[:256]
    gam = lambda t: 0.5 / np.sqrt(t)
    if which == "fedmm":
        s0 = _np(jsur.s_bar(jnp.asarray(z), jnp.asarray(means_true + 1.0)))
        jst, jh = jfedmm.run(jsur, jax.tree.map(jnp.asarray, s0),
                             lambda t, k: jnp.asarray(clients), gam, KEY, jcfg,
                             rounds, eval_batch=jnp.asarray(ev))
        tst, th = tfedmm.run(tsur, to_torch(s0),
                             lambda t, g: to_torch(clients), gam, 0, tcfg,
                             rounds, eval_batch=to_torch(ev), device="cpu")
        keys = ("loss", "e_s", "e_p_s", "h_norm_sq")
    else:
        th0 = means_true + 1.0
        diag = clients[:, :64]
        jst, jh = jnaive.run(jsur, jnp.asarray(th0),
                             lambda t, k: jnp.asarray(clients), gam, KEY, jcfg,
                             rounds, eval_batch=jnp.asarray(ev),
                             surrogate_diag_batches=jnp.asarray(diag))
        tst, th = tnaive.run(tsur, to_torch(th0),
                             lambda t, g: to_torch(clients), gam, 0, tcfg,
                             rounds, eval_batch=to_torch(ev),
                             surrogate_diag_batches=to_torch(diag),
                             device="cpu")
        keys = ("loss", "e_p", "e_s_p")
    for f in jst._fields:
        assert_tree_close(getattr(tst, f), getattr(jst, f), msg=f)
    for k in keys:
        np.testing.assert_allclose([h[k] for h in th], [h[k] for h in jh],
                                   rtol=RTOL, atol=ATOL, err_msg=k)


def test_control_variates_at_h():
    z, clients, means_true, jspec, tspec = _gmm_clients()
    jsur, tsur = jjensen.make_gmm_em(jspec), tjensen.make_gmm_em(tspec)
    s0 = _np(jsur.s_bar(jnp.asarray(z), jnp.asarray(means_true + 1.0)))
    cfg_j = jfedmm.FedMMConfig(n_clients=3)
    cfg_t = tfedmm.FedMMConfig(n_clients=3)
    assert_tree_close(tfedmm.init_control_variates_at_h(tsur, to_torch(s0),
                                              to_torch(clients), cfg_t),
           jfedmm.init_control_variates_at_h(
               jsur, jax.tree.map(jnp.asarray, s0), jnp.asarray(clients),
               cfg_j), msg="V_0")
