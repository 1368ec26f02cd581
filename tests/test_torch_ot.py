"""FedMM-OT in the port against the JAX package: the optimizers
(``optim/optimizers.py``), the ICNN potentials, the OT objectives, the
Gaussian ground truth and L2-UVP, Algorithm 3 and the FedAdam baseline
(``core/fedmm_ot.py``), the state carried across by
``interop.ot_state_to_torch``, and Fig. 3's ``run_dim`` at a tiny size.

Both packages get the same inputs (numpy from a seed, or the reference's
own draws carried across as numpy). Tolerances, stated once:

- ``RTOL, ATOL = 1e-5, 1e-6`` (as in ``tests/test_torch_driver.py``) for
  every single evaluation: an optimizer step, the potential, its input
  gradient, the objectives and their parameter gradients (second order
  through the input gradient), one client oracle, one server update, one
  round, ``l2_uvp``. XLA and PyTorch sum in other orders, and the
  softplus' derivative is ``exp(x - softplus(x))`` in JAX and
  ``sigmoid(x)`` here: last-ulp differences.
- ``RTOL_EIGH = 1e-4`` for ``gaussian_ot_map``'s matrix, which goes
  through two ``eigh`` and an ``inv`` (LAPACK in both, called in other
  ways), and for the pushforward identity, the reference test's own.
- ``RTOL_TRAJ`` for trajectories: the rounds are deterministic given the
  data and the initial potentials (p = 1, identity compressor), but each
  round takes 5 SGD and 10 Adam steps, and Adam divides the gradient by
  its running magnitude, so where a gradient element is small the ulps
  above are amplified. Measured on a CPU: the 10-round FedMM-OT
  trajectory's L2-UVP within 3e-6 relative, its potentials within 2e-5
  relative of their leaf's largest element; FedAdam's three rounds and
  ``run_dim``'s curves within 1e-5. The limit is 1e-4.
"""
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import fedmm_ot as jot
from repro.optim import optimizers as jopt
from repro_torch import api as tapi
from repro_torch import interop
from repro_torch.benchmarks import fig3_ot as tfig3
from repro_torch.core import fedmm_ot as tot
from repro_torch.optim import optimizers as topt

from _torch_parity import assert_tree_close, np_of, to_torch

RTOL, ATOL = 1e-5, 1e-6
RTOL_EIGH = 1e-4
RTOL_TRAJ = 1e-4
KEY = jax.random.PRNGKey(0)
D, HIDDEN, SC, LAM = 4, (16, 16, 16), 0.3, 4.0
N_CLIENTS, N_LOCAL, N_Q = 4, 32, 64
ROUNDS = 10


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _specs(d=D, hidden=HIDDEN, sc=SC):
    return (jot.ICNNSpec(dim=d, hidden=hidden, strong_convexity=sc),
            tot.ICNNSpec(dim=d, hidden=hidden, strong_convexity=sc))


def _cfgs(n_clients=N_CLIENTS):
    kw = dict(n_clients=n_clients, p=1.0, alpha=0.01, lam=LAM,
              client_lr=2e-2, client_steps=5, server_steps=10,
              server_lr=5e-3)
    return jot.FedOTConfig(**kw), tot.FedOTConfig(**kw)


def _ref_problem(d=D, key=KEY):
    """The reference Fig. 3 data at a small size, and the same as tensors
    (the true map rebuilt from the reference's matrix)."""
    from benchmarks import fig3_ot as jfig3
    prob = jfig3.make_problem(d, key, n_clients=N_CLIENTS,
                              n_per_client=N_LOCAL, n_q=N_Q)
    return prob, _torch_problem(prob, d, key)


def _torch_problem(prob, d, key):
    """The port's view of a reference ``make_problem`` dict: its arrays
    carried across, and its true map rebuilt from the matrix the
    reference's ``make_problem`` solves for with the same key."""
    k1, k2, _, _ = jax.random.split(key, 4)
    a1 = jax.random.normal(k1, (d, d)) * 0.3
    a2 = jax.random.normal(k2, (d, d)) * 0.3
    cov_p, cov_q = a1 @ a1.T + jnp.eye(d), a2 @ a2.T + 0.5 * jnp.eye(d)
    m_p, m_q = jnp.zeros(d), jnp.ones(d) * 0.5
    _, A = jot.gaussian_ot_map(m_p, cov_p, m_q, cov_q)
    # the rebuilt map is the reference's own
    x = np.asarray(prob["x_eval"][:8])
    np.testing.assert_array_equal(np.asarray(prob["true_map"](x)),
                                  np.asarray(m_q + (x - m_p) @ A.T))
    out = {k: to_torch(np.asarray(prob[k]))
           for k in ("cov_q", "client_x", "y_q", "x_eval")}
    out["true_map"] = tot.affine_map(*(to_torch(np.asarray(a))
                                       for a in (m_p, m_q, A)))
    return out


def _rand_tree(rng, shapes):
    return {k: rng.normal(size=s).astype(np.float32)
            for k, s in shapes.items()}


SHAPES = {"a": (5, 3), "b": (7,), "c": (2, 2, 2)}


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
@pytest.mark.parametrize("count0", [0, 998])
def test_adam_update(weight_decay, count0):
    """Several Adam steps from a fresh state and from one at count 998, so
    the bias corrections run to count 1,001 in float32 (b2 ** 1001)."""
    rng = np.random.default_rng(1)
    params = _rand_tree(rng, SHAPES)
    m0, v0 = _rand_tree(rng, SHAPES), _rand_tree(rng, SHAPES)
    v0 = {k: np.abs(v) * 0.1 for k, v in v0.items()}
    if count0 == 0:
        m0 = {k: np.zeros_like(v) for k, v in m0.items()}
        v0 = {k: np.zeros_like(v) for k, v in v0.items()}
    js = jopt.AdamState(m=m0, v=v0, count=jnp.asarray(count0, jnp.int32))
    ts = topt.AdamState(m=to_torch(m0), v=to_torch(v0),
                        count=torch.tensor(count0, dtype=torch.int32))
    jp, tp = params, to_torch(params)
    for _ in range(3):
        g = _rand_tree(rng, SHAPES)
        jp, js = jopt.adam_update(jp, g, js, 5e-3, weight_decay=weight_decay)
        tp, ts = topt.adam_update(tp, to_torch(g), ts, 5e-3,
                                  weight_decay=weight_decay)
        assert_tree_close(tp, jp, RTOL, ATOL)
        assert_tree_close((ts.m, ts.v), (js.m, js.v), RTOL, ATOL)
    assert ts.count.dtype == torch.int32
    assert int(ts.count) == int(js.count) == count0 + 3


def test_adam_init_and_bias_correction_in_float32():
    """A fresh state is zero with an int32 count; at count 1,000 the
    bias correction is the reference's float32 one."""
    st = topt.adam_init(to_torch(_rand_tree(np.random.default_rng(0),
                                            SHAPES)))
    assert st.count.dtype == torch.int32 and int(st.count) == 0
    assert all(float(torch.abs(x).max()) == 0.0 for x in st.m.values())
    t = torch.tensor(1000, dtype=torch.int32).to(torch.float32)
    c2 = float(1 - torch.pow(0.999, t))
    c2_ref = float(1 - 0.999 ** jnp.asarray(1000, jnp.int32).astype(
        jnp.float32))
    assert c2 == pytest.approx(c2_ref, rel=1e-6, abs=0)


@pytest.mark.parametrize("beta", [0.0, 0.9])
def test_sgd_update(beta):
    rng = np.random.default_rng(2)
    params = _rand_tree(rng, SHAPES)
    jp, js = params, jopt.sgd_init(params)
    tp = to_torch(params)
    ts = topt.sgd_init(tp)
    for _ in range(4):
        g = _rand_tree(rng, SHAPES)
        jp, js = jopt.sgd_update(jp, g, js, 0.1, beta=beta)
        tp, ts = topt.sgd_update(tp, to_torch(g), ts, 0.1, beta=beta)
        assert_tree_close(tp, jp, RTOL, ATOL)
        assert_tree_close(ts.momentum, js.momentum, RTOL, ATOL)


def test_cosine_schedule():
    jlr, tlr = (m.cosine_schedule(3e-3, 10, 100) for m in (jopt, topt))
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(float(tlr(step)), float(jlr(step)),
                                   rtol=RTOL, atol=1e-9)


# ---------------------------------------------------------------------------
# the ICNN
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def potentials():
    """Two reference potentials (numpy) and inputs."""
    jspec, _ = _specs()
    k1, k2 = jax.random.split(KEY)
    rng = np.random.default_rng(3)
    return {"omega": _np(jot.icnn_init(k1, jspec)),
            "theta": _np(jot.icnn_init(k2, jspec)),
            "x": rng.normal(size=(32, D)).astype(np.float32),
            "y": (rng.normal(size=(24, D)) * 1.5 + 0.5).astype(np.float32)}


def test_icnn_init_structure():
    """The port's draw has the reference's leaves, in its order, with
    the reference's scales: 1/sqrt(fan-in) weights, zero biases."""
    jspec, tspec = _specs(hidden=(64, 64, 64))
    ref = jot.icnn_init(KEY, jspec)
    got = tot.icnn_init(torch.Generator().manual_seed(0), tspec,
                        device="cpu")
    jl = jax.tree.leaves(ref)
    tl = jax.tree.leaves(jax.tree.map(np_of, got))
    assert [a.shape for a in tl] == [a.shape for a in jl]
    assert set(got) == {"Wx", "Wz", "b", "w_out"}
    for w, fan_in in zip(got["Wx"] + got["Wz"], (D, D, D, 64, 64)):
        assert 0.7 < float(w.std()) * fan_in ** 0.5 < 1.3
    assert all(float(torch.abs(b).max()) == 0.0 for b in got["b"])


def test_icnn_forward_and_grad(potentials):
    jspec, tspec = _specs()
    om = potentials["omega"]
    x = potentials["x"]
    np.testing.assert_allclose(
        np_of(tot.icnn_forward(to_torch(om), tspec, to_torch(x))),
        np.asarray(jot.icnn_forward(om, jspec, x)), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        np_of(tot.icnn_grad(to_torch(om), tspec, to_torch(x))),
        np.asarray(jot.icnn_grad(om, jspec, x)), rtol=RTOL, atol=ATOL)
    # the input gradient is autograd's of the potential
    xt = to_torch(x).requires_grad_(True)
    g, = torch.autograd.grad(tot.icnn_forward(to_torch(om), tspec, xt).sum(),
                             xt)
    np.testing.assert_allclose(
        np_of(tot.icnn_grad(to_torch(om), tspec, to_torch(x))), np_of(g),
        rtol=RTOL, atol=ATOL)


def test_softplus_is_logaddexp_past_the_threshold():
    """Pre-activations far above torch's softplus threshold (20): the
    potential and its gradient still match the reference's."""
    jspec, tspec = _specs()
    om = _np(jot.icnn_init(KEY, jspec))
    x = (np.random.default_rng(4).normal(size=(8, D)) * 40).astype(
        np.float32)
    np.testing.assert_allclose(
        np_of(tot.icnn_forward(to_torch(om), tspec, to_torch(x))),
        np.asarray(jot.icnn_forward(om, jspec, x)), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        np_of(tot.icnn_grad(to_torch(om), tspec, to_torch(x))),
        np.asarray(jot.icnn_grad(om, jspec, x)), rtol=RTOL, atol=ATOL)


def test_icnn_is_convex_along_segments():
    """``tests/test_fedmm_ot.py``'s convexity check, on the port."""
    _, tspec = _specs(sc=0.1)
    params = tot.icnn_init(torch.Generator().manual_seed(0), tspec,
                           device="cpu")
    gen = torch.Generator().manual_seed(1)
    x, y = torch.randn((32, D), generator=gen), torch.randn((32, D),
                                                            generator=gen)
    for lam in (0.25, 0.5, 0.75):
        mid = tot.icnn_forward(params, tspec, lam * x + (1 - lam) * y)
        bound = (lam * tot.icnn_forward(params, tspec, x)
                 + (1 - lam) * tot.icnn_forward(params, tspec, y))
        assert bool(torch.all(mid <= bound + 1e-5))


def test_icnn_grad_shape_and_strong_monotonicity():
    """``tests/test_fedmm_ot.py``'s check: <g(x) - g(y), x - y> >= m
    ||x - y||^2 for the strong convexity m."""
    tspec = tot.ICNNSpec(dim=3, strong_convexity=0.5)
    params = tot.icnn_init(torch.Generator().manual_seed(0), tspec,
                           device="cpu")
    x = torch.randn((8, 3), generator=torch.Generator().manual_seed(2))
    g = tot.icnn_grad(params, tspec, x)
    assert tuple(g.shape) == (8, 3)
    y = x + 0.1
    inner = torch.sum((g - tot.icnn_grad(params, tspec, y)) * (x - y), -1)
    assert bool(torch.all(inner >= 0.5 * torch.sum((x - y) ** 2, -1) - 1e-5))


# ---------------------------------------------------------------------------
# the objectives
# ---------------------------------------------------------------------------

def test_objectives_and_parameter_gradients(potentials):
    """W_i and the conjugate objective, and their gradients with respect
    to both potentials' parameters (second order through icnn_grad)."""
    jspec, tspec = _specs()
    om, th, x, y = (potentials[k] for k in ("omega", "theta", "x", "y"))
    tom, tth, tx, ty = map(to_torch, (om, th, x, y))

    def jloc(w, t):
        return jot.local_objective(w, t, jspec, x, y, LAM)

    def tloc(w, t):
        return tot.local_objective(w, t, tspec, tx, ty, LAM)

    def jconj(w, t):
        return jot.conjugate_objective(w, t, jspec, y, LAM)

    def tconj(w, t):
        return tot.conjugate_objective(w, t, tspec, ty, LAM)

    for jf, tf in ((jloc, tloc), (jconj, tconj)):
        np.testing.assert_allclose(float(tf(tom, tth)), float(jf(om, th)),
                                   rtol=RTOL, atol=ATOL)
        jg = jax.jit(jax.grad(jf, argnums=(0, 1)))(om, th)
        tg = torch.func.grad(tf, argnums=(0, 1))(tom, tth)
        assert_tree_close(tg, jg, RTOL, ATOL)


# ---------------------------------------------------------------------------
# the Gaussian ground truth and L2-UVP
# ---------------------------------------------------------------------------

def _gaussians(d=3, key=KEY):
    k1, k2 = jax.random.split(key)
    a1 = jax.random.normal(k1, (d, d)) * 0.4
    a2 = jax.random.normal(k2, (d, d)) * 0.4
    return (np.zeros(d, np.float32), np.asarray(a1 @ a1.T + jnp.eye(d)),
            np.ones(d, np.float32), np.asarray(a2 @ a2.T + 0.5 * jnp.eye(d)))


def test_gaussian_ot_map():
    """Pushforward covariance A S_p A^T = S_q, A symmetric positive
    definite, and A and the map within ``RTOL_EIGH`` of the reference's."""
    m_p, cov_p, m_q, cov_q = _gaussians()
    jmap, jA = jot.gaussian_ot_map(m_p, cov_p, m_q, cov_q)
    tmap, tA = tot.gaussian_ot_map(*map(to_torch, (m_p, cov_p, m_q, cov_q)))
    A = np_of(tA)
    np.testing.assert_allclose(A @ cov_p @ A.T, cov_q, rtol=RTOL_EIGH,
                               atol=1e-5)
    np.testing.assert_allclose(A, A.T, atol=1e-5)
    assert float(np.linalg.eigvalsh(A).min()) > 0.0
    np.testing.assert_allclose(A, np.asarray(jA), rtol=RTOL_EIGH, atol=1e-5)
    x = np.random.default_rng(5).normal(size=(16, 3)).astype(np.float32)
    np.testing.assert_allclose(np_of(tmap(to_torch(x))),
                               np.asarray(jmap(x)), rtol=RTOL_EIGH,
                               atol=1e-5)


def test_l2_uvp():
    m_p, cov_p, m_q, cov_q = _gaussians()
    tmap, _ = tot.gaussian_ot_map(*map(to_torch, (m_p, cov_p, m_q, cov_q)))
    x = np.random.default_rng(6).normal(size=(64, 3)).astype(np.float32)
    assert float(tot.l2_uvp(tmap, tmap, to_torch(x), to_torch(cov_q))) == 0.0
    shift = np.float32(0.3)
    want = jot.l2_uvp(lambda xx: xx + shift, lambda xx: xx * 1.1, x, cov_q)
    got = tot.l2_uvp(lambda xx: xx + shift, lambda xx: xx * 1.1,
                     to_torch(x), to_torch(cov_q))
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


# ---------------------------------------------------------------------------
# Algorithm 3 and FedAdam
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ot_setup():
    """The reference's data and FedMM-OT / FedAdam initial states at a
    small size (as ``benchmarks/fig3_ot.run_dim`` draws them from one
    key), and the port's copies."""
    jspec, tspec = _specs()
    jcfg, tcfg = _cfgs()
    prob, tprob = _ref_problem()
    st0 = jot.init(KEY, jspec, jcfg)
    fa0 = jot.fedadam_init(KEY, jspec)
    return dict(jspec=jspec, tspec=tspec, jcfg=jcfg, tcfg=tcfg, prob=prob,
                tprob=tprob, st0=st0, fa0=fa0,
                tst0=interop.ot_state_to_torch(_np(st0), tot.FedOTState,
                                               device="cpu"),
                tfa0=interop.ot_state_to_torch(_np(fa0), tot.FedAdamState,
                                               device="cpu"))


def test_ot_state_to_torch(ot_setup):
    """The reference's states become the port's NamedTuples, leaf for
    leaf."""
    tst, tfa = ot_setup["tst0"], ot_setup["tfa0"]
    assert type(tst) is tot.FedOTState and type(tfa) is tot.FedAdamState
    assert type(tst.theta_opt) is topt.AdamState
    assert type(tfa.opt) is topt.AdamState
    assert tst.theta_opt.count.dtype == torch.int32
    assert_tree_close(tuple(tst), tuple(_np(ot_setup["st0"])), 0, 0)
    assert_tree_close(tuple(tfa), tuple(_np(ot_setup["fa0"])), 0, 0)
    # the FedAdam moments follow the iterate's sorted-key order
    assert list(tfa.opt.m) == ["omega", "theta"]


def test_s_bar_and_server_step(ot_setup):
    """One client's relaxed best response (5 SGD steps) and one conjugate
    update (10 Adam steps) against the reference's."""
    s = ot_setup
    jprob = jot.make_ot_problem(s["jspec"], s["jcfg"], s["prob"]["y_q"])
    tprob = tot.make_ot_problem(s["tspec"], s["tcfg"], s["tprob"]["y_q"])
    st0, tst0 = s["st0"], s["tst0"]
    x1 = s["prob"]["client_x"][1]
    want = jax.jit(jprob.s_bar)(x1, (st0.omega, st0.theta))
    got = tprob.s_bar(s["tprob"]["client_x"][1], (tst0.omega, tst0.theta))
    assert_tree_close(got, want, RTOL, ATOL)
    (jth, jopt_), _ = jax.jit(jprob.server_step)(
        (st0.theta, st0.theta_opt), want)
    (tth, topt_), _ = tprob.server_step((tst0.theta, tst0.theta_opt),
                                        to_torch(_np(want)))
    assert_tree_close(tth, jth, RTOL, ATOL)
    assert_tree_close((topt_.m, topt_.v), (jopt_.m, jopt_.v), RTOL, ATOL)
    assert int(topt_.count) == int(jopt_.count) == s["tcfg"].server_steps


def test_one_step(ot_setup):
    """One FedMM-OT round through the shim, with the reference's state."""
    s = ot_setup
    jst, jm = jax.jit(lambda st: jot.step(
        st, s["jspec"], s["jcfg"], s["prob"]["client_x"], s["prob"]["y_q"],
        1.0, KEY))(s["st0"])
    tst, tm = tot.step(s["tst0"], s["tspec"], s["tcfg"],
                       s["tprob"]["client_x"], s["tprob"]["y_q"], 1.0,
                       torch.Generator().manual_seed(0), device="cpu")
    assert type(tst) is tot.FedOTState
    for f in ("omega", "theta", "v", "v_i"):
        assert_tree_close(getattr(tst, f), getattr(jst, f), RTOL, ATOL,
                          msg=f)
    assert_tree_close(tst.theta_opt.m, jst.theta_opt.m, RTOL, ATOL)
    assert int(tst.step) == 1
    np.testing.assert_allclose(float(tm["omega_update"]),
                               float(jm["omega_update"]), rtol=RTOL)


def _rel_to_leaf_max(a, b, rtol, msg=""):
    for x, y in zip(jax.tree.leaves(jax.tree.map(np_of, a)),
                    jax.tree.leaves(jax.tree.map(np_of, b))):
        np.testing.assert_allclose(x, y, rtol=rtol,
                                   atol=rtol * float(np.max(np.abs(y))),
                                   err_msg=msg)


def test_fedmm_ot_trajectory(ot_setup):
    """10 FedMM-OT rounds on the drivers from the reference's initial
    state and data, L2-UVP every round: each round's L2-UVP and the final
    potentials within ``RTOL_TRAJ``."""
    s = ot_setup
    jprob = jot.make_ot_problem(s["jspec"], s["jcfg"], s["prob"]["y_q"],
                                uvp_eval=(s["prob"]["true_map"],
                                          s["prob"]["cov_q"]))
    jst, jh = japi.run(jprob, s["st0"].omega, s["prob"]["client_x"], 1.0,
                       spec=jot.ot_federation_spec(s["jcfg"]), key=KEY,
                       n_rounds=ROUNDS, eval_batch=s["prob"]["x_eval"],
                       eval_every=1, state0=jot.to_driver(s["st0"]))
    tprob = tot.make_ot_problem(s["tspec"], s["tcfg"], s["tprob"]["y_q"],
                                uvp_eval=(s["tprob"]["true_map"],
                                          s["tprob"]["cov_q"]))
    tst, th = tapi.run(tprob, s["tst0"].omega, s["tprob"]["client_x"], 1.0,
                       spec=tot.ot_federation_spec(s["tcfg"]), key=0,
                       n_rounds=ROUNDS, eval_batch=s["tprob"]["x_eval"],
                       state0=tot.to_driver(s["tst0"]), device="cpu")
    juvp = np.asarray(jh["loss"])
    np.testing.assert_allclose(np_of(th["loss"]), juvp, rtol=RTOL_TRAJ)
    assert juvp[-1] < juvp[0]
    _rel_to_leaf_max(tst.x, jst.x, RTOL_TRAJ, "omega")
    _rel_to_leaf_max(tst.aux[0], jst.aux[0], RTOL_TRAJ, "theta")
    _rel_to_leaf_max((tst.v, tst.v_i), (jst.v, jst.v_i), RTOL_TRAJ, "v")


def test_fedadam_rounds_with_the_reference_masks(ot_setup):
    """Three FedAdam rounds at p = 0.6, each with the reference's active
    set handed in: the parameters and Adam state within ``RTOL_TRAJ``."""
    s = ot_setup
    jfa, tfa = s["fa0"], s["tfa0"]
    jstep = jax.jit(lambda st, k: jot.fedadam_step(
        st, s["jspec"], s["prob"]["client_x"], s["prob"]["y_q"], lam=LAM,
        lr=5e-3, key=k, p=0.6))
    masks = []
    for t in range(3):
        k = jax.random.PRNGKey(t + 1)
        active = np.asarray(jax.random.bernoulli(k, 0.6, (N_CLIENTS,)))
        masks.append(active)
        jfa = jstep(jfa, k)
        tfa = tot.fedadam_step(tfa, s["tspec"], s["tprob"]["client_x"],
                               s["tprob"]["y_q"], lam=LAM, lr=5e-3,
                               key=torch.Generator().manual_seed(t), p=0.6,
                               active=torch.tensor(active), device="cpu")
        assert type(tfa) is tot.FedAdamState
        _rel_to_leaf_max((tfa.omega, tfa.theta), (jfa.omega, jfa.theta),
                         RTOL_TRAJ, f"round {t}")
        _rel_to_leaf_max(tfa.opt.m, jfa.opt.m, RTOL_TRAJ, f"m round {t}")
    assert int(tfa.opt.count) == int(jfa.opt.count) == 3
    # the draws exercised a partial round
    assert any(not m.all() for m in masks) and all(m.any() for m in masks)


def test_fedadam_draws_its_own_mask():
    """Without ``active=`` the mask is Bernoulli(p) from the generator's
    first draws; p = 1 keeps every client."""
    _, tspec = _specs(hidden=(8, 8, 8))
    gen = torch.Generator().manual_seed(0)
    fa = tot.fedadam_init(gen, tspec, device="cpu")
    cx = torch.randn((3, 8, D), generator=gen)
    y = torch.randn((16, D), generator=gen)
    a = tot.fedadam_step(fa, tspec, cx, y, LAM, 5e-3,
                         torch.Generator().manual_seed(7), p=0.5,
                         device="cpu")
    want = torch.rand((3,), generator=torch.Generator().manual_seed(7)) < 0.5
    b = tot.fedadam_step(fa, tspec, cx, y, LAM, 5e-3,
                         torch.Generator().manual_seed(99), p=0.5,
                         active=want, device="cpu")
    assert_tree_close((a.omega, a.theta), (b.omega, b.theta), 0, 0)


# ---------------------------------------------------------------------------
# Fig. 3
# ---------------------------------------------------------------------------

def test_fig3_run_dim_tiny(monkeypatch):
    """``run_dim`` at d = 2 for 10 rounds on the reference's data and
    initial potentials (the reference's Fig. 3 network, clients and
    samples): both algorithms' L2-UVP at round 10 within ``RTOL_TRAJ`` of
    the reference ``run_dim``'s, every round's finite."""
    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))
    from benchmarks import fig3_ot as jfig3
    d, rounds = 2, 10
    want_mm, want_fa = jfig3.run_dim(d, rounds=rounds)
    key = jax.random.PRNGKey(0)
    jspec = jot.ICNNSpec(dim=d, hidden=(64, 64, 64), strong_convexity=0.3)
    jcfg, _ = _cfgs(n_clients=10)
    prob = jfig3.make_problem(d, key)
    init = (interop.ot_state_to_torch(_np(jot.init(key, jspec, jcfg)),
                                      tot.FedOTState, device="cpu"),
            interop.ot_state_to_torch(_np(jot.fedadam_init(key, jspec)),
                                      tot.FedAdamState, device="cpu"))
    out = tfig3.run_dim(d, rounds=rounds, device="cpu",
                        prob=_torch_problem(prob, d, key), init=init)
    assert len(out["fedmm_ot"]) == len(out["fedadam"]) == rounds
    assert all(math.isfinite(v) for v in out["fedmm_ot"] + out["fedadam"])
    np.testing.assert_allclose(tfig3.every_tenth(out["fedmm_ot"]), want_mm,
                               rtol=RTOL_TRAJ)
    np.testing.assert_allclose(tfig3.every_tenth(out["fedadam"]), want_fa,
                               rtol=RTOL_TRAJ)


def test_fig3_run_dim_starts_both_from_the_same_potentials(monkeypatch):
    """``run_dim`` hands FedMM-OT and FedAdam the same omega and theta, as
    the reference's ``init`` and ``fedadam_init`` of one key do (checked
    here too), and FedAdam's Adam state starts at zero."""
    jspec, _ = _specs()
    jcfg, _ = _cfgs()
    jst, jfa = jot.init(KEY, jspec, jcfg), jot.fedadam_init(KEY, jspec)
    assert_tree_close((jfa.omega, jfa.theta), (jst.omega, jst.theta), 0, 0)
    starts = {}

    def fedmm(prob, spec, cfg, state0, rounds, seed=0, device=None):
        starts["fedmm_ot"] = state0
        return [0.0] * rounds, 0.0

    def fedadam(prob, spec, state0, rounds, device=None):
        starts["fedadam"] = state0
        return [0.0] * rounds, 0.0

    monkeypatch.setattr(tfig3, "run_fedmm_ot", fedmm)
    monkeypatch.setattr(tfig3, "run_fedadam", fedadam)
    tfig3.run_dim(3, rounds=1, seed=5, device="cpu")
    mm, fa = starts["fedmm_ot"], starts["fedadam"]
    assert_tree_close((fa.omega, fa.theta), (mm.omega, mm.theta), 0, 0)
    assert int(fa.opt.count) == 0
    assert all(float(torch.abs(m).max()) == 0.0
               for m in jax.tree.leaves(fa.opt.m))
    # and a start of its own for another seed
    other, _ = tfig3.initial_states(*tfig3.setup(3), seed=6, device="cpu")
    assert not torch.equal(other.omega["w_out"], mm.omega["w_out"])


def test_fig3_main_rows_and_make_problem():
    """``main``'s row per dim (the reference's keys, the first non-finite
    round of each algorithm), and ``make_problem`` the same on every call
    with the banded shards and the closed-form map's pushforward."""
    rows = tfig3.main(dims=(2,), rounds=2, device="cpu")
    row, = rows
    for k in ("dim", "fedmm_ot_uvp", "fedadam_uvp", "fedmm_ot_curve",
              "fedadam_curve", "seconds"):
        assert k in row
    assert row["fedmm_ot_first_nonfinite"] is None
    assert row["fedadam_first_nonfinite"] is None
    assert len(row["fedmm_ot_curve"]) == 1
    a = tfig3.make_problem(3, seed=4, device="cpu")
    b = tfig3.make_problem(3, seed=4, device="cpu")
    for k in ("cov_q", "client_x", "y_q", "x_eval"):
        assert torch.equal(a[k], b[k])
    cx = a["client_x"]
    assert tuple(cx.shape) == (10, 128, 3)
    assert bool(torch.all(cx[1:, 0, 0] >= cx[:-1, -1, 0]))   # bands
    assert tfig3.first_nonfinite([1.0, 2.0, float("nan"), 3.0]) == 3
    assert tfig3.every_tenth(list(range(25))) == [9, 19, 24]


def test_examples_on_the_cpu():
    """The two examples at a few rounds, on the CPU when asked."""
    from repro_torch.examples import (fedmm_ot_maps,
                                      federated_dictionary_learning)
    out = fedmm_ot_maps.main(["--rounds", "10", "--device", "cpu"])
    assert out["rounds"] == [10]
    assert all(math.isfinite(v) for v in out["fedmm_ot"] + out["fedadam"])
    out = federated_dictionary_learning.main(
        ["--rounds", "4", "--bits", "0", "--device", "cpu"])
    assert len(out["fedmm"]) == len(out["naive"]) == 4
    assert out["fedmm"][-1]["loss"] < out["fedmm"][0]["loss"]


def test_entry_points_default_to_the_gpu():
    """Fig. 3, the two examples and the OT constructors run on the GPU
    unless asked for the CPU; with no GPU they raise."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the defaults run there")
    from repro_torch.examples import (fedmm_ot_maps,
                                      federated_dictionary_learning)
    _, tspec = _specs()
    _, tcfg = _cfgs()
    gen = torch.Generator()
    for call in (lambda: tfig3.make_problem(2),
                 lambda: tfig3.run_dim(2, rounds=1),
                 lambda: tfig3.main(dims=(2,), rounds=1),
                 lambda: fedmm_ot_maps.main(["--rounds", "1"]),
                 lambda: federated_dictionary_learning.main(["--rounds", "1"]),
                 lambda: tot.icnn_init(gen, tspec),
                 lambda: tot.init(gen, tspec, tcfg),
                 lambda: tot.fedadam_init(gen, tspec),
                 lambda: interop.ot_state_to_torch(None, tot.FedOTState)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
