"""The port's driver against the JAX package's: the golden quadratic
problem's trajectory in ``vmap`` and ``scan`` mode, with the reference's
participation masks and per-client, per-leaf dither seeds handed to the
port's ``step`` through ``active=`` and ``seeds=``.

Tolerances: with ``identity()`` the golden tolerance (rtol 1e-5, atol
1e-6; XLA and PyTorch may round the oracles' products differently in the
last ulp). With ``block_quant`` such an ulp can move a drift element
across a rounding edge, so one code flips by one level. The block-quant
test re-anchors each round on the reference's state, counts the flips in
the client payloads (each must sit where the reference's fraction lies
within float32 rounding of its dither), and bounds the iterate's gap
element by element: a flip of client c's code at element e moves the
decoded drift there by the group's scale / levels, hence the iterate by
gamma / p * mu_c * scale / levels at e and nowhere else. Elements without
a flip keep the golden tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.api.topology import Topology as JTopology
from repro.core import compression as JC
from repro.core.quadratic import quadratic_for_objective as jquad
from repro_torch import api as tapi
from repro_torch.core import compression as TC
from repro_torch.core.quadratic import quadratic_for_objective as tquad
from repro_torch import interop
from repro_torch.interop import state_to_numpy

from _torch_parity import client_seeds, leaf_seeds, np_of, state_to_torch, \
    to_torch

KEY = jax.random.PRNGKey(0)
RTOL, ATOL = 1e-5, 1e-6


def _golden(n_clients=4, het=3.0, dim=6):
    """``tests/test_api_golden.py:_quad_problem`` in both packages."""
    ks = jax.random.split(KEY, n_clients)
    Xs = jnp.stack([jax.random.normal(k, (32, dim)) for k in ks])
    w_i = jnp.stack([jnp.linspace(-1, 1, dim) + het * i
                     for i in range(n_clients)])
    ys = jnp.einsum("nbp,np->nb", Xs, w_i)

    def jloss(batch, theta):
        xb, yb = batch
        return 0.5 * jnp.mean((xb @ theta - yb) ** 2)

    def tloss(batch, theta):
        xb, yb = batch
        return 0.5 * torch.mean((xb @ theta - yb) ** 2)

    return ((Xs, ys), japi.as_problem(jquad(jloss, rho=0.05)),
            tapi.as_problem(tquad(tloss, rho=0.05)), jnp.zeros(dim))


def _wide(n_clients=4, d_in=16, d_out=256):
    """A multi-output least-squares problem whose "w" leaf (d_in x d_out)
    reaches the quantizer kernel at a small threshold; "b" stays plain."""
    rng = np.random.default_rng(1)
    X = rng.standard_normal((n_clients, 32, d_in)).astype(np.float32)
    W = rng.standard_normal((d_in, d_out)).astype(np.float32) / 4
    Y = (X @ W + rng.standard_normal((n_clients, 1, d_out))).astype(
        np.float32)

    def jloss(batch, theta):
        r = batch[0] @ theta["w"] + theta["b"] - batch[1]
        return 0.5 * jnp.mean(jnp.sum(r * r, axis=-1))

    def tloss(batch, theta):
        r = batch[0] @ theta["w"] + theta["b"] - batch[1]
        return 0.5 * torch.mean(torch.sum(r * r, dim=-1))

    x0 = {"w": np.zeros((d_in, d_out), np.float32),
          "b": np.zeros((d_out,), np.float32)}
    return ((X, Y), japi.as_problem(jquad(jloss, rho=0.02)),
            tapi.as_problem(tquad(tloss, rho=0.02)), x0)


def _specs(n, comp_kw=None, **kw):
    if comp_kw is None:
        jc, tc = JC.identity(), TC.identity()
    else:
        jc, tc = JC.block_quant(**comp_kw), TC.block_quant(**comp_kw)
    return (japi.FederationSpec(n_clients=n, compressor=jc, **kw),
            tapi.FederationSpec(n_clients=n, compressor=tc, **kw))


def _draws(key, jspec, n_leaves):
    """One round of the reference ``run``'s host key chain and draws."""
    key, k_round, _ = jax.random.split(key, 3)
    active, quant_keys = japi.participation_draw(k_round, jspec)
    return key, k_round, np.asarray(active), client_seeds(quant_keys,
                                                          n_leaves)


def _close(a, b, rtol=RTOL, atol=ATOL, msg=""):
    for x, y in zip(jax.tree.leaves(jax.tree.map(np_of, a)),
                    jax.tree.leaves(jax.tree.map(np_of, b))):
        np.testing.assert_allclose(x, y, rtol=rtol, atol=atol, err_msg=msg)


@pytest.mark.parametrize("normalization", ["expected", "realized"])
@pytest.mark.parametrize("variates,alpha", [("zero", 0.1), ("off", 0.0)])
@pytest.mark.parametrize("mode", ["vmap", "scan"])
def test_golden_trajectory_identity(mode, variates, alpha, normalization):
    (Xs, ys), jp, tp, x0 = _golden()
    rounds = 5
    jspec, tspec = _specs(4, participation=0.5, alpha=alpha,
                          variates=variates, normalization=normalization)
    gammas = np.asarray(japi.resolve_schedule(lambda t: 0.5 / jnp.sqrt(t),
                                              rounds))
    eval_batch = (Xs.reshape(-1, 6), ys.reshape(-1))
    jstate, jhist = japi.run(jp, x0, (Xs, ys), gammas, spec=jspec, key=KEY,
                             n_rounds=rounds, eval_batch=eval_batch,
                             client_mode=mode)

    tstate = tapi.init(tp, torch.zeros(6), tspec, device="cpu")
    batches = to_torch((np.asarray(Xs), np.asarray(ys)))
    tev = to_torch(tuple(map(np.asarray, eval_batch)))
    key, hist = KEY, []
    for t in range(rounds):
        key, _, active, seeds = _draws(key, jspec, 1)
        tstate, m = tapi.step(tp, tspec, tstate, batches,
                              torch.tensor(gammas[t]), None,
                              active=torch.tensor(active), seeds=seeds,
                              device="cpu", client_mode=mode)
        m["loss"] = tp.loss(tev, tstate.x)
        hist.append(m)
    _close(tstate.x, jstate.x, msg="x")
    if variates != "off":
        _close(tstate.v, jstate.v, msg="v")
        _close(tstate.v_i, jstate.v_i, msg="v_i")
    for k in ("e_s", "h_norm_sq", "loss"):
        np.testing.assert_allclose([float(m[k]) for m in hist],
                                   np.asarray(jhist[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    for k in ("n_active", "comm_bytes", "omega_eff"):
        assert [float(m[k]) for m in hist] == \
            np.asarray(jhist[k]).tolist(), k


def _flips(jp, tp, jstate, tstate, batches, comp_kw, seeds, key_c, c):
    """Encode client c's drift in both packages; return the positions
    where the codes differ, with the reference's fraction, dither, code
    step and group scale there."""
    jview, tview = jp.T(jstate.x), tp.T(tstate.x)
    jb = jax.tree.map(lambda x: jnp.asarray(x[c]), batches)
    tb = to_torch(jax.tree.map(lambda x: np.asarray(x[c]), batches))
    jd = jax.tree.map(lambda s, x, v: s - x - v[c], jp.s_bar(jb, jview),
                      jstate.x, jstate.v_i)
    td = jax.tree.map(lambda s, x, v: s - x - v[c], tp.s_bar(tb, tview),
                      tstate.x, tstate.v_i,
                      is_leaf=lambda x: isinstance(x, torch.Tensor))
    jpay = JC.block_quant(**comp_kw).encode(key_c, jd)
    tpay = TC.block_quant(**comp_kw).encode(list(seeds[c]), td)
    out = []
    for i, k in enumerate(sorted(jd)):
        jc_, tc_ = np.asarray(jpay[k].codes), tpay[k].codes.numpy()
        idx = np.flatnonzero(jc_.reshape(-1) != tc_.reshape(-1))
        if idx.size:
            x = np.asarray(jd[k], np.float32).reshape(-1)
            g = comp_kw["block"]
            pad = (-x.size) % g
            xp = np.pad(x, (0, pad)).reshape(-1, g)
            scale = np.abs(xp).max(axis=1, keepdims=True)
            y = (xp / np.where(scale > 0, scale, 1) * 127).reshape(-1)
            u = np.asarray(JC.hash_dither(
                jax.random.split(key_c, len(jd))[i], (x.size + pad,)))
            out.append((k, idx, y[idx] - np.floor(y[idx]), u[idx],
                        np.abs(jc_.reshape(-1)[idx].astype(int)
                               - tc_.reshape(-1)[idx]),
                        np.asarray(jpay[k].scales).reshape(-1)[idx // g]))
    return out


@pytest.mark.parametrize("mode", ["vmap", "scan"])
def test_block_quant_rounds_with_kernel_route_leaf(mode):
    (X, Y), jp, tp, x0 = _wide()
    comp_kw = dict(bits=8, block=256, dither="hash", kernel_threshold=1024)
    jspec, tspec = _specs(4, comp_kw, participation=0.5, alpha=0.1)
    jstate = japi.init(jp, jax.tree.map(jnp.asarray, x0), jspec)
    batches = (jnp.asarray(X), jnp.asarray(Y))
    tb = to_torch((X, Y))
    key, levels, n_flips = KEY, 127.0, 0
    for t in range(4):
        gamma = np.float32(0.5)
        key, k_round, active, seeds = _draws(key, jspec, 2)
        tstate = state_to_torch(jax.tree.map(np.asarray, jstate))
        tnew, tm = tapi.step(tp, tspec, tstate, tb, torch.tensor(gamma),
                             None, active=torch.tensor(active),
                             seeds=seeds, device="cpu", client_mode=mode)
        jnew, jm = japi.step(jp, jspec, jstate, batches, gamma, k_round,
                             client_mode=mode)
        for k in ("n_active", "comm_bytes", "omega_eff"):
            assert float(tm[k]) == float(jm[k]), k
        # every code flip must sit on a rounding edge of the reference;
        # each active client's flip widens the tolerance at its element by
        # what it moves the iterate: gamma / p * mu_c * scale / levels
        qkeys = japi.participation_draw(k_round, jspec)[1]
        mu = tspec.client_weights().numpy()
        bound = {k: np.zeros(np.shape(v), np.float64) for k, v in x0.items()}
        for c in range(4):
            for k, idx, frac, u, dcode, scale in _flips(
                    jp, tp, jstate, tstate, (X, Y), comp_kw, seeds,
                    qkeys[c], c):
                assert (dcode == 1).all()
                assert np.all(np.abs(frac - u) <= 1e-5), (frac, u)
                n_flips += idx.size
                if active[c]:
                    np.add.at(bound[k].reshape(-1), idx,
                              gamma / tspec.participation * mu[c] * scale
                              / levels)
        for k in x0:
            gap = np.abs(tnew.x[k].numpy() - np.asarray(jnew.x[k]))
            tol = RTOL * np.abs(np.asarray(jnew.x[k])) + ATOL
            assert np.all(gap <= tol + bound[k]), k
        jstate = jnew
    # the count is reported by -rA; on this input it is 0 or a handful
    print(f"code flips over 4 rounds x 4 clients: {n_flips}")


def test_parameter_space_oracle_delta_and_momentum():
    (Xs, ys), jp, tp, x0 = _golden()
    rounds = 3
    for kw in (dict(aggregation="parameter", participation=0.5),
               dict(delta="oracle", variates="off", participation=1.0),
               dict(server_momentum=0.5, participation=0.5, alpha=0.1)):
        jspec, tspec = _specs(4, **kw)
        gammas = np.full((rounds,), 0.3, np.float32)
        jstate, _ = japi.run(jp, x0, (Xs, ys), gammas, spec=jspec, key=KEY)
        tstate = tapi.init(tp, torch.zeros(6), tspec, device="cpu")
        batches = to_torch((np.asarray(Xs), np.asarray(ys)))
        key = KEY
        for t in range(rounds):
            key, _, active, seeds = _draws(key, jspec, 1)
            tstate, m = tapi.step(tp, tspec, tstate, batches,
                                  torch.tensor(gammas[t]), None,
                                  active=torch.tensor(active),
                                  seeds=seeds, device="cpu")
        _close(tstate.x, jstate.x, msg=str(kw))
        if kw.get("server_momentum"):
            _close(tstate.opt, jstate.opt, msg="momentum")


def test_variates_at_init_matches():
    (Xs, ys), jp, tp, x0 = _golden(het=5.0)
    jspec, tspec = _specs(4, participation=0.5, alpha=0.2,
                          variates="at-init")
    js = japi.init(jp, x0, jspec, init_batches=(Xs, ys))
    ts = tapi.init(tp, torch.zeros(6), tspec, device="cpu",
                   init_batches=to_torch((np.asarray(Xs), np.asarray(ys))))
    _close(ts.v_i, js.v_i)
    _close(ts.v, js.v)


def test_centralized_run_matches():
    (Xs, ys), jp, tp, x0 = _golden()
    batches = [(Xs[i % 4, :16], ys[i % 4, :16]) for i in range(6)]
    gam = np.full((6,), 0.4, np.float32)
    js, jh = japi.run(jp, x0, batches, gam, scan=False)
    ts, th = tapi.run(tp, torch.zeros(6), [to_torch(tuple(map(np.asarray, b)))
                                          for b in batches], gam,
                      device="cpu")
    _close(ts.x, js.x)
    np.testing.assert_allclose(th["e_s"].numpy(), np.asarray(jh["e_s"]),
                               rtol=RTOL, atol=ATOL)


def test_run_drives_rounds_and_loss_falls():
    (X, Y), _, tp, x0 = _wide()
    _, tspec = _specs(4, dict(bits=8, block=256, dither="kernel",
                              kernel_threshold=1024),
                      participation=0.5, alpha=0.1)
    tb = to_torch((X, Y))
    ev = (tb[0].reshape(-1, 16), tb[1].reshape(-1, 256))
    for mode in ("vmap", "scan"):
        state, hist = tapi.run(tp, to_torch(x0), tb, 0.5, spec=tspec, key=3,
                               n_rounds=6, eval_batch=ev, device="cpu",
                               client_mode=mode, eval_every=2)
        loss = hist["loss"].tolist()
        assert np.isnan(loss[0]) and loss[-1] < loss[1]
        rows = tapi.history_list(hist)
        assert len(rows) == 6 and rows[2]["n_active"] == \
            float(hist["n_active"][2])
        assert int(state.step) == 6


def test_hash_and_kernel_dither_trajectories_identical():
    (X, Y), _, tp, x0 = _wide()
    tb = to_torch((X, Y))
    finals = []
    for dither in ("hash", "kernel"):
        _, tspec = _specs(4, dict(bits=8, block=256, dither=dither,
                                  kernel_threshold=1024),
                          participation=0.5, alpha=0.1)
        state, hist = tapi.run(tp, to_torch(x0), tb, 0.5, spec=tspec,
                               key=torch.Generator().manual_seed(9),
                               n_rounds=3, device="cpu")
        finals.append((state, hist))
    (a, ha), (b, hb) = finals
    for k in x0:
        assert torch.equal(a.x[k], b.x[k]) and torch.equal(a.v_i[k],
                                                           b.v_i[k])
    for k in ha:
        assert torch.equal(ha[k], hb[k])


def test_interop_roundtrip_of_reference_state():
    (Xs, ys), jp, tp, x0 = _golden()
    jspec, _ = _specs(4, participation=0.5, alpha=0.1)
    js = japi.init(jp, x0, jspec)
    js, _ = japi.step(jp, jspec, js, (Xs, ys), 0.3, KEY)
    back = japi.DriverState(*state_to_numpy(
        state_to_torch(jax.tree.map(np.asarray, js))))
    for a, b in zip(jax.tree.leaves(js), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_step_rejects_what_is_not_ported():
    (Xs, ys), _, tp, x0 = _golden()
    _, tspec = _specs(4)
    st = tapi.init(tp, torch.zeros(6), tspec, device="cpu")
    b = to_torch((np.asarray(Xs), np.asarray(ys)))
    g = torch.Generator().manual_seed(0)
    for kw, err in ((dict(mesh=object()), TypeError),
                    (dict(mesh=object(), client_mode="scan"), ValueError),
                    (dict(cohort=object()), TypeError),
                    (dict(uplink="reduce"), ValueError),
                    (dict(client_mode="pmap"), ValueError)):
        with pytest.raises(err):
            tapi.step(tp, tspec, st, b, 0.1, g, device="cpu", **kw)
    with pytest.raises(ValueError):
        tapi.step(tp, tspec, st, b, 0.1, None, device="cpu")
    two = tapi.FederationSpec(n_clients=4,
                              topology=tapi.Topology.two_tier(2))
    with pytest.raises(TypeError):
        tapi.step(tp, two, st, b, 0.1, g, device="cpu", mesh=object())
    # off the mesh the two-tier round runs and bills its backbone
    _, m = tapi.step(tp, two, st, b, 0.1, g, device="cpu")
    assert float(m["backbone_bytes"]) == 2 * 6 * 4
    with pytest.raises(ValueError, match="FaultSpec"):
        tapi.FederationSpec(n_clients=4, faults=object())
    assert JTopology.two_tier(2).edge_ids(4).tolist() == \
        tapi.Topology.two_tier(2).edge_ids(4).tolist()


def test_default_device_is_the_gpu():
    if torch.cuda.is_available():
        assert tapi.resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            tapi.resolve_device()
        (_, _, tp, _) = _golden()
        with pytest.raises(RuntimeError):
            tapi.init(tp, torch.zeros(6), tapi.FederationSpec(n_clients=2))
        # interop follows the same rule
        with pytest.raises(RuntimeError):
            interop.to_torch(np.zeros(3, np.float32))
        assert interop.to_torch(np.zeros(3, np.float32),
                                device="cpu").device.type == "cpu"


def test_participation_draw_shapes_and_seeds():
    _, tspec = _specs(5, participation=0.4)
    g1, g2 = torch.Generator().manual_seed(1), torch.Generator().manual_seed(1)
    a1, s1 = tapi.participation_draw(g1, tspec, 3)
    a2, s2 = tapi.participation_draw(g2, tspec, 3)
    assert a1.shape == (5,) and a1.dtype == torch.bool
    assert s1.shape == (5, 3) and torch.equal(s1, s2) and torch.equal(a1, a2)
    assert int(s1.min()) >= 0 and int(s1.max()) < 2 ** 32
    assert leaf_seeds(KEY, 2) == leaf_seeds(KEY, 2)
