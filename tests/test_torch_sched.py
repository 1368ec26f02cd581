"""The port's cohort scheduler (``repro_torch.sched``) against
``tests/test_scheduler.py``'s contracts and the JAX package's scheduler:

  * one full-participation cohort is bit for bit the port's own
    ``api.run`` (state, the arena against ``v_i``, every metric): off the
    mesh, on a one-rank gloo mesh with both uplinks, and two-tier;
  * with the reference's draws handed in (``draws=``), the port's ragged
    cohorts (n = 10 in cohorts of 4, non-uniform mu) follow the
    reference's ``CohortScheduler.run`` in lockstep (each round from the
    reference's state and arena) within rtol 1e-5 / atol 1e-6, with the
    accounting exact (a free run of the port's own re-associates the
    reduce; its gap to ``api.run`` is held to the reference's allclose);
  * async with the sync window is bit for bit sync; a pipelined window
    is stale and bounded;
  * the population: stable edge ids and seeds, scatter respecting the
    valid mask, the warm start, no live tensor with an O(n_total) dim;
  * ``server_momentum`` through the scheduler.
"""
import datetime
import gc
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro import api as japi
from repro.core import compression as JC
from repro.core.quadratic import quadratic_for_objective as jquad
from repro.sched import CohortScheduler as JCohortScheduler
from repro.sched import cohort_ids as jcohort_ids
from repro_torch import api as tapi
from repro_torch.core import compression as TC
from repro_torch.core.quadratic import quadratic_for_objective as tquad
from repro_torch.launch.mesh import cohort_capacity
from repro_torch.sched import ClientPopulation, CohortScheduler, cohort_ids
from repro_torch.sched import staleness as stale

from _torch_parity import (assert_bits_equal, assert_tree_close, edge_seeds,
                           np_of, round_draws, to_torch)

KEY = jax.random.PRNGKey(0)
RTOL, ATOL = 1e-5, 1e-6
COMP_KW = dict(bits=8, block=16, dither="hash")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def one_rank():
    """A one-rank gloo process group in this process, for the module."""
    dist.init_process_group("gloo",
                            init_method=f"tcp://localhost:{_free_port()}",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    yield
    dist.destroy_process_group()


def _quad(n_clients=8, dim=32, batch=16):
    """``tests/test_scheduler.py:_quad_problem`` in both packages."""
    ks = jax.random.split(KEY, n_clients)
    Xs = jnp.stack([jax.random.normal(k, (batch, dim)) for k in ks])
    w_i = jnp.stack([jnp.linspace(-1, 1, dim) + 2.0 * i
                     for i in range(n_clients)])
    ys = jnp.einsum("nbp,np->nb", Xs, w_i)

    def jloss(b, theta):
        xb, yb = b
        return 0.5 * jnp.mean((xb @ theta - yb) ** 2)

    def tloss(b, theta):
        xb, yb = b
        return 0.5 * torch.mean((xb @ theta - yb) ** 2)

    tb = to_torch((np.asarray(Xs), np.asarray(ys)))
    return ((Xs, ys), tb, japi.as_problem(jquad(jloss, rho=0.05)),
            tapi.as_problem(tquad(tloss, rho=0.05)))


def _slicing(tb):
    def data_fn(t, g, ids):
        ids = torch.as_tensor(np.asarray(ids))
        return tuple(x[ids] for x in tb)
    return data_fn


def _bits(a, b, msg=""):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb), msg
    for x, y in zip(la, lb):
        assert_bits_equal(x, y, msg)


def _metrics_bits(m_ref, m, keys=None):
    for k in (m_ref if keys is None else keys):
        assert_bits_equal(m_ref[k], m[k], k)


def _spec(n, comp_kw=COMP_KW, **kw):
    return tapi.FederationSpec(n_clients=n,
                               compressor=TC.block_quant(**comp_kw), **kw)


# ---------------------------------------------------------------------------
# one full cohort == the port's api.run, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("client_mode", ["vmap", "scan"])
def test_sync_single_cohort_bit_identical_to_run(client_mode):
    n, dim = 8, 32
    _, tb, _, tp = _quad(n, dim)
    spec = _spec(n, participation=0.5, alpha=0.1)
    eval_batch = (tb[0][0], tb[1][0])
    st_ref, m_ref = tapi.run(tp, torch.zeros(dim), lambda t, g: tb, 0.3,
                             spec=spec, key=0, n_rounds=6, device="cpu",
                             eval_batch=eval_batch, client_mode=client_mode)
    sched = CohortScheduler(tp, spec, cohort_size=n, device="cpu",
                            client_mode=client_mode)
    st, pop, m = sched.run(torch.zeros(dim), _slicing(tb), 0.3, key=0,
                           n_rounds=6, eval_batch=eval_batch)
    _bits(st_ref.x, st.x)
    _bits(st_ref.v, st.v)
    # the population arena carries what run kept in DriverState.v_i
    _bits(st_ref.v_i, pop.variates())
    _metrics_bits(m_ref, m)
    assert pop.rounds_seen == 6


def test_single_cohort_consumes_the_chain_as_run():
    """A data function that draws from the generator: cohort 0 draws on the
    chain and the later cohorts from its state before the data, so one
    cohort is still api.run, and several cohorts see the same rows."""
    n, dim = 8, 32
    _, tb, _, tp = _quad(n, dim)
    spec = _spec(n, participation=0.7, alpha=0.1)

    def data(t, g):
        noise = torch.randn(tb[1].shape, generator=g)
        return (tb[0], tb[1] + 0.1 * noise)

    def data_fn(t, g, ids):
        ids = torch.as_tensor(np.asarray(ids))
        return tuple(x[ids] for x in data(t, g))

    gen = torch.Generator().manual_seed(5)
    st_ref, m_ref = tapi.run(tp, torch.zeros(dim), data, 0.3, spec=spec,
                             key=gen, n_rounds=4, device="cpu")
    st, _, m = CohortScheduler(tp, spec, cohort_size=n, device="cpu").run(
        torch.zeros(dim), data_fn, 0.3,
        key=torch.Generator().manual_seed(5), n_rounds=4)
    _bits(st_ref.x, st.x)
    _metrics_bits(m_ref, m)
    st3, _, m3 = CohortScheduler(tp, spec, cohort_size=3, device="cpu").run(
        torch.zeros(dim), data_fn, 0.3, key=5, n_rounds=4)
    assert_tree_close(st3.x, st_ref.x, 2e-5, 2e-6)
    _metrics_bits(m_ref, m3, ("n_active", "comm_bytes"))


@pytest.mark.parametrize("uplink", ["gather", "reduce"])
def test_single_cohort_on_a_one_rank_mesh(one_rank, uplink):
    n, dim = 8, 32
    _, tb, _, tp = _quad(n, dim)
    mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("clients",))
    spec = _spec(n, participation=0.5, alpha=0.1)
    st_ref, m_ref = tapi.run(tp, torch.zeros(dim), lambda t, g: tb, 0.3,
                             spec=spec, key=0, n_rounds=4, device="cpu",
                             mesh=mesh, uplink=uplink)
    sched = CohortScheduler(tp, spec, cohort_size=n, mesh=mesh,
                            uplink=uplink, device="cpu")
    st, pop, m = sched.run(torch.zeros(dim), _slicing(tb), 0.3, key=0,
                           n_rounds=4)
    _bits(st_ref.x, st.x)
    _bits(st_ref.v, st.v)
    _bits(st_ref.v_i, pop.variates())
    _metrics_bits(m_ref, m)
    assert "collective_payload_bytes" in m
    # ragged cohorts of 4 on the mesh: the padded-cohort honest bytes
    sched4 = CohortScheduler(tp, _spec(10, participation=0.6, alpha=0.1),
                             cohort_size=4, mesh=mesh, uplink=uplink,
                             device="cpu")
    _, tb10, _, tp10 = _quad(10, dim)
    _, _, m4 = sched4.run(torch.zeros(dim), _slicing(tb10), 0.3, key=0,
                          n_rounds=2)
    if uplink == "gather":
        per_client = TC.block_quant(**COMP_KW).payload_bytes(
            torch.zeros(dim))
        np.testing.assert_allclose(m4["collective_payload_bytes"].numpy(),
                                   3 * 4 * per_client)
    else:
        np.testing.assert_allclose(m4["collective_payload_bytes"].numpy(),
                                   3 * dim * 4)


def test_cohort_ids_padding():
    cohorts = cohort_ids(10, 4)
    assert [c[0].tolist() for c in cohorts] == [
        [0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 8, 8]]
    assert cohorts[-1][1].tolist() == [1.0, 1.0, 0.0, 0.0]
    for (a, va), (b, vb) in zip(cohorts, jcohort_ids(10, 4)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(va, vb)
    with pytest.raises(ValueError, match="cohort_size"):
        cohort_ids(10, 0)


def test_cohort_capacity_glue(one_rank):
    mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("clients",))
    assert cohort_capacity(mesh, "clients") == 1
    assert cohort_capacity(mesh, "clients", per_device=3) == 3
    with pytest.raises(ValueError, match="client_axis"):
        cohort_capacity(mesh, "nope")
    with pytest.raises(ValueError, match="per_device"):
        cohort_capacity(mesh, "clients", per_device=0)
    # a cohort of the capacity streams through the mesh
    n, dim = 6, 32
    _, tb, _, tp = _quad(n, dim)
    c = cohort_capacity(mesh, "clients", per_device=2)
    sched = CohortScheduler(tp, _spec(n, participation=1.0, alpha=0.1),
                            cohort_size=c, mesh=mesh, device="cpu")
    st, pop, m = sched.run(torch.zeros(dim), _slicing(tb), 0.3, key=0,
                           n_rounds=1)
    assert sched.n_cohorts == 3 and float(m["n_active"][0]) == 6.0


# ---------------------------------------------------------------------------
# against the reference's scheduler: ragged cohorts, non-uniform mu
# ---------------------------------------------------------------------------

def _ref_sched_draws(jspec, rounds, n_leaves=1):
    key, out = KEY, []
    for _ in range(rounds):
        key, k_round, _, active, seeds = round_draws(key, jspec, n_leaves)
        d = {"active": active, "seeds": seeds}
        if jspec.topology.is_two_tier:
            d["edge_seeds"] = edge_seeds(k_round, jspec.topology.n_edges,
                                         n_leaves)
        out.append(d)
    return out


def test_ragged_cohorts_lockstep_with_reference_scheduler():
    """n = 10 in cohorts of 4 (the last padded by 2), non-uniform mu: each
    round of the port's scheduler starts from the reference scheduler's
    state and arena after the rounds before, with that round's draws; the
    round's state and arena are within rtol 1e-5 / atol 1e-6 of the
    reference's, and n_active and the bytes are bit-equal."""
    n, dim, csize, rounds = 10, 32, 4, 4
    (Xs, ys), tb, jp, tp = _quad(n, dim)
    mu = np.arange(1, n + 1, dtype=np.float32)
    mu /= mu.sum()
    kw = dict(participation=0.6, alpha=0.1)
    jspec = japi.FederationSpec(n_clients=n, compressor=JC.block_quant(
        **COMP_KW), mu=jnp.asarray(mu), **kw)
    tspec = _spec(n, mu=mu, **kw)
    jsched = JCohortScheduler(jp, jspec, cohort_size=csize)
    jdata = lambda t, k, ids: (Xs[np.asarray(ids)], ys[np.asarray(ids)])
    draws = _ref_sched_draws(jspec, rounds)
    tsched = CohortScheduler(tp, tspec, cohort_size=csize, device="cpu")
    prev = None
    for r in range(1, rounds + 1):
        jst, jpop, jm = jsched.run(jnp.zeros(dim), jdata, 0.3, key=KEY,
                                   n_rounds=r)
        pop = ClientPopulation(tspec, torch.zeros(dim))
        if prev is None:
            state0 = None
        else:
            pst, ppop = prev
            pop.scatter_variates(np.arange(n), to_torch(
                np.asarray(ppop.variates())))
            state0 = tapi.DriverState(
                x=to_torch(np.asarray(pst.x)), v=to_torch(np.asarray(pst.v)),
                v_i=(), aux=(), opt=(), step=torch.tensor(r - 1))
        st, pop, m = tsched.run(torch.zeros(dim), _slicing(tb), 0.3, key=0,
                                n_rounds=1, population=pop, state0=state0,
                                draws=lambda i, r=r: draws[r - 1])
        assert_tree_close(st.x, jst.x, RTOL, ATOL, f"x round {r}")
        assert_tree_close(st.v, jst.v, RTOL, ATOL, f"v round {r}")
        assert_tree_close(pop.variates(), np.asarray(jpop.variates()), RTOL,
                          ATOL, f"arena round {r}")
        for k in ("n_active", "comm_bytes", "uplink_bytes"):
            assert_bits_equal(m[k][0], jm[k][r - 1], k)
        np.testing.assert_allclose(m["e_s"][0], jm["e_s"][r - 1], rtol=1e-4)
        prev = (jst, jpop)
    # the port's free run: the accounting exact, the state allclose to the
    # port's api.run, as the reference holds its own
    per_client = float(tspec.compressor.wire_bytes(torch.zeros(dim)))
    st_f, _, m_f = tsched.run(torch.zeros(dim), _slicing(tb), 0.3, key=0,
                              n_rounds=5,
                              draws=lambda i: _ref_sched_draws(jspec, 5)[i])
    st_r, m_r = tapi.run(tp, torch.zeros(dim), lambda t, g: tb, 0.3,
                         spec=tspec, key=0, n_rounds=5, device="cpu")
    np.testing.assert_allclose(m_f["comm_bytes"].numpy(),
                               per_client * m_f["n_active"].numpy())
    _, _, jm5 = jsched.run(jnp.zeros(dim), jdata, 0.3, key=KEY, n_rounds=5)
    for k in ("n_active", "comm_bytes"):
        assert_bits_equal(m_f[k], jm5[k], k)
    assert np.isfinite(np_of(st_f.x)).all() and np.isfinite(
        np_of(st_r.x)).all()


# ---------------------------------------------------------------------------
# async: the sync window recovers sync; a pipelined window is bounded
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weight_fn", [None, stale.constant(),
                                       stale.polynomial(0.5),
                                       stale.exponential(0.5)])
def test_async_defaults_recover_sync_exactly(weight_fn):
    n, dim = 8, 32
    _, tb, _, tp = _quad(n, dim)
    spec = _spec(n, participation=0.75, alpha=0.1,
                 staleness_weight=weight_fn)
    sched = CohortScheduler(tp, spec, cohort_size=3, device="cpu")
    st_s, pop_s, m_s = sched.run(torch.zeros(dim), _slicing(tb), 0.3, key=0,
                                 n_rounds=5)
    st_a, pop_a, m_a = sched.run(torch.zeros(dim), _slicing(tb), 0.3, key=0,
                                 n_rounds=5, mode="async")
    _bits(st_s.x, st_a.x)
    _bits(st_s.v, st_a.v)
    _bits(pop_s.variates(), pop_a.variates())
    _metrics_bits(m_s, m_a)
    assert float(m_a["staleness_max"].max()) == 0.0


def test_async_pipelined_staleness_is_bounded():
    n, dim, bound = 8, 32, 2
    _, tb, _, tp = _quad(n, dim)
    spec = tapi.FederationSpec(n_clients=n, variates="off",
                               max_staleness=bound,
                               staleness_weight=stale.polynomial(0.5))
    sched = CohortScheduler(tp, spec, cohort_size=3, device="cpu")
    k_cohorts = sched.n_cohorts
    st, _, m = sched.run(torch.zeros(dim), _slicing(tb), 0.1, key=0,
                         n_rounds=8, mode="async",
                         max_inflight=2 * k_cohorts,
                         buffer_cohorts=k_cohorts,
                         delay_fn=lambda i: i % 3)
    taus = m["staleness_max"].numpy()
    assert taus.max() > 0.0          # asynchronous
    assert taus.max() <= bound       # and bounded
    assert bool(torch.isfinite(st.x).all())


def test_async_knob_validation():
    n, dim = 4, 16
    _, tb, _, tp = _quad(n, dim)
    spec = tapi.FederationSpec(n_clients=n, variates="off")
    sched = CohortScheduler(tp, spec, cohort_size=2, device="cpu")
    data_fn = _slicing(tb)
    with pytest.raises(ValueError, match="mode"):
        sched.run(torch.zeros(dim), data_fn, 0.1, key=0, n_rounds=2,
                  mode="nope")
    with pytest.raises(ValueError, match="buffer_cohorts"):
        sched.run(torch.zeros(dim), data_fn, 0.1, key=0, n_rounds=2,
                  mode="async", max_inflight=1, buffer_cohorts=2)
    with pytest.raises(ValueError, match=">= 1"):
        sched.run(torch.zeros(dim), data_fn, 0.1, key=0, n_rounds=2,
                  mode="async", max_inflight=0)
    with pytest.raises(ValueError, match="population holds"):
        other = ClientPopulation(
            tapi.FederationSpec(n_clients=2 * n, variates="off"),
            torch.zeros(dim))
        sched.run(torch.zeros(dim), data_fn, 0.1, key=0, n_rounds=2,
                  population=other)
    with pytest.raises(ValueError, match="checkpoint_every"):
        sched.run(torch.zeros(dim), data_fn, 0.1, key=0, n_rounds=2,
                  checkpoint_every=0)
    with pytest.raises(ValueError, match="n_rounds"):
        sched.run(torch.zeros(dim), data_fn, lambda t: 0.1, key=0)


# ---------------------------------------------------------------------------
# two-tier through the scheduler
# ---------------------------------------------------------------------------

def _two_tier(n, n_edges, reencode=False):
    return _spec(n, dict(COMP_KW, checksum=True), participation=0.8,
                 alpha=0.1, topology=tapi.Topology.two_tier(
                     n_edges, reencode=reencode))


@pytest.mark.parametrize("reencode", [False, True])
def test_two_tier_single_cohort_bit_identical_to_run(reencode):
    n, dim = 8, 32
    _, tb, _, tp = _quad(n, dim)
    spec = _two_tier(n, 3, reencode)
    st_ref, m_ref = tapi.run(tp, torch.zeros(dim), lambda t, g: tb, 0.3,
                             spec=spec, key=0, n_rounds=6, device="cpu")
    st, pop, m = CohortScheduler(tp, spec, cohort_size=n, device="cpu").run(
        torch.zeros(dim), _slicing(tb), 0.3, key=0, n_rounds=6)
    _bits(st_ref.x, st.x)
    _bits(st_ref.v, st.v)
    _bits(st_ref.v_i, pop.variates())
    _metrics_bits(m_ref, m)


@pytest.mark.parametrize("reencode", [False, True])
def test_two_tier_ragged_cohorts_exact_per_tier_bytes(reencode):
    """n = 8 in cohorts of 3: the clients keep their stable edges, so the
    per-tier bytes are bit-equal to the port's api.run (and to the
    reference scheduler's, with its draws), the backbone billed once per
    landing; the state within the reference's tolerance of api.run's."""
    n, dim, n_edges = 8, 32, 3
    (Xs, ys), tb, jp, tp = _quad(n, dim)
    spec = _two_tier(n, n_edges, reencode)
    st_ref, m_ref = tapi.run(tp, torch.zeros(dim), lambda t, g: tb, 0.3,
                             spec=spec, key=0, n_rounds=5, device="cpu")
    st, pop, m = CohortScheduler(tp, spec, cohort_size=3, device="cpu").run(
        torch.zeros(dim), _slicing(tb), 0.3, key=0, n_rounds=5)
    assert_tree_close(st.x, st_ref.x, 2e-5, 2e-6)
    _metrics_bits(m_ref, m, ("n_active", "uplink_bytes", "backbone_bytes",
                             "comm_bytes"))
    per_client = float(spec.compressor.wire_bytes(torch.zeros(dim)))
    np.testing.assert_allclose(m["uplink_bytes"].numpy(),
                               per_client * m["n_active"].numpy())
    per_edge = (float(TC._tree_bytes(spec.compressor.encode(
        [0], torch.zeros(dim)))) if reencode else dim * 4)
    np.testing.assert_allclose(m["backbone_bytes"].numpy(),
                               n_edges * per_edge)
    assert_bits_equal(m["comm_bytes"],
                      m["uplink_bytes"] + m["backbone_bytes"])
    # the reference's scheduler bills the same with its own draws
    jspec = japi.FederationSpec(
        n_clients=n, compressor=JC.block_quant(**COMP_KW, checksum=True),
        participation=0.8, alpha=0.1,
        topology=japi.Topology.two_tier(n_edges, reencode=reencode))
    _, _, jm = JCohortScheduler(jp, jspec, cohort_size=3).run(
        jnp.zeros(dim), lambda t, k, ids: (Xs[np.asarray(ids)],
                                           ys[np.asarray(ids)]),
        0.3, key=KEY, n_rounds=5)
    draws = _ref_sched_draws(jspec, 5)
    _, _, mj = CohortScheduler(tp, spec, cohort_size=3, device="cpu").run(
        torch.zeros(dim), _slicing(tb), 0.3, key=0, n_rounds=5,
        draws=draws.__getitem__)
    _metrics_bits(jm, mj, ("n_active", "uplink_bytes", "backbone_bytes",
                           "comm_bytes"))


def test_two_tier_scheduler_mode_restrictions():
    n, dim = 6, 16
    _, tb, _, tp = _quad(n, dim)
    spec = _spec(n, participation=0.8, alpha=0.1,
                 topology=tapi.Topology.two_tier(2))
    with pytest.raises(ValueError, match="uplink='reduce'"):
        CohortScheduler(tp, spec, cohort_size=3, uplink="reduce",
                        device="cpu")
    sched = CohortScheduler(tp, spec, cohort_size=3, device="cpu")
    with pytest.raises(ValueError, match="mode='async'"):
        sched.run(torch.zeros(dim), _slicing(tb), 0.3, key=0, n_rounds=3,
                  mode="async")
    # the cohort path needs the cohort's edge map under two-tier
    st = sched.init_state(torch.zeros(dim), ClientPopulation(
        spec, torch.zeros(dim)))
    cohort = tapi.CohortSlice(mask=torch.ones(3), mu=torch.full((3,), 1 / 6),
                              seeds=torch.zeros((3, 1), dtype=torch.int64))
    with pytest.raises(ValueError, match="edge_ids"):
        tapi.step(tp, spec, st, tuple(x[:3] for x in tb), 0.3, None,
                  device="cpu", cohort=cohort)


def test_cohort_step_and_apply_partial_match_step():
    """``step(cohort=...)`` with every client in one cohort, then
    ``apply_partial``, is bit for bit one ``step`` (flat); malformed
    slices raise."""
    n, dim = 6, 32
    _, tb, _, tp = _quad(n, dim)
    spec = _spec(n, participation=0.7, alpha=0.1)
    st = tapi.init(tp, torch.zeros(dim), spec, device="cpu")
    g = torch.Generator().manual_seed(1)
    active, seeds = tapi.participation_draw(g, spec, 1)
    new, m = tapi.step(tp, spec, st, tb, torch.tensor(0.3), None,
                       active=active, seeds=seeds, device="cpu")
    mu = spec.client_weights("cpu")
    part = tapi.step(tp, spec, st, tb, 0.3, None, device="cpu",
                     cohort=tapi.CohortSlice(
                         mask=active.float(), mu=mu, seeds=seeds,
                         v_i=st.v_i))
    assert isinstance(part, tapi.CohortPartial)
    landed, lm = tapi.apply_partial(tp, spec, st._replace(v_i=()), part.agg,
                                    part.n_active, torch.tensor(0.3),
                                    device="cpu")
    _bits(new.x, landed.x)
    _bits(new.v, landed.v)
    _bits(new.v_i, part.v_i)
    # the partial's bill is exact (float64); cast once, it is step's
    assert part.comm_bytes.dtype == torch.float64
    assert_bits_equal(m["uplink_bytes"], part.comm_bytes.float())
    for k in ("n_active", "e_s", "h_norm_sq", "omega_eff"):
        assert_bits_equal(m[k], lm[k], k)
    with pytest.raises(TypeError, match="CohortSlice"):
        tapi.step(tp, spec, st, tb, 0.3, None, device="cpu", cohort=object())
    with pytest.raises(ValueError, match="leading dim"):
        tapi.step(tp, spec, st, tb, 0.3, None, device="cpu",
                  cohort=tapi.CohortSlice(mask=active.float(), mu=mu[:3],
                                          seeds=seeds, v_i=st.v_i))
    agg, bb = tapi.finalize_partial(spec, part.agg, None, st.x)
    assert agg is part.agg and bb == 0.0


def _with_client_metric(tp, name="s_sum"):
    """``tp`` reporting one per-client metric through ``s_bar_metrics``."""
    def s_bar_metrics(batch, view):
        s_i = tp.s_bar(batch, view)
        return s_i, {name: torch.sum(s_i)}
    return tapi.as_problem(tp, s_bar_metrics=s_bar_metrics)


@pytest.mark.parametrize("cohort_size", [10, 4])
def test_client_metrics_through_the_scheduler(cohort_size):
    """A problem's per-client metric: ``step`` reports its mean over the
    clients; the scheduler's sum over n of the cohorts' valid rows is it
    bit for bit for one full cohort (the CPU's mean sums then divides) and
    to re-association for ragged cohorts of 4 over n = 10. A metric named
    like a driver metric raises in both."""
    n, dim = 10, 32
    _, tb, _, tp = _quad(n, dim)
    tp = _with_client_metric(tp)
    spec = _spec(n, participation=0.7, alpha=0.1)
    _, m_ref = tapi.run(tp, torch.zeros(dim), lambda t, g: tb, 0.3,
                        spec=spec, key=3, n_rounds=2, device="cpu")
    sched = CohortScheduler(tp, spec, cohort_size=cohort_size, device="cpu")
    _, _, m = sched.run(torch.zeros(dim), _slicing(tb), 0.3, key=3,
                        n_rounds=1)
    assert "s_sum" in m
    if cohort_size == n:
        assert_bits_equal(m_ref["s_sum"][:1], m["s_sum"])
    else:
        assert_tree_close(m_ref["s_sum"][:1], m["s_sum"], RTOL, ATOL)
    clash = _with_client_metric(tp, name="uplink_bytes")
    with pytest.raises(ValueError, match="collide"):
        tapi.run(clash, torch.zeros(dim), lambda t, g: tb, 0.3, spec=spec,
                 key=3, n_rounds=1, device="cpu")
    with pytest.raises(ValueError, match="collide"):
        CohortScheduler(clash, spec, cohort_size=cohort_size,
                        device="cpu").run(torch.zeros(dim), _slicing(tb),
                                          0.3, key=3, n_rounds=1)


# ---------------------------------------------------------------------------
# the population
# ---------------------------------------------------------------------------

def test_population_carries_stable_edge_ids():
    spec = tapi.FederationSpec(n_clients=10, compressor=TC.identity(),
                               topology=tapi.Topology.two_tier(3))
    pop = ClientPopulation(spec, torch.zeros(4))
    assert pop.edge_ids.tolist() == [0, 0, 0, 0, 1, 1, 1, 2, 2, 2]
    flat = tapi.FederationSpec(n_clients=10, variates="off")
    assert ClientPopulation(flat, torch.zeros(4)).edge_ids.tolist() == \
        [0] * 10


def test_population_client_keys_stable_under_cohorting():
    spec = tapi.FederationSpec(n_clients=16, variates="off")
    pop = ClientPopulation(spec, torch.zeros(4), base_seed=9)
    all_keys = pop.client_keys(np.arange(16))
    some = pop.client_keys(np.asarray([3, 11, 7]))
    np.testing.assert_array_equal(some, all_keys[[3, 11, 7]])
    assert len(set(all_keys.tolist())) == 16
    other = ClientPopulation(spec, torch.zeros(4), base_seed=10)
    assert not np.array_equal(other.client_keys(np.arange(16)), all_keys)
    g3 = pop.client_generators([3])[0]
    g3b = pop.client_generators(np.arange(16))[3]
    assert torch.equal(torch.rand(5, generator=g3),
                       torch.rand(5, generator=g3b))


def test_population_scatter_respects_valid_mask():
    spec = tapi.FederationSpec(n_clients=6, alpha=0.1)
    pop = ClientPopulation(spec, torch.zeros(3))
    ids = np.asarray([4, 5, 4, 4])          # a ragged cohort padded with 4
    valid = np.asarray([1.0, 1.0, 0.0, 0.0], np.float32)
    rows = torch.stack([torch.full((3,), float(i + 1)) for i in range(4)])
    pop.scatter_variates(ids, rows, valid)
    arena = pop.variates()
    np.testing.assert_allclose(arena[4].numpy(), 1.0)   # pads don't clobber
    np.testing.assert_allclose(arena[5].numpy(), 2.0)
    np.testing.assert_allclose(arena[:4].numpy(), 0.0)
    got = pop.gather_variates(ids)
    np.testing.assert_allclose(got[0].numpy(), 1.0)
    np.testing.assert_allclose(got[2].numpy(), 1.0)     # pads mirror 4
    pop.record_participation(ids, np.asarray([1.0, 0.0, 1.0, 1.0]), valid)
    assert pop.participation_counts.tolist() == [0, 0, 0, 0, 1, 0]
    with pytest.raises(ValueError, match="leaves"):
        pop.scatter_variates(ids, (rows, rows), valid)


def test_population_warm_start_matches_driver_at_init():
    n, dim = 6, 16
    (Xs, ys), tb, jp, tp = _quad(n, dim)
    spec = tapi.FederationSpec(n_clients=n, alpha=0.1, variates="at-init")
    ref = tapi.variates_at_init(tp, torch.zeros(dim), tb)
    jref = japi.variates_at_init(jp, jnp.zeros(dim), (Xs, ys))
    pop = ClientPopulation(spec, torch.zeros(dim))
    pop.warm_start_variates(
        tp, torch.zeros(dim), lambda ids: tuple(
            x[torch.as_tensor(ids)] for x in tb), cohort_size=4,
        device="cpu")
    assert_tree_close(pop.variates(), ref, 1e-6, 1e-7)
    assert_tree_close(pop.variates(), np.asarray(jref), RTOL, ATOL)
    v_ref = torch.tensordot(spec.client_weights("cpu"), ref, dims=1)
    assert_tree_close(pop.weighted_variate_sum(), v_ref, RTOL, ATOL)
    with pytest.raises(ValueError, match="variates"):
        ClientPopulation(tapi.FederationSpec(n_clients=n, variates="off"),
                         torch.zeros(dim)).warm_start_variates(
            tp, torch.zeros(dim), None, cohort_size=2, device="cpu")


def _live_tensors():
    gc.collect()
    return [o for o in gc.get_objects() if isinstance(o, torch.Tensor)]


def test_no_live_tensor_with_an_o_n_total_dim():
    """Variates on, n_total 512 in cohorts of 16: at every cohort boundary
    no tensor made by the run has a dim of n_total (the host arena is made
    before it; the round's draws live as numpy on the host), and the
    sampled bytes of those tensors do not grow with the population."""
    dim, csize = 16, 16
    _, _, _, tp = _quad(4, dim)

    def peak_for(n_total):
        spec = _spec(n_total, participation=0.5, alpha=0.1)
        sched = CohortScheduler(tp, spec, cohort_size=csize, device="cpu")
        pop = ClientPopulation(spec, torch.zeros(dim))
        # the arena, and whatever lived before the run, are not the run's
        before = [x for x in _live_tensors()]
        skip = {id(x) for x in before}
        peak = [0]

        def data_fn(t, g, ids):
            ids = np.asarray(ids)
            if (ids[0] // csize) % 4 == 0:       # every fourth boundary
                sample(ids)
            xb = torch.linspace(-1, 1, dim).repeat(len(ids), 8, 1)
            yb = torch.from_numpy((ids % 7).astype(np.float32))[:, None] \
                * torch.ones(8)
            return (xb, yb)

        def sample(ids):
            live = [x for x in _live_tensors() if id(x) not in skip]
            for x in live:
                # (the kept generator state is a fixed 5056-byte tensor)
                assert n_total not in x.shape, x.shape
            peak[0] = max(peak[0], sum(x.numel() * x.element_size()
                                       for x in live))

        st, pop, _ = sched.run(torch.zeros(dim), data_fn, 0.2, key=0,
                               n_rounds=1, population=pop)
        assert pop.participation_counts.sum() > 0
        return peak[0]

    small, big = peak_for(64), peak_for(512)
    assert big <= small + (16 << 10), (small, big)


# ---------------------------------------------------------------------------
# server momentum through the scheduler
# ---------------------------------------------------------------------------

def test_server_momentum_first_round_matches_plain_sa():
    n, dim = 6, 32
    _, tb, _, tp = _quad(n, dim)
    base = dict(n_clients=n, participation=1.0, alpha=0.0, variates="off")
    plain = tapi.FederationSpec(**base)
    mom = tapi.FederationSpec(**base, server_momentum=0.7)

    def sched_run(spec, rounds, cohort_size=n):
        return CohortScheduler(tp, spec, cohort_size=cohort_size,
                               device="cpu").run(
            torch.zeros(dim), _slicing(tb), 0.3, key=0, n_rounds=rounds)

    _bits(sched_run(plain, 1)[0].x, sched_run(mom, 1)[0].x)
    st_p, st_m = sched_run(plain, 3)[0], sched_run(mom, 3)[0]
    assert not torch.allclose(st_p.x, st_m.x)
    assert float(st_m.opt.abs().max()) > 0.0
    # one full cohort with momentum is api.run with momentum, bit for bit
    st_r, _ = tapi.run(tp, torch.zeros(dim), lambda t, g: tb, 0.3, spec=mom,
                       key=0, n_rounds=4, device="cpu")
    st_s = sched_run(mom, 4)[0]
    _bits(st_r.x, st_s.x)
    _bits(st_r.opt, st_s.opt)
    # and over cohorts of 4, allclose
    assert_tree_close(sched_run(mom, 4, cohort_size=4)[0].x, st_r.x,
                      2e-5, 2e-6)


def test_server_momentum_exact_heavy_ball_recursion():
    """m_t = beta m_{t-1} + h_t, x_t = x_{t-1} + gamma m_t through the
    scheduler, against a hand-rolled recursion on the plain scheduler's h
    from the same state (cohorts of 4 of 6)."""
    n, dim, beta, gamma = 6, 16, 0.5, 0.2
    _, tb, _, tp = _quad(n, dim)
    base = dict(n_clients=n, participation=1.0, alpha=0.0, variates="off")
    plain = tapi.FederationSpec(**base)
    mom = tapi.FederationSpec(**base, server_momentum=beta)
    s_plain = CohortScheduler(tp, plain, cohort_size=4, device="cpu")
    s_mom = CohortScheduler(tp, mom, cohort_size=4, device="cpu")
    state_m = s_mom.init_state(torch.zeros(dim),
                               ClientPopulation(mom, torch.zeros(dim)))
    m_ref = torch.zeros(dim)
    for _ in range(3):
        new_p, _, _ = s_plain.run(torch.zeros(dim), _slicing(tb), gamma,
                                  key=0, n_rounds=1,
                                  state0=state_m._replace(opt=()))
        h = (new_p.x - state_m.x) / gamma
        new_m, _, _ = s_mom.run(torch.zeros(dim), _slicing(tb), gamma,
                                key=0, n_rounds=1, state0=state_m)
        m_ref = beta * m_ref + h
        x_ref = state_m.x + gamma * m_ref
        assert_tree_close(new_m.opt, m_ref, RTOL, ATOL)
        assert_tree_close(new_m.x, x_ref, RTOL, ATOL)
        state_m, m_ref = new_m, new_m.opt
