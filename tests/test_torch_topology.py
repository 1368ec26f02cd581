"""The port's two-tier topology off the mesh against the JAX package's:
``tests/test_topology.py``'s trajectories and byte accounting, with the
reference's participation masks, per-client dither seeds and per-edge
tier-boundary seeds handed to the port's ``step`` (``active=``,
``seeds=``, ``edge_seeds=``).

Tolerances are the reference's own: a two-tier trajectory matches the
flat one (and the port's matches the reference's) to rtol 1e-5 / atol
1e-6; the re-encoded boundary is lossy, so a re-encoded run is held
within atol 0.02 of the raw one. ``uplink_bytes``, ``backbone_bytes``
and ``comm_bytes`` are bit-equal to the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.api.driver import _edge_keys, tier_boundary as jtier_boundary
from repro.core import compression as JC
from repro.core.quadratic import quadratic_for_objective as jquad
from repro_torch import api as tapi
from repro_torch.core import compression as TC
from repro_torch.core.quadratic import quadratic_for_objective as tquad

from _torch_parity import (assert_tree_close, edge_seeds, np_of,
                           round_draws, state_to_torch, to_torch)

KEY = jax.random.PRNGKey(0)
RTOL, ATOL = 1e-5, 1e-6
# the dither both packages draw alike: the murmur hash of the index
COMP_KW = dict(bits=8, block=32, dither="hash", checksum=True)


def _quad(n_clients=8, dim=64):
    """``tests/test_topology.py:_quad_problem`` in both packages."""
    ks = jax.random.split(KEY, n_clients)
    Xs = jnp.stack([jax.random.normal(k, (16, dim)) for k in ks])
    w_i = jnp.stack([jnp.linspace(-1, 1, dim) + 2.0 * i
                     for i in range(n_clients)])
    ys = jnp.einsum("nbp,np->nb", Xs, w_i)

    def jloss(batch, theta):
        xb, yb = batch
        return 0.5 * jnp.mean((xb @ theta - yb) ** 2)

    def tloss(batch, theta):
        xb, yb = batch
        return 0.5 * torch.mean((xb @ theta - yb) ** 2)

    return ((Xs, ys), japi.as_problem(jquad(jloss, rho=0.05)),
            tapi.as_problem(tquad(tloss, rho=0.05)))


def _specs(n, n_edges=None, reencode=False, comp_kw=COMP_KW, **kw):
    """The same spec in both packages (flat, or two-tier over n_edges)."""
    def build(mod, C):
        topo = ({} if n_edges is None else
                {"topology": mod.Topology.two_tier(n_edges,
                                                   reencode=reencode)})
        return mod.FederationSpec(n_clients=n,
                                  compressor=C.block_quant(**comp_kw),
                                  **topo, **kw)
    return build(japi, JC), build(tapi, TC)


def _port_rounds(tp, tspec, jspec, batches, gamma, rounds, client_mode,
                 dim=64):
    """The port's trajectory with the reference run's draws, round by
    round. Returns (final state, list of per-round metrics)."""
    tstate = tapi.init(tp, torch.zeros(dim), tspec, device="cpu")
    tb = to_torch(tuple(map(np.asarray, batches)))
    key, hist = KEY, []
    topo = tspec.topology
    for _ in range(rounds):
        key, k_round, _, active, seeds = round_draws(key, jspec, 1)
        e_seeds = (edge_seeds(k_round, topo.n_edges)
                   if topo.is_two_tier else None)
        tstate, m = tapi.step(tp, tspec, tstate, tb, torch.tensor(gamma),
                              None, active=torch.tensor(active), seeds=seeds,
                              edge_seeds=e_seeds, device="cpu",
                              client_mode=client_mode)
        hist.append(m)
    return tstate, hist


def _col(hist, k):
    return np.array([float(m[k]) for m in hist], np.float32)


@pytest.mark.parametrize("reencode", [False, True])
@pytest.mark.parametrize("client_mode", ["vmap", "scan"])
def test_two_tier_trajectory_matches_reference(client_mode, reencode):
    """The port's two-tier run (3 edges over 8 clients) against the
    reference's, draw for draw: the iterate and variates within the
    golden tolerance, every byte count bit-equal."""
    (Xs, ys), jp, tp = _quad()
    jspec, tspec = _specs(8, 3, reencode,
                          participation=0.6, alpha=0.1)
    rounds = 6
    jst, jh = japi.run(jp, jnp.zeros(64), lambda t, k: (Xs, ys), 0.3,
                       spec=jspec, key=KEY, n_rounds=rounds,
                       client_mode=client_mode)
    tst, th = _port_rounds(tp, tspec, jspec, (Xs, ys), 0.3, rounds,
                           client_mode)
    assert_tree_close(tst.x, jst.x, RTOL, ATOL, "x")
    assert_tree_close(tst.v, jst.v, RTOL, ATOL, "v")
    assert_tree_close(tst.v_i, jst.v_i, RTOL, ATOL, "v_i")
    for k in ("n_active", "uplink_bytes", "backbone_bytes", "comm_bytes"):
        np.testing.assert_array_equal(_col(th, k), np.asarray(jh[k]),
                                      err_msg=k)
    np.testing.assert_allclose(_col(th, "e_s"), np.asarray(jh["e_s"]),
                               rtol=1e-4)


@pytest.mark.parametrize("client_mode", ["vmap", "scan"])
def test_two_tier_allclose_to_flat_with_exact_bytes(client_mode):
    """``test_topology.py``'s check on the port: two-tier without
    reencode only re-associates the reduce, so with the same draws it
    matches the flat run; the uplink is the same wire and the backbone
    bills the raw float32 edge partials. (A two-tier round draws its edge
    seeds after the flat round's draws, so the same draws are handed to
    both here.)"""
    n, dim, n_edges = 8, 64, 3
    (Xs, ys), _, tp = _quad(n, dim)
    jflat, flat = _specs(n, participation=0.6, alpha=0.1)
    _, two = _specs(n, n_edges, participation=0.6, alpha=0.1)
    st_f, h_f = _port_rounds(tp, flat, jflat, (Xs, ys), 0.3, 6, client_mode)
    st_t, h_t = _port_rounds(tp, two, jflat, (Xs, ys), 0.3, 6, client_mode)
    assert_tree_close(st_t.x, st_f.x, RTOL, ATOL)
    for k in ("n_active", "uplink_bytes"):
        np.testing.assert_array_equal(_col(h_f, k), _col(h_t, k), err_msg=k)
    np.testing.assert_array_equal(_col(h_f, "backbone_bytes"), np.zeros(6))
    np.testing.assert_array_equal(_col(h_f, "comm_bytes"),
                                  _col(h_f, "uplink_bytes"))
    np.testing.assert_array_equal(_col(h_t, "backbone_bytes"),
                                  np.full(6, n_edges * dim * 4, np.float32))
    np.testing.assert_array_equal(
        _col(h_t, "comm_bytes"),
        _col(h_t, "uplink_bytes") + _col(h_t, "backbone_bytes"))


@pytest.mark.parametrize("client_mode", ["vmap", "scan"])
def test_two_tier_reencode_compresses_the_backbone(client_mode):
    """reencode=True bills the re-encoded edge payloads (fewer bytes than
    the raw partials and than the uplink) and stays within the
    reference's lossy bound of the raw run."""
    n, dim, n_edges = 8, 64, 3
    (Xs, ys), _, tp = _quad(n, dim)
    _, raw = _specs(n, n_edges, participation=1.0, alpha=0.1)
    _, re = _specs(n, n_edges, True, participation=1.0,
                   alpha=0.1)
    tb = to_torch((np.asarray(Xs), np.asarray(ys)))
    kw = dict(key=5, n_rounds=6, client_mode=client_mode, device="cpu")
    st_r, h_r = tapi.run(tp, torch.zeros(dim), tb, 0.3, spec=raw, **kw)
    st_e, h_e = tapi.run(tp, torch.zeros(dim), tb, 0.3, spec=re, **kw)
    assert_tree_close(st_e.x, st_r.x, rtol=0, atol=0.02)
    comp = re.compressor
    per_payload = comp.encoded_bytes(comp.encode([0], torch.zeros(dim)))
    assert per_payload == JC.block_quant(**COMP_KW).encoded_bytes(
        JC.block_quant(**COMP_KW).encode(KEY, jnp.zeros(dim)))
    assert torch.equal(h_e["backbone_bytes"],
                       torch.full((6,), float(n_edges * per_payload)))
    assert (h_e["backbone_bytes"] < h_r["backbone_bytes"]).all()
    assert (h_e["backbone_bytes"] < h_e["uplink_bytes"]).all()


@pytest.mark.parametrize("normalization", ["expected", "realized"])
@pytest.mark.parametrize("reencode", [False, True])
def test_ragged_edges_and_zero_active_edge(normalization, reencode):
    """Edges of sizes (2, 2, 1), a round where edge 2's only client sat
    out and a round where no one came: finite, with the reference's exact
    n_active / uplink / backbone / comm bytes."""
    n, dim, n_edges = 5, 64, 3
    (Xs, ys), jp, tp = _quad(n, dim)
    jspec, tspec = _specs(n, n_edges, reencode, alpha=0.1,
                          normalization=normalization)
    assert tspec.topology.edge_sizes(n) == (2, 2, 1)
    tstate = tapi.init(tp, torch.zeros(dim), tspec, device="cpu")
    jstate = japi.init(jp, jnp.zeros(dim), jspec)
    tb = to_torch((np.asarray(Xs), np.asarray(ys)))
    seeds = np.arange(n, dtype=np.int64).reshape(n, 1) + 100
    edge_seeds = np.arange(n_edges, dtype=np.int64).reshape(n_edges, 1) + 7
    for active in ([1, 1, 1, 1, 0], [0, 0, 0, 0, 0]):
        new, m = tapi.step(tp, tspec, tstate, tb, 0.3, None,
                           active=torch.tensor(active, dtype=torch.bool),
                           seeds=seeds, edge_seeds=edge_seeds, device="cpu")
        _, jm = japi.step(jp, jspec, jstate, (Xs, ys), 0.3, KEY,
                          active=jnp.asarray(active, bool))
        for k in ("n_active", "uplink_bytes", "backbone_bytes",
                  "comm_bytes"):
            assert float(m[k]) == float(jm[k]), k
        for leaf in (new.x, new.v, new.v_i):
            assert torch.isfinite(leaf).all()
    assert float(m["uplink_bytes"]) == 0.0


def test_two_tier_ragged_run_allclose_to_flat():
    """A ragged population (n=5 over 3 edges) matches the flat run drawn
    alike."""
    n, dim = 5, 64
    (Xs, ys), _, tp = _quad(n, dim)
    jflat, flat = _specs(n, participation=0.6)
    _, two = _specs(n, 3, participation=0.6)
    st_f, h_f = _port_rounds(tp, flat, jflat, (Xs, ys), 0.3, 6, "vmap")
    st_t, h_t = _port_rounds(tp, two, jflat, (Xs, ys), 0.3, 6, "vmap")
    assert_tree_close(st_t.x, st_f.x, RTOL, ATOL)
    for k in ("n_active", "uplink_bytes"):
        np.testing.assert_array_equal(_col(h_f, k), _col(h_t, k), err_msg=k)


@pytest.mark.parametrize("reencode", [False, True])
def test_tier_boundary_matches_reference(reencode):
    """The tier crossing alone: the same float32 edge partials and edge
    seeds give the reference's aggregate and backbone bytes."""
    n_edges, dim = 3, 4096
    rng = np.random.default_rng(0)
    parts = {"w": rng.standard_normal((n_edges, 8, dim)).astype(np.float32),
             "b": rng.standard_normal((n_edges, dim)).astype(np.float32)}
    x_ref = {"w": np.zeros((8, dim), np.float32),
             "b": np.zeros((dim,), np.float32)}
    comp_kw = dict(bits=8, block=256, dither="hash", checksum=True)
    jspec, tspec = _specs(4, n_edges, reencode, comp_kw=comp_kw)
    keys = _edge_keys(KEY, n_edges)
    jagg, jbytes = jtier_boundary(
        jspec, jax.tree.map(jnp.asarray, parts), keys,
        jax.tree.map(jnp.asarray, x_ref))
    tagg, tbytes = tapi.tier_boundary(
        tspec, to_torch(parts), edge_seeds(KEY, n_edges, n_leaves=2),
        to_torch(x_ref))
    assert tbytes == jbytes
    assert_tree_close(tagg, jagg, RTOL, ATOL)


def test_edge_seeds_are_drawn_only_under_two_tier():
    """Flat rounds draw what they always drew (the mask, then the client
    seeds); a two-tier round then draws one seed per edge and leaf. With
    no key, a two-tier round needs edge_seeds=."""
    n, dim = 4, 64
    (Xs, ys), _, tp = _quad(n, dim)
    _, flat = _specs(n, participation=0.5)
    _, two = _specs(n, 2, participation=0.5)
    tb = to_torch((np.asarray(Xs), np.asarray(ys)))
    st = tapi.init(tp, torch.zeros(dim), flat, device="cpu")
    g_flat, g_two, g_draw = (torch.Generator().manual_seed(4)
                             for _ in range(3))
    tapi.step(tp, flat, st, tb, 0.3, g_flat, device="cpu")
    tapi.participation_draw(g_draw, flat, 1)
    assert torch.equal(g_flat.get_state(), g_draw.get_state())
    tapi.step(tp, two, st, tb, 0.3, g_two, device="cpu")
    assert not torch.equal(g_two.get_state(), g_draw.get_state())
    TC.leaf_seeds(g_draw, 1)
    TC.leaf_seeds(g_draw, 1)
    assert torch.equal(g_two.get_state(), g_draw.get_state())
    with pytest.raises(ValueError, match="edge_seeds"):
        tapi.step(tp, two, st, tb, 0.3, None, active=torch.ones(n),
                  seeds=np.zeros((n, 1), np.int64), device="cpu")


def test_reference_state_carries_over_to_two_tier_rounds():
    """One reference two-tier round, its state carried across by interop,
    then the next round in both packages: the same iterate."""
    (Xs, ys), jp, tp = _quad()
    jspec, tspec = _specs(8, 2, True, participation=0.5,
                          alpha=0.1)
    jstate = japi.init(jp, jnp.zeros(64), jspec)
    key = KEY
    for _ in range(2):
        key, k_round, _, active, seeds = round_draws(key, jspec, 1)
        tstate = state_to_torch(jax.tree.map(np.asarray, jstate))
        tnew, _ = tapi.step(tp, tspec, tstate,
                            to_torch((np.asarray(Xs), np.asarray(ys))), 0.3,
                            None, active=torch.tensor(active), seeds=seeds,
                            edge_seeds=edge_seeds(k_round, 2), device="cpu")
        jstate, _ = japi.step(jp, jspec, jstate, (Xs, ys), 0.3, k_round)
        np.testing.assert_allclose(np_of(tnew.x), np.asarray(jstate.x),
                                   rtol=RTOL, atol=ATOL)
