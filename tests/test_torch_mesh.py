"""The port's mesh path (``mesh=`` a ``DeviceMesh``, ``uplink`` gather or
reduce, the two-tier ``(edge, client)`` mesh) and the partitioned
``DTensor`` route of the compressor, on the CPU over gloo.

One rank in this process: the reference's one-device mesh cases
(``tests/test_sharded_driver.py``, ``tests/test_topology.py``) mirrored on
a one-rank gloo mesh, with the reference's draws handed in, and the
validation errors of ``launch.mesh`` and of ``step``.

Several ranks: ``tests/_torch_dist_worker.py`` runs as 2 and as 4
processes (one job each, started together, each with a hard timeout and a
60 s process-group timeout); this process runs the same cases without a
mesh and compares. Tolerances: gather is bit-identical to one process;
reduce re-associates the float32 sum, so it is held to the reference's
rtol 1e-5 / atol 1e-6 (atol 0.02 where the re-encoded tier boundary can
round a re-associated partial to the next level, as the reference holds
it); byte counts are bit-equal.
"""
import datetime
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh
from torch.distributed.device_mesh import init_device_mesh

from repro import api as japi
from repro.launch import mesh as jmesh
from repro.core import compression as JC
from repro.core.quadratic import quadratic_for_objective as jquad
from repro_torch import api as tapi
from repro_torch import interop
from repro_torch.core import compression as TC
from repro_torch.core.quadratic import quadratic_for_objective as tquad
from repro_torch.launch import mesh as tmesh

import _torch_dist_worker as W
from _torch_parity import (assert_tree_close, edge_seeds, np_of,
                           round_draws, to_torch)

KEY = jax.random.PRNGKey(0)
RTOL, ATOL = 1e-5, 1e-6
HERE = Path(__file__).resolve().parent
JOB_TIMEOUT = 120


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


def _client_mesh():
    return init_device_mesh("cpu", (1,), mesh_dim_names=("clients",))


def _quad(n_clients=8, dim=64):
    """``tests/test_sharded_driver.py:_quad_problem`` in both packages."""
    ks = jax.random.split(KEY, n_clients)
    Xs = jnp.stack([jax.random.normal(k, (32, dim)) for k in ks])
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


def _specs(n, topo=None, **kw):
    """The same spec in both packages; ``topo``: (n_edges, reencode)."""
    comp_kw = dict(bits=8, block=64, dither="hash")

    def build(mod, C):
        extra = ({} if topo is None else
                 {"topology": mod.Topology.two_tier(topo[0],
                                                    reencode=topo[1])})
        return mod.FederationSpec(n_clients=n,
                                  compressor=C.block_quant(**comp_kw),
                                  **extra, **kw)
    return build(japi, JC), build(tapi, TC)


def _port_run(tp, tspec, jspec, batches, rounds, **kw):
    """The port's rounds with the reference run's draws (and, under
    two-tier, its edge seeds). Returns (state, stacked metrics)."""
    tstate = tapi.init(tp, torch.zeros(64), tspec, device="cpu")
    tb = to_torch(tuple(map(np.asarray, batches)))
    key, hist = KEY, []
    topo = tspec.topology
    for _ in range(rounds):
        key, k_round, _, active, seeds = round_draws(key, jspec, 1)
        tstate, m = tapi.step(
            tp, tspec, tstate, tb, 0.3, None, active=torch.tensor(active),
            seeds=seeds, device="cpu",
            edge_seeds=(edge_seeds(k_round, topo.n_edges)
                        if topo.is_two_tier else None), **kw)
        hist.append(m)
    return tstate, {k: torch.stack([torch.as_tensor(m[k]) for m in hist])
                    for k in hist[0]}


# ---------------------------------------------------------------------------
# one rank: the reference's one-device mesh cases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variates,alpha", [("zero", 0.1), ("off", 0.0)])
def test_one_rank_mesh_uplinks_match_reference(one_rank, variates, alpha):
    """On a one-rank mesh the gather uplink is bit-identical to the
    single-device port, the reduce uplink allclose to it (and the
    reference's reduce-vs-gather check holds), and both are allclose to
    the reference's mesh runs with the same draws; n_active and
    comm_bytes bit-equal; the collective's operand is the gathered stack
    or the float32 partial."""
    n = 8
    (Xs, ys), jp, tp = _quad(n)
    jspec, tspec = _specs(n, participation=0.5, alpha=alpha,
                          variates=variates)
    jm = Mesh(np.asarray(jax.devices()[:1]), ("clients",))
    mesh = _client_mesh()
    runs = {}
    for uplink in ("gather", "reduce"):
        runs[uplink] = japi.run(jp, jnp.zeros(64), lambda t, k: (Xs, ys),
                                0.3, spec=jspec, key=KEY, n_rounds=8,
                                mesh=jm, uplink=uplink)
    st_0, h_0 = _port_run(tp, tspec, jspec, (Xs, ys), 8)
    st_g, h_g = _port_run(tp, tspec, jspec, (Xs, ys), 8, mesh=mesh)
    st_r, h_r = _port_run(tp, tspec, jspec, (Xs, ys), 8, mesh=mesh,
                          uplink="reduce")
    assert torch.equal(st_0.x, st_g.x)
    if variates == "zero":
        assert torch.equal(st_0.v, st_g.v) and torch.equal(st_0.v_i, st_g.v_i)
    for k in h_0:
        assert torch.equal(h_0[k], h_g[k]), k
    assert_tree_close(st_r.x, st_g.x, RTOL, ATOL)
    if variates == "zero":
        assert_tree_close(st_r.v_i, st_g.v_i, RTOL, ATOL)
        assert_tree_close(st_r.v, st_g.v, RTOL, ATOL)
    for k in ("n_active", "comm_bytes"):
        assert torch.equal(h_g[k], h_r[k]), k
    for uplink, st in (("gather", st_g), ("reduce", st_r)):
        assert_tree_close(st.x, runs[uplink][0].x, RTOL, ATOL, uplink)
        np.testing.assert_array_equal(
            h_g["comm_bytes"].numpy(),
            np.asarray(runs[uplink][1]["comm_bytes"]))
    payload_c = tspec.compressor.payload_bytes(torch.zeros(64))
    assert torch.equal(h_g["collective_payload_bytes"],
                       torch.full((8,), float(n * payload_c)))
    assert torch.equal(h_r["collective_payload_bytes"],
                       torch.full((8,), 64.0 * 4))
    np.testing.assert_array_equal(
        h_g["collective_payload_bytes"].numpy(),
        np.asarray(runs["gather"][1]["collective_payload_bytes"]))


def test_one_rank_mesh_run_slices_and_rebuilds(one_rank):
    """``run`` with mesh= on one rank is the single-device run, and
    ``interop.state_for_rank`` carries a reference state to the rank."""
    (Xs, ys), jp, tp = _quad(4)
    jspec, tspec = _specs(4, participation=0.5, alpha=0.1)
    tb = to_torch((np.asarray(Xs), np.asarray(ys)))
    mesh = _client_mesh()
    a = tapi.run(tp, torch.zeros(64), tb, 0.3, spec=tspec, key=3,
                 n_rounds=3, device="cpu")
    b = tapi.run(tp, torch.zeros(64), tb, 0.3, spec=tspec, key=3,
                 n_rounds=3, device="cpu", mesh=mesh)
    assert torch.equal(a[0].x, b[0].x) and torch.equal(a[0].v_i, b[0].v_i)
    assert set(b[1]) == set(a[1]) | {"collective_payload_bytes"}
    js = japi.init(jp, jnp.zeros(64), jspec)
    ours = interop.state_for_rank(jax.tree.map(np.asarray, js), tspec, mesh,
                                  device="cpu")
    assert ours.v_i.shape == (4, 64)
    np.testing.assert_array_equal(np_of(ours.v), np.asarray(js.v))


def test_one_rank_mesh_zero_active_round_stays_finite(one_rank):
    n = 8
    (Xs, ys), _, tp = _quad(n)
    tb = to_torch((np.asarray(Xs), np.asarray(ys)))
    mesh = _client_mesh()
    for normalization in ("expected", "realized"):
        _, spec = _specs(n, participation=0.5, alpha=0.1,
                         normalization=normalization)
        state = tapi.init(tp, torch.zeros(64), spec, device="cpu")
        for uplink in ("gather", "reduce"):
            new, m = tapi.step(tp, spec, state, tb, 0.3,
                               torch.Generator().manual_seed(0),
                               active=torch.zeros(n, dtype=torch.bool),
                               mesh=mesh, uplink=uplink, device="cpu")
            assert float(m["n_active"]) == 0.0
            assert float(m["comm_bytes"]) == 0.0
            for leaf in (new.x, new.v, new.v_i):
                assert torch.isfinite(leaf).all(), (normalization, uplink)


def test_two_tier_one_edge_mesh_matches_off_mesh(one_rank):
    """The 1 x 1 (edge, client) mesh: gather bit-identical to the off-mesh
    two-tier run, reduce allclose; both allclose to the reference's."""
    n = 8
    (Xs, ys), jp, tp = _quad(n)
    jspec, tspec = _specs(n, (1, False), participation=0.5, alpha=0.1)
    jst, _ = japi.run(jp, jnp.zeros(64), lambda t, k: (Xs, ys), 0.3,
                      spec=jspec, key=KEY, n_rounds=5,
                      mesh=jmesh.make_edge_mesh(1, 1), client_axis="client")
    emesh = tmesh.make_edge_mesh(1, 1, device="cpu")
    st0, h0 = _port_run(tp, tspec, jspec, (Xs, ys), 5)
    st1, h1 = _port_run(tp, tspec, jspec, (Xs, ys), 5, mesh=emesh,
                        client_axis="client")
    st2, h2 = _port_run(tp, tspec, jspec, (Xs, ys), 5, mesh=emesh,
                        client_axis="client", uplink="reduce")
    assert torch.equal(st0.x, st1.x)
    for k in h0:
        assert torch.equal(h0[k], h1[k]), k
    assert_tree_close(st2.x, st0.x, RTOL, ATOL)
    for k in ("n_active", "uplink_bytes", "backbone_bytes", "comm_bytes"):
        assert torch.equal(h0[k], h2[k]), k
    assert_tree_close(st1.x, jst.x, RTOL, ATOL)


def test_make_edge_mesh_and_cohort_capacity_raise_what_the_reference_raises(
        one_rank):
    for kw, match in ((dict(n_edges=0), "n_edges"),
                      (dict(n_edges=1, clients_per_edge=1, edge_axis="x",
                            client_axis="x"), "must differ"),
                      (dict(n_edges=2, clients_per_edge=2), "devices"),
                      (dict(n_edges=2), "split over"),
                      (dict(n_edges=1, clients_per_edge=0),
                       "clients_per_edge")):
        for make in (jmesh.make_edge_mesh,
                     lambda **k: tmesh.make_edge_mesh(device="cpu", **k)):
            with pytest.raises(ValueError, match=match):
                make(**kw)
    jm, tm = jmesh.make_edge_mesh(1, 1), tmesh.make_edge_mesh(1, 1,
                                                              device="cpu")
    assert tm.mesh_dim_names == tuple(jm.axis_names) == ("edge", "client")
    for axes, per in (("client", 1), (("edge", "client"), 1),
                      (("edge", "client"), 4)):
        assert tmesh.cohort_capacity(tm, axes, per) == \
            jmesh.cohort_capacity(jm, axes, per)
    for axes, per, match in ((("edge", "nope"), 1,
                              r"client_axis='nope' not an axis"),
                             ((), 1, "at least one"),
                             ("client", 0, "per_device")):
        for cap, m in ((jmesh.cohort_capacity, jm),
                       (tmesh.cohort_capacity, tm)):
            with pytest.raises(ValueError, match=match):
                cap(m, axes, per)


def test_validation_errors_match_the_reference(one_rank):
    """``step``'s knob checks raise what the reference's
    ``_validate_topology`` raises, plus the port's own: a mesh that is not
    a DeviceMesh, and client batches that are not the rank's rows."""
    n = 8
    (Xs, ys), jp, tp = _quad(n)
    mesh, emesh = _client_mesh(), tmesh.make_edge_mesh(1, 1, device="cpu")
    jm = Mesh(np.asarray(jax.devices()[:1]), ("clients",))
    jem = jmesh.make_edge_mesh(1, 1)
    tb = to_torch((np.asarray(Xs), np.asarray(ys)))
    g = torch.Generator().manual_seed(0)
    jspec, tspec = _specs(n)
    j2, t2 = _specs(n, (2, False))
    jc = japi.FederationSpec(n_clients=n, topology=japi.Topology.two_tier(
        2, edge_axis="client"))
    tc = tapi.FederationSpec(n_clients=n, topology=tapi.Topology.two_tier(
        2, edge_axis="client"))
    cases = (
        (jspec, tspec, (jm, mesh), dict(client_axis="nope"), "client_axis"),
        (jspec, tspec, (jm, mesh), dict(client_mode="scan"), "scan"),
        (jspec, tspec, (None, None), dict(client_mode="pmap"), "client_mode"),
        (jspec, tspec, (jm, mesh), dict(uplink="psum"), "uplink"),
        (jspec, tspec, (None, None), dict(uplink="reduce"), "mesh"),
        (j2, t2, (jm, mesh), {}, "make_edge_mesh"),
        (j2, t2, (jem, emesh), dict(client_axis="client"),
         "one mesh row per edge"),
        (jc, tc, (jem, emesh), dict(client_axis="client"),
         "collides with client_axis"),
    )
    for js, ts, (jmesh_, tmesh_), kw, match in cases:
        jstate = japi.init(jp, jnp.zeros(64), js)
        tstate = tapi.init(tp, torch.zeros(64), ts, device="cpu")
        with pytest.raises(ValueError, match=match):
            japi.step(jp, js, jstate, (Xs, ys), 0.3, KEY, mesh=jmesh_, **kw)
        with pytest.raises(ValueError, match=match):
            tapi.step(tp, ts, tstate, tb, 0.3, g, mesh=tmesh_, device="cpu",
                      **kw)
    tstate = tapi.init(tp, torch.zeros(64), tspec, device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        tapi.step(tp, tspec, tstate, tb, 0.3, g, mesh=jm, device="cpu")
    with pytest.raises(ValueError, match="rank"):
        tapi.step(tp, tspec, tstate, (tb[0][:4], tb[1][:4]), 0.3, g,
                  mesh=mesh, device="cpu")


# ---------------------------------------------------------------------------
# several ranks: the worker jobs
# ---------------------------------------------------------------------------

def _start(job: str, world: int, io_dir: Path):
    np.savez(io_dir / "inputs.npz", **W.make_inputs())
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    return [subprocess.Popen(
        [sys.executable, str(HERE / "_torch_dist_worker.py"), job, str(r),
         str(world), str(port), str(io_dir)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(world)]


def _finish(procs) -> None:
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=JOB_TIMEOUT)
            logs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    assert codes == [0] * len(procs), "\n".join(logs)[-4000:]


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """Both worker jobs, started together: ``{world: [out_rank, ...]}``."""
    dirs = {w: tmp_path_factory.mktemp(f"ranks{w}") for w in (2, 4)}
    procs = {w: _start({2: "two", 4: "four"}[w], w, d)
             for w, d in dirs.items()}
    for w in procs:
        _finish(procs[w])
    return {w: [dict(np.load(d / f"out_{r}.npz")) for r in range(w)]
            for w, d in dirs.items()}


@pytest.fixture(scope="module")
def single():
    """Every case run in this process without a mesh."""
    inp = W.make_inputs()
    data = (torch.tensor(inp["X"]), torch.tensor(inp["Y"]))
    return {name: W.run_case(case, data) for name, case in W.CASES.items()}


def _state_of(outs, name, field):
    """A field of the ranks' states; ``v_i``'s blocks in client order."""
    keys = sorted({k.split("/")[-1] for k in outs[0]
                   if k.startswith(f"{name}/{field}/")})
    if field != "v_i":
        return {k: outs[0][f"{name}/{field}/{k}"] for k in keys}
    order = sorted(range(len(outs)), key=lambda r: outs[r][f"{name}/rows"][0])
    return {k: np.concatenate([outs[r][f"{name}/{field}/{k}"] for r in order])
            for k in keys}


def _metrics(outs, name):
    pre = f"{name}/m/"
    return {k[len(pre):]: v for k, v in outs[0].items() if k.startswith(pre)}


def _case_ids(uplink, edge):
    return [(w, name) for w in (2, 4) for name, c in W.cases_for(w).items()
            if c["uplink"] == uplink and ("edges" in c) == edge]


@pytest.mark.parametrize("world,name", _case_ids("gather", False))
def test_gloo_gather_bit_identical_to_one_process(jobs, single, world, name):
    outs = jobs[world]
    st, hist = single[name]
    for field in ("x", "v", "v_i"):
        for k, v in _state_of(outs, name, field).items():
            np.testing.assert_array_equal(
                v, getattr(st, field)[k].numpy(), err_msg=f"{field}/{k}")
    m = _metrics(outs, name)
    for k, v in hist.items():
        np.testing.assert_array_equal(m[k], v.numpy(), err_msg=k)
    payload_c = W.spec().compressor.payload_bytes(W.x0())
    np.testing.assert_array_equal(m["collective_payload_bytes"],
                                  np.full(W.ROUNDS, W.N_CLIENTS * payload_c))


@pytest.mark.parametrize("world,name", _case_ids("reduce", False))
def test_gloo_reduce_allclose_with_v_i_in_client_order(jobs, single, world,
                                                       name):
    outs = jobs[world]
    st, hist = single[name]
    for field in ("x", "v", "v_i"):
        for k, v in _state_of(outs, name, field).items():
            np.testing.assert_allclose(v, getattr(st, field)[k].numpy(),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"{field}/{k}")
    m = _metrics(outs, name)
    for k in ("n_active", "uplink_bytes", "comm_bytes"):
        np.testing.assert_array_equal(m[k], hist[k].numpy(), err_msg=k)
    model = sum(v.numel() * 4 for v in W.x0().values())
    np.testing.assert_array_equal(m["collective_payload_bytes"],
                                  np.full(W.ROUNDS, float(model)))


@pytest.mark.parametrize("name", [n for _, n in _case_ids("gather", True)]
                         + [n for _, n in _case_ids("reduce", True)])
def test_gloo_edge_mesh_against_off_mesh_two_tier(jobs, single, name):
    """The 2 x 2 (edge, client) mesh: gather bit-identical to the off-mesh
    two-tier run; reduce allclose (atol 0.02 with reencode); every byte
    count bit-equal."""
    outs, case = jobs[4], W.CASES[name]
    st, hist = single[name]
    tol = (dict(rtol=0, atol=0.02) if case["reencode"]
           else dict(rtol=RTOL, atol=ATOL))
    for k, v in _state_of(outs, name, "x").items():
        if case["uplink"] == "gather":
            np.testing.assert_array_equal(v, st.x[k].numpy(), err_msg=k)
        else:
            np.testing.assert_allclose(v, st.x[k].numpy(), err_msg=k, **tol)
    m = _metrics(outs, name)
    for k in ("n_active", "uplink_bytes", "backbone_bytes", "comm_bytes"):
        np.testing.assert_array_equal(m[k], hist[k].numpy(), err_msg=k)


def test_device_mesh_rank_order_is_edge_major(jobs):
    """``make_edge_mesh`` over 4 ranks: rank r sits at (r // 2, r % 2) and
    holds client block r, so the edges own contiguous client blocks in
    the order ``Topology.edge_ids`` assigns."""
    outs = jobs[4]
    edge_ids = W.topology(W.CASES["edge_gather_raw"]).edge_ids(W.N_CLIENTS)
    for r, o in enumerate(outs):
        assert o["edge_coordinate"].tolist() == [r // 2, r % 2]
        assert int(o["edge_capacity"]) == 4
        lo, hi = o["edge_gather_raw/rows"].tolist()
        assert (lo, hi) == (2 * r, 2 * r + 2)
        assert set(edge_ids[lo:hi].tolist()) == {r // 2}


@pytest.mark.parametrize("placement", ["shard0", "shard1"])
def test_partitioned_dtensor_leaves_bit_identical(jobs, placement):
    """apply and encode of a leaf partitioned over 2 ranks take the
    per-shard route and equal the unsharded plain version bit for bit
    (codes, scales, digest, and decode . encode == apply), placed like
    the leaf."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((8, 4096), generator=gen) * 2.0
    kw = dict(bits=8, block=128, shard_safe=True, dither="hash")
    plain = dict(kw, kernel_threshold=1 << 62)
    want_a = TC.quantize_leaf(11, x, **plain)
    want_p = TC.encode_leaf(11, x, checksum=True, **plain)
    assert torch.equal(want_a, TC.quantize_leaf(11, x, kernel_threshold=1,
                                                **kw))
    for o in jobs[2]:
        pre = f"dt/{placement}/hash/"
        assert str(o[f"dt/{placement}/route"]) == "shard_map"
        np.testing.assert_array_equal(o[pre + "apply"], want_a.numpy())
        np.testing.assert_array_equal(o[pre + "codes"],
                                      want_p.codes.numpy())
        np.testing.assert_array_equal(o[pre + "scales"],
                                      want_p.scales.numpy())
        np.testing.assert_array_equal(o[pre + "check"], want_p.check.numpy())
        np.testing.assert_array_equal(o[pre + "decoded"], want_a.numpy())
        assert o[pre + "placed"].all()


@pytest.mark.parametrize("placement", ["shard0", "shard1"])
def test_kernel_dither_on_partitioned_leaf_degrades_to_hash(jobs, placement):
    """dither='kernel' on a partitioned leaf streams the hash draws, so
    it equals dither='hash' bit for bit (the reference's
    ``test_kernel_dither_on_sharded_leaf_degrades_to_streamed_hash``)."""
    for o in jobs[2]:
        for part in ("apply", "codes", "scales", "check"):
            np.testing.assert_array_equal(
                o[f"dt/{placement}/kernel/{part}"],
                o[f"dt/{placement}/hash/{part}"], err_msg=part)


def test_uneven_client_split_raises(jobs):
    """6 clients do not divide over 4 ranks; batches that are not the
    rank's rows are refused (recorded by every rank of the 4-rank job)."""
    for o in jobs[4]:
        assert str(o["errors/divide"]).startswith("ValueError")
        assert "divide evenly" in str(o["errors/divide"])
        assert str(o["errors/rows"]).startswith("ValueError")
