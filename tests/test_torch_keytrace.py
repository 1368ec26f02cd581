"""The port's generator-chain audit behind ``audit_keys=True``
(``repro_torch.analysis.keytrace``), the counterpart of
``tests/test_keytrace.py``, case for case.

Pinned here, as there:
  * bit-identity: ``api.run`` (off the mesh, and gather and reduce on a
    one-rank gloo mesh) and ``CohortScheduler.run`` (sync, async) give
    the same trajectories and metrics with the audit on;
  * two draws from one generator state at different sites raise
    ``KeyReuseError`` at the second, naming both sites (this file) and
    the sampler; ``raise_on_reuse=False`` collects instead;
  * an exact re-execution (same sampler, site and state: the scheduler's
    per-cohort ``data_fn`` re-derivation) is recorded, not flagged;
  * an audited ``resume()`` draws exactly the uninterrupted run's trace
    suffix;
  * ``activate()`` is re-entrant and restores the patched ``torch``
    attributes on exit, also when the body raises; draws on ``meta``
    tensors are skipped (the reference skips tracers and key tables);
  * centralized runs reject ``audit_keys``.

The port's chain is ``torch.Generator``s, not keys, so the two audits see
different draws and their traces are not compared event for event. What
is compared is the verdict: each driver and scheduler case runs the
reference's audited counterpart on the same data at the same sizes, and
the two agree on it (no reuse on the golden runs; the planted reuse
raised naming both sites in this file, or collected once a round; the
re-derived draw on the trace once a cohort and not flagged; the resumed
trace a suffix of the full run's; the centralized run rejected). The two
mechanics cases (patch and restore, fingerprints) have no reference
verdict to compare: each audit patches its own library.
"""
import datetime
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh
from torch.distributed.device_mesh import init_device_mesh

from repro import api as japi
from repro.analysis.keytrace import KeyAudit as JKeyAudit
from repro.analysis.keytrace import KeyReuseError as JKeyReuseError
from repro.core import compression as JC
from repro.core.quadratic import quadratic_for_objective as jquad
from repro.sched import CohortScheduler as JCohortScheduler
from repro_torch import api
from repro_torch.analysis.keytrace import (SAMPLERS, KeyAudit, KeyReuseError,
                                           _draw_fingerprint,
                                           generator_fingerprint)
from repro_torch.core import compression as C
from repro_torch.core.quadratic import quadratic_for_objective
from repro_torch.sched import CohortScheduler

JKEY = jax.random.PRNGKey(0)


def _bits(a, b, msg=""):
    for x, y in zip(torch.utils._pytree.tree_leaves(a),
                    torch.utils._pytree.tree_leaves(b)):
        assert torch.equal(x, y), msg


def _quad_problem(n_clients=8, dim=32, batch=16):
    rng = np.random.default_rng(0)
    Xs = torch.from_numpy(
        rng.standard_normal((n_clients, batch, dim)).astype(np.float32))
    w_i = torch.stack([torch.linspace(-1, 1, dim) + 2.0 * i
                       for i in range(n_clients)])
    ys = torch.einsum("nbp,np->nb", Xs, w_i)

    def loss(b, theta):
        xb, yb = b
        return 0.5 * torch.mean((xb @ theta - yb) ** 2)

    return (Xs, ys), api.as_problem(quadratic_for_objective(loss, rho=0.05))


def _reference(Xs, ys):
    """The same data and problem for the reference: ``((Xs, ys), problem)``
    in JAX."""
    def loss(b, theta):
        xb, yb = b
        return 0.5 * jnp.mean((xb @ theta - yb) ** 2)

    return ((jnp.asarray(Xs.numpy()), jnp.asarray(ys.numpy())),
            japi.as_problem(jquad(loss, rho=0.05)))


def _jspec(n, participation, quant=True):
    return japi.FederationSpec(
        n_clients=n, participation=participation, alpha=0.1,
        **({"compressor": JC.block_quant(8, 16)} if quant else {}))


def _slicing_data_fn(full):
    def data_fn(t, g, ids):
        return tuple(x[torch.as_tensor(ids)] for x in full(t, g))
    return data_fn


def _jslicing_data_fn(full):
    def data_fn(t, k, ids):
        return jax.tree.map(lambda x: x[np.asarray(ids)], full(t, k))
    return data_fn


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


# ---------------------------------------------------------------------------
# bit-identity: audit on == audit off
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_uplink", ["none", "gather", "reduce"])
def test_golden_run_bit_identical_with_audit(mesh_uplink, request):
    n, dim = 8, 32
    (Xs, ys), problem = _quad_problem(n_clients=n, dim=dim)
    spec = api.FederationSpec(n_clients=n, participation=0.5, alpha=0.1,
                              compressor=C.block_quant(8, 16))
    mesh = None
    if mesh_uplink != "none":
        request.getfixturevalue("one_rank")
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("clients",))
    uplink = "gather" if mesh_uplink == "none" else mesh_uplink
    kw = dict(spec=spec, key=0, n_rounds=5, mesh=mesh, uplink=uplink,
              eval_batch=(Xs[0], ys[0]), device="cpu")
    data = lambda t, g: (Xs, ys)                       # noqa: E731
    st_ref, m_ref = api.run(problem, torch.zeros(dim), data, 0.3, **kw)
    audit = KeyAudit()
    st, m = api.run(problem, torch.zeros(dim), data, 0.3, audit_keys=audit,
                    **kw)
    _bits(tuple(st_ref), tuple(st))
    for k in m_ref:
        assert torch.equal(m_ref[k], m[k]), k
    # the chain was watched: each round's participation draw is on it
    assert sum(1 for e in audit.report.events
               if e.kind == "consume:rand") >= 5
    # the reference's audit of the same run gives the same verdict
    (jXs, jys), jproblem = _reference(Xs, ys)
    jmesh = (None if mesh_uplink == "none"
             else Mesh(np.asarray(jax.devices()), ("clients",)))
    jaudit = JKeyAudit()
    japi.run(jproblem, jnp.zeros(dim), lambda t, k: (jXs, jys), 0.3,
             spec=_jspec(n, 0.5), key=JKEY, n_rounds=5, mesh=jmesh,
             uplink=uplink, eval_batch=(jXs[0], jys[0]), audit_keys=jaudit)
    assert len(jaudit.report) > 0
    assert audit.reuse_events == jaudit.reuse_events == []


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_golden_scheduler_bit_identical_with_audit(mode):
    n, dim = 8, 32
    (Xs, ys), problem = _quad_problem(n_clients=n, dim=dim)
    spec = api.FederationSpec(n_clients=n, participation=0.5, alpha=0.1,
                              compressor=C.block_quant(8, 16))
    data_fn = _slicing_data_fn(lambda t, g: (Xs, ys))
    kw = dict(key=0, n_rounds=4, mode=mode)
    st_ref, pop_ref, m_ref = CohortScheduler(
        problem, spec, cohort_size=4, device="cpu").run(
            torch.zeros(dim), data_fn, 0.3, **kw)
    audit = KeyAudit()
    st, pop, m = CohortScheduler(problem, spec, cohort_size=4,
                                 device="cpu").run(
        torch.zeros(dim), data_fn, 0.3, audit_keys=audit, **kw)
    _bits(tuple(st_ref), tuple(st))
    _bits(pop_ref.variates(), pop.variates())
    for k in m_ref:
        assert torch.equal(m_ref[k], m[k]), k
    assert len(audit.report) > 0
    (jXs, jys), jproblem = _reference(Xs, ys)
    jaudit = JKeyAudit()
    JCohortScheduler(jproblem, _jspec(n, 0.5), cohort_size=4).run(
        jnp.zeros(dim), _jslicing_data_fn(lambda t, k: (jXs, jys)), 0.3,
        key=JKEY, n_rounds=4, mode=mode, audit_keys=jaudit)
    assert len(jaudit.report) > 0
    assert audit.reuse_events == jaudit.reuse_events == []


# ---------------------------------------------------------------------------
# a state drawn from twice raises at the origin, naming both sites
# ---------------------------------------------------------------------------

def _bad_data(n, dim):
    def bad_data(t, g):
        twin = torch.Generator().set_state(g.get_state())
        xs = torch.randn((n, 16, dim), generator=g)
        ys = torch.randn((n, 16), generator=twin)   # BUG: g's state again
        return xs, ys
    return bad_data


def _jbad_data(n, dim):
    """``_bad_data`` in the reference: one key consumed twice."""
    def bad_data(t, k):
        xs = jax.random.normal(k, (n, 16, dim))
        ys = jax.random.normal(k, (n, 16))      # BUG: k consumed twice
        return xs, ys
    return bad_data


def test_double_consume_raises_at_origin():
    n, dim = 4, 8
    _, problem = _quad_problem(n_clients=n, dim=dim)
    spec = api.FederationSpec(n_clients=n, participation=1.0, alpha=0.1)
    with pytest.raises(KeyReuseError) as ei:
        api.run(problem, torch.zeros(dim), _bad_data(n, dim), 0.3,
                spec=spec, key=0, n_rounds=3, audit_keys=True, device="cpu")
    msg = str(ei.value)
    # the origin: both drawing sites are in THIS file, the sampler named
    assert msg.count("test_torch_keytrace.py") == 2
    assert "torch.randn" in msg
    # the reference raises for its counterpart, naming its sites here too
    with pytest.raises(JKeyReuseError) as jei:
        japi.run(_reference(torch.zeros(n, 16, dim), torch.zeros(n, 16))[1],
                 jnp.zeros(dim), _jbad_data(n, dim), 0.3,
                 spec=_jspec(n, 1.0, quant=False), key=JKEY, n_rounds=3,
                 audit_keys=True)
    assert str(jei.value).count("test_torch_keytrace.py") == 2


def test_double_consume_collected_when_not_raising():
    n, dim = 4, 8
    _, problem = _quad_problem(n_clients=n, dim=dim)
    spec = api.FederationSpec(n_clients=n, participation=1.0, alpha=0.1)
    audit = KeyAudit(raise_on_reuse=False)
    api.run(problem, torch.zeros(dim), _bad_data(n, dim), 0.3, spec=spec,
            key=0, n_rounds=3, audit_keys=audit, device="cpu")
    # one reuse per round, each pointing back at the first draw
    assert len(audit.reuse_events) == 3
    ev, first = audit.reuse_events[0]
    assert ev.key == first.key and ev.site != first.site
    # the reference collects as many, as alike
    jaudit = JKeyAudit(raise_on_reuse=False)
    japi.run(_reference(torch.zeros(n, 16, dim), torch.zeros(n, 16))[1],
             jnp.zeros(dim), _jbad_data(n, dim), 0.3,
             spec=_jspec(n, 1.0, quant=False), key=JKEY, n_rounds=3,
             audit_keys=jaudit)
    assert len(jaudit.reuse_events) == len(audit.reuse_events)
    ev, first = jaudit.reuse_events[0]
    assert ev.key == first.key and ev.site != first.site


def test_replay_at_same_site_is_allowed():
    """The re-derivation idiom: each cohort's ``data_fn(t, gen, ids)``
    gets a generator in the wave's state and re-draws the wave's batch
    at the same site. Recorded, not flagged."""
    n, dim = 8, 16
    _, problem = _quad_problem(n_clients=n, dim=dim)
    spec = api.FederationSpec(n_clients=n, participation=1.0, alpha=0.1)

    def drawing_data_fn(t, g, ids):
        xs = torch.randn((n, 16, dim), generator=g)
        ys = torch.einsum("nbp,p->nb", xs, torch.ones(dim))
        idx = torch.as_tensor(ids)
        return xs[idx], ys[idx]

    audit = KeyAudit()
    CohortScheduler(problem, spec, cohort_size=4, device="cpu").run(
        torch.zeros(dim), drawing_data_fn, 0.3, key=0, n_rounds=3,
        audit_keys=audit)
    assert audit.reuse_events == []
    # the replayed draw IS on the trace twice per round (once a cohort)
    n_draws = len([e for e in audit.report.events
                   if e.kind == "consume:randn"])
    assert n_draws == 6

    def jdrawing_data_fn(t, k, ids):
        xs = jax.random.normal(k, (n, 16, dim))
        ys = jnp.einsum("nbp,p->nb", xs, jnp.ones(dim))
        return jax.tree.map(lambda x: x[np.asarray(ids)], (xs, ys))

    # the reference: as many replays on its trace, none flagged
    jaudit = JKeyAudit()
    JCohortScheduler(_reference(torch.zeros(n, 16, dim),
                                torch.zeros(n, 16))[1],
                     _jspec(n, 1.0, quant=False), cohort_size=4).run(
        jnp.zeros(dim), jdrawing_data_fn, 0.3, key=JKEY, n_rounds=3,
        audit_keys=jaudit)
    assert jaudit.reuse_events == []
    assert len([e for e in jaudit.report.events
                if e.kind == "consume:normal"]) == n_draws


# ---------------------------------------------------------------------------
# an audited resume() draws the uninterrupted run's trace suffix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["sync", "async"])
def test_resume_replays_identical_trace_suffix(mode, tmp_path):
    n, dim = 8, 16
    (Xs, ys), problem = _quad_problem(n_clients=n, dim=dim)
    spec = api.FederationSpec(n_clients=n, participation=0.9, alpha=0.1,
                              compressor=C.block_quant(8, 16))
    data_fn = _slicing_data_fn(lambda t, g: (Xs, ys))

    def sched():
        return CohortScheduler(problem, spec, cohort_size=n, device="cpu")

    full = KeyAudit()
    sched().run(torch.zeros(dim), data_fn, 0.3, key=0, n_rounds=6,
                mode=mode, audit_keys=full)
    ck = str(tmp_path / "ck")
    sched().run(torch.zeros(dim), data_fn, 0.3, key=0, n_rounds=4,
                mode=mode, checkpoint_dir=ck, checkpoint_every=1)
    res = KeyAudit()
    sched().resume(torch.zeros(dim), data_fn, 0.3, checkpoint_dir=ck,
                   n_rounds=6, mode=mode, audit_keys=res)
    full_sig, res_sig = full.report.signature(), res.report.signature()
    assert 0 < len(res_sig) < len(full_sig)
    assert full_sig[-len(res_sig):] == res_sig
    # the reference's audited resume of the same run: a suffix too
    (jXs, jys), jproblem = _reference(Xs, ys)
    jdata_fn = _jslicing_data_fn(lambda t, k: (jXs, jys))

    def jsched():
        return JCohortScheduler(jproblem, _jspec(n, 0.9), cohort_size=n)

    jfull = JKeyAudit()
    jsched().run(jnp.zeros(dim), jdata_fn, 0.3, key=JKEY, n_rounds=6,
                 mode=mode, audit_keys=jfull)
    jck = str(tmp_path / "jck")
    jsched().run(jnp.zeros(dim), jdata_fn, 0.3, key=JKEY, n_rounds=4,
                 mode=mode, checkpoint_dir=jck, checkpoint_every=1)
    jres = JKeyAudit()
    jsched().resume(jnp.zeros(dim), jdata_fn, 0.3, checkpoint_dir=jck,
                    n_rounds=6, mode=mode, audit_keys=jres)
    jfull_sig, jres_sig = jfull.report.signature(), jres.report.signature()
    assert 0 < len(jres_sig) < len(jfull_sig)
    assert jfull_sig[-len(jres_sig):] == jres_sig


# ---------------------------------------------------------------------------
# mechanics: patch and restore, re-entrancy, fingerprints, rejection
# ---------------------------------------------------------------------------

def test_activate_restores_patches_even_on_error():
    orig = {name: getattr(torch, name) for name in SAMPLERS}
    audit = KeyAudit()
    with pytest.raises(RuntimeError, match="boom"):
        with audit.activate():
            assert torch.rand is not orig["rand"]
            with audit.activate():            # re-entrant: one patch set
                assert getattr(torch.rand, "_repro_key_audit", False)
            assert torch.rand is not orig["rand"]
            raise RuntimeError("boom")
    for name in SAMPLERS:
        assert getattr(torch, name) is orig[name], name


def test_fingerprint_skips_meta_and_reads_state():
    g = torch.Generator().manual_seed(3)
    twin = torch.Generator().manual_seed(3)
    assert generator_fingerprint(g) == generator_fingerprint(twin)
    assert _draw_fingerprint(((2,),), {"generator": g}) \
        == generator_fingerprint(g)
    # a draw without a generator reads the device's default generator
    assert _draw_fingerprint(((2,),), {}) \
        == generator_fingerprint(torch.default_generator)
    # meta draws have no state
    assert _draw_fingerprint(((2,),), {"device": "meta"}) is None
    assert _draw_fingerprint((torch.empty(3, device="meta"),), {}) is None
    audit = KeyAudit()
    with audit.activate():
        torch.rand((2,), device="meta")
        torch.rand((2,), generator=g)
    assert [e.kind for e in audit.report.events] == ["consume:rand"]
    # a drawn-from generator has moved on: a new state
    assert generator_fingerprint(g) != generator_fingerprint(twin)


def test_centralized_run_rejects_audit_keys():
    _, problem = _quad_problem(n_clients=2, dim=4)
    with pytest.raises(ValueError, match="audit_keys"):
        api.run(problem, torch.zeros(4), [(torch.ones((2, 4)),
                                           torch.ones(2))],
                0.3, audit_keys=True, device="cpu")
    # as the reference does
    with pytest.raises(ValueError, match="audit_keys"):
        japi.run(_reference(torch.ones(2, 2, 4), torch.ones(2, 2))[1],
                 jnp.zeros(4), [(jnp.ones((2, 4)), jnp.ones(2))], 0.3,
                 audit_keys=True)
