"""The port's fault axis, wire damage and crash-consistent resume
(``repro_torch.faults``, ``repro_torch.checkpoint`` and the scheduler's
``checkpoint_dir``/``resume()``) against ``tests/test_faults.py``'s
contracts and, where the packages can be held side by side, against the
JAX package itself:

  * ``FaultSpec`` and the spec's fault checks raise where the
    reference's raise;
  * ``corrupt_payload`` is bit for bit the reference's for every kind,
    on the same codes and scales;
  * a round with the reference's fault draws handed in (``fault_draws=``)
    matches the reference's ``step`` (rtol 1e-5 / atol 1e-6, the byte
    counts exact) and is, in the port, bit for bit the round with the
    equivalent participation draw;
  * detection has probability one, NaN scale bits never reach the
    aggregate;
  * zero-probability faults are bit for bit ``faults=None``; the retry
    ladder bills and abandons; the straggler is force-drained once;
  * kill and resume (in process, and a real SIGKILL in a subprocess) are
    bit for bit the uninterrupted run;
  * the snapshot codec and the population snapshot round-trip, and a file
    of the reference's ``save_snapshot`` reads back in the port.

The scheduler runs here hand in the reference's draws through
``draws=`` where the reference's outcome is predicted from its chain.
"""
import dataclasses
import glob
import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import compression as JC
from repro.core.quadratic import quadratic_for_objective as jquad
from repro.faults import FaultSpec as JFaultSpec
from repro.faults import corrupt_payload as jcorrupt
from repro.faults import save_snapshot as jsave_snapshot
from repro.sched import CohortScheduler as JCohortScheduler
from repro_torch import api as tapi
from repro_torch import checkpoint as tckpt
from repro_torch.core import compression as TC
from repro_torch.core.quadratic import quadratic_for_objective as tquad
from repro_torch.faults import (CORRUPT_KINDS, FaultSpec, ServerKilled,
                                corrupt_payload, load_snapshot,
                                save_snapshot)
from repro_torch.sched import ClientPopulation, CohortScheduler
import repro_torch.sched.scheduler as sched_mod

from _torch_parity import (assert_bits_equal, assert_tree_close,
                           client_seeds, round_draws, to_torch)

KEY = jax.random.PRNGKey(0)
RTOL, ATOL = 1e-5, 1e-6
HERE = Path(__file__).resolve().parent
SUBPROCESS_TIMEOUT = 240
COMP_KW = dict(bits=8, block=16, dither="hash", checksum=True)


def _quad(n_clients=8, dim=16, batch=8):
    """``tests/test_faults.py:_quad_problem`` in both packages."""
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
    def bits(x):
        return x.view(torch.int16) if (isinstance(x, torch.Tensor) and
                                       x.dtype == torch.bfloat16) else x
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb), msg
    for x, y in zip(la, lb):
        assert_bits_equal(bits(x), bits(y), msg)


def _metrics_bit_equal(m_ref, m):
    assert set(m_ref) == set(m), (sorted(m_ref), sorted(m))
    for k in m_ref:
        assert_bits_equal(m_ref[k], m[k], k)


def _spec(n, faults=None, comp_kw=COMP_KW, **kw):
    return tapi.FederationSpec(n_clients=n,
                               compressor=TC.block_quant(**comp_kw),
                               faults=faults, **kw)


# ---------------------------------------------------------------------------
# FaultSpec / FederationSpec validation, against the reference's
# ---------------------------------------------------------------------------

FAULT_CASES = [
    dict(dropout=1.5), dict(corrupt=1.5), dict(straggle=1.5),
    dict(cohort_fail=1.5), dict(dropout=-0.1), dict(corrupt_kind="nope"),
    dict(max_retries=-1), dict(straggle_delay=-1), dict(retry_backoff=-1),
    dict(kill_round=-2), dict(cohort_fail=1.0), dict(), dict(kill_round=3),
    dict(dropout=0.1), dict(corrupt=0.2, corrupt_kind="scales"),
    dict(straggle=0.5, straggle_delay=4), dict(cohort_fail=0.9,
                                               max_retries=0),
]


@pytest.mark.parametrize("case", FAULT_CASES, ids=str)
def test_faultspec_validation_matches_reference(case):
    try:
        ref = JFaultSpec(**case)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            FaultSpec(**case)
        # the same field is named in both messages
        field = next(iter(case)) if case else ""
        assert field.split("_")[0] in str(got.value), (str(e), got.value)
        return
    ours = FaultSpec(**case)
    assert ours.any_injection == ref.any_injection
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert set(CORRUPT_KINDS) == {"flip", "truncate", "scales"}


def test_spec_rejects_corrupt_without_checksummed_wire():
    with pytest.raises(ValueError, match="checksum"):
        japi.FederationSpec(n_clients=4, faults=JFaultSpec(corrupt=0.5),
                            compressor=JC.block_quant(8, 16))
    with pytest.raises(ValueError, match="checksum"):
        tapi.FederationSpec(n_clients=4, faults=FaultSpec(corrupt=0.5),
                            compressor=TC.block_quant(8, 16))
    with pytest.raises(ValueError, match="checksum"):
        tapi.FederationSpec(n_clients=4, faults=FaultSpec(corrupt=0.5))
    with pytest.raises(ValueError, match="FaultSpec"):
        tapi.FederationSpec(n_clients=4, faults="dropout")
    with pytest.raises(ValueError, match="FaultSpec"):
        tapi.FederationSpec(n_clients=4, faults=JFaultSpec(dropout=0.1))
    tapi.FederationSpec(n_clients=4, faults=FaultSpec(corrupt=0.5),
                        compressor=TC.block_quant(8, 16, checksum=True))
    # dropout alone needs no checksum
    tapi.FederationSpec(n_clients=4, faults=FaultSpec(dropout=0.5))


def test_fault_lanes_are_private_and_stable():
    """The lanes depend on (seed, index, salt) only: the same draw twice,
    a different one for another round, and the chain generator untouched."""
    fs = FaultSpec(dropout=0.5, corrupt=0.5, cohort_fail=0.3, straggle=0.5)
    d1, c1 = fs.client_draw(7, 3, 64)
    d2, c2 = fs.client_draw(7, 3, 64)
    assert torch.equal(d1, d2) and torch.equal(c1, c2)
    assert not bool((c1 & d1).any())           # dropped is never corrupt
    d3, _ = fs.client_draw(7, 4, 64)
    assert not torch.equal(d1, d3)
    f1, s1 = fs.cohort_draw(7, 3, 5)
    assert f1.shape == (5, 3) and f1.dtype == torch.float32
    assert s1.shape == (5,) and s1.dtype == torch.bool
    z = FaultSpec().client_draw(7, 3, 64)
    assert not bool(z[0].any()) and not bool(z[1].any())


# ---------------------------------------------------------------------------
# corrupt_payload, bit for bit the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("kind", ["flip", "truncate", "scales"])
def test_corrupt_payload_bit_identical_to_reference(kind, bits):
    n, dim = 6, 64
    rng = np.random.default_rng(3)
    D = rng.standard_normal((n, dim)).astype(np.float32) * 2.0
    kw = dict(bits=bits, block=16, dither="hash", checksum=True)
    jcomp, tcomp = JC.block_quant(**kw), TC.block_quant(**kw)
    keys = jax.random.split(KEY, n)
    jpay = jax.vmap(jcomp.encode)(keys, jnp.asarray(D))
    seeds = client_seeds(keys, 1)
    tpay = TC.stack_payloads([tcomp.encode(seeds[c], torch.tensor(D[c]))
                              for c in range(n)])
    _bits(tpay.codes, jpay.codes, "codes before damage")
    flag = np.array([True, False, True, True, False, False])
    jd = jcorrupt(jpay, jnp.asarray(flag), kind)
    td = corrupt_payload(tpay, torch.tensor(flag), kind)
    assert_bits_equal(td.codes, jd.codes, "codes")
    assert_bits_equal(td.scales, jd.scales, "scales")
    assert_bits_equal(td.check, jd.check, "check rides untouched")
    ok_j = np.asarray(JC.verify_payload(jd))
    ok_t = TC.verify_payload(td).numpy()
    np.testing.assert_array_equal(ok_t, ok_j)
    np.testing.assert_array_equal(ok_t, ~flag)     # every flagged row caught
    # one client's unstacked payload takes a scalar flag
    one = tcomp.encode(seeds[0], torch.tensor(D[0]))
    assert not bool(TC.verify_payload(corrupt_payload(one, True, kind)))
    assert bool(TC.verify_payload(corrupt_payload(one, False, kind)))


# ---------------------------------------------------------------------------
# a corrupted round IS an equivalent participation draw
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("client_mode", ["vmap", "scan"])
@pytest.mark.parametrize("normalization", ["expected", "realized"])
def test_corrupt_round_equals_equivalent_draw(normalization, client_mode):
    """The reference's fault draws handed to the port's ``step``: the
    state within rtol 1e-5 / atol 1e-6 of the reference's fault round,
    the counts and bytes exact; and in the port, the fault round is bit
    for bit the round whose mask leaves out the dropped and corrupt
    clients, while the corrupt clients are still billed."""
    n, dim = 8, 16
    (Xs, ys), tb, jp, tp = _quad(n, dim)
    jfs = JFaultSpec(dropout=0.25, corrupt=0.5, corrupt_kind="flip")
    fs = FaultSpec(dropout=0.25, corrupt=0.5, corrupt_kind="flip")
    kw = dict(participation=0.8, alpha=0.1, normalization=normalization)
    jspec = japi.FederationSpec(n_clients=n, compressor=JC.block_quant(
        **COMP_KW), faults=jfs, **kw)
    tspec_f = _spec(n, fs, **kw)
    tspec_p = dataclasses.replace(tspec_f, faults=None)
    jst = japi.init(jp, jnp.zeros(dim), jspec)
    st_f = tapi.init(tp, torch.zeros(dim), tspec_f, device="cpu")
    st_p = tapi.init(tp, torch.zeros(dim), tspec_p, device="cpu")
    key = KEY
    saw_corruption = False
    per_client = tspec_f.compressor.payload_bytes(torch.zeros(dim))
    for _ in range(3):
        key, k = jax.random.split(key)
        jst, jm = japi.step(jp, jspec, jst, (Xs, ys), 0.3, k,
                            client_mode=client_mode)
        act, qkeys = japi.participation_draw(k, jspec)
        drop, corr = (np.asarray(d) for d in jfs.client_draw(k, n))
        act = np.asarray(act)
        seeds = client_seeds(qkeys, 1)
        st_f, m_f = tapi.step(tp, tspec_f, st_f, tb, 0.3, None,
                              active=torch.tensor(act), seeds=seeds,
                              fault_draws=(drop, corr), device="cpu",
                              client_mode=client_mode)
        act_eff = act & ~drop & ~corr
        st_p, m_p = tapi.step(tp, tspec_p, st_p, tb, 0.3, None,
                              active=torch.tensor(act_eff), seeds=seeds,
                              device="cpu", client_mode=client_mode)
        assert_tree_close(st_f.x, jst.x, RTOL, ATOL, "x vs reference")
        assert_tree_close(st_f.v_i, jst.v_i, RTOL, ATOL, "v_i vs reference")
        for k_ in ("n_active", "comm_bytes", "uplink_bytes"):
            assert_bits_equal(m_f[k_], jm[k_], k_)
        _bits(st_f.x, st_p.x, "iterate")
        _bits(st_f.v, st_p.v, "server variate")
        _bits(st_f.v_i, st_p.v_i, "client variates")
        assert_bits_equal(m_f["n_active"], m_p["n_active"])
        n_sent = int(np.sum(act & ~drop))
        n_eff = int(np.sum(act_eff))
        saw_corruption |= n_sent > n_eff
        assert float(m_f["n_active"]) == float(n_eff)
        assert float(m_f["comm_bytes"]) == pytest.approx(per_client * n_sent)
        assert float(m_p["comm_bytes"]) == pytest.approx(per_client * n_eff)
    assert saw_corruption, "draws never corrupted a survivor — re-seed"


def test_step_draws_faults_from_its_lanes():
    """With a key and no fault_draws, ``step`` draws from the lanes of
    (key.initial_seed(), state.step): the round equals the one with those
    draws handed in."""
    n, dim = 8, 16
    _, tb, _, tp = _quad(n, dim)
    fs = FaultSpec(dropout=0.3, corrupt=0.3, corrupt_kind="truncate")
    spec = _spec(n, fs, participation=0.9, alpha=0.1)
    st = tapi.init(tp, torch.zeros(dim), spec, device="cpu")
    st = st._replace(step=torch.tensor(5))
    a, _ = tapi.step(tp, spec, st, tb, 0.3, torch.Generator().manual_seed(11),
                     device="cpu")
    g = torch.Generator().manual_seed(11)
    act, seeds = tapi.participation_draw(g, spec, 1)
    b, _ = tapi.step(tp, spec, st, tb, 0.3, None, active=act, seeds=seeds,
                     fault_draws=fs.client_draw(11, 5, n), device="cpu")
    _bits(a.x, b.x)
    with pytest.raises(ValueError, match="fault_draws"):
        tapi.step(tp, spec, st, tb, 0.3, None, active=act, seeds=seeds,
                  device="cpu")


def _ref_draws(jspec, jfs, rounds, k_cohorts, n_leaves=1):
    """The reference scheduler's per-round draws (sync chain), as the
    port's ``draws=`` hook takes them."""
    key, out = KEY, []
    n = jspec.n_clients
    for _ in range(rounds):
        key, k_round, _, active, seeds = round_draws(key, jspec, n_leaves)
        d = {"active": active, "seeds": seeds}
        if jfs is not None and jfs.any_injection:
            drop, corr = jfs.client_draw(k_round, n)
            fail_u, straggle = jfs.cohort_draw(k_round, k_cohorts)
            d.update(drop=np.asarray(drop), corrupt=np.asarray(corr),
                     fail_u=np.asarray(fail_u), straggle=np.asarray(straggle))
        out.append(d)
    return out


@pytest.mark.parametrize("kind", ["flip", "truncate", "scales"])
def test_corruption_detected_with_probability_one(kind):
    """Over a ragged, padded cohort layout with the reference's draws:
    every corrupt survivor leaves ``n_active`` every round, and NaN scale
    bits never reach the iterate."""
    n, dim, csize, rounds = 10, 16, 4, 5
    (Xs, ys), tb, jp, tp = _quad(n, dim)
    kw = dict(participation=0.9, alpha=0.1)
    jfs = JFaultSpec(dropout=0.15, corrupt=0.6, corrupt_kind=kind)
    jspec = japi.FederationSpec(n_clients=n, compressor=JC.block_quant(
        **COMP_KW), faults=jfs, **kw)
    spec = _spec(n, FaultSpec(dropout=0.15, corrupt=0.6, corrupt_kind=kind),
                 **kw)
    draws = _ref_draws(jspec, jfs, rounds, -(-n // csize))
    sched = CohortScheduler(tp, spec, cohort_size=csize, device="cpu")
    st, pop, m = sched.run(torch.zeros(dim), _slicing(tb), 0.3, key=0,
                           n_rounds=rounds, draws=draws.__getitem__)
    assert bool(torch.isfinite(st.x).all()), "corruption leaked NaN"
    assert bool(torch.isfinite(st.v).all())
    expected = [float(np.sum(d["active"] & ~d["drop"] & ~d["corrupt"]))
                for d in draws]
    assert_bits_equal(m["n_active"], np.asarray(expected, np.float32))
    # the reference's scheduler, on the same draws, counts the same
    _, _, jm = JCohortScheduler(jp, jspec, cohort_size=csize).run(
        jnp.zeros(dim), lambda t, k, ids: (Xs[np.asarray(ids)],
                                           ys[np.asarray(ids)]),
        0.3, key=KEY, n_rounds=rounds)
    for k_ in ("n_active", "comm_bytes", "fault_retries", "fault_abandoned"):
        assert_bits_equal(m[k_], jm[k_], k_)


# ---------------------------------------------------------------------------
# zero-probability faults == faults=None, bit for bit (port against port)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["sync", "async"])
def test_zero_prob_faultspec_bit_identical(mode):
    n, dim = 8, 16
    _, tb, _, tp = _quad(n, dim)

    def one(faults):
        spec = _spec(n, faults, participation=0.6, alpha=0.1)
        sched = CohortScheduler(tp, spec, cohort_size=4, device="cpu")
        return sched.run(torch.zeros(dim), _slicing(tb), 0.3, key=0,
                         n_rounds=4, mode=mode)

    st_ref, pop_ref, m_ref = one(None)
    st, pop, m = one(FaultSpec(kill_round=None))
    _bits(st_ref.x, st.x)
    _bits(st_ref.v, st.v)
    _bits(pop_ref.variates(), pop.variates())
    np.testing.assert_array_equal(pop_ref.participation_counts,
                                  pop.participation_counts)
    _metrics_bit_equal(m_ref, m)
    # and api.run: a zero-probability spec changes nothing either
    spec0 = _spec(n, FaultSpec(), participation=0.6, alpha=0.1)
    a, ma = tapi.run(tp, torch.zeros(dim), lambda t, g: tb, 0.3, spec=spec0,
                     key=0, n_rounds=3, device="cpu")
    b, mb = tapi.run(tp, torch.zeros(dim), lambda t, g: tb, 0.3,
                     spec=dataclasses.replace(spec0, faults=None), key=0,
                     n_rounds=3, device="cpu")
    _bits(a.x, b.x)
    _metrics_bit_equal(ma, mb)


# ---------------------------------------------------------------------------
# cohort failure: the retry ladder (sync)
# ---------------------------------------------------------------------------

def _fixed(fail_rows, straggle, n, drop=None):
    """A draws hook pinning every wave's cohort draws (and no client
    faults unless ``drop``)."""
    def hook(index):
        z = np.zeros((n,), bool)
        return {"fail_u": np.asarray(fail_rows, np.float32),
                "straggle": np.asarray(straggle, bool),
                "drop": z if drop is None else np.asarray(drop, bool),
                "corrupt": z.copy()}
    return hook


def test_sync_retry_billing_and_abandonment():
    """Cohort 0's ladder fails all 3 attempts (abandoned); cohort 1 fails
    once then lands. Every failed attempt bills its bytes; the abandoned
    cohort is bit for bit its clients dropped."""
    n, dim, csize = 8, 16, 4
    _, tb, _, tp = _quad(n, dim)
    spec = _spec(n, FaultSpec(cohort_fail=0.5, max_retries=2),
                 participation=1.0, alpha=0.1)
    sched = CohortScheduler(tp, spec, cohort_size=csize, device="cpu")
    st, pop, m = sched.run(
        torch.zeros(dim), _slicing(tb), 0.3, key=0, n_rounds=3,
        draws=_fixed([[0.0, 0.0, 0.0], [0.0, 1.0, 1.0]], [False, False], n))
    assert_bits_equal(m["fault_retries"], np.full((3,), 4.0, np.float32))
    assert_bits_equal(m["fault_abandoned"], np.ones((3,), np.float32))
    assert_bits_equal(m["n_active"], np.full((3,), 4.0, np.float32))
    per_client = spec.compressor.payload_bytes(torch.zeros(dim))
    assert_bits_equal(m["comm_bytes"],
                      np.full((3,), 5 * 4 * per_client, np.float32))
    drop = np.zeros((n,), bool)
    drop[:csize] = True
    spec_d = dataclasses.replace(spec, faults=FaultSpec(dropout=0.5))
    st_d, pop_d, m_d = CohortScheduler(
        tp, spec_d, cohort_size=csize, device="cpu").run(
        torch.zeros(dim), _slicing(tb), 0.3, key=0, n_rounds=3,
        draws=_fixed(np.ones((2, 3)), [False, False], n, drop=drop))
    _bits(st.x, st_d.x)
    _bits(st.v, st_d.v)
    assert_bits_equal(m["n_active"], m_d["n_active"])
    np.testing.assert_array_equal(pop.participation_counts,
                                  pop_d.participation_counts)


# ---------------------------------------------------------------------------
# the failure x staleness corner, pinned move by move
# ---------------------------------------------------------------------------

def test_async_straggler_failure_force_drained_exactly_once(monkeypatch):
    n, dim, csize = 8, 16, 4
    _, tb, _, tp = _quad(n, dim)
    spec = _spec(n, FaultSpec(straggle=1.0, straggle_delay=5,
                              cohort_fail=0.5, max_retries=2,
                              retry_backoff=1),
                 participation=1.0, alpha=0.1, max_staleness=1,
                 staleness_weight=lambda tau: 1.0 / (1.0 + tau))
    sched = CohortScheduler(tp, spec, cohort_size=csize, device="cpu")
    launched, counts = {}, [0, 0]
    orig_rc = CohortScheduler._run_cohort

    def spy_rc(self, state, batch, ids, valid, wave, pop):
        partial, mask = orig_rc(self, state, batch, ids, valid, wave, pop)
        ci = int(ids[0]) // csize
        launched[id(partial)] = (ci, counts[ci])
        counts[ci] += 1
        return partial, mask

    adds = []
    orig_add = sched_mod._PartialBuffer.add

    def spy_add(self, partial, weight, tau=0):
        adds.append(launched[id(partial)] + (float(weight), int(tau)))
        return orig_add(self, partial, weight, tau)

    monkeypatch.setattr(CohortScheduler, "_run_cohort", spy_rc)
    monkeypatch.setattr(sched_mod._PartialBuffer, "add", spy_add)
    st, pop, m = sched.run(
        torch.zeros(dim), _slicing(tb), 0.3, key=0, n_rounds=2,
        mode="async", max_inflight=3, buffer_cohorts=2,
        draws=_fixed([[0.0, 1.0, 1.0], [1.0, 1.0, 1.0]], [True, False], n))
    assert adds == [
        (1, 0, 1.0, 0),     # c1 wave0: prio 1 beats the straggler's 0+5
        (0, 0, 1.0, 0),     # c0 wave0: failed once, retried, landed fresh
        (0, 1, 0.5, 1),     # c0 wave1: forced drain at tau=1, w=1/2
        (1, 1, 1.0, 0),     # c1 wave1
    ], adds
    assert_bits_equal(m["staleness_max"], np.asarray([0.0, 1.0], np.float32))
    assert_bits_equal(m["staleness_mean"], np.asarray([0.0, 0.5], np.float32))
    assert_bits_equal(m["fault_retries"], np.asarray([1.0, 1.0], np.float32))
    assert_bits_equal(m["fault_abandoned"], np.zeros((2,), np.float32))
    assert_bits_equal(m["n_active"], np.full((2,), 8.0, np.float32))


# ---------------------------------------------------------------------------
# crash-consistent checkpoints and resume
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["sync", "async"])
def test_kill_and_resume_bit_identical(mode, tmp_path):
    n, dim = 8, 16
    _, tb, _, tp = _quad(n, dim)
    eval_batch = (tb[0][0], tb[1][0])
    kw = dict(max_inflight=4, buffer_cohorts=2) if mode == "async" else {}
    base = dict(dropout=0.2, corrupt=0.3, corrupt_kind="scales",
                cohort_fail=0.3, max_retries=2)
    sw = (dict(max_staleness=2, staleness_weight=lambda t: 1.0 / (1.0 + t))
          if mode == "async" else {})

    def mkspec(**faults):
        return _spec(n, FaultSpec(**faults), participation=0.9, alpha=0.1,
                     **sw)

    run_kw = dict(n_rounds=6, mode=mode, eval_batch=eval_batch,
                  eval_every=2, **kw)
    st_ref, pop_ref, m_ref = CohortScheduler(
        tp, mkspec(**base), cohort_size=4, device="cpu").run(
        torch.zeros(dim), _slicing(tb), 0.3, key=0, **run_kw)
    ck = str(tmp_path / "ck")
    sched = CohortScheduler(tp, mkspec(**base, kill_round=4), cohort_size=4,
                            device="cpu")
    with pytest.raises(ServerKilled) as ei:
        sched.run(torch.zeros(dim), _slicing(tb), 0.3, key=0,
                  checkpoint_dir=ck, **run_kw)
    assert ei.value.round_index == 4
    assert glob.glob(os.path.join(ck, "round_*.snap"))
    st, pop, m = sched.resume(torch.zeros(dim), _slicing(tb), 0.3,
                              checkpoint_dir=ck, **run_kw)
    _bits(st_ref.x, st.x)
    _bits(st_ref.v, st.v)
    _bits(pop_ref.variates(), pop.variates())
    np.testing.assert_array_equal(pop_ref.participation_counts,
                                  pop.participation_counts)
    assert pop_ref.rounds_seen == pop.rounds_seen
    _metrics_bit_equal(m_ref, m)


def test_checkpoint_pruning_and_resume_errors(tmp_path):
    n, dim = 8, 16
    _, tb, _, tp = _quad(n, dim)
    spec = _spec(n, participation=0.8, alpha=0.1)
    sched = CohortScheduler(tp, spec, cohort_size=4, device="cpu")
    ck = str(tmp_path / "ck")
    data_fn = _slicing(tb)
    with pytest.raises(FileNotFoundError, match="nothing to resume"):
        sched.resume(torch.zeros(dim), data_fn, 0.3, checkpoint_dir=ck,
                     n_rounds=3)
    _, _, m_ref = sched.run(torch.zeros(dim), data_fn, 0.3, key=0,
                            n_rounds=6)
    st, _, m = sched.run(torch.zeros(dim), data_fn, 0.3, key=0, n_rounds=6,
                         checkpoint_dir=ck)
    snaps = sorted(glob.glob(os.path.join(ck, "round_*.snap")))
    assert len(snaps) == sched_mod._CKPT_KEEP
    assert snaps[-1].endswith("round_000006.snap")
    with pytest.raises(ValueError, match="mode"):
        sched.resume(torch.zeros(dim), data_fn, 0.3, checkpoint_dir=ck,
                     n_rounds=6, mode="async")
    st2, _, m2 = sched.resume(torch.zeros(dim), data_fn, 0.3,
                              checkpoint_dir=ck, n_rounds=6)
    _bits(st.x, st2.x)
    _metrics_bit_equal(m_ref, m2)
    with pytest.raises(ValueError, match="treedef|leaf"):
        CohortScheduler(tp, spec, cohort_size=4, device="cpu").resume(
            torch.zeros(dim + 1), lambda t, g, ids: None, 0.3,
            checkpoint_dir=ck, n_rounds=6)
    # the runtime checks only read: sanitized and audited runs, and an
    # audited, sanitized resume, are the plain run bit for bit
    for kw in (dict(sanitize=True), dict(audit_keys=True)):
        st3, _, m3 = sched.run(torch.zeros(dim), data_fn, 0.3, key=0,
                               n_rounds=6, **kw)
        _bits(st.x, st3.x)
        _metrics_bit_equal(m_ref, m3)
    st4, _, m4 = sched.resume(torch.zeros(dim), data_fn, 0.3,
                              checkpoint_dir=ck, n_rounds=6, sanitize=True,
                              audit_keys=True)
    _bits(st.x, st4.x)
    _metrics_bit_equal(m_ref, m4)


def test_resume_midway_without_kill(tmp_path):
    n, dim = 8, 16
    _, tb, _, tp = _quad(n, dim)
    spec = _spec(n, FaultSpec(dropout=0.2, cohort_fail=0.3),
                 participation=0.8, alpha=0.1)
    sched = CohortScheduler(tp, spec, cohort_size=4, device="cpu")
    data_fn = _slicing(tb)
    st_ref, _, m_ref = sched.run(torch.zeros(dim), data_fn, 0.3, key=0,
                                 n_rounds=5)
    ck = str(tmp_path / "ck")
    sched.run(torch.zeros(dim), data_fn, 0.3, key=0, n_rounds=3,
              checkpoint_dir=ck, checkpoint_every=3)
    assert [os.path.basename(p) for p in
            sorted(glob.glob(os.path.join(ck, "round_*.snap")))] == \
        ["round_000003.snap"]
    st, _, m = sched.resume(torch.zeros(dim), data_fn, 0.3,
                            checkpoint_dir=ck, n_rounds=5)
    _bits(st_ref.x, st.x)
    _metrics_bit_equal(m_ref, m)


_SIGKILL_SCRIPT = r"""
import os, signal, sys
import numpy as np
import torch
from repro_torch import api
from repro_torch.core import compression as C
from repro_torch.core.quadratic import quadratic_for_objective
from repro_torch.faults import FaultSpec
from repro_torch.sched import CohortScheduler

n, dim = 8, 16
g = torch.Generator().manual_seed(0)
Xs = torch.randn((n, 8, dim), generator=g)
w_i = torch.stack([torch.linspace(-1, 1, dim) + 2.0 * i for i in range(n)])
ys = torch.einsum("nbp,np->nb", Xs, w_i)

def loss(b, theta):
    xb, yb = b
    return 0.5 * torch.mean((xb @ theta - yb) ** 2)

problem = api.as_problem(quadratic_for_objective(loss, rho=0.05))
spec = api.FederationSpec(
    n_clients=n, participation=0.9, alpha=0.1,
    compressor=C.block_quant(8, 16, dither="hash", checksum=True),
    faults=FaultSpec(dropout=0.2, corrupt=0.3, cohort_fail=0.3))
ck, phase = sys.argv[1], sys.argv[2]
kill_at = 4 if phase == "kill" else -1

def data_fn(t, gen, ids):
    if t == kill_at:
        os.kill(os.getpid(), signal.SIGKILL)   # a real crash: no cleanup
    ids = torch.as_tensor(np.asarray(ids))
    return (Xs[ids], ys[ids])

sched = CohortScheduler(problem, spec, cohort_size=4, device="cpu")
if phase == "kill":
    sched.run(torch.zeros(dim), data_fn, 0.3, key=0, n_rounds=6,
              checkpoint_dir=ck)
    raise SystemExit("survived a SIGKILL?")
if phase == "resume":
    st, pop, m = sched.resume(torch.zeros(dim), data_fn, 0.3,
                              checkpoint_dir=ck, n_rounds=6)
else:
    st, pop, m = sched.run(torch.zeros(dim), data_fn, 0.3, key=0,
                           n_rounds=6)
np.savez(sys.argv[3], x=st.x.numpy(), v=st.v.numpy(),
         counts=pop.participation_counts,
         **{f"m_{k}": v.numpy() for k, v in m.items()})
"""


def test_sigkill_and_resume_subprocess(tmp_path):
    """A real SIGKILL mid-run: the atomic snapshots survive, and resume()
    in a fresh process is bit for bit the uninterrupted run. Each
    subprocess has its own time limit."""
    ck = str(tmp_path / "ck")
    script = tmp_path / "driver.py"
    script.write_text(_SIGKILL_SCRIPT)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(HERE.parent / "src"),
                                         env.get("PYTHONPATH", "")])
    r = subprocess.run([sys.executable, str(script), ck, "kill", "-"],
                       env=env, capture_output=True, text=True,
                       timeout=SUBPROCESS_TIMEOUT)
    assert r.returncode == -signal.SIGKILL, (r.returncode, r.stderr)
    assert glob.glob(os.path.join(ck, "round_*.snap")), "no snapshot"
    ref, out = str(tmp_path / "ref.npz"), str(tmp_path / "resumed.npz")
    for phase, path in (("full", ref), ("resume", out)):
        r = subprocess.run([sys.executable, str(script), ck, phase, path],
                           env=env, capture_output=True, text=True,
                           timeout=SUBPROCESS_TIMEOUT)
        assert r.returncode == 0, r.stderr
    a, b = np.load(ref), np.load(out)
    assert set(a.files) == set(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ---------------------------------------------------------------------------
# the snapshot codec, the pytree checkpoint, population snapshots
# ---------------------------------------------------------------------------

def test_snapshot_codec_roundtrip(tmp_path):
    obj = {
        "mode": "async",
        "cursor": 7,
        "flag": True,
        "nothing": None,
        "gamma": 0.25,
        "key": np.arange(2, dtype=np.uint32),
        "rows": [{"a": np.float32(1.5)}, {"a": np.float32(2.5)}],
        "pair": (np.ones((2, 3), np.float32), [1, 2, 3]),
        "nested": {"deep": ({"x": np.zeros(4)},)},
        "t32": torch.arange(6, dtype=torch.float32).reshape(2, 3),
        "bf16": torch.tensor([1.5, -2.25, 3e-3], dtype=torch.bfloat16),
        "gen": torch.Generator().manual_seed(3).get_state(),
    }
    path = str(tmp_path / "snap.snap")
    save_snapshot(path, obj)
    back = load_snapshot(path)
    assert back["mode"] == "async" and back["cursor"] == 7
    assert back["flag"] is True and back["nothing"] is None
    assert back["gamma"] == 0.25
    assert isinstance(back["pair"], tuple) and isinstance(back["rows"], list)
    np.testing.assert_array_equal(back["key"], obj["key"])
    np.testing.assert_array_equal(back["pair"][0], obj["pair"][0])
    assert back["pair"][1] == [1, 2, 3]
    np.testing.assert_array_equal(back["nested"]["deep"][0]["x"], np.zeros(4))
    for k in ("t32", "bf16", "gen"):
        assert isinstance(back[k], torch.Tensor)
        assert back[k].dtype == obj[k].dtype
        assert_bits_equal(back[k].view(torch.int16) if k == "bf16"
                          else back[k],
                          obj[k].view(torch.int16) if k == "bf16" else obj[k])
    g = torch.Generator()
    g.set_state(back["gen"])
    assert torch.equal(torch.rand(4, generator=g),
                       torch.rand(4, generator=torch.Generator().manual_seed(
                           3)))
    with pytest.raises(TypeError, match="object"):
        save_snapshot(str(tmp_path / "bad.snap"), {"f": lambda: None})
    with pytest.raises(TypeError, match="keys"):
        save_snapshot(str(tmp_path / "bad.snap"), {1: "x"})
    assert not glob.glob(str(tmp_path / "bad.snap*"))   # nothing torn left


def test_reference_snapshot_reads_in_the_port(tmp_path):
    """One file written by the reference's ``save_snapshot`` from plain
    numpy structures reads back with the port's ``load_snapshot``."""
    obj = {"mode": "sync", "cursor": 3, "gamma": 0.5, "none": None,
           "arr": np.arange(12, dtype=np.float32).reshape(3, 4),
           "ids": np.arange(5, dtype=np.int64),
           "rows": [{"loss": np.float32(0.75)}], "t": (1, [2.0, "x"])}
    path = str(tmp_path / "ref.snap")
    jsave_snapshot(path, obj)
    back = load_snapshot(path)
    assert set(back) == set(obj)
    for k in ("mode", "cursor", "gamma", "none", "t"):
        assert back[k] == obj[k]
    np.testing.assert_array_equal(back["arr"], obj["arr"])
    assert back["arr"].dtype == np.float32
    np.testing.assert_array_equal(back["ids"], obj["ids"])
    np.testing.assert_array_equal(back["rows"][0]["loss"], np.float32(0.75))


def test_pytree_checkpoint_roundtrip_and_mismatch(tmp_path):
    st = tapi.init(_quad(4, 8)[3], {"w": torch.ones(8),
                                    "h": torch.ones(2, dtype=torch.bfloat16)},
                   tapi.FederationSpec(n_clients=4, alpha=0.1), device="cpu")
    path = str(tmp_path / "ck" / "state")
    tckpt.save(path, st)
    assert os.path.exists(path + ".npz") and os.path.exists(
        path + ".spec.json")
    back = tckpt.restore(path, st)
    assert type(back) is type(st)
    _bits(back, st)
    assert back.x["h"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="treedef"):
        tckpt.restore(path, st._replace(x={
            "u": torch.ones(8), "h": torch.ones(2, dtype=torch.bfloat16)}))
    with pytest.raises(ValueError, match="leaves"):
        tckpt.restore(path, st._replace(aux=(torch.zeros(1),)))
    with pytest.raises(ValueError, match="dtype"):
        tckpt.restore(path, st._replace(x={"w": torch.ones(8),
                                           "h": torch.ones(2)}))
    with pytest.raises(ValueError, match="shape"):
        tckpt.restore(path, st._replace(x={
            "w": torch.ones(9), "h": torch.ones(2, dtype=torch.bfloat16)}))


def test_population_snapshot_roundtrip_and_mismatch():
    n, dim = 6, 8
    spec = tapi.FederationSpec(n_clients=n, alpha=0.1)
    pop = ClientPopulation(spec, torch.zeros(dim))
    pop.scatter_variates(np.arange(3), torch.ones((3, dim)))
    pop.record_participation(np.arange(n), np.ones(n))
    pop.rounds_seen = 4
    snap = pop.snapshot()
    # the snapshot does not alias the live arena
    pop.scatter_variates(np.arange(3), torch.full((3, dim), 9.0))
    assert float(snap["arena"][0].max()) == 1.0
    pop2 = ClientPopulation(spec, torch.zeros(dim))
    pop2.load_snapshot(snap)
    _bits(pop2.variates(), snap["arena"][0])
    np.testing.assert_array_equal(pop2.participation_counts,
                                  pop.participation_counts)
    assert pop2.rounds_seen == 4
    wrong_n = ClientPopulation(tapi.FederationSpec(n_clients=n + 1,
                                                   alpha=0.1),
                               torch.zeros(dim))
    with pytest.raises(ValueError, match="clients"):
        wrong_n.load_snapshot(snap)
    wrong_shape = ClientPopulation(spec, torch.zeros(dim + 1))
    with pytest.raises(ValueError, match="arena leaf"):
        wrong_shape.load_snapshot(snap)
    novar = ClientPopulation(tapi.FederationSpec(n_clients=n,
                                                 variates="off"),
                             torch.zeros(dim))
    with pytest.raises(ValueError, match="variates"):
        novar.load_snapshot(snap)
