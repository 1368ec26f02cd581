"""The port's happens-before checker (``repro_torch.analysis.hb``, its own
copy of ``repro/analysis/hb.py``) on ``tests/test_hb.py``'s cases:

  * the tracker's mechanics: same-thread writes are ordered, a
    cross-thread write without a send/recv edge is flagged, the same
    writes with the edge are clean, ``mark(after=...)`` enforces order;
    each case run on both packages' trackers, with the same verdicts;
  * an unsynchronized arena write from the snapshot writer's thread,
    injected into the port's real scheduler, is caught;
  * the port's real scheduler (sync and async, checkpoints on, landings
    reordered by a seeded ``delay_fn``) is clean over 104 seeded
    interleavings, and every snapshot happens after its land.
"""
import threading

import numpy as np
import pytest
import torch

from repro.analysis import hb as jhb
from repro_torch import api as tapi
from repro_torch.analysis import hb
from repro_torch.core.quadratic import quadratic_for_objective as tquad
from repro_torch.sched import ClientPopulation, CohortScheduler
from repro_torch.sched import scheduler as sched_mod


def _quad(n_clients=4, dim=8, batch=16):
    g = torch.Generator().manual_seed(0)
    Xs = torch.randn((n_clients, batch, dim), generator=g)
    w_i = torch.stack([torch.linspace(-1, 1, dim) + 2.0 * i
                       for i in range(n_clients)])
    ys = torch.einsum("nbp,np->nb", Xs, w_i)

    def loss(b, theta):
        xb, yb = b
        return 0.5 * torch.mean((xb @ theta - yb) ** 2)

    return (Xs, ys), tapi.as_problem(tquad(loss, rho=0.05))


def _slicing(tb):
    def data_fn(t, g, ids):
        ids = torch.as_tensor(np.asarray(ids))
        return tuple(x[ids] for x in tb)
    return data_fn


def _in_thread(fn):
    out = {}

    def runner():
        try:
            out["r"] = fn()
        except BaseException as e:         # surfaced by the caller
            out["e"] = e
    th = threading.Thread(target=runner, name="hb-worker")
    th.start()
    th.join()
    if "e" in out:
        raise out["e"]
    return out.get("r")


@pytest.fixture(params=["port", "reference"])
def mod(request):
    return hb if request.param == "port" else jhb


# ---------------------------------------------------------------------------
# tracker mechanics, on both packages' trackers
# ---------------------------------------------------------------------------

def test_same_thread_writes_are_ordered(mod):
    trk = mod.HBTracker()
    trk.write("arena", [0, 1])
    trk.write("arena", [1, 2])
    assert trk.violations == []


def test_unordered_cross_thread_write_is_flagged(mod):
    trk = mod.HBTracker(raise_on_violation=False)
    trk.write("arena", [3])
    _in_thread(lambda: trk.write("arena", [3]))
    assert len(trk.violations) == 1
    assert "arena" in trk.violations[0] and "slot 3" in trk.violations[0]


def test_send_recv_edge_orders_cross_thread_writes(mod):
    trk = mod.HBTracker()
    trk.write("arena", [3])
    trk.send(("job", 1))

    def worker():
        trk.recv(("job", 1))
        trk.write("arena", [3])
        trk.send(("done", 1))   # the return edge (Future.result())
    _in_thread(worker)
    trk.recv(("done", 1))
    trk.write("arena", [3])
    assert trk.violations == []


def test_write_without_return_edge_is_flagged(mod):
    trk = mod.HBTracker(raise_on_violation=False)
    trk.send(("job", 1))

    def worker():
        trk.recv(("job", 1))
        trk.write("arena", [0])
    _in_thread(worker)
    trk.write("arena", [0])     # no recv of a done token: concurrent
    assert len(trk.violations) == 1


def test_mark_after_enforces_ordering(mod):
    trk = mod.HBTracker(raise_on_violation=False)
    trk.mark("snapshot", 1, after=("land", 0))      # land never happened
    assert len(trk.violations) == 1
    trk2 = mod.HBTracker()
    trk2.mark("land", 0)
    trk2.send(("snap", "p"))

    def worker():
        trk2.recv(("snap", "p"))
        trk2.mark("snapshot", 1, after=("land", 0))
    _in_thread(worker)
    assert trk2.violations == []


def test_mark_without_edge_is_flagged_and_raises(mod):
    trk = mod.HBTracker()
    trk.mark("land", 0)
    with pytest.raises(mod.HBViolation, match="snapshot:1"):
        _in_thread(lambda: trk.mark("snapshot", 1, after=("land", 0)))
    assert len(trk.violations) == 1


def test_module_hooks_are_no_ops_without_a_tracker():
    hb.uninstall()
    hb.on_write("arena", [1])
    hb.on_send("x")
    hb.on_recv("x")
    hb.on_mark("land", 0, after=("never", 0))
    with hb.tracking(raise_on_violation=False) as trk:
        hb.on_mark("snapshot", 0, after=("land", 0))
    assert len(trk.violations) == 1 and hb._TRACKER is None


# ---------------------------------------------------------------------------
# the port's real scheduler
# ---------------------------------------------------------------------------

def test_injected_unsynchronized_arena_write_is_caught(tmp_path, monkeypatch):
    """The snapshot thread pokes the variate arena directly, racing the
    round loop's scatters: the single-writer-per-slot check flags it."""
    n, dim = 4, 8
    tb, problem = _quad(n, dim)
    spec = tapi.FederationSpec(n_clients=n, participation=1.0, alpha=0.1)
    sched = CohortScheduler(problem, spec, cohort_size=n, device="cpu")
    captured = {}
    orig_write = sched_mod._SnapshotWriter._write

    def evil_write(path, snap, prune_dir):
        orig_write(path, snap, prune_dir)
        pop = captured["pop"]
        pop.scatter_variates(np.array([0]),
                             tuple(torch.zeros_like(x[:1])
                                   for x in pop._arena))
    monkeypatch.setattr(sched_mod._SnapshotWriter, "_write",
                        staticmethod(evil_write))
    pop = ClientPopulation(spec, torch.zeros(dim))
    captured["pop"] = pop
    with hb.tracking(raise_on_violation=False) as trk:
        sched.run(torch.zeros(dim), _slicing(tb), 0.3, key=0, n_rounds=4,
                  population=pop, checkpoint_dir=str(tmp_path / "ck"),
                  checkpoint_every=1)
    assert any("variate-arena" in v and "unsynchronized" in v
               for v in trk.violations)


def test_real_scheduler_clean_over_seeded_interleavings(tmp_path):
    """104 seeded interleavings: async landings reordered by a seeded
    delay_fn, checkpoints on, one scheduler. Every run is violation-free
    and publishes its three snapshot-after-land marks."""
    n, dim = 4, 8
    tb, problem = _quad(n, dim)
    spec = tapi.FederationSpec(n_clients=n, participation=1.0, alpha=0.1)
    sched = CohortScheduler(problem, spec, cohort_size=2, device="cpu")
    for seed in range(104):
        rng = np.random.default_rng(seed)
        delays = rng.integers(0, 3, size=64)
        mode = "sync" if seed % 4 == 0 else "async"
        kw = {} if mode == "sync" else {
            "max_inflight": 4, "buffer_cohorts": 2,
            "delay_fn": lambda i, d=delays: int(d[i % d.size]),
        }
        with hb.tracking() as trk:          # raises at the origin
            sched.run(torch.zeros(dim), _slicing(tb), 0.3, key=0,
                      n_rounds=3, mode=mode,
                      checkpoint_dir=str(tmp_path / f"s{seed}"),
                      checkpoint_every=1, **kw)
        assert trk.violations == []
        snaps = [k for k in trk._marks if k[0] == "snapshot"]
        assert len(snaps) == 3, f"seed {seed}: {snaps}"
