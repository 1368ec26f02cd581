"""CohortScheduler: stream a population through the client stage, cohort by
cohort (the counterpart of ``repro/sched/scheduler.py``).

``step`` runs all n clients as one stacked stage; the scheduler runs the
same round as ceil(n / C) cohorts of C clients through ``step(...,
cohort=...)``, sums the ``CohortPartial``s in a buffer and lands the sum
with ``api.apply_partial``. Device memory is O(C * model), whatever n: the
O(n) state (the variate arena, the participation counters, the round's
draws) lives on the host in the ``ClientPopulation``.

The generator chain. ``api.run`` calls ``data(t, gen)``, then ``step``
draws the participation mask, the dither seeds and (two-tier only) the
edge seeds from the same generator. The scheduler consumes the chain in
that order: it keeps the generator's state from before the round's data,
calls cohort 0's ``data_fn(t, gen, ids)`` on the chain generator, draws
the whole population's mask and seeds, and hands every later cohort a
generator restored to the kept state. So with one full cohort the run is
bit for bit the port's own ``api.run`` (state, arena against ``v_i``,
every metric), for any ``data_fn`` whose use of the generator does not
depend on ``ids``. With several cohorts the weighted reduce is
re-associated, so trajectories agree to rounding, and the accounting
(``n_active``, bytes) stays exact.

Two modes, as the reference's:

* ``mode="sync"``: a barrier per round.
* ``mode="async"``: bounded staleness, FedBuff-style. Cohorts are launched
  into a window of ``max_inflight`` and computed against the iterate at
  launch; a landing order (FIFO, reordered by ``delay_fn`` and straggle)
  drains them into the buffer with weight ``spec.staleness_weight(tau)``,
  tau the server updates since launch; every ``buffer_cohorts`` landings
  make one update; ``spec.max_staleness`` forces over-bound cohorts to
  land first. With the defaults every cohort lands fresh and the run is
  bit for bit ``mode="sync"``.

Faults (``spec.faults``): dropout folds into the wave's mask; corrupt
flags go into ``CohortSlice.corrupt`` (the driver detects and drops the
damaged clients); cohort failure walks a pre-drawn retry ladder, billing
each failed attempt (``fault_retries``) and abandoning a cohort whose
ladder runs out (``fault_abandoned``); ``straggle`` adds landing delay in
async mode; ``kill_round`` raises ``ServerKilled`` just before that update
lands. The fault draws come from private generator lanes seeded by the
chain generator's seed (read once per run, kept in snapshots) and the
round or wave index.

Crash-consistent checkpoints: ``run(..., checkpoint_dir=...)`` publishes
one atomic ``round_NNNNNN.snap`` after each server update (the state's
leaves, the population, the chain generator's state, the metric rows and,
async, the in-flight window), keeping the last three, from a background
writer thread that only ever receives host copies made before the next
round starts. ``resume()`` restores the latest and reproduces the
uninterrupted run bit for bit (the kill point is off on resume).

``draws=``: a callable ``index -> dict`` whose entries (``active``,
``seeds``, ``edge_seeds``, ``drop``, ``corrupt``, ``fail_u``,
``straggle``) replace what the round (or wave) ``index`` drew; the
tests hand in the reference's draws this way.

Runtime checks: ``run``/``resume(sanitize=True)`` queue each cohort's and
each landing's stage checks (``analysis/runtime.py``; and the cohorts'
client ids against the population) into one ``Sanitizer`` read once a
server update, and run the comm-bytes audit on every cohort;
``audit_keys`` audits the whole drive's draws (``analysis/keytrace.py``):
an audited ``resume`` draws the uninterrupted run's suffix.
"""
from __future__ import annotations

import contextlib
import gc
import glob
import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..analysis import hb
from ..analysis.keytrace import resolve_audit
from ..analysis.runtime import Sanitizer
from ..api import collective
from ..api.driver import (CohortPartial, CohortSlice, DriverState,
                          _as_generator, _merge_client_metrics,
                          _stack_metrics, _to, apply_partial,
                          finalize_partial, local_rows, resolve_device, step)
from ..api.problem import as_problem
from ..api.schedule import resolve_schedule, schedule_length
from ..api.spec import FederationSpec, participation_draw
from ..checkpoint.checkpoint import dtype_name, treedef_repr
from ..core.compression import leaf_seeds
from ..faults.snapshot import load_snapshot, save_snapshot
from ..faults.spec import ServerKilled
from ..tree import tree_flatten, tree_leaves, tree_map, tree_unflatten
from .population import ClientPopulation

# round snapshots kept on disk (older ones are pruned after each publish)
_CKPT_KEEP = 3


def _host(x):
    """A host copy that no later round can touch (never a view of a device
    buffer or of live host state)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return np.array(x, copy=True)


def _np(x, dtype) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.array(x, dtype=dtype, copy=True)


class _SnapshotWriter:
    """A one-thread background publisher of round snapshots.

    The round loop hands over a snapshot of host copies (built on the
    loop's thread, so it cannot alias state the next round changes) and
    goes on; the worker serializes, fsyncs, publishes atomically and
    prunes. At most one write is in flight (``submit`` waits for the
    previous one), so publish order is round order. A write error
    surfaces at the next ``submit`` or at ``flush``, which the driving
    loops always call on the way out."""

    def __init__(self):
        self._ex = ThreadPoolExecutor(max_workers=1)
        self._fut = None
        self._last = None

    @staticmethod
    def _write(path, snap, prune_dir):
        # hb edges: the executor handoff, the snapshot-after-land mark, and
        # the completion token the next submit or flush joins
        hb.on_recv(("snap", path))
        save_snapshot(path, snap)
        hb.on_mark("snapshot", int(snap["cursor"]),
                   after=("land", int(snap["cursor"]) - 1))
        stale = sorted(glob.glob(os.path.join(prune_dir, "round_*.snap")))
        for p in stale[:-_CKPT_KEEP]:
            try:
                os.remove(p)
            except OSError:
                pass
        hb.on_send(("snap-done", path))

    def submit(self, path, snap, prune_dir):
        if self._fut is not None:
            self._fut.result()   # backpressure; surfaces a write error
            hb.on_recv(("snap-done", self._last))
        self._fut = self._ex.submit(self._write, path, snap, prune_dir)
        self._last = path

    def flush(self):
        try:
            if self._fut is not None:
                fut, self._fut = self._fut, None
                fut.result()
                hb.on_recv(("snap-done", self._last))
        finally:
            self._ex.shutdown(wait=True)


def cohort_ids(n_total: int, cohort_size: int):
    """Contiguous cohorts of the population, the last one padded up to
    ``cohort_size`` by repeating its first id. Returns ``(ids, valid)``
    numpy pairs; padded slots have ``valid == 0.0`` and count nowhere."""
    if cohort_size < 1:
        raise ValueError(f"cohort_size must be >= 1, got {cohort_size}")
    out = []
    for lo in range(0, n_total, cohort_size):
        real = np.arange(lo, min(lo + cohort_size, n_total))
        pad = cohort_size - real.size
        ids = np.concatenate([real, np.full((pad,), real[0])]) if pad \
            else real
        valid = np.concatenate(
            [np.ones((real.size,), np.float32), np.zeros((pad,), np.float32)])
        out.append((ids.astype(np.int64), valid))
    return out


class _PartialBuffer:
    """Sums staleness-weighted ``CohortPartial``s between server updates.
    The first partial is adopted without an add (and a weight of exactly
    1.0 skips the multiply), so a one-cohort sync round lands the cohort's
    own buffers bit for bit. Later partials add into the adopted buffers
    in place: the scheduler hands over each partial and keeps no other
    reference to it, and no third model-sized buffer is made."""

    def __init__(self):
        self.agg = None
        self.n_active = None
        self.comm_bytes = None
        self.collective_payload_bytes = None
        self.metric_sums = None
        self.metric_means = None  # the one partial's own, while it is alone
        self.staleness = []
        self.retries = 0        # failed cohort uplink attempts (billed)
        self.abandoned = 0      # cohorts whose retry ladder ran out

    def add(self, partial, weight: float, tau: int = 0):
        if weight == 1.0:
            agg = partial.agg
        else:
            w = float(weight)
            agg = tree_map(lambda x: (w * x).to(x.dtype), partial.agg)
        self.agg = agg if self.agg is None else tree_map(
            lambda a, b: a.add_(b), self.agg, agg)
        # the accounting is unweighted: these clients did take part and
        # did send those bytes, however downweighted they land
        self.n_active = (partial.n_active if self.n_active is None
                         else self.n_active + partial.n_active)
        self.bill(partial.comm_bytes)
        if partial.collective_payload_bytes is not None:
            prev = self.collective_payload_bytes
            self.collective_payload_bytes = (
                partial.collective_payload_bytes if prev is None
                else prev + partial.collective_payload_bytes)
        self.metric_means = (partial.metric_means
                             if self.metric_sums is None else None)
        if self.metric_sums is None:
            self.metric_sums = dict(partial.metric_sums)
        else:
            self.metric_sums = {k: self.metric_sums[k] + v
                                for k, v in partial.metric_sums.items()}
        self.staleness.append(int(tau))

    def bill(self, comm_bytes):
        """Count wire bytes without aggregating: a failed attempt used the
        uplink though its payload never landed."""
        self.comm_bytes = (comm_bytes if self.comm_bytes is None
                           else self.comm_bytes + comm_bytes)


class _Inflight(NamedTuple):
    launch_updates: int     # server-update count when the cohort computed
    order: int              # global launch order (FIFO tiebreak)
    partial: object         # the CohortPartial
    wave: int               # which population pass launched it
    cohort_idx: int = -1    # index into the static cohort list
    attempt: int = 0        # next rung of the pre-drawn retry ladder
    extra: int = 0          # straggle + retry-backoff landing delay
    mask: object = None     # (C,) participation mask (deferred delivery)
    fail_row: object = None  # (max_retries + 1,) fail_u uniforms, or None


class CohortScheduler:
    """Streams cohorts of ``cohort_size`` clients through the driver's
    client stage, on ``mesh`` or one device (``device``: the GPU unless
    ``"cpu"``). On a mesh ``cohort_size`` must divide over the client dims
    (``launch.mesh.cohort_capacity`` gives the natural choice); every rank
    draws the whole cohort's data and takes its rows."""

    def __init__(self, problem, spec: FederationSpec, *, cohort_size: int,
                 mesh=None, client_axis: str = "clients",
                 client_mode: str = "vmap", uplink: str = "gather",
                 drift_metric: bool = True, device=None):
        self.problem = as_problem(problem)
        self.spec = spec
        self.cohort_size = int(cohort_size)
        self.mesh = mesh
        self.client_axis = client_axis
        self.client_mode = client_mode
        self.uplink = uplink
        self.drift_metric = drift_metric
        self.device = resolve_device(device)
        self.n_cohorts = math.ceil(spec.n_clients / self.cohort_size)
        self._two_tier = spec.topology.is_two_tier
        if self._two_tier and uplink == "reduce":
            raise ValueError(
                "two-tier uplink='reduce' groups clients by mesh position; "
                "a streamed cohort's edge membership is data-dependent — "
                "use uplink='gather' under the scheduler")
        self._ckpt_writer = None
        self._gc_pending = False
        self._san = None            # the drive's Sanitizer, under sanitize
        # with a cohort-failure axis, client-local effects (the variate
        # scatter, the participation counts) commit at DELIVERY, since a
        # failed attempt never reached the server; without one, at compute
        # time (the client did its round then, however stale it lands)
        self._defer_delivery = (spec.faults is not None
                                and spec.faults.cohort_fail > 0.0)

    # -- state ----------------------------------------------------------------
    def init_state(self, x0, population: ClientPopulation) -> DriverState:
        """``api.init``'s state with the per-client variates left in the
        population arena: ``v_i`` is ``()``, never O(n) on the device."""
        problem, spec, dev = self.problem, self.spec, self.device
        x0 = _to(x0, dev)
        v = (_to(population.weighted_variate_sum(), dev)
             if spec.use_variates else ())
        aux = problem.init_aux() if problem.init_aux is not None else ()
        if spec.server_momentum > 0.0:
            if problem.server_opt is not None or problem.init_opt is not None:
                raise ValueError(
                    "server_momentum and a custom MMProblem.server_opt/"
                    "init_opt both claim the server update — fold the "
                    "momentum into your server_opt instead")
            opt = tree_map(torch.zeros_like, x0)
        else:
            opt = problem.init_opt(x0) if problem.init_opt is not None else ()
        return DriverState(x=x0, v=v, v_i=(), aux=aux, opt=opt,
                           step=torch.tensor(0))

    # -- one wave's draws ---------------------------------------------------------
    def _open_wave(self, gen, index, data_fn, cohorts, fault_seed, draws):
        """Start round (sync) or population pass (async) ``index``: keep
        the chain's state, make cohort 0's data on the chain, then draw the
        whole population's mask, seeds and (two-tier) edge seeds, and the
        fault lanes' draws. Returns ``(wave, cohort 0's batch)``; later
        cohorts' data come from ``_data_generator(wave)``."""
        spec = self.spec
        data_state = gen.get_state()
        batch0 = data_fn(index, gen, cohorts[0][0])
        active, seeds = participation_draw(gen, spec, self._n_leaves)
        edge_seeds = None
        if self._two_tier:
            edge_seeds = torch.tensor(
                [leaf_seeds(gen, self._n_leaves)
                 for _ in range(spec.topology.n_edges)], dtype=torch.int64)
        given = draws(index) if draws is not None else {}
        wave = {"data_state": data_state,
                "active": _np(given.get("active", active), bool),
                "seeds": _np(given.get("seeds", seeds), np.int64),
                "edge_seeds": (None if edge_seeds is None else
                               _np(given.get("edge_seeds", edge_seeds),
                                   np.int64)),
                "fctx": None}
        faults = spec.faults
        if faults is not None and faults.any_injection:
            drop, corr = faults.client_draw(fault_seed, index, spec.n_clients)
            fail_u, straggle = faults.cohort_draw(fault_seed, index,
                                                  self.n_cohorts)
            drop = _np(given.get("drop", drop), bool)
            # a dropped client's uplink never arrives: out of the mask
            wave["active"] = wave["active"] & ~drop
            wave["fctx"] = {
                "corrupt": (_np(given.get("corrupt", corr), bool)
                            if faults.corrupt > 0.0 else None),
                "fail_u": _np(given.get("fail_u", fail_u), np.float32),
                "straggle": _np(given.get("straggle", straggle), bool),
            }
        return wave, batch0

    def _data_generator(self, wave) -> torch.Generator:
        """A generator in the state the chain had before the wave's data."""
        g = torch.Generator(device=self._gen_device)
        g.set_state(wave["data_state"])
        return g

    # -- one cohort through the client stage ---------------------------------------
    def _run_cohort(self, state, batch, ids, valid, wave,
                    pop: ClientPopulation):
        spec, dev = self.spec, self.device
        if self._san is not None:
            self._san.check_index("cohort", "client ids", ids, pop.n_total)
        mask = wave["active"][ids].astype(np.float32) * valid
        mu_s = pop.mu[ids] * valid
        v_i = pop.gather_variates(ids, dev) if spec.use_variates else ()
        corrupt = None
        fctx = wave["fctx"]
        if fctx is not None and fctx["corrupt"] is not None:
            corrupt = torch.from_numpy(fctx["corrupt"][ids] & (valid > 0.5))
        if self.mesh is not None:
            lo, hi = local_rows(spec, self.mesh, self.client_axis,
                                n=self.cohort_size)
            batch = tree_map(lambda x: x[lo:hi], batch)
            v_i = tree_map(lambda x: x[lo:hi], v_i)
        cohort = CohortSlice(
            mask=torch.from_numpy(mask), mu=torch.from_numpy(mu_s),
            seeds=torch.from_numpy(wave["seeds"][ids]), v_i=v_i,
            valid=torch.from_numpy(valid), corrupt=corrupt,
            edge_ids=(torch.from_numpy(pop.edge_ids[ids].astype(np.int64))
                      if self._two_tier else None))
        partial = step(self.problem, spec, state, batch, 0.0, None,
                       device=dev, mesh=self.mesh,
                       client_axis=self.client_axis,
                       client_mode=self.client_mode, uplink=self.uplink,
                       cohort=cohort, sanitize=self._san or False)
        del batch, v_i, cohort
        if self._gc_pending:
            # torch.func's first vmap of a grad in a process leaves a cycle
            # holding that call's (cohort-sized) intermediates
            gc.collect()
            self._gc_pending = False
        if self.mesh is not None and spec.use_variates:
            # every rank's arena holds the whole cohort's rows
            dims = collective.client_dims(spec.topology, self.client_axis)
            partial = partial._replace(v_i=tree_map(
                lambda x: collective.gather_rows(x, self.mesh, dims),
                partial.v_i))
        if not self._defer_delivery:
            self._deliver(pop, partial, ids, mask, valid)
            partial = partial._replace(v_i=())
        return partial, mask

    def _deliver(self, pop: ClientPopulation, partial, ids, mask, valid):
        """Commit a cohort's client-local effects: its variates into the
        arena and its realized participations."""
        if self.spec.use_variates:
            pop.scatter_variates(ids, partial.v_i, valid)
        pop.record_participation(ids, mask, valid)

    def _land(self, state, buffer: _PartialBuffer, gamma, t_idx, n_rounds,
              eval_batch, eval_every, edge_seeds=None):
        """Apply the buffered aggregate and assemble the round's metrics
        (``api.run``'s keys and arithmetic). A two-tier partial crosses the
        tier boundary here, with the landing round's edge seeds: cohorts
        sum edge-wise before the boundary and the backbone is billed once
        per landing."""
        spec = self.spec
        if buffer.agg is None:
            # every cohort's ladder ran out: land a zero aggregate with
            # n_active = 0 so the rounds, gammas and rows stay aligned
            if self._two_tier:
                n_edges = spec.topology.n_edges
                buffer.agg = tree_map(
                    lambda x: torch.zeros((n_edges,) + tuple(x.shape),
                                          dtype=torch.float32,
                                          device=x.device), state.x)
            else:
                buffer.agg = tree_map(torch.zeros_like, state.x)
        agg = buffer.agg
        backbone = torch.tensor(0.0, dtype=torch.float32)
        if self._two_tier:
            agg, backbone_bytes = finalize_partial(spec, agg, edge_seeds,
                                                   state.x)
            backbone = torch.tensor(backbone_bytes, dtype=torch.float32)
        zero = torch.tensor(0.0, dtype=torch.float32)
        n_active = zero if buffer.n_active is None else buffer.n_active
        state, m = apply_partial(self.problem, spec, state, agg, n_active,
                                 gamma, drift_metric=self.drift_metric,
                                 device=self.device,
                                 sanitize=self._san or False)
        if self._san is not None:
            self._san.raise_if_tripped(f"server update {t_idx}")
        del agg
        buffer.agg = None
        # the bill sums exactly in float64 and rounds once, here
        comm = (zero if buffer.comm_bytes is None
                else buffer.comm_bytes.to(torch.float32))
        # flat: the backbone is exactly 0.0, so comm_bytes is the uplink's
        m["uplink_bytes"] = comm
        m["backbone_bytes"] = backbone
        m["comm_bytes"] = comm + backbone
        if buffer.collective_payload_bytes is not None:
            m["collective_payload_bytes"] = torch.tensor(
                buffer.collective_payload_bytes, dtype=torch.float32)
        # one cohort of all n clients lands step's own torch.mean, bit for
        # bit (CUDA's mean multiplies by 1/n, so the sum over n may part
        # from it by an ulp); cohorts land the sum of their sums over n
        means = buffer.metric_means
        if means is None:
            means = {k: v / spec.n_clients
                     for k, v in (buffer.metric_sums or {}).items()}
        _merge_client_metrics(m, means)
        if self.problem.loss is not None and eval_batch is not None:
            if "loss" in m:
                raise ValueError(
                    "metric key collision: the problem's s_bar_metrics "
                    "already reports a per-client 'loss' and the eval hook "
                    "would overwrite it — drop eval_batch or rename the "
                    "client metric")
            if (t_idx + 1) % eval_every == 0 or t_idx == n_rounds - 1:
                theta = (state.x if spec.aggregation == "parameter"
                         else self.problem.T(state.x))
                m["loss"] = torch.as_tensor(
                    self.problem.loss(eval_batch, theta)).to(torch.float32)
            else:
                m["loss"] = torch.tensor(float("nan"))
        if buffer.staleness:
            stale = np.asarray(buffer.staleness, np.float32)
            m["staleness_mean"] = torch.tensor(stale.mean())
            m["staleness_max"] = torch.tensor(stale.max())
        faults = spec.faults
        if faults is not None and faults.any_injection:
            m["fault_retries"] = torch.tensor(float(buffer.retries))
            m["fault_abandoned"] = torch.tensor(float(buffer.abandoned))
        hb.on_mark("land", t_idx)
        return state, m

    # -- crash-consistent snapshots --------------------------------------------------
    def _encode_partial(self, partial) -> dict:
        enc = {
            "agg": [_host(x) for x in tree_leaves(partial.agg)],
            "n_active": _host(partial.n_active),
            "comm_bytes": _host(partial.comm_bytes),
            "metric_sums": {k: _host(v)
                            for k, v in partial.metric_sums.items()},
            "collective_payload_bytes": (
                None if partial.collective_payload_bytes is None
                else float(partial.collective_payload_bytes)),
            "metric_means": (None if partial.metric_means is None else
                             {k: _host(v)
                              for k, v in partial.metric_means.items()}),
        }
        if self._defer_delivery and self.spec.use_variates:
            # a deferred delivery scatters v_i when it lands, which may be
            # after a resume
            enc["v_i"] = [_host(x) for x in tree_leaves(partial.v_i)]
        return enc

    def _decode_partial(self, enc: dict, x_template) -> CohortPartial:
        dev = self.device
        tdef = tree_flatten(x_template)[1]
        agg = tree_unflatten(tdef, [torch.as_tensor(x).to(dev)
                                    for x in enc["agg"]])
        v_i = ()
        if enc.get("v_i") is not None:
            v_i = tree_unflatten(tdef, [torch.as_tensor(x).to(dev)
                                        for x in enc["v_i"]])
        cpb = enc["collective_payload_bytes"]
        means = enc.get("metric_means")
        return CohortPartial(
            agg=agg, v_i=v_i, n_active=torch.as_tensor(enc["n_active"]).to(
                dev),
            comm_bytes=torch.as_tensor(enc["comm_bytes"]).to(dev),
            metric_sums={k: torch.as_tensor(v).to(dev)
                         for k, v in enc["metric_sums"].items()},
            collective_payload_bytes=None if cpb is None else float(cpb),
            metric_means=None if means is None else {
                k: torch.as_tensor(v).to(dev) for k, v in means.items()})

    @staticmethod
    def _encode_wave(wave) -> Optional[dict]:
        if wave is None:
            return None
        fctx = wave["fctx"]
        return {
            "data_state": _host(wave["data_state"]),
            "active": _host(wave["active"]),
            "seeds": _host(wave["seeds"]),
            "edge_seeds": (None if wave["edge_seeds"] is None
                           else _host(wave["edge_seeds"])),
            "fctx": None if fctx is None else {
                "corrupt": (None if fctx["corrupt"] is None
                            else _host(fctx["corrupt"])),
                "fail_u": _host(fctx["fail_u"]),
                "straggle": _host(fctx["straggle"]),
            },
        }

    def _encode_async_ctx(self, inflight, pending, wave_idx, wave,
                          order) -> dict:
        return {
            "order": int(order),
            "wave": int(wave_idx),
            "pending": [int(ci) for ci in pending],
            "wave_ctx": self._encode_wave(wave),
            "inflight": [{
                "launch_updates": int(e.launch_updates),
                "order": int(e.order),
                "wave": int(e.wave),
                "cohort_idx": int(e.cohort_idx),
                "attempt": int(e.attempt),
                "extra": int(e.extra),
                "mask": _host(e.mask),
                "fail_row": None if e.fail_row is None else _host(e.fail_row),
                "partial": self._encode_partial(e.partial),
            } for e in inflight],
        }

    def _decode_async_ctx(self, ctx: dict, x_template) -> dict:
        wave = ctx["wave_ctx"]
        if wave is not None:
            wave = dict(wave)
            wave["data_state"] = torch.as_tensor(wave["data_state"])
            if wave["fctx"] is not None:
                wave["fctx"] = dict(wave["fctx"])
        inflight = [
            _Inflight(int(d["launch_updates"]), int(d["order"]),
                      self._decode_partial(d["partial"], x_template),
                      int(d["wave"]), int(d["cohort_idx"]),
                      int(d["attempt"]), int(d["extra"]),
                      np.asarray(d["mask"]),
                      (None if d["fail_row"] is None
                       else np.asarray(d["fail_row"])))
            for d in ctx["inflight"]]
        return {"inflight": inflight,
                "pending": [int(ci) for ci in ctx["pending"]],
                "wave": int(ctx["wave"]), "wave_ctx": wave,
                "order": int(ctx["order"])}

    def _save_checkpoint(self, ckpt_dir, mode, cursor, gen, fault_seed,
                         state, pop, rows, extra=None):
        """Publish one atomic round snapshot and prune older ones. The host
        copies are made here, on the round loop's thread; the write goes to
        the run's ``_SnapshotWriter``, so the loop does not wait on the
        disk."""
        os.makedirs(ckpt_dir, exist_ok=True)
        leaves, tdef = tree_flatten(state)
        snap = {
            "mode": mode,
            "cursor": int(cursor),
            "key": {"state": _host(gen.get_state()),
                    "device": gen.device.type,
                    "fault_seed": int(fault_seed)},
            "state": {"treedef": treedef_repr(tdef),
                      "leaves": [_host(x) for x in leaves]},
            "pop": pop.snapshot(),
            "rows": [{k: _host(v) for k, v in r.items()} for r in rows],
        }
        if extra:
            snap.update(extra)
        path = os.path.join(ckpt_dir, f"round_{cursor:06d}.snap")
        hb.on_send(("snap", path))
        if self._ckpt_writer is not None:
            self._ckpt_writer.submit(path, snap, ckpt_dir)
        else:
            _SnapshotWriter._write(path, snap, ckpt_dir)

    # -- driving loops --------------------------------------------------------------
    def _check_run(self, mode, n_rounds, schedule, population, x0):
        if mode not in ("sync", "async"):
            raise ValueError(f"mode={mode!r} (want 'sync' or 'async')")
        if mode == "async" and self._two_tier:
            raise ValueError(
                "mode='async' does not support a two-tier topology: the "
                "tier boundary re-encodes with the LANDING round's seeds, "
                "and the async window lands cohorts from different waves "
                "into one update — use mode='sync'")
        if n_rounds is None:
            n_rounds = schedule_length(schedule)
            if n_rounds is None:
                raise ValueError("n_rounds required with a callable "
                                 "schedule")
        if population is None:
            population = ClientPopulation(self.spec, x0, device=self.device)
        if population.n_total != self.spec.n_clients:
            raise ValueError(
                f"population holds {population.n_total} clients but the "
                f"spec says {self.spec.n_clients}")
        self._n_leaves = len(tree_leaves(x0))
        return n_rounds, resolve_schedule(schedule, n_rounds), population

    def run(self, x0, data_fn, schedule, *, key,
            n_rounds: Optional[int] = None,
            population: Optional[ClientPopulation] = None,
            mode: str = "sync", eval_batch=None, eval_every: int = 1,
            max_inflight: Optional[int] = None,
            buffer_cohorts: Optional[int] = None,
            delay_fn: Optional[Callable[[int], int]] = None,
            state0: Optional[DriverState] = None,
            sanitize: bool = False, audit_keys=False,
            checkpoint_dir: Optional[str] = None,
            checkpoint_every: int = 1, draws=None):
        """Drive ``n_rounds`` server updates.

        ``data_fn(t, generator, ids) -> (len(ids), ...)`` client batches
        for the GLOBAL ids ``ids`` (padded slots repeat a real id; their
        rows are computed and discarded). ``t``: the round (sync) or the
        population pass (async). ``key``: a ``torch.Generator`` or an int
        seed, as ``api.run`` takes it; slicing the rows of ``api.run``'s
        batch reproduces its data exactly. ``population``: the clients'
        host state (default: a fresh ``ClientPopulation`` for the
        scheduler's device, its arena page-locked on a GPU).

        Async knobs (``mode="async"``): ``max_inflight`` cohorts computed
        since the last update (default one population pass),
        ``buffer_cohorts`` landings per update (default one pass),
        ``delay_fn(i) -> int`` reorders landings (entry i becomes eligible
        at virtual time ``i + delay_fn(i)``).

        ``checkpoint_dir``/``checkpoint_every``: publish an atomic snapshot
        every ``checkpoint_every`` updates (and after the last);
        ``resume()`` continues from the latest bit for bit. A
        ``spec.faults.kill_round`` raises ``ServerKilled`` before that
        update lands. ``draws``: see the module docstring.

        Returns ``(DriverState, ClientPopulation, metrics)``, the metrics
        stacked with one row per server update.

        ``sanitize``: the stage checks of every cohort and landing, read
        once a server update (which raises ``SanitizerError`` naming it,
        the stage and the leaf), and the comm-bytes audit on every cohort;
        ``audit_keys``: True, or a ``KeyAudit`` to read its report, audits
        the run's draws. Both only read: trajectories are bit for bit
        those with both off."""
        n_rounds, gammas, population = self._check_run(
            mode, n_rounds, schedule, population, x0)
        if checkpoint_every < 1:
            raise ValueError(f"checkpoint_every must be >= 1, got "
                             f"{checkpoint_every}")
        state = (DriverState(*(_to(f, self.device) for f in state0))
                 if state0 is not None else self.init_state(x0, population))
        gen = _as_generator(key)
        return self._drive(mode, state, data_fn, gammas, gen,
                           gen.initial_seed(), n_rounds, population,
                           eval_batch, eval_every, max_inflight,
                           buffer_cohorts, delay_fn, checkpoint_dir,
                           checkpoint_every, draws, sanitize, audit_keys,
                           kill_enabled=True, start_round=0, rows=None,
                           resume_ctx=None)

    def resume(self, x0, data_fn, schedule, *, checkpoint_dir: str,
               n_rounds: Optional[int] = None,
               population: Optional[ClientPopulation] = None,
               mode: str = "sync", eval_batch=None, eval_every: int = 1,
               max_inflight: Optional[int] = None,
               buffer_cohorts: Optional[int] = None,
               delay_fn: Optional[Callable[[int], int]] = None,
               sanitize: bool = False, audit_keys=False,
               checkpoint_every: int = 1, draws=None):
        """Continue a crashed ``run(..., checkpoint_dir=...)`` from its
        latest snapshot, reproducing the uninterrupted run bit for bit. The
        snapshot holds the chain generator's state and seed, the state's
        leaves (structure, shapes and dtypes verified against a fresh
        template), the population, the metric rows and (async) the
        window. Pass the crashed run's ``x0``, ``data_fn``, ``schedule``
        and knobs. The kill point is off on resume. Returns what ``run``
        returns, over the whole run. ``sanitize``/``audit_keys``: as
        ``run``'s, over the resumed rounds."""
        n_rounds, gammas, population = self._check_run(
            mode, n_rounds, schedule, population, x0)
        paths = sorted(glob.glob(os.path.join(checkpoint_dir,
                                              "round_*.snap")))
        if not paths:
            raise FileNotFoundError(
                f"no round_*.snap snapshots under {checkpoint_dir!r} — "
                f"nothing to resume")
        snap = load_snapshot(paths[-1])
        if snap["mode"] != mode:
            raise ValueError(
                f"snapshot was written by mode={snap['mode']!r} but "
                f"resume asked for mode={mode!r}")
        template = self.init_state(x0, population)
        tmpl_leaves, tdef = tree_flatten(template)
        if treedef_repr(tdef) != snap["state"]["treedef"]:
            raise ValueError(
                f"snapshot DriverState treedef\n  {snap['state']['treedef']}"
                f"\ndoes not match this scheduler's\n  {treedef_repr(tdef)}"
                f" — resume needs the problem and spec the snapshot was "
                f"written with")
        leaves = []
        for i, (tl, sl) in enumerate(zip(tmpl_leaves, snap["state"]["leaves"])):
            sl = torch.as_tensor(sl)
            if (tuple(sl.shape) != tuple(tl.shape)
                    or dtype_name(sl) != dtype_name(tl)):
                raise ValueError(
                    f"DriverState leaf {i}: snapshot has "
                    f"{tuple(sl.shape)}/{dtype_name(sl)}, expected "
                    f"{tuple(tl.shape)}/{dtype_name(tl)}")
            leaves.append(sl.to(tl.device))
        population.load_snapshot(snap["pop"])
        state = tree_unflatten(tdef, leaves)
        gen = torch.Generator(device=snap["key"]["device"])
        gen.set_state(torch.as_tensor(snap["key"]["state"]))
        rows = [dict(r) for r in snap["rows"]]
        cursor = int(snap["cursor"])
        if cursor >= n_rounds:
            return state, population, _stack_metrics(rows)
        resume_ctx = (self._decode_async_ctx(snap["async"], state.x)
                      if mode == "async" else None)
        return self._drive(mode, state, data_fn, gammas, gen,
                           snap["key"]["fault_seed"], n_rounds, population,
                           eval_batch, eval_every, max_inflight,
                           buffer_cohorts, delay_fn, checkpoint_dir,
                           checkpoint_every, draws, sanitize, audit_keys,
                           kill_enabled=False, start_round=cursor, rows=rows,
                           resume_ctx=resume_ctx)

    def _drive(self, mode, state, data_fn, gammas, gen, fault_seed, n_rounds,
               pop, eval_batch, eval_every, max_inflight, buffer_cohorts,
               delay_fn, checkpoint_dir, checkpoint_every, draws, sanitize,
               audit_keys, **kw):
        audit = resolve_audit(audit_keys)
        with (audit.activate() if audit is not None
              else contextlib.nullcontext()):
            self._san = Sanitizer() if sanitize else None
            try:
                return self._drive_loop(
                    mode, state, data_fn, gammas, gen, fault_seed, n_rounds,
                    pop, eval_batch, eval_every, max_inflight,
                    buffer_cohorts, delay_fn, checkpoint_dir,
                    checkpoint_every, draws, **kw)
            finally:
                self._san = None

    def _drive_loop(self, mode, state, data_fn, gammas, gen, fault_seed,
                    n_rounds, pop, eval_batch, eval_every, max_inflight,
                    buffer_cohorts, delay_fn, checkpoint_dir,
                    checkpoint_every, draws, **kw):
        self._gen_device = gen.device
        self._gc_pending = True
        if eval_batch is not None:
            eval_batch = _to(eval_batch, self.device)
        cohorts = cohort_ids(self.spec.n_clients, self.cohort_size)
        self._ckpt_writer = (_SnapshotWriter() if checkpoint_dir is not None
                             else None)
        common = (state, data_fn, gammas, gen, fault_seed, n_rounds, pop,
                  cohorts, eval_batch, eval_every, checkpoint_dir,
                  checkpoint_every, draws)
        try:
            if mode == "sync":
                kw.pop("resume_ctx")
                return self._run_sync(*common, **kw)
            return self._run_async(*common, max_inflight, buffer_cohorts,
                                   delay_fn, **kw)
        finally:
            if self._ckpt_writer is not None:
                w, self._ckpt_writer = self._ckpt_writer, None
                w.flush()

    def _run_sync(self, state, data_fn, gammas, gen, fault_seed, n_rounds,
                  pop, cohorts, eval_batch, eval_every, checkpoint_dir,
                  checkpoint_every, draws, kill_enabled=True, start_round=0,
                  rows=None):
        faults = self.spec.faults
        rows = [] if rows is None else rows
        for t in range(start_round, n_rounds):
            wave, batch = self._open_wave(gen, t, data_fn, cohorts,
                                          fault_seed, draws)
            buf = _PartialBuffer()
            for ci, (ids, valid) in enumerate(cohorts):
                if ci:
                    batch = data_fn(t, self._data_generator(wave), ids)
                partial, mask = self._run_cohort(state, batch, ids, valid,
                                                 wave, pop)
                batch = None
                if self._defer_delivery:
                    # walk the cohort's pre-drawn ladder: each failed
                    # attempt bills its bytes; an exhausted ladder abandons
                    # the cohort (billed, never aggregated)
                    fail_row = wave["fctx"]["fail_u"][ci]
                    a = 0
                    while (a < fail_row.shape[0]
                           and fail_row[a] < faults.cohort_fail):
                        buf.bill(partial.comm_bytes)
                        buf.retries += 1
                        a += 1
                    if a >= fail_row.shape[0]:
                        buf.abandoned += 1
                        continue
                    self._deliver(pop, partial, ids, mask, valid)
                    partial = partial._replace(v_i=())
                buf.add(partial, 1.0)
                del partial
            if (kill_enabled and faults is not None
                    and faults.kill_round == t):
                raise ServerKilled(t)
            pop.rounds_seen += 1
            state, m = self._land(state, buf, gammas[t], t, n_rounds,
                                  eval_batch, eval_every,
                                  edge_seeds=wave["edge_seeds"])
            del buf
            rows.append(m)
            if checkpoint_dir is not None and (
                    (t + 1) % checkpoint_every == 0 or t == n_rounds - 1):
                self._save_checkpoint(checkpoint_dir, "sync", t + 1, gen,
                                      fault_seed, state, pop, rows)
        return state, pop, _stack_metrics(rows)

    def _run_async(self, state, data_fn, gammas, gen, fault_seed, n_rounds,
                   pop, cohorts, eval_batch, eval_every, checkpoint_dir,
                   checkpoint_every, draws, max_inflight, buffer_cohorts,
                   delay_fn, kill_enabled=True, start_round=0, rows=None,
                   resume_ctx=None):
        spec = self.spec
        faults = spec.faults
        k_cohorts = len(cohorts)
        if max_inflight is None:
            max_inflight = k_cohorts
        if buffer_cohorts is None:
            buffer_cohorts = k_cohorts
        if max_inflight < 1 or buffer_cohorts < 1:
            raise ValueError("max_inflight and buffer_cohorts must be >= 1")
        if buffer_cohorts > max_inflight:
            raise ValueError(
                f"buffer_cohorts={buffer_cohorts} > max_inflight="
                f"{max_inflight} can never fill the buffer — the window "
                f"admits at most max_inflight unapplied cohorts")
        weight_fn = spec.staleness_weight or (lambda tau: 1.0)
        rows = [] if rows is None else rows
        updates = start_round
        if resume_ctx is None:
            inflight: list = []
            pending = []        # cohort indices of the wave not yet launched
            wave_idx = -1
            wave = None         # the wave's draws and data state
            order = 0
        else:
            inflight = resume_ctx["inflight"]
            pending = resume_ctx["pending"]
            wave_idx = resume_ctx["wave"]
            wave = resume_ctx["wave_ctx"]
            order = resume_ctx["order"]
        landed = 0
        buf = _PartialBuffer()

        def prio(e: _Inflight) -> int:
            return (e.order + (delay_fn(e.order) if delay_fn else 0)
                    + e.extra)

        def uplink(e: _Inflight, must_land: bool):
            """Walk the entry's pre-drawn failure ladder at landing. Returns
            the entry when its uplink succeeds; None when it re-entered the
            window (a retry, ``retry_backoff`` later, its staleness clock
            intact) or its ladder ran out. ``must_land`` (the force-drain)
            walks the rest of the ladder in place."""
            if e.fail_row is None:
                return e
            a = e.attempt
            n_att = len(e.fail_row)
            while a < n_att:
                if e.fail_row[a] >= faults.cohort_fail:
                    return e._replace(attempt=a)
                # this attempt failed after using the wire
                buf.bill(e.partial.comm_bytes)
                buf.retries += 1
                a += 1
                if a < n_att and not must_land:
                    inflight.append(e._replace(
                        attempt=a, extra=e.extra + faults.retry_backoff))
                    return None
            buf.abandoned += 1
            return None

        def take(e: _Inflight, tau: int):
            buf.add(e.partial, weight_fn(tau), tau)
            if self._defer_delivery:
                ids, valid = cohorts[e.cohort_idx]
                self._deliver(pop, e.partial, ids, e.mask, valid)

        while updates < n_rounds:
            # 1. keep the window full: compute cohorts now, against the
            #    current iterate (their staleness accrues while later
            #    updates land first). The window counts every cohort
            #    computed since the last applied update.
            while len(inflight) + landed < max_inflight:
                batch = None
                if not pending:
                    wave_idx += 1
                    wave, batch = self._open_wave(gen, wave_idx, data_fn,
                                                  cohorts, fault_seed, draws)
                    pending = list(range(k_cohorts))
                ci = pending.pop(0)
                ids, valid = cohorts[ci]
                if batch is None:
                    batch = data_fn(wave_idx, self._data_generator(wave), ids)
                partial, mask = self._run_cohort(state, batch, ids, valid,
                                                 wave, pop)
                del batch
                extra = 0
                fail_row = None
                fctx = wave["fctx"]
                if fctx is not None:
                    if bool(fctx["straggle"][ci]):
                        extra = faults.straggle_delay
                    if faults.cohort_fail > 0.0:
                        fail_row = np.array(fctx["fail_u"][ci], copy=True)
                inflight.append(_Inflight(updates, order, partial, wave_idx,
                                          ci, 0, extra, mask, fail_row))
                del partial
                order += 1
            # 2. land one cohort: any over the staleness bound first (the
            #    forced drain), else the delay-ordered head of the window
            if spec.max_staleness is not None:
                forced = [e for e in inflight
                          if updates - e.launch_updates >= spec.max_staleness]
            else:
                forced = []
            e = (min(forced, key=lambda e: e.order) if forced
                 else min(inflight, key=prio))
            inflight.remove(e)
            e = uplink(e, bool(forced))
            if e is None:
                continue
            take(e, updates - e.launch_updates)
            landed += 1
            # 3. a full buffer makes the server update, after draining every
            #    remaining over-bound cohort (no cohort outlives the bound)
            if landed >= buffer_cohorts:
                if spec.max_staleness is not None:
                    over = sorted(
                        (e2 for e2 in inflight
                         if updates - e2.launch_updates >= spec.max_staleness),
                        key=lambda e2: e2.order)
                    for e2 in over:
                        inflight.remove(e2)
                        e2 = uplink(e2, True)
                        if e2 is not None:
                            take(e2, updates - e2.launch_updates)
                if (kill_enabled and faults is not None
                        and faults.kill_round == updates):
                    raise ServerKilled(updates)
                state, m = self._land(state, buf, gammas[updates], updates,
                                      n_rounds, eval_batch, eval_every)
                rows.append(m)
                updates += 1
                pop.rounds_seen += 1
                landed = 0
                buf = _PartialBuffer()
                if checkpoint_dir is not None and (
                        updates % checkpoint_every == 0
                        or updates == n_rounds):
                    self._save_checkpoint(
                        checkpoint_dir, "async", updates, gen, fault_seed,
                        state, pop, rows,
                        extra={"async": self._encode_async_ctx(
                            inflight, pending, wave_idx, wave, order)})
        return state, pop, _stack_metrics(rows)
