"""ClientPopulation: per-client persistent state, apart from the device
(the counterpart of ``repro/sched/population.py``).

The driver's ``step`` holds the whole population in one stacked client
dim (the ``(n, ...)`` ``v_i`` of ``DriverState``), so n is capped by
device memory. The population arena lifts the cap: the control variates
live in a host arena (one ``(n_total, *leaf.shape)`` CPU tensor per model
leaf), and only the current cohort's ``(C, ...)`` slice is put on the
device.

Per-client randomness comes from ``client_keys(ids)``: one seed per
client, a function of ``(base_seed, global id)`` only, so a client's
stream is the same in whichever cohort it lands. The per-round dither
seeds are another thing: they come from the round's draw
(``participation_draw`` over all n, indexed by the cohort's ids), so that
one full cohort is bit for bit ``api.run``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..analysis.hb import on_write
from ..api.driver import _tensordot
from ..api.spec import FederationSpec
from ..tree import tree_flatten, tree_leaves, tree_map, tree_unflatten

_M64 = (1 << 64) - 1


def _ids(ids) -> np.ndarray:
    if isinstance(ids, torch.Tensor):
        ids = ids.cpu().numpy()
    return np.asarray(ids, dtype=np.int64).reshape(-1)


def _span(ids: np.ndarray):
    """``(lo, hi)`` when ``ids`` is the run ``lo..hi-1`` (a cohort of
    contiguous clients: rows move as one block, with no gather copy)."""
    if ids.size and np.array_equal(ids, np.arange(ids[0], ids[0] + ids.size)):
        return int(ids[0]), int(ids[0]) + ids.size
    return None


class ClientPopulation:
    """Host arena for a population of ``spec.n_clients`` clients: control
    variates (when the spec uses them), participation counters, the
    stable edge map and the per-client seeds.

    ``x0`` fixes the per-client variate leaves' shapes and dtypes. The
    arena starts at the ``variates='zero'`` initialization;
    ``warm_start_variates`` gives the streaming ``'at-init'`` start.
    ``device``: where the cohorts run (the CPU when None). On a GPU the
    arena is page-locked, so a cohort's rows cross to the card and back at
    the copy engines' rate rather than through a staging buffer."""

    def __init__(self, spec: FederationSpec, x0, *, base_seed: int = 0,
                 device=None):
        self.spec = spec
        self.n_total = spec.n_clients
        self.base_seed = int(base_seed)
        # the global client weights, on the host once: cohorts slice this
        self.mu = spec.client_weights("cpu").numpy().astype(np.float32)
        # the stable global client -> edge assignment (zeros when flat)
        self.edge_ids = spec.topology.edge_ids(self.n_total)
        self.participation_counts = np.zeros((self.n_total,), np.int64)
        self.rounds_seen = 0
        pin = device is not None and torch.device(device).type == "cuda"
        if spec.use_variates:
            leaves, self._treedef = tree_flatten(x0)
            self._arena = [torch.zeros((self.n_total,) + tuple(leaf.shape),
                                       dtype=leaf.dtype,
                                       pin_memory=pin)
                           for leaf in leaves]
        else:
            self._treedef = None
            self._arena = None

    # -- per-client randomness ------------------------------------------------
    def client_keys(self, ids) -> np.ndarray:
        """One 63-bit seed per GLOBAL client id (int64 numpy), a function
        of ``(base_seed, id)`` only: stable under any cohorting. Not the
        per-round dither seeds."""
        out = []
        for i in _ids(ids).tolist():
            z = (self.base_seed * 0x9E3779B97F4A7C15 + i + 1) & _M64
            z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9 & _M64
            z = (z ^ (z >> 27)) * 0x94D049BB133111EB & _M64
            out.append((z ^ (z >> 31)) >> 1)
        return np.asarray(out, dtype=np.int64)

    def client_generators(self, ids, device="cpu") -> list:
        """One ``torch.Generator`` on ``device`` per id, seeded by
        ``client_keys``."""
        return [torch.Generator(device=device).manual_seed(int(s))
                for s in self.client_keys(ids)]

    # -- variate arena ----------------------------------------------------------
    @property
    def has_variates(self) -> bool:
        return self._arena is not None

    def gather_variates(self, ids, device=None):
        """The cohort's ``(C, ...)`` variate slice on ``device`` (the host
        when None). Padded (repeated) ids get real copies; the cohort mask
        zeroes their contribution."""
        if self._arena is None:
            return ()
        ids = _ids(ids)
        span = _span(ids)
        if span is not None:
            rows = [leaf[span[0]:span[1]] for leaf in self._arena]
        else:
            idx = torch.from_numpy(ids)
            rows = [leaf.index_select(0, idx) for leaf in self._arena]
        dev = torch.device(device or "cpu")
        # a host slice is copied, so the slice never aliases the arena
        return tree_unflatten(self._treedef, [
            r.to(dev, copy=True) if dev.type == "cpu" else r.to(dev)
            for r in rows])

    def scatter_variates(self, ids, v_new, valid: Optional[np.ndarray] = None):
        """Write a cohort's updated variate rows into the arena; ``valid``
        masks out padded slots (their rows repeat a real client's)."""
        if self._arena is None:
            return
        ids = _ids(ids)
        keep = None
        if valid is not None:
            keep = np.asarray(valid) > 0.5
            ids = ids[keep]
        new_leaves = tree_leaves(v_new)
        if len(new_leaves) != len(self._arena):
            raise ValueError(
                f"scatter_variates got {len(new_leaves)} leaves for an "
                f"arena of {len(self._arena)} — cohort slice and arena "
                f"must share the model tree structure")
        on_write("variate-arena", ids)      # hb: single writer per slot
        span = _span(ids)
        idx = torch.from_numpy(ids)
        for arena_leaf, new_leaf in zip(self._arena, new_leaves):
            rows = torch.as_tensor(new_leaf).detach()
            if keep is not None:
                rows = rows[torch.from_numpy(keep).to(rows.device)]
            if span is not None:
                # straight from the device into the arena's block
                arena_leaf[span[0]:span[1]].copy_(rows)
            else:
                arena_leaf[idx] = rows.to("cpu", arena_leaf.dtype)

    def variates(self):
        """The whole ``(n_total, ...)`` arena as a host pytree (tests,
        checkpoints; never put on the device by the scheduler)."""
        if self._arena is None:
            return ()
        return tree_unflatten(self._treedef, list(self._arena))

    def weighted_variate_sum(self):
        """V = sum_i mu_i V_i on the host, leaf by leaf, in each leaf's
        dtype (the server variate of a scheduler's first state)."""
        if self._arena is None:
            return ()
        mu = torch.from_numpy(self.mu)
        return tree_unflatten(
            self._treedef,
            [_tensordot(mu, leaf).to(leaf.dtype) for leaf in self._arena])

    # -- snapshots ----------------------------------------------------------------
    def snapshot(self) -> dict:
        """The population's host state as a plain structure of copies (the
        next round writes the arena in place)."""
        return {
            "n_total": int(self.n_total),
            "base_seed": int(self.base_seed),
            "mu": self.mu.copy(),
            "participation_counts": self.participation_counts.copy(),
            "rounds_seen": int(self.rounds_seen),
            "arena": ([leaf.clone() for leaf in self._arena]
                      if self._arena is not None else None),
        }

    def load_snapshot(self, snap: dict) -> None:
        """Restore from ``snapshot()``, verifying the layout (client count,
        arena leaf count, shapes, dtypes): a mismatch raises."""
        if int(snap["n_total"]) != self.n_total:
            raise ValueError(f"snapshot holds {snap['n_total']} clients, "
                             f"population holds {self.n_total}")
        arena = snap["arena"]
        if (arena is None) != (self._arena is None):
            raise ValueError("snapshot and population disagree on whether "
                             "control variates exist")
        if arena is not None:
            if len(arena) != len(self._arena):
                raise ValueError(f"snapshot arena has {len(arena)} leaves, "
                                 f"population has {len(self._arena)}")
            for i, (cur, new) in enumerate(zip(self._arena, arena)):
                new = torch.as_tensor(new)
                if new.shape != cur.shape or new.dtype != cur.dtype:
                    raise ValueError(
                        f"arena leaf {i}: snapshot {tuple(new.shape)}/"
                        f"{new.dtype} != population {tuple(cur.shape)}/"
                        f"{cur.dtype}")
        self.base_seed = int(snap["base_seed"])
        self.mu = np.asarray(snap["mu"], np.float32).copy()
        on_write("participation-counts", range(self.n_total))
        self.participation_counts = np.asarray(
            snap["participation_counts"], np.int64).copy()
        self.rounds_seen = int(snap["rounds_seen"])
        if arena is not None:
            on_write("variate-arena", range(self.n_total))
            for cur, new in zip(self._arena, arena):
                cur.copy_(torch.as_tensor(new))

    # -- bookkeeping ----------------------------------------------------------------
    def record_participation(self, ids, active,
                             valid: Optional[np.ndarray] = None):
        """Count realized participations per client (padded slots not)."""
        ids = _ids(ids)
        hit = np.asarray(active).reshape(-1) > 0.5
        if valid is not None:
            hit = hit & (np.asarray(valid) > 0.5)
        on_write("participation-counts", ids[hit])
        np.add.at(self.participation_counts, ids[hit], 1)

    # -- the 'at-init' warm start -----------------------------------------------------
    def warm_start_variates(self, problem, x0, init_batch_fn, *,
                            cohort_size: int, device=None):
        """Streaming ``variates='at-init'``: V_{0,i} = h_i(Shat_0), one
        cohort at a time, so no ``(n_total, ...)`` stack exists on the
        device. ``init_batch_fn(ids) -> (len(ids), ...)`` client batches."""
        if self._arena is None:
            raise ValueError("warm_start_variates needs a spec with "
                             "variates enabled")
        from ..api.driver import _to, resolve_device, variates_at_init
        from ..api.problem import as_problem
        problem = as_problem(problem)
        dev = resolve_device(device)
        x0 = _to(x0, dev)
        param_space = self.spec.aggregation == "parameter"
        for lo in range(0, self.n_total, cohort_size):
            ids = np.arange(lo, min(lo + cohort_size, self.n_total))
            rows = variates_at_init(problem, x0, _to(init_batch_fn(ids), dev),
                                    param_space)
            self.scatter_variates(ids, tree_map(lambda r: r.cpu(), rows))
            del rows
