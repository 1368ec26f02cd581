"""The MM driver: init/step/run (the counterpart of ``repro/api/driver.py``).

``step`` is one round of Algorithm 2 with every federation concern read
off a ``FederationSpec``: the client oracles, the drift
``S_i - Shat - V_i``, the A4 compressor's wire encode (or ``apply`` for
compressors without a wire format), code-space decode, the participation
mask and the mu-weighted reduce, the control-variate updates, and the SA
server step. ``centralized_step`` is Algorithm 1. ``run`` is a Python loop
over ``step``.

Client stage: ``client_mode`` ``"vmap"`` (the oracles of all clients in
one ``torch.func.vmap``, then each client's encode with its own seeds,
stacked into the payload the server decodes) or ``"scan"`` (the clients
one after another, the aggregate accumulated in the iterate's dtype).
``step(..., _oracle_loop=True)`` is the LM trainer's route on a mesh: the
``"vmap"`` stage with the oracles called one client at a time (an oracle
that ``torch.func.vmap`` cannot batch: ctypes kernel launches, autograd
under checkpoint), each client's payload encoded before the next runs.

Mesh: with ``mesh=`` (a ``torch.distributed.device_mesh.DeviceMesh`` with
a ``client_axis`` dim) every rank runs the round for its own contiguous
block of clients: ``x``, ``v``, ``aux``, ``opt`` and ``step`` are
replicated, ``v_i`` and the client batches hold the rank's rows (rank
``r`` of the client dim holds clients ``r n / W`` to ``(r + 1) n / W -
1``). ``uplink="gather"`` gathers the encoded buffers over the client
dim's process group and every rank runs the single-device tail, bit for
bit; ``uplink="reduce"`` decodes and reduces each rank's clients locally
(the fused decode + reduce kernel when the variates are off) and sums
the float32 partial with one all-reduce. The mesh's device type (NCCL on
``"cuda"``, gloo on ``"cpu"``) must be the device the caller runs on.

Topology: ``Topology.two_tier(n_edges, reencode=...)`` reduces within
each edge in float32 (by the stable ``edge_ids``; on a mesh, over the
client dim of an ``(edge, client)`` mesh), optionally re-encodes each
edge's partial at the tier boundary, sums over edges and casts once.
``backbone_bytes`` bills the edge -> root buffers and ``comm_bytes`` is
``uplink_bytes + backbone_bytes``.

Cohorts (the scheduler path, ``repro_torch.sched``): ``step(cohort=
CohortSlice(...))`` runs the client stage on one cohort of C clients and
returns its ``CohortPartial`` without touching the iterate; the scheduler
sums partials and lands them with ``apply_partial`` (two-tier partials
cross the tier boundary at landing, ``finalize_partial``).

Faults (``spec.faults``, a ``repro_torch.faults.FaultSpec``): a round
draws ``(drop, corrupt)`` from the fault lanes (or takes ``fault_draws=``),
folds ``drop`` into the participation mask and damages the ``corrupt``
clients' payloads before verification, which drops them from the round.

Runtime checks (``repro_torch.analysis``): ``sanitize=True`` checks every
floating leaf for NaN and inf at the boundaries of the round's stages, the
index tensors the round gathers with against their range, reads the
flags once at the end of the round and raises ``SanitizerError`` naming
the round, the stage and the leaf (``analysis/runtime.py``: why stage
checks and not checkify's per operation); it also runs the comm-bytes
audit. ``audit_keys=True`` (or a ``KeyAudit``) records every draw from a
``torch.Generator`` and raises
``KeyReuseError`` where two call sites draw from the same generator state
(``analysis/keytrace.py``). Both only read: trajectories are bit for bit
the same with them on.

Randomness: ``key`` is a ``torch.Generator``. Each round draws the
participation mask, then one 32-bit seed per client and leaf
(``participation_draw``), then, under two-tier only, one seed per edge
and leaf for the tier boundary, so that flat trajectories draw what they
always drew. Every rank of a mesh draws the whole round and takes its
rows. ``active=``, ``seeds=`` and ``edge_seeds=`` hand in draws computed
elsewhere (the tests pass the reference's).

Devices: the entry points run on ``device="cuda"`` unless the caller
passes ``device="cpu"``; with no GPU and no such request they raise.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..analysis.keytrace import resolve_audit
from ..analysis.runtime import (Sanitizer, assert_comm_audit,
                                finite_flag, resolve_sanitizer)
from ..core.compression import (PackedLeaf, _tensordot, _tree_bytes,
                                leaf_seeds, stack_payloads, verify_payload,
                                zero_invalid_rows)
from ..faults.injector import corrupt_payload
from ..core.surrogate import (tree_lerp, tree_scale, tree_sq_norm,
                              tree_sq_norm_ew, tree_sub)
from ..tree import tree_leaves, tree_leaves_with_path, tree_map
from .problem import MMProblem, as_problem
from .schedule import resolve_schedule, schedule_length
from . import collective
from .spec import FederationSpec, participation_draw

Pytree = Any


def _under_key_audit(fn):
    """Run ``fn`` (``step``, ``run``) inside the key audit that its
    ``audit_keys=`` asks for, and nothing around it when that is off."""
    @functools.wraps(fn)
    def audited(*args, **kw):
        audit = resolve_audit(kw.get("audit_keys", False))
        with (audit.activate() if audit is not None
              else contextlib.nullcontext()):
            return fn(*args, **kw)
    return audited


CLIENT_MODES = ("vmap", "scan")

UPLINKS = ("gather", "reduce")


class DriverState(NamedTuple):
    """``x`` is Shat_t (surrogate aggregation) or theta_t (parameter
    aggregation); ``v``/``v_i`` the control variates (``()`` when
    ``variates='off'``); ``aux`` problem-owned server state; ``opt``
    server-optimizer state (or the FedAvgM momentum buffer)."""
    x: Pytree
    v: Pytree
    v_i: Pytree
    aux: Pytree
    opt: Pytree
    step: torch.Tensor


class CohortSlice(NamedTuple):
    """The per-round inputs of ONE cohort of C clients, gathered by a
    scheduler from its population arena; every leading dim is C.

    ``mask``: the participation mask of the cohort's clients (0.0 also on
    padded slots of a ragged last cohort); ``mu``: the matching slice of
    the global client weights, not renormalized (pads zeroed), so summing
    cohort partials gives the population's weighted reduce; ``seeds``:
    the clients' (C, n_leaves) dither seeds from the round's draw;
    ``v_i``: the cohort's control variates (on a mesh, the rank's rows;
    ``()`` when the variates are off); ``valid``: 1.0 on real clients, 0.0
    on padded slots (None: all real); ``corrupt``: bool flags of clients
    whose payload is damaged in flight (needs a checksummed wire format);
    ``edge_ids``: the cohort's slice of the population's stable client ->
    edge map (required under two-tier)."""
    mask: Any
    mu: Any
    seeds: Any
    v_i: Pytree = ()
    valid: Any = None
    corrupt: Any = None
    edge_ids: Any = None


class CohortPartial(NamedTuple):
    """One cohort's contribution to a round: ``agg``, the masked
    mu-weighted partial aggregate (iterate dtype; under two-tier the
    ``(n_edges,)``-stacked float32 per-edge partial, finalized at landing
    by ``finalize_partial``), the updated variates (``v_i``), the count of
    clients that survived verification, the billed uplink bytes (every
    active real client that sent; float64, exact, so that a scheduler's
    sum over cohorts rounds to ``step``'s float32 bill once, at landing,
    where the reference sums float32 bills and rounds at model width),
    the per-client oracle metrics summed
    over the cohort's real clients (divide by n after summing cohorts),
    the mesh collective's operand bytes (None off the mesh), and, when
    the cohort holds all n clients, ``step``'s own means of those metrics
    (``torch.mean`` over the client dim; on CUDA a mean multiplies by
    1 / n, so the sum over n may part from it by an ulp), else None."""
    agg: Pytree
    v_i: Pytree
    n_active: torch.Tensor
    comm_bytes: torch.Tensor
    metric_sums: dict
    collective_payload_bytes: Optional[float]
    metric_means: Optional[dict] = None


def resolve_device(device=None) -> torch.device:
    """``device`` or, when None, the GPU. Raises when the GPU is asked for
    and there is none: the CPU is used only on request."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the GPU "
                           "unless the caller passes device='cpu'")
    return dev


def _to(tree, dev):
    return tree_map(lambda x: x.to(dev) if isinstance(x, torch.Tensor)
                    else x, tree)


def _take(tree, c: int):
    return tree_map(lambda x: x[c], tree)


def _rows(tree, lo: int, hi: int):
    """Clients ``lo`` to ``hi - 1`` of a client-stacked tree."""
    return tree_map(lambda x: x[lo:hi], tree)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def variates_at_init(problem: MMProblem, x0, client_batches,
                     param_space: bool = False):
    """V_{0,i} = h_i(Shat_0), one full local expectation per client (with
    ``param_space=True``: T(Sbar_i(theta_0)) - theta_0)."""
    theta0 = x0 if param_space else problem.T(x0)

    def one(batch):
        s_i = problem.s_bar(batch, theta0)
        out = problem.T(s_i) if param_space else s_i
        return tree_sub(out, x0)

    return torch.func.vmap(one)(client_batches)


def init(problem, x0, spec: FederationSpec, v0_i=None, init_batches=None,
         device=None) -> DriverState:
    problem = as_problem(problem)
    dev = resolve_device(device)
    x0 = _to(x0, dev)
    if spec.use_variates:
        if v0_i is None and spec.variates == "at-init":
            if init_batches is None:
                raise ValueError("variates='at-init' needs init_batches "
                                 "(an (n, ...) pytree of client data)")
            v0_i = variates_at_init(problem, x0, _to(init_batches, dev),
                                    spec.aggregation == "parameter")
        if v0_i is None:
            v0_i = tree_map(
                lambda x: torch.zeros((spec.n_clients,) + tuple(x.shape),
                                      dtype=x.dtype, device=dev), x0)
        v0_i = _to(v0_i, dev)
        mu = spec.client_weights(dev)
        v = tree_map(lambda x: _tensordot(mu, x), v0_i)
    else:
        v, v0_i = (), ()
    aux = problem.init_aux() if problem.init_aux is not None else ()
    if spec.server_momentum > 0.0:
        if problem.server_opt is not None or problem.init_opt is not None:
            raise ValueError(
                "server_momentum and a custom MMProblem.server_opt/init_opt "
                "both claim the server update — fold the momentum into your "
                "server_opt instead")
        opt = tree_map(torch.zeros_like, x0)
    else:
        opt = problem.init_opt(x0) if problem.init_opt is not None else ()
    return DriverState(x=x0, v=v, v_i=v0_i, aux=aux, opt=opt,
                       step=torch.tensor(0))


def centralized_init(problem, s0, device=None) -> DriverState:
    del problem
    return DriverState(x=_to(s0, resolve_device(device)), v=(), v_i=(),
                       aux=(), opt=(), step=torch.tensor(0))


# ---------------------------------------------------------------------------
# step
# ---------------------------------------------------------------------------

def _variate_update(v, q, coef):
    """Lines 8/11/17: V <- V + coef * q, leaf-wise (coef = alpha/p). The
    sum lands in the product's own buffer (``coef * q`` then ``+ v``, the
    same two roundings) rather than a second full-size temporary."""
    return tree_map(lambda vv, dq: (coef * dq).add_(vv), v, q)


def _weighted_reduce(w, q):
    """The mu-weighted client reduction (line 13), dtype-preserving."""
    return tree_map(lambda x: _tensordot(w, x).to(x.dtype), q)


def _edge_partials(q, w, edge_ids, n_edges: int):
    """Per-edge mu-weighted partial sums in float32: the within-edge half
    of the two-tier reduce, grouped by the stable client -> edge
    assignment ``edge_ids`` (one segment sum per leaf)."""
    def one(x):
        wcol = w.to(torch.float32).reshape((-1,) + (1,) * (x.ndim - 1))
        out = torch.zeros((n_edges,) + tuple(x.shape[1:]),
                          dtype=torch.float32, device=x.device)
        return out.index_add_(0, edge_ids.to(x.device),
                              x.to(torch.float32) * wcol)
    return tree_map(one, q)


def tier_boundary(spec: FederationSpec, edge_parts, edge_seeds, x_ref):
    """Cross the edge -> root tier: optionally re-encode each edge's
    partial (``Compressor.reencode`` with that edge's seeds; digests are
    stamped anew), measure the buffers that cross the backbone, sum over
    edges and cast once to the iterate's dtype. ``edge_parts``: an
    ``(n_edges,)``-stacked float32 partial per leaf; ``edge_seeds``:
    ``(n_edges, n_leaves)``. Returns ``(agg, backbone_bytes)``."""
    comp = spec.compressor
    if spec.topology.reencode:
        payload = stack_payloads([
            comp.reencode(edge_seeds[e].tolist(), _take(edge_parts, e))
            for e in range(edge_seeds.shape[0])])
        backbone_bytes = float(_tree_bytes(payload))
        edge_parts = comp.decode(payload)
    else:
        backbone_bytes = float(_tree_bytes(edge_parts))
    agg = tree_map(lambda e, x: torch.sum(e, dim=0).to(x.dtype),
                   edge_parts, x_ref)
    return agg, backbone_bytes


def finalize_partial(spec: FederationSpec, agg, edge_seeds, x_ref):
    """The scheduler's landing-time tier crossing: a two-tier partial
    accumulates as ``(n_edges,)``-stacked float32 edge sums (re-encoding
    is nonlinear, so cohorts sum before the boundary) and crosses here
    with the landing round's edge seeds. A flat partial passes through
    with no backbone bytes. Returns ``(agg, backbone_bytes)``."""
    topo = spec.topology
    if not topo.is_two_tier:
        return agg, 0.0
    edge_seeds = torch.as_tensor(edge_seeds, dtype=torch.int64).reshape(
        topo.n_edges, -1)
    return tier_boundary(spec, agg, edge_seeds, x_ref)


def _map_buffers(fn, payload):
    """``fn`` on every buffer of a payload tree (codes, scales and digest
    of each ``PackedLeaf``; raw leaves as they are)."""
    def leaf(p):
        if not isinstance(p, PackedLeaf):
            return fn(p)
        return dataclasses.replace(
            p, codes=fn(p.codes), scales=fn(p.scales),
            check=None if p.check is None else fn(p.check))
    return tree_map(leaf, payload, is_leaf=lambda x: isinstance(x,
                                                                PackedLeaf))


def _finite_flags(tree) -> dict:
    """``path ->`` True where every element of the floating leaf is
    finite (under ``torch.func.vmap``, one flag a client)."""
    return {p: finite_flag(x)
            for p, x in tree_leaves_with_path(tree) if x.is_floating_point()}


def _stack_flags(fls: list) -> dict:
    """One client's ``{stage: {path: flag}}`` after another, stacked over
    the clients as ``torch.func.vmap`` returns them."""
    return {stage: {p: torch.stack([fl[stage][p] for fl in fls])
                    for p in fls[0][stage]} for stage in fls[0]}


def _client_stage(problem: MMProblem, spec: FederationSpec, view, x_ref,
                  client_batches, v_i, seeds, mask, mu, *, client_mode,
                  uplink="gather", mesh=None, client_axis="clients",
                  rows=None, edge_seeds=None, edge_ids=None, corrupt=None,
                  tier_finalize=True, oracle_loop=False, san=None):
    """The client half of Algorithm 2. ``seeds``, ``mask`` and ``mu`` cover
    all n clients; ``client_batches`` and ``v_i`` the clients of ``rows``
    (``(lo, hi)``: the rank's block on a mesh, all n off it). Returns
    ``(agg, v_i_new, cmetrics, wire_bytes_client, n_survive,
    collective_bytes, backbone_bytes)``: the masked mu-weighted aggregate
    (iterate dtype), the updated variates of ``rows``, stacked per-client
    oracle metrics of all n clients, the measured per-client uplink bytes
    (None for compressors without a wire format), the count of active
    clients whose payload passed verification (``sum(mask)`` without
    checksums), the bytes of the mesh collective's operand (None off the
    mesh) and the measured edge -> root bytes (None for the flat
    topology).

    ``edge_ids``: the stage's clients' edges (default: the spec's stable
    map of all n). ``corrupt``: bool flags of clients whose payload is
    damaged (``spec.faults.corrupt_kind``) between encode and verify.
    ``tier_finalize=False`` (the cohort path) returns the two-tier
    ``(n_edges,)`` float32 per-edge partial instead of crossing the
    boundary. ``oracle_loop``: the ``"vmap"`` stage with the oracles
    called one client at a time. ``san``: a ``Sanitizer`` that the stage's
    checks are queued into (the oracle's output, ``T`` of it, the drift,
    the updated variates: per client, gathered over a mesh; the edge
    ids' range), or None."""
    p, alpha = spec.participation, spec.alpha
    param_space = spec.aggregation == "parameter"
    use_v = spec.use_variates
    comp = spec.compressor
    use_wire = comp.encode is not None
    verify = use_wire and comp.checksum
    if corrupt is not None and not verify:
        raise ValueError("corrupt flags need a checksummed wire-format "
                         "compressor (block_quant(..., checksum=True)) — "
                         "undetected damage would poison the aggregate")
    kind = spec.faults.corrupt_kind if spec.faults is not None else "flip"
    topo = spec.topology
    two_tier = topo.is_two_tier
    n = mask.shape[0]
    lo, hi = (0, n) if rows is None else rows
    n_local = hi - lo
    if two_tier:
        edge_ids = torch.as_tensor(
            topo.edge_ids(n) if edge_ids is None else edge_ids,
            dtype=torch.int64)
        if san is not None:
            san.check_index("aggregate", "edge_ids", edge_ids, topo.n_edges)
        edge_ids = edge_ids.to(mask.device)
    collective_bytes = backbone_bytes = None

    def oracle(batch, v_c):
        """One client's oracle (+ optional metrics) and drift, and under
        ``san`` the stages' finite flags."""
        flags = {}
        if problem.s_bar_metrics is not None:
            s_i, cm = problem.s_bar_metrics(batch, view)   # line 6
        else:
            s_i, cm = problem.s_bar(batch, view), {}
        if san is not None:
            flags["oracle"] = _finite_flags(s_i)
        out = problem.T(s_i) if param_space else s_i       # eq. 21
        if san is not None and param_space:
            flags["T"] = _finite_flags(out)
        if spec.delta == "oracle":
            return out, cm, flags
        d = tree_sub(out, x_ref)                           # line 7
        if use_v:
            d = tree_sub(d, v_c)
        if san is not None:
            flags["drift"] = _finite_flags(d)
        return d, cm, flags

    def sanitized(flags, v_new):
        """Queue the stage's flags (stacked over the local clients) and the
        updated variates', gathered over the mesh's client dims."""
        if use_v and tree_leaves(v_new):
            flags = dict(flags, variates={
                p: finite_flag(x, rows=True)
                for p, x in tree_leaves_with_path(v_new)})
        for stage, fl in flags.items():
            if mesh is not None:
                dims = collective.client_dims(topo, client_axis)
                fl = {p: collective.gather_rows(f.to(torch.uint8), mesh, dims)
                      for p, f in fl.items()}
            san.check_flags(stage, fl)

    def compress(c, d):                                    # line 9
        key = seeds[c].tolist()
        return comp.encode(key, d) if use_wire else comp.apply(key, d)

    def masked(x, m):
        # dtype-preserving: an f32 mask never upcasts a bf16 payload. A
        # decoded payload is the driver's own buffer: mask it in place
        m = m.to(x.dtype)
        return x.mul_(m) if use_wire else x * m

    def rows_mask(m, x):
        return m.reshape((m.shape[0],) + (1,) * (x.ndim - 1))

    def checked(payload, flags):
        """Damage the flagged rows (if any), then verify: returns the
        payload with failing rows zeroed and the ok flags. Zeroing comes
        before decode: NaN scale bits times a zero weight are still NaN."""
        if flags is not None:
            payload = corrupt_payload(payload, flags, kind)
        ok = verify_payload(payload)
        return zero_invalid_rows(payload, ok), ok

    def receive(payload, m, own, weights=None, flags=None):
        """The server's side of the uplink on a stack of payloads whose
        clients' mask is ``m``: verify and zero the rows that fail, then
        decode, mask (non-participating clients send nothing and keep
        V_i) and update the variates of the stack's rows ``own`` (this
        rank's clients). With ``weights`` the mask folds into them (it is
        0.0/1.0) and the decode into the weighted sum: the decoded stack
        never exists. Returns ``(q, or the float32 sum with weights;
        v_i_new; the surviving clients' mask)``."""
        surv = m
        if verify:
            payload, ok = checked(payload, flags)
            surv = m * ok.to(m.device, torch.float32)
        if weights is not None:
            part = comp.decode_reduce(payload, weights * m, fused=True)
            return part, (), surv
        q = comp.decode(payload) if use_wire else payload
        del payload
        q = tree_map(lambda x: masked(x, rows_mask(m, x)), q)
        v_new = (_variate_update(v_i, _rows(q, *own), alpha / p) if use_v
                 else ())
        return q, v_new, surv

    if client_mode == "scan":
        # one client's oracle/quantize transients live at a time; the
        # aggregate accumulates in the iterate's dtype (flat) or edge by
        # edge in float32 (two-tier: the tier boundary casts once)
        if two_tier:
            agg = tree_map(lambda x: torch.zeros(
                (topo.n_edges,) + tuple(x.shape), dtype=torch.float32,
                device=x.device), x_ref)
        else:
            agg = tree_map(torch.zeros_like, x_ref)
        v_i_new = tree_map(torch.empty_like, v_i) if use_v else ()
        cms, fls = [], []
        n_survive = torch.zeros((), dtype=torch.float32, device=mask.device)
        wire_bytes_client = None
        for c in range(n_local):
            v_c = _take(v_i, c) if use_v else None
            d, cm, fl = oracle(_take(client_batches, c), v_c)
            payload_c = compress(c, d)
            del d
            surv_c = mask[c]
            if use_wire:
                wire_bytes_client = float(comp.encoded_bytes(payload_c))
            if verify:
                payload_c, ok = checked(
                    payload_c, None if corrupt is None else corrupt[c])
                surv_c = mask[c] * ok.to(mask.device, torch.float32)
            q_c = comp.decode(payload_c) if use_wire else payload_c
            q_c = tree_map(lambda x: masked(x, mask[c]), q_c)
            if use_v:
                tree_map(lambda dst, src: dst[c].copy_(src), v_i_new,
                         _variate_update(v_c, q_c, alpha / p))
            if two_tier:
                e = int(edge_ids[c])
                tree_map(lambda a, x: a[e].add_(mu[c] * x.to(torch.float32)),
                         agg, q_c)
            else:
                agg = tree_map(lambda a, x: a + (mu[c] * x).to(a.dtype),
                               agg, q_c)
            n_survive = n_survive + surv_c
            cms.append(cm)
            fls.append(fl)
        cmetrics = tree_map(lambda *xs: torch.stack(xs), *cms)
        if san is not None:
            sanitized(_stack_flags(fls), v_i_new)
        if two_tier and tier_finalize:
            agg, backbone_bytes = tier_boundary(spec, agg, edge_seeds, x_ref)
        return (agg, v_i_new, cmetrics, wire_bytes_client, n_survive,
                collective_bytes, backbone_bytes)

    # "vmap": every local client's oracle in one batched call, then each
    # client's payload with its own seeds, stacked as the server gets it.
    # Encoding client by client gives the batched encode's values without
    # its memory: at model width the streamed hash dither alone holds
    # several GB of int64 temporaries per client.
    if oracle_loop:
        # one client's oracle and drift alive at a time: what stays is
        # its payload
        parts, cms, fls = [], [], []
        for c in range(n_local):
            d, cm, fl = oracle(_take(client_batches, c),
                               _take(v_i, c) if use_v else None)
            parts.append(compress(lo + c, d))
            del d
            cms.append(cm)
            fls.append(fl)
        cmetrics = tree_map(lambda *xs: torch.stack(xs), *cms)
        flags = _stack_flags(fls)
    else:
        if use_v:
            d_stack, cmetrics, flags = torch.func.vmap(oracle)(client_batches,
                                                               v_i)
        else:
            d_stack, cmetrics, flags = torch.func.vmap(
                lambda b: oracle(b, None))(client_batches)
        parts = [compress(lo + c, _take(d_stack, c))
                 for c in range(n_local)]
        del d_stack
    payload = (stack_payloads(parts) if use_wire
               else tree_map(lambda *xs: torch.stack(xs), *parts))
    del parts
    if use_wire:
        # actual uplink bytes of ONE client, read off the stacked buffers
        wire_bytes_client = comp.encoded_bytes(payload) / n_local
    else:
        wire_bytes_client = None
    dims = (collective.client_dims(topo, client_axis) if mesh is not None
            else ())
    if mesh is not None:
        # the per-client oracle metrics of every client
        cmetrics = tree_map(lambda x: collective.gather_rows(x, mesh, dims),
                            cmetrics)

    if mesh is not None and uplink == "reduce":
        if two_tier and not tier_finalize:
            raise ValueError(
                "two-tier uplink='reduce' groups clients by mesh position; "
                "a streamed cohort's edge membership is data-dependent — "
                "use uplink='gather' under the scheduler")
        # each rank decodes, masks and mu-reduces its own clients; the
        # float32 partial crosses the mesh in ONE all-reduce (edge-scoped
        # under two-tier, then one more across edges) and is cast once
        mu_l = mu[lo:hi]
        fused = not use_v and use_wire and comp.decode_reduce is not None
        part, v_i_new, surv = receive(
            payload, mask[lo:hi], (0, n_local), mu_l if fused else None,
            None if corrupt is None else corrupt[lo:hi])
        del payload
        if not fused:
            part = tree_map(lambda x: _tensordot(mu_l, x), part)
        collective_bytes = float(_tree_bytes(part))
        part = tree_map(lambda x: collective.sum_over(x, mesh,
                                                      (client_axis,)), part)
        if two_tier:
            e = collective.client_block(mesh, (topo.edge_axis,))[0]
            if topo.reencode:
                pay_e = comp.reencode(edge_seeds[e].tolist(), part)
                edge_bytes = float(_tree_bytes(pay_e))
                part = comp.decode(pay_e)
                del pay_e
            else:
                edge_bytes = float(_tree_bytes(part))
            part = tree_map(lambda x: collective.sum_over(
                x, mesh, (topo.edge_axis,)), part)
            backbone_bytes = edge_bytes * topo.n_edges
        n_survive = (collective.sum_over(torch.sum(surv), mesh, dims)
                     if verify else torch.sum(mask))
        agg = tree_map(lambda a, x: a.to(x.dtype), part, x_ref)
        if san is not None:
            sanitized(flags, v_i_new)
        return (agg, v_i_new, cmetrics, wire_bytes_client, n_survive,
                collective_bytes, backbone_bytes)

    if mesh is not None:
        # the uplink moves the encoded buffers; every rank then holds the
        # stack of all n clients in client order and runs the tail below
        payload = _map_buffers(
            lambda x: collective.gather_rows(x, mesh, dims), payload)
        collective_bytes = float(_tree_bytes(payload))
    q, v_i_new, surv = receive(payload, mask, (lo, hi), flags=corrupt)
    del payload
    n_survive = torch.sum(surv)
    if san is not None:
        sanitized(flags, v_i_new)
    if two_tier:
        agg = _edge_partials(q, mu, edge_ids, topo.n_edges)
        del q
        if tier_finalize:
            agg, backbone_bytes = tier_boundary(spec, agg, edge_seeds, x_ref)
    else:
        agg = _weighted_reduce(mu, q)
    return (agg, v_i_new, cmetrics, wire_bytes_client, n_survive,
            collective_bytes, backbone_bytes)


def _server_apply(problem: MMProblem, spec: FederationSpec,
                  state: DriverState, agg, v_i_new, n_active, gamma,
                  san: Optional[Sanitizer] = None):
    """The server half of Algorithm 2: normalization, the control-variate
    shift, the server update (custom server_opt, FedAvgM momentum, or the
    SA step + projection), the server variate update (line 17) and the
    problem's aux update. Returns ``(new_state, h, aux_metrics)``. ``san``:
    the ``Sanitizer`` the server stages' checks are queued into."""
    n, p, alpha = spec.n_clients, spec.participation, spec.alpha
    param_space = spec.aggregation == "parameter"
    use_v = spec.use_variates
    if spec.normalization == "realized":
        scale = n / torch.clamp(n_active, min=1.0)
        h = tree_map(lambda a: (scale * a).to(a.dtype), agg)
    else:
        h = tree_scale(agg, 1.0 / p)
    if use_v:
        h = tree_map(lambda v, hh: v + hh.to(v.dtype), state.v, h)

    if problem.server_opt is not None:
        if spec.server_momentum > 0.0:
            raise ValueError(
                "server_momentum and a custom MMProblem.server_opt both "
                "claim the server update — fold the momentum into your "
                "server_opt instead")
        x_new, opt_new = problem.server_opt(state.x, h, gamma, state.opt)
        project = False
    elif spec.server_momentum > 0.0:
        opt_new = tree_map(
            lambda m, hh: (spec.server_momentum * m
                           + hh.to(m.dtype)).to(m.dtype), state.opt, h)
        x_new = tree_map(
            lambda mm, xx: (gamma * mm.to(xx.dtype) + xx).to(xx.dtype),
            opt_new, state.x)
        project = not param_space
    else:
        x_new = tree_map(
            lambda hh, xx: (gamma * hh.to(xx.dtype) + xx).to(xx.dtype),
            h, state.x)
        project = not param_space
        opt_new = state.opt
    if san is not None:
        san.check_finite("server_step", x_new)
    if project:
        x_new = problem.project(x_new)
        if san is not None:
            san.check_finite("project", x_new)

    v_new = (tree_map(lambda v, a: v + ((alpha / p) * a).to(v.dtype),
                      state.v, agg) if use_v else ())
    if san is not None:
        san.check_finite("variates", v_new, prefix="v")

    if problem.server_step is not None:
        aux_new, aux_metrics = problem.server_step(state.aux, x_new)
    else:
        aux_new, aux_metrics = state.aux, {}
    new_state = DriverState(x=x_new, v=v_new, v_i=v_i_new, aux=aux_new,
                            opt=opt_new, step=state.step + 1)
    return new_state, h, aux_metrics


def _broadcast_view(problem: MMProblem, spec: FederationSpec,
                    state: DriverState):
    """Line 4: the view broadcast to clients."""
    if spec.aggregation == "parameter":
        return state.x
    if problem.view is not None:
        return problem.view(state.x, state.aux)
    return problem.T(state.x)


def centralized_step(problem: MMProblem, state: DriverState, batch, gamma):
    """Algorithm 1 (SA-SSMM): oracle, SA blend, projection."""
    theta = problem.T(state.x)
    s_oracle = problem.s_bar(batch, theta)                 # line 2
    s_new = tree_lerp(state.x, s_oracle, gamma)            # line 3
    s_new = problem.project(s_new)
    drift = tree_sub(s_new, state.x)
    metrics = {"e_s": tree_sq_norm(drift) / (gamma ** 2)}
    return state._replace(x=s_new, step=state.step + 1), metrics


def _validate(spec: FederationSpec, mesh, client_axis, client_mode, uplink,
              dev: torch.device, n_stage: Optional[int] = None) -> None:
    """The knobs of a round, checked as the reference's
    ``_validate_topology`` checks them, plus what the port adds: the mesh
    is a ``DeviceMesh`` on the device the caller runs on, over NCCL on the
    GPU and gloo on the CPU. ``n_stage``: the client stage's leading count
    that must divide over the mesh (the cohort size on the cohort path;
    by default ``spec.n_clients``)."""
    if client_mode not in CLIENT_MODES:
        raise ValueError(f"client_mode={client_mode!r} (want {CLIENT_MODES})")
    if uplink not in UPLINKS:
        raise ValueError(f"uplink={uplink!r} (want {UPLINKS})")
    if uplink == "reduce" and mesh is None:
        raise ValueError("uplink='reduce' is the cross-mesh partial-reduce "
                         "collective; it needs mesh= (without a mesh the "
                         "vmap path has no collective to fuse)")
    if mesh is None:
        return
    if client_mode != "vmap":
        raise ValueError("the mesh path runs the batched client stage; "
                         "client_mode='scan' is sequential — drop mesh= or "
                         "use 'vmap'")
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh= takes a torch.distributed.device_mesh."
                        f"DeviceMesh, got {type(mesh).__name__}")
    shape = collective.mesh_shape(mesh)
    if client_axis not in shape:
        raise ValueError(f"client_axis={client_axis!r} not an axis of "
                         f"the mesh (axes: {tuple(shape)})")
    topo = spec.topology
    if topo.is_two_tier:
        e_ax = topo.edge_axis
        if e_ax == client_axis:
            raise ValueError(
                f"topology.edge_axis={e_ax!r} collides with client_axis — "
                f"the two-tier mesh needs distinct (edge, client) axes")
        if e_ax not in shape:
            raise ValueError(
                f"topology.edge_axis={e_ax!r} not an axis of the mesh "
                f"(axes: {tuple(shape)}) — build a 2-D (edge, client) mesh "
                f"(launch.mesh.make_edge_mesh)")
        if shape[e_ax] != topo.n_edges:
            raise ValueError(
                f"mesh axis {e_ax!r} has size {shape[e_ax]} but the "
                f"topology declares n_edges={topo.n_edges} — one mesh row "
                f"per edge aggregator")
    if mesh.device_type != dev.type:
        raise ValueError(f"the mesh lives on {mesh.device_type!r} but the "
                         f"round runs on {dev.type!r}: build the mesh on the "
                         f"device the round runs on")
    want = "nccl" if dev.type == "cuda" else "gloo"
    for d in collective.client_dims(topo, client_axis):
        backend = str(dist.get_backend(mesh.get_group(d)))
        if want not in backend:
            raise ValueError(f"mesh dim {d!r} runs over {backend!r}; a "
                             f"{dev.type} mesh runs over {want}")
    count = 1
    for d in collective.client_dims(topo, client_axis):
        count *= shape[d]
    n_stage = spec.n_clients if n_stage is None else n_stage
    if n_stage % count:
        raise ValueError(
            f"the client-stage leading dim ({n_stage} clients) must "
            f"divide evenly over the mesh axes "
            f"{collective.client_dims(topo, client_axis)} (total size "
            f"{count})")


def local_rows(spec: FederationSpec, mesh, client_axis: str = "clients",
               n: Optional[int] = None):
    """``(lo, hi)``: the clients this rank holds of a stage of ``n``
    (default ``spec.n_clients``; a cohort's C on the cohort path), ``(0,
    n)`` off a mesh."""
    n = spec.n_clients if n is None else n
    if mesh is None:
        return 0, n
    b, count = collective.client_block(
        mesh, collective.client_dims(spec.topology, client_axis))
    per = n // count
    return b * per, (b + 1) * per


@_under_key_audit
def step(problem: MMProblem, spec: FederationSpec, state: DriverState,
         client_batches, gamma, key: Optional[torch.Generator] = None,
         active=None, *, seeds=None, edge_seeds=None, device=None,
         mesh=None, client_axis: str = "clients", client_mode: str = "vmap",
         uplink: str = "gather", drift_metric: bool = True,
         sanitize=False, audit_keys=False,
         cohort: Optional[CohortSlice] = None, fault_draws=None,
         _oracle_loop: bool = False):
    """One federated MM round. ``client_batches``: a pytree with a leading
    client axis (all n clients, or the rank's block on a mesh; ``v_i``
    likewise). ``key``: the round's ``torch.Generator`` (the participation
    draw, then per-client, per-leaf seeds, then under two-tier per-edge,
    per-leaf seeds). ``active``: an (n,) bool/0-1 mask that overrides the
    drawn one; ``seeds``: an (n, n_leaves) array of 32-bit dither seeds;
    ``edge_seeds``: an (n_edges, n_leaves) array for the tier boundary;
    ``fault_draws``: ``(drop, corrupt)``, two (n,) bool arrays that
    override the fault lanes' draw (``spec.faults.client_draw`` from
    ``key.initial_seed()`` and ``state.step``). With all the draws given,
    ``key`` may be None.

    ``cohort``: the scheduler path. The client stage runs on the
    ``CohortSlice``'s clients (``client_batches`` holds their C rows, the
    rank's rows on a mesh) and the ``CohortPartial`` comes back without a
    server update; ``gamma``, ``key``, ``active`` and the draws are not
    used.

    ``comm_bytes`` is read off the actual encoded buffers for wire-format
    compressors (the analytic ``payload_bytes`` otherwise), plus the
    backbone under two-tier. On a mesh, ``collective_payload_bytes`` is
    the bytes of the collective's operand: the gathered stack
    (``uplink="gather"``) or the float32 partial (``"reduce"``).

    ``sanitize``: the stage checks (``analysis/runtime.py``), read once
    at the end of the round, which raises ``SanitizerError`` naming the
    round, the stage and the leaf; and the comm-bytes audit
    (``assert_comm_audit``). A
    ``Sanitizer`` instance queues the checks into it and leaves the raise
    to its owner (the scheduler raises once a round). ``audit_keys``:
    True, or a ``KeyAudit`` to read its report afterwards, audits the
    round's draws (``analysis/keytrace.py``). Both only read: the round's
    results are bit for bit those with both off.

    ``_oracle_loop``: internal, the LM trainer's route (the module
    docstring); it runs the ``"vmap"`` stage only."""
    problem = as_problem(problem)
    dev = resolve_device(device)
    san = resolve_sanitizer(sanitize) if sanitize else None
    if cohort is not None:
        return _cohort_partial(problem, spec, state, client_batches, cohort,
                               dev=dev, mesh=mesh, client_axis=client_axis,
                               client_mode=client_mode, uplink=uplink,
                               san=san,
                               own=san is not None and san is not sanitize)
    _validate(spec, mesh, client_axis, client_mode, uplink, dev)
    n, p = spec.n_clients, spec.participation
    comp = spec.compressor
    use_wire = comp.encode is not None
    topo = spec.topology
    state = DriverState(*(_to(f, dev) for f in state))
    client_batches = _to(client_batches, dev)
    mu = spec.client_weights(dev)
    rows = local_rows(spec, mesh, client_axis)
    lead = tree_leaves(client_batches)[0].shape[0]
    if lead != rows[1] - rows[0]:
        raise ValueError(
            f"client_batches hold {lead} clients; this rank holds clients "
            f"{rows[0]}..{rows[1] - 1} of {n}"
            + (" (on a mesh, pass the rank's own rows)" if mesh is not None
               else ""))

    view = _broadcast_view(problem, spec, state)           # line 4
    if san is not None and spec.aggregation != "parameter":
        san.check_finite("T", view)

    n_leaves = len(tree_leaves(state.x))
    if key is not None:
        drawn, drawn_seeds = participation_draw(key, spec, n_leaves)  # A5
        active = drawn if active is None else active
        seeds = drawn_seeds if seeds is None else seeds
        if topo.is_two_tier:
            drawn_edge = torch.tensor(
                [leaf_seeds(key, n_leaves) for _ in range(topo.n_edges)],
                dtype=torch.int64)
            edge_seeds = drawn_edge if edge_seeds is None else edge_seeds
    elif active is None or seeds is None or (topo.is_two_tier
                                             and edge_seeds is None):
        raise ValueError("step needs a key, or active= and seeds= (and "
                         "edge_seeds= under a two-tier topology)")
    seeds = torch.as_tensor(seeds, dtype=torch.int64).reshape(n, n_leaves)
    if topo.is_two_tier:
        edge_seeds = torch.as_tensor(edge_seeds, dtype=torch.int64).reshape(
            topo.n_edges, n_leaves)
    corrupt = None
    faults = spec.faults
    if faults is not None and faults.any_injection:
        # private lanes: the participation and seed draws above are
        # untouched, so a zero-probability FaultSpec changes nothing
        if fault_draws is None:
            if key is None:
                raise ValueError("a round with fault injection needs a key, "
                                 "or fault_draws=(drop, corrupt)")
            fault_draws = faults.client_draw(key.initial_seed(),
                                             int(state.step), n)
        drop, corr = (d.to("cpu", torch.bool).reshape(n)
                      if isinstance(d, torch.Tensor)
                      else torch.tensor(np.asarray(d, dtype=bool)).reshape(n)
                      for d in fault_draws)
        # a dropped client's uplink never arrives: it leaves the mask
        active = torch.as_tensor(active).to(torch.bool).reshape(n).cpu() \
            & ~drop
        corrupt = corr if faults.corrupt > 0.0 else None
    mask = torch.as_tensor(active).to(dev, torch.float32).reshape(n)

    (agg, v_i_new, cmetrics, wire_bytes_client, n_survive, collective_bytes,
     backbone_bytes) = _client_stage(
        problem, spec, view, state.x, client_batches, state.v_i, seeds, mask,
        mu, client_mode=client_mode, uplink=uplink, mesh=mesh,
        client_axis=client_axis, rows=rows, edge_seeds=edge_seeds,
        corrupt=corrupt, oracle_loop=_oracle_loop, san=san)
    new_state, metrics = apply_partial(
        problem, spec, state._replace(v_i=v_i_new), agg, n_survive, gamma,
        drift_metric=drift_metric, device=dev, sanitize=san)

    comm = comp.round_metrics(state.x, p=p)
    per_client = (wire_bytes_client if use_wire
                  else comm["payload_bytes_per_client"])
    if san is not None and use_wire:
        assert_comm_audit(
            comp, state.x, per_client,
            where=f"step(client_mode={client_mode!r}, uplink={uplink!r})")
    uplink_bytes = per_client * torch.sum(mask)
    backbone = torch.tensor(0.0 if backbone_bytes is None else backbone_bytes,
                            dtype=torch.float32)
    # client -> edge (flat: client -> root); edge -> root: the tier
    # boundary's buffers (0 for flat)
    metrics.update(uplink_bytes=uplink_bytes, backbone_bytes=backbone,
                   comm_bytes=uplink_bytes + backbone)
    if collective_bytes is not None:
        metrics["collective_payload_bytes"] = torch.tensor(
            collective_bytes, dtype=torch.float32)
    _merge_client_metrics(metrics, {k: torch.mean(v, dim=0)
                                   for k, v in cmetrics.items()})
    if san is not None and san is not sanitize:
        san.raise_if_tripped(lambda: f"round {int(state.step)}")
    return new_state, metrics


def _merge_client_metrics(metrics: dict, client_means: dict) -> None:
    """Add the problem's per-client metric means (``s_bar_metrics``) to a
    round's driver metrics, in place; a key that both report raises."""
    dup = set(client_means) & set(metrics)
    if dup:
        raise ValueError(f"s_bar_metrics keys {sorted(dup)} collide with "
                         f"driver metrics — rename them in the problem")
    metrics.update(client_means)


def _cohort_partial(problem: MMProblem, spec: FederationSpec,
                    state: DriverState, client_batches, cohort: CohortSlice,
                    *, dev, mesh, client_axis, client_mode, uplink,
                    san=None, own=False) -> CohortPartial:
    """``step(..., cohort=...)``: the client stage on one cohort, returning
    its ``CohortPartial``. The cohort's ``mu`` is the un-renormalized slice
    of the global weights, so the partials of a population's cohorts sum to
    the full weighted reduce (bit for bit for one full cohort, to
    re-association otherwise). ``san``: the ``Sanitizer`` the cohort's
    checks are queued into (read here when ``own``), with the comm-bytes
    audit."""
    if not isinstance(cohort, CohortSlice):
        raise TypeError(f"cohort= takes a CohortSlice, got "
                        f"{type(cohort).__name__}")
    topo = spec.topology
    if topo.is_two_tier and cohort.edge_ids is None:
        raise ValueError(
            "a two-tier topology needs CohortSlice.edge_ids — the cohort's "
            "slice of the population's stable client -> edge assignment "
            "(ClientPopulation.edge_ids)")
    mask = torch.as_tensor(cohort.mask).to(dev, torch.float32)
    if mask.ndim != 1:
        raise ValueError(f"CohortSlice.mask must be 1-D, got shape "
                         f"{tuple(mask.shape)}")
    c = mask.shape[0]
    for name in ("mu", "seeds", "valid", "corrupt", "edge_ids"):
        arr = getattr(cohort, name)
        if arr is not None and tuple(torch.as_tensor(arr).shape)[:1] != (c,):
            raise ValueError(
                f"CohortSlice.{name} has leading dim "
                f"{tuple(torch.as_tensor(arr).shape)[:1]} != cohort size {c}")
    _validate(spec, mesh, client_axis, client_mode, uplink, dev, n_stage=c)
    comp = spec.compressor
    use_wire = comp.encode is not None
    state = DriverState(*(_to(f, dev) for f in state))
    client_batches = _to(client_batches, dev)
    rows = local_rows(spec, mesh, client_axis, n=c)
    lead = tree_leaves(client_batches)[0].shape[0]
    if lead != rows[1] - rows[0]:
        raise ValueError(
            f"client_batches hold {lead} clients; this rank holds clients "
            f"{rows[0]}..{rows[1] - 1} of the cohort's {c}")
    n_leaves = len(tree_leaves(state.x))
    seeds = torch.as_tensor(cohort.seeds, dtype=torch.int64).reshape(
        c, n_leaves)
    mu = torch.as_tensor(cohort.mu, dtype=torch.float32).to(dev)
    corrupt = (None if cohort.corrupt is None
               else torch.as_tensor(cohort.corrupt, dtype=torch.bool))

    view = _broadcast_view(problem, spec, state)           # line 4
    if san is not None and spec.aggregation != "parameter":
        san.check_finite("T", view)
    (agg, v_i_new, cmetrics, wire_bytes_client, n_survive, collective_bytes,
     _) = _client_stage(
        problem, spec, view, state.x, client_batches, _to(cohort.v_i, dev),
        seeds, mask, mu, client_mode=client_mode, uplink=uplink, mesh=mesh,
        client_axis=client_axis, rows=rows, edge_ids=cohort.edge_ids,
        corrupt=corrupt, tier_finalize=False, san=san)
    if san is not None:
        san.check_finite("aggregate", agg)
    comm = comp.round_metrics(state.x, p=spec.participation)
    per_client = (wire_bytes_client if use_wire
                  else comm["payload_bytes_per_client"])
    if san is not None and use_wire:
        assert_comm_audit(comp, state.x, per_client,
                          where=f"step(cohort=..., client_mode="
                                f"{client_mode!r}, uplink={uplink!r})")
    if own:
        san.raise_if_tripped("the cohort's client stage")
    every_client = c == spec.n_clients and (
        cohort.valid is None or bool(torch.as_tensor(cohort.valid).all()))
    if cohort.valid is None:
        metric_sums = {k: torch.sum(v, dim=0) for k, v in cmetrics.items()}
    else:
        # padded slots repeat a real client's batch: their metrics do not
        # count toward the population's means
        valid = torch.as_tensor(cohort.valid).to(dev, torch.float32)
        metric_sums = {
            k: torch.sum(v * valid.reshape((c,) + (1,) * (v.ndim - 1))
                         .to(v.dtype), dim=0)
            for k, v in cmetrics.items()}
    return CohortPartial(
        # the clients that survived verification (sum(mask) without
        # checksums): a corrupt client is not counted...
        agg=agg, v_i=v_i_new, n_active=n_survive,
        # ...but billed, since it used the wire; the mask is 0.0 on padded
        # slots, so a ragged cohort bills its real active clients only.
        # float32(per_client) x count is exact in float64: the landing's one
        # cast gives step's float32 product, whatever the cohorting
        comm_bytes=(torch.tensor(per_client, dtype=torch.float32).double()
                    * torch.sum(mask).double()),
        metric_sums=metric_sums,
        collective_payload_bytes=collective_bytes,
        metric_means=({k: torch.mean(v, dim=0) for k, v in cmetrics.items()}
                      if every_client else None))


def apply_partial(problem, spec: FederationSpec, state: DriverState, agg,
                  n_active, gamma, *, drift_metric: bool = True,
                  device=None, sanitize=False):
    """Land an aggregate: the server half of a round. ``step`` lands its
    client stage's aggregate here; a scheduler lands the sum of its
    (possibly staleness-weighted) ``CohortPartial.agg`` terms.
    ``n_active``: the surviving clients' count (the 'realized'
    normalization divides by it). ``state.v_i`` passes through: cohort
    variates live in the scheduler's population arena. Returns
    ``(new_state, metrics)`` with the server-side metrics (``n_active``,
    ``omega_eff``, ``e_s``/``e_p``, ``h_norm_sq``, aux); the caller adds
    the byte counts and ``_merge_client_metrics``. ``sanitize``: the
    server stages' checks (the aggregate, the server step, ``project``,
    the server variate), as ``step``'s."""
    problem = as_problem(problem)
    dev = resolve_device(device)
    san = resolve_sanitizer(sanitize) if sanitize else None
    state = DriverState(*(_to(f, dev) for f in state))
    agg = _to(agg, dev)
    param_space = spec.aggregation == "parameter"
    n_active = torch.as_tensor(n_active, dtype=torch.float32)
    if san is not None:
        san.check_finite("aggregate", agg)
    new_state, h, aux_metrics = _server_apply(
        problem, spec, state, agg, state.v_i, n_active, gamma, san)
    comm = spec.compressor.round_metrics(state.x, p=spec.participation)
    metrics = {
        "n_active": n_active,
        "omega_eff": torch.tensor(comm["omega_eff"], dtype=torch.float32),
    }
    if drift_metric:
        drift = tree_sub(new_state.x, state.x)
        metrics["e_p" if param_space else "e_s"] = \
            tree_sq_norm(drift) / (gamma ** 2)
    if not param_space:
        metrics["h_norm_sq"] = tree_sq_norm_ew(h)
    metrics.update(aux_metrics)
    if san is not None and san is not sanitize:
        san.raise_if_tripped(lambda: f"round {int(state.step)}")
    return new_state, metrics


# ---------------------------------------------------------------------------
# run — a Python loop over step
# ---------------------------------------------------------------------------

def _as_generator(key) -> torch.Generator:
    if isinstance(key, torch.Generator):
        return key
    return torch.Generator().manual_seed(int(key))


@_under_key_audit
def run(problem, x0, data, schedule, *, spec: Optional[FederationSpec] = None,
        key=None, n_rounds: Optional[int] = None, eval_batch=None,
        eval_every: int = 1, track_mirror: bool = False, diag=None,
        v0_i=None, init_batches=None, state0: Optional[DriverState] = None,
        device=None, mesh=None, client_axis: str = "clients",
        client_mode: str = "vmap", uplink: str = "gather",
        sanitize: bool = False, audit_keys=False):
    """Drive ``n_rounds`` of the MM recursion; returns ``(final
    DriverState, metrics)`` with each metric stacked over rounds.

    data: centralized (``spec is None``): a list of batches or a pytree
    with a leading round axis; federated: a callable ``(t, generator) ->
    (n, ...) client batch pytree`` or a static ``(n, ...)`` pytree reused
    every round. ``key``: a ``torch.Generator`` or an int seed (for a CPU
    generator); every round's draws come from it in order.
    ``eval_batch``: records ``loss`` (every ``eval_every`` rounds and the
    last; NaN otherwise). ``track_mirror``/``diag``: the movement
    diagnostics of the reference.

    ``mesh``/``client_axis``/``uplink``: the mesh path of ``step``. The
    data still come as all n clients' batches and every rank takes its own
    rows; ``state0``, where given, holds the rank's rows of ``v_i`` (see
    ``interop.state_for_rank``), and an ``init`` made here is cut to them.
    ``collective_payload_bytes`` is stacked like every other metric.

    ``sanitize``/``audit_keys``: ``step``'s, every round (the key audit
    over the whole run, the data's draws included); federated runs only.
    A round whose checks trip raises at its end."""
    if sanitize and spec is None:
        raise ValueError("sanitize=True is the federated driver's runtime "
                         "sanitizer; the centralized path does not run it "
                         "— check centralized_step's outputs with "
                         "analysis.runtime.Sanitizer yourself")
    if audit_keys and spec is None:
        raise ValueError("audit_keys=True audits the federated driver's "
                         "generator chain; the centralized path draws "
                         "nothing — activate a keytrace.KeyAudit yourself "
                         "if your batch pipeline draws")
    problem = as_problem(problem)
    dev = resolve_device(device)
    if spec is None:
        return _run_centralized(problem, x0, data, schedule,
                                n_rounds=n_rounds, state0=state0, device=dev)
    _validate(spec, mesh, client_axis, client_mode, uplink, dev)
    if key is None:
        raise ValueError("federated run needs a key (generator or seed)")
    gen = _as_generator(key)
    if n_rounds is None:
        n_rounds = schedule_length(schedule)
        if n_rounds is None:
            raise ValueError("n_rounds required with a callable schedule")
    gammas = resolve_schedule(schedule, n_rounds)
    param_space = spec.aggregation == "parameter"
    track_mirror = track_mirror and not param_space
    if eval_batch is not None:
        eval_batch = _to(eval_batch, dev)
    lo, hi = local_rows(spec, mesh, client_axis)

    if state0 is None:
        state0 = init(problem, x0, spec, v0_i=v0_i,
                      init_batches=init_batches, device=dev)
        state0 = state0._replace(v_i=_rows(state0.v_i, lo, hi))
    diag_name, diag_fn = diag if diag is not None else (None, None)
    state = state0
    theta_prev = problem.T(state.x) if track_mirror else None
    diag_prev = diag_fn(state.x) if diag_fn is not None else None
    hist = []
    for t in range(n_rounds):
        gamma = gammas[t]
        batch = _rows(data(t, gen) if callable(data) else data, lo, hi)
        state, m = step(problem, spec, state, batch, gamma, gen, device=dev,
                        mesh=mesh, client_axis=client_axis,
                        client_mode=client_mode, uplink=uplink,
                        sanitize=sanitize)
        if t == 0:
            # torch.func's first vmap of a grad in a process leaves a
            # reference cycle holding that call's intermediates (client-
            # stack sized); free them now rather than at the next
            # collection
            gc.collect()
        if track_mirror:
            theta_new = problem.T(state.x)
            m["e_p_s"] = (tree_sq_norm(tree_sub(theta_new, theta_prev))
                          / gamma ** 2)
            theta_prev = theta_new
        if diag_fn is not None:
            diag_new = diag_fn(state.x)
            m[diag_name] = (tree_sq_norm(tree_sub(diag_new, diag_prev))
                            / gamma ** 2)
            diag_prev = diag_new
        if problem.loss is not None and eval_batch is not None:
            if "loss" in m:
                raise ValueError(
                    "metric key collision: the problem's s_bar_metrics "
                    "already reports a per-client 'loss' and the eval hook "
                    "would overwrite it — drop eval_batch or rename the "
                    "client metric")
            if (t + 1) % eval_every == 0 or t == n_rounds - 1:
                theta_eval = state.x if param_space else problem.T(state.x)
                m["loss"] = torch.as_tensor(
                    problem.loss(eval_batch, theta_eval)).to(torch.float32)
            else:
                m["loss"] = torch.tensor(float("nan"))
        hist.append(m)
    return state, _stack_metrics(hist)


def _run_centralized(problem: MMProblem, s0, data, schedule, *,
                     n_rounds=None, state0=None, device=None):
    if isinstance(data, (list, tuple)):
        batches = list(data)
        if n_rounds is None:
            n_rounds = len(batches)
        pick = batches.__getitem__
    else:
        if n_rounds is None:
            n_rounds = tree_leaves(data)[0].shape[0]
        pick = lambda t: _take(data, t)
    gammas = resolve_schedule(schedule, n_rounds)
    if state0 is None:
        state0 = centralized_init(problem, s0, device=device)
    state, hist = state0, []
    for t in range(n_rounds):
        batch = _to(pick(t), device)
        state, m = centralized_step(problem, state, batch, gammas[t])
        if problem.loss is not None:
            m = dict(m, loss=problem.loss(batch, problem.T(state.x)))
        hist.append(m)
    return state, _stack_metrics(hist)


def mean_oracle_diag(problem, diag_batches):
    """Tbar(theta) = (1/n) sum_i Sbar_i(theta) on fixed per-client batches:
    the cross-space E^{s,p} diagnostic for parameter-space aggregation."""
    problem = as_problem(problem)

    def tbar(theta):
        stacked = torch.func.vmap(
            lambda b: problem.s_bar(b, theta))(diag_batches)
        return tree_map(lambda x: torch.mean(x, dim=0), stacked)

    return tbar


# ---------------------------------------------------------------------------
# metric views
# ---------------------------------------------------------------------------

def _stack_metrics(hist):
    if not hist:
        return {}
    return {k: torch.stack([torch.as_tensor(m[k]).detach().to("cpu",
                                                               torch.float32)
                            for m in hist])
            for k in hist[0]}


def history_list(hist) -> list:
    """Stacked metrics -> a list of per-round float dicts."""
    if not hist:
        return []
    n = len(next(iter(hist.values())))
    return [{k: float(v[t]) for k, v in hist.items()} for t in range(n)]
