"""The port's runtime checks behind ``api.run/step(..., sanitize=True)``
(``repro_torch.analysis.runtime``), the counterpart of
``tests/test_sanitizer.py``.

Pinned here, as there:
  * bit-identity: ``sanitize=True`` returns the same trajectory (state
    and every stacked metric) as ``sanitize=False``, in ``run`` (both
    client modes), in an eager ``step`` and on a one-rank gloo mesh
    (gather and reduce);
  * the ``eval_every`` cadence's NaN fill is not flagged;
  * an injected 0/0 in the client oracle is flagged, naming the round,
    the stage and the leaf, in ``run`` and in an eager ``step``; without
    the flag the quantizer launders it and the state stays finite, and
    that laundered state is the reference's (its draws handed over);
  * the comm-bytes audit: a lying ``payload_fn`` raises with the flag
    and passes silently without it; the honest model passes in the
    ``"scan"`` client mode;
  * centralized runs reject ``sanitize=True``.

Two reference tests have no case here: ``test_collapse_failure_degrades_
to_upstream_rule`` (a patch of checkify's shard_map rule, which PyTorch
does not have) and ``test_mesh_run_bit_identical_under_sanitize`` (the
reference's own mesh run fails on this tree, ROADMAP Queue C item 2): the
port's one-rank gloo mesh run, flag on against off, stands in its place.
Beyond the reference: ``apply_partial(sanitize=True)``, the index check,
a round with no active client (its clamped divisor) passing, and the stage
named first when several trip.
"""
import dataclasses
import datetime
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
from repro_torch import api
from repro_torch.analysis.runtime import SanitizerError, finite_flag
from repro_torch.core import compression as C
from repro_torch.core.quadratic import quadratic_for_objective

from _torch_parity import assert_tree_close, round_draws, to_torch

KEY = jax.random.PRNGKey(0)


def _quad_problem(n_clients=4, het=3.0, dim=6, seed=0):
    """``tests/test_sanitizer.py:_quad_problem``'s shape of problem, its
    data from a numpy seed: (batches, the reference's surrogate, the
    port's)."""
    rng = np.random.default_rng(seed)
    Xs = rng.standard_normal((n_clients, 32, dim)).astype(np.float32)
    w_i = np.stack([np.linspace(-1, 1, dim) + het * i
                    for i in range(n_clients)]).astype(np.float32)
    ys = np.einsum("nbp,np->nb", Xs, w_i).astype(np.float32)

    def jloss(batch, theta):
        xb, yb = batch
        return 0.5 * jnp.mean((xb @ theta - yb) ** 2)

    def tloss(batch, theta):
        xb, yb = batch
        return 0.5 * torch.mean((xb @ theta - yb) ** 2)

    return ((Xs, ys), jquad(jloss, rho=0.05),
            quadratic_for_objective(tloss, rho=0.05))


def _data(Xs, ys):
    batch = (torch.from_numpy(Xs), torch.from_numpy(ys))
    return lambda t, g: batch


def _spec(**kw):
    kw.setdefault("compressor", C.block_quant(4, 64))
    return api.FederationSpec(n_clients=4, participation=0.5, alpha=0.1,
                              **kw)


def _bits(a, b, msg=""):
    for x, y in zip(torch.utils._pytree.tree_leaves(a),
                    torch.utils._pytree.tree_leaves(b)):
        assert torch.equal(x, y), msg


def _eval(Xs, ys):
    return (torch.from_numpy(Xs.reshape(-1, Xs.shape[-1])),
            torch.from_numpy(ys.reshape(-1)))


def _poisoned(sur):
    """0/0 inside the client oracle -> NaN in round 0."""
    return dataclasses.replace(
        sur, s_bar=lambda b, th: sur.s_bar(b, th) + (th - th) / (th - th))


# ---------------------------------------------------------------------------
# bit-identity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("client_mode", ["vmap", "scan"])
def test_run_bit_identical_under_sanitize(client_mode):
    (Xs, ys), _, sur = _quad_problem()
    problem = api.as_problem(sur)
    kwargs = dict(spec=_spec(), key=0, n_rounds=8, device="cpu",
                  client_mode=client_mode, eval_batch=_eval(Xs, ys))
    st0, h0 = api.run(problem, torch.zeros(6), _data(Xs, ys), 0.3, **kwargs)
    st1, h1 = api.run(problem, torch.zeros(6), _data(Xs, ys), 0.3,
                      sanitize=True, **kwargs)
    _bits(st0.x, st1.x)
    _bits(st0.v_i, st1.v_i)
    assert set(h0) == set(h1)
    for k in h0:
        assert torch.equal(h0[k], h1[k]), k


def test_step_bit_identical_under_sanitize():
    (Xs, ys), _, sur = _quad_problem()
    problem = api.as_problem(sur)
    spec = _spec(normalization="realized")
    state0 = api.init(problem, torch.zeros(6), spec, device="cpu")
    batch = _data(Xs, ys)(0, None)
    s0, m0 = api.step(problem, spec, state0, batch, 0.3,
                      torch.Generator().manual_seed(7), device="cpu")
    s1, m1 = api.step(problem, spec, state0, batch, 0.3,
                      torch.Generator().manual_seed(7), device="cpu",
                      sanitize=True)
    _bits(tuple(s0), tuple(s1))
    for key in m0:
        assert torch.equal(m0[key], m1[key]), key


def test_apply_partial_bit_identical_under_sanitize():
    (Xs, ys), _, sur = _quad_problem()
    problem = api.as_problem(sur)
    spec = _spec(normalization="realized")
    state0 = api.init(problem, torch.zeros(6), spec, device="cpu")
    agg = torch.linspace(-1.0, 1.0, 6)
    outs = [api.apply_partial(problem, spec, state0, agg, 2.0, 0.3,
                              device="cpu", sanitize=s) for s in (False, True)]
    _bits(tuple(outs[0][0]), tuple(outs[1][0]))
    with pytest.raises(SanitizerError, match="stage 'aggregate'"):
        api.apply_partial(problem, spec, state0, agg / 0.0, 2.0, 0.3,
                          device="cpu", sanitize=True)


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


@pytest.mark.parametrize("uplink", ["gather", "reduce"])
def test_mesh_run_bit_identical_under_sanitize(one_rank, uplink):
    """The port's own mesh path on one gloo rank: flag on against off
    (the reference's mesh case, which fails in the reference itself)."""
    (Xs, ys), _, sur = _quad_problem(n_clients=8, dim=64)
    problem = api.as_problem(sur)
    spec = api.FederationSpec(n_clients=8, participation=1.0, alpha=0.1,
                              compressor=C.block_quant(4, 64))
    mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("clients",))
    kwargs = dict(spec=spec, key=0, n_rounds=4, mesh=mesh, uplink=uplink,
                  device="cpu")
    st0, h0 = api.run(problem, torch.zeros(64), _data(Xs, ys), 0.3, **kwargs)
    st1, h1 = api.run(problem, torch.zeros(64), _data(Xs, ys), 0.3,
                      sanitize=True, **kwargs)
    _bits(tuple(st0), tuple(st1))
    for k in h0:
        assert torch.equal(h0[k], h1[k]), k
    with pytest.raises(SanitizerError, match="round 0, stage 'oracle'"):
        api.run(api.as_problem(_poisoned(sur)), torch.zeros(64),
                _data(Xs, ys), 0.3, sanitize=True, **kwargs)


def test_eval_every_nan_cadence_not_flagged():
    (Xs, ys), _, sur = _quad_problem()
    problem = api.as_problem(sur)
    st, hist = api.run(problem, torch.zeros(6), _data(Xs, ys), 0.3,
                       spec=_spec(), key=0, n_rounds=6, eval_every=3,
                       eval_batch=_eval(Xs, ys), device="cpu", sanitize=True)
    loss = hist["loss"].numpy()
    assert np.isnan(loss[0]) and np.isfinite(loss[2])


# ---------------------------------------------------------------------------
# real poison is caught
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("client_mode", ["vmap", "scan"])
def test_injected_nan_is_flagged(client_mode):
    (Xs, ys), _, sur = _quad_problem()
    problem = api.as_problem(_poisoned(sur))
    kwargs = dict(spec=_spec(), key=0, n_rounds=3, device="cpu",
                  client_mode=client_mode)
    # without the sanitizer the poison is laundered: the quantizer's
    # scale > 0 guard is false for NaN, the NaN update becomes all-zero
    # codes and the state stays finite
    st, _ = api.run(problem, torch.zeros(6), _data(Xs, ys), 0.3, **kwargs)
    assert torch.isfinite(st.x).all()
    with pytest.raises(SanitizerError,
                       match="nan .* at round 0, stage 'oracle'"):
        api.run(problem, torch.zeros(6), _data(Xs, ys), 0.3, sanitize=True,
                **kwargs)


def test_injected_nan_is_flagged_in_eager_step():
    (Xs, ys), _, sur = _quad_problem()
    problem = api.as_problem(_poisoned(sur))
    spec = _spec()
    state0 = api.init(problem, torch.zeros(6), spec, device="cpu")
    with pytest.raises(SanitizerError, match="round 0, stage 'oracle'"):
        api.step(problem, spec, state0, _data(Xs, ys)(0, None), 0.3,
                 torch.Generator().manual_seed(0), device="cpu",
                 sanitize=True)


@pytest.mark.parametrize("where", ["oracle", "one client's data"])
def test_laundered_state_matches_reference(where):
    """Without the flag the port launders the poison as the reference
    does: with the reference's participation masks and dither seeds
    handed over (the hash dither), the states agree after 3 rounds."""
    (Xs, ys), jsur, tsur = _quad_problem()
    if where == "oracle":
        clean = jsur.s_bar
        jsur = dataclasses.replace(jsur, s_bar=lambda b, th: jax.tree.map(
            lambda x: x + (x - x) / (x - x), clean(b, th)))
        tsur = _poisoned(tsur)
    else:
        Xs = Xs.copy()
        Xs[1, 0, 0] = np.nan
    jp, tp = japi.as_problem(jsur), api.as_problem(tsur)
    jspec = japi.FederationSpec(n_clients=4, participation=0.5, alpha=0.1,
                                compressor=JC.block_quant(4, 64, "hash"))
    tspec = _spec(compressor=C.block_quant(4, 64, "hash"))
    jstate = japi.init(jp, jnp.zeros(6), jspec)
    tstate = api.init(tp, torch.zeros(6), tspec, device="cpu")
    jb, tb = (jnp.asarray(Xs), jnp.asarray(ys)), _data(Xs, ys)(0, None)
    key = KEY
    for _ in range(3):
        key, k_round, _, active, seeds = round_draws(key, jspec, 1)
        jstate, _ = japi.step(jp, jspec, jstate, jb, 0.3, k_round)
        tstate, _ = api.step(tp, tspec, tstate, tb, 0.3, None,
                             active=active, seeds=seeds, device="cpu")
    assert torch.isfinite(tstate.x).all()
    assert_tree_close(to_torch(jstate.x), tstate.x)
    assert_tree_close(to_torch(jstate.v_i), tstate.v_i)


def test_index_and_divisor_checks():
    """A cohort's edge ids out of range are flagged before the gather; a
    round with no active client divides by the clamped count (one) and
    passes."""
    (Xs, ys), _, sur = _quad_problem()
    problem = api.as_problem(sur)
    two = _spec(topology=api.Topology.two_tier(2))
    state0 = api.init(problem, torch.zeros(6), two, device="cpu")
    cohort = api.CohortSlice(
        mask=torch.ones(4), mu=torch.full((4,), 0.25),
        seeds=torch.arange(4).reshape(4, 1), v_i=state0.v_i,
        edge_ids=torch.tensor([0, 1, 2, 0]))
    with pytest.raises(SanitizerError, match="index out of range.*edge_ids"):
        api.step(problem, two, state0, _data(Xs, ys)(0, None), 0.3, None,
                 cohort=cohort, device="cpu", sanitize=True)
    spec = _spec(normalization="realized")
    state0 = api.init(problem, torch.zeros(6), spec, device="cpu")
    none = torch.zeros(4, dtype=torch.bool)
    outs = [api.step(problem, spec, state0, _data(Xs, ys)(0, None), 0.3,
                     torch.Generator().manual_seed(0), active=none,
                     device="cpu", sanitize=s) for s in (False, True)]
    _bits(tuple(outs[0][0]), tuple(outs[1][0]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_finite_flag_is_isfinite_all(dtype):
    """The stage checks' one-pass flag against ``isfinite().all()``: NaN,
    both infinities, the largest finite values of either sign (whose
    difference or sum would overflow), empty tensors, per row and under
    ``vmap``."""
    big = torch.finfo(dtype).max
    for v in (0.0, float("nan"), float("inf"), -float("inf"), big, -big):
        x = torch.ones(3, 5, dtype=dtype)
        x[1, 2] = v
        x[0, 0] = -big
        want = torch.isfinite(x).all()
        assert torch.equal(finite_flag(x), want), v
        assert torch.equal(finite_flag(x, rows=True),
                           torch.isfinite(x).all(dim=1)), v
        assert torch.equal(torch.func.vmap(finite_flag)(x),
                           torch.isfinite(x).all(dim=1)), v
    for shape in ((0,), (2, 0)):
        e = torch.empty(shape, dtype=dtype)
        assert bool(finite_flag(e))
        assert torch.equal(finite_flag(e, rows=True),
                           torch.ones(shape[0], dtype=torch.bool))


# ---------------------------------------------------------------------------
# the comm-bytes audit
# ---------------------------------------------------------------------------

def test_comm_audit_catches_lying_payload_model():
    (Xs, ys), _, sur = _quad_problem()
    problem = api.as_problem(sur)
    lying = dataclasses.replace(C.block_quant(4, 64),
                                payload_fn=lambda shape, itemsize: 1.0)
    kwargs = dict(spec=_spec(compressor=lying), key=0, n_rounds=2,
                  device="cpu")
    # off: permissive (the metric lies, nothing raises)
    api.run(problem, torch.zeros(6), _data(Xs, ys), 0.3, **kwargs)
    with pytest.raises(ValueError, match="comm-bytes audit failed"):
        api.run(problem, torch.zeros(6), _data(Xs, ys), 0.3, sanitize=True,
                **kwargs)


def test_honest_model_passes_audit_on_scan_client_mode():
    (Xs, ys), _, sur = _quad_problem()
    st, _ = api.run(api.as_problem(sur), torch.zeros(6), _data(Xs, ys), 0.3,
                    spec=_spec(), key=0, n_rounds=2, client_mode="scan",
                    device="cpu", sanitize=True)
    assert torch.isfinite(st.x).all()


def test_centralized_rejects_sanitize():
    (Xs, ys), _, sur = _quad_problem()
    batch = (torch.from_numpy(Xs[0]), torch.from_numpy(ys[0]))
    with pytest.raises(ValueError, match="sanitize=True"):
        api.run(api.as_problem(sur), torch.zeros(6), [batch] * 3, 0.3,
                device="cpu", sanitize=True)
