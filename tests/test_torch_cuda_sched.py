"""The port's cohort scheduler on the card, at a reduced size: the
iterate's ``w`` (16 x 4096, 65,536 elements, group 256) takes the
quantizer kernels' route, so ``qb_encode`` launches inside every cohort's
``step(cohort=...)``, and ``qb_decode_reduce`` inside every cohort of a
reduce uplink. Every test is marked ``cuda`` and skips without a CUDA
device; the module imports no JAX:

    python -m pytest -q -m cuda tests/test_torch_cuda_sched.py
"""
import datetime
import socket

import pytest
import torch

from repro_torch import api
from repro_torch.core import compression as C
from repro_torch.core.quadratic import quadratic_for_objective
from repro_torch.faults import FaultSpec, ServerKilled
from repro_torch.kernels import quantize_block as qb
from repro_torch.sched import CohortScheduler

pytestmark = pytest.mark.cuda

N, D_IN, D_OUT, ROUNDS = 8, 16, 4096, 3
COMP_KW = dict(bits=8, block=256, dither="kernel")


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    torch.cuda.set_device(0)


def _problem():
    def loss(batch, theta):
        r = batch[0] @ theta["w"] + theta["b"] - batch[1]
        return 0.5 * torch.mean(torch.sum(r * r, dim=-1))

    gen = torch.Generator(device="cuda").manual_seed(0)
    X = torch.randn((N, 16, D_IN), generator=gen, device="cuda")
    W = torch.randn((D_IN, D_OUT), generator=gen, device="cuda") / 4
    Y = X @ W + torch.randn((N, 1, D_OUT), generator=gen, device="cuda")
    x0 = {"w": torch.zeros((D_IN, D_OUT), device="cuda"),
          "b": torch.zeros((D_OUT,), device="cuda")}
    return (api.as_problem(quadratic_for_objective(loss, rho=0.05)),
            (X, Y), x0)


def _data(batches):
    """Noisy targets drawn from the chain generator (a CUDA one, or the CPU
    generator of an int seed)."""
    def data(t, gen):
        noise = torch.randn(batches[1].shape, generator=gen,
                            device=gen.device).to("cuda")
        return (batches[0], batches[1] + 0.01 * noise)

    def data_fn(t, gen, ids):
        ids = torch.as_tensor(ids, device="cuda")
        return tuple(x[ids] for x in data(t, gen))
    return data, data_fn


def _spec(**kw):
    return api.FederationSpec(n_clients=N, participation=0.6,
                              compressor=C.block_quant(**COMP_KW), **kw)


def test_single_cohort_bit_identical_to_run_with_a_cuda_generator(card):
    problem, batches, x0 = _problem()
    data, data_fn = _data(batches)
    spec = _spec(alpha=0.1)
    st_r, m_r = api.run(problem, x0, data, 0.3, spec=spec,
                        key=torch.Generator(device="cuda").manual_seed(3),
                        n_rounds=ROUNDS)
    qb.reset_launches()
    sched = CohortScheduler(problem, spec, cohort_size=N)
    st, pop, m = sched.run(x0, data_fn, 0.3,
                           key=torch.Generator(device="cuda").manual_seed(3),
                           n_rounds=ROUNDS)
    # every client of every cohort encodes w on the kernel
    assert qb.LAUNCHES["encode_seeded"] == ROUNDS * N
    for k in ("w", "b"):
        assert torch.equal(st_r.x[k], st.x[k]), k
        assert torch.equal(st_r.v[k], st.v[k]), k
        assert torch.equal(st_r.v_i[k].cpu(), pop.variates()[k]), k
        # the scheduler's own population page-locks the arena on a GPU
        assert pop.variates()[k].is_pinned(), k
    for k in m_r:
        assert torch.equal(m_r[k], m[k]), k
    # cohorts of 3: the accounting exact, the state close
    _, _, m3 = CohortScheduler(problem, spec, cohort_size=3).run(
        x0, data_fn, 0.3, key=torch.Generator(device="cuda").manual_seed(3),
        n_rounds=ROUNDS)
    for k in ("n_active", "comm_bytes"):
        assert torch.equal(m_r[k], m3[k]), k


def test_client_metric_through_one_full_cohort_bit_for_bit(card):
    """A problem's per-client metric (``s_bar_metrics``) over n = 12
    clients, not a power of two, in one cohort of all 12: the scheduler
    lands ``step``'s own ``torch.mean`` (on CUDA a mean multiplies by
    1 / n, where a sum over n divides), so every metric of every round is
    ``api.run``'s bit for bit."""
    n, dim = 12, 32
    gen = torch.Generator(device="cuda").manual_seed(5)
    X = torch.randn((n, 16, dim), generator=gen, device="cuda")
    w = (torch.linspace(-1, 1, dim, device="cuda")
         + 2.0 * torch.arange(n, device="cuda")[:, None])
    Y = torch.einsum("nbp,np->nb", X, w)

    def loss(batch, theta):
        return 0.5 * torch.mean((batch[0] @ theta - batch[1]) ** 2)

    base = api.as_problem(quadratic_for_objective(loss, rho=0.05))

    def s_bar_metrics(batch, view):
        s_i = base.s_bar(batch, view)
        return s_i, {"s_sum": torch.sum(s_i)}

    problem = api.as_problem(base, s_bar_metrics=s_bar_metrics)
    spec = api.FederationSpec(n_clients=n, participation=0.75, alpha=0.1)
    x0 = torch.zeros(dim, device="cuda")
    _, m_ref = api.run(problem, x0, lambda t, g: (X, Y), 0.3, spec=spec,
                       key=3, n_rounds=ROUNDS)
    _, _, m = CohortScheduler(problem, spec, cohort_size=n).run(
        x0, lambda t, g, ids: (X[torch.as_tensor(ids, device="cuda")],
                               Y[torch.as_tensor(ids, device="cuda")]),
        0.3, key=3, n_rounds=ROUNDS)
    assert m["s_sum"].shape == (ROUNDS,)
    for k in m_ref:
        assert torch.equal(m_ref[k], m[k]), k


def test_async_kill_and_resume_on_the_card(card, tmp_path):
    problem, batches, x0 = _problem()
    _, data_fn = _data(batches)
    faults = dict(dropout=0.2, corrupt=0.3, corrupt_kind="scales",
                  cohort_fail=0.3)
    comp = C.block_quant(**COMP_KW, checksum=True)

    def spec(**extra):
        return api.FederationSpec(
            n_clients=N, participation=0.9, alpha=0.1, compressor=comp,
            faults=FaultSpec(**faults, **extra), max_staleness=2,
            staleness_weight=lambda t: 1.0 / (1.0 + t))

    kw = dict(n_rounds=4, mode="async", max_inflight=4, buffer_cohorts=2)
    st_ref, pop_ref, m_ref = CohortScheduler(problem, spec(),
                                             cohort_size=4).run(
        x0, data_fn, 0.3, key=7, **kw)
    sched = CohortScheduler(problem, spec(kill_round=2), cohort_size=4)
    ck = str(tmp_path / "ck")
    with pytest.raises(ServerKilled):
        sched.run(x0, data_fn, 0.3, key=7, checkpoint_dir=ck, **kw)
    st, pop, m = sched.resume(x0, data_fn, 0.3, checkpoint_dir=ck, **kw)
    for k in ("w", "b"):
        assert torch.equal(st_ref.x[k], st.x[k]), k
        assert torch.equal(pop_ref.variates()[k], pop.variates()[k]), k
        assert bool(torch.isfinite(st.x[k]).all())
    for k in m_ref:
        assert torch.equal(m_ref[k], m[k]), k


def test_reduce_uplink_cohorts_launch_the_fused_reduce(card):
    """On a one-rank NCCL mesh with variates off, one qb_decode_reduce a
    cohort a round; the run within rtol 1e-5 / atol 1e-6 of the gather
    scheduler off the mesh."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("clients",))
        problem, batches, x0 = _problem()
        _, data_fn = _data(batches)
        spec = _spec(variates="off")
        st_g, _, m_g = CohortScheduler(problem, spec, cohort_size=4).run(
            x0, data_fn, 0.3, key=1, n_rounds=ROUNDS)
        qb.reset_launches()
        st_r, _, m_r = CohortScheduler(problem, spec, cohort_size=4,
                                       mesh=mesh, uplink="reduce").run(
            x0, data_fn, 0.3, key=1, n_rounds=ROUNDS)
        assert qb.LAUNCHES["decode_reduce"] == ROUNDS * 2
        for k in ("w", "b"):
            assert torch.allclose(st_r.x[k], st_g.x[k], rtol=1e-5,
                                  atol=1e-6), k
        assert torch.equal(m_r["n_active"], m_g["n_active"])
    finally:
        dist.destroy_process_group()
