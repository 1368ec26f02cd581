"""The port's mesh path on the card, at a reduced size: a one-rank process
group in this process (NCCL for CUDA tensors, gloo for the CPU mesh of
the last test), the quantizer kernels on the kernel route of the w leaf.
Every test is marked ``cuda`` and skips without a CUDA device; the module
imports no JAX:

    python -m pytest -q -m cuda tests/test_torch_cuda_mesh.py
"""
import datetime
import socket

import pytest
import torch

from repro_torch import api
from repro_torch.core import compression as C
from repro_torch.core.quadratic import quadratic_for_objective
from repro_torch.kernels import quantize_block as qb
from repro_torch.launch.mesh import make_edge_mesh

pytestmark = pytest.mark.cuda

N, D_IN, D_OUT, ROUNDS = 8, 8, 1024, 3
# w (8192 elements) takes the kernel route, b (1024) the plain one
COMP_KW = dict(bits=8, block=256, dither="kernel", kernel_threshold=4096)


@pytest.fixture(scope="module")
def pg():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    import torch.distributed as dist
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("cpu:gloo,cuda:nccl",
                            init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    yield
    dist.destroy_process_group()


def _mesh(device="cuda"):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device, (1,), mesh_dim_names=("clients",))


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
    return api.as_problem(quadratic_for_objective(loss, rho=0.02)), (X, Y), x0


def _spec(variates="zero", **topo):
    extra = {"topology": api.Topology.two_tier(**topo)} if topo else {}
    return api.FederationSpec(
        n_clients=N, participation=0.5, alpha=0.0 if variates == "off"
        else 0.1, variates=variates, compressor=C.block_quant(**COMP_KW),
        **extra)


def test_nccl_gather_bit_identical_to_one_device(pg):
    problem, data, x0 = _problem()
    spec = _spec()
    a, ha = api.run(problem, x0, data, 0.3, spec=spec, key=5,
                    n_rounds=ROUNDS)
    b, hb = api.run(problem, x0, data, 0.3, spec=spec, key=5,
                    n_rounds=ROUNDS, mesh=_mesh())
    for k in x0:
        assert torch.equal(a.x[k], b.x[k]) and torch.equal(a.v_i[k],
                                                           b.v_i[k])
    for k in ha:
        assert torch.equal(ha[k], hb[k]), k
    per_client = spec.compressor.payload_bytes(x0)
    assert torch.equal(hb["collective_payload_bytes"],
                       torch.full((ROUNDS,), float(N * per_client)))


def test_nccl_reduce_launches_decode_reduce(pg):
    """variates off: the reduce uplink runs the fused decode + reduce
    kernel once per round for w, and one round of it from a gather
    round's state agrees with that round to rtol 1e-5 / atol 1e-6."""
    problem, data, x0 = _problem()
    spec = _spec("off")
    mesh = _mesh()
    qb.reset_launches()
    api.run(problem, x0, data, 0.3, spec=spec, key=5, n_rounds=ROUNDS,
            mesh=mesh, uplink="reduce")
    assert qb.LAUNCHES["decode_reduce"] == ROUNDS
    state = api.init(problem, x0, spec)
    outs = [api.step(problem, spec, state, data, 0.3,
                     torch.Generator().manual_seed(2), mesh=mesh,
                     uplink=uplink) for uplink in ("gather", "reduce")]
    for k in x0:
        torch.testing.assert_close(outs[1][0].x[k], outs[0][0].x[k],
                                   rtol=1e-5, atol=1e-6)
    assert float(outs[1][1]["collective_payload_bytes"]) == \
        (D_IN * D_OUT + D_OUT) * 4


def test_two_tier_reencode_launches_encode_per_edge(pg):
    """Off the mesh and on the 1 x 1 edge mesh, each re-encoded edge
    partial is one encode launch (w's; b stays plain) beside the
    clients'."""
    problem, data, x0 = _problem()
    for edges, kw in ((2, {}), (1, dict(mesh=make_edge_mesh(1, 1),
                                        client_axis="client",
                                        uplink="reduce"))):
        spec = _spec(n_edges=edges, reencode=True)
        state = api.init(problem, x0, spec)
        qb.reset_launches()
        _, m = api.step(problem, spec, state, data, 0.3,
                        torch.Generator().manual_seed(2), **kw)
        assert qb.LAUNCHES["encode_seeded"] == N + edges
        assert float(m["backbone_bytes"]) == edges * float(
            C._tree_bytes(spec.compressor.encode([0, 0], x0)))


def test_cuda_round_with_cpu_mesh_raises(pg):
    problem, data, x0 = _problem()
    spec = _spec()
    state = api.init(problem, x0, spec)
    with pytest.raises(ValueError, match="mesh lives on 'cpu'"):
        api.step(problem, spec, state, data, 0.3,
                 torch.Generator().manual_seed(2), mesh=_mesh("cpu"))
