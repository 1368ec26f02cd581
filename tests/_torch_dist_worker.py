"""One rank of the port's multi-rank CPU tests (gloo), run as

    python tests/_torch_dist_worker.py JOB RANK WORLD PORT DIR

``tests/test_torch_mesh.py`` starts WORLD of these with one free PORT.
Each reads ``DIR/inputs.npz`` (the client data), brings up
``torch.distributed`` over gloo on ``tcp://localhost:PORT`` with a
60-second timeout, runs JOB's cases through ``repro_torch.api.run`` on a
CPU ``DeviceMesh`` (and the compressor on partitioned ``DTensor`` leaves),
and writes what it holds to ``DIR/out_<RANK>.npz``; the parent compares
with the single-process port. Imports no JAX. ``problem()`` and
``CASES`` are shared with the parent.
"""
import datetime
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import api  # noqa: E402
from repro_torch.core import compression as C  # noqa: E402
from repro_torch.core.quadratic import quadratic_for_objective  # noqa: E402

N_CLIENTS, D_IN, D_OUT, ROUNDS = 8, 8, 128, 3
# w (8, 128) reaches the quantizer's kernel route (its plain version on
# the CPU) and the fused decode + reduce; b (128,) stays plain
COMP_KW = dict(bits=8, block=128, dither="hash", kernel_threshold=1024)


def make_inputs(seed: int = 1) -> dict:
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N_CLIENTS, 16, D_IN)).astype(np.float32)
    W = rng.standard_normal((D_IN, D_OUT)).astype(np.float32) / 4
    Y = (X @ W + rng.standard_normal((N_CLIENTS, 1, D_OUT))).astype(
        np.float32)
    return {"X": X, "Y": Y}


def _loss(batch, theta):
    r = batch[0] @ theta["w"] + theta["b"] - batch[1]
    return 0.5 * torch.mean(torch.sum(r * r, dim=-1))


def problem():
    return api.as_problem(quadratic_for_objective(_loss, rho=0.02))


def x0():
    return {"w": torch.zeros((D_IN, D_OUT)), "b": torch.zeros((D_OUT,))}


def spec(variates="zero", checksum=False, topology=None):
    alpha = 0.0 if variates == "off" else 0.1
    kw = {} if topology is None else {"topology": topology}
    return api.FederationSpec(
        n_clients=N_CLIENTS, participation=0.5, alpha=alpha,
        variates=variates,
        compressor=C.block_quant(**COMP_KW, checksum=checksum), **kw)


def topology(case: dict):
    if "edges" not in case:
        return None
    return api.Topology.two_tier(case["edges"], reencode=case["reencode"])


# each case: uplink, variates, checksum, the two-tier edges and reencode
# (run on a 2 x (world / 2) edge mesh), and the one world size it runs at
# where it does not run at both
CASES = {
    "gather_zero": dict(uplink="gather", variates="zero"),
    "gather_off": dict(uplink="gather", variates="off"),
    "reduce_zero_ck": dict(uplink="reduce", variates="zero", checksum=True),
    "reduce_off": dict(uplink="reduce", variates="off"),
    "edge_gather_raw": dict(uplink="gather", variates="zero", edges=2,
                            reencode=False, world=4),
    "edge_gather_re": dict(uplink="gather", variates="zero", edges=2,
                           reencode=True, world=4, checksum=True),
    "edge_reduce_raw": dict(uplink="reduce", variates="zero", edges=2,
                            reencode=False, world=4, checksum=True),
    "edge_reduce_re": dict(uplink="reduce", variates="off", edges=2,
                           reencode=True, world=4),
}


def cases_for(world: int) -> dict:
    return {k: c for k, c in CASES.items() if c.get("world", world) == world}


def run_case(case: dict, data, mesh=None, client_axis="clients"):
    """The case's ROUNDS through ``api.run`` (on ``mesh`` when given)."""
    return api.run(problem(), x0(), data, 0.3,
                   spec=spec(case["variates"], case.get("checksum", False),
                             topology(case)),
                   key=7, n_rounds=ROUNDS, device="cpu", mesh=mesh,
                   client_axis=client_axis,
                   uplink=case["uplink"] if mesh is not None else "gather")


def _flat(prefix: str, tree, out: dict) -> None:
    for k, v in (tree.items() if isinstance(tree, dict) else ()):
        out[f"{prefix}/{k}"] = v.detach().numpy()


def _dtensor_checks(mesh, out: dict) -> None:
    """apply and encode of partitioned leaves against the unsharded
    leaf's, and dither='kernel' degrading to the hash on them."""
    from torch.distributed.tensor import Shard, distribute_tensor
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((8, 4096), generator=gen) * 2.0
    kw = dict(bits=8, block=128, shard_safe=True, kernel_threshold=1)
    for name, placement in (("shard0", Shard(0)), ("shard1", Shard(1))):
        xs = distribute_tensor(x, mesh, [placement], src_data_rank=None)
        out[f"dt/{name}/route"] = np.array(C._kernel_route(xs, 128, 1))
        for dither in ("hash", "kernel"):
            a = C.quantize_leaf(11, xs, dither=dither, **kw)
            p = C.encode_leaf(11, xs, dither=dither, checksum=True, **kw)
            out[f"dt/{name}/{dither}/apply"] = a.full_tensor().numpy()
            out[f"dt/{name}/{dither}/codes"] = p.codes.full_tensor().numpy()
            out[f"dt/{name}/{dither}/scales"] = \
                p.scales.full_tensor().numpy()
            out[f"dt/{name}/{dither}/check"] = p.check.numpy()
            out[f"dt/{name}/{dither}/decoded"] = \
                C.decode_leaf(p).full_tensor().numpy()
            out[f"dt/{name}/{dither}/placed"] = np.array(
                [a.placements == (placement,),
                 p.codes.placements == (placement,)])


def _error(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return f"ValueError: {e}"
    return "no error"


def _error_checks(mesh, data, out: dict) -> None:
    """What a mesh refuses: 6 clients over 4 ranks, and batches that are
    not the rank's rows."""
    six = api.FederationSpec(n_clients=6)
    st6 = api.init(problem(), x0(), six, device="cpu")
    out["errors/divide"] = np.array(_error(lambda: api.step(
        problem(), six, st6, (data[0][:6], data[1][:6]), 0.3,
        torch.Generator().manual_seed(0), mesh=mesh, device="cpu")))
    st = api.init(problem(), x0(), spec(), device="cpu")
    out["errors/rows"] = np.array(_error(lambda: api.step(
        problem(), spec(), st, data, 0.3, torch.Generator().manual_seed(0),
        mesh=mesh, device="cpu")))


def main(argv) -> int:
    job, rank, world, port, io_dir = argv[1], int(argv[2]), int(argv[3]), \
        int(argv[4]), Path(argv[5])
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch.mesh import cohort_capacity, make_edge_mesh

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        inp = np.load(io_dir / "inputs.npz")
        data = (torch.tensor(inp["X"]), torch.tensor(inp["Y"]))
        out = {}
        t0 = time.perf_counter()
        mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("clients",))
        emesh = make_edge_mesh(2, world // 2, device="cpu")
        out["edge_coordinate"] = np.array(emesh.get_coordinate())
        out["edge_capacity"] = np.array(cohort_capacity(emesh,
                                                        ("edge", "client")))
        for name, case in cases_for(world).items():
            on_edge = "edges" in case
            m, axis = (emesh, "client") if on_edge else (mesh, "clients")
            out[f"{name}/rows"] = np.array(api.local_rows(
                spec(topology=topology(case)), m, axis))
            state, hist = run_case(case, data, m, axis)
            _flat(f"{name}/x", state.x, out)
            _flat(f"{name}/v", state.v, out)
            _flat(f"{name}/v_i", state.v_i, out)
            for k, v in hist.items():
                out[f"{name}/m/{k}"] = v.numpy()
        if job == "two":
            _dtensor_checks(mesh, out)
        else:
            _error_checks(mesh, data, out)
        out["seconds"] = np.array(time.perf_counter() - t0)
        np.savez(io_dir / f"out_{rank}.npz", **out)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
