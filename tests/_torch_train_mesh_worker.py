"""One rank of the LM trainer's multi-rank CPU tests (gloo), run as

    python tests/_torch_train_mesh_worker.py RANK WORLD PORT DIR

``tests/test_torch_train_mesh.py`` starts WORLD of these with one free
PORT. Each reads ``DIR/inputs.pt`` (the rounds' batches and draws and,
for every case, the state each round starts from), brings up
``torch.distributed`` over gloo on ``tcp://localhost:PORT`` with a
60-second timeout, steps the physical trainer on a CPU ``DeviceMesh``
(``("clients",)``) round by round from those states with its rows of the
batch and of ``v_i``, and writes each round's new state (its ``v_i``
rows) and metrics to ``DIR/out_<RANK>.pt``. Imports no JAX. The config,
the cases and ``train_step`` are shared with the parent.
"""
import datetime
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import repro_torch.configs as TC  # noqa: E402
from repro_torch import api, interop  # noqa: E402
from repro_torch.fed import trainer as TFT  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

ARCH = "gemma3-12b"
N_CLIENTS, B_LOCAL, SEQ, ROUNDS = 4, 1, 24, 2
# name: (uplink, variates on)
CASES = {"gather_zero": ("gather", True), "gather_off": ("gather", False),
         "reduce_zero": ("reduce", True), "reduce_off": ("reduce", False)}


def model():
    return build_model(TC.get(ARCH).reduced(), device="cpu")


def fed_config(use_cv: bool, quant_bits: int = 8) -> TFT.FedLMConfig:
    """Physical silos, p 0.5, ``block_quant(8, 256, "hash")`` (shard-safe
    groups) unless ``quant_bits=0``."""
    return TFT.FedLMConfig(n_clients=N_CLIENTS, rho=0.05, p=0.5, alpha=0.1,
                           use_cv=use_cv, quant_bits=quant_bits,
                           client_mode="physical")


def gamma(t: int) -> float:
    return 0.5 / (1.0 + t) ** 0.5


def as_state(d: dict) -> TFT.FedLMState:
    return TFT.FedLMState(s_hat=d["s_hat"], v=d["v"], v_i=d["v_i"],
                          step=d["step"])


def as_dict(state: TFT.FedLMState) -> dict:
    return {"s_hat": state.s_hat, "v": state.v, "v_i": state.v_i,
            "step": state.step}


def lockstep(step, starts, inputs, spec, mesh=None, first: int = 0) -> list:
    """Round ``t = first + i`` stepped from ``starts[i]`` (a whole state;
    on a mesh the rank takes its rows of ``v_i`` and of the batch) with
    round ``t``'s batch and draws. Returns each round's ``{"state",
    "metrics"}``."""
    lo, hi = api.local_rows(spec, mesh)
    out = []
    for t, start in enumerate(starts, first):
        state = as_state(start)
        if mesh is not None:
            state = interop.fedlm_state_for_rank(state, spec, mesh,
                                                 device="cpu")
        batch = tree_map(lambda x: x[lo:hi], inputs["batches"][t])
        new, m = step(state, batch, None, gamma(t),
                      active=inputs["active"][t], seeds=inputs["seeds"][t])
        out.append({"state": as_dict(new), "metrics": m})
    return out


def main(argv) -> int:
    rank, world, port, io_dir = int(argv[1]), int(argv[2]), int(argv[3]), \
        Path(argv[4])
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        inputs = torch.load(io_dir / "inputs.pt")
        mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("clients",))
        tm = model()
        out = {}
        for name, (uplink, use_cv) in CASES.items():
            fcfg = fed_config(use_cv)
            step = TFT.make_train_step(tm, fcfg, mesh=mesh, uplink=uplink)
            out[name] = lockstep(step, inputs["starts"][name], inputs,
                                 fcfg.federation_spec(), mesh)
        out["rows"] = api.local_rows(fed_config(True).federation_spec(),
                                     mesh)
        torch.save(out, io_dir / f"out_{rank}.pt")
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
