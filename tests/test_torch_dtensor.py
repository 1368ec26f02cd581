"""The models on ``DTensor``s with data: the layout rules' call sites and
the branches that only a ``DTensor`` takes (the vocab-sharded loss, the
MoE's counts, the head split and merge, the kernels' and the Mamba
scan's per-block maps, decode's slot write), on the CPU over gloo.

Four ranks (``tests/_torch_dtensor_worker.py``, subprocesses) form a
(2, 2) ``("data", "model")`` mesh with the production rules installed;
each reduced family runs ``prefill``, one ``decode`` step and ``loss_fn``
with its gradient on parameters laid out by ``placements(param_specs)``
and a batch split over ``"data"``, and the same calls on plain tensors.
Every result, gathered, is held within 1e-5 of the plain result's
largest magnitude: float32 sums taken in another order (the largest gap
seen is 2.4e-6 of it). No JAX."""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
WORLD = 4
JOB_TIMEOUT = 240
FAMILIES = ("dense", "swa", "heads3", "moe", "hybrid", "rwkv")
QUANTITIES = ("prefill", "caches", "decode", "decoded_caches", "loss",
              "grad")
RTOL = 1e-5


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def gaps(tmp_path_factory):
    """Rank 0's record: {family: {quantity: [max gap, max |plain|]}}."""
    out_dir = tmp_path_factory.mktemp("dtensor")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(HERE.parent / "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(HERE / "_torch_dtensor_worker.py"), str(r),
         str(WORLD), str(port), str(out_dir)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=JOB_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]
    return json.loads((out_dir / "out.json").read_text())


@pytest.mark.parametrize("quantity", QUANTITIES)
@pytest.mark.parametrize("family", FAMILIES)
def test_dtensor_matches_plain(gaps, family, quantity):
    err, scale = gaps[family][quantity]
    assert scale > 0
    assert err <= RTOL * scale, (family, quantity, err, scale)


@pytest.mark.parametrize("family", FAMILIES)
def test_gradient_is_sharded(gaps, family):
    """The gradients come back laid out (not all replicated): the layout
    rules were in force."""
    assert gaps[family]["grad_sharded"] is True


def test_no_jax_on_the_ranks(gaps):
    assert gaps["jax_imported"] == []
