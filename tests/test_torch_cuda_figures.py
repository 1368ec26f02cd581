"""The paper's figure problems on the card: one Fig. 1 setting at the
reduced size, the minibatch function with a CPU and with a CUDA
generator, and the two examples. Every test here is marked ``cuda`` and
skips without a CUDA device; the module imports no JAX, so it also runs
on a machine without it:

    python -m pytest -q -m cuda tests/test_torch_cuda_figures.py
"""
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.benchmarks import fig1_dictlearn as fig1
from repro_torch.configs.dictlearn import SYNTH_HETEROGENEOUS
from repro_torch.data.synthetic import client_minibatch_fn
from repro_torch.examples import federated_em_gmm

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parents[1]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


def test_fig1_reduced_setting_on_the_card():
    """Fig. 1's outcome on the synthetic heterogeneous setting at the
    reduced size (1500 samples, 50 ISTA iterations, 80 rounds)."""
    _cuda()
    out = fig1.run_setting(SYNTH_HETEROGENEOUS, rounds=80, reduced=True,
                           device="cuda")
    row = fig1.summary(SYNTH_HETEROGENEOUS, out)
    assert all(math.isfinite(v) for hist in (out["fedmm"], out["naive"])
               for h in hist for v in h.values())
    assert row["fedmm_loss_last"] < row["fedmm_loss_first"], row
    assert row["naive_loss_last"] > row["fedmm_loss_last"], row


@pytest.mark.parametrize("gen_device", ["cpu", "cuda"])
def test_minibatch_fn_with_either_generator(gen_device):
    """Data on the card, indices drawn on a CPU or a CUDA generator: the
    batch lands on the card, each row from its own client's shard; with a
    CPU generator it is the batch the CPU data gives for the same seed."""
    dev = _cuda()
    data = torch.arange(4 * 10 * 3, dtype=torch.float32).reshape(4, 10, 3)
    gen = torch.Generator(device=gen_device).manual_seed(0)
    got = client_minibatch_fn(data.to(dev), batch_size=6)(0, gen)
    assert got.device.type == "cuda" and tuple(got.shape) == (4, 6, 3)
    for c in range(4):
        shard = {tuple(r) for r in data[c].tolist()}
        assert all(tuple(r) in shard for r in got[c].cpu().tolist())
    if gen_device == "cpu":
        want = client_minibatch_fn(data, batch_size=6)(
            0, torch.Generator().manual_seed(0))
        assert torch.equal(got.cpu(), want)


def _losses(line: str):
    m = re.search(r"loss: ([0-9.]+) -> ([0-9.]+)", line)
    return float(m.group(1)), float(m.group(2))


def test_quickstart_on_the_card():
    """``python -m repro_torch.examples.quickstart --rounds 20`` with its
    default device, the GPU: SA-SSMM's and FedMM's losses fall."""
    _cuda()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.quickstart",
         "--rounds", "20"], capture_output=True, text=True, env=env,
        cwd=str(ROOT), timeout=600)
    assert out.returncode == 0, out.stderr
    lines = {ln.split()[0]: ln for ln in out.stdout.splitlines() if ln}
    for name in ("SA-SSMM", "FedMM"):
        first, last = _losses(lines[name])
        assert last < first, lines[name]
    assert all(math.isfinite(v) for v in _losses(lines["naive(Theta)"]))


def test_federated_em_gmm_on_the_card():
    _cuda()
    out = federated_em_gmm.main(["--rounds", "40"])
    assert out["nll1"] < out["nll0"]
    assert max(out["mean_error"]) < 0.6
