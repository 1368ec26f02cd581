"""FedMM-OT and the Section 6/7 examples on the card: a reduced Fig. 3 with
the gates of ``chip_smoke.py``'s ``fig3`` phase, and the two examples.
Every test here is marked ``cuda`` and skips without a CUDA device; the
module imports no JAX, so it also runs on a machine without it:

    python -m pytest -q -m cuda tests/test_torch_cuda_ot.py
"""
import math

import pytest
import torch

from repro_torch.benchmarks import fig3_ot as fig3
from repro_torch.examples import fedmm_ot_maps, federated_dictionary_learning

pytestmark = pytest.mark.cuda

# chip_smoke.py's DEVICE_RTOL: the GPU-vs-CPU limit of the figures
DEVICE_RTOL = 1e-4


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")


def test_fig3_reduced_on_the_card():
    """d = 4, 20 rounds: every round's L2-UVP of both algorithms finite,
    each curve's last point (round 20) below its first (round 10); and the
    first 10 FedMM-OT rounds within ``DEVICE_RTOL`` of the CPU's from the
    same host draws."""
    _cuda()
    d, rounds = 4, 20
    out = fig3.run_dim(d, rounds=rounds, device="cuda")
    for name in ("fedmm_ot", "fedadam"):
        assert fig3.first_nonfinite(out[name]) is None, out[name]
        curve = fig3.every_tenth(out[name])
        assert len(curve) == 2 and curve[-1] < curve[0], (name, curve)
    cpu = fig3.run_dim(d, rounds=10, device="cpu")["fedmm_ot"]
    rel = max(abs(g - c) / abs(c) for g, c in zip(out["fedmm_ot"], cpu))
    assert rel <= DEVICE_RTOL, (out["fedmm_ot"][:10], cpu)


def test_fedmm_ot_maps_on_the_card():
    """``repro_torch.examples.fedmm_ot_maps`` with its default device, the
    GPU: FedMM-OT's L2-UVP falls, both finite."""
    _cuda()
    out = fedmm_ot_maps.main(["--rounds", "30"])
    assert out["rounds"] == [10, 20, 30]
    assert all(math.isfinite(v) for v in out["fedmm_ot"] + out["fedadam"])
    assert out["fedmm_ot"][-1] < out["fedmm_ot"][0]


def test_federated_dictionary_learning_on_the_card():
    """``repro_torch.examples.federated_dictionary_learning --rounds 10``
    on the GPU: FedMM's loss falls and ends below the naive baseline's."""
    _cuda()
    out = federated_dictionary_learning.main(["--rounds", "10"])
    f, n = out["fedmm"], out["naive"]
    assert all(math.isfinite(v) for h in f + n for v in h.values())
    assert f[-1]["loss"] < f[0]["loss"]
    assert n[-1]["loss"] > f[-1]["loss"]
