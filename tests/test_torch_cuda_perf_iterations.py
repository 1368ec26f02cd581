"""The A/B driver's wire mode on the card at the reference's size (32
clients x 262,144, ``block_quant(b, 256, dither="hash")``): the kernels
route (``qb_quantize``, ``qb_encode``, ``qb_decode_reduce``), the
dequantized and code-space aggregates bit for bit, each also bit for bit
the plain route's (``kernel_threshold=1 << 62``) at b 8 and b 4, the
fused one within rtol 1e-5 / atol 1e-6, and the payload stacks' bytes. Marked ``cuda``; it
skips without a CUDA device and imports no JAX:

    python -m pytest -q -m cuda tests/test_torch_cuda_perf_iterations.py
"""
import pytest
import torch

from repro_torch.benchmarks import perf_iterations as P
from repro_torch.core import compression as C
from repro_torch.kernels import quantize_block as qb

pytestmark = pytest.mark.cuda

# the reference's committed wire row at this size (results/perf_log.json)
PAYLOAD_STACK_BYTES = {"b8": 8_519_680, "b4": 4_325_376}
F32_STACK_BYTES = 33_554_432


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    torch.cuda.set_device(0)


def test_wire_on_the_card(card, tmp_path):
    entry = P.bench_wire(log_path=str(tmp_path / "p.json"))
    r = entry["result"]
    assert entry["card"] and r["device"] == "cuda"
    assert (r["n_clients"], r["dim"]) == (32, 1 << 18)
    assert r["f32_stack_bytes"] == F32_STACK_BYTES
    for b, nbytes in PAYLOAD_STACK_BYTES.items():
        assert r[b]["aggregate_bit_identical"] is True, b
        assert r[b]["plain_route_bit_identical"] is True, b
        assert r[b]["payload_stack_bytes"] == nbytes, b
        assert r[b]["fused_allclose_vs_code_space"] is True, b
    # the in-kernel dither variants: 32 clients x (1 + 5) calls x 2 widths
    for k in ("quantize_seeded", "encode_seeded", "decode_reduce"):
        assert r["launches"].get(k, 0) > 0, (k, r["launches"])
    assert not {"quantize", "encode"} & set(r["launches"]), r["launches"]


def test_fused_round_within_tolerance_of_code_space(card):
    gen = torch.Generator().manual_seed(1)
    xs = torch.randn((32, 1 << 18), generator=gen).cuda()
    seeds = list(range(32))
    mu = torch.full((32,), 1.0 / 32, device="cuda")
    for bits in (8, 4):
        comp = C.block_quant(bits, 256, dither="hash")
        plain = C.block_quant(bits, 256, dither="hash",
                              kernel_threshold=1 << 62)
        qb.reset_launches()
        fused = P.wire_round(comp, xs, seeds, mu, "fused")
        assert qb.LAUNCHES["decode_reduce"] == 1
        code = P.wire_round(comp, xs, seeds, mu, "code_space")
        deq = P.wire_round(comp, xs, seeds, mu, "dequant")
        assert P.bits_equal(code, deq)
        # the kernels against their plain versions on the same inputs
        for path, got in (("dequant", deq), ("code_space", code)):
            assert P.bits_equal(got, P.wire_round(plain, xs, seeds, mu, path)), \
                (bits, path)
        torch.testing.assert_close(fused, code, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(
            fused, P.wire_round(plain, xs, seeds, mu, "fused"),
            rtol=1e-5, atol=1e-6)
