"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked ``cuda`` and skips without a CUDA device;
the module imports no JAX, so it also runs on a machine without it:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import compression as TC
from repro_torch.kernels import ops as kops
from repro_torch.kernels import quantize_block as tqb

pytestmark = pytest.mark.cuda


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


def _bits(t):
    t = t.detach().cpu()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 3.0).astype(np.float32)
    x.reshape(-1, shape[-1])[1] = 0.0
    u = rng.random(shape).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(u)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("rows,cols,group", [(64, 256, 256), (33, 512, 128),
                                             (9, 1024, 1024), (5, 4096, 2048),
                                             (3, 1152, 384),
                                             # groups below 128, a ragged
                                             # tail at g 1 and 2
                                             (5, 7, 1), (7, 6, 2),
                                             (10, 12, 4), (33, 3840, 8),
                                             (9, 80, 16), (3, 480, 32),
                                             (4, 576, 64),
                                             # more tiles than one wave of
                                             # warps walks at once, with a
                                             # partial last tile at g 8 and
                                             # 32; a ragged flat n at g 1
                                             # and 2
                                             (4099, 3840, 8),
                                             (4099, 1536, 16),
                                             (16387, 480, 32),
                                             (3, 349527, 1),
                                             (3, 349526, 2)])
def test_kernels_match_plain(bits, rows, cols, group):
    dev = _cuda()
    x, u = _inputs((rows, cols), rows)
    x, u = x.to(dev), u.to(dev)
    seed = 2 ** 32 - 3
    pairs = [
        (tqb.quantize_grouped(x, u, bits=bits, group=group),
         tqb.quantize_grouped_plain(x, u, bits=bits, group=group)),
        (tqb.quantize_grouped(x, bits=bits, group=group, seed=seed),
         tqb.quantize_grouped_plain(x, bits=bits, group=group, seed=seed)),
    ]
    pairs += list(zip(
        tqb.quantize_encode_grouped(x, u, bits=bits, group=group),
        tqb.quantize_encode_grouped_plain(x, u, bits=bits, group=group)))
    pairs += list(zip(
        tqb.quantize_encode_grouped(x, bits=bits, group=group, seed=seed),
        tqb.quantize_encode_grouped_plain(x, bits=bits, group=group,
                                          seed=seed)))
    for got, want in pairs:
        assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("round_to", [None, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("group", [256, 2048])
def test_reduce_matches_plain(group, round_to):
    dev = _cuda()
    rng = np.random.default_rng(2)
    codes = torch.from_numpy(
        rng.integers(-127, 128, (16, 8, 4096)).astype(np.int8)).to(dev)
    scales = torch.from_numpy(
        rng.random((16, 8, 4096 // group)).astype(np.float32)).to(dev)
    scales[0, 1, 0] = 0.0
    w = torch.from_numpy(rng.random(16).astype(np.float32)).to(dev)
    got = tqb.decode_reduce_grouped(codes, scales, w, bits=8, group=group,
                                    round_to=round_to)
    want = tqb.decode_reduce_grouped_plain(codes, scales, w, bits=8,
                                           group=group, round_to=round_to)
    assert torch.equal(_bits(got), _bits(want))


def test_launches_count_kernel_calls():
    dev = _cuda()
    x, u = _inputs((8, 256), 0)
    before = dict(tqb.LAUNCHES)
    tqb.quantize_encode_grouped(x.to(dev), u.to(dev))
    tqb.quantize_grouped(x.to(dev), seed=1)
    assert tqb.LAUNCHES["encode"] == before["encode"] + 1
    assert tqb.LAUNCHES["quantize_seeded"] == before["quantize_seeded"] + 1
    # the flat stream's launch counts once, under its own entry
    before = dict(tqb.LAUNCHES)
    kops.quantize_dequantize_with_dither(x.reshape(-1).to(dev),
                                         u.reshape(-1).to(dev))
    assert tqb.LAUNCHES["quantize_block"] == before["quantize_block"] + 1
    assert sum(tqb.LAUNCHES.values()) == sum(before.values()) + 1


@pytest.mark.parametrize("shard_safe", [False, True])
@pytest.mark.parametrize("dither", ["hash", "kernel"])
def test_compressor_on_card_equals_cpu(shard_safe, dither):
    """The kernel route on the card gives the CPU plain route's bits, and
    decode(encode(x)) == apply(x) on the card."""
    dev = _cuda()
    x, _ = _inputs((64, 1024), 9)
    tree = {"w": x, "b": x[0, :300].clone()}
    comp = TC.block_quant(8, 256, dither=dither, shard_safe=shard_safe,
                          kernel_threshold=4096, checksum=True)
    seeds = [2 ** 31 + 1, 17]
    on_card = comp.encode(seeds, {k: v.to(dev) for k, v in tree.items()})
    on_cpu = comp.encode(seeds, tree)
    for k in tree:
        assert torch.equal(on_card[k].codes.cpu(), on_cpu[k].codes)
        assert torch.equal(_bits(on_card[k].scales), _bits(on_cpu[k].scales))
        assert torch.equal(on_card[k].check.cpu(), on_cpu[k].check)
    applied = comp.apply(seeds, {k: v.to(dev) for k, v in tree.items()})
    decoded = comp.decode(on_card)
    for k in tree:
        assert torch.equal(_bits(applied[k]), _bits(decoded[k]))


@pytest.mark.parametrize("cols", [3840, 2560, 15360])
def test_small_group_leaf_takes_kernel_on_card(cols):
    """A shard-safe leaf whose group is below 128 (LM widths: D 3840 gives
    8, 2560 16, 15360 32) launches the encode kernel with the in-kernel
    dither for ``"hash"``, with the CPU plain route's bits."""
    dev = _cuda()
    x, _ = _inputs((64, cols), 3)
    comp = TC.block_quant(8, 256, dither="hash", shard_safe=True)
    before = dict(tqb.LAUNCHES)
    on_card = comp.encode([7], {"w": x.to(dev)})["w"]
    assert tqb.LAUNCHES["encode_seeded_small"] == \
        before["encode_seeded_small"] + 1
    on_cpu = comp.encode([7], {"w": x})["w"]
    assert on_card.group == TC.group_size(cols, 256) < 128
    assert torch.equal(on_card.codes.cpu(), on_cpu.codes)
    assert torch.equal(_bits(on_card.scales), _bits(on_cpu.scales))
