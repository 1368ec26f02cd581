"""The quantizer's CUDA source run on the CPU, bit for bit against the plain
versions.

``csrc/quantize_block.cu`` is compiled as committed by g++, with the stub
runtime header of ``tests/cuda_stub/`` (one host thread per CUDA thread,
``__shfl_xor_sync`` through a per-warp array and barrier, the ``__f*_rn``
intrinsics as IEEE operations, a device of two SMs that hold one block
each, so a grid-stride loop wraps); only its ``<<<...>>>`` launches are
rewritten to the stub's launcher. The library's ``qb_encode``,
``qb_quantize`` and ``qb_decode_reduce`` (float32 and bf16-rounded) are
called through ctypes with CPU tensors' pointers. The
outputs sit in buffers with a guard region past their end, which must come
back untouched. Runs where ``g++`` is found (about 15 s)::

    PYTHONPATH=src python -m pytest -q tests/test_torch_quantize_emulated.py
"""
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import quantize_block as tqb

STUB = Path(__file__).resolve().parent / "cuda_stub"
FLAGS = ("-std=c++20", "-O1", "-ffp-contract=off", "-fno-strict-aliasing",
         "-fPIC", "-shared", "-pthread")
LAUNCH = re.compile(r"(\w+(?:<[^<>;()]*>)?)\s*<<<(.*?)>>>\s*\(", re.S)
SEED = 2 ** 32 - 3
GUARD = 64                   # elements past each output's end
SENTINEL = -77               # int8 / float guard value

# (rows, cols) per group: below one warp tile (n < 256, ragged against 4
# at g 1 and 2) and several whole tiles over a grid that wraps (the stub's
# 16 warps) plus a ragged tail (n % 256 != 0, any tile of 2-8 chunks)
SHAPES = {
    1: ((3, 7), (3, 6827)),
    2: ((5, 6), (7, 2926)),
    4: ((3, 20), (5, 4100)),
    8: ((5, 40), (5, 3848)),
    16: ((3, 64), (11, 1840)),
    32: ((5, 32), (5, 4064)),
    64: ((3, 64), (9, 2240)),
    256: ((3, 256), (11, 768)),
}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the CUDA source on the CPU")
    text, n = LAUNCH.subn(r"::cuda_stub::launch(\1, ::cuda_stub::Cfg(\2), ",
                          tqb.SOURCE.read_text())
    assert n == 3, f"expected the source's three launches, rewrote {n}"
    out = tmp_path_factory.mktemp("qb_emulated")
    src = out / "quantize_block_host.cpp"
    src.write_text(text)
    so = out / "libquantize_block_host.so"
    subprocess.run([gxx, *FLAGS, f"-I{STUB}", "-o", str(so), str(src)],
                   check=True, capture_output=True, text=True)
    P, I, LL, U = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_uint)
    handle = ctypes.CDLL(str(so))
    handle.qb_quantize.argtypes = [P, P, P, LL, LL, I, I, U, I, I, P]
    handle.qb_encode.argtypes = [P, P, P, P, LL, LL, I, I, U, I, I, P]
    handle.qb_decode_reduce.argtypes = [P, P, P, P, I, LL, LL, I, I, I, I,
                                        P]
    handle.qb_quantize.restype = handle.qb_encode.restype = I
    handle.qb_decode_reduce.restype = I
    return handle


def _inputs(shape, group, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 3.0).astype(np.float32)
    x.reshape(-1, group)[1] = 0.0                # one all-zero group
    u = rng.random(shape).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(u)


def _guarded(n, dtype):
    buf = torch.full((n + GUARD,), SENTINEL, dtype=dtype)
    return buf, buf[:n]


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _emulated(lib, x, u, *, encode, bits, group):
    R, D = x.shape
    seeded = u is None
    uptr = None if seeded else u.data_ptr()
    seed = SEED if seeded else 0
    if encode:
        cbuf, codes = _guarded(R * D, torch.int8)
        sbuf, scales = _guarded(R * D // group, torch.float32)
        rc = lib.qb_encode(x.data_ptr(), uptr, codes.data_ptr(),
                           scales.data_ptr(), R, D, group, bits, seed,
                           int(seeded), 0, None)
        got, bufs = (codes.view(R, D), scales.view(R, D // group)), (cbuf,
                                                                    sbuf)
    else:
        obuf, out = _guarded(R * D, torch.float32)
        rc = lib.qb_quantize(x.data_ptr(), uptr, out.data_ptr(), R, D, group,
                             bits, seed, int(seeded), 0, None)
        got, bufs = (out.view(R, D),), (obuf,)
    assert rc == 0, f"launch returned cudaError {rc}"
    for buf in bufs:
        tail = buf[-GUARD:]
        assert torch.equal(tail, torch.full_like(tail, SENTINEL)), \
            "the kernel wrote past the end of an output"
    return got


def _plain(x, u, *, encode, bits, group):
    seed = SEED if u is None else None
    if encode:
        return tqb.quantize_encode_grouped_plain(x, u, bits=bits,
                                                 group=group, seed=seed)
    return (tqb.quantize_grouped_plain(x, u, bits=bits, group=group,
                                       seed=seed),)


@pytest.mark.parametrize("size", [0, 1], ids=["below_tile", "tiles_tail"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("group", sorted(SHAPES))
def test_emulated_source_matches_plain(lib, group, bits, size):
    """Encode and quantize, the dither made in the kernel (seed 2^32 - 3)
    and streamed: every output bit for bit the plain version's."""
    shape = SHAPES[group][size]
    x, u = _inputs(shape, group, seed=group * 10 + size)
    for encode in (True, False):
        for dither in (None, u):
            got = _emulated(lib, x, dither, encode=encode, bits=bits,
                            group=group)
            want = _plain(x, dither, encode=encode, bits=bits, group=group)
            for g, w in zip(got, want):
                assert torch.equal(_bits(g), _bits(w)), (
                    f"encode={encode} seeded={dither is None}: "
                    f"{int((_bits(g) != _bits(w)).sum())} elements differ")


def test_emulated_source_refuses_bad_groups(lib):
    """A group that is neither a power of two below 128 nor a multiple of
    128 launches nothing."""
    x, _ = _inputs((2, 96), 1, seed=0)
    out = torch.empty_like(x)
    assert lib.qb_quantize(x.data_ptr(), None, out.data_ptr(), 2, 96, 48, 8,
                           1, 1, 0, None) == 1  # cudaErrorInvalidValue


@pytest.mark.parametrize("round_to", [None, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("group", [128, 256])
def test_emulated_decode_reduce_matches_plain(lib, group, round_to):
    """The decode + reduce over 3 clients (one dropped group, one client
    weighted 0), its dequantized elements as they are or rounded to bf16
    (a bf16 leaf's decode), bit for bit the plain version's, over a grid
    that wraps and with a guard past the output."""
    rng = np.random.default_rng(group)
    C, R, D = 3, 5, 2 * group
    codes = torch.from_numpy(rng.integers(-127, 128, (C, R, D))
                             .astype(np.int8))
    scales = torch.from_numpy((rng.random((C, R, D // group)) * 7.0)
                              .astype(np.float32))
    scales[1, 2, 0] = 0.0
    w = torch.tensor([0.3, 0.0, 0.7], dtype=torch.float32)
    obuf, out = _guarded(R * D, torch.float32)
    rc = lib.qb_decode_reduce(codes.data_ptr(), scales.data_ptr(),
                              w.data_ptr(), out.data_ptr(), C, R, D, group,
                              8, int(round_to is not None), 0, None)
    assert rc == 0, f"launch returned cudaError {rc}"
    tail = obuf[-GUARD:]
    assert torch.equal(tail, torch.full_like(tail, SENTINEL))
    want = tqb.decode_reduce_grouped_plain(codes, scales, w, bits=8,
                                           group=group, round_to=round_to)
    assert torch.equal(_bits(out.view(R, D)), _bits(want))
    if round_to is not None:
        plain32 = tqb.decode_reduce_grouped_plain(codes, scales, w, bits=8,
                                                  group=group)
        assert not torch.equal(want, plain32), "the rounding changed nothing"
