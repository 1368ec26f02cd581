"""Chunks per warp tile of the small-group quantizer kernel, timed on the
card.

Builds ``csrc/quantize_block.cu`` once for each K in ``--chunks`` (the
source's ``kSmallChunks`` replaced in a copy under ``build/``) and runs
each through the port's own wrapper (``quantize_block.SOURCE`` pointed at
the copy). With ``--parent SRC``, the wrapper of another checkout's
package (its ``src`` directory, for example the parent commit unpacked by
``git archive``) runs beside them as that checkout builds it. Each version
encodes, with the dither made in the kernel, gemma3-12b's embedding
(262144 x 3840, group 8) and qwen3-moe's expert leaves (524288 x 1536,
group 16): bit for bit against ``quantize_encode_grouped_plain``, then
timed with CUDA events (20 calls) against the bytes bound (5 n + 4 n / g
bytes at 3.35 TB/s). Every version runs in a process of its own, first to
last, then last to first. Then ``cuobjdump -sass`` of each library gives,
for the group-8 and group-16 seeded encode instances, the instructions of
the function, of its first loop (the walk over whole tiles) and per
element of that loop, and its opcodes (``tests/torch_sass_counts.py``),
and ptxas gives each instance's registers and spill bytes. Prints the card, then as its last line one JSON object. Not collected by
pytest; needs a CUDA device and ``nvcc``::

    PYTHONPATH=src python tests/torch_small_quant_tiles.py --chunks 2,4,8
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import quantize_block as qb  # noqa: E402
from torch_sass_counts import function_counts  # noqa: E402

CHUNKS = re.compile(r"constexpr int kSmallChunks = \d+;")
CASES = {"g8": ((262144, 3840), 8), "g16": ((128 * 4096, 1536), 16)}
SEED = 0x9E3779B9
BYTES_PER_S = 3.35e12


def variant(k: int) -> Path:
    """A copy of the source with K chunks per warp tile."""
    src, n = CHUNKS.subn(f"constexpr int kSmallChunks = {k};",
                         qb.SOURCE.read_text())
    if n != 1:
        raise RuntimeError(f"{qb.SOURCE} holds no '{CHUNKS.pattern}'")
    path = build.BUILD_DIR / f"{qb.SOURCE.stem}_K{k}.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(src)
    return path


def time_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def one(source: str) -> dict:
    """Check and time one version in this process: the library built from
    ``source``, or, for "", this process's own wrapper and source."""
    if source:
        qb.SOURCE = Path(source)
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = {}
    for name, (shape, g) in CASES.items():
        x = torch.randn(shape, generator=gen, device="cuda")
        x[3, :g] = 0.0                           # one all-zero group
        kern = lambda: qb.quantize_encode_grouped(x, bits=8, group=g,
                                                  seed=SEED)
        got = kern()
        want = qb.quantize_encode_grouped_plain(x, bits=8, group=g,
                                                seed=SEED)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise SystemExit(f"{source or 'quantize_encode_grouped'} "
                             f"differs from the plain encode at {name}")
        del got, want
        n = x.numel()
        bound = (5 * n + 4 * n // g) / BYTES_PER_S * 1e3
        ms = time_ms(kern)
        out[name] = {"ms": ms, "bound_ms": bound, "pct_of_bound":
                     100 * bound / ms}
        del x
        torch.cuda.empty_cache()
    return out


def ptxas(report: str) -> dict:
    """Registers and spill bytes (stores + loads) of each small-group
    instance in ptxas' report, by (encode, seeded, group)."""
    out = {}
    for block in report.split("Compiling entry function '")[1:]:
        m = re.search(r"small_quant_kernelILb(\d)ELb(\d)ELi(\d)E",
                      block.split("'", 1)[0])
        if m:
            num = lambda pat: sum(map(int, re.findall(pat, block)))
            key = (("encode" if m.group(1) == "1" else "quantize")
                   + ("_seeded" if m.group(2) == "1" else "")
                   + f"_g{2 ** int(m.group(3))}")
            out[key] = [num(r"Used (\d+) registers"),
                        num(r"(\d+) bytes spill (?:stores|loads)")]
    return out


def sass(lib: Path, k: int = 0) -> dict:
    """The seeded group-8 and group-16 encode instances' counts, with the
    instructions per element of the tile loop (4 K elements a lane and
    trip). A parent source without the group as a template constant has
    one instance and no loop: its per-element count is the whole
    function's over the four elements of a thread."""
    keep = {}
    for fn, rec in function_counts(lib, "small_quant_kernel").items():
        for tag, mangled in (("g8", "ILb1ELb1ELi3E"),
                             ("g16", "ILb1ELb1ELi4E"),
                             ("any_group", "ILb1ELb1EEE")):
            if mangled in fn:
                rec["per_element"] = (rec["loop_instructions"] / (4 * k) if k
                                      else rec["instructions"] / 4)
                keep[tag] = rec
    return keep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chunks", default="2,4,8",
                    help="128-element chunks per warp tile, comma-separated")
    ap.add_argument("--parent", default=None,
                    help="the src directory of another checkout, whose "
                         "wrapper runs beside the variants")
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    if args.one is not None:
        print(json.dumps(one(args.one)))
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    versions = {f"K{k}": variant(int(k)) for k in args.chunks.split(",")}
    libs = build.build_many([(p, qb.NVCC_FLAGS) for p in versions.values()],
                            force=True)
    result = {"card": card, "cases": {k: {"shape": list(s), "group": g}
                                      for k, (s, g) in CASES.items()},
              "versions": {name: {"runs": [], "sass": sass(lib,
                                                           int(name[1:])),
                                  "ptxas": ptxas(build.BUILD_INFO.get(
                                      p.name, ""))}
                           for (name, p), lib in zip(versions.items(),
                                                     libs)}}
    runs = {name: (str(p), os.environ) for name, p in versions.items()}
    if args.parent:
        result["versions"]["parent"] = {"runs": []}
        runs["parent"] = ("", dict(os.environ, PYTHONPATH=str(
            Path(args.parent).resolve())))
    for name in list(runs) + list(runs)[::-1]:
        source, env = runs[name]
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--one", source],
            capture_output=True, text=True, timeout=600, env=env)
        rec = result["versions"][name]
        if proc.returncode != 0:
            rec.setdefault("errors", []).append(
                proc.stderr.strip().splitlines()[-1:])
            continue
        rec["runs"].append(json.loads(proc.stdout.strip().splitlines()[-1]))
    if args.parent:
        built = sorted((Path(args.parent).resolve().parent / "build")
                       .glob(f"lib{qb.SOURCE.stem}_*.so"))
        if built:
            result["versions"]["parent"]["sass"] = sass(built[-1])
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
