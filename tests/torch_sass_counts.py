"""Instruction counts of a built kernel library, from ``cuobjdump -sass``.

For each kernel whose name holds ``--match``: its instructions (NOPs
left out), the instructions of its first loop (from the lowest target of
a backward branch to the last branch back there), a histogram of opcodes
over the function and over that loop, and its memory instructions by
address space:
generic (``LD``/``ST``/``ATOM``/``RED``, whose space the hardware decides
from the address), local (``LDL``/``STL``), global, shared. Prints one
JSON object. Needs the CUDA toolkit's ``cuobjdump``; not collected by
pytest::

    python tests/torch_sass_counts.py build/libquantize_block_*.so \\
        --match small_quant_kernel
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import re
import shutil
import subprocess
from pathlib import Path

FUNCTION = re.compile(r"^\s*Function : (\S+)")
INSTRUCTION = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
PREDICATE = re.compile(r"^@!?U?P\w+\s+")
TARGET = re.compile(r"0x([0-9a-f]+)")
SPACES = {"generic": ("LD", "ST", "ATOM", "RED"), "local": ("LDL", "STL"),
          "global": ("LDG", "STG", "ATOMG", "REDG"),
          "shared": ("LDS", "STS", "ATOMS", "LDSM")}


def cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    default = "/usr/local/cuda/bin/cuobjdump"
    if os.path.exists(default):
        return default
    raise RuntimeError("cuobjdump not found (the CUDA toolkit's)")


def opcode(text: str) -> str:
    return PREDICATE.sub("", text).split()[0]


def parse(listing: str) -> dict:
    """function name -> [(address, instruction text)]"""
    out, current = {}, None
    for line in listing.splitlines():
        m = FUNCTION.match(line)
        if m:
            current = out.setdefault(m.group(1), [])
            continue
        m = INSTRUCTION.search(line)
        if m and current is not None:
            current.append((int(m.group(1), 16), m.group(2)))
    return out


def counts(body) -> dict:
    body = [(a, t) for a, t in body if opcode(t) != "NOP"]
    # the first loop: the backward branch with the lowest target, the
    # last one to it where several branch back there
    loop = None
    for addr, text in body:
        if opcode(text).startswith("BRA"):
            m = TARGET.search(text.split(None, 1)[-1])
            if m and int(m.group(1), 16) < addr:
                span = (int(m.group(1), 16), addr)
                if loop is None or (span[0], -span[1]) < (loop[0], -loop[1]):
                    loop = span
    loop = loop or (0, -1)
    in_loop = [t for a, t in body if loop[0] <= a <= loop[1]]
    hist = collections.Counter(opcode(t) for _, t in body)
    loop_hist = collections.Counter(opcode(t) for t in in_loop)
    spaces = {space: sum(n for op, n in hist.items()
                         if op.split(".")[0] in ops)
              for space, ops in SPACES.items()}
    return {"instructions": len(body), "loop_instructions": len(in_loop),
            "memory_by_space": spaces,
            "opcodes": dict(sorted(hist.items())),
            "loop_opcodes": dict(sorted(loop_hist.items()))}


def function_counts(lib: Path, match: str = "") -> dict:
    listing = subprocess.run([cuobjdump(), "-sass", str(lib)],
                             capture_output=True, text=True,
                             check=True).stdout
    return {name: counts(body) for name, body in parse(listing).items()
            if match in name}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("libs", nargs="+", help="built .so libraries")
    ap.add_argument("--match", default="", help="part of the kernel names")
    args = ap.parse_args(argv)
    print(json.dumps({lib: function_counts(Path(lib), args.match)
                      for lib in args.libs}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
