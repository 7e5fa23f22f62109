#!/usr/bin/env python3
"""Compare the SASS of one library's kernels in this tree and in another.

    python3 tools/sass_against.py --lib gather_mlp --against DIR
        [--match REGEX]

Builds ``src/repro_torch/csrc/<lib>.cu`` with the headers beside it, and
the same file of another tree with the headers beside it there (DIR,
e.g. a parent commit's ``src/repro_torch/csrc``), with the port's nvcc
flags (under ``build/repro_torch/sass/<lib>/``; the sources are not
touched); dumps each library's SASS (``cuobjdump -sass``) and prints one
JSON line per kernel whose mangled name matches REGEX in either tree: its
instruction count in each and whether the two instruction streams are
equal (addresses and encodings stripped), then one line with the count
of kernels compared, equal, and found in one tree only.  Exits 1 if a
matched kernel differs or is missing from a tree.  Needs nvcc, no CUDA
device.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(ROOT / "tools")]

# an instruction line of cuobjdump -sass: /*0070*/  OPCODE operands ;
INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")
# the hash an anonymous namespace's mangled name carries, which follows
# the build and not the code
HASH = re.compile(r"[0-9a-f]{8,}")


def sass(tool: str, lib: Path) -> dict:
    """{kernel (mangled name, its hashes as H): [instruction, ...]} of a
    built library."""
    text = subprocess.run([tool, "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    out, fn = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            fn = HASH.sub("H", line.split("Function :")[1].strip())
            out[fn] = []
        elif fn is not None:
            m = INSN.search(line)
            if m:
                out[fn].append(m.group(1))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lib", required=True,
                    help="the library's source name, e.g. gather_mlp")
    ap.add_argument("--against", required=True,
                    help="a directory with the other tree's <lib>.cu and "
                         "headers")
    ap.add_argument("--match", default=".",
                    help="a regular expression the kernels' mangled names "
                         "are searched for")
    args = ap.parse_args()
    from gather_mlp_planted_faults import build
    from repro_torch.kernels import _build

    def tree(d: Path) -> dict:
        return {p.name: p.read_text() for p in
                [d / f"{args.lib}.cu", *sorted(d.glob("*.cuh"))]}
    libs = build({"this": tree(_build.CSRC), "against":
                  tree(Path(args.against))},
                 _build.BUILD_DIR / "sass" / args.lib)
    tool = str(Path(_build._nvcc()).with_name("cuobjdump"))
    ours, theirs = sass(tool, libs["this"]), sass(tool, libs["against"])
    pick = re.compile(args.match)
    names = sorted(n for n in set(ours) | set(theirs) if pick.search(n))
    same = alone = 0
    for name in names:
        a, b = ours.get(name), theirs.get(name)
        row = dict(kernel=name, insns=None if a is None else len(a),
                   insns_against=None if b is None else len(b),
                   equal=a is not None and a == b)
        same += row["equal"]
        alone += a is None or b is None
        print(json.dumps(row), flush=True)
    print(json.dumps(dict(lib=args.lib, match=args.match,
                          kernels=len(names), equal=same,
                          in_one_tree_only=alone)), flush=True)
    return 0 if names and same == len(names) else 1


if __name__ == "__main__":
    sys.exit(main())
