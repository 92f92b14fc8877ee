"""Compare kernels' SASS between two builds.

    python -m pbf_sph_tpu_torch.tools.sass_diff A B PATTERN_A=PATTERN_B ...

A and B are built libraries or cubins.  Each PATTERN_A=PATTERN_B names one
kernel in each by a unique part of its mangled name (a refactor may rename
a kernel, e.g. by a template argument).  For each pair it prints both
instruction counts, whether the opcode sequences are equal, how many of
the loops (the spans of backward branches, in address order) hold the same
opcode sequence in both, how many instructions of each a sequence diff
leaves unmatched once the constant-bank operands (c[0x0][...], where a
kernel reads its parameters, which move when its parameter list changes)
are masked, and the opcodes that one has more of than the other.  The last
line is one JSON object.
Needs the CUDA toolkit's `cuobjdump`, no card.
"""

from __future__ import annotations

import collections
import difflib
import json
import re
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Tuple

from pbf_sph_tpu_torch.ops import cuda_build
from pbf_sph_tpu_torch.tools import anchor_rate as ar

_FUNC = re.compile(r"\s*Function\s*:\s*(\S+)")
_INST = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")
_CBANK = re.compile(r"c\[0x[0-9a-f]+\]\[0x[0-9a-f]+\]")


def listings(path) -> Dict[str, Tuple[List[str], ar.Sass]]:
    """`parse` of the build's `cuobjdump -sass`."""
    tool = Path(cuda_build.find_nvcc()).with_name("cuobjdump")
    return parse(subprocess.run([str(tool), "-sass", str(path)], capture_output=True,
                                text=True, check=True).stdout)


def parse(text: str) -> Dict[str, Tuple[List[str], ar.Sass]]:
    """{mangled kernel name: (its instructions as written, predicate
    included; its `anchor_rate.parse_sass` listing)} of a listing."""
    parsed = ar.parse_sass(text)
    funcs: Dict[str, List[str]] = {}
    insts = None
    for line in text.splitlines():
        m = _FUNC.match(line)
        if m:
            insts = funcs.setdefault(m.group(1), [])
        elif insts is not None and _INST.search(line):
            insts.append(" ".join(_INST.search(line).group(1).split()))
    return {name: (insts, parsed[name]) for name, insts in funcs.items()}


def one(funcs: dict, pattern: str):
    names = [n for n in funcs if pattern in n]
    if len(names) != 1:
        raise SystemExit(f"sass_diff: {len(names)} kernels match {pattern!r}")
    return funcs[names[0]]


def loops(sass: ar.Sass) -> List[List[str]]:
    """The opcode sequence of each loop, the span of a backward branch, in
    address order."""
    return [[op for addr, op, _ in sass[0] if lo <= addr <= hi]
            for lo, hi in sorted(ar.all_spans(sass))]


def opcode(inst: str) -> str:
    return re.sub(r"^@!?U?P[0-9T]+\s+", "", inst).split()[0]


def compare(a, b) -> dict:
    """Of two `listings` entries: instruction counts, opcode sequences
    equal, loops and loops the same opcode for opcode, the instructions of
    each that a sequence diff leaves unmatched with the constant-bank
    operands masked, and the opcodes each has more of."""
    (ia, sa), (ib, sb) = a, b
    ma = [_CBANK.sub("c[.]", i) for i in ia]
    mb = [_CBANK.sub("c[.]", i) for i in ib]
    matched = sum(m.size for m in difflib.SequenceMatcher(None, ma, mb, autojunk=False)
                  .get_matching_blocks())
    la, lb = loops(sa), loops(sb)
    ops_a = collections.Counter(opcode(i) for i in ia)
    ops_b = collections.Counter(opcode(i) for i in ib)
    return dict(insts=[len(ia), len(ib)],
                same_opcodes=[opcode(i) for i in ia] == [opcode(i) for i in ib],
                loops=[len(la), len(lb)], same_loops=sum(x == y for x, y in zip(la, lb)),
                unmatched=[len(ia) - matched, len(ib) - matched],
                more_in_a=dict(ops_a - ops_b), more_in_b=dict(ops_b - ops_a))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 3 or not all("=" in p for p in argv[2:]):
        raise SystemExit(__doc__)
    funcs_a, funcs_b = listings(argv[0]), listings(argv[1])
    res = {}
    for pair in argv[2:]:
        pa, pb = pair.split("=", 1)
        r = res[pair] = compare(one(funcs_a, pa), one(funcs_b, pb))
        print(f"{pa} -> {pb}: {r['insts'][0]} / {r['insts'][1]} instructions, opcodes "
              f"{'the same' if r['same_opcodes'] else 'differ'}, {r['same_loops']} of "
              f"{r['loops'][0]} / {r['loops'][1]} loops the same, unmatched {r['unmatched'][0]} "
              f"/ {r['unmatched'][1]} (constant-bank operands masked); more in A "
              f"{r['more_in_a']}, more in B {r['more_in_b']}")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
