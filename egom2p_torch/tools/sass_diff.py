#!/usr/bin/env python3
"""Compare the SASS of the attention kernels' head_dim-64 instances between
two checkouts whose kernel libraries are built (run `kernel_bench.py` or
`chip_smoke.py` once in each first).

    python3 egom2p_torch/tools/sass_diff.py ROOT_A ROOT_B

Instances are matched by kernel name and their boolean template arguments
(a leading head-width argument of 64 is dropped, so an instance of a
template that gained a head-width parameter matches its old self).  Each
instruction is compared without its address, its encoding, its constant-bank
offsets (which move when a kernel gains parameters) and branch targets.
Prints one line per instance: instruction counts and whether the sequences
are equal.  Needs cuobjdump (CUDA_HOME or /usr/local/cuda).
"""
import os
import re
import subprocess
import sys
from pathlib import Path

# a kernel's name and template arguments in its mangled name (the anonymous
# namespace before it holds the file's name, flash64_fwd_cu_...)
NAME = re.compile(r"(flash64_(?:fwd|dq|dkv)_kernel)I((?:L[ib]\d+E)+)E")


def library(root: str) -> Path:
    found = sorted((Path(root) / "egom2p_torch" / "build").glob("libegom2p_kernels_*.so"))
    if not found:
        raise SystemExit(f"no kernel library under {root}/egom2p_torch/build: build it first")
    return found[-1]


def parse(sass: str):
    """{(kernel, bool args): [normalised instruction]} of the 64-wide
    instances in cuobjdump's text."""
    out, key = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = NAME.search(line)
            key = None
            if m:
                args = re.findall(r"L([ib])(\d+)E", m.group(2))
                if args and args[0][0] == "i":
                    if args[0][1] != "64":
                        continue  # another head width
                    args = args[1:]
                key = (m.group(1), tuple(v for _, v in args))
                out[key] = []
        elif key is not None and "*/" in line and ";" in line:
            ins = line.split("*/", 1)[1].split(";", 1)[0].strip()
            ins = re.sub(r"c\[0x[0-9a-f]+\]\[0x[0-9a-f]+\]", "c[P]", ins)
            out[key].append(re.sub(r"0x[0-9a-f]+", "N", ins))
    return out


def instances(so: Path):
    cuobjdump = Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda") / "bin" / "cuobjdump"
    return parse(subprocess.run([str(cuobjdump), "-sass", str(so)], capture_output=True,
                                text=True, check=True).stdout)


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__)
        return 2
    a, b = (instances(library(root)) for root in sys.argv[1:])
    same = 0
    for key in sorted(set(a) | set(b)):
        sa, sb = a.get(key), b.get(key)
        equal = sa is not None and sa == sb
        same += equal
        first = ""
        if not equal and sa is not None and sb is not None:
            i = next((i for i, (x, y) in enumerate(zip(sa, sb)) if x != y), min(len(sa), len(sb)))
            first = f" from instruction {i}: {sa[i:i + 1]} / {sb[i:i + 1]}"
        print(f"{key[0]}<{', '.join(key[1])}>: {len(sa or [])} / {len(sb or [])} instructions, "
              f"{'equal' if equal else 'different'}{first}")
    print(f"{same} of {len(set(a) | set(b))} head_dim-64 instances have equal SASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
