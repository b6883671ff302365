#!/usr/bin/env python3
"""Compare the machine code (SASS) of the port's kernels between two
checkouts: whether a change to a shared header left the kernels it was
not meant to touch compiled to the same instructions.

    python3 scripts/sass_compare.py --root _parent --root . [--all]

Each --root builds its own kernel library (ops/_build.py, in its own
tree) in a process of its own; `cuobjdump -sass` lists every __global__
function. A function is keyed by its name and template arguments, with
the flags its template gained for fast mode and the shallow-water bf16
product store taken off (FAST on ka_fields_kernel, kb_pair_kernel,
kb_adv_kernel, kx_visc_kernel, ka_sw_kernel, ky_all_kernel,
ky_adv_kernel, kb_adv_tracer_kernel, kb_kernel, kc_kernel,
ka_adv_kernel, ka_fwd_kernel, ka_kernel and xstage_kernel; BF16 on
kx_visc_kernel; the product type of sw_combine_kernel and
sw_combine_mv_kernel), and the instances with a gained flag set or a
bf16 product type (no counterpart in a checkout without them) left out.
Prints, per key, whether the instructions (encodings
included) are identical in the two checkouts; exits non-zero if any
differs or is missing in the second; one only in the second (a kernel
the change adds) is listed as new. --all compares every instance by its
full template arguments, the fast and bf16 ones too (for a change that
means to leave them alone as well). --dump DIR writes the two SASS listings of
each function that differs. Needs the CUDA toolkit (nvcc, cuobjdump).
"""

from __future__ import annotations

import argparse
import difflib
import re
import shutil
import subprocess
import sys
from pathlib import Path

# the templates that gained flags (FAST, BF16) after their first form:
# the number of flags each had before (ka_fields_kernel's PSI_FIRST,
# kb_adv_kernel's FULL); every later flag is a gained one
OWN_FLAGS = {"ka_fields_kernel": 1, "kb_pair_kernel": 0, "kb_adv_kernel": 1,
             "kx_visc_kernel": 0, "ka_sw_kernel": 0, "ky_all_kernel": 0,
             "ky_adv_kernel": 0, "kb_adv_tracer_kernel": 0, "kb_kernel": 0,
             "kc_kernel": 0, "ka_adv_kernel": 0, "ka_fwd_kernel": 0,
             "ka_kernel": 1, "xstage_kernel": 3}
# the templates on the product type: float (the first form) or bf16
PRODUCT_TEMPLATES = ("sw_combine_kernel", "sw_combine_mv_kernel")


def library(root: str) -> str:
    """The kernel library of the port under `root`, built in its tree."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from xlab_fftbarotropic_torch.ops import _build; "
            "print(_build.build())")
    out = subprocess.run([sys.executable, "-c", code,
                          str(Path(root).resolve())], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[-1]


def cuobjdump() -> str:
    for p in ("/usr/local/cuda/bin/cuobjdump", shutil.which("cuobjdump")):
        if p and Path(p).exists():
            return p
    sys.exit("sass_compare: cuobjdump not found")


def key(name: str, every: bool = False):
    """(kernel, template arguments) of a mangled name, the gained flags
    and the float product type taken off; None for an instance with a
    gained flag set or a bf16 product type. `every`: (kernel, all its
    template arguments), never None."""
    # the length prefix of the kernel's name may follow the digits of a
    # file hash: try every tail of every run of digits
    for m in re.finditer(r"\d+", name):
        for i in range(len(m.group())):
            base = name[m.end():m.end() + int(m.group()[i:])]
            if base[:1].isalpha() and base.endswith("_kernel"):
                break
        else:
            continue
        break
    else:
        return (name, "")
    rest = name[m.end() + len(base):]
    if every:
        t = re.match(r"I(.*?)Ev", rest)
        return (base, t.group(1) if t else "")
    if base in PRODUCT_TEMPLATES:
        return None if "bfloat16" in rest[:24] else (base, "")
    t = re.match(r"I((?:L[a-z]+n?\d+E)+)E", rest)
    flags = re.findall(r"L[a-z]+n?\d+E", t.group(1)) if t else []
    own = OWN_FLAGS.get(base, len(flags))
    if "Lb1E" in flags[own:]:
        return None
    return (base, "".join(flags[:own]))


def functions(lib: str, every: bool = False) -> dict:
    """key -> the function's SASS lines: instructions with their
    encodings (the lines that hold one), white space collapsed (its
    column widths depend on the other functions), the offset comments
    dropped and the branch labels (numbered across the whole library)
    renumbered within the function."""
    text = subprocess.run([cuobjdump(), "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for block in re.split(r"\n\s*Function : ", text)[1:]:
        name, _, body = block.partition("\n")
        k = key(name.strip(), every)
        if k is None:
            continue
        labels = {}
        lines = []
        for ln in body.splitlines():
            if "/* 0x" not in ln:
                continue
            ln = re.sub(r"\s+", " ", re.sub(r"/\*[0-9a-f]{4,}\*/", "", ln))
            lines.append(re.sub(r"\.L_x_\d+", lambda m: labels.setdefault(
                m.group(), f"L{len(labels)}"), ln.strip()))
        out[k] = lines
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", action="append", required=True)
    ap.add_argument("--dump", default=None, metavar="DIR",
                    help="write the SASS of each function that differs, "
                         "one file per checkout, into DIR")
    ap.add_argument("--all", action="store_true",
                    help="compare every instance, the fast and bf16 ones "
                         "too")
    args = ap.parse_args(argv)
    if len(args.root) != 2:
        sys.exit("sass_compare: give two --root")
    a, b = (functions(library(r), args.all) for r in args.root)
    bad = 0
    for k in sorted(set(a) | set(b)):
        if k not in b:
            state = f"only in {args.root[0]}"
            bad += 1
        elif k not in a:
            state = f"new in {args.root[1]}"
        elif a[k] == b[k]:
            state = f"identical ({len(a[k])} lines)"
        else:
            sm = difflib.SequenceMatcher(None, a[k], b[k], autojunk=False)
            same = sum(blk.size for blk in sm.get_matching_blocks())
            state = (f"DIFFERS ({len(a[k]) - same} of {len(a[k])} lines "
                     f"not in the other, {len(b[k]) - same} of "
                     f"{len(b[k])} the other way)")
            bad += 1
            if args.dump:
                Path(args.dump).mkdir(parents=True, exist_ok=True)
                for root, code in zip(args.root, (a[k], b[k])):
                    tag = Path(root).resolve().name
                    (Path(args.dump) / f"{k[0]}{k[1]}.{tag}.sass").write_text(
                        "\n".join(code) + "\n")
        print(f"{k[0]}{'<' + k[1] + '>' if k[1] else ''}: {state}")
    print(f"{len(set(a) & set(b)) - bad} of {len(set(a))} functions "
          f"identical, {len(set(b) - set(a))} new")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
