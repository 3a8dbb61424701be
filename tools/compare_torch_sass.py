#!/usr/bin/env python3
"""Compare the machine code (SASS) of kernel sources between two checkouts.

    python3 tools/compare_torch_sass.py PARENT_ROOT ROOT [STEM ...]

For each `rt_depth_map_tpu_torch/csrc/<STEM>.cu` (default: every source of
ROOT), both checkouts' copies are compiled for sm_90a with nvcc's `-cubin`
(the flags of `ops/cuda/_build.py`, one nvcc each, all at once, into
`build/sass/`), disassembled with `cuobjdump -sass`, and each function's
instructions compared with their addresses and encodings stripped. One
line a source: the kernels in each, and how many of PARENT_ROOT's function
bodies appear unchanged in ROOT's, which shows whether a change left a
kernel's code as it was even where its template arguments (and so its
name) grew. Needs the CUDA toolkit (run it on the card's machine).
"""

from __future__ import annotations

import hashlib
import subprocess
import sys
from pathlib import Path


def _bodies(cubin: Path, objdump: str) -> dict:
    """{function name: its instructions, one a line}."""
    txt = subprocess.run([objdump, "-sass", str(cubin)], capture_output=True,
                         text=True, check=True).stdout
    funcs, cur, name = {}, [], None
    for ln in txt.splitlines():
        if "Function : " in ln:
            if name:
                funcs[name] = "\n".join(cur)
            name, cur = ln.split("Function : ")[1].strip(), []
        elif name and ln.strip().startswith("/*") and "*/" in ln:
            cur.append(ln.split("*/", 1)[1].split("/*")[0].strip())
    if name:
        funcs[name] = "\n".join(cur)
    return funcs


def main(argv) -> int:
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    parent, root = Path(argv[0]).resolve(), Path(argv[1]).resolve()
    sys.path.insert(0, str(root))
    from rt_depth_map_tpu_torch.ops.cuda import _build

    nvcc = _build._nvcc()
    objdump = str(Path(nvcc).with_name("cuobjdump"))
    stems = argv[2:] or sorted(p.stem for p in (root / "rt_depth_map_tpu_torch"
                                                 / "csrc").glob("*.cu"))
    out = root / "build" / "sass"
    out.mkdir(parents=True, exist_ok=True)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler",
                                                        "-fPIC")]
    procs = []
    for side, tree in (("parent", parent), ("change", root)):
        for stem in stems:
            src = tree / "rt_depth_map_tpu_torch" / "csrc" / f"{stem}.cu"
            cubin = out / f"{side}-{stem}.cubin"
            procs.append(subprocess.Popen(
                [nvcc, *flags, "-cubin", "-o", str(cubin), str(src)],
                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True))
    for p in procs:
        _, err = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed: {err[-2000:]}")
    for stem in stems:
        p = _bodies(out / f"parent-{stem}.cubin", objdump)
        c = _bodies(out / f"change-{stem}.cubin", objdump)

        def digests(funcs):
            return {hashlib.sha1(b.encode()).hexdigest() for b in funcs.values()}

        same = len(digests(p) & digests(c))
        print(f"sass {stem}: parent {len(p)} kernels, change {len(c)}; parent "
              f"bodies unchanged in the change: {same} of {len(digests(p))}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
