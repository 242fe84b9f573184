"""Compare two builds of one CUDA source kernel by kernel: registers, SASS
instruction count, and whether the machine code is the same.

A change to a template that several kernels share can leave some of them
untouched or not; this shows which, so a time that moves is traced to code
that moved (or shown not to be). Each source is compiled as `cuda_build`
compiles it (same nvcc flags, to a cubin), then `cuobjdump -sass` is split
per kernel; two kernels match when their instructions match with addresses
and encodings stripped.

    python -m april_asr_tpu_torch.tools.sass_diff OLD.cu NEW.cu [--kernel lstm_rec_kernel]

Needs `nvcc` and `cuobjdump` (the CUDA toolkit); no card.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List

from ..ops import cuda_build

_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_REGS = re.compile(r"Used (\d+) registers")
_FUNC = re.compile(r"^\s*Function : (\w+)")
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;?\s*/\*")


def ptxas_registers(log: str) -> Dict[str, int]:
    """{mangled kernel: registers} from `-Xptxas -v` output."""
    regs, entry = {}, None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            entry = m.group(1)
        m = _REGS.search(line)
        if m and entry:
            regs[entry] = int(m.group(1))
            entry = None
    return regs


def sass_functions(dump: str) -> Dict[str, List[str]]:
    """{mangled kernel: its instructions} from `cuobjdump -sass`, each
    instruction without its address or encoding."""
    funcs, cur = {}, None
    for line in dump.splitlines():
        m = _FUNC.match(line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = _INSN.search(line)
        if m and cur is not None:
            cur.append(m.group(1))
    return funcs


def ptxas_properties(log: str) -> Dict[str, str]:
    """{mangled kernel: its registers, shared memory and spills} from
    `-Xptxas -v` output, as ptxas words them."""
    props, entry = {}, None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            entry = m.group(1)
            props[entry] = ""
        elif entry and ("spill" in line or "Used" in line):
            text = line.split(":", 1)[-1].strip() if "Used" in line else line.strip()
            props[entry] = f"{props[entry]}; {text}" if props[entry] else text
    return props


def compile_sass(src: Path, out_dir: Path) -> tuple:
    """(ptxas -v output, {mangled kernel: instructions}) of `src` built as
    `cuda_build` builds it, to a cubin."""
    flags = [f for f in cuda_build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    cubin = out_dir / "k.cubin"
    log = subprocess.run([cuda_build._nvcc(), *flags, "-cubin", "-Xptxas", "-v", "-o", str(cubin),
                          str(src)], capture_output=True, text=True, check=True)
    cuobjdump = str(Path(cuda_build._nvcc()).parent / "cuobjdump")  # nvcc's toolkit
    dump = subprocess.run([cuobjdump, "-sass", str(cubin)], capture_output=True, text=True,
                          check=True).stdout
    return log.stdout + log.stderr, sass_functions(dump)


def build(src: Path, out_dir: Path) -> tuple:
    log, funcs = compile_sass(src, out_dir)
    return ptxas_registers(log), funcs


def compare(old: tuple, new: tuple, kernel: str = "") -> List[dict]:
    """One row per kernel named in either build (and containing `kernel`)."""
    (r_old, f_old), (r_new, f_new) = old, new
    rows = []
    for name in sorted(set(f_old) | set(f_new)):
        if kernel not in name:
            continue
        a, b = f_old.get(name), f_new.get(name)
        rows.append({"kernel": name, "regs": (r_old.get(name), r_new.get(name)),
                     "insns": (len(a) if a else None, len(b) if b else None),
                     "same": a is not None and a == b})
    return rows


def main(argv=None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old", type=Path)
    ap.add_argument("new", type=Path)
    ap.add_argument("--kernel", default="", help="only kernels whose mangled name holds this")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as a, tempfile.TemporaryDirectory() as b:
        rows = compare(build(args.old, Path(a)), build(args.new, Path(b)), args.kernel)
    for r in rows:
        print(f"{r['kernel'][:48]}: registers {r['regs'][0]} -> {r['regs'][1]}, "
              f"instructions {r['insns'][0]} -> {r['insns'][1]}, "
              f"SASS {'same' if r['same'] else 'differs'}")
    return rows


if __name__ == "__main__":
    main()
