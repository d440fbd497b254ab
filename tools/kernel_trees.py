"""Build the port's kernels from several source trees, time them and read
their SASS: the shared part of ``fft_core_bench.py``,
``compress_kernels_bench.py``, ``range_quant_bench.py`` and
``sass_compare.py``.

A tree is a directory holding ``csrc`` sources and their headers:
``src/repro_torch/kernels/csrc``, or that directory of an earlier commit
unpacked with ``git archive`` into a directory that ``.gitignore`` lists
(``build/``).
"""

from __future__ import annotations

import ctypes
import re
import subprocess
from pathlib import Path

import torch


def ptxas_kernels(text):
    """[(mangled kernel name, registers, spill bytes)] of ``nvcc -Xptxas -v``
    output, kernel by kernel."""
    parts = re.split(r"Compiling entry function '(\S+)'", text)[1:]
    return [(name, int(re.search(r"Used (\d+) registers", info).group(1)),
             sum(int(v) for v in re.findall(r"(\d+) bytes spill", info)))
            for name, info in zip(parts[::2], parts[1::2])]


def build_all(trees, sources, out_dir, extra_flags=()):
    """One nvcc per (tree, source), all at once, with the port's flags and
    ``extra_flags``, into ``out_dir/<name>/``; prints each kernel's
    registers and spill bytes as ptxas reports them.  ``trees`` maps a name
    to a directory.  Returns {name: {source: CDLL}}."""
    from repro_torch.kernels.build import NVCC_FLAGS, nvcc_path

    jobs = []
    for name, src in trees.items():
        (Path(out_dir) / name).mkdir(parents=True, exist_ok=True)
        for source in sources:
            target = Path(out_dir) / name / source.replace(".cu", ".so")
            cmd = [nvcc_path(), *NVCC_FLAGS, *extra_flags, "-o", str(target),
                   str(Path(src) / source)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)
            jobs.append((name, source, target, proc))
    libs = {}
    for name, source, target, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode:
            print(out)
            raise SystemExit(f"{name}/{source}: nvcc failed")
        for kernel, regs, spill in ptxas_kernels(out):
            print(f"[ptxas {name}/{source}] {kernel}: {regs} registers, {spill} bytes spill")
        libs.setdefault(name, {})[source] = ctypes.CDLL(str(target))
    return libs


def library_path(out_dir, name, source):
    """Where :func:`build_all` put ``source`` of tree ``name``."""
    return Path(out_dir) / name / source.replace(".cu", ".so")


def sass(lib):
    """{demangled kernel name: [(address, SASS instruction)]} of a built
    library, as ``cuobjdump -sass`` prints them (no encodings), named by
    :func:`_kernel_name`, so a kernel that gained a trailing ``bool`` mode
    keeps its name in the ``false`` mode."""
    from repro_torch.kernels.build import nvcc_path

    bin_dir = Path(nvcc_path()).parent
    text = subprocess.run([str(bin_dir / "cuobjdump"), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    kernels, current = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            current = kernels.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s*(.*?)\s*;", line)
        if m and current is not None:
            current.append((int(m.group(1), 16), m.group(2)))
    names = subprocess.run([str(bin_dir / "cu++filt")], input="\n".join(kernels),
                           capture_output=True, text=True, check=True).stdout.splitlines()
    return {_kernel_name(name): kernels[mangled] for mangled, name in zip(kernels, names)}


def _kernel_name(demangled):
    """A demangled name without its parameter list (the last balanced
    parentheses) and with a last template argument false or (bool)0 dropped."""
    depth, cut = 0, len(demangled)
    for i in range(len(demangled) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(demangled[i], 0)
        if depth == 0 and demangled[i] == "(":
            cut = i
            break
    return re.sub(r", (false|\(bool\)0)>$", ">", demangled[:cut].strip())


def time_ms(fn, iters):
    """Mean device time (ms, CUDA events) of ``iters`` calls after one."""
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


_STORE_BYTES = {".128": 16, ".64": 8, ".U8": 1, ".S8": 1, ".U16": 2, ".S16": 2}


def _opcode(ins):
    """An instruction's opcode with its modifiers, past any predicate."""
    words = ins.split()
    return words[1] if words[0].startswith("@") and len(words) > 1 else words[0]


def loop_per_value(code, out_bytes):
    """(instructions, values, nested) of a kernel's storing loop, from
    :func:`sass`'s list: the innermost backward branch whose body holds
    global stores (STG), its instructions less those of loops nested in it
    (a rarely taken inner loop), and the values one pass stores (store
    bytes / ``out_bytes`` per value).  None when no loop stores."""
    index = {a: i for i, (a, _) in enumerate(code)}
    loops = []
    for i, (_, ins) in enumerate(code):
        m = re.search(r"\bBRA\s+(0x[0-9a-f]+)", ins)
        if m and int(m.group(1), 16) in index and index[int(m.group(1), 16)] <= i:
            loops.append((index[int(m.group(1), 16)], i))
    best = None
    for lo, hi in loops:
        stores = [op for op in (_opcode(ins) for _, ins in code[lo:hi + 1])
                  if op.split(".")[0] == "STG"]
        if stores and (best is None or hi - lo < best[1] - best[0]):
            n_bytes = sum(next((v for k, v in _STORE_BYTES.items() if op.endswith(k)), 4)
                          for op in stores)
            nested = sum(h - l + 1 for l, h in loops if lo < l and h < hi)
            best = (lo, hi, n_bytes / out_bytes, nested)
    if best is None:
        return None
    lo, hi, values, nested = best
    return hi - lo + 1 - nested, values, nested
