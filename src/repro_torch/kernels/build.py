"""Build, load and account for the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into its own shared library under ``build/kernels/`` at the repo
root (listed in ``.gitignore``), then loaded with ``ctypes``.  A library is
named by a hash of its sources and flags, so an edited kernel rebuilds and
an unchanged one is reused; it is written to a temporary name and renamed,
so processes that build at once never load a half-written file.

:func:`build` starts one ``nvcc`` per missing library, all at once, and
waits for them; :func:`Kernel.lib` builds a single library on first use.
Nothing is compiled or loaded when this module is imported.

Each wrapper reaches its kernel through a ``torch.library`` custom op
(:func:`kernel_op`): the op's implementation is the wrapper's body (the
plain version on a CPU tensor, the kernel on a CUDA one) and its fake
implementation gives the outputs' shapes alone, so a step traced on fake
tensors (``launch/dryrun.py``) sees each kernel as one op and never hands
``ctypes`` the null pointer of a fake tensor's ``data_ptr()``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

__all__ = ["BUILD_DIR", "CSRC", "NVCC_FLAGS", "Kernel", "KernelError", "build", "kernel_op",
           "nvcc_path", "ptr"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

# -fmad stays at nvcc's default, as in PyTorch's own CUDA build: the kernels
# that promise bitwise equality spell their arithmetic with round-to-nearest
# intrinsics, and expf/logf then compile exactly as in PyTorch's kernels.
# No --use_fast_math: it would change sqrtf, expf, logf and division.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_HEADERS = ("common.cuh", "fft4096.cuh", "range_quant.cuh", "threshold.cuh")


class KernelError(Exception):
    """A kernel that does not build, load or launch.  Deliberately not a
    ``RuntimeError``: the train loop's recovery path (rollback, retry, the
    degradation ladder) absorbs ``RuntimeError``, and a broken kernel must
    end the run at once instead of being retried or degraded around."""


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's
    default location; raises when none exists."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.exists(c):
            return c
    raise KernelError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built from csrc/ on first use")


def _library_path(source: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in (source,) + _HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build(sources: Iterable[str], log: Optional[Dict[str, str]] = None) -> Dict[str, float]:
    """Compile every library of ``sources`` that is missing, one ``nvcc``
    each, all started together.  Returns wall seconds per source built;
    ``log`` (when given) receives each compiler's output (``-Xptxas -v``
    register and shared-memory counts).  Raises on any failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    t0 = time.perf_counter()
    for source in dict.fromkeys(sources):  # one nvcc per source, however often named
        target = _library_path(source)
        if target.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[source] = (proc, tmp, target)
    seconds = {}
    failures = []
    for source, (proc, tmp, target) in jobs.items():
        output, _ = proc.communicate()
        seconds[source] = time.perf_counter() - t0
        if log is not None:
            log[source] = output
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"{source} (nvcc rc={proc.returncode}):\n{output}")
        else:
            os.replace(tmp, target)
    if failures:
        raise KernelError("kernel build failed:\n" + "\n".join(failures))
    return seconds


def kernel_op(name: str, schema: str, impl, fake):
    """``impl`` registered as the custom op ``repro_torch::<name>`` of
    ``schema`` (no argument mutated, every output a new tensor), with
    ``fake`` its shape function under a ``FakeTensorMode``."""
    import torch

    op = torch.library.custom_op(f"repro_torch::{name}", impl, mutates_args=(), schema=schema)
    op.register_fake(fake)
    return op


def ptr(t) -> ctypes.c_void_p:
    """Device pointer of a tensor for a ``c_void_p`` argument."""
    return ctypes.c_void_p(t.data_ptr())


class Kernel:
    """One hand-written kernel: its library, the TPU kernel it replaces, and
    ``launches``, a plain count its wrapper bumps at every launch."""

    def __init__(self, name: str, source: str, replaces: str, entry: str, argtypes):
        self.name = name
        self.source = source
        self.replaces = replaces
        self.entry = entry
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None
        self._lib = None

    @property
    def source_path(self) -> str:
        return f"src/repro_torch/kernels/csrc/{self.source}"

    def fn(self):
        """The loaded C entry point (builds the library on first use)."""
        if self._fn is None:
            path = _library_path(self.source)
            if not path.exists():
                build([self.source])
            lib = ctypes.CDLL(str(path))
            fn = getattr(lib, self.entry)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            self._lib, self._fn = lib, fn
        return self._fn

    def launch(self, device, *args) -> None:
        """Call the C entry on ``device`` (the tensors' card, made current for
        the call) and its current PyTorch stream (the last argument); raise
        when the launch was refused."""
        import torch

        with torch.cuda.device(device):
            stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
            err = self.fn()(*args, stream)
        if err != 0:
            msg = self._lib.repro_error_string(err).decode()
            raise KernelError(f"{self.name}: CUDA launch failed ({err}: {msg})")
        self.launches += 1
