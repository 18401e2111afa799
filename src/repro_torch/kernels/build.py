"""Build and load the hand-written CUDA kernels of ``repro_torch/csrc``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``. The
build runs at first use, all sources at once (one ``nvcc`` each, in
parallel), into ``build/repro_torch/<digest>/`` under the repository
root, where the digest covers the sources and the flags — an edited
source gets a fresh directory. A failed build raises; nothing falls
back to the plain versions.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
KERNEL_SOURCES = ("qmatmul", "decode_attention", "flash_attention",
                  "flash_attention_bwd", "quantize")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# dtype codes shared with csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1,
               torch.float8_e4m3fn: 2}


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the one on PATH."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put the CUDA "
                           "toolkit's bin/ on PATH to build the kernels")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> Path:
    """Compile every kernel source not yet built for the current sources
    (all ``nvcc`` processes started together) and return the build
    directory. Each compiler's output, including ``-Xptxas -v``'s
    register and shared-memory report, is kept as ``<name>.log``."""
    out_dir = BUILD_ROOT / _digest()
    todo = [n for n in KERNEL_SOURCES
            if not (out_dir / f"lib{n}.so").exists()]
    if not todo:
        return out_dir
    out_dir.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    procs = {}
    for name in todo:
        tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
        procs[name] = (tmp, subprocess.Popen(
            [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        (out_dir / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name} (rc {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out_dir / f"lib{name}.so")
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return out_dir


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel source ``name`` (built on first
    use)."""
    return ctypes.CDLL(str(build_all() / f"lib{name}.so"))


@functools.cache
def launcher(lib_name: str, fn_name: str, signature: str):
    """The C launch function ``fn_name`` of library ``lib_name`` with its
    ctypes argument types spelled one letter each — ``p`` pointer (the
    stream included), ``i`` int, ``l`` 64-bit int, ``f`` float; it
    returns a cudaError_t.
    Pointers must be declared: undeclared, ctypes cuts them to 32 bits."""
    fn = getattr(library(lib_name), fn_name)
    kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int, "l": ctypes.c_longlong,
             "f": ctypes.c_float}
    fn.argtypes = [kinds[c] for c in signature]
    fn.restype = ctypes.c_int
    return fn


def check(rc: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError_t {rc}")


def stream_handle(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as a raw pointer."""
    return torch.cuda.current_stream(t.device).cuda_stream
