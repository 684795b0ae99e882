"""Build the CUDA kernels of ``csrc/`` at first use, load them, and
check what their wrappers pass in.

``nvcc`` compiles each source into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), which is
loaded with ``ctypes``. The library goes to ``build/repro_torch_kernels/``
at the root of the checkout, named by a hash of its source and of the
shared headers ``csrc/*.cuh``, so an edited source is rebuilt and an
unchanged one is reused. Nothing here runs on
import: the CPU tests import every module of the package.

The flags never include ``--use_fast_math``: its approximate division
and FMA contraction would change the routing capacities.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit")


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library of the same source is
    already built (the digest covers the shared headers ``csrc/*.cuh``
    too). Returns the library's path; the compiler's report (registers,
    shared memory, spills) is kept beside it as ``.log``."""
    src = CSRC / f"{name}.cu"
    text = src.read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(text
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and load it."""
    return ctypes.CDLL(str(build(name)))


# ctypes types of the launchers' arguments: c_void_p for pointers and the
# stream, or ctypes would cut them to 32-bit ints
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def check(t: torch.Tensor, name: str, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {dtype} tensor of "
                         f"shape {tuple(shape)} on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def device_scalar(x, dtype, device) -> torch.Tensor:
    """A 0-dim device tensor the kernel reads through a pointer (no
    host sync when ``x`` already is one)."""
    if isinstance(x, torch.Tensor):
        if x.numel() != 1 or x.device != device:
            raise ValueError(f"expected a scalar on {device}, got shape "
                             f"{tuple(x.shape)} on {x.device}")
        return x.reshape(()).to(dtype).contiguous()
    return torch.full((), x, dtype=dtype, device=device)


def raise_on(err: int, name: str):
    if err:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
