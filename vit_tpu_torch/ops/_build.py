"""Build the hand-written CUDA kernels and bind them with ``ctypes``.

Every ``*.cu`` under ``vit_tpu_torch/csrc`` is compiled by ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface, at first use,
into ``build/kernels/`` at the root of the checkout (git-ignored; set
``VIT_TPU_TORCH_BUILD_DIR`` to build elsewhere).  The library's file name
carries a hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads the existing library.  Only the sources in the checkout are
used; a failed build raises with nvcc's output.

Nothing here runs at import time: this module imports without ``nvcc``, CUDA
or a card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
DEFAULT_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# dtype codes of csrc/kernels.cuh (vit::DType).
DTYPE_CODES = {torch.bfloat16: 0, torch.float16: 1}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# C signatures of the entry points (argtypes, restype).
SIGNATURES = {
    "vit_fused_attention_block_fwd": (
        # x, gamma, beta, wqkv, wo, bo, y, xn, qkv, oattn,
        [_P] * 10
        # b, n, d, heads, dim_head, scale, eps, dtype, stream
        + [_I, _I, _I, _I, _I, _F, _F, _I, _P],
        ctypes.c_int,
    ),
    "vit_fused_mlp_fwd": (
        # x, gamma, beta, w1, b1, w2, b2, y, xn, h,
        [_P] * 10
        # rows, d, hidden, eps, dtype, stream
        + [_I, _I, _I, _F, _I, _P],
        ctypes.c_int,
    ),
    "vit_error_string": ([_I], ctypes.c_char_p),
}


def sources() -> list[Path]:
    """The CUDA translation units that make up the library."""
    return sorted(CSRC_DIR.glob("*.cu"))


def source_hash() -> str:
    """Hash of every source and header plus the compiler flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return Path(os.environ.get("VIT_TPU_TORCH_BUILD_DIR", DEFAULT_BUILD_DIR))


def library_path() -> Path:
    return build_dir() / f"libvit_kernels_{source_hash()}.so"


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for cand in candidates:
        if cand.is_file():
            return str(cand)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, on PATH and in "
        "/usr/local/cuda/bin); the CUDA kernels cannot be built")


def build() -> tuple[Path, str]:
    """Compile the library if it is not built yet; return (path, nvcc log).

    The log holds ptxas's register and shared-memory report of a fresh build,
    and is empty when the library already existed.
    """
    out = library_path()
    if out.is_file():
        return out, ""
    out.parent.mkdir(parents=True, exist_ok=True)
    # Build under a temporary name and rename, so that a concurrent process
    # never loads a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        Path(tmp).unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


@functools.cache
def load() -> ctypes.CDLL:
    """Build if needed, load the library and declare its C signatures."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def check(err: int, what: str) -> None:
    """Raise if an entry point returned a CUDA error (a refused launch is
    reported only this way: it never runs, and a later synchronise is silent)."""
    if err != 0:
        msg = load().vit_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")
