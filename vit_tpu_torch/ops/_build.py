"""Build the hand-written CUDA kernels and bind them with ``ctypes``.

Every ``*.cu`` under ``vit_tpu_torch/csrc`` is compiled by ``nvcc`` for
``sm_90a``, one process per source, all started together, and linked into one
shared library with a plain C interface, at first use, into
``build/kernels/`` at the root of the checkout (git-ignored; set
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

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# dtype codes of csrc/kernels.cuh (vit::DType).
DTYPE_CODES = {torch.bfloat16: 0, torch.float16: 1}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LL = ctypes.POINTER(ctypes.c_longlong)  # a host array of 64-bit strides

# C signatures of the entry points (argtypes, restype).
SIGNATURES = {
    "vit_fused_attention_block_fwd": (
        # x, gamma, beta, wqkv, wo, bo, y, xn, qkv, oattn, lse (or null),
        # strides (q, k, v, out: batch, head, row), route (0 short, 1 mha),
        # bias (or null), hb,
        [_P] * 11 + [_LL, _I] + [_P, _I]
        # b, n, d, heads, dim_head, scale, eps, dtype, stream
        + [_I, _I, _I, _I, _I, _F, _F, _I, _P],
        ctypes.c_int,
    ),
    "vit_fused_attention_block_bwd": (
        # dy, x, qkv, oattn, lse, gamma, wqkv, wo, dx, dqkv, sums_d, doattn,
        # strides (q, k, v, out, dout, dq, dk, dv: batch, head, row), route
        # (0 short, 1 mha), dq_part, dsum and rowstat (or null), dxn, stats,
        # part_d, bias (or null), hb, dbias and dbias_part (or null),
        [_P] * 12 + [_LL, _I] + [_P] * 6 + [_P, _I, _P, _P]
        # b, n, d, heads, dim_head, scale, eps, dtype, stream
        + [_I, _I, _I, _I, _I, _F, _F, _I, _P],
        ctypes.c_int,
    ),
    "vit_fused_mlp_fwd": (
        # x, gamma, beta, w1, b1, w2, b2, y, xn, g, h (null when serving),
        [_P] * 11
        # rows, d, hidden, eps, dtype, stream
        + [_I, _I, _I, _F, _I, _P],
        ctypes.c_int,
    ),
    "vit_fused_mlp_bwd": (
        # dy, x, h, gamma, w1, w2, dx, dh, gact, sums_h, sums_d, dxn, stats,
        # part_h, part_d,
        [_P] * 15
        # rows, d, hidden, eps, dtype, stream
        + [_I, _I, _I, _F, _I, _P],
        ctypes.c_int,
    ),
    # The split forms (tensor parallelism): each stops at an f32 partial sum
    # that the model ranks add up before the pass that ends the block.
    "vit_fused_attention_block_fwd_partial": (
        # x, gamma, beta, wqkv, wo, s (f32), xn, qkv, oattn, lse (or null),
        # strides (q, k, v, out: batch, head, row), route (0 short, 1 mha),
        # bias (or null), hb,
        [_P] * 10 + [_LL, _I] + [_P, _I]
        # b, n, d, heads, dim_head, scale, eps, dtype, stream
        + [_I, _I, _I, _I, _I, _F, _F, _I, _P],
        ctypes.c_int,
    ),
    "vit_fused_attention_block_bwd_partial": (
        # dy, qkv, oattn, lse, wqkv, wo, dqkv, doattn, dxn (f32), strides (q,
        # k, v, out, dout, dq, dk, dv: batch, head, row), route, dq_part, dsum
        # and rowstat (or null), bias (or null), hb, dbias and dbias_part (or
        # null),
        [_P] * 9 + [_LL, _I] + [_P] * 3 + [_P, _I, _P, _P]
        # b, n, d, heads, dim_head, scale, dtype, stream
        + [_I, _I, _I, _I, _I, _F, _I, _P],
        ctypes.c_int,
    ),
    "vit_fused_mlp_fwd_partial": (
        # x, gamma, beta, w1, b1, w2, s (f32), xn, g, h (null when serving),
        [_P] * 10
        # rows, d, hidden, eps, dtype, stream
        + [_I, _I, _I, _F, _I, _P],
        ctypes.c_int,
    ),
    "vit_fused_mlp_bwd_partial": (
        # dy, h, w1, w2, dh, gact, sums_h, dxn (f32), part_h,
        [_P] * 9
        # rows, d, hidden, dtype, stream
        + [_I, _I, _I, _I, _P],
        ctypes.c_int,
    ),
    # y = T(x + T(s + b)) over a split block's summed f32 partials: s, b, x, y,
    # rows, d, dtype, stream.
    "vit_bias_residual": ([_P] * 4 + [_I, _I, _I, _P], ctypes.c_int),
    # The LayerNorm backward with its residual from an f32 dxn: x, dxn, gamma,
    # dy, dx, stats, partial, sums, rows, d, eps, dtype, stream.
    "vit_ln_bwd": ([_P] * 8 + [_I, _I, _F, _I, _P], ctypes.c_int),
    "vit_fused_mlp_fwd_ragged": (
        # x, gamma_p, beta_p, w1_p, b1_p, w2_p, b2_p, y, xn, xp, g, h (null when
        # serving), yp,
        [_P] * 13
        # rows, d, dp, hp, eps, dtype, stream
        + [_I, _I, _I, _I, _F, _I, _P],
        ctypes.c_int,
    ),
    "vit_fused_mlp_bwd_ragged": (
        # dy, x, h, gamma_p, w1_p, w2_p, dx, dh, gact, sums_h, sums_d, dxn, stats,
        # part_h, part_d, dyp,
        [_P] * 16
        # rows, d, dp, hp, eps, dtype, stream
        + [_I, _I, _I, _I, _F, _I, _P],
        ctypes.c_int,
    ),
    "vit_flash_attention_fwd": (
        # q, k, v, out, lse, strides (q, k, v, out: batch, head, row),
        [_P] * 5 + [_LL]
        # b, heads, n_q, n_k, dk, dv, scale, dtype, stream
        + [_I] * 6 + [_F, _I, _P],
        ctypes.c_int,
    ),
    "vit_flash_attention_bwd": (
        # q, k, v, out, lse, dout, dq, dk, dv, dsum, strides (q, k, v, out,
        # dout, dq, dk, dv: batch, head, row),
        [_P] * 10 + [_LL]
        # b, heads, n_q, n_k, dk, dv, scale, dtype, stream
        + [_I] * 6 + [_F, _I, _P],
        ctypes.c_int,
    ),
    "vit_fused_cross_attention_fwd": (
        # x, xn, wq, k, v, wo, bo, y, q, oattn and lse (q and lse null when
        # serving, oattn too on route 1 of vit_fused_cross_attention_fused),
        [_P] * 11
        # b, n, n_k, c, heads, dh_k, dh_v, scale, dtype, stream
        + [_I] * 7 + [_F, _I, _P],
        ctypes.c_int,
    ),
    "vit_fused_cross_attention_bwd": (
        # dy, q, k, v, oattn, lse, wq, wo, dxn, dq, dk, dv, dbo, scratch,
        [_P] * 14
        # b, n, n_k, c, heads, dh_k, dh_v, scale, route asked for, dtype, stream
        + [_I] * 7 + [_F, _I, _I, _P],
        ctypes.c_int,
    ),
    # The cross-attention block's split form: xn, wq, k, v, wo, s (f32), q,
    # oattn, lse (q and lse null when serving a shape of route 2),
    "vit_fused_cross_attention_fwd_partial": (
        [_P] * 9
        # b, n, n_k, c, heads, dh_k, dh_v, scale, dtype, stream
        + [_I] * 7 + [_F, _I, _P],
        ctypes.c_int,
    ),
    # dy, q, k, v, oattn, lse, wq, wo, dxn (f32), dq, dk, dv, dbo, scratch;
    # b, n, n_k, c, heads, dh_k, dh_v, scale, route asked for, dtype, stream.
    "vit_fused_cross_attention_bwd_partial": (
        [_P] * 14 + [_I] * 7 + [_F, _I, _I, _P],
        ctypes.c_int,
    ),
    "vit_short_attention_fwd": (
        # q, k, v, out, lse (or null), strides (q, k, v, out: batch, head, row),
        [_P] * 5 + [_LL]
        # b, heads, n_q, n_k, d, scale, dtype, stream
        + [_I] * 5 + [_F, _I, _P],
        ctypes.c_int,
    ),
    "vit_short_attention_bwd": (
        # q, k, v, out, lse, dout, dq, dk, dv, dq_part (or null), strides (q,
        # k, v, out, dout, dq, dk, dv: batch, head, row),
        [_P] * 10 + [_LL]
        # b, heads, n_q, n_k, d, scale, dtype, stream
        + [_I] * 5 + [_F, _I, _P],
        ctypes.c_int,
    ),
    "vit_ln_gemm_fwd": (
        # x, gamma, beta, w, out, xn, rows, d, n_out, eps, dtype, stream
        [_P] * 6 + [_I] * 3 + [_F, _I, _P],
        ctypes.c_int,
    ),
    "vit_ln_gemm_bwd": (
        # dout, x, gamma, w, dx, sums, dxn, stats, part, rows, d, n_out, eps,
        # dtype, stream
        [_P] * 9 + [_I] * 3 + [_F, _I, _P],
        ctypes.c_int,
    ),
    "vit_gemm": (
        # a, w, layout, bias, res, aux_in, out, aux, partial, sums (each or
        # null), rows, n, k, epilogue, kernel, dtype, stream
        [_P, _P, _I] + [_P] * 7 + [_I] * 6 + [_P],
        ctypes.c_int,
    ),
    "vit_gemm_ln_bwd": (
        # a, w, x, gamma, dy (or null), dx, partial, sums, rows, d, k, eps,
        # dtype, stream
        [_P] * 8 + [_I] * 3 + [_F, _I, _P],
        ctypes.c_int,
    ),
    # 1 where the blocks' backwards take the LayerNorm-backward dgrad at width
    # d, 0 where they keep the f32 dxn and the LayerNorm backward's passes.
    "vit_ln_bwd_fused": ([_I], ctypes.c_int),
    # The clusters of d / 256 CTAs the LayerNorm-backward dgrad runs at once.
    "vit_ln_bwd_clusters": ([_I], ctypes.c_int),
    # The launches of one kind counted where the library makes them, since
    # the last take of that kind (csrc/kernels.cuh Counted), set back to 0.
    "vit_take_launch_count": ([_I], ctypes.c_longlong),
    "vit_proj_mlp_fwd": (
        # x, o, wo, bo, gamma, beta, w1, b1, w2, b2, z, y, xn, g, h (null when
        # serving), rows, d, inner, hidden, eps, dtype, stream
        [_P] * 15 + [_I] * 4 + [_F, _I, _P],
        ctypes.c_int,
    ),
    "vit_proj_mlp_bwd": (
        # dz, y, h, gamma, wo, w1, w2, dy, do, dh, gact, sums_h, sums_d, dbo,
        # dxn, stats, part_h, part_d, rows, d, inner, hidden, eps, dtype, stream
        [_P] * 18 + [_I] * 4 + [_F, _I, _P],
        ctypes.c_int,
    ),
    # The cross-attention forward's route at (b, n, n_k, c, heads, dh_k, dh_v):
    # 1 the one cross_fwd kernel, 2 cross_fwd and a GEMM for y, 0 three launches.
    "vit_fused_cross_attention_fused": ([_I] * 7, ctypes.c_int),
    "vit_fused_cross_attention_partial_route": ([_I] * 7, ctypes.c_int),
    # The cross-attention backward's route at (b, n, n_k, c, heads, dh_k, dh_v)
    # given the route asked for (-1: the shape's own): 1 one cross_bwd kernel
    # and its reduction, 2 cross_bwd between two GEMMs, 0 four steps, -1 not
    # at this shape; and the bytes of its one scratch buffer.
    "vit_fused_cross_attention_bwd_route": ([_I] * 8, ctypes.c_int),
    "vit_fused_cross_attention_bwd_scratch": ([_I] * 8, ctypes.c_longlong),
    # Key blocks of the short-attention backward at n_k keys and width d (its
    # dq_part).
    "vit_short_attention_parts": ([_I, _I], ctypes.c_int),
    # Rows of the f32 column partial sums the backward entry points take for
    # `rows` rows: part_h (the dGELU GEMM's) and part_d (the LayerNorm
    # backward's).
    "vit_linear_partial_rows": ([_I], ctypes.c_int),
    "vit_ln_bwd_partial_rows": ([_I], ctypes.c_int),
    # Parts of the dbias scratch for (b, n, heads, hb).
    "vit_attention_dbias_parts": ([_I] * 4, ctypes.c_int),
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
    nvcc = find_nvcc()
    # Objects and the library are built in a private directory and the
    # library renamed into place, so that a concurrent process never loads a
    # half-written one.
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        jobs = []
        for src in sources():
            obj = Path(tmp) / f"{src.stem}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for cmd, _, proc in jobs:
            log = proc.communicate()[0]
            logs.append(log)
            if proc.returncode != 0:
                failed.append(f"nvcc failed (exit {proc.returncode}):\n"
                              f"{' '.join(cmd)}\n{log}")
        if failed:
            raise RuntimeError("\n".join(failed))
        lib = Path(tmp) / out.name
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(lib),
               *(str(obj) for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed (exit {proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(lib, out)
    return out, "".join(logs)


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
