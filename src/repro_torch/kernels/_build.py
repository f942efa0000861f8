"""Build and load the port's CUDA kernels (a plain C interface over ctypes).

Each ``csrc/<name>.cu`` compiles on first use into ``build/lib<name>.so`` at
the checkout root with::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -I csrc -o build/lib<name>.so csrc/<name>.cu

Only the sources in this package are built.  Every pointer and the stream
cross the boundary as ``ctypes.c_void_p``; each C entry returns
``cudaGetLastError()`` and :func:`check` raises when it is not 0.  Nothing
here runs at import: the tests import every module on hosts with no
``nvcc``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
SOURCES = ("pim_gemv", "splitk_gemv", "quant_gemv", "grouped_gemv",
           "triton_gemv", "decode_attention")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C signatures: (x, w_t, out, B, K, M, ld, m_blk, k_blk, stages, stream)
# for the streaming output-stationary kernel and its column-block form
# (triton_gemv), and (x, w_t, out, B, K, M, ld, deg, m_blk, k_blk, stages,
# stream) for its split-K form, beside (B, m_blk, k_blk, stages,
# elem_bytes, split_k) for the shared memory either launch takes; the
# quant form (x, codes, scales, out, B, K, M, ldw, lds, block, deg, m_blk,
# k_blk, stages, stream) beside (B, m_blk, k_blk, stages, elem_bytes,
# split_k, bits, block) for its shared memory; the expert forms (xs, w,
# out, E, C, K, M, ld, es, x_es, x_rs, m_blk, k_blk, stages, stream) and
# (x, offsets, w, out, T, K, M, ld, es, E, m_blk, k_blk, stream); ld /
# ldw / lds are row strides and es / x_es expert strides, in elements;
# and decode attention's (q, k, v, out,
# qpos, qpos_stride, qpos_bytes, vlen, vlen_stride, vlen_bytes, B, C, Hkv,
# G, D, q_sb, k_sb, k_sp, k_sh, v_sb, v_sp, v_sh, splits, scale, stream),
# its quantized-page form (q, k, v, k_scale, v_scale, out, qpos, ...,
# v_sh, ks_sb, ks_sp, ks_sh, vs_sb, vs_sp, vs_sh, bits, splits, scale,
# stream), beside (G, D, C, splits) for its shared memory.  Every entry
# returns an int (a CUDA error) unless _RESTYPES names another type.
_SIGNATURES = {
    "pim_gemv": {
        **{f"pim_gemv_{t}": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P)
           for t in ("bf16", "f32")},
        "gemv_stream_smem_bytes": (_I, _I, _I, _I, _I, _I),
    },
    "splitk_gemv": {
        f"splitk_gemv_{t}": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P)
        for t in ("bf16", "f32")
    },
    "quant_gemv": {
        **{f"{k}_{t}": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                        _I, _P)
           for k in ("quant_gemv", "quant4_gemv") for t in ("bf16", "f32")},
        "quant_gemv_smem_bytes": (_I, _I, _I, _I, _I, _I, _I, _I),
    },
    "triton_gemv": {
        f"triton_gemv_{t}": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P)
        for t in ("bf16", "f32")
    },
    "grouped_gemv": {
        **{f"grouped_gemv_{t}": (_P, _P, _P, _I, _I, _I, _I, _I, _L, _L, _L,
                                 _I, _I, _I, _P) for t in ("bf16", "f32")},
        **{f"ragged_gemv_{t}": (_P, _P, _P, _P, _I, _I, _I, _I, _L, _I, _I,
                                _I, _P) for t in ("bf16", "f32")},
    },
    "decode_attention": {
        **{f"decode_attention_{t}": (_P, _P, _P, _P, _P, _L, _I, _P, _L, _I,
                                     _I, _I, _I, _I, _I, _L, _L, _L, _L, _L,
                                     _L, _L, _I, _F, _P)
           for t in ("bf16", "f32")},
        **{f"decode_attention_quant_{t}": (_P, _P, _P, _P, _P, _P, _P, _L,
                                           _I, _P, _L, _I, _I, _I, _I, _I,
                                           _I, *(_L,) * 13, _I, _I, _F, _P)
           for t in ("bf16", "f32")},
        "decode_attention_smem_bytes": (_I, _I, _I, _I),
    },
}

_RESTYPES = {"gemv_stream_smem_bytes": _L, "quant_gemv_smem_bytes": _L,
             "decode_attention_smem_bytes": _L}

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "on this host")
    return path


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def nvcc_command(name: str, out: Path, compiler: str = "nvcc") -> list[str]:
    return [compiler, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(CSRC),
            "-o", str(out), str(CSRC / f"{name}.cu")]


def _stale(name: str) -> bool:
    lib = library_path(name)
    if not lib.exists():
        return True
    deps = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return lib.stat().st_mtime < max(p.stat().st_mtime for p in deps)


def build(names=SOURCES, *, force: bool = False) -> dict[str, dict]:
    """Compile every stale source with one ``nvcc`` each, all at once.

    Returns ``{name: {"seconds": s, "ptxas": text}}`` for the sources built
    (``ptxas`` holds the ``-Xptxas -v`` register and spill report).  Raises
    with the compiler's output when any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if force or _stale(n)]
    compiler = nvcc() if todo else ""
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        # private output name, renamed into place: concurrent builds
        # (test workers) never load a half-written library
        tmp = BUILD_DIR / f".lib{n}.{os.getpid()}.so"
        procs[n] = (tmp, subprocess.Popen(
            nvcc_command(n, tmp, compiler), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    report, failed = {}, []
    for n, (tmp, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {n} (nvcc exit {proc.returncode})\n{text}")
            continue
        os.replace(tmp, library_path(n))
        report[n] = {"seconds": time.perf_counter() - t0, "ptxas": text}
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if missing or stale."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            if _stale(name):
                build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in _SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = _RESTYPES.get(fn, _I)
            _LIBS[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise when a C entry reported a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
