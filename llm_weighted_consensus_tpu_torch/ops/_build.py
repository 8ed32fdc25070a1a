"""Build and load the port's hand-written CUDA kernels.

The sources under ``csrc/`` have a plain C interface (no PyTorch headers),
so each compiles with ``nvcc`` in seconds.  They are compiled for
``sm_90a`` (Hopper), one ``nvcc`` per source started together, linked
into ``build/kernels/liblwc_torch_kernels.so`` at the repository root,
and loaded with ``ctypes``.  The build runs at first use, and again only
when the library is missing or older than one of its sources or of the
headers (``csrc/*.cuh``) they include.

Every C entry point returns ``cudaGetLastError()`` after its launch;
``check`` turns a nonzero code into an exception.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
SOURCES = (
    "cosine_vote.cu", "cosine_vote_sm90.cu", "attention.cu",
    "attention_sm90.cu", "quant_matmul.cu", "quant_gemm_sm90.cu",
    "norm_act.cu",
)
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
LIB_NAME = "liblwc_torch_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError(
        "nvcc not found (looked on PATH and under CUDA_HOME or "
        "/usr/local/cuda): the CUDA kernels cannot be built"
    )


def _inputs() -> list:
    """Every file the library is built from: the sources and the headers
    under ``csrc/`` they include."""
    return [CSRC_DIR / name for name in SOURCES] + sorted(
        CSRC_DIR.glob("*.cuh")
    )


def _stale(lib_path: Path) -> bool:
    if not lib_path.exists():
        return True
    built = lib_path.stat().st_mtime
    return any(path.stat().st_mtime > built for path in _inputs())


def build(verbose: bool = False) -> Path:
    """Compile every source in parallel and link the shared library.

    Objects and the library are written under temporary names and moved
    into place, so a concurrent loader never sees a half-written file.
    """
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.{threading.get_ident()}"
    objects = []
    procs = []
    for name in SOURCES:
        obj = BUILD_DIR / f"{Path(name).stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC_DIR / name), "-o", str(obj)]
        if verbose:
            cmd.insert(1, "-Xptxas=-v")
        procs.append(
            (name, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ))
        )
        objects.append(obj)
    failures = []
    for name, proc in procs:
        out, _ = proc.communicate()
        if verbose and out:
            print(out, flush=True)
        if proc.returncode != 0:
            failures.append(f"{name}:\n{out}")
    if failures:
        raise RuntimeError("nvcc failed\n" + "\n".join(failures))
    tmp_lib = BUILD_DIR / f"{LIB_NAME}.{tag}"
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp_lib), *map(str, objects)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    for obj in objects:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    lib_path = BUILD_DIR / LIB_NAME
    os.replace(tmp_lib, lib_path)
    return lib_path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # the fourth int is the scalar n_valid, the pointer after it the
    # per-request counts (null: the scalar)
    lib.lwc_cosine_vote.argtypes = [
        vp, vp, i32, i32, i32, i32, vp, f32, i32, vp,
    ]
    lib.lwc_cosine_vote.restype = i32
    lib.lwc_cosine_vote_cluster.argtypes = [
        vp, vp, i32, i32, i32, i32, vp, f32, i32, i32, i32, vp,
    ]
    lib.lwc_cosine_vote_cluster.restype = i32
    lib.lwc_cosine_vote_cluster_smem.argtypes = [i32, i32, i32, i32]
    lib.lwc_cosine_vote_cluster_smem.restype = ctypes.c_longlong
    for name in ("lwc_attention", "lwc_attention_seg", "lwc_attention_tma",
                 "lwc_attention_seg_tma"):
        fn = getattr(lib, name)
        fn.argtypes = [
            vp, vp, vp, vp, vp, i32, i32, i32, i32,
            ctypes.POINTER(ctypes.c_longlong), f32, i32, vp,
        ]
        fn.restype = i32
    lib.lwc_attention_seg_tma_schedule.argtypes = (
        lib.lwc_attention_seg_tma.argtypes + [vp])
    lib.lwc_attention_seg_tma_schedule.restype = i32
    lib.lwc_attention_seg_tma_tiles.argtypes = [i32, ctypes.POINTER(i32)]
    lib.lwc_attention_seg_tma_tiles.restype = None
    lib.lwc_quantize_rows.argtypes = [vp, vp, vp, i32, i32, i32, i32, i32,
                                      vp]
    lib.lwc_quantize_rows.restype = i32
    for name in ("lwc_quant_matmul", "lwc_quant_matmul_tma"):
        fn = getattr(lib, name)
        fn.argtypes = [
            vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, i32, vp,
        ]
        fn.restype = i32
    lib.lwc_add_layer_norm.argtypes = [vp, vp, vp, vp, vp, i32, i32, f32, i32,
                                       vp]
    lib.lwc_add_layer_norm.restype = i32
    lib.lwc_gelu.argtypes = [vp, vp, ctypes.c_longlong, i32, vp]
    lib.lwc_gelu.restype = i32
    return lib


def library(verbose: bool = False) -> ctypes.CDLL:
    """The loaded kernel library, built first when missing or stale."""
    global _lib
    with _lock:
        if _lib is None:
            lib_path = BUILD_DIR / LIB_NAME
            if _stale(lib_path):
                build(verbose=verbose)
            _lib = _bind(ctypes.CDLL(str(lib_path)))
        return _lib


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
