"""Build and load the port's hand-written CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, loaded with
``ctypes``.  Nothing is built when a module is imported: the first call that
needs a kernel builds it into ``build/kernels/`` at the repository root
(listed in ``.gitignore``).  The library's file name carries a digest of its
source and flags, so an edited source is never served by a stale build.
``build_all`` starts one ``nvcc`` per source at once and waits for all.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

__all__ = ["SOURCES", "build_all", "library", "nvcc_path"]

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

#: kernel name -> (source file in csrc/, {C function: (argtypes, restype)})
SOURCES = {
    "gram_matvec": ("gram_matvec.cu", {
        "gram_matvec_launch": ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 12
                               + [ctypes.c_void_p], ctypes.c_int),
        "gram_matvec_error_string": ([ctypes.c_int], ctypes.c_char_p),
    }),
    "gram_matvec_onepass": ("gram_matvec_onepass.cu", {
        "gram_onepass_launch": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                                + [ctypes.c_void_p], ctypes.c_int),
        "gram_onepass_smem": ([ctypes.c_int] * 3, ctypes.c_longlong),
        "gram_onepass_error_string": ([ctypes.c_int], ctypes.c_char_p),
    }),
    "greedy_assign": ("greedy_assign.cu", {
        "greedy_assign_launch": ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                                 + [ctypes.c_void_p], ctypes.c_int),
        "greedy_assign_dense_trials": ([ctypes.POINTER(ctypes.c_ulonglong)],
                                       ctypes.c_int),
        "greedy_assign_smem": ([ctypes.c_int], ctypes.c_longlong),
        "greedy_assign_error_string": ([ctypes.c_int], ctypes.c_char_p),
    }),
    "swa_attention": ("swa_attention.cu", {
        "swa_attention_launch": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                                 + [ctypes.c_void_p], ctypes.c_int),
        "swa_attention_error_string": ([ctypes.c_int], ctypes.c_char_p),
    }),
    "swa_attention_f32": ("swa_attention_f32.cu", {
        "swa_f32_launch": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                           + [ctypes.c_void_p] + [ctypes.c_int] * 2
                           + [ctypes.c_void_p] * 3, ctypes.c_int),
        "swa_f32_error_string": ([ctypes.c_int], ctypes.c_char_p),
    }),
    "swa_attention_wgmma": ("swa_attention_wgmma.cu", {
        "swa_wgmma_launch": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                             + [ctypes.c_void_p], ctypes.c_int),
        "swa_wgmma_error_string": ([ctypes.c_int], ctypes.c_char_p),
    }),
}

FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else PyTorch's idea of
    the toolkit's home, else ``/usr/local/cuda``."""
    home = os.environ.get("CUDA_HOME")
    if not home:
        from torch.utils.cpp_extension import CUDA_HOME
        home = CUDA_HOME or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(f"nvcc not found at {path}; set CUDA_HOME to the "
                           f"CUDA toolkit to build the port's kernels")
    return str(path)


def _target(name: str) -> Path:
    src = CSRC / SOURCES[name][0]
    digest = hashlib.sha1(src.read_bytes() + " ".join(FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build_all(names=None) -> float:
    """Compile every named kernel (default: all) that has no current build,
    one ``nvcc`` process per source, all started together.  Returns the
    wall seconds spent; raises with the compiler's output on failure.  The
    compiler's log (``-Xptxas=-v``: registers, shared memory, spills) is
    kept beside each library as ``<name>.log``."""
    names = list(SOURCES) if names is None else list(names)
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *FLAGS, "-o", str(tmp),
               str(CSRC / SOURCES[name][0])]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)          # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel ``name`` (built on first use),
    with ``argtypes``/``restype`` declared for every exported function."""
    lib = _loaded.get(name)
    if lib is None:
        if not _target(name).exists():
            build_all([name])
        lib = ctypes.CDLL(str(_target(name)))
        for fn, (argtypes, restype) in SOURCES[name][1].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _loaded[name] = lib
    return lib
