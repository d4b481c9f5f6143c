"""Build and load ``repro_torch/csrc/selection.cu`` at first use.

The source has a plain C interface and is bound with ``ctypes``: one
``nvcc`` call, a few seconds, with no PyTorch headers involved.  The shared
library lands in ``build/repro_torch_kernels/selection-<hash>/`` at the
repository root, keyed by a hash of the sources and the flags, so an edited
source rebuilds and an unchanged one is reused.  Nothing is built when the
module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import NamedTuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("selection.cu", "topk.cuh")  # compiled, then included
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class SelectionLibrary(NamedTuple):
    lib: ctypes.CDLL
    build_s: float  # 0.0 when an earlier build was reused
    log: str  # nvcc / ptxas output (registers, shared memory)


_lock = threading.Lock()
_loaded: SelectionLibrary | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the repro_torch CUDA kernels are "
                       "built from source at first use")


def _build() -> SelectionLibrary:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in SOURCES:
        digest.update(f.encode())
        digest.update((CSRC / f).read_bytes())
    out_dir = BUILD_ROOT / f"selection-{digest.hexdigest()[:16]}"
    so = out_dir / "libselection.so"
    log_file = out_dir / "build.log"
    build_s = 0.0
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        # build beside the target and rename: a concurrent loader sees
        # either no library or a whole one
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / SOURCES[0])]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        log_file.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, so)
        build_s = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so))
    # every pointer and the stream as c_void_p (a bare Python int would be
    # cut to 32 bits), sizes as c_int
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.selection_smem_bytes.argtypes = [I]
    lib.selection_smem_bytes.restype = ctypes.c_size_t
    lib.selection_max_k.argtypes = []
    lib.selection_max_k.restype = I
    lib.selection_prepare.argtypes = [I]
    lib.selection_prepare.restype = I
    lib.retrieval_topk_launch.argtypes = [P, P, P, P, I, I, I, I, P]
    lib.retrieval_topk_launch.restype = I
    lib.dsqe_score_launch.argtypes = [P] * 12 + [I] * 6 + [P]
    lib.dsqe_score_launch.restype = I
    log = log_file.read_text() if log_file.exists() else ""
    return SelectionLibrary(lib, build_s, log)


def selection_library() -> SelectionLibrary:
    """``csrc/selection.cu`` (retrieval_topk, dsqe_score), built if needed
    and loaded once per process."""
    global _loaded
    if _loaded is None:
        with _lock:
            if _loaded is None:
                _loaded = _build()
    return _loaded
