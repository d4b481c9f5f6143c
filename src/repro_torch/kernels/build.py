"""Build and load every CUDA source in ``repro_torch/csrc/`` at first use.

The sources have a plain C interface and are bound with ``ctypes``: no
PyTorch headers are involved, so a build takes seconds.  Each ``*.cu`` is
compiled by its own ``nvcc -c``, all started together, and one more
``nvcc -shared`` links the objects into one library.  It lands in
``build/repro_torch_kernels/kernels-<hash>/`` at the repository root, keyed
by a hash of every ``*.cu`` and ``*.cuh`` and the flags, so an edited source
rebuilds and an unchanged tree is reused.  The library is loaded once per
process.  Nothing is built when the module is imported.
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
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3")
COMPILE_FLAGS = (*ARCH_FLAGS, "-c", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = (*ARCH_FLAGS, "-shared", "-ldl")


class KernelLibrary(NamedTuple):
    lib: ctypes.CDLL
    build_s: float  # 0.0 when an earlier build was reused
    log: str  # nvcc / ptxas output of every source (registers, spills)


_lock = threading.Lock()
_loaded: KernelLibrary | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the repro_torch CUDA kernels are "
                       "built from source at first use")


def _sources() -> tuple[list[Path], list[Path]]:
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Run the commands at once; their output, or raise on the first that
    fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = []
    try:
        for cmd, p in zip(cmds, procs):
            out, _ = p.communicate(timeout=600)
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                                   f"{' '.join(cmd)}\n{out}")
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _build() -> KernelLibrary:
    units, headers = _sources()
    digest = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for f in units + headers:
        digest.update(f.name.encode())
        digest.update(f.read_bytes())
    out_dir = BUILD_ROOT / f"kernels-{digest.hexdigest()[:16]}"
    so = out_dir / "libkernels.so"
    log_file = out_dir / "build.log"
    build_s = 0.0
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        nvcc = _nvcc()
        with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
            objs = [Path(tmp) / f"{u.stem}.o" for u in units]
            logs = _run_all([[nvcc, *COMPILE_FLAGS, "-o", str(o), str(u)]
                             for u, o in zip(units, objs)])
            # link beside the target and rename: a concurrent loader sees
            # either no library or a whole one
            tmp_so = Path(tmp) / "libkernels.so"
            logs += _run_all([[nvcc, *LINK_FLAGS, "-o", str(tmp_so),
                               *map(str, objs)]])
            log_file.write_text("".join(logs))
            os.replace(tmp_so, so)
        build_s = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so))
    # every pointer and the stream as c_void_p (a bare Python int would be
    # cut to 32 bits), sizes as c_int
    P, I, S = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    for name, args, res in (
            ("selection_smem_bytes", [I], S),
            ("selection_prepare", [I], I),
            ("retrieval_topk_launch", [P, P, P, P, I, I, I, I, P], I),
            ("retrieval_topk_tiled_launch", [P] * 7 + [I] * 9 + [P], I),
            ("retrieval_topk_select_launch", [P] * 6 + [I] * 9 + [P], I),
            ("dsqe_score_row_launch", [P] * 12 + [I] * 6 + [P], I),
            ("dsqe_score_tiled_launch", [P] * 15 + [I] * 11 + [P], I),
            ("dsqe_score_select_launch", [P] * 14 + [I] * 11 + [P], I),
            ("flash_attention_launch", [P] * 5 + [I] * 10 + [P], I),
            ("flash_attention_tc_launch", [P] * 5 + [I] * 9 + [P], I),
            ("flash_attention_bwd_launch", [P] * 10 + [I] * 12 + [P, P], I),
            ("decode_attention_launch", [P] * 8 + [I] * 10 + [P], I),
            ("decode_attention_lse_launch",
             [P] * 8 + [I] * 10 + [I, I, P, P], I),
            ("decode_attention_tc_smem_bytes", [I], S),
            ("decode_attention_tc_launch", [P] * 8 + [I] * 9 + [P], I),
            ("decode_attention_tc_lse_launch",
             [P] * 8 + [I] * 9 + [I, I, P, P], I),
            ("moe_gmm_launch", [P] * 3 + [I] * 5 + [P], I),
            ("moe_gmm_tc_launch", [P] * 3 + [I] * 4 + [P], I),
            ("moe_gmm_bwd_launch", [P] * 5 + [I] * 5 + [P], I),
            ("moe_gmm_bwd_tc_launch", [P] * 5 + [I] * 4 + [P], I),
            ("rglru_scan_launch", [P] * 4 + [I] * 4 + [P], I),
            ("rglru_scan_bwd_launch", [P] * 7 + [I] * 4 + [P], I),
            ("rglru_scan_last_route", [], I),
            ("rglru_scan_plan", [I] * 5 + [P], I)):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = res
    log = log_file.read_text() if log_file.exists() else ""
    return KernelLibrary(lib, build_s, log)


def kernel_library() -> KernelLibrary:
    """Every kernel in ``csrc/`` (retrieval_topk and dsqe_score, each with
    its tiled, select and row variants, flash_attention and decode_attention
    and their tensor-core variants, the flash backward, moe_gmm and its
    backward, each with a tensor-core variant, rglru_scan and its backward,
    each on a TMA or a cp.async producer),
    built if needed and loaded once per process."""
    global _loaded
    if _loaded is None:
        with _lock:
            if _loaded is None:
                _loaded = _build()
    return _loaded
