"""Build the port's CUDA kernels and bind them with ctypes.

Every `egom2p_torch/csrc/*.cu` file is compiled by its own nvcc process, all
started together, and the objects are linked into one shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), under
`egom2p_torch/build/`, named by a hash of the sources, headers and flags: a
library is rebuilt only when that hash changes.  The build runs at the first
call of `load()`, i.e. at the first kernel launch, never at import.  A failed
build raises; there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_c_void_p, _c_int, _c_ll, _c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# safemax, head_dim, sm_scale, stream: the tail of the training attention entry points
_ATTN_TAIL = [_c_int, _c_int, _c_float, _c_void_p]
# C signatures of the entry points in csrc/*.cu: (argtypes, restype)
SIGNATURES = {
    # q, k, v, kv_blocked, out, B, N, M, H, 9 strides, safemax, stream
    "egom2p_flash64_fwd": ([_c_void_p] * 5 + [_c_int] * 4 + [_c_ll] * 9
                           + [_c_int, _c_void_p], _c_int),
    # q, k, v, kv_blocked, segments, out, l2, B, N, M, H, 9 strides, tail
    "egom2p_flash64_train_fwd": ([_c_void_p] * 7 + [_c_int] * 4 + [_c_ll] * 9
                                 + _ATTN_TAIL, _c_int),
    # q, k, v, do, l2, D, kv_blocked, segments, dq, B, N, M, H, 9 strides, tail
    "egom2p_flash64_train_dq": ([_c_void_p] * 9 + [_c_int] * 4 + [_c_ll] * 9
                                + _ATTN_TAIL, _c_int),
    # ... dk, dv instead of dq
    "egom2p_flash64_train_dkv": ([_c_void_p] * 10 + [_c_int] * 4 + [_c_ll] * 9
                                 + _ATTN_TAIL, _c_int),
    # ... dq (fp32, zeroed), dk, dv
    "egom2p_flash64_train_dqkv": ([_c_void_p] * 11 + [_c_int] * 4 + [_c_ll] * 9
                                  + _ATTN_TAIL, _c_int),
    # y, w, targets, live, logz, gold, partial, scratch, R, V, D, vocab slices,
    # y row stride, w row stride, stream
    "egom2p_flash_ce_fwd": ([_c_void_p] * 8 + [_c_int] * 4 + [_c_ll] * 2
                            + [_c_void_p], _c_int),
    # y, w, targets, wc, logz, dy, dw, scratch, R, V, D, group columns, y row stride,
    # w row stride, stream
    "egom2p_flash_ce_bwd": ([_c_void_p] * 8 + [_c_int] * 4 + [_c_ll] * 2
                            + [_c_void_p], _c_int),
}


class _State:
    lib = None
    build_seconds = None  # wall time of the nvcc run; 0.0 when reused
    ptxas_log = ""        # nvcc's -Xptxas -v report (registers, smem, spills)


_lock = threading.Lock()


def sources():
    found = sorted(CSRC_DIR.glob("*.cu"))
    if not found:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return found


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources() + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []) + [
            Path("/usr/local/cuda/bin/nvcc")]:
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _run_all(cmds):
    """Start every command at once; returns [(cmd, returncode, output)]."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    outs = [(cmd, p.communicate()[0], p) for cmd, p in procs]
    return [(cmd, p.returncode, out) for cmd, out, p in outs]


def build() -> Path:
    """Compile the sources into BUILD_DIR unless a library of the same
    source hash exists; returns its path."""
    digest = source_hash()
    so = BUILD_DIR / f"libegom2p_kernels_{digest}.so"
    if so.exists():
        _State.build_seconds = 0.0
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{digest}.{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}_{tag}.o" for src in sources()]
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        results = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                            for src, obj in zip(sources(), objs)])
        if all(rc == 0 for _, rc, _ in results):
            results += _run_all([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
        _State.build_seconds = time.perf_counter() - t0
        _State.ptxas_log = "".join(out for _, _, out in results)
        failed = [(cmd, rc, out) for cmd, rc, out in results if rc != 0]
        if failed:
            tmp.unlink(missing_ok=True)
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{' '.join(cmd)} (exit code {rc})\n{out}" for cmd, rc, out in failed))
        os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return so


def load() -> ctypes.CDLL:
    """The kernel library, built on first use, with argtypes set."""
    with _lock:
        if _State.lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _State.lib = lib
    return _State.lib


def build_seconds():
    return _State.build_seconds


def ptxas_log() -> str:
    return _State.ptxas_log
