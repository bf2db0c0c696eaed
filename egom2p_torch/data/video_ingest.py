"""mp4 in and out for the port's eval entry points: ctypes bindings of the
repo's native video library.

The port's own copy of egom2p_tpu/data/video_ingest.py: `read_video` decodes
a clip to uint8 RGB frames with a center square crop and Lanczos scaling
(reference: eval_model_rgb2depth.py:26-32, cosmos_tokenizer/video_cli.py:
211-240), `write_video` encodes frames to an mp4 (reference:
egom2p/utils/plotting_utils.py:103-131).  The shared library is built at
first use from native/video_ingest.cpp with g++ and libav (libavformat,
libavcodec, libavutil, libswscale) into native/build/, under a name of its
own.  A failed build raises.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(_REPO_ROOT, "native", "video_ingest.cpp")
BUILD_DIR = os.path.join(_REPO_ROOT, "native", "build")
LIBRARY = os.path.join(BUILD_DIR, "libvideoingest_torch.so")
LIBS = ("-lavformat", "-lavcodec", "-lavutil", "-lswscale")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def build() -> str:
    """Compile the library (to a temporary name, then renamed into place, so
    a concurrent loader never opens a half-written file)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIBRARY}.{os.getpid()}.tmp"
    cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", SOURCE, "-o", tmp, *LIBS]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"video library build failed:\n{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, LIBRARY)
    return LIBRARY


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(LIBRARY) or os.path.getmtime(LIBRARY) < os.path.getmtime(SOURCE):
            build()
        lib = ctypes.CDLL(LIBRARY)
        lib.vi_read_video.restype = ctypes.c_int
        lib.vi_read_video.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)), ctypes.POINTER(ctypes.c_int)]
        lib.vi_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
        lib.vi_write_video.restype = ctypes.c_int
        lib.vi_write_video.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_double]
        _lib = lib
        return lib


def read_video(path: str, out_size: int = 256, target_fps: float = 0.0,
               max_frames: int = 0) -> np.ndarray:
    """Decode a video to (T, out_size, out_size, 3) uint8 RGB (center square
    crop, Lanczos scaling).  target_fps <= 0 keeps the native rate."""
    lib = _load()
    data = ctypes.POINTER(ctypes.c_uint8)()
    n = ctypes.c_int(0)
    rc = lib.vi_read_video(path.encode(), out_size, out_size, float(target_fps),
                           int(max_frames), ctypes.byref(data), ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"vi_read_video({path}) failed with code {rc}")
    try:
        arr = np.ctypeslib.as_array(data, shape=(n.value * out_size * out_size * 3,)).copy()
    finally:
        lib.vi_free(data)
    return arr.reshape(n.value, out_size, out_size, 3)


def read_videos_pooled(paths, out_size: int = 256, target_fps: float = 0.0,
                       max_frames: int = 0, workers: int = 0) -> List[np.ndarray]:
    """Decode many clips on a thread pool (ctypes releases the GIL during a
    decode); `workers` 0 takes one per CPU core.  Results in input order."""
    workers = workers or os.cpu_count() or 1
    if workers == 1 or len(paths) <= 1:
        return [read_video(p, out_size, target_fps, max_frames) for p in paths]
    with ThreadPoolExecutor(max_workers=workers) as ex:
        return list(ex.map(lambda p: read_video(p, out_size, target_fps, max_frames), paths))


def write_video(path: str, frames: np.ndarray, fps: float = 8.0) -> None:
    """Encode (T, H, W, 3) uint8 RGB frames to an mp4."""
    lib = _load()
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    t, h, w, c = frames.shape
    if c != 3:
        raise ValueError(f"frames must be (T, H, W, 3), got {frames.shape}")
    rc = lib.vi_write_video(path.encode(), frames.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                            t, w, h, float(fps))
    if rc != 0:
        raise RuntimeError(f"vi_write_video({path}) failed with code {rc}")
