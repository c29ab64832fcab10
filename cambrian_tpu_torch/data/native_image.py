"""ctypes bindings for the native image-preprocessing library
(native/image_ops.cpp): thread-parallel expand-to-square + PIL-parity
resample + normalize, used by the training input pipeline to keep four-tower
preprocessing off the Python critical path (SURVEY.md §7 hard-part 5).

The port's own copy of cambrian_tpu/data/native_image.py. The library is
compiled from the repository's ``native/image_ops.cpp`` with g++ on first use
into ``build/cambrian_tpu_torch/`` (git-ignored); callers fall back to the PIL
path when the toolchain is unavailable.
"""

import ctypes
import logging
import os
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_REPO, "native", "image_ops.cpp")
_SO = os.path.join(_REPO, "build", "cambrian_tpu_torch", "libimage_ops.so")

_lib = None
_lib_lock = threading.Lock()

RESAMPLE_BILINEAR = 0
RESAMPLE_BICUBIC = 1


def _compile() -> Optional[str]:
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"   # concurrent builders each write their own
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
           "-pthread", _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=180)
        os.replace(tmp, _SO)
        return _SO
    except Exception as e:
        logger.warning("native image_ops build failed (%s); using PIL path", e)
        return None


def load_library():
    """Returns the ctypes library or None (PIL fallback)."""
    global _lib
    if _lib is not None:
        return _lib if _lib is not False else None
    with _lib_lock:
        if _lib is not None:
            return _lib if _lib is not False else None
        path = _SO if os.path.exists(_SO) and (
            os.path.getmtime(_SO) >= os.path.getmtime(_SRC)) else _compile()
        if path is None:
            _lib = False
            return None
        lib = ctypes.CDLL(path)
        lib.preprocess_batch.argtypes = [
            ctypes.POINTER(ctypes.c_void_p),                  # srcs
            ctypes.POINTER(ctypes.c_int),                     # heights
            ctypes.POINTER(ctypes.c_int),                     # widths
            ctypes.c_int,                                     # n
            ctypes.POINTER(ctypes.c_uint8),                   # fill rgb
            ctypes.c_int, ctypes.c_int,                       # target, resample
            ctypes.POINTER(ctypes.c_float),                   # mean
            ctypes.POINTER(ctypes.c_float),                   # std
            ctypes.POINTER(ctypes.c_float),                   # out
            ctypes.c_int,                                     # threads
        ]
        lib.preprocess_batch.restype = None
        _lib = lib
        return lib


def available() -> bool:
    return load_library() is not None


def preprocess_batch(
    images: Sequence[np.ndarray],       # n x u8 HWC (RGB)
    target: int,
    image_mean: Sequence[float],
    image_std: Sequence[float],
    resample: int = RESAMPLE_BICUBIC,
    fill_from_mean: bool = True,
    num_threads: int = 0,
) -> np.ndarray:
    """expand2square(mean fill) + resize(target) + normalize -> [n,3,T,T] f32
    (the per-tower contract of mm_utils.process_images:186-201)."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native image_ops unavailable")

    n = len(images)
    images = [np.ascontiguousarray(im, dtype=np.uint8) for im in images]
    srcs = (ctypes.c_void_p * n)(
        *[im.ctypes.data_as(ctypes.c_void_p).value for im in images])
    heights = (ctypes.c_int * n)(*[im.shape[0] for im in images])
    widths = (ctypes.c_int * n)(*[im.shape[1] for im in images])
    fill = np.asarray(
        [int(m * 255) for m in image_mean] if fill_from_mean else [0, 0, 0],
        dtype=np.uint8,
    )
    mean = np.asarray(image_mean, dtype=np.float32)
    std = np.asarray(image_std, dtype=np.float32)
    out = np.empty((n, 3, target, target), dtype=np.float32)

    lib.preprocess_batch(
        srcs, heights, widths, n,
        fill.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        target, resample,
        mean.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        std.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        num_threads,
    )
    return out
