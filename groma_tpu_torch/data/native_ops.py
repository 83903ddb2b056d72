"""ctypes bindings for the C++ image pipeline (native/image_ops.cpp).

Auto-builds the shared library on first use if a toolchain is present;
falls back to the numpy/cv2 implementation otherwise.  Semantics match
cv2.resize INTER_LINEAR exactly (tests/test_native_ops.py).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_LIB = None
_TRIED = False

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), 'native')
_SO_PATH = os.path.join(_NATIVE_DIR, 'libgroma_image_ops.so')


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if not os.path.exists(_SO_PATH):
        try:
            subprocess.run(['make', '-C', _NATIVE_DIR], check=True,
                           capture_output=True, timeout=120)
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(_SO_PATH)
    except OSError:
        return None
    i64, u8p, f32p = (ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8),
                      ctypes.POINTER(ctypes.c_float))
    lib.resize_bilinear_u8.argtypes = [u8p, i64, i64, i64, u8p, i64, i64]
    lib.resize_normalize.argtypes = [u8p, i64, i64, i64, f32p, i64, i64,
                                     f32p, f32p]
    lib.normalize_u8.argtypes = [u8p, i64, i64, f32p, f32p, f32p]
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def _u8p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def resize_bilinear(img: np.ndarray, out_hw) -> np.ndarray:
    """uint8 HWC resize, cv2 INTER_LINEAR semantics."""
    lib = _load()
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    oh, ow = out_hw
    if lib is None:
        import cv2
        return cv2.resize(img, (ow, oh), interpolation=cv2.INTER_LINEAR)
    out = np.empty((oh, ow, c), np.uint8)
    lib.resize_bilinear_u8(_u8p(img), h, w, c, _u8p(out), oh, ow)
    return out


def resize_normalize(img: np.ndarray, out_hw, mean: np.ndarray,
                     std: np.ndarray) -> np.ndarray:
    """Fused uint8 resize + (x-mean)/std float32."""
    lib = _load()
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    oh, ow = out_hw
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    if lib is None:
        r = resize_bilinear(img, out_hw).astype(np.float32)
        return (r - mean) / std
    out = np.empty((oh, ow, c), np.float32)
    lib.resize_normalize(_u8p(img), h, w, c, _f32p(out), oh, ow,
                         _f32p(mean), _f32p(std))
    return out
