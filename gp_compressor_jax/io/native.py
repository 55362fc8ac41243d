"""ctypes bindings for the native IO library (native/gpio.cpp).

Compiles the C++ on first use (native/build.sh) and falls back silently to
the NumPy implementations in io/pcd.py when no compiler is available —
behaviour is identical, speed is not.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libgpio.so")
_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        if not os.path.exists(_LIB_PATH) or (
                os.path.getmtime(_LIB_PATH)
                < os.path.getmtime(os.path.join(_NATIVE_DIR, "gpio.cpp"))):
            subprocess.run(["sh", os.path.join(_NATIVE_DIR, "build.sh")],
                           check=True, capture_output=True)
        lib = ctypes.CDLL(_LIB_PATH)
        lib.gpio_pcd_info.argtypes = [ctypes.c_char_p,
                                      ctypes.POINTER(ctypes.c_long),
                                      ctypes.POINTER(ctypes.c_int)]
        lib.gpio_pcd_read.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                      ctypes.c_void_p]
        lib.gpio_pcd_write.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                       ctypes.c_void_p, ctypes.c_long,
                                       ctypes.c_int]
        lib.gpio_dict_write.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                        ctypes.c_long, ctypes.c_long]
        lib.gpio_dict_info.argtypes = [ctypes.c_char_p,
                                       ctypes.POINTER(ctypes.c_long),
                                       ctypes.POINTER(ctypes.c_long)]
        lib.gpio_dict_read.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
        lib.gpio_pccode_write.argtypes = [
            ctypes.c_char_p] + [ctypes.c_int32] * 6 + [ctypes.c_float] + \
            [ctypes.c_void_p] * 9
        for fn in (lib.gpio_pcd_info, lib.gpio_pcd_read, lib.gpio_pcd_write,
                   lib.gpio_dict_write, lib.gpio_dict_info,
                   lib.gpio_dict_read, lib.gpio_pccode_write):
            fn.restype = ctypes.c_int
        _lib = lib
    except Exception:
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def read_pcd(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    lib = _load()
    if lib is None:
        from gp_compressor_jax.io import pcd
        return pcd.read(path)
    n = ctypes.c_long()
    has_rgb = ctypes.c_int()
    rc = lib.gpio_pcd_info(path.encode(), ctypes.byref(n),
                           ctypes.byref(has_rgb))
    if rc != 0:
        raise IOError(f"gpio_pcd_info({path}) failed rc={rc}")
    xyz = np.empty((n.value, 3), np.float32)
    rgb = np.empty((n.value, 3), np.float32) if has_rgb.value else None
    rc = lib.gpio_pcd_read(
        path.encode(), xyz.ctypes.data_as(ctypes.c_void_p),
        rgb.ctypes.data_as(ctypes.c_void_p) if rgb is not None else None)
    if rc != 0:
        raise IOError(f"gpio_pcd_read({path}) failed rc={rc}")
    return xyz, rgb


def write_artifact(name: str, art) -> bool:
    """Native .pccode/.pcdict writer (byte-identical to io/artifact.py).
    Returns False when the native library is unavailable (caller should
    fall back to the Python writer)."""
    lib = _load()
    if lib is None:
        return False

    def cp(a, dt):
        return np.ascontiguousarray(a, dt).ctypes.data_as(ctypes.c_void_p)

    rc = lib.gpio_dict_write(
        (name + "rgb.pcdict").encode(), cp(art.RGB_D, np.float32),
        art.RGB_D.shape[0], art.RGB_D.shape[1])
    rc |= lib.gpio_dict_write(
        (name + "depth.pcdict").encode(), cp(art.D, np.float32),
        art.D.shape[0], art.D.shape[1])
    n = art.means.shape[0]
    rc |= lib.gpio_pccode_write(
        (name + ".pccode").encode(),
        ctypes.c_int32(n), ctypes.c_int32(art.sz),
        ctypes.c_int32(art.words_max), ctypes.c_int32(art.RGB_words_max),
        ctypes.c_int32(art.D.shape[1]), ctypes.c_int32(art.RGB_D.shape[1]),
        ctypes.c_float(art.res),
        cp(art.means, np.float32), cp(art.quats, np.float32),
        cp(art.rgb_means, np.float32),
        cp(art.X, np.float32), cp(art.I, np.int32), cp(art.nw, np.int32),
        cp(art.RGB_X, np.float32), cp(art.RGB_I, np.int32),
        cp(art.RGB_nw, np.int32), cp(art.W, np.uint8))
    if rc != 0:
        raise IOError(f"native artifact write failed rc={rc}")
    return True


def write_pcd(path: str, points: np.ndarray,
              colors: Optional[np.ndarray] = None, binary: bool = True):
    lib = _load()
    if lib is None:
        from gp_compressor_jax.io import pcd
        return pcd.write(path, points, colors, binary)
    xyz = np.ascontiguousarray(points, np.float32)
    rgb = None if colors is None else np.ascontiguousarray(colors, np.float32)
    rc = lib.gpio_pcd_write(
        path.encode(), xyz.ctypes.data_as(ctypes.c_void_p),
        rgb.ctypes.data_as(ctypes.c_void_p) if rgb is not None else None,
        xyz.shape[0], 1 if binary else 0)
    if rc != 0:
        raise IOError(f"gpio_pcd_write({path}) failed rc={rc}")
