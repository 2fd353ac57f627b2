"""ctypes bindings for the ffmpeg-backed decoder (built on demand)."""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "src", "ffmpeg_decode.cpp")
_SO = os.path.join(_HERE, "libthesia_ffmpeg.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-o", tmp, _SRC,
        "-lavformat", "-lavcodec", "-lavutil",
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        # atomic: concurrent processes (test workers) may build at once,
        # and none may load a half-written library
        os.replace(tmp, _SO)
        return True
    except Exception:
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        # a deployment may ship the prebuilt .so without src/ — treat a
        # missing source as "not stale" instead of crashing available()
        # (same guard as native/__init__.py; review finding)
        need = not os.path.exists(_SO) or (
            os.path.exists(_SRC)
            and os.path.getmtime(_SO) < os.path.getmtime(_SRC)
        )
        if need and not _build():
            return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        c = ctypes
        lib.ffmpeg_decode.argtypes = [
            c.c_char_p, c.POINTER(c.POINTER(c.c_float)),
            c.POINTER(c.c_uint32), c.POINTER(c.c_uint32), c.POINTER(c.c_uint64),
            c.c_char_p, c.c_int, c.c_char_p, c.c_int,
            c.POINTER(c.c_int32), c.POINTER(c.c_int64), c.POINTER(c.c_uint64),
        ]
        lib.ffmpeg_decode.restype = c.c_int
        lib.thesia_ffmpeg_free.argtypes = [c.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def decode(path: str):
    """-> (planar f32 (n_ch, n), info dict). Raises ValueError on failure."""
    lib = _load()
    if lib is None:
        raise ValueError("ffmpeg decoder unavailable")
    out = ctypes.POINTER(ctypes.c_float)()
    sr = ctypes.c_uint32()
    n_ch = ctypes.c_uint32()
    n = ctypes.c_uint64()
    codec = ctypes.create_string_buffer(64)
    fmt = ctypes.create_string_buffer(64)
    bits = ctypes.c_int32()
    bitrate = ctypes.c_int64()
    pkt_bytes = ctypes.c_uint64()
    rc = lib.ffmpeg_decode(
        path.encode(), ctypes.byref(out), ctypes.byref(sr), ctypes.byref(n_ch),
        ctypes.byref(n), codec, 64, fmt, 64,
        ctypes.byref(bits), ctypes.byref(bitrate), ctypes.byref(pkt_bytes),
    )
    if rc != 0:
        raise ValueError(f"ffmpeg decode failed (code {rc})")
    count = n.value * n_ch.value
    arr = np.ctypeslib.as_array(out, shape=(count,)).reshape(n_ch.value, n.value).copy()
    lib.thesia_ffmpeg_free(out)
    return arr, {
        "sr": sr.value,
        "codec": codec.value.decode(),
        "format": fmt.value.decode(),
        "bits_per_sample": bits.value,
        "bit_rate": bitrate.value,
        "packet_bytes": pkt_bytes.value,
    }
