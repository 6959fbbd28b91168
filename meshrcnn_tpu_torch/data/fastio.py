"""The port's native host decoders (``meshrcnn_tpu_torch/csrc/fastio.c`` and
``csrc/jpeg.c``), called through ``ctypes`` on numpy buffers.

Each library is built with ``cc`` at its first call (``ops/cuda_build.host_build``)
and a failed build raises: nothing falls back to the Python parsers. ctypes
releases the interpreter lock for the length of each call, so the loader's
threads decode files in parallel. Each wrapper counts its calls in
``calls``, under a lock, since loader threads call them at once.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np

from meshrcnn_tpu_torch.ops import cuda_build

_i64, _ptr = ctypes.c_int64, ctypes.c_void_p
_SIGNATURES = {
    "fastio_parse_obj": (ctypes.c_int, (ctypes.c_char_p, _i64, ctypes.POINTER(_ptr),
                                        ctypes.POINTER(_i64), ctypes.POINTER(_ptr),
                                        ctypes.POINTER(_i64))),
    "fastio_free": (None, (_ptr,)),
    "fastio_decode_rle": (_i64, (ctypes.c_char_p, _i64, _ptr, _i64)),
    "fastio_png_unfilter": (_i64, (ctypes.c_char_p, _i64, _i64, _i64, _ptr)),
    "fastio_png_adam7": (_i64, (ctypes.c_char_p, _i64, _i64, _i64, _i64, _ptr)),
    "fastio_resample_u8": (ctypes.c_int, (_ptr, _i64, _i64, _i64, _ptr, _ptr, _ptr, _i64, _i64,
                                          _ptr)),
}

_JPEG_SIGNATURES = {
    "jpeg_decode": (ctypes.c_int, (ctypes.c_char_p, _i64, _i64, _i64, _i64, _ptr,
                                   ctypes.c_char_p, _i64)),
}
_JPEG_DAMAGED, _JPEG_NO_MEMORY = 1, 3

calls = {"parse_obj": 0, "decode_rle": 0, "png_unfilter": 0, "png_adam7": 0,
         "resample_u8": 0, "decode_jpeg": 0}
_lock = threading.Lock()


def _lib() -> ctypes.CDLL:
    return cuda_build.load_host("fastio", _SIGNATURES)


def _count(name: str) -> None:
    with _lock:
        calls[name] += 1


def reset_calls() -> None:
    with _lock:
        for name in calls:
            calls[name] = 0


def _copy_out(lib, ptr: ctypes.c_void_p, n: int, ctype, dtype) -> np.ndarray:
    """The n values at ``ptr`` as a numpy array of its own; frees ``ptr``."""
    try:
        if n == 0:
            return np.zeros(0, dtype)
        return np.ctypeslib.as_array(ctypes.cast(ptr, ctypes.POINTER(ctype)), (n,)).copy()
    finally:
        lib.fastio_free(ptr)


def parse_obj(raw: bytes):
    """(vertices float32 [V, 3], faces int64 [F, 3]) of OBJ text, the face
    indices as the file writes them (1-based in a valid file)."""
    lib = _lib()
    vp, fp, nv, nf = _ptr(), _ptr(), _i64(), _i64()
    rc = lib.fastio_parse_obj(raw, len(raw), ctypes.byref(vp), ctypes.byref(nv),
                              ctypes.byref(fp), ctypes.byref(nf))
    if rc != 0:
        raise MemoryError("fastio_parse_obj ran out of memory")
    _count("parse_obj")
    verts = _copy_out(lib, vp, 3 * nv.value, ctypes.c_float, np.float32)
    faces = _copy_out(lib, fp, 3 * nf.value, ctypes.c_int64, np.int64)
    return verts.reshape(nv.value, 3), faces.reshape(nf.value, 3)


def decode_rle(payload: bytes, total: int) -> np.ndarray:
    """The uint8 [total] expansion of a binvox payload of (value, count) pairs:
    zeros after a payload that runs short, cut at ``total`` one that runs long."""
    out = np.empty(total, np.uint8)
    _lib().fastio_decode_rle(payload, len(payload), out.ctypes.data, total)
    _count("decode_rle")
    return out


def png_unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """The uint8 [height, stride] rows of ``height`` PNG scanlines of 1 + stride
    bytes each (filter type, then the filtered row); ``bpp`` is the bytes of a
    pixel, at least 1. Raises ValueError at a filter type outside 0-4."""
    if len(raw) < height * (stride + 1):
        raise ValueError(f"{len(raw)} bytes for {height} scanlines of {stride + 1}")
    out = np.empty((height, stride), np.uint8)
    bad = _lib().fastio_png_unfilter(raw, height, stride, max(bpp, 1), out.ctypes.data)
    _count("png_unfilter")
    if bad:
        raise ValueError(f"scanline {bad - 1} has filter type {raw[(bad - 1) * (stride + 1)]}")
    return out


def png_adam7(raw: bytes, width: int, height: int, bits: int) -> np.ndarray:
    """The uint8 [height, (width * bits + 7) // 8] rows of an Adam7-interlaced
    PNG image of ``bits`` a pixel, from its seven passes' scanlines (each
    pass unfiltered as an image of its own width, the empty ones absent).
    Raises ValueError when ``raw`` is too short or a filter type is outside
    0-4."""
    out = np.empty((height, (width * bits + 7) // 8), np.uint8)
    rc = _lib().fastio_png_adam7(raw, len(raw), width, height, bits, out.ctypes.data)
    _count("png_adam7")
    if rc == -1:
        raise ValueError(f"{len(raw)} bytes for the seven passes of a {width}x{height} image")
    if rc == -2:
        raise MemoryError("fastio_png_adam7 ran out of memory")
    if rc:
        raise ValueError(f"interlaced scanline {rc - 1} has a filter type outside 0-4")
    return out


def resample_u8(pixels: np.ndarray, start: np.ndarray, length: np.ndarray,
                weights: np.ndarray) -> np.ndarray:
    """One pass of Pillow's 8-bit resize along axis 1 of uint8 ``pixels``
    [outer, n_in, inner]: output position x is the sum of ``length[x]`` taps
    from ``start[x]`` weighted by int32 ``weights[x]`` (22 fractional bits),
    plus 2^21, shifted down 22 bits and clipped to 0-255."""
    pixels = np.ascontiguousarray(pixels, np.uint8)
    outer, n_in, inner = pixels.shape
    start = np.ascontiguousarray(start, np.int64)
    length = np.ascontiguousarray(length, np.int64)
    weights = np.ascontiguousarray(weights, np.int32)
    n_out, ksize = weights.shape
    if start.shape != (n_out,) or length.shape != (n_out,) or (
            n_out and ((start < 0).any() or (start + length > n_in).any()
                       or (length > ksize).any())):
        raise ValueError(f"resample windows out of range for {n_in} input positions")
    out = np.empty((outer, n_out, inner), np.uint8)
    if _lib().fastio_resample_u8(pixels.ctypes.data, outer, n_in, inner, start.ctypes.data,
                                 length.ctypes.data, weights.ctypes.data, ksize, n_out,
                                 out.ctypes.data) != 0:
        raise MemoryError("fastio_resample_u8 ran out of memory")
    _count("resample_u8")
    return out


def decode_jpeg(raw: bytes, width: int, height: int, channels: int) -> np.ndarray:
    """The uint8 [height, width, channels] samples of a JPEG file's bytes, as
    libjpeg-turbo gives them at Pillow's settings (RGB for a YCbCr file, CMYK
    not inverted); ``width``, ``height`` and ``channels`` are its frame's.
    Raises OSError naming the fault for a file libjpeg could not decode."""
    out = np.empty((height, width, channels), np.uint8)
    msg = ctypes.create_string_buffer(256)
    rc = cuda_build.load_host("jpeg", _JPEG_SIGNATURES).jpeg_decode(
        raw, len(raw), width, height, channels, out.ctypes.data, msg, len(msg))
    _count("decode_jpeg")
    text = msg.value.decode()
    if rc == _JPEG_DAMAGED:
        raise OSError(text)
    if rc == _JPEG_NO_MEMORY:
        raise MemoryError(f"jpeg_decode: {text}")
    return out
