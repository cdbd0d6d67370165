"""ctypes binding for the native RLE mask library (host C++).

Counterpart of ``rsis_tpu/kernels/_binding.py``: typed wrappers over the
flat-buffer C ABI of ``rle/rle.cpp`` (a copy of the JAX package's). The
library is compiled with ``g++`` at first use into
``build/rsis_tpu_torch/`` at the repository root, named by a hash of the
source and the flags, never beside the source; an unchanged source is
reused, and a failed build raises (there is no numpy fallback).

The pycocotools-compatible API lives in :mod:`rsis_tpu_torch.kernels.mask`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "rle" / "rle.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "rsis_tpu_torch"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_build_lock = threading.Lock()
_lib = None

_u64p = ctypes.POINTER(ctypes.c_uint64)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_f64p = ctypes.POINTER(ctypes.c_double)


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / f"librle-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile rle.cpp (unless this source is built already); returns the
    library's path. Raises RuntimeError with g++'s output on failure."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(_SRC)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"RLE library build failed (g++ exited "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _build_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))

        u64 = ctypes.c_uint64
        lib.rsis_rle_encode.argtypes = [_u8p, u64, u64, u64, _u32p, _u64p]
        lib.rsis_rle_decode.argtypes = [_u32p, _u64p, _u64p, u64, u64, u64, _u8p]
        lib.rsis_rle_area.argtypes = [_u32p, _u64p, _u64p, u64, _u32p]
        lib.rsis_rle_merge.argtypes = [
            _u32p, _u64p, _u64p, u64, u64, u64, ctypes.c_int, _u32p, _u64p]
        lib.rsis_rle_iou.argtypes = [
            _u32p, _u64p, _u64p, _u64p, u64,
            _u32p, _u64p, _u64p, _u64p, u64, _u8p, _f64p]
        lib.rsis_rle_to_bbox.argtypes = [_u32p, _u64p, _u64p, _u64p, u64, _f64p]
        lib.rsis_bb_iou.argtypes = [_f64p, _f64p, u64, u64, _u8p, _f64p]
        lib.rsis_rle_from_bbox.argtypes = [_f64p, u64, u64, u64, _u32p, _u64p]
        lib.rsis_rle_from_poly.argtypes = [_f64p, u64, u64, u64, _u32p, _u64p]
        lib.rsis_rle_nms.argtypes = [
            _u32p, _u64p, _u64p, _u64p, u64, ctypes.c_double, _u32p]
        lib.rsis_bb_nms.argtypes = [_f64p, u64, ctypes.c_double, _u32p]
        lib.rsis_rle_to_string.argtypes = [_u32p, u64, ctypes.c_char_p]
        lib.rsis_rle_to_string.restype = u64
        lib.rsis_rle_from_string.argtypes = [ctypes.c_char_p, u64, u64, _u32p]
        lib.rsis_rle_from_string.restype = u64
        _lib = lib
    return _lib


def _as_u32p(a: np.ndarray):
    return a.ctypes.data_as(_u32p)


def _as_u64p(a: np.ndarray):
    return a.ctypes.data_as(_u64p)


def _as_u8p(a: np.ndarray):
    return a.ctypes.data_as(_u8p)


def _as_f64p(a: np.ndarray):
    return a.ctypes.data_as(_f64p)


def _pack(cnts_list):
    """Concatenate per-mask count arrays into (flat, offsets, lengths)."""
    ms = np.array([len(c) for c in cnts_list], dtype=np.uint64)
    offs = np.zeros(len(cnts_list), dtype=np.uint64)
    if len(cnts_list):
        offs[1:] = np.cumsum(ms[:-1])
    flat = (np.concatenate(cnts_list).astype(np.uint32)
            if len(cnts_list) else np.zeros(0, dtype=np.uint32))
    return np.ascontiguousarray(flat), offs, ms


def encode(masks_fortran: np.ndarray):
    """Encode n column-major uint8 masks of shape (h, w, n) -> list of count arrays."""
    h, w, n = masks_fortran.shape
    flat = np.asfortranarray(masks_fortran, dtype=np.uint8)
    # Fortran layout of (h, w, n) puts each mask's column-major pixels
    # contiguously per n-slice.
    buf = flat.ravel(order="F")
    stride = h * w + 1
    out_cnts = np.empty(n * stride, dtype=np.uint32)
    out_m = np.empty(n, dtype=np.uint64)
    _load().rsis_rle_encode(
        _as_u8p(buf), h, w, n, _as_u32p(out_cnts), _as_u64p(out_m))
    return [out_cnts[i * stride:i * stride + int(out_m[i])].copy()
            for i in range(n)]


def decode(cnts_list, h: int, w: int) -> np.ndarray:
    """Decode n RLEs into an (h, w, n) uint8 Fortran-ordered array."""
    n = len(cnts_list)
    flat, offs, ms = _pack(cnts_list)
    out = np.empty(h * w * n, dtype=np.uint8)
    _load().rsis_rle_decode(
        _as_u32p(flat), _as_u64p(offs), _as_u64p(ms), h, w, n, _as_u8p(out))
    return out.reshape((h, w, n), order="F")


def area(cnts_list) -> np.ndarray:
    flat, offs, ms = _pack(cnts_list)
    out = np.empty(len(cnts_list), dtype=np.uint32)
    _load().rsis_rle_area(
        _as_u32p(flat), _as_u64p(offs), _as_u64p(ms), len(cnts_list),
        _as_u32p(out))
    return out


def merge(cnts_list, h: int, w: int, intersect: bool):
    flat, offs, ms = _pack(cnts_list)
    out_cnts = np.empty(h * w + 1, dtype=np.uint32)
    out_m = np.zeros(1, dtype=np.uint64)
    _load().rsis_rle_merge(
        _as_u32p(flat), _as_u64p(offs), _as_u64p(ms), len(cnts_list), h, w,
        1 if intersect else 0, _as_u32p(out_cnts), _as_u64p(out_m))
    return out_cnts[:int(out_m[0])].copy()


def iou(dt_cnts, dt_hw, gt_cnts, gt_hw, iscrowd) -> np.ndarray:
    """Mask IoU. Returns array of shape (m, n): IoU of dt d vs gt g."""
    m, n = len(dt_cnts), len(gt_cnts)
    dflat, doffs, dms = _pack(dt_cnts)
    gflat, goffs, gms = _pack(gt_cnts)
    dhw = np.ascontiguousarray(np.asarray(dt_hw, dtype=np.uint64)).ravel()
    ghw = np.ascontiguousarray(np.asarray(gt_hw, dtype=np.uint64)).ravel()
    crowd = np.ascontiguousarray(np.asarray(iscrowd, dtype=np.uint8))
    out = np.empty(m * n, dtype=np.float64)
    _load().rsis_rle_iou(
        _as_u32p(dflat), _as_u64p(doffs), _as_u64p(dms), _as_u64p(dhw), m,
        _as_u32p(gflat), _as_u64p(goffs), _as_u64p(gms), _as_u64p(ghw), n,
        _as_u8p(crowd), _as_f64p(out))
    # C layout is o[g*m + d] -> reshape to (n, m) then transpose to (m, n)
    return out.reshape(n, m).T.copy()


def to_bbox(cnts_list, hw) -> np.ndarray:
    n = len(cnts_list)
    flat, offs, ms = _pack(cnts_list)
    hw_arr = np.ascontiguousarray(np.asarray(hw, dtype=np.uint64)).ravel()
    out = np.empty(n * 4, dtype=np.float64)
    _load().rsis_rle_to_bbox(
        _as_u32p(flat), _as_u64p(offs), _as_u64p(ms), _as_u64p(hw_arr), n,
        _as_f64p(out))
    return out.reshape(n, 4)


def bb_iou(dt: np.ndarray, gt: np.ndarray, iscrowd) -> np.ndarray:
    m, n = len(dt), len(gt)
    d = np.ascontiguousarray(dt, dtype=np.float64)
    g = np.ascontiguousarray(gt, dtype=np.float64)
    crowd = np.ascontiguousarray(np.asarray(iscrowd, dtype=np.uint8))
    out = np.empty(m * n, dtype=np.float64)
    _load().rsis_bb_iou(_as_f64p(d), _as_f64p(g), m, n, _as_u8p(crowd),
                        _as_f64p(out))
    return out.reshape(n, m).T.copy()


def from_bbox(bb: np.ndarray, h: int, w: int):
    n = len(bb)
    b = np.ascontiguousarray(bb, dtype=np.float64)
    stride = h * w + 1
    out_cnts = np.empty(n * stride, dtype=np.uint32)
    out_m = np.empty(n, dtype=np.uint64)
    _load().rsis_rle_from_bbox(
        _as_f64p(b), h, w, n, _as_u32p(out_cnts), _as_u64p(out_m))
    return [out_cnts[i * stride:i * stride + int(out_m[i])].copy()
            for i in range(n)]


def from_poly(xy: np.ndarray, h: int, w: int):
    p = np.ascontiguousarray(np.asarray(xy, dtype=np.float64)).ravel()
    k = len(p) // 2
    out_cnts = np.empty(h * w + 1, dtype=np.uint32)
    out_m = np.zeros(1, dtype=np.uint64)
    _load().rsis_rle_from_poly(
        _as_f64p(p), k, h, w, _as_u32p(out_cnts), _as_u64p(out_m))
    return out_cnts[:int(out_m[0])].copy()


def nms(cnts_list, hw, thr: float) -> np.ndarray:
    n = len(cnts_list)
    flat, offs, ms = _pack(cnts_list)
    hw_arr = np.ascontiguousarray(np.asarray(hw, dtype=np.uint64)).ravel()
    keep = np.empty(n, dtype=np.uint32)
    _load().rsis_rle_nms(
        _as_u32p(flat), _as_u64p(offs), _as_u64p(ms), _as_u64p(hw_arr), n,
        thr, _as_u32p(keep))
    return keep


def bb_nms(bb: np.ndarray, thr: float) -> np.ndarray:
    n = len(bb)
    b = np.ascontiguousarray(bb, dtype=np.float64)
    keep = np.empty(n, dtype=np.uint32)
    _load().rsis_bb_nms(_as_f64p(b), n, thr, _as_u32p(keep))
    return keep


def to_string(cnts: np.ndarray) -> bytes:
    c = np.ascontiguousarray(cnts, dtype=np.uint32)
    buf = ctypes.create_string_buffer(6 * len(c) + 1)
    ln = _load().rsis_rle_to_string(_as_u32p(c), len(c), buf)
    return buf.raw[:ln]


def from_string(s: bytes, h: int, w: int) -> np.ndarray:
    # every run consumes >=1 char, so len(s) bounds the run count even when
    # the caller passes degenerate h/w (h*w+2 alone under-allocates then)
    out = np.empty(max(h * w, len(s)) + 2, dtype=np.uint32)
    m = _load().rsis_rle_from_string(s, h, w, _as_u32p(out))
    return out[:int(m)].copy()
