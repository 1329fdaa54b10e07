"""The loader's host ops: normalize, one-hot and batch assembly in C++.

Counterpart of ide3d_tpu/data/_native. `host_ops.cpp` has a plain C
interface; g++ builds it at first use into build/ide3d_tpu_torch/
(`_build.build_host`, hashed over the source and flags) and ctypes calls it,
releasing the interpreter lock for each call. Where it cannot be built (no
compiler), the same functions run in numpy; `route()` says which one runs and
`build_error()` why the native one does not.

Both routes map class ids >= num_classes to class 0, as the JAX package's C++
route does (its numpy route clips them to num_classes - 1).
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from ... import _build

SOURCE = Path(__file__).resolve().parent / "host_ops.cpp"
_lock = threading.Lock()
_state: dict = {}  # "lib": the CDLL or None, "error": the build error or None


def _lib() -> Optional[ctypes.CDLL]:
    """The native library, built and loaded at the first call; None when it
    cannot be built."""
    with _lock:
        if "lib" not in _state:
            try:
                path, _ = _build.build_host(SOURCE)
                lib = ctypes.CDLL(str(path))
            except (OSError, RuntimeError) as e:  # no compiler, or it refused the source
                _state.update(lib=None, error=f"{type(e).__name__}: {e}")
            else:
                p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
                lib.ide3d_onehot_seg.argtypes = [p, p, i64, i64, i, i]
                lib.ide3d_normalize_img.argtypes = [p, p, i64, i64, i]
                lib.ide3d_batch_assemble.argtypes = [p, p, p, i64, i64, i64, i, p, p]
                for fn in (lib.ide3d_onehot_seg, lib.ide3d_normalize_img,
                           lib.ide3d_batch_assemble):
                    fn.restype = None
                _state.update(lib=lib, error=None)
        return _state["lib"]


def route() -> str:
    """"native" when the C++ library runs the ops, else "numpy"."""
    return "native" if _lib() is not None else "numpy"


def build_error() -> Optional[str]:
    """Why the native route is off, or None when it is on."""
    _lib()
    return _state["error"]


def _u8(a, ndim: int, what: str) -> np.ndarray:
    a = np.ascontiguousarray(a, np.uint8)
    if a.ndim != ndim or (ndim == 3 and a.shape[2] != 3):
        raise ValueError(f"expected {what}, got shape {a.shape}")
    return a


def _onehot_numpy(mask: np.ndarray, num_classes: int, flip: bool) -> np.ndarray:
    if flip:
        mask = mask[:, ::-1]
    ids = np.where(mask < num_classes, mask, 0).astype(np.int64)
    out = np.full((*mask.shape, num_classes), -1.0, np.float32)
    np.put_along_axis(out, ids[..., None], 1.0, axis=-1)
    return out


def _normalize_numpy(img: np.ndarray, flip: bool) -> np.ndarray:
    if flip:
        img = img[:, ::-1]
    return img.astype(np.float32) * np.float32(1.0 / 127.5) - np.float32(1.0)


def onehot_seg(mask, num_classes: int = 19, flip: bool = False) -> np.ndarray:
    """mask u8 [H,W] -> f32 [H,W,C] in {-1,+1}, x-flipped when `flip`."""
    mask = _u8(mask, 2, "a uint8 [H, W] mask")
    lib = _lib()
    if lib is None:
        return _onehot_numpy(mask, num_classes, flip)
    out = np.empty((*mask.shape, num_classes), np.float32)
    lib.ide3d_onehot_seg(mask.ctypes.data, out.ctypes.data, *mask.shape, num_classes, int(flip))
    return out


def normalize_img(img, flip: bool = False) -> np.ndarray:
    """img u8 [H,W,3] -> f32 [H,W,3] in [-1,1], x-flipped when `flip`."""
    img = _u8(img, 3, "a uint8 [H, W, 3] image")
    lib = _lib()
    if lib is None:
        return _normalize_numpy(img, flip)
    out = np.empty(img.shape, np.float32)
    lib.ide3d_normalize_img(img.ctypes.data, out.ctypes.data, *img.shape[:2], int(flip))
    return out


def batch_assemble(imgs: Sequence, segs: Optional[Sequence], xflips: Sequence,
                   num_classes: int = 19):
    """B images u8 [H,W,3] (and masks u8 [H,W], or None) -> (f32 [B,H,W,3],
    f32 [B,H,W,C] or None), each sample x-flipped where its xflip is true."""
    imgs = [_u8(i, 3, "uint8 [H, W, 3] images") for i in imgs]
    b = len(imgs)
    h, w = imgs[0].shape[:2]
    if any(i.shape[:2] != (h, w) for i in imgs):
        raise ValueError("inconsistent image sizes in batch")
    if segs is not None:
        segs = [_u8(s, 2, "uint8 [H, W] masks") for s in segs]
        if len(segs) != b or any(s.shape != (h, w) for s in segs):
            raise ValueError("masks must match the images in number and size")
    flips = [bool(f) for f in xflips]
    if len(flips) != b:
        raise ValueError(f"{len(flips)} flips for {b} images")
    lib = _lib()
    if lib is None:
        img_b = np.stack([_normalize_numpy(i, f) for i, f in zip(imgs, flips)])
        seg_b = None if segs is None else np.stack(
            [_onehot_numpy(s, num_classes, f) for s, f in zip(segs, flips)])
        return img_b, seg_b
    img_b = np.empty((b, h, w, 3), np.float32)
    seg_b = None if segs is None else np.empty((b, h, w, num_classes), np.float32)
    ptrs = ctypes.c_void_p * b
    lib.ide3d_batch_assemble(
        ptrs(*(i.ctypes.data for i in imgs)),
        None if segs is None else ptrs(*(s.ctypes.data for s in segs)),
        (ctypes.c_int * b)(*flips), b, h, w, num_classes,
        img_b.ctypes.data, None if seg_b is None else seg_b.ctypes.data)
    return img_b, seg_b
