"""ctypes bindings for the native array-bundle codec (native/nvsr_native.cpp).

Builds the shared library on first use (g++ is in the image; no
pybind11 — plain C ABI + ctypes). Falls back cleanly when the toolchain
or build is unavailable: callers check `available()`.

The port's copy of nvsr_tpu/utils/native_store.py: it builds the same
`native/` library (unchanged) with `make`, and reads and writes the same
NVPS files as the JAX package.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_MAX_DIMS = 8
_MAX_NAME = 64

# stable dtype codes for the file format
_DTYPE_CODES = {
    np.dtype("float32"): 1,
    np.dtype("float64"): 2,
    np.dtype("int32"): 3,
    np.dtype("int64"): 4,
    np.dtype("uint8"): 5,
    np.dtype("bool"): 6,
    np.dtype("float16"): 7,
    np.dtype("uint32"): 8,
}
_CODE_DTYPES = {v: k for k, v in _DTYPE_CODES.items()}
# bfloat16 is stored as raw uint16 payload with its own code
_BF16_CODE = 9

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_failed = False


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def _build_library() -> Optional[str]:
    native_dir = os.path.join(_repo_root(), "native")
    target = os.path.join(native_dir, "build", "libnvsr_native.so")
    src = os.path.join(native_dir, "nvsr_native.cpp")
    if not os.path.isfile(src):
        return None
    if (os.path.isfile(target)
            and os.path.getmtime(target) >= os.path.getmtime(src)):
        return target
    try:
        subprocess.run(["make", "-C", native_dir], check=True,
                       capture_output=True, timeout=120)
        return target if os.path.isfile(target) else None
    except Exception:
        return None


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _lib_failed
    with _lib_lock:
        if _lib is not None or _lib_failed:
            return _lib
        path = _build_library()
        if path is None:
            _lib_failed = True
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            _lib_failed = True
            return None
        c = ctypes
        lib.nvps_write.restype = c.c_int
        lib.nvps_write.argtypes = [
            c.c_char_p, c.c_int32, c.POINTER(c.c_char_p),
            c.POINTER(c.c_int32), c.POINTER(c.c_int32),
            c.POINTER(c.c_int64), c.POINTER(c.c_void_p),
            c.POINTER(c.c_int64)]
        lib.nvps_open.restype = c.c_int64
        lib.nvps_open.argtypes = [c.c_char_p]
        lib.nvps_num_arrays.restype = c.c_int32
        lib.nvps_num_arrays.argtypes = [c.c_int64]
        lib.nvps_get_info.restype = c.c_int
        lib.nvps_get_info.argtypes = [
            c.c_int64, c.c_int32, c.c_char_p, c.POINTER(c.c_int32),
            c.POINTER(c.c_int32), c.POINTER(c.c_int64),
            c.POINTER(c.c_int64)]
        lib.nvps_read.restype = c.c_int
        lib.nvps_read.argtypes = [c.c_int64, c.c_int32, c.c_void_p]
        lib.nvps_close.restype = None
        lib.nvps_close.argtypes = [c.c_int64]
        lib.nvps_prefetch_start.restype = c.c_int64
        lib.nvps_prefetch_start.argtypes = [c.POINTER(c.c_char_p),
                                            c.c_int32, c.c_int32]
        lib.nvps_prefetch_remaining.restype = c.c_int32
        lib.nvps_prefetch_remaining.argtypes = [c.c_int64]
        lib.nvps_prefetch_join.restype = None
        lib.nvps_prefetch_join.argtypes = [c.c_int64]
        _lib = lib
        return _lib


def available() -> bool:
    return _get_lib() is not None


def _dtype_code(arr: np.ndarray) -> int:
    if arr.dtype.name == "bfloat16":
        return _BF16_CODE
    code = _DTYPE_CODES.get(arr.dtype)
    if code is None:
        raise TypeError(f"unsupported dtype for native store: {arr.dtype}")
    return code


def save_arrays(path: str, arrays: dict) -> None:
    """Atomically write {name: ndarray} as an NVPS bundle."""
    lib = _get_lib()
    assert lib is not None, "native store library unavailable"
    items = list(arrays.items())
    n = len(items)
    names = (ctypes.c_char_p * n)(
        *[k.encode() for k, _ in items])
    np_arrays = []
    dtypes = (ctypes.c_int32 * n)()
    ndims = (ctypes.c_int32 * n)()
    shapes = (ctypes.c_int64 * (n * _MAX_DIMS))()
    datas = (ctypes.c_void_p * n)()
    nbytes = (ctypes.c_int64 * n)()
    for i, (k, v) in enumerate(items):
        assert len(k.encode()) < _MAX_NAME, f"name too long: {k}"
        a = np.ascontiguousarray(v)
        assert a.ndim <= _MAX_DIMS
        np_arrays.append(a)  # keep alive
        dtypes[i] = _dtype_code(a)
        ndims[i] = a.ndim
        for d, sdim in enumerate(a.shape):
            shapes[i * _MAX_DIMS + d] = sdim
        datas[i] = a.ctypes.data_as(ctypes.c_void_p).value
        nbytes[i] = a.nbytes
    rc = lib.nvps_write(path.encode(), n, names, dtypes, ndims, shapes,
                        datas, nbytes)
    if rc != 0:
        raise IOError(f"nvps_write failed ({rc}) for {path}")


def load_arrays(path: str) -> dict:
    """Read an NVPS bundle into {name: ndarray}."""
    lib = _get_lib()
    assert lib is not None, "native store library unavailable"
    handle = lib.nvps_open(path.encode())
    if handle == 0:
        raise IOError(f"nvps_open failed (missing/corrupt): {path}")
    try:
        out = {}
        n = lib.nvps_num_arrays(handle)
        for i in range(n):
            name = ctypes.create_string_buffer(_MAX_NAME)
            dtype = ctypes.c_int32()
            ndim = ctypes.c_int32()
            shape = (ctypes.c_int64 * _MAX_DIMS)()
            nb = ctypes.c_int64()
            rc = lib.nvps_get_info(handle, i, name, ctypes.byref(dtype),
                                   ctypes.byref(ndim), shape,
                                   ctypes.byref(nb))
            if rc != 0:
                raise IOError(f"nvps_get_info failed for {path}[{i}]")
            shp = tuple(shape[d] for d in range(ndim.value))
            if dtype.value == _BF16_CODE:
                arr = np.empty(shp, dtype=np.uint16)
            else:
                arr = np.empty(shp, dtype=_CODE_DTYPES[dtype.value])
            assert arr.nbytes == nb.value, (arr.nbytes, nb.value)
            rc = lib.nvps_read(handle, i,
                               arr.ctypes.data_as(ctypes.c_void_p))
            if rc != 0:
                raise IOError(f"nvps_read failed for {path}[{i}]")
            if dtype.value == _BF16_CODE:
                import ml_dtypes
                arr = arr.view(ml_dtypes.bfloat16)
            out[name.value.decode()] = arr
        return out
    finally:
        lib.nvps_close(handle)


def is_nvps_file(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            # little-endian uint32 0x4E565053 ("NVPS")
            return f.read(4) == b"SPVN"
    except OSError:
        return False


class Prefetcher:
    """Warms the page cache for upcoming files on background threads."""

    def __init__(self, paths, n_threads: int = 2):
        lib = _get_lib()
        assert lib is not None
        self._lib = lib
        paths = [p for p in paths if os.path.isfile(p)]
        arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        self._handle = lib.nvps_prefetch_start(arr, len(paths), n_threads)

    def remaining(self) -> int:
        if not self._handle:
            return 0
        return self._lib.nvps_prefetch_remaining(self._handle)

    def join(self):
        if self._handle:
            self._lib.nvps_prefetch_join(self._handle)
            self._handle = 0

    def __del__(self):
        try:
            self.join()
        except Exception:
            pass
