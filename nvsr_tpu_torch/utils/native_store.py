"""ctypes bindings for the native array-bundle codec (native/nvsr_native.cpp).

Builds the shared library on first use (g++ is in the image; no
pybind11 — plain C ABI + ctypes). Falls back cleanly when the toolchain
or build is unavailable: callers check `available()`.

The port's copy of nvsr_tpu/utils/native_store.py. It compiles the same
source (unchanged) with the flags of native/Makefile, but into
build/nvsr_tpu_torch/native/ and never under native/: the library is
named by a digest of the source, the Makefile and the flags, compiled
into a per-process temporary and published with os.replace, so a file at
the final path is always whole and processes that build at once only
repeat a compile. It reads and writes the same NVPS files as the JAX
package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
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

_ROOT = Path(__file__).resolve().parent.parent.parent
NATIVE_DIR = _ROOT / "native"
BUILD_DIR = _ROOT / "build" / "nvsr_tpu_torch" / "native"
# native/Makefile's CXXFLAGS and LDFLAGS
CXXFLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall")
LDFLAGS = ("-shared", "-lz", "-lpthread")

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_failed = False
_lib_error = ""


def lib_path(build_dir=None) -> Path:
    """Where the library for this source, Makefile and flags is published."""
    digest = hashlib.sha256(
        (NATIVE_DIR / "nvsr_native.cpp").read_bytes()
        + (NATIVE_DIR / "Makefile").read_bytes()
        + " ".join(CXXFLAGS + LDFLAGS).encode()).hexdigest()
    return Path(build_dir or BUILD_DIR) / f"libnvsr_native-{digest[:16]}.so"


def _build_library(build_dir=None) -> str:
    """The published library's path, compiled first if it is missing.
    Raises RuntimeError (with the compiler's output) when there is no
    source or toolchain or the compile fails."""
    src = NATIVE_DIR / "nvsr_native.cpp"
    if not src.is_file():
        raise RuntimeError(f"no native source at {src}")
    target = lib_path(build_dir)
    if target.is_file():
        return str(target)
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found")
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run(
            [cxx, *CXXFLAGS, str(src), *LDFLAGS, "-o", str(tmp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            timeout=120)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for {src}:\n{proc.stdout}")
        os.replace(tmp, target)
    finally:
        tmp.unlink(missing_ok=True)
    return str(target)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
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
    return lib


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _lib_failed, _lib_error
    with _lib_lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            _lib = _bind(ctypes.CDLL(_build_library()))
        except (RuntimeError, OSError, subprocess.SubprocessError) as e:
            _lib_failed, _lib_error = True, str(e)
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
    assert lib is not None, \
        f"native store library unavailable: {_lib_error}"
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
    assert lib is not None, \
        f"native store library unavailable: {_lib_error}"
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
        assert lib is not None, \
            f"native store library unavailable: {_lib_error}"
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
