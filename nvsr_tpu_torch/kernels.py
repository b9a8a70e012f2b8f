"""Build and bind the port's hand-written CUDA kernels.

Each source under csrc/ is compiled by `nvcc` for sm_90a into its own
shared library with a plain C interface, loaded with ctypes (no PyTorch
headers, so a build takes seconds). Libraries go to build/nvsr_tpu_torch/
beside the package, named by a hash of the source and flags so a changed
source is rebuilt; they are built at first use, never at import. Every C
entry returns the cudaError_t of its launch and the wrapper raises on a
non-zero value. Each entry keeps a count of its launches (`launches`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "nvsr_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_lock = threading.Lock()
_libs: dict = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME") and
                 os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _lib_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{source.stem}-{digest[:16]}.so"


def build(sources=None, verbose: bool = False) -> dict:
    """Compile the given csrc/*.cu files (all of them by default), one
    nvcc per source, all started together. Returns {source name: library
    path}; raises with the compiler output if a build fails."""
    sources = [CSRC / s for s in sources] if sources else \
        sorted(CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    paths, procs = {}, []
    for src in sources:
        lib = _lib_path(src)
        paths[src.name] = lib
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS] + (["-Xptxas", "-v"] if verbose else []) \
            + ["-o", str(tmp), str(src)]
        procs.append((src, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for src, lib, tmp, proc in procs:
        out, _ = proc.communicate()
        if verbose and out:
            print(out)
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{out}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def _load(source: str) -> ctypes.CDLL:
    with _lock:
        if source not in _libs:
            _libs[source] = ctypes.CDLL(str(build([source])[source]))
        return _libs[source]


class CudaKernel:
    """One C entry of a csrc/ library; `launches` counts the launches
    made through it."""

    def __init__(self, source: str, symbol: str, argtypes):
        self.source, self.symbol, self.argtypes = source, symbol, argtypes
        self.launches = 0
        self._fn = None

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(_load(self.source), self.symbol)
            fn.argtypes, fn.restype = self.argtypes, ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            raise RuntimeError(f"{self.symbol}: CUDA launch failed with "
                               f"cudaError_t {err}")
        self.launches += 1


_P, _I = ctypes.c_void_p, ctypes.c_int
_TRIPLANE_ARGS = [_P, _I, _I, _I, _P, _P, _P, _I, _I, _P, _I, _P, _P, _P,
                  _P, _I, _I, _I, _P, _I, _I, _P, _P]
triplane_render_full = CudaKernel(
    "triplane_render.cu", "triplane_render_full", _TRIPLANE_ARGS)
triplane_render_sigma_only = CudaKernel(
    "triplane_render.cu", "triplane_render_sigma_only", _TRIPLANE_ARGS)
plane_sample_fwd = CudaKernel(
    "plane_sample.cu", "plane_sample_fwd",
    [_P, _I, _I, _I, _I, _I, _P, _I, _I, _P, _P])
plane_sample_bwd = CudaKernel(
    "plane_sample.cu", "plane_sample_bwd",
    [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P])
KERNELS = (triplane_render_full, triplane_render_sigma_only,
           plane_sample_fwd, plane_sample_bwd)


def _check(t, name, dtype, device, shape=None, aligned=False):
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous {dtype} tensor on "
                         f"{device}, got {t.dtype} on {t.device}")
    if aligned and t.data_ptr() % 16:
        raise ValueError(f"{name}: need a 16-byte aligned tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: need shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")


def triplane_render(table, packed, origins, directions, z_vals, view, geom,
                    *, align_corners: bool, avg: bool,
                    sigma_only: bool) -> torch.Tensor:
    """Launch csrc/triplane_render.cu on the current stream -> [R, S, 4]
    f32 (see ops/fused_render.py for the arguments and the math)."""
    dev = table.device
    if dev.type != "cuda":
        raise ValueError("triplane_render needs CUDA tensors")
    _, h, w, cp = table.shape
    r, s = z_vals.shape
    _check(table, "table", torch.bfloat16, dev, (3, h, w, packed.cp))
    _check(origins, "origins", torch.float32, dev, (r, 3))
    _check(directions, "directions", torch.float32, dev, (r, 3))
    _check(z_vals, "z_vals", torch.float32, dev)
    _check(packed.w, "packed.w", torch.bfloat16, dev)
    _check(packed.b, "packed.b", torch.float32, dev)
    _check(packed.wh, "packed.wh", torch.bfloat16, dev)
    _check(packed.bh, "packed.bh", torch.float32, dev)
    if packed.cp % 16 or packed.cvp % 16:
        raise ValueError("feature parts must be padded to 16 channels")
    if sigma_only:
        view_ptr = None
    else:
        _check(view, "view", torch.bfloat16, dev, (r, packed.cvp))
        view_ptr = view.data_ptr()
    out = torch.empty((r, s, 4), dtype=torch.float32, device=dev)
    if r * s == 0:
        return out
    g = (ctypes.c_float * 24)(*[float(v) for v in geom])
    kern = triplane_render_sigma_only if sigma_only else triplane_render_full
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        kern(table.data_ptr(), h, w, cp, origins.data_ptr(),
             directions.data_ptr(), z_vals.data_ptr(), r, s, view_ptr,
             packed.cvp, packed.w.data_ptr(), packed.b.data_ptr(),
             packed.wh.data_ptr(), packed.bh.data_ptr(), packed.n_density,
             packed.n_rgb, packed.skip_every, ctypes.cast(g, _P),
             int(align_corners), int(avg), out.data_ptr(), stream)
    return out


_INT_MAX = 2 ** 31 - 1


def plane_sample_forward(table, grids, channels: int, *,
                         align_corners: bool) -> torch.Tensor:
    """Launch plane_sample_fwd (csrc/plane_sample.cu) on the current
    stream: bf16 table [P, H, W, Cp] at grids [P, N, 2] f32 -> [P, N,
    channels] f32 (see ops/plane_sample.py for the math)."""
    dev = table.device
    if dev.type != "cuda":
        raise ValueError("plane_sample_forward needs CUDA tensors")
    p, h, w, cp = table.shape
    n = grids.shape[1]
    _check(table, "table", torch.bfloat16, dev, aligned=True)
    _check(grids, "grids", torch.float32, dev, (p, n, 2), aligned=True)
    if channels % 8 or cp % 8 or channels > cp:
        raise ValueError(f"channels {channels} / table width {cp}: the "
                         f"kernel needs multiples of 8, channels <= width")
    if p * n * channels > _INT_MAX or p * h * w * cp > _INT_MAX:
        raise ValueError("plane_sample_forward: tensors too large")
    out = torch.empty((p, n, channels), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        plane_sample_fwd(table.data_ptr(), p, h, w, cp, channels,
                         grids.data_ptr(), n, int(align_corners),
                         out.data_ptr(), stream)
    return out


def plane_sample_backward(dout, grids, height: int, width: int, *,
                          align_corners: bool) -> torch.Tensor:
    """Launch plane_sample_bwd (csrc/plane_sample.cu) on the current
    stream: dout [P, N, C] f32 at grids [P, N, 2] -> dplanes [P, C, H, W]
    f32, accumulated with atomics (summation order varies by run)."""
    dev = dout.device
    if dev.type != "cuda":
        raise ValueError("plane_sample_backward needs CUDA tensors")
    p, n, c = dout.shape
    _check(dout, "dout", torch.float32, dev, aligned=True)
    _check(grids, "grids", torch.float32, dev, (p, n, 2), aligned=True)
    if p * n * c > _INT_MAX or p * height * width * c > _INT_MAX:
        raise ValueError("plane_sample_backward: tensors too large")
    scratch = torch.empty((p, height, width, c), dtype=torch.float32,
                          device=dev)
    out = torch.empty((p, c, height, width), dtype=torch.float32,
                      device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        plane_sample_bwd(dout.data_ptr(), grids.data_ptr(), p, n, c, height,
                         width, int(align_corners), scratch.data_ptr(),
                         out.data_ptr(), stream)
    return out
