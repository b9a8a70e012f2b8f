"""The port's build of the native plane-store library
(nvsr_tpu_torch/utils/native_store.py) under concurrent first use.

Each test process may be the first to need the library on a fresh tree,
so many build it at once: a process must never find a partial file at
the published path. The builders run as separate processes that load the
port's native_store.py by its file (numpy only, no torch), so their
compiles overlap as they would under pytest-xdist, torchrun or the CLI.
"""

import filecmp
import importlib.util
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

from nvsr_tpu_torch import kernels
from nvsr_tpu_torch.utils import native_store

ROOT = Path(__file__).resolve().parent.parent
STORE_PY = ROOT / "nvsr_tpu_torch" / "utils" / "native_store.py"
LIB_NAME = re.compile(r"libnvsr_native-[0-9a-f]{16}\.so")

# one builder: build into argv[2] and load the library, then round-trip a
# bf16 and an f32 array through argv[3]
BUILDER = r"""
import ctypes, importlib.util, sys
import ml_dtypes
import numpy as np
spec = importlib.util.spec_from_file_location("native_store", sys.argv[1])
ns = importlib.util.module_from_spec(spec)
spec.loader.exec_module(ns)
build_dir, out, seed = sys.argv[2], sys.argv[3], int(sys.argv[4])
ns._lib = ns._bind(ctypes.CDLL(ns._build_library(build_dir)))
rng = np.random.default_rng(seed)
arrays = {"bf16": rng.standard_normal((3, 4, 5)).astype(ml_dtypes.bfloat16),
          "f32": rng.standard_normal((2, 7)).astype(np.float32)}
ns.save_arrays(out, arrays)
got = ns.load_arrays(out)
for k, a in arrays.items():
    assert got[k].dtype == a.dtype and got[k].shape == a.shape, k
    assert got[k].tobytes() == a.tobytes(), k
"""

# loads every file that matches argv[1] as soon as it exists, until argv[2]
# exists; prints its loads and its OSErrors
WATCHER = r"""
import ctypes, glob, os, sys, time
pattern, stop = sys.argv[1], sys.argv[2]
loads, errors = 0, []
print("ready", flush=True)
deadline = time.monotonic() + 90
while not os.path.exists(stop) and time.monotonic() < deadline:
    for path in glob.glob(pattern):
        loads += 1
        try:
            ctypes.CDLL(path)
        except OSError as e:
            errors.append(str(e))
print(loads, len(errors), errors[:3], flush=True)
"""


def _run_builders(tmp_path, build_dir, n, gap_s=0.1):
    """n builders started gap_s apart on build_dir -> their outputs."""
    procs = []
    try:
        for i in range(n):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", BUILDER, str(STORE_PY),
                 str(build_dir), str(tmp_path / f"bundle{i}.planes"),
                 str(i)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
            time.sleep(gap_s)
        return [(p.wait(timeout=120), p.stdout.read()) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def test_staggered_builders_all_load_one_library(tmp_path):
    """12 processes arriving 0.1 s apart on an empty build directory all
    load a whole library and round-trip bf16 and f32 bit-equal; one
    library remains and no temporary."""
    build_dir = tmp_path / "build"
    results = _run_builders(tmp_path, build_dir, 12)
    assert [rc for rc, _ in results] == [0] * 12, \
        [out for rc, out in results if rc]
    names = sorted(os.listdir(build_dir))
    assert len(names) == 1 and LIB_NAME.fullmatch(names[0]), names


def test_watcher_never_sees_a_partial_library(tmp_path):
    """A process that loads the published path whenever it exists, while
    6 staggered builders compile, never gets an OSError."""
    build_dir, stop = tmp_path / "build", tmp_path / "stop"
    watcher = subprocess.Popen(
        [sys.executable, "-c", WATCHER, str(build_dir / "*.so"), str(stop)],
        stdout=subprocess.PIPE, text=True)
    try:
        assert watcher.stdout.readline() == "ready\n"
        results = _run_builders(tmp_path, build_dir, 6)
        time.sleep(0.2)
        stop.touch()
        out, _ = watcher.communicate(timeout=60)
    finally:
        if watcher.poll() is None:
            watcher.kill()
            watcher.wait()
    assert watcher.returncode == 0, out
    loads, errors = out.split(" ", 2)[:2]
    assert int(loads) > 0 and int(errors) == 0, out
    assert [rc for rc, _ in results] == [0] * 6, results


def test_builds_under_build_and_writes_nothing_under_native(tmp_path):
    """The default library lies in build/nvsr_tpu_torch/native/, beside
    the CUDA kernels' libraries; a copy of the module built in a copy of
    the tree leaves that tree's native/ as it was."""
    assert native_store.BUILD_DIR == kernels.BUILD_DIR / "native"
    assert native_store.lib_path().parent == kernels.BUILD_DIR / "native"
    assert LIB_NAME.fullmatch(native_store.lib_path().name)

    store_py = tmp_path / "nvsr_tpu_torch" / "utils" / "native_store.py"
    store_py.parent.mkdir(parents=True)
    shutil.copy(STORE_PY, store_py)
    shutil.copytree(ROOT / "native", tmp_path / "native",
                    ignore=shutil.ignore_patterns("build"))
    before = sorted(p.relative_to(tmp_path)
                    for p in (tmp_path / "native").rglob("*"))
    spec = importlib.util.spec_from_file_location("native_store_copy",
                                                  store_py)
    copy = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(copy)
    assert copy.available(), copy._lib_error
    lib = copy.lib_path()
    assert lib.parent == tmp_path / "build" / "nvsr_tpu_torch" / "native"
    assert lib.name == native_store.lib_path().name and lib.is_file()
    assert sorted(os.listdir(lib.parent)) == [lib.name]
    after = sorted(p.relative_to(tmp_path)
                   for p in (tmp_path / "native").rglob("*"))
    assert after == before
    for rel in before:
        assert filecmp.cmp(ROOT / rel, tmp_path / rel, shallow=False), rel
