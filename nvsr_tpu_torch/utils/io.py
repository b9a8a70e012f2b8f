"""Crash-safe artifact IO + run preemption signatures.

Reproduces the reference's atomic-write semantics
(reference nerf_helpers.py:19-67 safe_saving/safe_loading): write
`.<sfx>_temp`, rename old file to `.<sfx>_bckp`, rename temp into place,
delete backup; loading falls back '' -> _temp -> _bckp on corruption.

Also the `time_sig.txt` preemption protocol
(reference train_nerf.py:563, nerf_helpers.py:22-30): a newer run
writing to the same logdir makes the older run exit at its next save.

The port's copy of nvsr_tpu/utils/io.py. Two changes, both for the
optimizers' optax state (NamedTuples such as `ScaleByAdamState`) that the
JAX package's checkpoints pickle. `load_pickle` reads through a
restricted unpickler: a plain `pickle.load` would import optax, and with
it JAX; here those classes resolve to plain stand-ins with the same
fields, and any other global from `jax`, `jaxlib`, `optax` or `nvsr_tpu`
is refused. `save_pickle` writes the stand-ins back under optax's own
names, so the JAX package's plain `pickle.load` reads a port-written
checkpoint as one of its own, and the port never imports optax.
"""

from __future__ import annotations

import os
import pickle
import sys
from typing import Any, Callable, NamedTuple

import numpy as np


class PreemptedError(SystemExit):
    pass


def check_run_signature(run_folder: str, run_time_signature: float) -> None:
    """Claim/verify the logdir; exit if a newer run has claimed it."""
    if not run_time_signature:
        return
    sig_file = os.path.join(run_folder, "time_sig.txt")
    if os.path.exists(sig_file):
        with open(sig_file, "r") as f:
            saved = float(f.read())
        if saved < run_time_signature:
            with open(sig_file, "w") as f:
                f.write(str(run_time_signature))
        elif saved > run_time_signature:
            raise PreemptedError(
                "Exiting run %f since a newer run %f has started."
                % (run_time_signature, saved))
    else:
        with open(sig_file, "w") as f:
            f.write(str(run_time_signature))


def _variants(file_name: str, suffix: str):
    return {
        "temp": file_name.replace(f".{suffix}", f".{suffix}_temp"),
        "bckp": file_name.replace(f".{suffix}", f".{suffix}_bckp"),
    }


def safe_save(file_name: str, write_fn: Callable[[str], None], suffix: str,
              best: bool = False, run_time_signature: float = 0,
              run_folder: str = None) -> str:
    """Atomically write an artifact via `write_fn(temp_path)`.

    Returns the final path written.
    """
    if run_time_signature and run_folder:
        check_run_signature(run_folder, run_time_signature)
    if best:
        file_name = file_name.replace(f".{suffix}", f".{suffix}_best")
        suffix = f"{suffix}_best"
    v = _variants(file_name, suffix)
    write_fn(v["temp"])
    del_bckp = False
    if os.path.isfile(file_name):
        del_bckp = True
        os.rename(file_name, v["bckp"])
    os.rename(v["temp"], file_name)
    if del_bckp:
        os.remove(v["bckp"])
    return file_name


def safe_load(file_name: str, read_fn: Callable[[str], Any], suffix: str,
              best: bool = False) -> Any:
    if best:
        file_name = file_name.replace(f".{suffix}", f".{suffix}_best")
        suffix = f"{suffix}_best"
    v = _variants(file_name, suffix)
    for path in (file_name, v["temp"], v["bckp"]):
        try:
            return read_fn(path)
        except Exception as e:  # noqa: BLE001 - mirror reference fallback
            if path == v["bckp"]:
                raise
            print(f"!!!! WARNING: saved file {path} seems corrupted; "
                  f"falling back:\n{e}", file=sys.stderr)


def save_npz(file_name: str, arrays: dict, suffix: str = "npz",
             best: bool = False, run_time_signature: float = 0,
             run_folder: str = None) -> str:
    def write(path):
        np.savez(path, **arrays)

    # np.savez appends .npz; write to exact temp path via file handle
    def write_exact(path):
        with open(path, "wb") as f:
            np.savez(f, **arrays)

    return safe_save(file_name, write_exact, suffix, best=best,
                     run_time_signature=run_time_signature,
                     run_folder=run_folder)


def load_npz(file_name: str, suffix: str = "npz", best: bool = False) -> dict:
    def read(path):
        with np.load(path, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}

    return safe_load(file_name, read, suffix, best=best)


class ScaleByAdamState(NamedTuple):
    """Stand-in for optax's Adam state (count, first and second moments)."""
    count: Any
    mu: Any
    nu: Any


class EmptyState(NamedTuple):
    """Stand-in for optax's stateless-transform state."""


# the optax classes in the JAX package's checkpoints, by the module that
# defines them in optax (as pickletools.dis shows a JAX checkpoint): the
# decoders' and the SR net's optax.adam states (the planes' Adam state is
# stored as arrays in the plane files)
_OPTAX_PATHS = {ScaleByAdamState: ("optax._src.transform",
                                   "ScaleByAdamState"),
                EmptyState: ("optax._src.base", "EmptyState")}
_OPTAX_STAND_INS = {name: cls for cls, (_, name) in _OPTAX_PATHS.items()}
_REFUSED = ("jax", "jaxlib", "optax", "nvsr_tpu")


class PortPickler(pickle._Pickler):
    """Writes the optax stand-ins as optax's own globals. The C pickler
    checks a global by importing its module, which would need optax; the
    Python pickler's save_global can be overridden to emit the reference
    as pickle protocol 4 writes any global (module name, qualified name,
    STACK_GLOBAL)."""

    def save_global(self, obj, name=None):
        where = _OPTAX_PATHS.get(obj)
        if where is None:
            return super().save_global(obj, name)
        self.save(where[0])
        self.save(where[1])
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


def save_pickle(file_name: str, content, suffix: str = "pkl",
                best: bool = False, run_time_signature: float = 0,
                run_folder: str = None) -> str:
    def write(path):
        with open(path, "wb") as f:
            PortPickler(f, protocol=4).dump(content)

    return safe_save(file_name, write, suffix, best=best,
                     run_time_signature=run_time_signature,
                     run_folder=run_folder)


class PortUnpickler(pickle.Unpickler):
    """Maps optax's state classes to the stand-ins above and refuses any
    other global of the JAX stack, so loading never imports it."""

    def find_class(self, module, name):
        top = module.split(".")[0]
        if top == "optax" and name in _OPTAX_STAND_INS:
            return _OPTAX_STAND_INS[name]
        if top in _REFUSED:
            raise pickle.UnpicklingError(
                f"refusing to import {module}.{name} from a pickle")
        return super().find_class(module, name)


def load_pickle(file_name: str, suffix: str = "pkl", best: bool = False):
    def read(path):
        with open(path, "rb") as f:
            return PortUnpickler(f).load()

    return safe_load(file_name, read, suffix, best=best)
