"""Gloo worlds on the CPU for the port's data-parallel tests: each rank is
a process of its own (`python -c`, one torch thread), started with its
rank, the world size and a file:// rendezvous; a rank function
`module:function(rank, world, **kwargs)` runs inside the process group
and its picklable result comes back through a file. A world that fails
or outlasts its timeout kills its processes and fails the test, so a
hang costs the timeout, not the suite. The rank functions live in
tests/torch_dist_ranks.py, which imports no JAX."""

import os
import pickle
import subprocess
import sys
import time
import uuid

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)

_BOOT = """
import importlib, pickle, sys
import torch
import torch.distributed as dist
target, rank, world, rdv, args, out = sys.argv[1:7]
rank, world = int(rank), int(world)
torch.set_num_threads(1)
if rdv != "-":
    dist.init_process_group("gloo", init_method=rdv, rank=rank,
                            world_size=world)
module, fn = target.split(":")
with open(args, "rb") as f:
    kwargs = pickle.load(f)
result = getattr(importlib.import_module(module), fn)(rank, world, **kwargs)
if rdv != "-":
    dist.destroy_process_group()
with open(out, "wb") as f:
    pickle.dump(result, f)
"""


def env():
    """The ranks' environment: the repo and tests/ importable, one
    thread, gloo on the loopback interface."""
    return dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, TESTS]),
                OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")


def start(target: str, world: int, kwargs: dict, tmp, group=True):
    """Start one world (group=False: `world` lone processes without a
    process group); returns its handle for `finish`."""
    tag = uuid.uuid4().hex[:8]
    args = os.path.join(tmp, f"args_{tag}.pkl")
    with open(args, "wb") as f:
        pickle.dump(kwargs, f)
    rdv = f"file://{os.path.join(tmp, f'rdv_{tag}')}" if group else "-"
    procs = []
    for r in range(world):
        out = os.path.join(tmp, f"out_{tag}_{r}.pkl")
        with open(out + ".log", "w") as log:
            p = subprocess.Popen(
                [sys.executable, "-c", _BOOT, target, str(r), str(world),
                 rdv, args, out], env=env(), cwd=REPO, stdout=log,
                stderr=subprocess.STDOUT)
        procs.append((p, out))
    return procs


def finish(procs, timeout: float = 120.0) -> list:
    """The ranks' results, in rank order; AssertionError (every process
    killed) if a rank fails or the world outlasts `timeout` seconds."""
    deadline = time.monotonic() + timeout
    try:
        for p, _ in procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"a world outlasted {timeout} s")
        for r, (p, out) in enumerate(procs):
            if p.returncode != 0:
                with open(out + ".log") as f:
                    raise AssertionError(f"rank {r} failed:\n"
                                         f"{f.read()[-4000:]}")
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for _, out in procs:
        with open(out, "rb") as f:
            results.append(pickle.load(f))
    return results


def run_world(target: str, world: int, kwargs: dict, tmp, group=True,
              timeout: float = 120.0) -> list:
    return finish(start(target, world, kwargs, tmp, group), timeout)
