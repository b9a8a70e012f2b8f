"""Data-parallel training through the Experiment, one process a rank.

The cell's traffic sets `experiment.data_parallel` (its "config" keys)
over a world of `world` ranks, as `cli.py` runs under torchrun: this
process is rank 0, and ranks 1 .. world - 1 are processes of their own
(`python -m gpubench.drivers.train_dp <spec> <rank>`). With a card a
rank, each rank computes on cuda:<rank> with an NCCL device group (and
the Experiment's gloo host group); with fewer cards than ranks (the
limits' readings, `cell_readings.py`, on one card) every rank shares the
caller's card over gloo, and on the CPU the ranks are gloo CPU ranks.

Every rank writes the scenes, builds the Experiment and hands it the
benchmark's weights from the seed, and draws the same traffic from the
seed (drivers/train.py's `Draws`): each iteration's global batch, whose
rows the Experiment splits over the ranks. The loop is train.py's:
the checked round, the warm-up to a round's end, then whole rounds until
rank 0's window is over, which rank 0 tells the others at each round's
start over the host group. Rank 0 alone profiles (--trace 1), times the
window and, once the other ranks have exited, follows the checked
iterations with the plain reference on the global batch in one world.
"""

from __future__ import annotations

import datetime
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

from gpubench import cell_faults
from gpubench.drivers import loop, train

# seconds a rank may wait in one collective, and the other ranks' exit
TIMEOUT_S = 600


class _RankContext:
    """The part of harness.Context a rank that is not rank 0 reads."""

    def __init__(self, spec, rank):
        import torch
        self.cell, self.seed = spec["cell"], int(spec["seed"])
        self.config, self.traffic = spec["config"], spec["traffic"]
        self.overrides, self.trace = spec["overrides"], False
        self.device = torch.device(spec["device"][str(rank)])

    def note(self, what):
        pass

    def param(self, key):
        return self.overrides.get(key, self.traffic.get(key))


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run(ctx):
    import torch
    world = int(ctx.param("world"))
    # NCCL and a card a rank where there is one for each; else gloo, every
    # rank on rank 0's device
    nccl = ctx.device.type == "cuda" and torch.cuda.device_count() >= world
    for k in ("GLOO_SOCKET_IFNAME", "NCCL_SOCKET_IFNAME"):
        os.environ.setdefault(k, "lo")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(p for p in sys.path
                                          if p and os.path.isdir(p)))
    tmp = tempfile.TemporaryDirectory()
    spec = {"cell": ctx.cell, "seed": ctx.seed, "config": ctx.config,
            "traffic": ctx.traffic,
            "overrides": {k: v for k, v in ctx.overrides.items()
                          if k != "control"},
            "world": world, "backend": "nccl" if nccl else "gloo",
            "init": f"tcp://localhost:{_free_port()}",
            "device": {str(r): f"cuda:{r}" if nccl else str(ctx.device)
                       for r in range(world)}}
    path = os.path.join(tmp.name, "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    procs = []
    try:
        for r in range(1, world):
            log = open(os.path.join(tmp.name, f"rank{r}.log"), "w")
            procs.append((subprocess.Popen(
                [sys.executable, "-m", "gpubench.drivers.train_dp", path,
                 str(r)], cwd=here, env=env, stdout=log,
                stderr=subprocess.STDOUT), log))
        with cell_faults.planted(spec["overrides"].get("fault")):
            program = rank_loop(ctx, 0, spec)
        _join(procs, tmp.name)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    try:
        train.check(ctx, *program, control=bool(ctx.overrides.get(
            "control")))
    finally:
        tmp.cleanup()


def _join(procs, folder):
    deadline = time.monotonic() + TIMEOUT_S
    for r, (p, _) in enumerate(procs, 1):
        try:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
        except subprocess.TimeoutExpired:
            raise RuntimeError(f"rank {r} outlasted {TIMEOUT_S} s")
        if p.returncode != 0:
            with open(os.path.join(folder, f"rank{r}.log")) as f:
                raise RuntimeError(f"rank {r} failed:\n{f.read()[-4000:]}")


def _share(exp, rank):
    """share(flag) of loop.drive: rank 0's flag on every rank, over the
    host group."""
    import torch
    import torch.distributed as dist

    def share(flag):
        t = torch.tensor([int(flag) if rank == 0 else 0])
        dist.broadcast(t, group=exp.mesh.cpu_group, group_src=0)
        return bool(t.item())
    return share


def rank_loop(ctx, rank, spec):
    """One rank's run on ctx.device, every rank in step (drivers/loop.py).
    Rank 0 fills ctx.record, ctx.work and ctx.trace_data, and returns the
    arguments of train.check after the window; the others return None."""
    import torch
    import torch.distributed as dist
    nccl = spec["backend"] == "nccl"
    if ctx.device.type == "cuda":
        torch.cuda.set_device(ctx.device)
    dist.init_process_group(
        spec["backend"], init_method=spec["init"], rank=rank,
        world_size=spec["world"],
        timeout=datetime.timedelta(seconds=TIMEOUT_S),
        device_id=ctx.device if nccl else None)
    try:
        return _train(ctx, rank)
    finally:
        dist.destroy_process_group()


def _train(ctx, rank):
    import torch
    from nvsr_tpu_torch import experiment
    from nvsr_tpu_torch.utils.config import CfgNode
    dev, main = ctx.device, rank == 0
    ctx.note("imports")
    with tempfile.TemporaryDirectory() as root:
        scenes = train._scenes(ctx, root)
        ctx.note("scenes written")
        raw = train.experiment_config(ctx.config)
        raw["dataset"]["synt"]["root"] = "synt"
        raw["experiment"]["logdir"] = "logs"
        raw["experiment"]["randomseed"] = ctx.seed
        loop.edited(raw, ctx.traffic.get("config", {}),
                    ctx.overrides.get("config", {}))
        exp = experiment.Experiment(CfgNode(raw), root_path=root,
                                    device=dev)
        exp.planes_buffer.draw_scenes()
        exp._update_active_scenes()
        init = train._weights(ctx, exp)
        train._hand_over(exp, init)
        draws = train.Draws(ctx, exp, experiment, scenes)
        ctx.note("Experiment built")
        program = loop.drive(ctx, exp, draws, raw, dev, main=main,
                             share=_share(exp, rank))
        out = None
        if main:
            ctx.record["world"] = exp.mesh.world if exp.mesh else 1
            kinds = {draws.kind(sc) for sc in draws.mix}
            out = (raw, scenes, draws.steps, init, program, draws.fits,
                   kinds)
        draws.close()
        del exp, draws
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def _main(argv):
    import torch
    path, rank = argv[0], int(argv[1])
    with open(path) as f:
        spec = json.load(f)
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with cell_faults.planted(spec["overrides"].get("fault")):
        rank_loop(_RankContext(spec, rank), rank, spec)
    return 0


if __name__ == "__main__":
    sys.exit(_main(sys.argv[1:]))
