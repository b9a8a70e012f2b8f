"""Command line entry point of the port (counterpart of nvsr_tpu/cli.py):

    python -m nvsr_tpu_torch.cli --config <yml> [--load-checkpoint DIR|resume]
                                 [--max-iters N] [--profile-dir DIR]
                                 [--eval images|video --results_path DIR]
                                 [--device cuda|cuda:N|cpu]
                                 [--dist-backend nccl|gloo]

trains (or, with --eval, evaluates) as `python -m nvsr_tpu.cli` does,
with the machine-local `config/local_config.yml` root-path indirection
and the eval-mode override from the trained experiment's dumped config
(the eval config's dataset section is kept). The logdir it writes is the
JAX package's layout, so either package resumes or evaluates what the
other wrote. The device is the card unless `--device` names another.
`--profile-dir` traces the set-up and the run with torch.profiler into
that directory (a Chrome trace), in place of the JAX package's
jax.profiler trace. The trace carries the program's spans
(`utils/tracing.py`) as `nvsr.*` annotations beside the operators and
kernels: `nvsr.load_pretrained` over the set-up's loads (the pretrained
or resumed checkpoints, then the first planes draw), `nvsr.train_iteration`
over each training iteration, with its phases `nvsr.input` (the draw,
the rays and the target to the device, the planes lent and the rays
tightened), `nvsr.occupancy` (the occupancy update), `nvsr.forward`
(with `nvsr.plane_sr`, `nvsr.render.coarse` / `nvsr.render.fine` and,
on a consistency iteration, `nvsr.consistency_loss` inside),
`nvsr.backward` (the gradients), `nvsr.reduce` (the data group's
all_reduce, under a mesh) and `nvsr.optimizer` (the planes' Adam,
the gated module steps); around them `nvsr.flush_metrics` (the queued
metrics' one device-to-host copy), `nvsr.evaluate` and `nvsr.save` (the
planes and the checkpoints written).

Under torchrun (RANK, WORLD_SIZE and LOCAL_RANK set) each process is one
rank of a process group, for a config with `experiment.data_parallel`
(and, from the same YAML, `experiment.model_parallel` and
`nerf.train.store_planes.device_pool`):

    torchrun --standalone --nproc_per_node=N -m nvsr_tpu_torch.cli \
        --config <yml> [--device cpu] [--dist-backend gloo]

The backend is NCCL on cards and gloo on the CPU; a rank's device is
cuda:LOCAL_RANK, unless --device names a card (e.g. `--device cuda:0
--dist-backend gloo`: every rank on one card, which NCCL refuses). The
process group is destroyed at exit. Without those variables nothing of
this happens.
"""

from __future__ import annotations

import argparse
import contextlib
import os

import torch

from nvsr_tpu_torch.experiment import Experiment
from nvsr_tpu_torch.utils.config import get_config


def build_argparser():
    parser = argparse.ArgumentParser(prog="nvsr_tpu_torch")
    parser.add_argument("--config", type=str,
                        help="Path to (.yml) config file.")
    parser.add_argument("--load-checkpoint", type=str, default="",
                        help="Path to load saved checkpoint from "
                             "(or 'resume').")
    parser.add_argument("--eval", type=str, choices=["images", "video"],
                        default=None,
                        help="Run in evaluation mode and render "
                             "images/video.")
    parser.add_argument("--results_path", type=str,
                        help="Path to save evaluation results.")
    parser.add_argument("--local-config", type=str,
                        default=os.path.join("config", "local_config.yml"),
                        help="Machine-local config with the dataset/logs "
                             "root path.")
    parser.add_argument("--max-iters", type=int, default=None,
                        help="Override experiment.train_iters (for smoke "
                             "runs).")
    parser.add_argument("--profile-dir", type=str, default=None,
                        help="Capture a torch.profiler trace of the run "
                             "into this directory.")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the models and renders "
                             "(default: the card; under torchrun, the "
                             "rank's card cuda:LOCAL_RANK unless an index "
                             "is given).")
    parser.add_argument("--dist-backend", type=str, default=None,
                        choices=["nccl", "gloo"],
                        help="torch.distributed backend under torchrun "
                             "(default: nccl on cards, gloo on the CPU).")
    return parser


def init_distributed(device: str, backend=None):
    """Under torchrun: this rank's device, with the process group
    initialized from the launcher's environment (env://); else None.
    No silent fallback: NCCL with two ranks on one card fails as NCCL
    does."""
    if not {"RANK", "WORLD_SIZE", "LOCAL_RANK"} <= set(os.environ):
        return None
    import torch.distributed as dist
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend,
                            device_id=dev if backend == "nccl" else None)
    return dev


def main(argv=None):
    args = build_argparser().parse_args(argv)
    device = init_distributed(args.device, args.dist_backend)
    try:
        run(args, device or torch.device(args.device))
    finally:
        if device is not None:
            import torch.distributed as dist
            dist.destroy_process_group()


def run(args, device):
    eval_mode = args.eval
    assert args.config or args.load_checkpoint, (
        "Specify a configuration file and/or a checkpoint to resume.")
    root_path = ""
    if os.path.isfile(args.local_config):
        root_path = get_config(args.local_config).get("root", "")

    config_file = (os.path.join(args.load_checkpoint, "config.yml")
                   if args.config is None else args.config)
    cfg = get_config(config_file)
    experiment_id = cfg.experiment.get(
        "id", cfg.experiment["logdir"].split("/")[-1])
    planes_model = ("coarse" not in cfg.get("models", {})
                    or cfg.models.coarse.get("type") == "TwoDimPlanesModel")

    if eval_mode and planes_model and args.config is not None:
        # the training-time config, keeping the eval dataset section
        dataset_cfg = cfg.dataset
        trained_cfg_file = os.path.join(root_path, cfg.experiment["logdir"],
                                        experiment_id, "config.yml")
        if os.path.isfile(trained_cfg_file):
            cfg = get_config(trained_cfg_file)
            cfg["dataset"] = dataset_cfg

    print(f"Using configuration file {config_file}")
    print(("Evaluating" if eval_mode else "Running")
          + f" experiment {experiment_id} on {device}")
    profiler = contextlib.nullcontext()
    if args.profile_dir:
        # the set-up's loads (`load_pretrained`) and the run
        from torch.profiler import (ProfilerActivity, profile,
                                    tensorboard_trace_handler)
        activities = [ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        profiler = profile(activities=activities,
                           on_trace_ready=tensorboard_trace_handler(
                               args.profile_dir))
    with profiler:
        exp = Experiment(cfg, load_checkpoint=args.load_checkpoint,
                         eval_mode=eval_mode,
                         results_path=args.results_path,
                         root_path=root_path, device=device)
        exp.run(max_iters=args.max_iters)
        if args.profile_dir and exp.device.type == "cuda":
            torch.cuda.synchronize(exp.device)


if __name__ == "__main__":
    main()
