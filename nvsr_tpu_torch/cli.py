"""Command line entry point of the port (counterpart of nvsr_tpu/cli.py):

    python -m nvsr_tpu_torch.cli --config <yml> [--load-checkpoint DIR|resume]
                                 [--max-iters N] [--profile-dir DIR]
                                 [--eval images|video --results_path DIR]
                                 [--device cuda|cpu]

trains (or, with --eval, evaluates) as `python -m nvsr_tpu.cli` does,
with the machine-local `config/local_config.yml` root-path indirection
and the eval-mode override from the trained experiment's dumped config
(the eval config's dataset section is kept). The logdir it writes is the
JAX package's layout, so either package resumes or evaluates what the
other wrote. The device is the card unless `--device` names another.
`--profile-dir` traces the run with torch.profiler into that directory
(a Chrome trace), in place of the JAX package's jax.profiler trace.
"""

from __future__ import annotations

import argparse
import os

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
                             "(default: the card).")
    return parser


def main(argv=None):
    args = build_argparser().parse_args(argv)
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
          + f" experiment {experiment_id} on {args.device}")
    exp = Experiment(cfg, load_checkpoint=args.load_checkpoint,
                     eval_mode=eval_mode, results_path=args.results_path,
                     root_path=root_path, device=args.device)
    if args.profile_dir:
        import torch
        from torch.profiler import (ProfilerActivity, profile,
                                    tensorboard_trace_handler)
        activities = [ProfilerActivity.CPU]
        if exp.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities,
                     on_trace_ready=tensorboard_trace_handler(
                         args.profile_dir)):
            exp.run(max_iters=args.max_iters)
            if exp.device.type == "cuda":
                torch.cuda.synchronize(exp.device)
    else:
        exp.run(max_iters=args.max_iters)


if __name__ == "__main__":
    main()
