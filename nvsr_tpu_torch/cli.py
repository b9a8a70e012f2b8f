"""Command line entry point of the port (counterpart of nvsr_tpu/cli.py),
its eval modes:

    python -m nvsr_tpu_torch.cli --config <yml> --eval images|video
                                 [--results_path DIR] [--device cuda|cpu]

with the machine-local `config/local_config.yml` root-path indirection
and the eval-mode override from the trained experiment's dumped config
(the eval config's dataset section is kept). The device is the card
unless `--device` names another. Training is not ported yet (ROADMAP
Queue 1 #3).
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
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the models and renders "
                             "(default: the card).")
    return parser


def main(argv=None):
    args = build_argparser().parse_args(argv)
    eval_mode = args.eval
    assert args.config or args.load_checkpoint, (
        "Specify a configuration file and/or a checkpoint to resume.")
    if not eval_mode:
        raise NotImplementedError("training from the command line is not "
                                  "ported yet: ROADMAP Queue 1 #3")

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

    if planes_model and args.config is not None:
        # the training-time config, keeping the eval dataset section
        dataset_cfg = cfg.dataset
        trained_cfg_file = os.path.join(root_path, cfg.experiment["logdir"],
                                        experiment_id, "config.yml")
        if os.path.isfile(trained_cfg_file):
            cfg = get_config(trained_cfg_file)
            cfg["dataset"] = dataset_cfg

    print(f"Using configuration file {config_file}")
    print(f"Evaluating experiment {experiment_id} on {args.device}")
    Experiment(cfg, load_checkpoint=args.load_checkpoint,
               eval_mode=eval_mode, results_path=args.results_path,
               root_path=root_path, device=args.device).run()


if __name__ == "__main__":
    main()
