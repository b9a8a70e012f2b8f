"""stage1.host_waits_per_iter: train.host_waits_per_iter (metrics/train.host_waits_per_iter.py) in the stage-1 training cell, where it
moves train_iter_ms.stage1."""

from gpubench.harness import load_metric

read = load_metric("train.host_waits_per_iter").read
