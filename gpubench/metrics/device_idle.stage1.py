"""device_idle.stage1: device_idle.train (metrics/device_idle.train.py) in the stage-1 training cell, where it
moves train_iter_ms.stage1."""

from gpubench.harness import load_metric

read = load_metric("device_idle.train").read
