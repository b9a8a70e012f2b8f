"""device_idle.refine: device_idle.train (metrics/device_idle.train.py) in the stage-3 refine cell, where it moves
train_iter_ms (a consistency iteration counts as an HR one)."""

from gpubench.harness import load_metric

read = load_metric("device_idle.train").read
