"""device_idle.stage1_dp4: device_idle.train (metrics/device_idle.train.py)
on rank 0's card in the data-parallel stage-1 cell, where it moves
train_iter_ms."""

from gpubench.harness import load_metric

read = load_metric("device_idle.train").read
