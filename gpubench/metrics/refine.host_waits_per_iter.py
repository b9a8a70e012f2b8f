"""refine.host_waits_per_iter: train.host_waits_per_iter (metrics/train.host_waits_per_iter.py) in the stage-3 refine cell, where it moves
train_iter_ms (a consistency iteration counts as an HR one)."""

from gpubench.harness import load_metric

read = load_metric("train.host_waits_per_iter").read
