"""backward_ms.refine: backward_ms.train (metrics/backward_ms.train.py) in the stage-3 refine cell, where it moves
train_iter_ms (a consistency iteration counts as an HR one)."""

from gpubench.harness import load_metric

read = load_metric("backward_ms.train").read
