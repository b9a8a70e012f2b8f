"""backward_ms.stage1: backward_ms.train (metrics/backward_ms.train.py) in the
stage-1 training cell, where it moves train_iter_ms.stage1."""

from gpubench.harness import load_metric

read = load_metric("backward_ms.train").read
