"""input_ms.stage1: input_ms.train (metrics/input_ms.train.py) in the
stage-1 training cell, where it moves train_iter_ms.stage1."""

from gpubench.harness import load_metric

read = load_metric("input_ms.train").read
