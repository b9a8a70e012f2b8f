"""forward_ms.stage1: forward_ms.train (metrics/forward_ms.train.py) in the
stage-1 training cell, where it moves train_iter_ms.stage1."""

from gpubench.harness import load_metric

read = load_metric("forward_ms.train").read
