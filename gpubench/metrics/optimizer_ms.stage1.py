"""optimizer_ms.stage1: optimizer_ms.train (metrics/optimizer_ms.train.py) in the
stage-1 training cell, where it moves train_iter_ms.stage1."""

from gpubench.harness import load_metric

read = load_metric("optimizer_ms.train").read
