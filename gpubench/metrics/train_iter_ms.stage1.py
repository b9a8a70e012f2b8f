"""train_iter_ms.stage1: train_iter_ms (metrics/train_iter_ms.py) in the stage-1 training cell, where it
moves train_iter_ms.stage1."""

from gpubench.harness import load_metric

read = load_metric("train_iter_ms").read
