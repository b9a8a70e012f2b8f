"""sr_recomputed_blocks.refine: sr_recomputed_blocks (metrics/sr_recomputed_blocks.py) in the stage-3 refine cell, over its
consistency iterations' `plane_sr` spans, where it moves train_iter_ms."""

from gpubench.harness import load_metric

read = load_metric("sr_recomputed_blocks").read
