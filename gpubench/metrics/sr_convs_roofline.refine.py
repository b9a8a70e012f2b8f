"""sr_convs_roofline.refine: sr_convs_roofline (metrics/sr_convs_roofline.py) in the stage-3 refine cell, where it moves
train_iter_ms (a consistency iteration counts as an HR one)."""

from gpubench.harness import load_metric

read = load_metric("sr_convs_roofline").read
