"""Faults planted under the timed path of the cells that faults.py does
not reach, to show that their checks catch them: the data-parallel
step's gradient average (planted in every rank's process by
drivers/train_dp.py) and the consistency iteration of stage 3. Named by
`cell_readings.py --fault` on the card and by the CPU tests."""

from __future__ import annotations

import contextlib

from gpubench import faults
from gpubench.faults import _patched


def _reduce_fault(edit):
    """experiment.reduce_step with `edit(mesh, grads) -> grads` applied
    to this rank's gradients before the all_reduce and its mean."""
    from nvsr_tpu_torch import experiment

    def make(real):
        def reduce(mesh, metrics, grads):
            if mesh is not None:
                grads = edit(mesh, grads)
            return real(mesh, metrics, grads)
        return reduce

    return _patched(experiment, "reduce_step", make)


def _scaled(tree, factor):
    if isinstance(tree, dict):
        return {k: _scaled(v, factor) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_scaled(v, factor) for v in tree]
    return tree * factor


def dp_rank_left_out():
    """The last rank's gradients are left out of the average: it adds
    zeros to the sum, which is still divided by the world."""
    return _reduce_fault(lambda mesh, g: _scaled(g, 0.0)
                         if mesh.rank == mesh.world - 1 else g)


def dp_sum():
    """The ranks' gradients are summed, not averaged."""
    return _reduce_fault(lambda mesh, g: _scaled(g, float(mesh.data_size)))


def consistency_first_ray():
    """A consistency iteration's loss takes each patch's first ray in
    place of the patch's mean colour."""
    from nvsr_tpu_torch import train

    def make(real):
        def first(rgb, ds):
            return rgb.reshape(-1, ds * ds, rgb.shape[-1])[:, 0]
        return first

    return _patched(train, "avg_downsample_pixels", make)


def sr_step_skipped():
    """The SR net's Adam does not step on the consistency iterations (its
    only steps in stage 3)."""
    from nvsr_tpu_torch import experiment

    stack = contextlib.ExitStack()

    def make(real):
        def init(self, *a, **kw):
            real(self, *a, **kw)
            if self.sr_opt is not None:
                self.sr_opt.step = self.sr_opt.zero
        return init

    stack.enter_context(_patched(experiment.Experiment, "__init__", make))
    return stack


# every fault a driver of these cells plants by name: faults.py's too
FAULTS = {**faults.FAULTS,
          "dp_rank_left_out": dp_rank_left_out, "dp_sum": dp_sum,
          "consistency_first_ray": consistency_first_ray,
          "sr_step_skipped": sr_step_skipped}


def planted(name):
    """The fault `name` (a run's overrides["fault"]) planted for a `with`,
    or nothing when it is None."""
    return FAULTS[name]() if name else contextlib.nullcontext()
