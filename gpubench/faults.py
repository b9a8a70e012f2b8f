"""Faults planted under a cell's timed path, to show that its check
catches them (tests/test_gpubench_faults.py on the CPU; readings.py
--fault on the card for the limits' upper readings)."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(obj, name, make):
    real = getattr(obj, name)
    setattr(obj, name, make(real))
    try:
        yield
    finally:
        setattr(obj, name, real)


def unchanged():
    """Every optimizer step returns the state unchanged: the decoders'
    and the SR net's (ModuleOptimizer) and the planes' (PlanesOptimizer)."""
    from nvsr_tpu_torch import planes_store, train

    stack = contextlib.ExitStack()
    stack.enter_context(_patched(train.ModuleOptimizer, "step",
                                 lambda real: lambda self: self.zero()))
    stack.enter_context(_patched(planes_store.PlanesOptimizer, "apply_grads",
                                 lambda real: lambda self, *a, **kw: None))
    return stack


def half_batch():
    """The training step sees the first half of its rays and targets:
    the mean is taken over the rest."""
    from nvsr_tpu_torch import experiment

    def make(real):
        def step(dc, df, *a, **kw):
            a = list(a)
            i = next(k for k, x in enumerate(a) if hasattr(x, "origins"))
            rays, target = a[i], a[i + 1]
            n, t = rays.origins.shape[0] // 2, target.shape[0] // 2
            a[i] = type(rays)(*[None if f is None else f[:n] for f in rays])
            a[i + 1] = target[:t]
            return real(dc, df, *a, **kw)
        return step

    stack = contextlib.ExitStack()
    for name in ("train_step", "train_step_baseline"):
        stack.enter_context(_patched(experiment, name, make))
    return stack


FAULTS = {"unchanged": unchanged, "half_batch": half_batch}
