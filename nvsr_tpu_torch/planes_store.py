"""Per-scene feature planes: low-rank materialization and the planes'
Adam (counterpart of part of nvsr_tpu/planes_store.py).

Ported so far: `materialize_pos_planes` and the optimizer half of the
JAX `PlanesBuffer` (its per-scene optax Adam, `apply_grads`, `set_lr`).
The scene buffer, the disk store and the prefetch wait for the
Experiment slice. optax.adam(lr, eps=1e-8) and torch.optim.Adam(lr,
eps=1e-8) take the same step.
"""

from __future__ import annotations

from typing import Optional

import torch


def materialize_pos_planes(planes_pos, rank: Optional[int]):
    """Expand low-rank factors [P, C, R, 2k] to full planes [P, C, R, R];
    identity when rank is None."""
    if rank is None:
        return planes_pos
    a = planes_pos[..., :rank]
    b = planes_pos[..., rank:]
    return torch.einsum("pcrk,pcsk->pcrs", a, b)


class PlanesOptimizer:
    """One Adam per trained scene over its plane dict {"pos", "view"?}.

    `planes` maps scene -> plane dict of leaf tensors, which are updated
    in place; frozen scenes (or optimize=False) never step."""

    def __init__(self, planes: dict, lr: float, *, optimize: bool = True,
                 frozen_scenes=()):
        self.planes = planes
        self.lr = float(lr)
        self.optimize = optimize
        self.frozen_scenes = set(frozen_scenes)
        self.opts: dict = {}

    def _opt(self, scene: str) -> torch.optim.Adam:
        if scene not in self.opts:
            self.opts[scene] = torch.optim.Adam(
                list(self.planes[scene].values()), lr=self.lr, eps=1e-8)
        return self.opts[scene]

    @torch.no_grad()
    def apply_grads(self, scene: str, grads: dict):
        """One Adam step on this scene's planes with `grads` (the same
        keys as its plane dict); a no-op for a frozen scene."""
        if not self.optimize or scene in self.frozen_scenes:
            return
        opt = self._opt(scene)
        for g in opt.param_groups:
            g["lr"] = self.lr
        for k, p in self.planes[scene].items():
            p.grad = grads[k]
        opt.step()
        for p in self.planes[scene].values():
            p.grad = None

    def set_lr(self, lr: float):
        """Adjust the planes learning rate (plateau scheduler hook); it
        takes effect at the next step."""
        self.lr = float(lr)
