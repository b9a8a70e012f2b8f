"""Random draws of a ray batch that come out the same on every rank.

JAX replicates one key over the mesh: a sharded batch draws the numbers
of the whole batch, and each device keeps its rows. `RowShard` does that
for a torch.Generator. A draw whose leading axis is a shard's rows (or a
whole multiple of them, as [rays * samples, 3] points) draws the global
batch's shape and keeps the shard's rows. So W ranks that hold one
seed draw together exactly the numbers that one rank draws for the
whole batch, in the same order. A plain generator (or None) draws the
shape it is given, as torch does.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class RowShard:
    """`generator` drawing for a batch of n rows of which this rank holds
    [lo, hi)."""
    generator: torch.Generator
    lo: int
    hi: int
    n: int

    @property
    def device(self):
        return self.generator.device


def base(generator):
    """The torch.Generator behind a RowShard (or the generator itself):
    for draws that are not of the batch's rows, as the SR net's noise."""
    return generator.generator if isinstance(generator, RowShard) \
        else generator


def _draw(draw, shape, generator):
    shape = tuple(shape)
    if not isinstance(generator, RowShard):
        return draw(shape, generator)
    g = generator
    per, rest = divmod(shape[0], g.hi - g.lo)
    assert rest == 0, (shape, g)
    return draw((g.n * per,) + shape[1:], g.generator)[g.lo * per:
                                                       g.hi * per]


def rand(shape, generator, *, dtype=torch.float32, device=None):
    """Uniforms in [0, 1), as torch.rand."""
    return _draw(lambda s, g: torch.rand(s, generator=g, dtype=dtype,
                                         device=device), shape, generator)


def randn(shape, generator, *, dtype=torch.float32, device=None):
    """Standard normals, as torch.randn."""
    return _draw(lambda s, g: torch.randn(s, generator=g, dtype=dtype,
                                          device=device), shape, generator)


def exponential(shape, generator, *, dtype=torch.float32, device=None):
    """Standard exponentials, as Tensor.exponential_."""
    return _draw(lambda s, g: torch.empty(s, dtype=dtype, device=device)
                 .exponential_(generator=g), shape, generator)
