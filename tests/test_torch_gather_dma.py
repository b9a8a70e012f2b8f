"""The row gather (ops/gather_dma.py, the plain version of
csrc/gather_rows.cu) against JAX's gather_rows_dma (Pallas in interpret
mode): bit-equal, as both copy rows (JAX's one-hot select adds exact
zeros). Fixture: tests/test_pallas_gather.py (a [512, 256] f32 table and
1024 indices), and the narrow row widths the kernel copies by scalars.
The preconditions are JAX's, as ValueErrors, plus the indices' range.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvsr_tpu.ops.pallas import gather_dma as jgd
from nvsr_tpu_torch.ops import gather_dma as tgd


@pytest.mark.parametrize("hw,c", [(512, 256), (256, 4), (2048, 2)])
def test_gather_rows_dma_matches_jax(rng, hw, c):
    table = rng.standard_normal((hw, c)).astype(np.float32)
    idx = rng.integers(0, hw, size=(jgd.BLOCK,)).astype(np.int32)
    ref = np.asarray(jgd.gather_rows_dma(jnp.asarray(table),
                                         jnp.asarray(idx), interpret=True))
    out = tgd.gather_rows_dma(torch.as_tensor(table), torch.as_tensor(idx))
    assert out.shape == (jgd.BLOCK, c) and out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(out.numpy(), table[idx])


@pytest.mark.parametrize("hw,c,n,bad,match", [
    (512, 3, 1024, 0, "divide"),           # 1024 % C
    (510, 256, 1024, 0, "multiple of 4"),  # HW % (1024 / C)
    (512, 256, 1000, 0, "multiple of 1024"),
    (512, 256, 1024, 512, "lie in"),       # an index past the table
    (512, 256, 1024, -1, "lie in"),
])
def test_gather_rows_dma_preconditions(hw, c, n, bad, match):
    """JAX's three asserts, and the indices' range (JAX's DMA reads what
    they name; on a CUDA table the port's kernel asserts on the device)."""
    table = torch.zeros((hw, c))
    idx = torch.zeros((n,), dtype=torch.int32)
    idx[-1] = bad
    with pytest.raises(ValueError, match=match):
        tgd.gather_rows_dma(table, idx)
