"""Host side of the row-gather kernel, and its plain version.

Counterpart of nvsr_tpu/ops/pallas/gather_dma.py::gather_rows_dma (:56,
the TPU kernel `_kernel` :29). The CUDA kernel is csrc/gather_rows.cu;
`gather_rows_reference` (table[idx]) is its plain PyTorch version, used
on the CPU and as the kernel's oracle. The TPU kernel's 1024-float group
DMAs and one-hot select are a Mosaic workaround with no counterpart: the
kernel copies each row with 16-byte loads and stores. Its preconditions
are kept, with the same conditions.
"""

from __future__ import annotations

import torch

GROUP_ELEMS = 1024          # the TPU kernel's 1-D f32 tile
BLOCK = 1024                # its points per grid step


def gather_rows_reference(table, idx) -> torch.Tensor:
    """Plain PyTorch version of the kernel -> [N, C]."""
    return table[idx.long()]


def gather_rows_dma(table, idx) -> torch.Tensor:
    """Rows table[idx]: table [HW, C] f32 with C dividing 1024 and HW a
    multiple of 1024 / C; idx [N] int32 in [0, HW), N a multiple of 1024
    -> [N, C] f32. Each condition is checked (ValueError); the indices'
    range is checked here on the CPU, and on a CUDA table by a device-side
    assert in the kernel, as torch.index_select does (no host sync).

    A CPU table runs the plain version, a CUDA table the kernel
    (kernels.gather_rows_forward), which raises on any failure; any other
    device raises."""
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gather_rows_dma needs CPU or CUDA tensors, got "
                         f"{table.device}")
    hw, c = table.shape
    if GROUP_ELEMS % c:
        raise ValueError("row width must divide the 1024-f32 tile")
    if hw % (GROUP_ELEMS // c):
        raise ValueError(f"table rows {hw} must be a multiple of "
                         f"{GROUP_ELEMS // c}")
    if idx.shape[0] % BLOCK:
        raise ValueError(f"N must be a multiple of {BLOCK}")
    if table.device.type == "cpu":
        lo, hi = torch.aminmax(idx)
        if lo < 0 or hi >= hw:
            raise ValueError(f"indices must lie in [0, {hw}), got "
                             f"[{int(lo)}, {int(hi)}]")
        return gather_rows_reference(table, idx)
    from nvsr_tpu_torch import kernels
    return kernels.gather_rows_forward(table.contiguous(), idx.contiguous())
