"""The fused kernel's shared-memory layout, on the CPU: the mirror
kernels.triplane_layout_bytes of csrc/decoder.cuh's make_layout fits the
232,448 bytes a block may use for every config that fused_render.supports
sends to the kernel, grows with the feature width, and reads the same
constants as the CUDA source. On the card chip_smoke.py holds the mirror
equal to the library's own figure (triplane_layout_bytes)."""

import dataclasses
import re
from pathlib import Path

import pytest

from nvsr_tpu_torch import kernels
from nvsr_tpu_torch.models.triplane import TriplaneConfig
from nvsr_tpu_torch.ops import fused_render

CSRC = Path(kernels.__file__).resolve().parent / "csrc"
WIDTHS = range(1, 81)


def _admitted(cubic):
    """Every (C, Cv) in 1..80 that fused_render.supports admits."""
    base = TriplaneConfig(proj_combination="avg",
                          viewdir_proj_combination="concat_pos",
                          compute_dtype="bfloat16",
                          plane_interp="bicubic" if cubic else "bilinear")
    return [(c, cv) for c in WIDTHS for cv in WIDTHS
            if fused_render.supports(dataclasses.replace(
                base, num_plane_channels=c, num_viewdir_plane_channels=cv))]


@pytest.mark.parametrize("sigma_only", [False, True],
                         ids=["full", "sigma_only"])
@pytest.mark.parametrize("cubic", [False, True], ids=["bilinear", "bicubic"])
def test_layout_fits_every_admitted_config(cubic, sigma_only):
    admitted = _admitted(cubic)
    # supports admits up to 64 channels of each kind, and only those
    assert max(c for c, _ in admitted) == 64
    assert max(cv for _, cv in admitted) == 64
    assert len(admitted) == 64 * 64
    worst = 0
    for c, cv in admitted:
        cp = fused_render._round_up(c, fused_render.CH_ALIGN)
        cvp = 0 if sigma_only else fused_render._round_up(
            cv, fused_render.CH_ALIGN)
        total = kernels.triplane_layout_bytes(cp, cvp, cubic)
        assert total <= kernels.SMEM_BLOCK_LIMIT, (c, cv, total)
        worst = max(worst, total)
    # the widest config: 215,168 bytes in bicubic with view rows
    assert worst == kernels.triplane_layout_bytes(
        64, 0 if sigma_only else 64, cubic)


@pytest.mark.parametrize("cvp", [0, 16, 48, 64])
@pytest.mark.parametrize("cubic", [False, True], ids=["bilinear", "bicubic"])
def test_layout_grows_with_the_feature_width(cubic, cvp):
    totals = [kernels.triplane_layout_bytes(cp, cvp, cubic)
              for cp in (16, 32, 48, 64)]
    assert totals == sorted(set(totals))
    assert kernels.triplane_layout_bytes(48, cvp, True) > \
        kernels.triplane_layout_bytes(48, cvp, False)


def test_layout_at_the_flagship_and_the_limits():
    # ring 65,536 + heads 8,192 + barriers 128 + 3 stages + one scratch
    assert kernels.triplane_layout_bytes(48, 48, True) == 184448
    assert kernels.triplane_layout_bytes(64, 64, True) == 215168
    assert kernels.triplane_layout_bytes(48, 0, False) == 73856 + \
        3 * 64 * 4 * 48 * 2 + 64 * 3 * 7 * 4


def _constant(text, name):
    m = re.search(rf"constexpr int {name} = (\d+);", text)
    assert m, name
    return int(m.group(1))


def test_mirror_reads_the_cuda_constants():
    dec = (CSRC / "decoder.cuh").read_text()
    assert _constant(dec, "kRing") == kernels._RING_SLICES
    assert _constant(dec, "kStages") == kernels._STAGES
    assert _constant(dec, "kWgPoints") == 64
    assert _constant(dec, "kRing") * 4 * 16 * 128 * 2 == kernels._RING_BYTES
    # the barriers: the weight ring's and the stages' full and empty
    assert "align128(off + 2 * (kRing + kStages) * 8)" in dec
    assert "L.feat = off;    off += kStages * L.feat_bytes;" in dec
    assert "L.scratch = off; off += L.scratch_bytes;" in dec
    render = (CSRC / "triplane_render.cu").read_text()
    assert "kInts = kCubic ? 8 : 4;" in render
    assert "kFloats = kCubic ? 16 : 3;" in render
