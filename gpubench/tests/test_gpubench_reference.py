"""The plain reference (gpubench/reference/) against the port's own f32
path on the CPU, at tiny sizes: the reference is shown right before it
judges anything on the card. Run: python -m pytest gpubench/tests."""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from gpubench import inputs  # noqa: E402
from gpubench.reference import nerf  # noqa: E402
from gpubench.reference import render as rref  # noqa: E402
from gpubench.reference import triplane as tref  # noqa: E402

DEV = torch.device("cpu")


@pytest.mark.parametrize("blocks,scale", [(1, 2), (2, 4)])
def test_plane_sr_matches_the_port_in_f32(blocks, scale):
    from nvsr_tpu_torch.models.plane_sr import PlaneSRConfig, apply_plane_sr
    gen = torch.Generator().manual_seed(blocks)
    planes = 0.03 * torch.randn(3, 8, 10, 10, generator=gen)
    w = inputs.edsr_weights(gen, 8, 16, blocks, scale, DEV)
    cfg = PlaneSRConfig(in_channels=8, out_channels=8, hidden_size=16,
                        n_blocks=blocks, scale_factor=scale)
    mine = apply_plane_sr({"inner": w}, cfg, planes)
    ref = tref.plane_sr(w, planes, scale)
    assert mine.shape == ref.shape == (3, 8, 10 * scale, 10 * scale)
    assert (mine - ref).abs().max() < 1e-7
    # the backward too, with the blocks recomputed
    g = torch.randn(ref.shape, generator=gen)
    leaves = [x for _, x in nerf.leaves(w)]
    for x in leaves:
        x.requires_grad_(True)
    mine_g = torch.autograd.grad((apply_plane_sr({"inner": w}, cfg, planes)
                                  * g).sum(), leaves)
    ref_g = torch.autograd.grad((tref.plane_sr(w, planes, scale) * g).sum(),
                                leaves)
    for a, b in zip(mine_g, ref_g):
        assert torch.allclose(a, b, rtol=1e-4, atol=1e-10)


def test_scene_box_matches_the_port():
    from nvsr_tpu_torch.ops.geometry import calc_scene_box
    poses = np.stack([inputs.look_at(4.0 * np.array([np.cos(a), np.sin(a),
                                                     0.45]))
                      for a in (0.0, 1.7, 4.0)])
    h, focal = 100, 0.5 * 100 / np.tan(0.35)
    mine = calc_scene_box({"camera_poses": poses[:, :3, :4], "near": 2.0,
                           "far": 6.0, "H": [h] * 3, "W": [h] * 3,
                           "f": [focal] * 3}, including_dirs=True,
                          no_ndc=True)
    ref = tref.scene_box(poses, h, h, focal, 2.0, 6.0)
    assert np.allclose(mine, ref, rtol=1e-6, atol=1e-6)


def test_inverse_cdf_and_composite_match_the_port():
    from nvsr_tpu_torch.ops.rendering import volume_render
    from nvsr_tpu_torch.ops.sampling import hierarchical_z_vals
    gen = torch.Generator().manual_seed(3)
    z = torch.sort(2 + 4 * torch.rand(5, 9, generator=gen), -1).values
    raw = torch.randn(5, 9, 4, generator=gen)
    d = torch.randn(5, 3, generator=gen)
    out = volume_render(raw, z, d)
    rgb, w = rref.composite(raw, z, d)
    assert torch.allclose(out.rgb, rgb, atol=1e-6)
    assert torch.allclose(out.weights, w, atol=1e-6)
    assert torch.allclose(hierarchical_z_vals(z, w, 6, det=True),
                          rref.fine_depths(z, w, 6, det=True), atol=1e-6)
