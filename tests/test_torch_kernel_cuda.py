"""The CUDA triplane kernel against its plain version, on the card.

Marked `cuda`: each test skips unless torch sees a CUDA device (decided in
the fixture, not at import). The file needs neither JAX nor the reference
package, so it also runs on a GPU machine without them:
    python -m pytest --noconftest -m cuda tests/test_torch_kernel_cuda.py
The kernel and the plain version share every rounding up to the decoder;
the tensor cores sum the decoder's bf16 products in another order, which
can flip a bf16 activation by one ULP: atol 2e-2, mean 1e-3.
"""

import math

import numpy as np
import pytest
import torch

from nvsr_tpu_torch import kernels
from nvsr_tpu_torch.models.triplane import TriplaneConfig, make_rot_mats
from nvsr_tpu_torch.ops import fused_render

pytestmark = pytest.mark.cuda

BOX = np.stack([[-2, -2, -2, -np.pi, -np.pi / 2],
                [2, 2, 2, np.pi, np.pi / 2]]).astype(np.float32)


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _decoder(gen, cfg, device):
    def lin(i, o):
        bound = 1.0 / math.sqrt(i)
        return {"w": ((torch.rand((i, o), generator=gen) * 2 - 1) * bound
                      ).to(device),
                "b": ((torch.rand((o,), generator=gen) * 2 - 1) * bound
                      ).to(device)}

    def branch(in_ch, n):
        return [lin(in_ch, 128)] + [
            lin(128 + (in_ch if cfg.is_skip_layer(ln) else 0), 128)
            for ln in range(n - 1)]

    return {"members": [{
        "density": branch(cfg.density_in_channels, cfg.dec_density_layers),
        "fc_alpha": lin(128, 1),
        "rgb": branch(cfg.rgb_in_channels, cfg.dec_rgb_layers),
        "fc_rgb": lin(128, 3)}]}


def _inputs(device, layers=4, chans=48, R=300, S=24, res=96, seed=0):
    cfg = TriplaneConfig(dec_density_layers=layers, dec_rgb_layers=layers,
                         num_plane_channels=chans, skip_connect_every=3,
                         proj_combination="avg",
                         viewdir_proj_combination="concat_pos",
                         compute_dtype="bfloat16")
    gen = torch.Generator().manual_seed(seed)
    packed = fused_render.pack_decoder(_decoder(gen, cfg, device), cfg)
    planes = 0.5 * torch.randn((3, chans, res, res), generator=gen)
    table = fused_render.build_plane_table(planes.to(device))
    origins = torch.rand((R, 3), generator=gen) * 2 - 1
    dirs = torch.randn((R, 3), generator=gen)
    z = torch.sort(torch.rand((R, S), generator=gen) * 3 + 0.5, -1).values
    view = fused_render.view_rows(
        torch.randn((R, chans), generator=gen).to(device), packed.cvp)
    geom = fused_render.geometry_args(BOX, make_rot_mats(3))
    return (table, packed, origins.to(device), dirs.to(device),
            z.to(device), view, geom)


@pytest.mark.parametrize("layers,chans", [(4, 48), (6, 16), (7, 40)])
def test_kernel_matches_plain(device, layers, chans):
    args = _inputs(device, layers, chans)
    for so in (False, True):
        kw = dict(align_corners=True, avg=True, sigma_only=so)
        out = kernels.triplane_render(*args, **kw)
        ref = fused_render.fused_render_reference(*args, **kw)
        torch.cuda.synchronize()
        err = (out - ref).abs()
        assert err.max() < 2e-2 and err.mean() < 1e-3, (so, err.max())


def test_sigma_only_bit_identical_and_counted(device):
    args = _inputs(device, R=257, S=16, seed=1)
    mine = (kernels.triplane_render_full, kernels.triplane_render_sigma_only)
    before = [k.launches for k in mine]
    full = kernels.triplane_render(*args, align_corners=False, avg=False,
                                   sigma_only=False)
    so = kernels.triplane_render(*args, align_corners=False, avg=False,
                                 sigma_only=True)
    torch.cuda.synchronize()
    assert torch.equal(so[..., 3], full[..., 3])
    assert torch.all(so[..., :3] == args[1].bh[:3])
    assert [k.launches for k in mine] == [b + 1 for b in before]


# -- the trainable plane sampler (csrc/plane_sample.cu) -------------------
# The forward repeats its plain version's rounding step for step: bit-equal.
# The backward adds with atomics in an order that varies by run; its plain
# version adds with index_add_: f32 summation order only, atol 1e-5 on
# gradients of unit scale.


def _sampler_inputs(device, P=3, C=48, H=37, W=29, N=5000, seed=0):
    from nvsr_tpu_torch.ops.fused_render import build_plane_table
    gen = torch.Generator().manual_seed(seed)
    planes = torch.randn((P, C, H, W), generator=gen).to(device)
    # a fifth of the points fall outside [-1, 1]: the border clamps
    grids = (torch.rand((P, N, 2), generator=gen) * 2.5 - 1.25).to(device)
    dout = torch.randn((P, N, C), generator=gen).to(device)
    return planes, build_plane_table(planes), grids, dout


@pytest.mark.parametrize("align_corners", [True, False])
def test_plane_sample_fwd_bit_equal(device, align_corners):
    from nvsr_tpu_torch.ops import plane_sample as ps
    planes, table, grids, _ = _sampler_inputs(device)
    before = kernels.plane_sample_fwd.launches
    out = kernels.plane_sample_forward(table, grids, planes.shape[1],
                                       align_corners=align_corners)
    ref = ps.plane_sample_reference(table, grids, planes.shape[1],
                                    align_corners)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    assert kernels.plane_sample_fwd.launches == before + 1


@pytest.mark.parametrize("align_corners", [True, False])
def test_plane_sample_bwd_matches_plain(device, align_corners):
    from nvsr_tpu_torch.ops import plane_sample as ps
    planes, _, grids, dout = _sampler_inputs(device, seed=1)
    _, c, h, w = planes.shape
    before = kernels.plane_sample_bwd.launches
    out = kernels.plane_sample_backward(dout, grids, h, w,
                                        align_corners=align_corners)
    ref = ps.plane_sample_backward_reference(dout, grids, h, w,
                                             align_corners)
    torch.cuda.synchronize()
    assert out.shape == planes.shape
    assert (out - ref).abs().max() < 1e-5
    assert kernels.plane_sample_bwd.launches == before + 1


def test_plane_sample_autograd_goes_through_kernels(device):
    from nvsr_tpu_torch.ops import plane_sample as ps
    planes, _, grids, dout = _sampler_inputs(device, C=16, N=777, seed=2)
    planes.requires_grad_(True)
    before = [kernels.plane_sample_fwd.launches,
              kernels.plane_sample_bwd.launches]
    out = ps.plane_sample(planes, grids)
    (g,) = torch.autograd.grad(out, planes, dout)
    torch.cuda.synchronize()
    assert [kernels.plane_sample_fwd.launches,
            kernels.plane_sample_bwd.launches] == [b + 1 for b in before]
    ref = ps.plane_sample_backward_reference(dout, grids, *planes.shape[2:],
                                             True)
    assert (g - ref).abs().max() < 1e-5
