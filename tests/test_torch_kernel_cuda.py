"""The CUDA kernels against their plain versions, on the card.

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


def _inputs(device, layers=4, chans=48, R=300, S=24, res=96, seed=0,
            rgb_layers=None, skip=3, view_chans=None):
    cfg = TriplaneConfig(dec_density_layers=layers,
                         dec_rgb_layers=rgb_layers or layers,
                         num_plane_channels=chans, skip_connect_every=skip,
                         num_viewdir_plane_channels=view_chans,
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
        torch.randn((R, cfg.viewdir_channels), generator=gen).to(device),
        packed.cvp)
    geom = fused_render.geometry_args(BOX, make_rot_mats(3))
    return (table, packed, origins.to(device), dirs.to(device),
            z.to(device), view, geom)


# decoder and point-count cases of the persistent decoder (csrc/decoder.cuh):
# feature widths cp/cvp 16 and 64, a skip after every layer, density and
# rgb depths that differ, a ragged last 128-point tile (N = 128 k + 37), N
# below one tile, and more tiles than the card has SMs (132), so each
# block's loop wraps
SHAPES = {
    "cp16": dict(chans=16, view_chans=16),
    "cp64": dict(chans=64, view_chans=64),
    "cp64v16": dict(chans=64, view_chans=16),
    "skip1": dict(layers=5, skip=1),
    "d3r6": dict(layers=3, rgb_layers=6, chans=32),
    "ragged": dict(R=161, S=5),            # N = 805 = 6 * 128 + 37
    "small": dict(R=7, S=9),               # N = 63
    "wrap": dict(R=1100, S=24),            # N = 26,400: 207 tiles
}


@pytest.mark.parametrize("cubic", [False, True])
@pytest.mark.parametrize("layers,chans,shape", [
    (4, 48, None), (6, 16, None), (7, 40, None)] + [
    (None, None, name) for name in SHAPES])
def test_kernel_matches_plain(device, layers, chans, shape, cubic):
    kw = dict(SHAPES.get(shape, {}))
    if layers is not None:
        kw.update(layers=layers, chans=chans)
    args = _inputs(device, **kw)
    for so in (False, True):
        kw = dict(align_corners=True, avg=True, sigma_only=so, cubic=cubic)
        out = kernels.triplane_render(*args, **kw)
        ref = fused_render.fused_render_reference(*args, **kw)
        torch.cuda.synchronize()
        err = (out - ref).abs()
        assert err.max() < 2e-2 and err.mean() < 1e-3, (so, err.max())


@pytest.mark.parametrize("cubic", [False, True])
def test_sigma_only_bit_identical_and_counted(device, cubic):
    args = _inputs(device, R=257, S=16, seed=1)
    mine = ((kernels.triplane_render_cubic_full,
             kernels.triplane_render_cubic_sigma_only) if cubic else
            (kernels.triplane_render_full, kernels.triplane_render_sigma_only))
    before = [k.launches for k in mine]
    full = kernels.triplane_render(*args, align_corners=False, avg=False,
                                   sigma_only=False, cubic=cubic)
    so = kernels.triplane_render(*args, align_corners=False, avg=False,
                                 sigma_only=True, cubic=cubic)
    torch.cuda.synchronize()
    assert torch.equal(so[..., 3], full[..., 3])
    assert torch.all(so[..., :3] == args[1].bh[:3])
    assert [k.launches for k in mine] == [b + 1 for b in before]


# -- the trainable plane sampler (csrc/plane_sample.cu) -------------------
# The forward repeats its plain version's rounding step for step: bit-equal.
# The backward sums each chunk of points in shared memory, then adds with
# atomics, in an order that varies by run; its plain version adds with
# index_add_: f32 summation order only, atol 1e-5 on gradients of unit
# scale.


def _sampler_inputs(device, P=3, C=48, H=37, W=29, N=5000, seed=0,
                    coherent=False):
    from nvsr_tpu_torch.ops.fused_render import build_plane_table
    gen = torch.Generator().manual_seed(seed)
    planes = torch.randn((P, C, H, W), generator=gen)
    if coherent:
        # tile-coherent, as training orders its points: each run of 1024
        # points lies within +-2 cells of one centre (the chunk tables'
        # worst contention: every point of a chunk on a few cells)
        runs = (N + 1023) // 1024
        centres = torch.rand((P, runs, 1, 2), generator=gen) * 2 - 1
        jitter = (torch.rand((P, runs, 1024, 2), generator=gen) - 0.5) \
            * torch.tensor([8.0 / W, 8.0 / H])
        grids = (centres + jitter).reshape(P, runs * 1024, 2)[:, :N]
        # ~160 taps land on each of those cells: dout / 8 keeps the
        # gradients at the unit scale the 1e-5 tolerance assumes (the f32
        # summation-order difference grows with the sums)
        dscale = 0.125
    else:
        # uniform over 2.5x the plane: a fifth of the points fall outside
        # [-1, 1] (the border clamps) and nearly every tap of a chunk has
        # a cell of its own (the chunk tables at their fullest)
        grids = torch.rand((P, N, 2), generator=gen) * 2.5 - 1.25
        dscale = 1.0
    dout = torch.randn((P, N, C), generator=gen) * dscale
    planes, grids, dout = (t.contiguous().to(device)
                           for t in (planes, grids, dout))
    return planes, build_plane_table(planes), grids, dout


# (plane channels, channels sampled): C = 40 reads a 48-wide table; 8, 24,
# 48 and 264 give 1, 3, 6 and 32 lanes a point; N = 5000 is no multiple of
# a warp's batch of points
@pytest.mark.parametrize("chans", [(48, 48), (48, 40), (8, 8), (24, 24),
                                   (264, 264)])
@pytest.mark.parametrize("cubic", [False, True])
@pytest.mark.parametrize("align_corners", [True, False])
def test_plane_sample_fwd_bit_equal(device, align_corners, cubic, chans):
    from nvsr_tpu_torch.ops import plane_sample as ps
    c, channels = chans
    planes, table, grids, _ = _sampler_inputs(device, C=c)
    kern = kernels.plane_sample_cubic_fwd if cubic else \
        kernels.plane_sample_fwd
    before = kern.launches
    out = kernels.plane_sample_forward(table, grids, channels,
                                       align_corners=align_corners,
                                       cubic=cubic)
    ref = ps.plane_sample_reference(table, grids, channels, align_corners,
                                    cubic)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    assert kern.launches == before + 1


# tile-coherent grids (hot cells: a cell's taps split over many threads
# and merged by the warp sum) and uniformly random ones (a cell per tap,
# the tables at their fullest); any C (3 takes the 4-byte copies); P = 1
# with N = 1023, no multiple of a chunk
@pytest.mark.parametrize("shape", [(3, 5000, 37, 29), (1, 1023, 120, 90)])
@pytest.mark.parametrize("c", [3, 16, 48, 64])
@pytest.mark.parametrize("coherent", [False, True])
@pytest.mark.parametrize("align_corners", [True, False])
def test_plane_sample_bwd_matches_plain(device, align_corners, coherent, c,
                                        shape):
    from nvsr_tpu_torch.ops import plane_sample as ps
    p, n, h, w = shape
    planes, _, grids, dout = _sampler_inputs(
        device, P=p, C=c, H=h, W=w, N=n, seed=1, coherent=coherent)
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


# -- no fallback: a failed library load or a device other than the card
# and the CPU raises; the plain version is never taken


def test_failed_library_load_raises(device, monkeypatch):
    from nvsr_tpu_torch.ops import plane_sample as ps

    def broken(source):
        raise OSError(f"cannot load the library of {source}")

    def plain(*args, **kw):
        raise AssertionError("plain version used for a CUDA tensor")

    monkeypatch.setattr(kernels, "_load", broken)
    for k in kernels.KERNELS:
        monkeypatch.setattr(k, "_fn", None)
    monkeypatch.setattr(fused_render, "fused_render_reference", plain)
    monkeypatch.setattr(ps, "plane_sample_reference", plain)
    args = _inputs(device, R=8, S=4)
    before = [k.launches for k in kernels.KERNELS]
    with pytest.raises(OSError):
        fused_render.fused_render_rays(*args, align_corners=True, avg=True,
                                       sigma_only=False, cubic=True)
    planes, table, grids, _ = _sampler_inputs(device, N=16)
    with pytest.raises(OSError):
        ps.sample_forward(table, grids, planes.shape[1], True, cubic=True)
    assert [k.launches for k in kernels.KERNELS] == before


def test_meta_tensors_raise(device):
    from nvsr_tpu_torch.ops import plane_sample as ps
    args = [a.to("meta") if torch.is_tensor(a) else a
            for a in _inputs(device, R=8, S=4)]
    for cubic in (False, True):
        with pytest.raises(ValueError, match="CUDA"):
            fused_render.fused_render_rays(
                *args, align_corners=True, avg=True, sigma_only=True,
                cubic=cubic)
        with pytest.raises(ValueError, match="CUDA"):
            ps.sample_forward(torch.zeros((3, 4, 4, 16), device="meta"),
                              torch.zeros((3, 5, 2), device="meta"), 16,
                              True, cubic=cubic)


# -- the grids entries of csrc/triplane_render.cu, the standalone decoder
# (csrc/fused_decode.cu) and the row gather (csrc/gather_rows.cu). The
# grids entries and the decoder share every rounding with their plain
# versions up to the decoder (atol 2e-2, mean 1e-3, as above); the gather
# copies, bit-equal.


def _grids_inputs(device, layers=4, chans=48, seed=3, **kw):
    kw.setdefault("R", 300)
    kw.setdefault("S", 24)
    table, packed, origins, dirs, z, view, geom = _inputs(
        device, layers, chans, seed=seed, **kw)
    r, s = z.shape
    grids = torch.stack(fused_render.plane_grids(origins, dirs, z, geom))
    # a fifth of the points past the border
    grids[:, ::5] *= 1.3
    view_pts = view[:, None, :].expand(r, s, packed.cvp).reshape(
        r * s, packed.cvp).contiguous()
    return table, packed, grids.contiguous(), view_pts


@pytest.mark.parametrize("form,sigma_only", [("v2", False), ("v2", True),
                                             ("v1", False)])
@pytest.mark.parametrize("layers,chans,shape", [
    (4, 48, None), (6, 16, None)] + [(4, 48, name) for name in SHAPES])
def test_grids_entries_match_plain(device, layers, chans, shape, form,
                                   sigma_only):
    kw = dict(layers=layers, chans=chans)
    kw.update(SHAPES.get(shape, {}))
    table, packed, grids, view = _grids_inputs(device, **kw)
    kern = (kernels.triplane_render_grids_v1 if form == "v1" else
            kernels.triplane_render_grids_sigma_only if sigma_only else
            kernels.triplane_render_grids_full)
    before = kern.launches
    kw = dict(align_corners=True, avg=True, sigma_only=sigma_only)
    out = fused_render.tiled_render_chunked(table, packed, grids, view,
                                            form=form, **kw)
    ref = fused_render.tiled_render_chunked_reference(
        table, packed, grids, view, form=form, **kw)
    torch.cuda.synchronize()
    assert out.shape == (grids.shape[1], 4)
    err = (out - ref).abs()
    assert err.max() < 2e-2 and err.mean() < 1e-3, err.max()
    assert kern.launches == before + 1


def test_grids_entry_equals_the_ray_entry(device):
    """At the plane coordinates of o + d*z (computed by plane_grids as the
    ray entry computes them in the kernel) and the ray's view row per
    point, the v2 grids entries give the ray entries' output bit for bit."""
    table, packed, origins, dirs, z, view, geom = _inputs(device, seed=4)
    r, s = z.shape
    grids = torch.stack(fused_render.plane_grids(origins, dirs, z, geom)
                        ).contiguous()
    view_pts = view[:, None, :].expand(r, s, packed.cvp).reshape(
        r * s, packed.cvp).contiguous()
    for so in (False, True):
        kw = dict(align_corners=True, avg=True, sigma_only=so)
        rays = kernels.triplane_render(table, packed, origins, dirs, z, view,
                                       geom, **kw)
        pts = kernels.triplane_render_grids(table, packed, grids,
                                            None if so else view_pts, **kw)
        torch.cuda.synchronize()
        assert torch.equal(rays.reshape(r * s, 4), pts), so


@pytest.mark.parametrize("shape,n", [(None, 1000)] + [
    (name, {"ragged": 805, "small": 63, "wrap": 26400}.get(name, 1000))
    for name in SHAPES])
def test_fused_decode_matches_plain(device, shape, n):
    from nvsr_tpu_torch.ops import fused_decoder as fd
    kw = {k: v for k, v in SHAPES.get(shape, {}).items()
          if k not in ("R", "S")}
    _, packed, *_ = _inputs(device, seed=5, R=8, S=4, **kw)
    gen = torch.Generator().manual_seed(6)
    rows = (0.5 * torch.randn((3 * n, 128), generator=gen)).to(
        torch.bfloat16).to(device)
    ty = torch.rand((3 * n,), generator=gen).to(device)
    view = torch.randn((n, 64), generator=gen).to(device)
    before = kernels.fused_decode.launches
    out = fd.fused_decode(rows, ty, view, packed, avg=True)
    ref = fd.fused_decode_reference(rows, ty, view, packed, avg=True)
    torch.cuda.synchronize()
    assert out.shape == (n, 8) and torch.all(out[:, 4:] == 0)
    err = (out - ref).abs()
    assert err.max() < 2e-2 and err.mean() < 1e-3, err.max()
    assert kernels.fused_decode.launches == before + 1


# the last case is many times the rows the card holds in flight at once
# (C = 256: 16 rows a block, 8,448 blocks, 64 for each of 132 SMs)
@pytest.mark.parametrize("hw,c,n", [(4096, 256, 3072), (1024, 48, 3072),
                                    (4096, 4, 3072), (4096, 2, 3072),
                                    (8192, 256, 135168)])
def test_gather_rows_bit_equal(device, hw, c, n):
    from nvsr_tpu_torch.ops import gather_dma as gd
    gen = torch.Generator().manual_seed(7)
    table = torch.randn((hw, c), generator=gen).to(device)
    idx = torch.randint(0, hw, (n,), generator=gen,
                        dtype=torch.int32).to(device)
    before = kernels.gather_rows.launches
    out = (gd.gather_rows_dma(table, idx) if 1024 % c == 0 else
           kernels.gather_rows_forward(table, idx))
    torch.cuda.synchronize()
    assert torch.equal(out, gd.gather_rows_reference(table, idx))
    assert kernels.gather_rows.launches == before + 1
