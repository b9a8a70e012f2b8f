"""nvsr_tpu_torch.ops.plane_sample (the trainable plane sampler's plain
versions and autograd Function) against the JAX
`tiled_plane_sample_trainable` (its Pallas `_tile_gather` forward in
interpret mode, its XLA scatter backward) on the fixture of
tests/test_tile_sampler.py::_chunked_grids_and_cfg.

Tolerances. The JAX kernel takes its bf16 x-weights from the region-local
flat coordinate fidx = yl*tw + xl (f32), which loses up to ~9 bits of the
fraction at the fixture's 32x16 region, so a weight can differ from the
port's bf16(tx) by one bf16 ULP (2^-9 near 0.5), and a bf16 row sum can
then round the other way: one bf16 ULP of the row, 2^-6 = 1.6e-2 at the
fixture's |features| < 4. Forward: atol 1.6e-2, mean below 2e-5, and
more than 99% of the outputs bit-equal (measured: max 3.9e-3, 99.7%
equal). Backward: the same weights, bf16 cotangent rows and f32 sums in
another order: atol 1.6e-2 on gradients below 5, mean below 5e-6
(measured: max 2.9e-3, mean 2.6e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvsr_tpu.ops.pallas.tile_sampler import (TileSamplerConfig,
                                              from_chunks, to_chunks,
                                              tiled_plane_sample_trainable)
from nvsr_tpu_torch import kernels
from nvsr_tpu_torch.ops import plane_sample as ps
from nvsr_tpu_torch.ops.fused_render import build_plane_table
from nvsr_tpu_torch.ops.grid_sample import multi_plane_sample
from torch_port_helpers import t

CFG = TileSamplerConfig(tile_rays=16, slab=4, th=32, tw=16, group=2)
R, S = 32, 8


def _fixture(rng, P=3, C=8, H=64, W=64):
    """The inputs of tests/test_tile_sampler.py::_chunked_grids_and_cfg
    (same rng draws): planes and tile-coherent ray-major grids."""
    planes = rng.standard_normal((P, C, H, W)).astype(np.float32)
    ntiles, nslabs = R // CFG.tile_rays, S // CFG.slab
    centers = rng.uniform(-0.8, 0.8, size=(P, ntiles, nslabs, 2))
    g = np.repeat(np.repeat(centers[:, :, None, :, None, :], CFG.tile_rays,
                            axis=2), CFG.slab, axis=4)
    g = g + rng.uniform(-0.08, 0.08, size=g.shape)
    return planes, g.reshape(P, R, S, 2).astype(np.float32)


def _chunk(x):
    return to_chunks(jnp.asarray(x), R // CFG.tile_rays, CFG.tile_rays,
                     S // CFG.slab, CFG.slab)


def _unchunk(x, c):
    p = x.shape[0]
    return np.asarray(from_chunks(
        jnp.asarray(x).reshape(p, -1, CFG.tile_rays * CFG.slab, c),
        R // CFG.tile_rays, CFG.tile_rays, S // CFG.slab, CFG.slab))


def test_forward_matches_jax_kernel(rng):
    planes, grids = _fixture(rng)
    P, C = planes.shape[:2]
    out_j, ovf = tiled_plane_sample_trainable(jnp.asarray(planes),
                                              _chunk(grids), CFG, True, True)
    assert float(ovf) == 0.0
    ref = _unchunk(out_j, C).reshape(P, R * S, C)
    out = ps.plane_sample(t(planes), t(grids).reshape(P, R * S, 2)).numpy()
    err = np.abs(out - ref)
    assert err.max() < 1.6e-2 and err.mean() < 2e-5, (err.max(), err.mean())
    assert np.mean(err == 0) > 0.99


def test_backward_matches_jax_vjp(rng):
    planes, grids = _fixture(rng)
    P, C = planes.shape[:2]
    g_c = _chunk(grids)
    cot = rng.standard_normal((P, g_c.shape[1] * g_c.shape[2], C)
                              ).astype(np.float32)

    def loss(p):
        out, _ = tiled_plane_sample_trainable(p, g_c, CFG, True, True)
        return jnp.vdot(jnp.asarray(cot), out)

    ref = np.asarray(jax.grad(loss)(jnp.asarray(planes)))
    pt = t(planes).requires_grad_(True)
    out = ps.plane_sample(pt, t(grids).reshape(P, R * S, 2))
    (g,) = torch.autograd.grad(out, pt, t(_unchunk(cot, C)
                                          ).reshape(P, R * S, C))
    err = np.abs(g.numpy() - ref)
    assert 1.0 < np.abs(ref).max() < 5.0
    assert err.max() < 1.6e-2 and err.mean() < 5e-6, (err.max(), err.mean())


@pytest.mark.parametrize("align_corners", [True, False])
def test_backward_is_the_forward_transposed(rng, align_corners):
    """<dout, fwd(planes)> is linear in the table; its gradient, computed
    by autograd through the plain forward in f64 on the bf16-rounded
    operands, is the plain backward up to its bf16 cotangent rows."""
    P, C, H, W, N = 2, 16, 9, 7, 300
    planes = t(rng.standard_normal((P, C, H, W)).astype(np.float32))
    grids = t(rng.uniform(-1.3, 1.3, (P, N, 2)).astype(np.float32))
    dout = t(rng.standard_normal((P, N, C)).astype(np.float32))
    cells, w0, w1, ty = ps._taps(grids, H, W, align_corners)
    tab = build_plane_table(planes).double().reshape(P * H * W, -1)[:, :C]
    tab.requires_grad_(True)
    d = dout.reshape(P * N, C).double()
    top = w0.double() * tab[cells[0]] + w1.double() * tab[cells[1]]
    bot = w0.double() * tab[cells[2]] + w1.double() * tab[cells[3]]
    out = top * (1 - ty.double()) + bot * ty.double()
    (g,) = torch.autograd.grad(out, tab, d)
    ref = g.reshape(P, H, W, C).permute(0, 3, 1, 2)
    got = ps.plane_sample_backward_reference(dout, grids, H, W,
                                             align_corners)
    err = (got.double() - ref).abs()
    assert err.max() < 4e-2 and err.mean() < 2e-3, err.max()


def test_matches_f32_weight_sampler(rng):
    """Against the reference gather with the same bf16 taps but f32
    weights and f32 rows (grid_sample.multi_plane_sample): the bf16
    weights and rows differ by at most a few bf16 ULPs of |features|."""
    planes, grids = _fixture(rng)
    P, C = planes.shape[:2]
    g = t(grids).reshape(P, R * S, 2)
    ref = multi_plane_sample(t(planes), g, tap_dtype=torch.bfloat16)
    out = ps.plane_sample(t(planes), g)
    err = (out - ref).abs()
    assert err.max() < 5e-2 and err.mean() < 5e-3


def test_no_tile_coherence_needed(rng):
    """Ray-major, order-free: scattered points give the same values as
    the same points sampled one by one in another order."""
    P, C, H, W, N = 3, 8, 20, 30, 500
    planes = t(rng.standard_normal((P, C, H, W)).astype(np.float32))
    grids = t(rng.uniform(-1, 1, (P, N, 2)).astype(np.float32))
    perm = torch.as_tensor(rng.permutation(N))
    out = ps.plane_sample(planes, grids)
    out_p = ps.plane_sample(planes, grids[:, perm])
    assert torch.equal(out[:, perm], out_p)


def test_grids_get_no_gradient(rng):
    planes = t(rng.standard_normal((3, 8, 10, 10)).astype(np.float32))
    grids = t(rng.uniform(-2, 2, (3, 40, 2)).astype(np.float32))
    planes.requires_grad_(True)
    grids.requires_grad_(True)
    out = ps.plane_sample(planes, grids)
    gp, gg = torch.autograd.grad(out.square().sum(), (planes, grids),
                                 allow_unused=True)
    assert gg is None and torch.isfinite(gp).all()


def test_cuda_tensors_never_take_the_plain_versions(monkeypatch):
    """sample_forward / sample_backward dispatch on the tensor's device
    alone: CUDA tensors go to the kernel wrappers (stubs that record the
    call), never to the plain versions."""
    calls = []

    class FakeCuda(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda")

    def plain(*args, **kw):
        raise AssertionError("plain version used for a CUDA tensor")

    monkeypatch.setattr(kernels, "plane_sample_forward",
                        lambda *a, **kw: calls.append(("fwd", kw)))
    monkeypatch.setattr(kernels, "plane_sample_backward",
                        lambda *a, **kw: calls.append(("bwd", kw)))
    monkeypatch.setattr(ps, "plane_sample_reference", plain)
    monkeypatch.setattr(ps, "plane_sample_backward_reference", plain)
    table = torch.zeros((3, 4, 4, 16)).as_subclass(FakeCuda)
    dout = torch.zeros((3, 5, 16)).as_subclass(FakeCuda)
    grids = torch.zeros((3, 5, 2))
    ps.sample_forward(table, grids, 16, True)
    ps.sample_backward(dout, grids, 4, 4, False)
    assert calls == [("fwd", {"align_corners": True}),
                     ("bwd", {"align_corners": False})]


def test_kernel_wrappers_refuse_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        kernels.plane_sample_forward(torch.zeros((3, 4, 4, 16)),
                                     torch.zeros((3, 5, 2)), 16,
                                     align_corners=True)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.plane_sample_backward(torch.zeros((3, 5, 16)),
                                      torch.zeros((3, 5, 2)), 4, 4,
                                      align_corners=True)
