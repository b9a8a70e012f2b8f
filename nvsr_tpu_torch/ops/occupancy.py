"""Occupancy-guided sampling bounds (counterpart of
nvsr_tpu/ops/occupancy.py): the occupied box of a density field, and the
tightening of each ray's [near, far] to it."""

from __future__ import annotations

import torch


def estimate_occupied_box(density_fn, box, *, grid: int = 64,
                          threshold: float = 0.0, margin: float = 1.0):
    """Occupied world AABB [2, 3] of a density field.

    density_fn: [N, 3] world points -> [N] raw density logits; box: the
    scene's normalization box [2, D] (numpy or tensor; world xyz bounds in
    box[:, :3]); occupancy is sigma_logit > threshold on a grid^3 lattice
    over the box, dilated by `margin` voxels and clipped to the box. With
    nothing occupied, the scene box. The lattice is built on the device of
    the box tensor (the CPU for a numpy box) and evaluated in one call."""
    box = torch.as_tensor(box, dtype=torch.float32)
    lo, hi = box[0, :3], box[1, :3]
    # jnp.linspace's rounding: start + (i / (n-1)) * (stop - start), and
    # the stop itself last
    frac = torch.arange(grid - 1, device=box.device, dtype=torch.float32) \
        / (grid - 1)
    axes = [torch.cat([lo[d] + frac * (hi[d] - lo[d]), hi[d:d + 1]])
            for d in range(3)]
    pts = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)
    occ = density_fn(pts.reshape(-1, 3)).reshape(grid, grid, grid) \
        > threshold
    voxel = (hi - lo) / (grid - 1)
    idx = torch.stack(torch.meshgrid(
        *[torch.arange(grid, device=box.device)] * 3, indexing="ij"), dim=-1)

    def axis_bounds(d):
        mn = torch.amin(torch.where(occ, idx[..., d], grid))
        mx = torch.amax(torch.where(occ, idx[..., d], -1))
        return mn, mx

    bounds = [axis_bounds(d) for d in range(3)]
    mins = torch.stack([b[0] for b in bounds]).to(torch.float32) - margin
    maxs = torch.stack([b[1] for b in bounds]).to(torch.float32) + margin
    any_occ = torch.any(occ)
    world_lo = torch.where(any_occ, lo + mins * voxel, lo)
    world_hi = torch.where(any_occ, lo + maxs * voxel, hi)
    return torch.stack([torch.maximum(world_lo, lo),
                        torch.minimum(world_hi, hi)], dim=0)


def tighten_near_far(ray_origins, ray_directions, near, far, aabb):
    """Clamp each ray's [near, far] ([R, 1]) to its slab intersection
    with the [2, 3] world box `aabb`.

    Returns (near', far', hit). Rays that miss the box get a DEGENERATE
    interval (near' == far') at the clipped slab midpoint, so they
    composite to exact background (ops/rendering.py zero-span guard) and
    stay continuous across the hit/miss silhouette.
    """
    eps = 1e-9
    inv = 1.0 / torch.where(ray_directions.abs() < eps,
                            torch.where(ray_directions >= 0,
                                        torch.full_like(ray_directions, eps),
                                        torch.full_like(ray_directions, -eps)),
                            ray_directions)
    t0 = (aabb[0] - ray_origins) * inv
    t1 = (aabb[1] - ray_origins) * inv
    t_enter = torch.amax(torch.minimum(t0, t1), dim=-1, keepdim=True)
    t_exit = torch.amin(torch.maximum(t0, t1), dim=-1, keepdim=True)
    hit = t_exit > torch.clamp(t_enter, min=0.0)
    new_near = torch.minimum(torch.maximum(t_enter, near), far)
    new_far = torch.minimum(torch.maximum(t_exit, near), far)
    valid = hit & (new_far > new_near)
    mid = torch.minimum(torch.maximum(0.5 * (t_enter + t_exit), near), far)
    return (torch.where(valid, new_near, mid),
            torch.where(valid, new_far, mid), valid)
