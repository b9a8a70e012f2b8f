"""Occupancy bound tightening (counterpart of
nvsr_tpu/ops/occupancy.py::tighten_near_far)."""

from __future__ import annotations

import torch


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
