"""mfu.train: the model operations of the run's unprofiled iterations
over their time (host clock: the window less its profiled part), at the
f32 peak, TF32 off (%).

An iteration's model operations are 3x the forward multiply-adds (x2)
of its networks (forward and backward):
* the baseline: its MLP at every coarse and fine interval of every ray
  (a mip pass over E edges decodes E - 1 intervals; the fine edges are
  the coarse ones and n_fine + 1 more); every kind of iteration renders
  the same number of rays;
* a triplane model: the decoder at every coarse point and every fine
  point (the coarse depths and n_fine more) of every ray, and on an HR
  ("sr") iteration the EDSR's forward over the planes
  (sr_convs_roofline.edsr_forward_flops; the recompute of its blocks in
  the backward is not counted)."""

import importlib.util
import os


def mlp_flops(mc):
    """Forward multiply-adds (x2) of the baseline MLP for one point."""
    h, dx, dd = mc.hidden_size, mc.dim_xyz, mc.dim_dir
    flops = dx * h
    for i in range(mc.num_layers - 1):
        skip = i > 0 and i % mc.skip_connect_every == 0
        flops += (h + (dx if skip else 0)) * h
    flops += h * h + h + (h + dd) * (h // 2) + (h // 2) * 3
    return 2 * flops


def _edsr_forward_flops(*args):
    path = os.path.join(os.path.dirname(__file__), "sr_convs_roofline.py")
    spec = importlib.util.spec_from_file_location("sr_convs_roofline", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.edsr_forward_flops(*args)


def iteration_flops(work, kind):
    rays, nc, nf = work["rays"], work["n_coarse"], work["n_fine"]
    if "mlp_cfg" in work:
        fine = (nc + 1) + (nf + 1) - 1
        return 3 * mlp_flops(work["mlp_cfg"]) * rays * (nc + fine)
    point = 2 * sum(i * o for i, o in work["decoder_dims"])
    flops = 3 * point * rays * (nc + nc + nf)
    if kind == "sr":
        flops += 3 * _edsr_forward_flops(*work["edsr"])
    return flops


def read(ctx):
    work, rec = ctx.work, ctx.record
    counts = {k: n for k, n in (work.get("untraced") or {}).items() if n}
    n = sum(counts.values())
    if not n or rec.get("window_s") is None:
        return None
    secs = rec["window_s"] - rec.get("traced_s", 0.0)
    flops = sum(iteration_flops(work, k) * c for k, c in counts.items())
    return 100.0 * flops / (secs * ctx.peaks["f32_flops_per_s"])
