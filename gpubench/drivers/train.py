"""Training through the Experiment, in a closed loop.

Set-up writes the config's scenes from the seed (synthetic Blender-style
views in TMPDIR), builds `experiment.Experiment` on the device and puts
the benchmark's weights (and, for a triplane model, each scene's planes),
drawn from the seed on the device, in place of the ones it drew. The
benchmark draws the traffic itself, from the seed: which scene and view
each iteration trains (in rounds that hold every scene of the mix in
proportion to its configured probability, shuffled within the round)
and the pixels of each view, which it hands to the Experiment in place
of its own draws. Set-up drives `Experiment.train_iteration` through its
first `check_rounds` rounds, then `warmup_iters` more, to the end of a
round. The window calls
`train_iteration` in a loop of whole rounds, flushing the queued metrics
every `print_every` iterations as the Experiment's own loop does; one
synchronize closes it. After the window the plain reference follows the
checked iterations from the same weights and draws.
"""

from __future__ import annotations

import math
import os
import re
import tempfile
import time
from collections import Counter
from fractions import Fraction

import numpy as np

from gpubench import inputs
from gpubench.harness import experiment_config

ADAM_B1 = 0.9


def _leaf_items(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaf_items(tree[k],
                                                             f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _leaf_items(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def _scenes(ctx, root):
    """Write every scene the config names -> {scene: {split: views}}."""
    cfg = ctx.config
    names = sorted({s for split in cfg["dataset"]["dir"].values()
                    for group in split.values() for s in group})
    return {name: inputs.synthetic_scene(
        os.path.join(root, "synt"), name, ctx.param("image"),
        ctx.param("views"), ctx.param("camera_angle_x"), [ctx.seed, k])
        for k, name in enumerate(names)}


def _name(scene_id):
    return re.sub(r"_DS\d.*", "", scene_id)


def _ds(scene_id):
    return int(re.search(r"_DS(\d+)", scene_id).group(1))


class Draws:
    """The benchmark's traffic, handed to the Experiment in place of its
    own draws: `sample` (the image sampler's) gives the next (scene,
    image index) of the round schedule, `pixels` and `patches` the
    pixels of a view (the module's choose_random_pixels and
    choose_patch_pixels). While `recording`, each iteration's scene,
    view and pixels are kept in `steps`."""

    def __init__(self, ctx, exp, module, scenes):
        self.rng = np.random.default_rng([ctx.seed, 3])
        self.exp, self.module, self.scenes = exp, module, scenes
        self.steps, self.recording, self.fits = [], True, True
        self.round, self.kinds = [], []
        self.saved = (exp.image_sampler.sample, module.choose_random_pixels,
                      module.choose_patch_pixels)
        sampler = exp.image_sampler
        self.views = {}
        for sc in sampler.active_scenes:
            poses = [c2w for c2w, _ in scenes[_name(sc)]["train"]]
            idx = {}
            for i in sampler.scenes_dict[sc]:
                hit = [k for k, p in enumerate(poses)
                       if np.array_equal(p, exp.dataset.item(i)[1])]
                self.fits &= len(hit) == 1 and hit[0] not in idx
                idx[hit[0] if hit else -1] = i
            self.views[sc] = idx
        probs = Counter()
        for (sc_num, _), p in zip(sampler.im_inds, sampler.im_probs):
            probs[sampler.active_scenes[sc_num]] += p
        counts = {sc: Fraction(p).limit_denominator(64)
                  for sc, p in probs.items()}
        den = math.lcm(*(c.denominator for c in counts.values()))
        self.mix = [sc for sc in sampler.active_scenes
                    for _ in range(int(counts[sc] * den))]
        sampler.sample = self.sample
        module.choose_random_pixels = self.pixels
        module.choose_patch_pixels = self.patches

    def kind(self, scene):
        exp = self.exp
        if exp.im_inconsistency_loss_w and \
                scene in exp.dataset.val_only_scene_ids:
            return "consistency"
        if exp.planes_model and scene in \
                exp.scene_coupler.downsample_couples:
            return "sr"
        return "lr"

    def at_round_start(self):
        return not self.round

    def sample(self):
        if not self.round:
            self.round = [self.mix[i] for i in
                          self.rng.permutation(len(self.mix))]
        sc = self.round.pop(0)
        k = int(self.rng.choice(sorted(self.views[sc])))
        self.kinds.append(self.kind(sc))
        if self.recording:
            self.steps.append({"scene": sc, "view": k,
                               "kind": self.kinds[-1]})
        return sc, self.views[sc][k]

    def _keep(self, rows, cols):
        if self.recording:
            self.steps[-1].update(rows=rows, cols=cols)

    def pixels(self, _rng, image, num_rays):
        h, w = image.shape[:2]
        idx = self.rng.choice(h * w, size=min(h * w, num_rays),
                              replace=False)
        rows, cols = idx // w, idx % w
        self._keep(rows, cols)
        return rows, cols, image[rows, cols]

    def patches(self, _rng, lr_image, num_rays, ds):
        lh, lw = lr_image.shape[:2]
        idx = self.rng.choice(lh * lw, size=min(lh * lw, num_rays // ds ** 2),
                              replace=False)
        rows, cols = idx // lw, idx % lw
        target = lr_image[rows, cols]
        n = len(idx)
        hr_rows = np.broadcast_to(rows[:, None, None] * ds + np.arange(ds)[
            None, :, None], (n, ds, ds)).reshape(-1)
        hr_cols = np.broadcast_to(cols[:, None, None] * ds + np.arange(ds)[
            None, None, :], (n, ds, ds)).reshape(-1)
        self._keep(hr_rows, hr_cols)
        return hr_rows, hr_cols, target

    def close(self):
        (self.exp.image_sampler.sample, self.module.choose_random_pixels,
         self.module.choose_patch_pixels) = self.saved


def _weights(ctx, exp):
    """The benchmark's weights, from the seed on the device, in the
    program's layout: {"decoders": {"dc", "df"}} for the baseline's MLPs;
    with planes also "sr" ({"inner": EDSR}) and "planes" ({saved scene:
    {"pos", "view"}})."""
    import torch
    dev = ctx.device
    gen = torch.Generator(device=dev).manual_seed(ctx.seed)
    names = sorted(exp.decoder_opt.params)
    if not exp.planes_model:
        mc = exp.mlp_cfg
        return {"decoders": {k: inputs.nerf_mlp(
            gen, mc.dim_xyz, mc.dim_dir, mc.hidden_size, mc.num_layers,
            mc.skip_connect_every, dev) for k in names}}
    mc, sc = exp.model_cfg, exp.sr_cfg
    decs = {k: {"members": [inputs.triplane_decoder(
        gen, mc.num_plane_channels, mc.viewdir_channels, mc.dec_channels,
        mc.dec_density_layers, mc.skip_connect_every,
        ctx.param("density_bias"), dev)]} for k in names}
    std = ctx.param("plane_std")
    buf = exp.planes_buffer
    shapes = {s: {k: tuple(t.shape) for k, t in buf.resident[s].params()
                  .items()} for s in sorted(buf.resident)}
    flat = torch.randn(sum(math.prod(v) for sh in shapes.values()
                           for v in sh.values()), generator=gen,
                       device=dev) * std
    planes, at = {}, 0
    for s, sh in shapes.items():
        planes[s] = {}
        for k, shape in sh.items():
            n = math.prod(shape)
            planes[s][k] = flat[at:at + n].reshape(shape)
            at += n
    out = {"decoders": decs, "planes": planes}
    if exp.sr_opt is not None:
        out["sr"] = {"inner": inputs.edsr_weights(
            gen, mc.num_plane_channels, sc.hidden_size, sc.n_blocks,
            sc.scale_factor, dev)}
    return out


def _hand_over(exp, init):
    """Copy the benchmark's weights into the Experiment's tensors (those
    its optimizers step)."""
    import torch
    pairs = [(exp.decoder_opt.params, init["decoders"])]
    if "sr" in init:
        pairs.append((exp.sr_opt.params, init["sr"]))
    for s, p in init.get("planes", {}).items():
        pairs.append((exp.planes_buffer.resident[s].params(), p))
    with torch.no_grad():
        for mine, theirs in pairs:
            mine = dict(_leaf_items(mine))
            for path, w in _leaf_items(theirs):
                if mine[path].shape != w.shape:
                    raise ValueError(f"{path}: {tuple(w.shape)} for "
                                     f"{tuple(mine[path].shape)}")
                mine[path].copy_(w)


def _opt_groups(exp):
    """[(path prefix, params tree, torch Adam or None)] of every group
    the Experiment trains (a scene's planes have no Adam before their
    first step), each tensor's Adam state in opt.state."""
    groups = [("", exp.decoder_opt.params, exp.decoder_opt.opt)]
    if exp.sr_opt is not None:
        groups.append(("/sr", exp.sr_opt.params, exp.sr_opt.opt))
    if exp.planes_model:
        buf = exp.planes_buffer
        for s in sorted(buf.resident):
            groups.append((f"/planes/{s}", buf.resident[s].params(),
                           buf.opt.opts.get(s)))
    return groups


def _first_grads(exp, have):
    """Each Adam's first gradient, taken once its step count is 1:
    Adam's first moment after one step is (1 - b1) g. Adds to `have`."""
    for prefix, params, opt in _opt_groups(exp):
        for p, t in _leaf_items(params):
            st = opt.state.get(t) if opt is not None else None
            if f"{prefix}{p}" not in have and st and int(st["step"]) == 1:
                have[f"{prefix}{p}"] = st["exp_avg"] / (1 - ADAM_B1)


def run(ctx):
    import torch
    from gpubench import trace as tr
    from nvsr_tpu_torch import experiment
    from nvsr_tpu_torch.utils.config import CfgNode
    dev = ctx.device
    cuda = dev.type == "cuda"
    ctx.note("imports")
    tmp = tempfile.TemporaryDirectory()
    root = tmp.name
    scenes = _scenes(ctx, root)
    ctx.note("scenes written")
    raw = experiment_config(ctx.config)
    raw["dataset"]["synt"]["root"] = "synt"
    raw["experiment"]["logdir"] = "logs"
    raw["experiment"]["randomseed"] = ctx.seed
    for key, value in ctx.overrides.get("config", {}).items():
        node = raw
        *path, last = key.split(".")
        for p in path:
            node = node[p]
        node[last] = value
    exp = experiment.Experiment(CfgNode(raw), root_path=root, device=dev)
    if exp.planes_model:
        exp.planes_buffer.draw_scenes()
    exp._update_active_scenes()
    init = _weights(ctx, exp)
    _hand_over(exp, init)
    draws = Draws(ctx, exp, experiment, scenes)
    ctx.note("Experiment built")

    # the checked iterations: the first check_rounds rounds, which hold
    # every kind of the mix
    it, first_grad = 0, {}
    for _ in range(ctx.param("check_rounds")):
        while True:
            exp.train_iteration(it)
            _first_grads(exp, first_grad)
            it += 1
            if draws.at_round_start():
                break
    n_check = it
    draws.recording = False
    after = [(f"{prefix}{p}", t.detach().clone())
             for prefix, params, _ in _opt_groups(exp)
             for p, t in _leaf_items(params)]
    losses = [float(m[3][0]) for m in exp._pending_metrics[:n_check]]
    ctx.note(f"{n_check} checked iterations")
    # at least warmup_iters more, up to the end of a round, so that the
    # window starts a round
    warm_end = it + ctx.param("warmup_iters")
    while it < warm_end or not draws.at_round_start():
        exp.train_iteration(it)
        it += 1
    exp.flush_train_metrics()
    if cuda:
        torch.cuda.synchronize()
    ctx.record["setup_s"] = time.time() - ctx.start

    every = int(raw["experiment"].get("print_every", 100))
    n_trace = ctx.param("trace_iters") if ctx.trace else 0
    done, traced = 0, []
    window_kinds = len(draws.kinds)
    t0 = time.perf_counter()
    end = t0 + ctx.seconds
    # whole rounds: every run does the mix's work in its proportions
    while time.perf_counter() < end or not draws.at_round_start():
        if done == ctx.param("trace_skip") and n_trace:
            first, k0 = it, len(draws.kinds)

            def profiled():
                for j in range(first, first + n_trace):
                    exp.train_iteration(j)

            t = time.perf_counter()
            ctx.trace_data = tr.profile(profiled, dev.type)
            ctx.record["traced_s"] = time.perf_counter() - t
            ctx.record["traced_iterations"] = n_trace
            traced = draws.kinds[k0:]
            it += n_trace
            done += n_trace
        else:
            exp.train_iteration(it)
            it += 1
            done += 1
        if done % every == 0:
            exp.flush_train_metrics()
    if cuda:
        torch.cuda.synchronize()
    window = time.perf_counter() - t0
    exp.flush_train_metrics()
    ctx.record.update(window_s=window, iterations=done, attempted=done,
                      failed=0, round=list(draws.mix))
    ctx.record["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev) \
        if cuda else 0
    untraced = Counter(draws.kinds[window_kinds:])
    untraced.subtract(Counter(traced))
    ctx.work = {"traced": traced, "untraced": dict(untraced),
                "rays": int(raw["nerf"]["train"]["num_random_rays"]),
                "n_coarse": int(raw["nerf"]["train"]["num_coarse"]),
                "n_fine": int(raw["nerf"]["train"]["num_fine"])}
    if exp.planes_model:
        member = init["decoders"]["dc"]["members"][0]
        ctx.work["decoder_dims"] = [tuple(p["w"].shape) for _, p in
                                    _member_layers(member)]
        if exp.sr_opt is not None:
            sc = exp.sr_cfg
            ctx.work["edsr"] = (sc.in_channels, sc.hidden_size, sc.n_blocks,
                                sc.scale_factor,
                                exp.planes_buffer.resident[
                                    sorted(exp.planes_buffer.resident)[0]]
                                .planes_pos.shape[-1])
    else:
        ctx.work["mlp_cfg"] = exp.mlp_cfg

    program = {"losses": losses, "first_grad": sorted(first_grad.items()),
               "after": after}
    # every kind of the training scenes
    kinds = {draws.kind(sc) for sc in draws.mix}
    steps, fits = draws.steps, draws.fits
    draws.close()
    del exp, draws
    if cuda:
        torch.cuda.empty_cache()
    try:
        check(ctx, raw, scenes, steps, init, program, fits, kinds,
              control=bool(ctx.overrides.get("control")))
    finally:
        tmp.cleanup()


def _member_layers(member):
    return [(k, p) for k in ("density", "fc_alpha", "rgb", "fc_rgb")
            for p in (member[k] if isinstance(member[k], list)
                      else [member[k]])]


def _lr_image(rgb, ds):
    """A view's pixels as the loader makes them: [0, 1] floats, the mean
    of each ds x ds block."""
    img = rgb.astype(np.float32) / 255.0
    h, w, c = img.shape
    return img.reshape(h // ds, ds, w // ds, ds, c).mean(axis=(1, 3))


def batches(raw, scenes, steps, ctx, boxes=None):
    """The reference's batches of the checked iterations, made from the
    benchmark's own views and draws. A draw that does not fit the scene
    (an index out of range, a patch that is not whole) gives None."""
    import torch
    from gpubench.reference import render
    dev = ctx.device
    train_ds = max(int(k.split(",")[0]) for k in raw["dataset"]["dir"]
                   ["train"])
    angle = ctx.param("camera_angle_x")
    out = []
    for st in steps:
        sc = st["scene"]
        ds, name = _ds(sc), _name(sc)
        c2w, rgb = scenes[name]["train"][st["view"]]
        rows, cols = st["rows"], st["cols"]
        if st["kind"] == "consistency":
            # an HR view's ds x ds patches against its LR couple's pixels
            lr = _lr_image(rgb, train_ds)
            patch = train_ds // ds
            hr = lr.shape[0] * patch
            if rows.max() >= hr or cols.max() >= hr:
                return None
            pr, pc = rows.reshape(-1, patch * patch), cols.reshape(
                -1, patch * patch)
            if not ((pr // patch == pr[:, :1] // patch).all()
                    and (pc // patch == pc[:, :1] // patch).all()):
                return None
            target = lr[pr[:, 0] // patch, pc[:, 0] // patch]
            h = hr
        else:
            img = _lr_image(rgb, ds)
            patch, h = 0, img.shape[0]
            if rows.max() >= h or cols.max() >= h:
                return None
            target = img[rows, cols]
        focal = 0.5 / np.tan(0.5 * angle) * h
        o, d = render.rays_at(torch.as_tensor(rows, device=dev),
                              torch.as_tensor(cols, device=dev), h, h,
                              focal, torch.as_tensor(c2w, device=dev),
                              (ds - 1) / (2 * ds))
        b = {"origins": o, "directions": d,
             "target": torch.as_tensor(target, device=dev)}
        if boxes is None:
            w = float(raw["nerf"]["train"].get("im_inconsistency_loss_w",
                                               1)) if patch else 1.0
            b.update(radius=ds * 0.00135 * 2.0 / np.sqrt(12.0), patch=patch,
                     weight=w)
        else:
            lr_sc = _lr_scene(raw, sc)
            b.update(scene=lr_sc, box=boxes[lr_sc], sr=lr_sc != sc)
        out.append(b)
    return out


def _lr_scene(raw, scene):
    """The LR scene whose planes an HR scene super-resolves: the scene's
    name in the group of the largest downsampling."""
    key = max(raw["dataset"]["dir"]["train"], key=lambda k: int(
        k.split(",")[0]))
    ds, res, vres = key.split(",")[:3]
    return f"{_name(scene)}_DS{ds}_PlRes{res}_{vres}"


def _boxes(raw, scenes, ctx, steps):
    """Each checked LR scene's box, worked out from the benchmark's views
    of it at its downsampling: as the code base's Blender loader reads a
    training scene, every train view and every testskip-th val view."""
    import torch
    sc_cfg = raw["dataset"]["synt"]
    out = {}
    for st in steps:
        lr_sc = _lr_scene(raw, st["scene"])
        if lr_sc in out:
            continue
        split = scenes[_name(lr_sc)]
        views = split["train"] + split["val"][::int(raw["dataset"].get(
            "testskip", 1))]
        h = views[0][1].shape[0] // _ds(lr_sc)
        focal = 0.5 / np.tan(0.5 * ctx.param("camera_angle_x")) * h
        from gpubench.reference import triplane
        out[lr_sc] = torch.as_tensor(triplane.scene_box(
            [c2w for c2w, _ in views], h, h, focal, float(sc_cfg["near"]),
            float(sc_cfg["far"])), device=ctx.device)
    return out


def reference_cfg(raw):
    t = raw["nerf"]["train"]
    sc = raw["dataset"]["synt"]
    out = {"near": float(sc["near"]), "far": float(sc["far"]),
           "n_coarse": int(t["num_coarse"]), "n_fine": int(t["num_fine"]),
           "noise_std": float(t["radiance_field_noise_std"]),
           "lr": float(raw["optimizer"]["lr"])}
    m = raw["models"]["coarse"]
    if "num_encoding_fn_xyz" in m:
        out.update(ipe_degrees=int(m["num_encoding_fn_xyz"]),
                   dir_freqs=int(m["num_encoding_fn_dir"]),
                   skip=int(m["skip_connect_every"]))
    else:
        groups = sorted(int(k.split(",")[0]) for k in raw["dataset"]["dir"]
                        ["train"])
        out.update(skip=int(m["skip_connect_every"]),
                   scale=groups[-1] // groups[0],
                   planes_lr=float(raw["optimizer"].get("planes_lr",
                                                        out["lr"])),
                   sr_lr=float(raw["super_resolution"].get("lr",
                                                           out["lr"])))
    return out


def _norm_gaps(mine, ref, keep=None):
    """(worst |‖mine‖ - ‖ref‖| over leaves, each against the larger of
    its reference norm and the median leaf's; that leaf's path)."""
    rn = {p: float(t.norm()) for p, t in ref}
    med = float(np.median(list(rn.values())))
    worst, leaf = 0.0, None
    for p, t in mine:
        if keep is not None and p not in keep:
            continue
        gap = abs(float(t.norm()) - rn[p]) / max(rn[p], med)
        if leaf is None or gap > worst:
            worst, leaf = gap, p
    return worst, leaf


def follow(ctx, raw, b, init, tf32=False):
    """The reference from `init` over batches b -> (losses, first
    gradients [(path, g)], leaves after [(path, t)]), TF32 on for the
    control."""
    import copy

    import torch
    from gpubench.reference import nerf, triplane
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        gen = torch.Generator(device=ctx.device).manual_seed(ctx.seed)
        state = copy.deepcopy(init)
        if "planes" not in state:
            losses, first, params = nerf.train(state["decoders"], b,
                                               reference_cfg(raw), gen)
            return losses, first, nerf.leaves(params)
        st = {"dc": state["decoders"]["dc"], "df": state["decoders"]["df"],
              "sr": state["sr"], "planes": state["planes"]}
        losses, first, st = triplane.train(st, b, reference_cfg(raw), gen)
        return losses, first, _state_leaves(st)
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = prev


def _state_leaves(st):
    from gpubench.reference import nerf
    return (nerf.leaves({"dc": st["dc"], "df": st["df"]})
            + nerf.leaves({"sr": st["sr"]})
            + nerf.leaves({"planes": st["planes"]}))


def _init_leaves(init):
    from gpubench.reference import nerf
    if "planes" not in init:
        return nerf.leaves(init["decoders"])
    return _state_leaves({"dc": init["decoders"]["dc"],
                          "df": init["decoders"]["df"], "sr": init["sr"],
                          "planes": init["planes"]})


def check(ctx, raw, scenes, steps, init, program, fits, kinds,
          control=False):
    """ctx.checks: the program's checked iterations ({"losses",
    "first_grad" [(path, g)], "after" [(path, t)]}) against the
    reference; with control, the reference in TF32 in the program's
    place."""
    import torch
    lim = ctx.limits
    # every kind of the mix among the checked iterations
    missing = kinds - {st["kind"] for st in steps}
    planes = "planes" in init
    boxes = _boxes(raw, scenes, ctx, steps) if planes else None
    b = batches(raw, scenes, steps, ctx, boxes) if fits else None
    if b is None or missing:
        ctx.checks.update(draws_fit=(1.0, 0.0))
        return
    losses, first, after = follow(ctx, raw, b, init)
    if control:
        c_losses, c_first, c_after = follow(ctx, raw, b, init, tf32=True)
        program = {"losses": c_losses, "first_grad": c_first,
                   "after": c_after}
    # a group that never stepped has no Adam state: a zero gradient
    mine_first = dict(program["first_grad"])
    program["first_grad"] = [(p, mine_first.get(p, torch.zeros_like(g)))
                             for p, g in first]
    gref = {p: float(g.norm()) for p, g in first}
    med = float(np.median(list(gref.values())))
    # leaves whose reference gradient is nought to rounding move under
    # Adam by round-off alone: left out of the change
    keep = {p for p, v in gref.items() if v >= 1e-3 * med}
    p0 = dict(_init_leaves(init))
    ref_delta = [(p, t - p0[p]) for p, t in after]
    mine_delta = [(p, t - p0[p]) for p, t in program["after"]]
    gaps = [abs(a - r) / abs(r) for a, r in zip(program["losses"], losses)]
    loss_rel = max(gaps)
    grad_gap, grad_leaf = _norm_gaps(program["first_grad"], first)
    update_gap, update_leaf = _norm_gaps(mine_delta, ref_delta, keep)
    ctx.record["worst_leaves"] = {"grad_norm_gap": grad_leaf,
                                  "update_norm_gap": update_leaf,
                                  "loss_gaps": gaps}
    ctx.checks.update(
        loss_rel=(loss_rel, lim.get("loss_rel", 0.0)),
        grad_norm_gap=(grad_gap, lim.get("grad_norm_gap", 0.0)),
        update_norm_gap=(update_gap, lim.get("update_norm_gap", 0.0)))
