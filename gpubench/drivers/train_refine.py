"""Stage 3 (RefineOnTestScene) through the Experiment, from the files a
user's run starts from.

Set-up writes the config's scene from the seed (drivers/train.py), then
what stage 3 loads, with the port's own writers: a stage-1 logdir at
`models.path` (an Experiment of the traffic's `pretrained` config on the
scene's LR and HR groups, holding the benchmark's decoders and EDSR drawn
from the seed as train.py draws them, written by `save_checkpoints`) and
a stage-2 planes directory at `models.planes_path` (the scene's LR
planes, drawn alike, with the code base's box of the LR scene, written
by `PlaneStore.save`). The Experiment of the cell's config then loads
them on the device as a user's run does, and trains in drivers/loop.py's
closed loop on the benchmark's draws: LR iterations and consistency
iterations (whole 4 x 4 patches of the HR view through the plane SR,
each patch's mean against its LR pixel). A consistency iteration does an
HR iteration's work, and is counted as one ("sr") in the run's work.

After the window the plain reference (reference/refine.py) follows the
checked iterations from the tensors set-up wrote, so the loads are
checked too.
"""

from __future__ import annotations

import copy
import os
import re
import tempfile

import numpy as np

from gpubench import cell_faults, harness, inputs
from gpubench.drivers import loop, train


def _scenes(ctx, root):
    """Write every scene the config names -> {scene: {split: views}}: a
    scene `name##k` reads the folder `name`."""
    cfg = ctx.config
    names = sorted({s for split in cfg["dataset"]["dir"].values()
                    for group in split.values() for s in group})
    return {name: inputs.synthetic_scene(
        os.path.join(root, "synt"), _folder(name), ctx.param("image"),
        ctx.param("views"), ctx.param("camera_angle_x"), [ctx.seed, k])
        for k, name in enumerate(names)}


def _folder(name):
    return re.sub(r"##.*", "", name)


def _groups(raw):
    """(the LR group's key, the HR group's key, the scene)."""
    dirs = raw["dataset"]["dir"]
    (lr_key, (scene,)), = dirs["train"].items()
    (hr_key, _), = dirs["val"].items()
    return lr_key, hr_key, scene


def pretrained_config(ctx, raw):
    """The stage-1 config whose Experiment writes the logdir: the traffic's
    `pretrained` configuration trained on the scene's folder in the
    cell's two groups, its logdir at the cell's models.path."""
    entry = harness.config_entry(ctx.spec, ctx.param("pretrained"))
    out = harness.experiment_config(harness.load_json(
        harness.ROOT / entry["file"]))
    lr_key, hr_key, scene = _groups(raw)
    out["dataset"]["synt"]["root"] = "synt"
    out["dataset"]["dir"] = {"train": {lr_key: [_folder(scene)],
                                       hr_key: [_folder(scene)]},
                             "val": {}}
    out["experiment"]["logdir"] = raw["models"]["path"]
    out["experiment"]["randomseed"] = ctx.seed
    return loop.edited(out, ctx.param("pretrained_config") or {})


def write_pretrained(ctx, root, raw, stage1, scenes):
    """Write the stage-1 logdir and the stage-2 planes directory ->
    the weights written ({"decoders", "sr", "planes"} and the planes'
    "box", on ctx.device)."""
    from nvsr_tpu_torch import experiment
    from nvsr_tpu_torch.planes_store import PlaneStore, ScenePlanes
    from nvsr_tpu_torch.utils.config import CfgNode
    writer = experiment.Experiment(CfgNode(stage1), root_path=root,
                                   device="cpu")
    writer.planes_buffer.draw_scenes()
    init = train._weights(ctx, writer)
    (_, planes), = init.pop("planes").items()
    train._hand_over(writer, init)
    writer.save_checkpoints(0, as_best=True)
    del writer
    saved = train._lr_scene(raw, _groups(raw)[2])
    box = train._boxes(raw, scenes, ctx, [{"scene": saved}])[saved]
    store = PlaneStore([os.path.join(root, raw["models"]["planes_path"],
                                     "planes")])
    os.makedirs(store.save_locations[0], exist_ok=True)
    store.save(saved, ScenePlanes(planes["pos"].cpu(), planes["view"].cpu(),
                                  box.cpu().numpy()))
    init["planes"] = {saved: planes}
    init["box"] = {saved: box}
    return init


def reference_cfg(raw, stage1):
    lr_key, hr_key, _ = _groups(raw)
    t, sc = raw["nerf"]["train"], raw["dataset"]["synt"]
    lr = float(raw["optimizer"]["lr"])
    return {"near": float(sc["near"]), "far": float(sc["far"]),
            "n_coarse": int(t["num_coarse"]), "n_fine": int(t["num_fine"]),
            "noise_std": float(t["radiance_field_noise_std"]), "lr": lr,
            "skip": int(stage1["models"]["coarse"]["skip_connect_every"]),
            "scale": int(lr_key.split(",")[0]) // int(hr_key.split(",")[0]),
            "planes_lr": float(raw["optimizer"].get("planes_lr", lr)),
            "sr_lr": float(raw["super_resolution"].get("lr", lr))}


def run(ctx):
    import torch
    from nvsr_tpu_torch import experiment
    from nvsr_tpu_torch.utils.config import CfgNode
    dev = ctx.device
    ctx.note("imports")
    with tempfile.TemporaryDirectory() as root:
        scenes = _scenes(ctx, root)
        ctx.note("scenes written")
        raw = harness.experiment_config(ctx.config)
        raw["dataset"]["synt"]["root"] = "synt"
        raw["experiment"]["randomseed"] = ctx.seed
        loop.edited(raw, ctx.overrides.get("config", {}))
        stage1 = pretrained_config(ctx, raw)
        init = write_pretrained(ctx, root, raw, stage1, scenes)
        ctx.note("stage-1 logdir and stage-2 planes written")
        with cell_faults.planted(ctx.overrides.get("fault")):
            exp = experiment.Experiment(CfgNode(raw), root_path=root,
                                        device=dev)
            exp.planes_buffer.draw_scenes()
            exp._update_active_scenes()
            draws = train.Draws(ctx, exp, experiment, scenes)
            ctx.note("Experiment built")
            program = loop.drive(
                ctx, exp, draws, raw, dev,
                work_kind=lambda k: "sr" if k == "consistency" else k)
            ctx.work["edsr"] = _edsr(exp)
            ctx.work["decoder_dims"] = [
                tuple(p["w"].shape) for _, p in train._member_layers(
                    init["decoders"]["dc"]["members"][0])]
            steps, fits = draws.steps, draws.fits
            kinds = {draws.kind(sc) for sc in draws.mix}
            draws.close()
            del exp, draws
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        check(ctx, raw, stage1, scenes, steps, init, program, fits, kinds,
              control=bool(ctx.overrides.get("control")))


def _edsr(exp):
    sc = exp.sr_cfg
    res = exp.planes_buffer.resident[sorted(exp.planes_buffer.resident)[0]]
    return (sc.in_channels, sc.hidden_size, sc.n_blocks, sc.scale_factor,
            res.planes_pos.shape[-1])


def batches(raw, scenes, steps, ctx, boxes):
    """train.batches' batches of the checked iterations with each one's
    `patch` (the HR patch side of a consistency iteration, else 0) and
    loss `weight`, or None where a draw does not fit."""
    out = train.batches(raw, scenes, steps, ctx, boxes)
    if out is None:
        return None
    lr_ds = int(_groups(raw)[0].split(",")[0])
    w = float(raw["nerf"]["train"].get("im_inconsistency_loss_w", 1))
    for b, st in zip(out, steps):
        cons = st["kind"] == "consistency"
        b.update(patch=lr_ds // train._ds(st["scene"]) if cons else 0,
                 weight=w if cons else 1.0)
    return out


def follow(ctx, cfg, b, init, tf32=False):
    """reference/refine.py from `init` over batches b -> (losses, first
    gradients, leaves after); TF32 on for the control."""
    import torch
    from gpubench.reference import refine
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        gen = torch.Generator(device=ctx.device).manual_seed(ctx.seed)
        st = copy.deepcopy({"dc": init["decoders"]["dc"],
                            "df": init["decoders"]["df"], "sr": init["sr"],
                            "planes": init["planes"]})
        losses, first, st = refine.train(st, b, cfg, gen)
        return losses, first, train._state_leaves(st)
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = prev


def check(ctx, raw, stage1, scenes, steps, init, program, fits, kinds,
          control=False):
    """ctx.checks of the program's checked iterations against the
    reference, as train.check (with control, the reference in TF32 in
    the program's place)."""
    import torch
    lim = ctx.limits
    missing = kinds - {st["kind"] for st in steps}
    b = batches(raw, scenes, steps, ctx, init["box"]) if fits else None
    if b is None or missing:
        ctx.checks.update(draws_fit=(1.0, 0.0))
        return
    cfg = reference_cfg(raw, stage1)
    losses, first, after = follow(ctx, cfg, b, init)
    if control:
        program = dict(zip(("losses", "first_grad", "after"),
                           follow(ctx, cfg, b, init, tf32=True)))
    mine_first = dict(program["first_grad"])
    program["first_grad"] = [(p, mine_first.get(p, torch.zeros_like(g)))
                             for p, g in first]
    gref = {p: float(g.norm()) for p, g in first}
    med = float(np.median(list(gref.values())))
    keep = {p for p, v in gref.items() if v >= 1e-3 * med}
    p0 = dict(train._init_leaves(init))
    ref_delta = [(p, t - p0[p]) for p, t in after]
    mine_delta = [(p, t - p0[p]) for p, t in program["after"]]
    gaps = [abs(a - r) / abs(r) for a, r in zip(program["losses"], losses)]
    grad_gap, grad_leaf = train._norm_gaps(program["first_grad"], first)
    update_gap, update_leaf = train._norm_gaps(mine_delta, ref_delta, keep)
    ctx.record["worst_leaves"] = {"grad_norm_gap": grad_leaf,
                                  "update_norm_gap": update_leaf,
                                  "loss_gaps": gaps}
    ctx.checks.update(
        loss_rel=(max(gaps), lim.get("loss_rel", 0.0)),
        grad_norm_gap=(grad_gap, lim.get("grad_norm_gap", 0.0)),
        update_norm_gap=(update_gap, lim.get("update_norm_gap", 0.0)))
