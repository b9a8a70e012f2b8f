"""The port's stage 3 (RefineOnTestScene) against the benchmark's plain
reference (gpubench/reference/refine.py), on the CPU at a mini size.

The benchmark's refine driver (gpubench/drivers/train_refine.py) writes
a stage-1 logdir (decoders and EDSR from the seed, through the port's
Experiment.save_checkpoints) and a stage-2 planes file (PlaneStore.save),
then the port's Experiment of the stage-3 config loads them and trains
one round of its mix: four LR iterations of the scene at ds 8 and one
consistency iteration on its ds 2 couple (4 LR pixels x 4x4 HR patches
through the plane SR). The reference follows the same round from the
tensors set-up wrote, so a load that lost or reordered anything fails
here too. Mini sizes: 16 plane channels at 16^2 (4 x 4 views at ds 8),
an EDSR of 2 blocks 16 wide (x4 to 64^2), decoders 16 wide, 64 rays.

Bounds (each program number against the reference's; both f32 on the
CPU, so what differs is the order of the operations; 4 seeds read):

* losses: relative 1e-5; sound runs read at most 4.6e-7 over the five
  iterations (rounding carried through the Adam steps), the patch's
  first ray in place of its mean reads 1e-3 on the consistency
  iteration;
* first moments (each Adam's after its first step): every element
  within 2e-3 of its leaf's largest reference element; sound runs read
  at most 1.4e-4 (a density leaf, whose gradient sums terms that
  cancel), the planted faults 1.0 and more;
* updates (parameters after the round less before): every element
  within 3e-3 of its leaf's largest reference update; sound runs read
  at most 2.4e-4 (Adam's first steps are near lr x the gradient's sign,
  so an element whose gradient is near eps moves on rounding), the
  planted faults 1.0 and more.
"""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from gpubench import harness  # noqa: E402
from gpubench.drivers import train, train_refine  # noqa: E402
from gpubench.faults import _patched  # noqa: E402

CELL = "refineontestscene.train_refine"
SEED = 11
MINI = {"image": 64, "views": {"train": 3, "val": 2, "test": 1},
        "warmup_iters": 0, "trace_skip": 0, "trace_iters": 0,
        "config": {"dataset.dir.train": {"8,16,4": ["lego##1"]},
                   "dataset.dir.val": {"2,64,4": ["lego##1"]},
                   "super_resolution.model.hidden_size": 16,
                   "super_resolution.model.n_blocks": 2,
                   "nerf.train.num_random_rays": 64,
                   "nerf.train.num_coarse": 8, "nerf.train.num_fine": 8},
        "pretrained_config": {"models.coarse.dec_channels": 16,
                              "models.coarse.num_plane_channels": 16,
                              "super_resolution.model.hidden_size": 16,
                              "super_resolution.model.n_blocks": 2}}
LOSS_RTOL, GRAD_BOUND, UPDATE_BOUND = 1e-5, 2e-3, 3e-3


def _run(fault=None):
    """One round of the mini stage 3 -> (the program's checked numbers,
    the reference's (losses, first gradients, leaves after), the
    iterations' kinds, the weights set-up wrote)."""
    got = {}

    def capture(real):
        def check(ctx, raw, stage1, scenes, steps, init, program, fits,
                  kinds, control=False):
            assert fits and kinds == {st["kind"] for st in steps}
            b = train_refine.batches(raw, scenes, steps, ctx, init["box"])
            got.update(ref=train_refine.follow(
                ctx, train_refine.reference_cfg(raw, stage1), b, init),
                program=program, kinds=[st["kind"] for st in steps],
                init=init)
        return check

    overrides = dict(MINI, **({"fault": fault} if fault else {}))
    ctx = harness.Context(CELL, SEED, 0.0, 0, torch.device("cpu"),
                          overrides=overrides)
    with _patched(train_refine, "check", capture):
        train_refine.run(ctx)
    return got


def _worst(mine, ref):
    """max over leaves of max |mine - ref| / max |ref| (a leaf the program
    never stepped counts as zeros)."""
    mine = dict(mine)
    return max(float((mine.get(p, torch.zeros_like(r)) - r).abs().max()
                     / r.abs().max().clamp_min(1e-30)) for p, r in ref)


def _deltas(after, init):
    p0 = dict(train._init_leaves(init))
    return [(p, t - p0[p]) for p, t in after]


def _gaps(got):
    losses, first, after = got["ref"]
    prog = got["program"]
    loss = max(abs(a - r) / abs(r) for a, r in zip(prog["losses"], losses))
    grad = _worst(prog["first_grad"], first)
    update = _worst(_deltas(prog["after"], got["init"]),
                    _deltas(after, got["init"]))
    return loss, grad, update


@pytest.fixture(scope="module")
def sound():
    return _run()


def test_the_round_holds_lr_and_consistency_iterations(sound):
    assert sorted(sound["kinds"]) == ["consistency"] + ["lr"] * 4
    # the SR net's Adam stepped once, on the consistency iteration
    firsts = dict(sound["program"]["first_grad"])
    assert any(p.startswith("/sr/") for p in firsts)


def test_losses_of_lr_and_consistency_iterations(sound):
    losses, _, _ = sound["ref"]
    assert len(sound["program"]["losses"]) == len(losses) == 5
    torch.testing.assert_close(torch.tensor(sound["program"]["losses"]),
                               torch.tensor(losses), rtol=LOSS_RTOL, atol=0)


def test_every_leafs_first_moment(sound):
    _, first, _ = sound["ref"]
    mine = dict(sound["program"]["first_grad"])
    assert set(mine) == {p for p, _ in first}
    assert _worst(mine.items(), first) <= GRAD_BOUND


def test_every_leafs_update(sound):
    _, _, after = sound["ref"]
    assert _worst(_deltas(sound["program"]["after"], sound["init"]),
                  _deltas(after, sound["init"])) <= UPDATE_BOUND


@pytest.mark.parametrize("fault", ["consistency_first_ray",
                                   "sr_step_skipped"])
def test_a_planted_fault_fails(fault):
    """The patch's first ray in place of its mean, and the SR net's step
    skipped on the consistency iteration, each land outside the bounds."""
    loss, grad, update = _gaps(_run(fault))
    assert loss > LOSS_RTOL or grad > GRAD_BOUND or update > UPDATE_BOUND
    assert grad > GRAD_BOUND and update > UPDATE_BOUND


def test_spans_of_a_refine_run(tmp_path):
    """Under a profiler, a stage-3 Experiment built on the files set-up
    writes and run for 12 iterations records `load_pretrained` for the
    checkpoints (the SR net's and the decoders') and for the planes file,
    and one `consistency_loss` span (patches: the 4 LR pixels of 64
    rays, ds 4) inside each consistency iteration's `forward`."""
    from nvsr_tpu_torch.experiment import Experiment
    from nvsr_tpu_torch.utils import tracing
    from nvsr_tpu_torch.utils.config import CfgNode

    ctx = harness.Context(CELL, SEED, 0.0, 0, torch.device("cpu"),
                          overrides=MINI)
    root = str(tmp_path)
    scenes = train_refine._scenes(ctx, root)
    raw = harness.experiment_config(ctx.config)
    raw["dataset"]["synt"]["root"] = "synt"
    train_refine.loop.edited(raw, MINI["config"], {
        "experiment.validate_every": 1000, "experiment.save_every": 1000})
    train_refine.write_pretrained(ctx, root, raw, train_refine
                                  .pretrained_config(ctx, raw), scenes)
    tracing.clear()
    with torch.profiler.profile():
        Experiment(CfgNode(raw), root_path=root, device="cpu").run(
            max_iters=12)
    recs = tracing.records()
    loads = [r["args"] for r in recs if r["name"] == "load_pretrained"]
    assert [x["files"] for x in loads] == [2, 1]
    assert all(x["bytes"] > 0 for x in loads)
    by_index = {r["index"]: r for r in recs}
    kinds = {r["index"]: r["args"]["kind"] for r in recs
             if r["name"] == "train_iteration"}
    losses = [r for r in recs if r["name"] == "consistency_loss"]
    owners = [by_index[r["parent"]]["parent"] for r in losses]
    assert all(by_index[r["parent"]]["name"] == "forward" for r in losses)
    assert sorted(owners) == sorted(i for i, k in kinds.items()
                                    if k == "consistency")
    assert len(owners) == len(set(owners)) > 0
    assert all(r["args"] == {"patches": 4, "ds": 4} for r in losses)
    tracing.clear()
