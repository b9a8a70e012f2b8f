"""The Experiment's training half in the port: the scenarios of
tests/test_experiment.py (stages 1 -> 2 -> 3, resume, module confinement,
separate_decoder_sr, plane coverage) and the loop's preemption and
early stop, run by nvsr_tpu_torch.experiment on the same synthetic
corpus, plus what the port's eval caches must do once
training moves the models: an evaluate after training steps renders the
trained decoders, planes and SR net, and one after an occupancy commit
tightens its rays to the new box.

Everything here runs the port alone, on the CPU; the comparisons with
the JAX package's Experiment are in tests/test_torch_experiment_interop
.py. Tolerance: a render of a reloaded logdir against the render of the
run that saved it, the same f32 function of the same bits: atol 1e-6
(measured equal).
"""

import os

import numpy as np
import pytest
import torch

from helpers_synth import write_blender_scene
from nvsr_tpu_torch import experiment as texp
from nvsr_tpu_torch.experiment import Experiment, find_latest_checkpoint
from nvsr_tpu_torch.scenes import get_plane_name
from nvsr_tpu_torch.utils.io import PreemptedError
from test_experiment import _mini_cfg

CPU = "cpu"
STAGE1 = {"4,8,8": ["lego", "ship"], "2,16,8": ["lego", "ship"]}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_corpus")
    for name in ("lego", "ship", "chair"):
        write_blender_scene(str(root / "synt"), name, size=32)
    return root


@pytest.fixture(scope="module")
def stage1(corpus):
    """Mini TrainModels in the port: LR and HR scenes, decoders, SR and
    planes trained jointly from scratch."""
    exp = Experiment(_mini_cfg(corpus, logdir="logs/stage1",
                               train_groups=STAGE1, iters=6),
                     root_path=str(corpus), device=CPU)
    exp.run()
    return exp


def test_stage1_trains_and_checkpoints(stage1, corpus):
    logdir = os.path.join(str(corpus), "logs/stage1")
    assert find_latest_checkpoint(logdir, sr=False).endswith(
        "checkpoint00005.ckpt")
    assert find_latest_checkpoint(logdir, sr=True).endswith(
        "SR_checkpoint00005.ckpt")
    for name in ("checkpoint.ckpt_best", "SR_checkpoint.ckpt_best",
                 "exp_info.pkl", "time_sig.txt", "config.yml"):
        assert os.path.isfile(os.path.join(logdir, name)), name
    planes = sorted(os.listdir(os.path.join(logdir, "planes")))
    assert planes == ["coarse_lego_DS4_PlRes8_8.planes",
                      "coarse_lego_DS4_PlRes8_8.planes_best",
                      "coarse_ship_DS4_PlRes8_8.planes",
                      "coarse_ship_DS4_PlRes8_8.planes_best"]
    # the HR scenes train the LR scenes' planes
    assert stage1.scene_coupler.scene2saved["lego_DS2_PlRes16_8"] == \
        "lego_DS4_PlRes8_8"
    assert stage1.scene_coupler.ds_factor == 2
    assert stage1.experiment_info["start_i"] == 6
    # the flushed training losses reached the running scores
    losses = list(stage1.running.scores["loss"]["train"])
    assert losses and np.all(np.isfinite(losses))
    assert stage1._pending_metrics == []


def test_stage2_planes_only_frozen_decoder(stage1, corpus):
    """Mini Feature_Planes_Only: new scene planes; the decoders and SR
    net inherited and frozen, bit for bit."""
    cfg = _mini_cfg(corpus, logdir="logs/stage2",
                    train_groups={"4,8,8": ["chair"]},
                    val_groups={"2,16,8": ["chair"]},
                    what=("LR_planes",), sr=False, pretrained="logs/stage1",
                    iters=5)
    exp = Experiment(cfg, root_path=str(corpus), device=CPU)
    assert exp.decoder_opt is None and exp.sr_opt is None
    assert exp.sr_experiment
    before = [x.clone() for x in (
        exp.decoder_coarse["members"][0]["fc_alpha"]["w"],
        exp.decoder_fine["members"][0]["rgb"][0]["w"],
        exp.sr_params["inner"]["conv_input"]["w"])]
    exp.run()
    after = (exp.decoder_coarse["members"][0]["fc_alpha"]["w"],
             exp.decoder_fine["members"][0]["rgb"][0]["w"],
             exp.sr_params["inner"]["conv_input"]["w"])
    for a, b in zip(before, after):
        torch.testing.assert_close(b, a, rtol=0, atol=0)
    assert exp.store.exists("chair_DS4_PlRes8_8")
    assert exp._models_to_save() == []
    assert not any(".ckpt" in f for f in os.listdir(exp.logdir)
                   if f != "exp_info.pkl")


def test_stage3_refine_with_consistency(stage1, corpus, monkeypatch):
    """Mini RefineOnTestScene: the val-only HR scene joins training for
    consistency iterations, which run and are logged as
    train/im_inconsistency; the best checkpoint follows that loss."""
    cfg = _mini_cfg(corpus, logdir="logs/stage3",
                    train_groups={"4,8,8": ["ship"]},
                    val_groups={"2,16,8": ["ship"]},
                    pretrained="logs/stage1", planes_path="logs/stage1",
                    im_inconsistency=1.0, iters=8)
    exp = Experiment(cfg, root_path=str(corpus), device=CPU)
    assert "ship_DS2_PlRes16_8" in exp.i_train
    assert exp.loss4best == "im_inconsistency"
    names = []
    real = exp.logger.write_scalar
    monkeypatch.setattr(exp.logger, "write_scalar",
                        lambda n, v, i: names.append(n) or real(n, v, i))
    exp.run()
    assert "train/im_inconsistency" in names and "train/loss_lr" in names


def test_resume_continues_iteration(stage1, corpus):
    cfg = _mini_cfg(corpus, logdir="logs/stage1", train_groups=STAGE1,
                    iters=8)
    exp = Experiment(cfg, load_checkpoint="resume", root_path=str(corpus),
                     device=CPU)
    assert exp.experiment_info["start_i"] == 6
    # the optimizers continue from the saved state
    assert int(exp.decoder_opt.state[0].count) > 0
    assert int(exp.sr_opt.state[0].count) > 0


def test_module_confinement_blocks_decoder(corpus):
    """A scene confined to 'decoder' never steps the decoder; its planes
    still train."""
    cfg = _mini_cfg(corpus, logdir="logs/confined",
                    train_groups={"4,8,8,'synt',1,['decoder']": ["lego"]},
                    sr=False, what=("LR_planes", "decoder"), iters=4)
    exp = Experiment(cfg, root_path=str(corpus), device=CPU)
    before = exp.decoder_opt.params["dc"]["members"][0]["fc_alpha"][
        "w"].clone()
    exp.planes_buffer.draw_scenes()
    planes_before = exp.planes_buffer.get(
        "lego_DS4_PlRes8_8").planes_pos.clone()
    exp.run()
    torch.testing.assert_close(
        exp.decoder_opt.params["dc"]["members"][0]["fc_alpha"]["w"], before,
        rtol=0, atol=0)
    assert not torch.equal(
        exp.planes_buffer.get("lego_DS4_PlRes8_8").planes_pos,
        planes_before)


def test_separate_decoder_sr_gating(corpus, monkeypatch):
    """separate_decoder_sr: the decoders step on LR iterations only, the
    SR net on HR (SR) iterations only."""
    cfg = _mini_cfg(corpus, logdir="logs/sepdec",
                    train_groups={"4,8,8": ["lego"], "2,16,8": ["lego"]},
                    iters=10)
    cfg.nerf.train["separate_decoder_sr"] = True
    exp = Experiment(cfg, root_path=str(corpus), device=CPU)
    steps, kinds = [], []
    for name in ("decoder_opt", "sr_opt"):
        opt = getattr(exp, name)
        real = opt.step
        monkeypatch.setattr(opt, "step", lambda name=name, real=real: (
            steps.append((name, kinds[-1])), real()))
    # the kind of each iteration, from the image sampler's draw
    real_sample = exp.image_sampler.sample

    def sample():
        sid, idx = real_sample()
        kinds.append(sid in exp.scene_coupler.downsample_couples)
        return sid, idx

    monkeypatch.setattr(exp.image_sampler, "sample", sample)
    exp.run()
    assert exp.scene_coupler.ds_factor == 2
    assert set(kinds) == {True, False}
    assert steps and all((name == "decoder_opt") != sr
                         for name, sr in steps)


def test_plane_coverage_and_jump_start(corpus):
    """models.coarse.plane_stats writes coverage PNGs per plane during an
    evaluate; jump_start pins the buffer and restores its cadence."""
    cfg = _mini_cfg(corpus, logdir="logs/coverage",
                    train_groups={"4,8,8": ["lego", "ship"]}, sr=False,
                    what=("LR_planes", "decoder"), iters=2)
    cfg.models.coarse["plane_stats"] = True
    exp = Experiment(cfg, root_path=str(corpus), device=CPU)
    exp.planes_buffer.draw_scenes()
    exp.image_sampler.update_active(exp.planes_buffer.cur_scenes)
    exp.evaluate(0)
    cov = os.listdir(os.path.join(exp.logdir, "coverage"))
    assert sorted(f for f in cov if f.startswith("plane_coverage_")) == [
        f"plane_coverage_{get_plane_name(s + '_DS4_PlRes8_8', d)}.png"
        for s in ("lego", "ship") for d in range(3)]
    counts = exp._plane_coverage.counts
    assert sum(int(c.sum()) for c in counts.values()) > 0
    assert exp.planes_buffer.jump_start((1,), on=True) == 1
    assert exp.planes_buffer.steps_per_buffer == -1
    assert sorted(exp.planes_buffer.jump_start(on=False)) == sorted(
        exp.training_scenes)


def test_evaluate_after_training_renders_the_trained_models(corpus,
                                                            monkeypatch):
    """The eval point fns are built per evaluate from the optimizers'
    tensors: an evaluate after training steps renders the trained
    decoders, planes and SR net, the same image as an eval-mode
    Experiment that loads what the run saved."""
    cfg = _mini_cfg(corpus, logdir="logs/evalafter",
                    train_groups={"4,8,8": ["lego"], "2,16,8": ["lego"]},
                    val_groups={}, iters=1000)
    exp = Experiment(cfg, root_path=str(corpus), device=CPU)
    renders = []
    real = texp.render_image
    monkeypatch.setattr(texp, "render_image", lambda *a, **kw: (
        renders.append(real(*a, **kw)) or renders[-1]))
    exp.planes_buffer.draw_scenes()
    exp.image_sampler.update_active(exp.planes_buffer.cur_scenes)
    exp.evaluate(0)
    first = [r.fine.rgb.clone() for r in renders]
    for i in range(6):
        exp.train_iteration(i)
    assert exp.sr_opt.state[0].count > 0 and exp.decoder_opt.state[0].count
    renders.clear()
    exp.evaluate(1)
    second = [r.fine.rgb.clone() for r in renders]
    assert len(first) == len(second) > 0
    assert all(not torch.allclose(a, b) for a, b in zip(first, second))
    # what the run saves, an eval-mode Experiment renders the same
    exp.planes_buffer.save_params(as_best=True)
    exp.save_checkpoints(6, as_best=True)
    ev = Experiment(cfg, eval_mode="images", results_path="res",
                    root_path=str(corpus), device=CPU)
    ev.planes_buffer.draw_scenes()
    # the eval-mode dataset indexes its views in its own way: both render
    # its views
    exp.dataset, exp._last_view = ev.dataset, None
    for seq, idx in ev.i_val.items():
        for skip in ((False, True) if seq in
                     exp.scene_coupler.downsample_couples else (False,)):
            a = exp.render_eval_image(seq, idx[0], skip_sr=skip)[0]
            b = ev.render_eval_image(seq, idx[0], skip_sr=skip)[0]
            torch.testing.assert_close(b.fine.rgb, a.fine.rgb, rtol=0,
                                       atol=1e-6)


def test_evaluate_after_occupancy_commit_uses_the_new_box(corpus,
                                                           monkeypatch):
    """The eval render's occupied box comes from the scene's current box:
    after a commit (PlanesBuffer.set_occ_aabb) the next render tightens
    its rays to the new box, not to a cached copy of the old one."""
    cfg = _mini_cfg(corpus, logdir="logs/occeval",
                    train_groups={"4,8,8": ["lego"]}, sr=False,
                    what=("LR_planes", "decoder"), iters=1000)
    cfg.nerf.train["occupancy"] = {"enabled": True, "warmup_iters": 0,
                                   "update_every": 1, "mode": "density",
                                   "grid": 8}
    exp = Experiment(cfg, root_path=str(corpus), device=CPU)
    boxes = []
    real = texp.render_image
    monkeypatch.setattr(texp, "render_image", lambda *a, **kw: (
        boxes.append(kw["occ_aabb"]), real(*a, **kw))[1])
    exp.planes_buffer.draw_scenes()
    exp.image_sampler.update_active(exp.planes_buffer.cur_scenes)
    scene = "lego_DS4_PlRes8_8"
    view = exp.i_val[scene][0]
    exp.train_iteration(0)      # commits a density-mode box
    committed = exp.planes_buffer.get(scene).occ_aabb
    assert committed is not None
    out_a = exp.render_eval_image(scene, view)[0]
    np.testing.assert_array_equal(boxes[-1].numpy(), committed)
    small = np.array([[-0.1, -0.1, -0.1], [0.1, 0.1, 0.1]], np.float32)
    exp.planes_buffer.set_occ_aabb(scene, small)
    out_b = exp.render_eval_image(scene, view)[0]
    np.testing.assert_array_equal(boxes[-1].numpy(), small)
    # rays that miss the small box composite to background
    assert not torch.allclose(out_a.fine.rgb, out_b.fine.rgb)


def test_newer_run_preempts_an_older_one(corpus):
    """time_sig.txt: a newer run on the same logdir claims it at its
    first save, and the older run stops at its next save."""
    cfg = _mini_cfg(corpus, logdir="logs/preempt",
                    train_groups={"4,8,8": ["lego"]}, sr=False,
                    what=("LR_planes", "decoder"), iters=4)
    older = Experiment(cfg, root_path=str(corpus), device=CPU)
    newer = Experiment(cfg, root_path=str(corpus), device=CPU)
    assert newer.run_time_signature > older.run_time_signature
    newer.save_checkpoints(0)
    with pytest.raises(PreemptedError):
        older.save_checkpoints(0)


def test_no_improvement_stops_training(corpus):
    """experiment.no_improvement_iters: at a save where the best-loss
    group's running loss has not improved for that many iterations per
    training scene, the run saves and stops."""
    cfg = _mini_cfg(corpus, logdir="logs/earlystop",
                    train_groups={"4,8,8": ["lego"]}, sr=False,
                    what=("LR_planes", "decoder"), iters=10)
    cfg.experiment.update(validate_every=1, save_every=1,
                          no_improvement_iters=0)
    exp = Experiment(cfg, root_path=str(corpus), device=CPU)
    # a best loss no run can beat
    exp.experiment_info["best_loss"] = (0, 0.0)
    exp.run()
    # the running score fills at the second evaluation (two val views)
    assert exp.experiment_info["start_i"] == 2
    assert find_latest_checkpoint(exp.logdir, sr=False).endswith(
        "checkpoint00001.ckpt")
