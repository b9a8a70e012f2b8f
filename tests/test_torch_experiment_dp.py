"""The port's Experiment under `experiment.data_parallel` on gloo worlds on
the CPU, as tests/test_experiment_mesh.py holds JAX's on its mesh:

* a world of 2 against a world of 1: tests/test_experiment_mesh.py's
  _run_steps (the mini TrainModels of tests/test_experiment.py's
  _mini_cfg with jitter on: LR and HR couples, planes, decoders and SR
  trained; 4 train_iterations, then one eval view) within JAX's bounds:
  losses rtol 2e-5 / atol 1e-7, PSNRs rtol 2e-4, the image rtol 1e-4 /
  atol 2e-5. The corpus is lego and boat, whose LR plane files have
  different crc32 owners at 2 ranks, so each rank owns one;
* the world of 2's planes and decoders after those steps against the
  world of 1's: within 1e-5 of each leaf's largest in f32, and within
  1e-2 with the SR net's convolutions in bf16, whose rounding steps
  grow the averaged gradients' rounding (the losses, PSNRs and image
  within JAX's bounds there too);
* a world of 4 (32 of the 128 rays a rank; two ranks own no plane file)
  against the world of 1 alike, in f32; with the last rank's gradients
  left out of the average (gpubench/cell_faults.py's dp_rank_left_out)
  it lands outside those bounds;
* a world of 1 against no process group: bit for bit;
* ownership: each rank wrote only the plane files it owns, rank 0 alone
  the checkpoints and exp_info, and both ranks hold the same planes;
* the port's world of 2 against JAX's Experiment with data_parallel: 2
  on 2 virtual devices, from one JAX-written logdir (the initialized
  stage, as tests/test_torch_experiment_interop.py starts from JAX's
  weights: torch generators cannot draw JAX's keys) and with the device
  draws off (no jitter, no noise): losses and PSNRs within 1e-5
  relative, as that file holds a single device;
* the CLI under `python -m torch.distributed.run --standalone
  --nproc_per_node=2 ... --device cpu` writes the logdir a world-1 run
  writes (one tensorboard event file);
* the refusal of data_parallel beyond the world; a world of 1 ignores
  model_parallel and store_planes.device_pool, as JAX's one device does
  (tests/test_torch_tensor_parallel.py and test_torch_device_pool.py run
  them on worlds of 2 and 4).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import torch_dist_helpers as dist_helpers
from helpers_synth import write_blender_scene
from nvsr_tpu_torch.experiment import Experiment as TExperiment
from nvsr_tpu_torch.parallel.host_pool import scene_owner
from nvsr_tpu_torch.utils.config import CfgNode as TCfgNode
from test_experiment import _mini_cfg

SCENES = ["lego", "boat"]
TRAIN = {"4,8,8": SCENES, "2,16,8": SCENES}
STEPS = "torch_dist_ranks:experiment_steps"


def _cfg(root, logdir, data_parallel=True, perturb=True, iters=4,
         **kw):
    cfg = _mini_cfg(root, logdir=logdir, train_groups=TRAIN, iters=iters,
                    **kw)
    if data_parallel:
        cfg.experiment["data_parallel"] = data_parallel
    cfg.nerf.train["perturb"] = perturb
    return cfg


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus_dp")
    for name in SCENES:
        write_blender_scene(str(root / "synt"), name, size=32)
    assert {scene_owner(f"{s}_DS4_PlRes8_8", 2) for s in SCENES} == {0, 1}
    return root


@pytest.fixture(scope="module")
def jax_stage(corpus):
    """The shared start of the port against JAX: JAX's initialized stage
    (device draws off), saved as its run saves; the refine config's
    options."""
    from nvsr_tpu.experiment import Experiment as JExperiment

    stage = JExperiment(_cfg(corpus, "logs/stage0", data_parallel=False,
                             perturb=False), root_path=str(corpus))
    stage.planes_buffer.draw_scenes()
    stage.planes_buffer.save_params()
    stage.planes_buffer.save_params(as_best=True)
    stage.save_checkpoints(0, as_best=True)
    return dict(perturb=False, pretrained="logs/stage0",
                planes_path="logs/stage0")


@pytest.fixture(scope="module")
def worlds(corpus, jax_stage, cpu_devices, tmp_path_factory):
    """The same run as a world of 2, a world of 1 and without a process
    group, and the refine from JAX's stage as a world of 2, all at once;
    meanwhile JAX's refine with data_parallel: 2 in this process."""
    from nvsr_tpu.experiment import Experiment as JExperiment

    tmp = str(tmp_path_factory.mktemp("worlds"))
    cfgs = {"w2": _cfg(corpus, "logs/w2"), "w1": _cfg(corpus, "logs/w1"),
            "alone": _cfg(corpus, "logs/alone"),
            "refine": _cfg(corpus, "logs/port_dp2", **jax_stage)}
    for name in ("w2_bf16", "w1_bf16"):
        cfgs[name] = _cfg(corpus, f"logs/{name}")
        cfgs[name].super_resolution.model["compute_dtype"] = "bfloat16"
    for name in ("w4", "w4_left_out"):
        cfgs[name] = _cfg(corpus, f"logs/{name}")
    faults = {"w4_left_out": "dp_rank_left_out"}
    runs = {name: dist_helpers.start(
        STEPS, world, dict(cfg=cfgs[name].to_dict(), root=str(corpus),
                           fault=faults.get(name)), tmp, group=group)
        for name, world, group in (("w2", 2, True), ("w1", 1, True),
                                   ("alone", 1, False), ("refine", 2, True),
                                   ("w2_bf16", 2, True), ("w1_bf16", 1, True),
                                   ("w4", 4, True), ("w4_left_out", 4, True))}
    je = JExperiment(_cfg(corpus, "logs/jax_dp2", data_parallel=2,
                          **jax_stage), root_path=str(corpus))
    assert je.mesh is not None and je.mesh.shape["data"] == 2
    je.planes_buffer.draw_scenes()
    je.image_sampler.update_active(je.planes_buffer.cur_scenes)
    for i in range(4):
        je.train_iteration(i)
    out = {name: dist_helpers.finish(procs, timeout=180)
           for name, procs in runs.items()}
    out["jax"] = je.flush_train_metrics()
    return out


def test_world2_matches_world1(worlds):
    ref, = worlds["w1"]
    for rank in worlds["w2"]:
        assert len(rank["losses"]) == len(ref["losses"]) == 4
        np.testing.assert_allclose(rank["losses"], ref["losses"], rtol=2e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(rank["psnrs"], ref["psnrs"], rtol=2e-4)
        np.testing.assert_allclose(rank["rgb"], ref["rgb"], rtol=1e-4,
                                   atol=2e-5)
    a, b = worlds["w2"]
    assert a["losses"] == b["losses"] and np.array_equal(a["rgb"], b["rgb"])


def _rel(a, b):
    """max |a - b| / max |b| over paired arrays."""
    return max(float(np.max(np.abs(x - y))) / max(float(np.max(np.abs(y))),
                                                  1e-30)
               for x, y in zip(a, b))


@pytest.mark.parametrize("sr_dtype,bound", [("", 1e-5), ("_bf16", 1e-2)])
def test_world2_parameters_against_world1(worlds, sr_dtype, bound):
    """After the 4 Adam steps, the world of 2's planes and decoders against
    the world of 1's, as max |delta| / leaf max. The averaged gradients
    round in another order than the whole batch's; in f32, with no
    atomics (the world of 1 is bit-equal to no process group), that
    rounding stays rounding (1.2e-7 planes, 6.5e-8 decoders). With the
    SR net's convolutions in bf16, as TrainModels runs them, a rounding
    that crosses a bf16 step moves the planes' gradient by 2^-8 of it:
    the planes drift 7.1e-4 apart in 4 steps (decoders 2.4e-7) while
    the losses, PSNRs and the eval image stay within JAX's bounds."""
    ref, = worlds["w1" + sr_dtype]
    scenes = sorted(ref["planes"])
    for rank in worlds["w2" + sr_dtype]:
        np.testing.assert_allclose(rank["losses"], ref["losses"], rtol=2e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(rank["psnrs"], ref["psnrs"], rtol=2e-4)
        np.testing.assert_allclose(rank["rgb"], ref["rgb"], rtol=1e-4,
                                   atol=2e-5)
        assert sorted(rank["planes"]) == scenes
        assert len(rank["decoders"]) == len(ref["decoders"]) > 0
        planes = _rel([rank["planes"][s] for s in scenes],
                      [ref["planes"][s] for s in scenes])
        decoders = _rel(rank["decoders"], ref["decoders"])
        print(f"world 2 vs world 1, SR net {sr_dtype[1:] or 'f32'}: planes "
              f"{planes:.3e}, decoders {decoders:.3e} of the leaf max")
        assert planes <= bound and decoders <= bound


def _world4_gaps(worlds, name):
    """The losses' and PSNRs' largest relative gaps and the planes' and
    decoders' (_rel) of each rank of world `name` against the world of
    1, after the 4 steps."""
    ref, = worlds["w1"]
    scenes = sorted(ref["planes"])
    out = []
    for rank in worlds[name]:
        assert sorted(rank["planes"]) == scenes
        loss = float(np.max(np.abs(np.subtract(rank["losses"], ref["losses"]))
                            / np.abs(ref["losses"])))
        out.append((loss, _rel([rank["planes"][s] for s in scenes],
                               [ref["planes"][s] for s in scenes]),
                    _rel(rank["decoders"], ref["decoders"])))
    return out


def test_world4_parameters_against_world1(worlds):
    """A world of 4 holds the world of 1's losses, PSNRs and eval image
    within JAX's bounds, and its planes and decoders after the 4 steps
    within 1e-5 of each leaf's largest, as the world of 2 does in f32:
    four shards' averaged gradients round in another order, and stay
    rounding."""
    ref, = worlds["w1"]
    assert len(worlds["w4"]) == 4
    for rank in worlds["w4"]:
        np.testing.assert_allclose(rank["losses"], ref["losses"], rtol=2e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(rank["psnrs"], ref["psnrs"], rtol=2e-4)
        np.testing.assert_allclose(rank["rgb"], ref["rgb"], rtol=1e-4,
                                   atol=2e-5)
    for loss, planes, decoders in _world4_gaps(worlds, "w4"):
        print(f"world 4 vs world 1: loss {loss:.3e}, planes {planes:.3e}, "
              f"decoders {decoders:.3e} of the leaf max")
        assert planes <= 1e-5 and decoders <= 1e-5


def test_world4_with_a_rank_left_out_of_the_average_fails(worlds):
    """The planted fault: the last rank's gradients left out of the sum,
    which is still divided by 4. The losses, which the all_reduce
    still averages whole, move only through the steps (1e-5); the planes
    and decoders land far outside the bound (0.46 and 7.4e-3 of the leaf
    max)."""
    for loss, planes, decoders in _world4_gaps(worlds, "w4_left_out"):
        print(f"world 4, a rank left out: loss {loss:.3e}, planes "
              f"{planes:.3e}, decoders {decoders:.3e}")
        assert planes > 1e-5 and decoders > 1e-5


def test_reduce_span_carries_the_all_reduce_bytes(corpus, tmp_path):
    """Under a profiler, an iteration's `reduce` span has the arg `bytes`:
    what its all_reduce moved (parallel.sharding.COLLECTIVES), the f32
    gradients of the decoders, the SR net and the scene's planes and the
    three loss terms. A world of 1 in this process: data_parallel over
    a gloo group of one rank has a mesh and reduces."""
    import torch
    import torch.distributed as dist
    from nvsr_tpu_torch.utils import tracing

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        exp = TExperiment(TCfgNode(_cfg(corpus, "logs/reduce").to_dict()),
                          root_path=str(corpus), device="cpu")
        assert exp.mesh is not None
        exp.planes_buffer.draw_scenes()
        exp._update_active_scenes()
        tracing.clear()
        with torch.profiler.profile():
            for i in range(2):
                exp.train_iteration(i)
        spans = [r for r in tracing.records() if r["name"] == "reduce"]
        tracing.clear()
    finally:
        dist.destroy_process_group()
    modules = sum(t.numel() * t.element_size()
                  for opt in (exp.decoder_opt, exp.sr_opt)
                  for t in opt._leaves)
    planes = sum(t.numel() * t.element_size() for t in next(iter(
        exp.planes_buffer.resident.values())).params().values())
    assert [r["args"]["bytes"] for r in spans] == [modules + planes + 12] * 2


def test_world1_is_bit_equal_to_no_process_group(worlds):
    one, = worlds["w1"]
    alone, = worlds["alone"]
    assert one["losses"] == alone["losses"]
    assert one["psnrs"] == alone["psnrs"]
    np.testing.assert_array_equal(one["rgb"], alone["rgb"])
    assert one["planes"].keys() == alone["planes"].keys()
    for s in one["planes"]:
        np.testing.assert_array_equal(one["planes"][s], alone["planes"][s])
    for a, b in zip(one["decoders"], alone["decoders"], strict=True):
        np.testing.assert_array_equal(a, b)
    assert one["planes_written"] == alone["planes_written"]
    assert one["pickles"] == alone["pickles"]


def test_owner_only_plane_files_and_rank0_checkpoints(worlds):
    r0, r1 = worlds["w2"]
    for r, rep in enumerate((r0, r1)):
        assert rep["planes_written"], f"rank {r} wrote no plane file"
        assert all(scene_owner(s, 2) == r for s in rep["planes_written"])
        assert set(rep["owned"]) == {s for s in rep["planes"]
                                     if scene_owner(s, 2) == r}
    assert r1["pickles"] == []
    assert set(r0["pickles"]) == {"checkpoint00003.ckpt",
                                  "SR_checkpoint00003.ckpt", "exp_info.pkl"}
    assert r0["planes"].keys() == r1["planes"].keys()
    for s in r0["planes"]:
        np.testing.assert_array_equal(r0["planes"][s], r1["planes"][s])


def test_port_world2_matches_jax_data_parallel(worlds):
    j_losses, j_psnrs = worlds["jax"]
    assert len(j_losses) == 4
    for rep in worlds["refine"]:
        np.testing.assert_allclose(rep["losses"], j_losses, rtol=1e-5)
        np.testing.assert_allclose(rep["psnrs"], j_psnrs, rtol=1e-5)


def _tree(d):
    """A logdir's files, tensorboard event files by their count."""
    files = sorted(os.path.relpath(os.path.join(p, f), d)
                   for p, _, fs in os.walk(d) for f in fs)
    events = [f for f in files if "tfevents" in f]
    return [f for f in files if "tfevents" not in f], len(events)


def test_cli_under_torchrun_writes_the_world1_logdir(corpus, tmp_path):
    paths = {}
    for name in ("cli_w1", "cli_w2"):
        cfg = _cfg(corpus, f"logs/{name}", iters=2)
        cfg.experiment["validate_every"] = 1000
        paths[name] = tmp_path / f"{name}.yml"
        paths[name].write_text(cfg.dump())
    base = [sys.executable]
    cli = ["-m", "nvsr_tpu_torch.cli", "--device", "cpu", "--max-iters",
           "2", "--config"]
    procs = {
        "cli_w1": subprocess.Popen(
            base + cli + [str(paths["cli_w1"])], cwd=str(corpus),
            env=dist_helpers.env(), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True),
        "cli_w2": subprocess.Popen(
            base + ["-m", "torch.distributed.run", "--standalone",
                    "--nproc_per_node=2"] + cli + [str(paths["cli_w2"])],
            cwd=str(corpus), env=dist_helpers.env(), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)}
    for name, p in procs.items():
        try:
            out, _ = p.communicate(timeout=180)
        finally:
            if p.poll() is None:
                p.kill()
        assert p.returncode == 0, f"{name}:\n{out[-4000:]}"
    one, n_one = _tree(corpus / "logs" / "cli_w1")
    two, n_two = _tree(corpus / "logs" / "cli_w2")
    assert one == two
    assert "checkpoint00001.ckpt" in one and "exp_info.pkl" in one
    assert n_one == n_two <= 1


def test_refusals(corpus):
    """Without a process group the world is 1: data_parallel 2 exceeds
    it; model_parallel and store_planes.device_pool are ignored there, as
    JAX's Experiment on one device ignores them (no mesh, whole
    decoders, every scene's planes in this process)."""
    def exp(cfg):
        return TExperiment(TCfgNode(cfg.to_dict()), root_path=str(corpus),
                           device="cpu")

    with pytest.raises(ValueError, match="exceeds"):
        exp(_cfg(corpus, "logs/ref_dp", data_parallel=2))
    cfg = _cfg(corpus, "logs/ref_mp")
    cfg.experiment["model_parallel"] = 2
    one = exp(cfg)
    assert one.mesh is None and one._tp is None
    assert one.decoder_coarse["members"][0]["density"][0]["w"].shape[1] \
        == cfg.models.coarse["dec_channels"]
    cfg = _cfg(corpus, "logs/ref_pool")
    cfg.nerf.train.store_planes["device_pool"] = True
    one = exp(cfg)
    assert one.mesh is None and not one.planes_buffer.device_pool
    # data_parallel: true without a process group is the world of 1 (no
    # mesh), as JAX's on one device
    assert exp(_cfg(corpus, "logs/ref_one")).mesh is None
