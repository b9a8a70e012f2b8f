"""The port's tensor parallelism (parallel/sharding.py's layouts,
parallel/tensor.py's collectives, the Experiment under
`experiment.model_parallel`) on gloo worlds on the CPU, against the port's
world of 1 and against the JAX package's sharded runs:

* one train_step with SR (tests/test_parallel.py's setup, and a variant
  with a skip concat feeding a row layer and an odd layer count) on a
  world of 2 (mesh 1 x 2) and of 4 (2 x 2) against the world of 1 and
  against JAX's sharded train_step on the 8-virtual-CPU mesh (4 x 2):
  loss rtol 1e-5, gradients rtol 5e-4 / atol 1e-5
  (tests/test_parallel.py:70-110); and with copy_to_model left out, the
  planes' gradient fails those bounds (it keeps each rank's part);
* the Experiment as a world of 4 (`data_parallel: 4, model_parallel: 2`)
  against the world of 1 within JAX's bounds (losses rtol 2e-4 / atol
  1e-6, the eval image rtol 1e-3 / atol 1e-4,
  tests/test_experiment_mesh.py:57-65), and against JAX's `data_parallel:
  4, model_parallel: 2` from one JAX logdir with the device draws off:
  losses and PSNRs within 1e-5 relative; its eval on the eval kernels'
  route (decoders gathered once) within the image bounds of the world
  of 1's on that route;
* checkpoints in the full layout: the world of 4's logdir resumes at
  world 1 and in JAX with every decoder, SR and Adam leaf bit-equal to
  the gathered ones, and a world-1 logdir resumes under model_parallel 2
  with each rank's slice bit-equal to its block of the full leaf.

Every world runs under tests/torch_dist_helpers.py's timeout, so a world
whose model-group ranks meet in different collectives fails in seconds."""

import numpy as np
import pytest

import torch_dist_helpers as dist_helpers
from helpers_synth import write_blender_scene
from nvsr_tpu_torch.parallel.host_pool import scene_owner
from test_torch_experiment_dp import SCENES, STEPS, _cfg

STEP = "torch_dist_ranks:tp_train_step"
RESUME = "torch_dist_ranks:experiment_resume"
# tests/test_parallel.py's decoder, and one whose rgb branch has a skip
# concat before a row layer (layer 3) and whose density branch ends in a
# column layer (3 layers)
CONFIGS = {
    "paired": dict(dec_channels=16, num_plane_channels=4,
                   dec_density_layers=2, dec_rgb_layers=2),
    "skip_odd": dict(dec_channels=16, num_plane_channels=4,
                     dec_density_layers=3, dec_rgb_layers=4,
                     skip_connect_every=2),
}
SR_CFG = dict(in_channels=4, out_channels=4, hidden_size=8, n_blocks=1,
              scale_factor=2)


def _flat(tree):
    """A numpy or jax tree's leaves (sorted dict keys) as numpy."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flat(v)]
    return [np.asarray(tree)]


def _jax_steps(name, cpu_devices):
    """tests/test_parallel.py's setup with decoder config `name`: the
    inputs as numpy, JAX's unsharded step and its step sharded over the
    8-device mesh (data 4 x model 2)."""
    import jax
    import jax.numpy as jnp
    from nvsr_tpu.models.plane_sr import (PlaneSRConfig,
                                          init_plane_sr_params)
    from nvsr_tpu.models.triplane import TriplaneConfig, init_decoder_params
    from nvsr_tpu.ops.geometry import get_ray_bundle
    from nvsr_tpu.parallel.sharding import (data_sharding,
                                            decoder_tp_shardings, make_mesh,
                                            plane_sr_tp_shardings,
                                            replicate, replicate_tree)
    from nvsr_tpu.render import RenderConfig, make_ray_bundle
    from nvsr_tpu.train import StepFlags, train_step
    from test_parallel import _camera

    rng = np.random.default_rng(0)
    cfg = TriplaneConfig(**CONFIGS[name])
    dc = init_decoder_params(jax.random.PRNGKey(0), cfg)
    df = init_decoder_params(jax.random.PRNGKey(1), cfg)
    sr_cfg = PlaneSRConfig(**SR_CFG)
    sr = init_plane_sr_params(jax.random.PRNGKey(2), sr_cfg)
    planes = {"pos": 0.1 * rng.standard_normal((3, 4, 12, 12)).astype(
                  np.float32),
              "view": 0.1 * rng.standard_normal((4, 6, 6)).astype(
                  np.float32)}
    box = np.stack([[-4, -4, -4, -np.pi, -np.pi / 2],
                    [4, 4, 4, np.pi, np.pi / 2]]).astype(np.float32)
    ro, rd = get_ray_bundle(8, 8, 10.0, jnp.asarray(_camera([3.0, 0, 0])))
    rays = make_ray_bundle(ro, rd, 2.0, 6.0, use_viewdirs=True)
    target = rng.random((64, 3)).astype(np.float32)
    rcfg = RenderConfig(num_coarse=6, num_fine=6, perturb=False)
    flags = StepFlags(sr_iter=True)
    key = jax.random.PRNGKey(0)

    def step(dc, df, srp, pl, rays, target, key):
        return train_step(dc, df, srp, pl, jnp.asarray(box), rays, target,
                          key, model_cfg=cfg, sr_cfg=sr_cfg, rcfg=rcfg,
                          flags=flags)

    ref = step(dc, df, sr, planes, rays, jnp.asarray(target), key)
    mesh = make_mesh(8, model_parallel=2, devices=cpu_devices)
    dec_sh = decoder_tp_shardings(dc, mesh)
    sr_sh = plane_sr_tp_shardings(sr, mesh)
    rays_sh = jax.tree.map(lambda a: data_sharding(mesh, a.ndim), rays)
    with mesh:
        sharded = jax.jit(step, in_shardings=(
            dec_sh, dec_sh, sr_sh, replicate_tree(planes, mesh), rays_sh,
            data_sharding(mesh, 2), replicate(mesh)))(
                dc, df, sr, planes, rays, jnp.asarray(target), key)
    inputs = dict(cfg=CONFIGS[name], sr_cfg=SR_CFG,
                  dc=jax.tree.map(np.asarray, dc),
                  df=jax.tree.map(np.asarray, df),
                  sr=jax.tree.map(np.asarray, sr), planes=planes, box=box,
                  rays=[None if f is None else np.asarray(f) for f in rays],
                  target=target)

    def out(res):
        metrics, grads = res
        return {"loss": float(metrics["loss"]),
                "grads": jax.tree.map(np.asarray, dict(grads))}

    return inputs, out(ref), out(sharded)


@pytest.fixture(scope="module")
def steps(cpu_devices, tmp_path_factory):
    """Per decoder config: the port's step on worlds of 1, 2 (1 x 2) and 4
    (2 x 2) and a world of 2 without copy_to_model, all spawned at once;
    meanwhile JAX's unsharded and sharded steps in this process."""
    tmp = str(tmp_path_factory.mktemp("tp_steps"))
    jax_out, runs = {}, {}
    for name in CONFIGS:
        inputs, ref, sharded = _jax_steps(name, cpu_devices)
        jax_out[name] = {"ref": ref, "sharded": sharded}
        for tag, world, group, extra in (
                ("w1", 1, False, {}), ("w2", 2, True, {}),
                ("w4", 4, True, {}), ("broken", 2, True,
                                      {"drop_pair": True})):
            runs[name, tag] = dist_helpers.start(
                STEP, world, dict(inputs, model_parallel=2, **extra), tmp,
                group=group)
    out = {key: dist_helpers.finish(procs, timeout=120)
           for key, procs in runs.items()}
    return out, jax_out


def _assert_step(got, want):
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    for group in ("planes", "dc", "df", "sr"):
        a, b = _flat(got["grads"][group]), _flat(want["grads"][group])
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, rtol=5e-4, atol=1e-5)


@pytest.mark.parametrize("world", ["w2", "w4"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_tp_step_matches_world1(steps, name, world):
    out, _ = steps
    ref, = out[name, "w1"]
    for rank in out[name, world]:
        _assert_step(rank, ref)


@pytest.mark.parametrize("world", ["w2", "w4"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_tp_step_matches_jax_sharded(steps, name, world):
    out, jax_out = steps
    for rank in out[name, world]:
        _assert_step(rank, jax_out[name]["sharded"])
    # and the world of 1 is JAX's unsharded step
    _assert_step(out[name, "w1"][0], jax_out[name]["ref"])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_dropping_copy_to_model_is_caught(steps, name):
    """Without the conjugate pair the planes' gradient (a replicated
    input's) keeps only this rank's part of the first layers' product:
    the bounds above fail."""
    out, _ = steps
    ref, = out[name, "w1"]
    broken, _ = out[name, "broken"]
    assert not all(np.allclose(x, y, rtol=5e-4, atol=1e-5) for x, y in zip(
        _flat(broken["grads"]["planes"]), _flat(ref["grads"]["planes"])))


# --- the Experiment -------------------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus_tp")
    for name in SCENES:
        write_blender_scene(str(root / "synt"), name, size=32)
    return root


def _tp_cfg(root, logdir, **kw):
    cfg = _cfg(root, logdir, data_parallel=4, **kw)
    cfg.experiment["model_parallel"] = 2
    return cfg


@pytest.fixture(scope="module")
def experiments(corpus, cpu_devices, tmp_path_factory):
    """The mini TrainModels as a world of 4 (2 x 2) and without a process
    group, and the refine from JAX's initialized stage as a world of 4,
    all at once, with JAX's stage and then its refine under data_parallel
    4, model_parallel 2 in this process; then the world of 4's logdir
    resumed without a process group and by JAX, and the world-1 logdir
    resumed by a world of 2 under model_parallel 2."""
    from nvsr_tpu.experiment import Experiment as JExperiment

    tmp = str(tmp_path_factory.mktemp("tp_worlds"))
    root = str(corpus)
    stage = JExperiment(_cfg(corpus, "logs/stage0", data_parallel=False,
                             perturb=False), root_path=root)
    stage.planes_buffer.draw_scenes()
    stage.planes_buffer.save_params()
    stage.planes_buffer.save_params(as_best=True)
    stage.save_checkpoints(0, as_best=True)
    refine = dict(perturb=False, pretrained="logs/stage0",
                  planes_path="logs/stage0")
    cfgs = {"w4": _tp_cfg(corpus, "logs/tp_w4"),
            "w1": _cfg(corpus, "logs/tp_w1"),
            "refine": _tp_cfg(corpus, "logs/tp_refine", **refine)}
    runs = {name: dist_helpers.start(
        STEPS, world, dict(cfg=cfgs[name].to_dict(), root=root), tmp,
        group=group)
        for name, world, group in (("w4", 4, True), ("w1", 1, False),
                                   ("refine", 4, True))}
    je = JExperiment(_tp_cfg(corpus, "logs/jax_tp", **refine),
                     root_path=root)
    assert dict(je.mesh.shape) == {"data": 2, "model": 2}
    je.planes_buffer.draw_scenes()
    je.image_sampler.update_active(je.planes_buffer.cur_scenes)
    for i in range(4):
        je.train_iteration(i)
    out = {name: dist_helpers.finish(procs, timeout=180)
           for name, procs in runs.items()}
    out["jax"] = je.flush_train_metrics()

    resumed_tp = _cfg(corpus, "logs/tp_w1", data_parallel=2)
    resumed_tp.experiment["model_parallel"] = 2
    runs = {"resume_w1": dist_helpers.start(
                RESUME, 1, dict(cfg=_cfg(corpus, "logs/tp_w4").to_dict(),
                                root=root), tmp, group=False),
            "resume_tp": dist_helpers.start(
                RESUME, 2, dict(cfg=resumed_tp.to_dict(), root=root), tmp)}
    jr = JExperiment(_cfg(corpus, "logs/tp_w4", data_parallel=False),
                     root_path=root, load_checkpoint="resume")
    out["jax_resume"] = {
        "decoders": _flat([jr.decoder_coarse, jr.decoder_fine]),
        "sr": _flat(jr.sr_params),
        "moments": _flat([jr.decoder_opt.state[0].mu,
                          jr.decoder_opt.state[0].nu,
                          jr.sr_opt.state[0].mu, jr.sr_opt.state[0].nu])}
    out.update({name: dist_helpers.finish(procs, timeout=120)
                for name, procs in runs.items()})
    return out


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))
                        / np.maximum(np.abs(np.asarray(b)), 1e-30)))


def test_world4_matches_world1(experiments):
    ref, = experiments["w1"]
    w4 = experiments["w4"][0]
    print(f"world 4 (2 x 2) vs world 1: losses "
          f"{_rel(w4['losses'], ref['losses']):.2e}, "
          f"PSNRs {_rel(w4['psnrs'], ref['psnrs']):.2e}, image "
          f"{float(np.max(np.abs(w4['rgb'] - ref['rgb']))):.2e} (max abs)")
    for rank in experiments["w4"]:
        assert len(rank["losses"]) == len(ref["losses"]) == 4
        np.testing.assert_allclose(rank["losses"], ref["losses"], rtol=2e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(rank["psnrs"], ref["psnrs"], rtol=2e-4)
        np.testing.assert_allclose(rank["rgb"], ref["rgb"], rtol=1e-3,
                                   atol=1e-4)
    first = experiments["w4"][0]
    assert all(r["losses"] == first["losses"] for r in experiments["w4"])


def test_world4_tiled_eval_matches_world1(experiments):
    """The eval kernels' route under the model axis: each rank renders
    with the decoders gathered once (the kernels take whole decoders),
    within JAX's tensor-parallel image bounds of the world of 1 on the
    same route."""
    ref, = experiments["w1"]
    assert not ref["gathered"]
    for rank in experiments["w4"]:
        assert rank["gathered"]
        np.testing.assert_allclose(rank["rgb_tiled"], ref["rgb_tiled"],
                                   rtol=1e-3, atol=1e-4)


def test_world4_matches_jax_model_parallel(experiments):
    j_losses, j_psnrs = experiments["jax"]
    assert len(j_losses) == 4
    mine = experiments["refine"][0]
    print(f"world 4 vs JAX's data_parallel 4 / model_parallel 2: losses "
          f"{_rel(mine['losses'], j_losses):.2e}, PSNRs "
          f"{_rel(mine['psnrs'], j_psnrs):.2e}")
    for rank in experiments["refine"]:
        np.testing.assert_allclose(rank["losses"], j_losses, rtol=1e-5)
        np.testing.assert_allclose(rank["psnrs"], j_psnrs, rtol=1e-5)


def test_world4_writes_rank0_checkpoints_and_owner_planes(experiments):
    reps = experiments["w4"]
    assert set(reps[0]["pickles"]) == {"checkpoint00003.ckpt",
                                       "SR_checkpoint00003.ckpt",
                                       "exp_info.pkl"}
    assert all(rep["pickles"] == [] for rep in reps[1:])
    for r, rep in enumerate(reps):
        assert all(scene_owner(s, 4) == r for s in rep["planes_written"])


@pytest.mark.parametrize("reader", ["resume_w1", "jax_resume"])
def test_tp_logdir_resumes_bit_equal(experiments, reader):
    """The world of 4 wrote the full layout: a world of 1 and JAX read
    back exactly the leaves it gathered."""
    saved = experiments["w4"][0]
    got = experiments[reader]
    if reader == "resume_w1":
        got = {k: [x for x, _ in v] for k, v in got[0].items()
               if k != "model_index"}
    for group in ("decoders", "sr", "moments"):
        assert len(got[group]) == len(saved[group]) > 0
        for a, b in zip(got[group], saved[group]):
            np.testing.assert_array_equal(a, b)


def test_world1_logdir_resumes_sliced(experiments):
    """A world-1 logdir under model_parallel 2: each rank holds its model
    index's contiguous block of every split leaf, bit for bit, and the
    whole of every replicated one."""
    full = experiments["w1"][0]
    ranks = experiments["resume_tp"]
    assert sorted(r["model_index"] for r in ranks) == [0, 1]
    for rank in ranks:
        split = 0
        for group in ("decoders", "sr", "moments"):
            assert len(rank[group]) == len(full[group]) > 0
            for (part, axis), whole in zip(rank[group], full[group]):
                want = whole if axis is None else np.split(
                    whole, 2, axis=axis)[rank["model_index"]]
                split += axis is not None
                np.testing.assert_array_equal(part, want)
        assert split > 0


def test_eval_kernel_routes_refuse_a_split_decoder():
    """The fused gather+decode kernel and the eval sampler route take a
    whole decoder: a tensor-parallel mesh there is refused (the
    Experiment gathers the decoders for them first)."""
    import torch
    from nvsr_tpu_torch.models.triplane import (TriplaneConfig,
                                                apply_triplane_rays_from_z,
                                                init_decoder_params)
    from nvsr_tpu_torch.parallel.sharding import Mesh
    from nvsr_tpu_torch.render import make_triplane_point_fn

    cfg = TriplaneConfig(**CONFIGS["paired"])
    dec = init_decoder_params(torch.Generator().manual_seed(0), cfg, "cpu")
    planes = torch.zeros((3, 4, 8, 8))
    view = torch.zeros((4, 4, 4))
    box = np.stack([[-4, -4, -4, -np.pi, -np.pi / 2],
                    [4, 4, 4, np.pi, np.pi / 2]]).astype(np.float32)
    mesh = Mesh(0, 2, None, None, torch.device("cpu"), model_parallel=2)
    with pytest.raises(ValueError, match="tensor-parallel"):
        make_triplane_point_fn(dec, cfg, planes, view, box, tile_rays=64,
                               mesh=mesh)
    rays = torch.zeros((64, 3))
    with pytest.raises(ValueError, match="tensor-parallel"):
        apply_triplane_rays_from_z(dec, cfg, planes, view, box, rays, rays,
                                   rays, torch.zeros((64, 4)), mesh=mesh)
