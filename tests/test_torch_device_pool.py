"""The port's device-resident scene pool (`nerf.train.store_planes.
device_pool`: parallel/host_pool.pool_homes, planes_store.PlanesBuffer's
device_pool) on gloo worlds on the CPU, as tests/test_experiment_mesh.py
:100-140 holds JAX's:

* the pool's world of 2 against the replicated world of 2 (the mini
  TrainModels of tests/test_torch_experiment_dp.py, jitter on, 4
  iterations, an eval view): bit for bit, since the same averaged
  gradients go through the same Adam on the scene's home;
* the homes are JAX's placement for the same saved ids (the sorted ids
  round-robin over the mesh's devices), and each plane file is written
  by its home alone;
* between steps a rank keeps its home scenes' planes and Adam moments
  and nothing of the other scenes;
* the pool's world of 2 against JAX's `device_pool` on 2 devices, from one
  JAX logdir with the device draws off: losses and PSNRs within 1e-5
  relative.

Every world runs under tests/torch_dist_helpers.py's timeout."""

import numpy as np
import pytest

import torch_dist_helpers as dist_helpers
from helpers_synth import write_blender_scene
from nvsr_tpu_torch.parallel.host_pool import HostPartition, pool_homes
from test_torch_experiment_dp import SCENES, STEPS, _cfg


def _pool_cfg(root, logdir, **kw):
    cfg = _cfg(root, logdir, data_parallel=2, **kw)
    cfg.nerf.train.store_planes["device_pool"] = True
    return cfg


@pytest.fixture(scope="module")
def pools(tmp_path_factory, cpu_devices):
    """The pool's and the replicated world of 2, and the pool's refine
    from JAX's initialized stage, all at once; meanwhile JAX's stage and
    its refine under device_pool on 2 devices in this process."""
    from nvsr_tpu.experiment import Experiment as JExperiment

    corpus = tmp_path_factory.mktemp("corpus_pool")
    for name in SCENES:
        write_blender_scene(str(corpus / "synt"), name, size=32)
    root = str(corpus)
    tmp = str(tmp_path_factory.mktemp("pool_worlds"))
    stage = JExperiment(_cfg(corpus, "logs/stage0", data_parallel=False,
                             perturb=False), root_path=root)
    stage.planes_buffer.draw_scenes()
    stage.planes_buffer.save_params()
    stage.planes_buffer.save_params(as_best=True)
    stage.save_checkpoints(0, as_best=True)
    refine = dict(perturb=False, pretrained="logs/stage0",
                  planes_path="logs/stage0")
    cfgs = {"pool": _pool_cfg(corpus, "logs/pool"),
            "rep": _cfg(corpus, "logs/rep", data_parallel=2),
            "refine": _pool_cfg(corpus, "logs/pool_refine", **refine)}
    runs = {name: dist_helpers.start(
        STEPS, 2, dict(cfg=cfg.to_dict(), root=root), tmp)
        for name, cfg in cfgs.items()}
    je = JExperiment(_pool_cfg(corpus, "logs/jax_pool", **refine),
                     root_path=root)
    devices = list(je.mesh.devices.flat)
    jax_homes = {sid: devices.index(next(iter(s.device_set)))
                 for sid, s in je.planes_buffer.placement.items()}
    je.planes_buffer.draw_scenes()
    je.image_sampler.update_active(je.planes_buffer.cur_scenes)
    for i in range(4):
        je.train_iteration(i)
    out = {name: dist_helpers.finish(procs, timeout=180)
           for name, procs in runs.items()}
    out["jax"] = je.flush_train_metrics()
    out["jax_homes"] = jax_homes
    return out


def test_pool_is_bit_equal_to_replicated(pools):
    for pool, rep in zip(pools["pool"], pools["rep"], strict=True):
        assert len(pool["losses"]) == 4
        assert pool["losses"] == rep["losses"]
        assert pool["psnrs"] == rep["psnrs"]
        np.testing.assert_array_equal(pool["rgb"], rep["rgb"])
        np.testing.assert_array_equal(pool["rgb_tiled"], rep["rgb_tiled"])
        for group in ("decoders", "sr", "moments"):
            for a, b in zip(pool[group], rep[group], strict=True):
                np.testing.assert_array_equal(a, b)
        for scene, planes in pool["planes"].items():
            np.testing.assert_array_equal(planes, rep["planes"][scene])


def test_homes_are_jax_placement(pools):
    homes = pools["jax_homes"]
    assert sorted(homes.values()) == [0, 1], "each rank is home to a scene"
    assert pool_homes(list(homes), 2) == homes
    for rank in pools["pool"] + pools["refine"]:
        assert rank["homes"] == homes


def test_homes_name_every_scene():
    """JAX's round robin over the trained scenes' ids, then the scenes
    only evaluated (which JAX leaves replicated) after them; the owners
    map is the one rule: an id it does not name is an error."""
    homes = pool_homes(["b", "a"], 2, extra=["c", "a", "0"])
    assert homes == {"a": 0, "b": 1, "0": 0, "c": 1}
    part = HostPartition(list(homes), process_index=1, process_count=2,
                         owners=homes)
    assert part.owned == ["b", "c"]
    with pytest.raises(KeyError):
        part.owner("d")


def test_each_plane_file_written_by_its_home(pools):
    for rank, rep in enumerate(pools["pool"]):
        homes = rep["homes"]
        assert rep["planes_written"], f"rank {rank} wrote no plane file"
        assert all(homes[s] == rank for s in rep["planes_written"])
        assert set(rep["owned"]) == {s for s in homes if homes[s] == rank}


def test_ranks_keep_only_their_home_scenes(pools):
    """After the steps each pooled rank holds the planes and moments of
    its home scene alone: half of what a replicated rank holds (one of
    two scenes of one size), and no planes of the other scene."""
    for rank, (pool, rep) in enumerate(zip(pools["pool"], pools["rep"])):
        homes = pool["homes"]
        assert sorted(pool["planes"]) == sorted(
            s for s in homes if homes[s] == rank)
        assert sorted(rep["planes"]) == sorted(homes)
        assert 0 < 2 * pool["resident_bytes"] == rep["resident_bytes"]


def test_pool_matches_jax_device_pool(pools):
    j_losses, j_psnrs = pools["jax"]
    assert len(j_losses) == 4
    mine = pools["refine"][0]
    print("pool vs JAX's device_pool: losses %.2e, PSNRs %.2e" % tuple(
        float(np.max(np.abs(np.subtract(a, b)) / np.abs(b)))
        for a, b in ((mine["losses"], j_losses), (mine["psnrs"], j_psnrs))))
    for rank in pools["refine"]:
        np.testing.assert_allclose(rank["losses"], j_losses, rtol=1e-5)
        np.testing.assert_allclose(rank["psnrs"], j_psnrs, rtol=1e-5)
