"""The port's data-parallel layer (nvsr_tpu_torch/parallel/) against JAX's
(nvsr_tpu/parallel/, tests/test_parallel.py) and against the world of 1:

* ownership: the port's crc32 scene_owner gives JAX's owner for every id,
  and the owned sets and balance are JAX's;
* the row split: data_sharding / shard_rays give each rank the rows that
  JAX's data_sharding puts on each of 2 virtual devices;
* the global draws: a batch split over ranks draws, row for row, what
  one rank draws for the whole batch (ops.draws.RowShard);
* the dry run (dryrun_multichip(2), two gloo ranks against the world of
  1): loss within 1e-6 relative, gradients within 1e-4 of their
  largest, the sharded eval render exactly equal;
* the two-rank plane pool (tests/test_parallel.py:217 with real ranks
  over one store directory): every read and write by the scene's owner,
  the same draws on both ranks, and a fresh reader sees the trained
  state;
* the tensor-parallel layouts and what they refuse, as JAX refuses it
  (tests/test_torch_tensor_parallel.py runs them).

Spawned gloo worlds run one torch thread a rank and fail after a
timeout instead of hanging (tests/torch_dist_helpers.py)."""

import numpy as np
import pytest
import torch

import torch_dist_helpers as dist_helpers
from nvsr_tpu.parallel.host_pool import HostPartition as JPartition
from nvsr_tpu.parallel.host_pool import scene_owner as j_owner
from nvsr_tpu_torch.ops import draws
from nvsr_tpu_torch.parallel import sharding
from nvsr_tpu_torch.parallel.dryrun import dryrun_multichip
from nvsr_tpu_torch.parallel.host_pool import HostPartition, scene_owner
from nvsr_tpu_torch.render import RayBundle

SCENES = [f"scene{i:03d}_DS2_PlRes64_16" for i in range(64)]


@pytest.mark.parametrize("hosts", [1, 2, 3, 4])
def test_scene_owner_matches_jax(hosts):
    assert [scene_owner(s, hosts) for s in SCENES] == \
        [j_owner(s, hosts) for s in SCENES]


def test_host_partition_matches_jax():
    """tests/test_parallel.py:139-156 on the port: deterministic, disjoint,
    covering and not pathologically skewed, and equal to JAX's views."""
    owned = [set(HostPartition(SCENES, process_index=i,
                               process_count=4).owned) for i in range(4)]
    assert set().union(*owned) == set(SCENES)
    assert sum(len(s) for s in owned) == len(SCENES)
    for i in range(4):
        p = HostPartition(SCENES, process_index=i, process_count=4)
        jp = JPartition(SCENES, process_index=i, process_count=4)
        assert p.owned == jp.owned
        assert p.balance() == jp.balance()
        assert [p.owns(s) for s in SCENES] == [jp.owns(s) for s in SCENES]
    bal = HostPartition(SCENES, process_index=1, process_count=4).balance()
    assert all(4 <= bal.get(h, 0) <= 28 for h in range(4)), bal
    # without a process group: one rank that owns everything
    alone = HostPartition(SCENES)
    assert (alone.process_index, alone.process_count) == (0, 1)
    assert alone.owned == SCENES


def _mesh(rank, world):
    """A rank's mesh for the row arithmetic (no process group needed)."""
    return sharding.Mesh(rank, world, None, None, torch.device("cpu"))


def test_shard_rows_match_jax_data_sharding(cpu_devices):
    import jax
    from nvsr_tpu.parallel.sharding import data_sharding as j_sharding
    from nvsr_tpu.parallel.sharding import make_mesh as j_make_mesh

    n = 24
    rows = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    jmesh = j_make_mesh(2, devices=cpu_devices[:2])
    placed = jax.device_put(rows, j_sharding(jmesh, 2))
    by_device = {s.device: np.asarray(s.data)
                 for s in placed.addressable_shards}
    bundle = RayBundle(*[torch.from_numpy(rows) * k for k in (1, 2, 3, 4)],
                       viewdirs=None)
    for r, dev in enumerate(jmesh.devices[:, 0]):
        lo, hi = sharding.data_sharding(_mesh(r, 2), n)
        np.testing.assert_array_equal(rows[lo:hi], by_device[dev])
        mine = sharding.shard_rays(_mesh(r, 2), bundle)
        np.testing.assert_array_equal(mine.origins.numpy(), by_device[dev])
        np.testing.assert_array_equal(mine.far.numpy(), 4 * by_device[dev])
        assert mine.viewdirs is None
    with pytest.raises(ValueError, match="does not split"):
        sharding.data_sharding(_mesh(0, 2), 25)


@pytest.mark.parametrize("world", [1, 2, 3])
def test_row_shards_draw_the_global_batch(world):
    """Each draw of ops.draws for a shard is the shard's rows of the draw
    for the whole batch, also for [rays * samples, 3] point draws."""
    n, s = 12, 5
    for fn, shape in ((draws.rand, (n, s)), (draws.randn, (n * s, 3)),
                      (draws.exponential, (n, s + 1))):
        full = fn(shape, torch.Generator().manual_seed(3))
        parts = []
        for r in range(world):
            lo, hi = sharding.data_sharding(_mesh(r, world), n)
            g = draws.RowShard(torch.Generator().manual_seed(3), lo, hi, n)
            local = (hi - lo,) + shape[1:] if shape[0] == n \
                else ((hi - lo) * s,) + shape[1:]
            parts.append(fn(local, g))
        assert torch.equal(torch.cat(parts), full)


def test_dryrun_two_ranks():
    fields = dryrun_multichip(2, device="cpu", timeout=120)
    assert fields["backend"] == "gloo"
    assert fields["loss_delta"] <= 1e-6 * abs(fields["loss"])
    assert fields["grad_rel_delta"] <= 1e-4
    assert fields["eval_render_max_delta"] == 0.0
    assert fields["grad_max"] > 0.0
    # the CPU repeats its arithmetic: the control is exact
    assert fields["control_loss_delta"] == 0.0
    assert set(fields["control_grad_rel_delta_by_group"].values()) == {0.0}


def test_dryrun_tensor_parallel():
    """The dry run under a model axis of 2: the step within JAX's
    tensor-parallel bounds, the eval render on the decoders gathered
    over the model group exactly the world of 1's, and the split
    activations gathered by all_gather on CPU tensors."""
    fields = dryrun_multichip(2, device="cpu", timeout=120, model_parallel=2)
    assert fields["mesh"] == {"data": 1, "model": 2}
    assert fields["loss_delta"] <= 1e-5 * abs(fields["loss"])
    assert fields["grad_rel_delta"] <= 5e-4
    assert fields["eval_render_max_delta"] == 0.0
    assert fields["collectives"]["model:all_gather"] > 0


def test_two_rank_pool_cycle(tmp_path):
    from nvsr_tpu_torch.planes_store import PlaneStore, ScenePlanes

    scenes = ["lego_DS2", "ship_DS2", "mic_DS2", "chair_DS2"]
    assert {scene_owner(s, 2) for s in scenes} == {0, 1}
    box = np.stack([np.full(5, -4.0), np.full(5, 4.0)]).astype(np.float32)
    store_dir = tmp_path / "planes"
    store_dir.mkdir()
    seed = PlaneStore([str(store_dir)])
    for i, s in enumerate(scenes):
        seed.save(s, ScenePlanes(
            torch.full((3, 4, 8, 8), float(i + 1)),
            torch.full((4, 4, 4), float(i + 1)), box))
    ranks = dist_helpers.run_world(
        "torch_dist_ranks:pool_cycle", 2,
        dict(store_dir=str(store_dir), scenes=scenes), str(tmp_path),
        timeout=120)
    assert ranks[0]["draws"] == ranks[1]["draws"], "the ranks drew apart"
    stepped = {s for cycle in ranks[0]["draws"] for s in cycle}
    for r, rep in enumerate(ranks):
        assert rep["writes"], f"rank {r} never wrote"
        assert all(scene_owner(s, 2) == r for s in rep["writes"]), rep
        assert all(scene_owner(s, 2) == r for s in rep["reads"]), rep
        assert set(rep["owned"]) == {s for s in scenes
                                     if scene_owner(s, 2) == r}
    assert set(ranks[0]["writes"]) | set(ranks[1]["writes"]) >= stepped
    for s in sorted(stepped):
        np.testing.assert_array_equal(ranks[0]["resident"][s],
                                      ranks[1]["resident"][s])
        np.testing.assert_array_equal(ranks[0]["disk"][s],
                                      ranks[0]["resident"][s])
        assert not np.array_equal(
            ranks[0]["disk"][s], np.full((3, 4, 8, 8),
                                         float(scenes.index(s) + 1)))


def test_tensor_parallel_refuses():
    """What JAX refuses, the port refuses: a model axis that does not
    divide the mesh (JAX asserts) and a split axis that does not divide
    by it (JAX's device_put raises ValueError); the layouts themselves
    are JAX's (column, row, replicated heads; conv output channels)."""
    with pytest.raises(ValueError, match="does not divide"):
        sharding.make_mesh(3, model_parallel=2)
    from nvsr_tpu_torch.models.plane_sr import (PlaneSRConfig,
                                                init_plane_sr_params)
    from nvsr_tpu_torch.models.triplane import (TriplaneConfig,
                                                init_decoder_params)
    gen = torch.Generator().manual_seed(0)
    dec = init_decoder_params(gen, TriplaneConfig(
        dec_channels=6, num_plane_channels=4, dec_density_layers=3,
        dec_rgb_layers=2), "cpu")
    sr = init_plane_sr_params(gen, PlaneSRConfig(
        in_channels=4, out_channels=4, hidden_size=6, n_blocks=1,
        scale_factor=2), "cpu")
    mesh = sharding.Mesh(1, 2, None, None, torch.device("cpu"),
                         model_parallel=2)
    lay = sharding.decoder_tp_shardings(dec, mesh)["members"][0]
    assert lay["density"] == [{"w": 1, "b": 0}, {"w": 0, "b": None},
                              {"w": 1, "b": 0}]
    assert lay["fc_alpha"] == lay["fc_rgb"] == {"w": None, "b": None}
    sr_lay = sharding.plane_sr_tp_shardings(sr, mesh)["inner"]
    assert sr_lay["conv_input"] == {"w": 0}
    mine = sharding.shard_tree(dec, {"members": [lay]}, mesh)["members"][0]
    np.testing.assert_array_equal(mine["density"][0]["w"].numpy(),
                                  dec["members"][0]["density"][0]["w"]
                                  [:, 3:].numpy())
    assert mine["fc_rgb"]["w"] is dec["members"][0]["fc_rgb"]["w"]
    # 6 hidden features split over 2 ranks, not over 4
    odd = sharding.Mesh(0, 4, None, None, torch.device("cpu"),
                        model_parallel=4)
    with pytest.raises(ValueError, match="does not split"):
        sharding.shard_tree(dec, sharding.decoder_tp_shardings(dec, odd),
                            odd)
