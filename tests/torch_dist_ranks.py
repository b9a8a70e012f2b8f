"""Rank functions of the port's data-parallel tests (run by
tests/torch_dist_helpers.py inside a gloo world on the CPU). No JAX is
imported here: each returns numpy arrays and plain values."""

import os

import numpy as np
import torch


def experiment_steps(rank, world, cfg, root, n_iters=4):
    """The mini TrainModels of tests/test_experiment_mesh.py's _run_steps
    through the port's Experiment on the CPU: n_iters train_iterations,
    the flushed losses and PSNRs, one eval view's rgb; also which plane
    files and pickles this rank wrote (after a planes save and a
    checkpoint save), and the scenes' resident planes."""
    from nvsr_tpu_torch import experiment as experiment_mod
    from nvsr_tpu_torch.utils.config import CfgNode

    pickles = []
    real_save_pickle = experiment_mod.save_pickle

    def save_pickle(name, *a, **kw):
        pickles.append(os.path.basename(name))
        return real_save_pickle(name, *a, **kw)

    experiment_mod.save_pickle = save_pickle
    exp = experiment_mod.Experiment(CfgNode(cfg), root_path=root,
                                    device="cpu")
    planes_written = []
    real_save = exp.store.save

    def save(scene, *a, **kw):
        planes_written.append(scene)
        return real_save(scene, *a, **kw)

    exp.store.save = save
    exp.planes_buffer.draw_scenes()
    exp.image_sampler.update_active(exp.planes_buffer.cur_scenes)
    for i in range(n_iters):
        exp.train_iteration(i)
    losses, psnrs = exp.flush_train_metrics()
    scene = exp.evaluation_sequences[0]
    out, _ = exp.render_eval_image(scene, exp.i_val[scene][0])
    rgb = (out.fine if out.fine is not None else out.coarse).rgb.numpy()
    exp.planes_buffer.save_params()
    exp.save_checkpoints(n_iters - 1)
    owned = None
    if exp.host_partition is not None:
        owned = exp.host_partition.owned
    return {"losses": losses, "psnrs": psnrs, "rgb": rgb,
            "planes_written": planes_written, "pickles": pickles,
            "owned": owned,
            "planes": {s: p.planes_pos.numpy().copy()
                       for s, p in exp.planes_buffer.resident.items()},
            "decoders": [t.detach().numpy().copy() for t in _leaves(
                [exp.decoder_coarse, exp.decoder_fine])]}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def pool_cycle(rank, world, store_dir, scenes, cycles=4):
    """tests/test_parallel.py's two-host pool cycle with real ranks: every
    rank drives its own PlanesBuffer over one store directory through
    redraw -> Adam step -> redraw cycles (the same gradients on every
    rank, as the reduced step gives them). Returns the rank's draws, the
    scenes it wrote and read, its resident planes of every stepped scene
    after the final flush, and what a fresh reader finds on disk after
    every rank flushed."""
    from nvsr_tpu_torch.parallel.host_pool import HostPartition
    from nvsr_tpu_torch.parallel.sharding import agree, make_mesh
    from nvsr_tpu_torch.planes_store import PlaneStore, PlanesBuffer

    mesh = make_mesh()
    store = PlaneStore([store_dir])
    writes, reads = [], []
    real_save, real_load = store.save, store.load

    def save(scene, *a, **kw):
        writes.append(scene)
        return real_save(scene, *a, **kw)

    def load(scene, *a, **kw):
        reads.append(scene)
        return real_load(scene, *a, **kw)

    store.save, store.load = save, load
    part = HostPartition(scenes)
    buf = PlanesBuffer(store, scenes, lr=1e-2, buffer_size=2,
                       steps_per_buffer=2, rng=np.random.default_rng(7),
                       device="cpu", host_partition=part, mesh=mesh)
    draws, stepped = [], set()
    for cycle in range(cycles):
        cur = buf.draw_scenes()
        draws.append(list(cur))
        for s in cur:
            value = 0.1 * (cycle + 1) * (scenes.index(s) + 1) / 7.0
            buf.apply_grads(s, {"pos": torch.full((3, 4, 8, 8), value),
                                "view": torch.zeros((4, 4, 4))})
            stepped.add(s)
    buf._flush()
    resident = {s: buf.load_scene(s).planes_pos.numpy().copy()
                for s in sorted(stepped)}
    agree(mesh, 0)      # every rank has flushed
    reader = PlaneStore([store_dir])
    disk = {s: reader.load(s)[0].planes_pos.numpy().copy()
            for s in sorted(stepped)}
    return {"draws": draws, "writes": writes, "reads": reads,
            "owned": part.owned, "resident": resident, "disk": disk}
