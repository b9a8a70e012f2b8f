"""Rank functions of the port's data-parallel tests (run by
tests/torch_dist_helpers.py inside a gloo world on the CPU). No JAX is
imported here: each returns numpy arrays and plain values."""

import os

import numpy as np
import torch


def experiment_steps(rank, world, cfg, root, n_iters=4, fault=None):
    """The mini TrainModels of tests/test_experiment_mesh.py's _run_steps
    through the port's Experiment on the CPU: n_iters train_iterations,
    the flushed losses and PSNRs, one eval view's rgb on the reference
    path and on the eval kernels' route; also which plane
    files and pickles this rank wrote (after a planes save and a
    checkpoint save), and the scenes' resident planes. `fault`: a fault
    of gpubench/cell_faults.py planted in the rank for the whole run."""
    if fault is not None:
        from gpubench import cell_faults
        with cell_faults.planted(fault):
            return experiment_steps(rank, world, cfg, root, n_iters)
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
    # what this rank keeps between steps: plane and Adam bytes of the
    # buffer, and the module slices with their moments
    resident_bytes = exp.planes_buffer.resident_bytes()
    module_bytes = {
        name: sum(t.numel() * t.element_size() for t in _leaves(tree))
        for name, tree in (
            ("decoders", [exp.decoder_coarse, exp.decoder_fine]),
            ("sr", exp.sr_params),
            ("moments", [[st["exp_avg"], st["exp_avg_sq"]]
                         for opt in (exp.decoder_opt, exp.sr_opt)
                         if opt is not None
                         for st in opt.opt.state.values()]))}
    scene = exp.evaluation_sequences[0]
    out, _ = exp.render_eval_image(scene, exp.i_val[scene][0])
    rgb = (out.fine if out.fine is not None else out.coarse).rgb.numpy()
    # the same view on the eval kernels' route (their plain versions here),
    # within one evaluate pass: the decoders gathered once under a model
    # axis, a pooled scene lent whole
    exp.cfg.nerf.validation["tiled_gather"] = True
    assert exp.eval_tile_cfg(scene) is not None
    exp._eval_pf_cache = {}
    out, _ = exp.render_eval_image(scene, exp.i_val[scene][0])
    rgb_tiled = (out.fine if out.fine is not None
                 else out.coarse).rgb.numpy()
    gathered = "decoders" in exp._eval_pf_cache
    exp._eval_pf_cache = None
    exp.cfg.nerf.validation["tiled_gather"] = False
    exp.planes_buffer.save_params()
    exp.save_checkpoints(n_iters - 1)
    owned = None
    if exp.host_partition is not None:
        owned = exp.host_partition.owned
    full = [exp._full("decoder", exp.decoder_coarse),
            exp._full("decoder", exp.decoder_fine)]
    sr = exp._full("SR", exp.sr_params)
    moments = [exp._full_opt_state(opt)[0][m]
               for opt in (exp.decoder_opt, exp.sr_opt) for m in (1, 2)]
    return {"losses": losses, "psnrs": psnrs, "rgb": rgb,
            "rgb_tiled": rgb_tiled, "gathered": gathered,
            "planes_written": planes_written, "pickles": pickles,
            "owned": owned, "resident_bytes": resident_bytes,
            "module_bytes": module_bytes,
            "homes": None if exp.host_partition is None
            else exp.host_partition.owners,
            "planes": {s: p.planes_pos.numpy().copy()
                       for s, p in exp.planes_buffer.resident.items()
                       if isinstance(p.planes_pos, torch.Tensor)},
            "decoders": _numpy_leaves(full), "sr": _numpy_leaves(sr),
            "moments": _numpy_leaves(moments)}


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


def _numpy_leaves(tree):
    """A tree's tensor leaves (sorted dict keys, list order) as numpy."""
    return [t.detach().numpy().copy() for t in _leaves(tree)]


def tp_train_step(rank, world, model_parallel, cfg, sr_cfg, dc, df, sr,
                  planes, box, rays, target, drop_pair=False):
    """One train_step of tests/test_parallel.py's setup (numpy trees in
    the JAX layout) with SR, on the ('data', 'model') mesh of the world
    (model_parallel M; without a process group, the world of 1): the
    decoders and the SR net sliced over the model index, the rays split
    over the data index, the step reduced over the data group. Returns
    the loss and every gradient in the full layout (gathered over the
    model group), as numpy trees in the JAX layout. drop_pair: with
    copy_to_model left out (identity both ways), as a broken port would
    run."""
    import torch.distributed as dist

    from nvsr_tpu_torch import bridge
    from nvsr_tpu_torch.models.plane_sr import PlaneSRConfig
    from nvsr_tpu_torch.models.triplane import TriplaneConfig
    from nvsr_tpu_torch.ops.draws import RowShard
    from nvsr_tpu_torch.parallel import sharding, tensor
    from nvsr_tpu_torch.render import RayBundle, RenderConfig
    from nvsr_tpu_torch.train import StepFlags, reduce_step, train_step

    if drop_pair:
        tensor.copy_to_model = lambda x, mesh: x
    cfg, sr_cfg = TriplaneConfig(**cfg), PlaneSRConfig(**sr_cfg)
    dc, df = (bridge.decoder_from_jax(t, "cpu") for t in (dc, df))
    sr = bridge.plane_sr_from_jax(sr, "cpu")
    planes = {k: torch.from_numpy(v) for k, v in planes.items()}
    rays = RayBundle(*[None if f is None else torch.from_numpy(f)
                       for f in rays])
    target = torch.from_numpy(target)
    gen = torch.Generator().manual_seed(0)
    mesh = sharding.make_mesh(model_parallel=model_parallel) \
        if dist.is_initialized() else None
    tp = mesh if sharding.tensor_parallel(mesh) else None
    lay = {}
    if tp is not None:
        lay = {"dc": sharding.decoder_tp_shardings(dc, tp),
               "sr": sharding.plane_sr_tp_shardings(sr, tp)}
        lay["df"] = lay["dc"]
        dc, df, sr = (sharding.shard_tree(t, lay[k], tp)
                      for k, t in (("dc", dc), ("df", df), ("sr", sr)))
    if mesh is not None:
        n = target.shape[0]
        lo, hi = sharding.data_sharding(mesh, n)
        rays, target = sharding.shard_rays(mesh, rays), target[lo:hi]
        gen = RowShard(gen, lo, hi, n)
    metrics, grads = train_step(
        dc, df, sr, planes, torch.from_numpy(box), rays, target, gen,
        model_cfg=cfg, sr_cfg=sr_cfg,
        rcfg=RenderConfig(num_coarse=6, num_fine=6, perturb=False),
        flags=StepFlags(sr_iter=True), mesh=tp)
    metrics, grads = reduce_step(mesh, metrics, grads)
    grads = {k: sharding.gather_tree(v, lay[k], tp) if k in lay else v
             for k, v in grads.items()}
    return {"loss": float(metrics["loss"]),
            "grads": {"planes": {k: v.numpy() for k, v in
                                 grads["planes"].items()},
                      "dc": bridge.decoder_to_jax(grads["dc"]),
                      "df": bridge.decoder_to_jax(grads["df"]),
                      "sr": bridge.plane_sr_to_jax(grads["sr"])}}


def experiment_resume(rank, world, cfg, root):
    """The port's Experiment resuming the config's logdir on this rank:
    its decoder and SR leaves and their Adam moments as this rank holds
    them (sorted dict keys), each with the axis it is split on (None:
    whole), and the rank's model index (None without a mesh)."""
    from nvsr_tpu_torch import experiment as experiment_mod
    from nvsr_tpu_torch.utils.config import CfgNode

    exp = experiment_mod.Experiment(CfgNode(cfg), root_path=root,
                                    device="cpu", load_checkpoint="resume")

    def with_axes(tree, layout):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in with_axes(
                tree[k], None if layout is None else layout[k])]
        if isinstance(tree, (list, tuple)):
            return [x for i, v in enumerate(tree) for x in with_axes(
                v, None if layout is None else layout[i])]
        return [(tree.detach().numpy().copy(), layout)]

    dec = exp._layouts.get("decoder")
    opts = [(exp.decoder_opt, {k: dec for k in exp.decoder_opt.params}
             if dec else None),
            (exp.sr_opt, exp._layouts.get("SR"))]
    return {"decoders": with_axes([exp.decoder_coarse, exp.decoder_fine],
                                  [dec, dec] if dec else None),
            "sr": with_axes(exp.sr_params, exp._layouts.get("SR")),
            "moments": [x for opt, lay in opts for m in (1, 2)
                        for x in with_axes(opt.state[0][m], lay)],
            "model_index": None if exp.mesh is None
            else exp.mesh.model_index}
