"""The multi-rank dry run (counterpart of __graft_entry__.py's
dryrun_multichip): one full training step sharded over n ranks, held
against the same step at world 1, and the sharded eval render held
against the unsharded one.

    python -m nvsr_tpu_torch.parallel.dryrun N [--device cuda|cuda:K|cpu]
                                              [--dist-backend nccl|gloo]
                                              [--model-parallel M]

The ranks run on the card, as the CLI's do: rank r on cuda:r under NCCL
(N cards), or every rank on one named card (`--device cuda:0
--dist-backend gloo`, which NCCL refuses); `--device cpu` runs gloo
ranks on the CPU. Each rank is a process of its own (one torch thread, a
file:// rendezvous); so is the world of 1, so that both run the same
arithmetic, and so is a second world of 1, the run-to-run control (on
the card the backward's atomics sum in another order each run; on the
CPU the two agree bit for bit). Tiny shapes: 2 + 2 layer decoders 16
wide, 4-channel 12^2 planes, EDSR 8x1 x2, 16 rays a rank, 6 + 6 samples
with jitter and density noise (drawn for the global batch on every rank,
ops.draws.RowShard), the density bias raised by 1 so that the field and
its gradients are alive.

With --model-parallel M (M > 1) the mesh is (N // M, M): the decoders
and the SR net are sliced (parallel.sharding's layouts), their
gradients gathered over the model group before the comparison, and the
eval render takes the decoders gathered over the model group (the eval
kernels take whole decoders), so it stays exactly equal. The step's
bounds are then JAX's for a tensor-parallel step
(tests/test_parallel.py: loss within 1e-5 relative; here the gradients
within 5e-4 of their group's largest): a row layer's partial sums add
up in another order.
"""

from __future__ import annotations

import argparse
import math
import os
import pickle
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

RAYS_PER_RANK = 16


def _camera(eye):
    eye = np.asarray(eye, dtype=np.float32)
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, [0, 0, 1.0]).astype(np.float32)
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up, -fwd, eye
    return torch.from_numpy(c2w)


def _setup(dev):
    """The models and planes, drawn on the CPU from seed 0 and moved to
    `dev`: the same numbers on every rank and device."""
    from nvsr_tpu_torch.models.plane_sr import (PlaneSRConfig,
                                                init_plane_sr_params)
    from nvsr_tpu_torch.models.triplane import (TriplaneConfig,
                                                init_decoder_params)
    gen = torch.Generator().manual_seed(0)
    cfg = TriplaneConfig(dec_channels=16, num_plane_channels=4,
                         dec_density_layers=2, dec_rgb_layers=2,
                         proj_combination="avg",
                         viewdir_proj_combination="concat_pos")
    sr_cfg = PlaneSRConfig(in_channels=4, out_channels=4, hidden_size=8,
                           n_blocks=1, scale_factor=2)
    dc = init_decoder_params(gen, cfg, dev)
    df = init_decoder_params(gen, cfg, dev)
    for dec in (dc, df):
        dec["members"][0]["fc_alpha"]["b"] += 1.0
    sr = init_plane_sr_params(gen, sr_cfg, dev)
    planes = {"pos": (0.03 * torch.randn((3, 4, 12, 12), generator=gen)
                      ).to(dev),
              "view": (0.03 * torch.randn((4, 6, 6), generator=gen)
                       ).to(dev)}
    box = np.stack([[-4, -4, -4, -np.pi, -np.pi / 2],
                    [4, 4, 4, np.pi, np.pi / 2]]).astype(np.float32)
    return cfg, sr_cfg, dc, df, sr, planes, box


def _rays(n, side, dev, tile=None):
    from nvsr_tpu_torch.ops.geometry import get_ray_bundle
    from nvsr_tpu_torch.render import RayBundle, make_ray_bundle, \
        tile_ray_maps
    ro, rd = get_ray_bundle(side, side, 1.2 * side, _camera([3.5, 0.5, 0.5]))
    if tile:
        ro, rd = tile_ray_maps(ro, tile), tile_ray_maps(rd, tile)
    rays = make_ray_bundle(ro.to(dev), rd.to(dev), 2.0, 6.0,
                           use_viewdirs=True)
    return RayBundle(*[f[:n] for f in rays])


def rank_step(n_rays: int, dev, model_parallel: int = 1) -> dict:
    """One rank of the dry run on `dev` (world 1 with no process group is
    the reference): the sharded train_step, its reduction, and the
    sharded eval render. Returns rank 0's loss, gradients (full) and rgb
    as numpy, with the collectives of the step."""
    import torch.distributed as dist

    from nvsr_tpu_torch.ops.draws import RowShard
    from nvsr_tpu_torch.parallel import sharding
    from nvsr_tpu_torch.parallel.sharding import (data_sharding, make_mesh,
                                                  shard_rays)
    from nvsr_tpu_torch.render import (RenderConfig, make_triplane_point_fn,
                                       render_rays_chunked)
    from nvsr_tpu_torch.train import StepFlags, reduce_step, train_step

    mesh = make_mesh(model_parallel=model_parallel) \
        if dist.is_initialized() else None
    tp = mesh if mesh is not None and mesh.model_parallel > 1 else None
    cfg, sr_cfg, dc, df, sr, planes, box = _setup(dev)
    if tp is not None:
        lay = {"dc": sharding.decoder_tp_shardings(dc, tp),
               "sr": sharding.plane_sr_tp_shardings(sr, tp)}
        lay["df"] = lay["dc"]
        dc, df, sr = (sharding.shard_tree(t, lay[k], tp)
                      for k, t in (("dc", dc), ("df", df), ("sr", sr)))
    rays = _rays(n_rays, int(math.ceil(math.sqrt(n_rays))), dev)
    dirs = rays.directions / torch.linalg.norm(rays.directions, dim=-1,
                                               keepdim=True)
    target = torch.clamp(0.5 + 0.5 * dirs, 0.0, 1.0)
    gen = torch.Generator(device=dev).manual_seed(0)
    if mesh is not None:
        lo, hi = data_sharding(mesh, n_rays)
        rays, target = shard_rays(mesh, rays), target[lo:hi]
        gen = RowShard(gen, lo, hi, n_rays)
    rcfg = RenderConfig(num_coarse=6, num_fine=6, perturb=True,
                        radiance_field_noise_std=0.2)
    flags = StepFlags(sr_iter=True, share_coarse_fine=False)
    before = dict(sharding.COLLECTIVES)
    metrics, grads = train_step(dc, df, sr, planes,
                                torch.from_numpy(box).to(dev),
                                rays, target, gen, model_cfg=cfg,
                                sr_cfg=sr_cfg, rcfg=rcfg, flags=flags,
                                mesh=tp)
    metrics, grads = reduce_step(mesh, metrics, grads)
    collectives = {k: v - before.get(k, 0)
                   for k, v in sharding.COLLECTIVES.items()}
    if tp is not None:
        grads = {k: sharding.gather_tree(v, lay[k], tp) if k in lay else v
                 for k, v in grads.items()}

    # the eval render: 32x32 rays in 8x8 tiles through the tiled point
    # fns (under a model axis on the decoders gathered once, as the
    # Experiment's eval does), four blocks of 256 rays shared over the
    # data indices
    rays_e = _rays(32 * 32, 32, dev, tile=8)
    rcfg_e = RenderConfig(num_coarse=6, num_fine=6, perturb=False,
                          ray_block=256)
    if tp is not None:
        dc, df = (sharding.gather_tree(t, lay[k], tp)
                  for k, t in (("dc", dc), ("df", df)))

    def point_fn(dec):
        return make_triplane_point_fn(
            dec, cfg, planes["pos"], planes["view"], box, tile_rays=64)

    with torch.no_grad():
        out = render_rays_chunked(point_fn(dc), point_fn(df), rays_e,
                                  rcfg_e, mesh=mesh)

    def numpy(tree):
        if isinstance(tree, dict):
            return {k: numpy(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [numpy(v) for v in tree]
        return tree.detach().cpu().numpy()

    return {"loss": float(metrics["loss"]), "psnr": float(metrics["psnr"]),
            "grads": numpy(grads), "rgb": out.fine.rgb.cpu().numpy(),
            "collectives": collectives}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _check(ok: bool, msg: str):
    if not ok:
        raise RuntimeError(msg)


def _rank_device(device: str, rank: int) -> str:
    """cuda:rank for `cuda` (a card a rank, as torchrun's LOCAL_RANK);
    a named device for every rank otherwise."""
    return f"cuda:{rank}" if device == "cuda" else device


def _spawn(world: int, n_rays: int, tmp: str, group: bool, device: str,
           backend: str, tag: str, model_parallel: int = 1):
    rdv = f"file://{os.path.join(tmp, f'rdv_{tag}')}" if group else "-"
    env = dict(os.environ, OMP_NUM_THREADS="1",
               GLOO_SOCKET_IFNAME=os.environ.get("GLOO_SOCKET_IFNAME", "lo"),
               NCCL_SOCKET_IFNAME=os.environ.get("NCCL_SOCKET_IFNAME", "lo"),
               PYTHONPATH=os.pathsep.join(
                   [os.path.dirname(os.path.dirname(os.path.dirname(
                       os.path.abspath(__file__)))),
                    os.environ.get("PYTHONPATH", "")]))
    procs = []
    for r in range(world):
        out = os.path.join(tmp, f"out_{tag}_{r}.pkl")
        with open(out + ".log", "w") as log:
            procs.append((subprocess.Popen(
                [sys.executable, "-m", "nvsr_tpu_torch.parallel.dryrun",
                 "--rank", str(r), str(world), str(n_rays), rdv, out,
                 _rank_device(device, r), backend, str(model_parallel)],
                env=env, stdout=log, stderr=subprocess.STDOUT), out))
    return procs


def _results(procs, timeout: float) -> dict:
    deadline = time.monotonic() + timeout
    try:
        for p, out in procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"the dry run outlasted {timeout} s")
            if p.returncode != 0:
                with open(out + ".log") as f:
                    raise RuntimeError(f"a dry-run rank failed:\n"
                                       f"{f.read()[-4000:]}")
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    with open(procs[0][1], "rb") as f:
        return pickle.load(f)


def _grad_rel(a: dict, b: dict) -> dict:
    """max |a - b| / max |b| over each gradient group's leaves."""
    return {k: max(float(np.max(np.abs(x - y))) /
                   max(float(np.max(np.abs(y))), 1e-12)
                   for x, y in zip(_leaves(a[k]), _leaves(b[k])))
            for k in b}


def dryrun_multichip(n_devices: int, device: str = "cuda", backend=None,
                     timeout: float = 300.0, model_parallel: int = 1) -> dict:
    """One training step on n ranks against the same step at world 1
    (16 rays a rank: the same global batch), and a second world of 1
    against the first (the control); prints JAX's fields, with the
    gradients' deltas by group, and returns them. Fails unless every
    gradient group is alive, the loss is within 1e-6 relative, the
    gradients within 1e-4 of their largest and the eval render exactly
    equal; with model_parallel > 1 (a (n // M, M) mesh), within the
    tensor-parallel bounds of the module docstring.

    device: `cuda` (rank r on cuda:r), a named card for every rank, or
    `cpu`. backend: NCCL on cards and gloo on the CPU unless named."""
    if model_parallel < 1 or n_devices % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} does not divide "
                         f"{n_devices} ranks")
    tp = model_parallel > 1
    backend = backend or ("gloo" if device == "cpu" else "nccl")
    if device == "cuda" and n_devices > torch.cuda.device_count():
        raise ValueError(
            f"{n_devices} ranks on cuda:0..{n_devices - 1}, but "
            f"{torch.cuda.device_count()} card(s) are visible: name one "
            f"card for every rank (--device cuda:0 --dist-backend gloo; "
            f"NCCL refuses two ranks on one card)")
    n_rays = RAYS_PER_RANK * n_devices
    one_dev = _rank_device(device, 0)
    with tempfile.TemporaryDirectory() as tmp:
        dp = _spawn(n_devices, n_rays, tmp, True, device, backend, "dp",
                    model_parallel)
        one = _spawn(1, n_rays, tmp, False, one_dev, backend, "one",
                     model_parallel)
        again = _spawn(1, n_rays, tmp, False, one_dev, backend, "again",
                       model_parallel)
        res_n, res_1, res_c = (_results(dp, timeout),
                               _results(one, timeout),
                               _results(again, timeout))
    loss = res_n["loss"]
    _check(np.isfinite(loss), "the dry run's loss is not finite")
    gmax = {k: max(float(np.max(np.abs(x))) for x in _leaves(v))
            for k, v in res_n["grads"].items()}
    _check(all(v > 0.0 for v in gmax.values()),
           f"a dead gradient group in the sharded step: {gmax}")
    dl = abs(loss - res_1["loss"])
    by_group = _grad_rel(res_n["grads"], res_1["grads"])
    control = _grad_rel(res_c["grads"], res_1["grads"])
    gd = max(by_group.values())
    rd = float(np.max(np.abs(res_n["rgb"] - res_1["rgb"])))
    rgb_ok = rd == 0.0
    mesh = {"data": n_devices // model_parallel, "model": model_parallel}
    fields = {"world": n_devices, "device": device, "backend": backend,
              "mesh": mesh, "collectives": res_n["collectives"],
              "loss": loss, "loss_delta": dl, "grad_rel_delta": gd,
              "grad_rel_delta_by_group": by_group,
              "control_loss_delta": abs(res_c["loss"] - res_1["loss"]),
              "control_grad_rel_delta_by_group": control,
              "grad_max": max(gmax.values()),
              "eval_render_max_delta": rd}
    print(f"dryrun_multichip({n_devices}) on {device} ({backend}): "
          f"mesh={mesh} loss={loss:.5f} "
          f"|loss_dp-loss_1|={dl:.2e} grad_rel_delta={gd:.2e} "
          f"grad_max={max(gmax.values()):.3e} "
          f"eval_render_max_delta={rd:.2e}; by group "
          f"{ {k: f'{v:.2e}' for k, v in by_group.items()} }, a second "
          f"world of 1 (control) "
          f"{ {k: f'{v:.2e}' for k, v in control.items()} }; rank 0's "
          f"collectives in the step {res_n['collectives']}")
    _check(dl <= (1e-5 if tp else 1e-6) * abs(loss),
           f"sharded loss {loss} vs {res_1['loss']}")
    _check(gd <= (5e-4 if tp else 1e-4),
           f"sharded gradients: relative delta {gd:.2e}")
    _check(rgb_ok, f"sharded eval render: max delta {rd:.2e}")
    print("OK")
    return fields


def _rank_main(rank, world, n_rays, rdv, out, device, backend,
               model_parallel):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if rdv != "-":
        dist.init_process_group(
            backend, init_method=rdv, rank=int(rank), world_size=int(world),
            device_id=dev if backend == "nccl" else None)
    try:
        res = rank_step(int(n_rays), dev, int(model_parallel))
    finally:
        if rdv != "-":
            dist.destroy_process_group()
    if int(rank) == 0:
        with open(out, "wb") as f:
            pickle.dump(res, f)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--rank"]:
        _rank_main(*argv[1:9])
        return
    parser = argparse.ArgumentParser(
        prog="python -m nvsr_tpu_torch.parallel.dryrun",
        description="One sharded training step and eval render against "
                    "the world of 1.")
    parser.add_argument("n", type=int, nargs="?", default=2,
                        help="ranks (default 2)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (rank r on cuda:r, the default), "
                             "cuda:K (every rank on card K) or cpu")
    parser.add_argument("--dist-backend", default=None,
                        choices=["nccl", "gloo"],
                        help="default: nccl on cards, gloo on the CPU")
    parser.add_argument("--model-parallel", type=int, default=1,
                        help="the mesh's model axis (default 1: data "
                             "parallel only)")
    args = parser.parse_args(argv)
    dryrun_multichip(args.n, device=args.device, backend=args.dist_backend,
                     model_parallel=args.model_parallel)


if __name__ == "__main__":
    main()
