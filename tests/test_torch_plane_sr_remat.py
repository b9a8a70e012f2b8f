"""The EDSR trunk's recompute policy (nvsr_tpu_torch/models/plane_sr.py)
on the CPU: kept and recomputed activations give the same outputs and
gradients to the bit; `edsr_kept_bytes` counts the ReLU maps autograd
saves; `edsr_remat` honours a stated remat and decides an unstated one
from the room it is given; `apply_plane_sr` decides once a call, in
training only; and the `plane_sr` span's `recomputed_blocks` arg."""

import dataclasses
import types

import pytest
import torch

from nvsr_tpu_torch.models import plane_sr as ps
from test_torch_tracing import _only_sr_draws, _profiled, _stage1, corpus  # noqa: F401

CFG = ps.PlaneSRConfig(in_channels=4, out_channels=4, hidden_size=8,
                       n_blocks=4, scale_factor=2)
LR_SHAPE = (3, 4, 10, 10)


def _sr(cfg):
    """Seeded SR parameters with every leaf trained, their leaves, and
    seeded LR planes that take a gradient too."""
    params = ps.init_plane_sr_params(torch.Generator().manual_seed(3), cfg,
                                     "cpu")
    inner = params["inner"]
    # the reference init's tiny weights would leave the blocks' outputs at
    # rounding level: scale them so every block moves the result
    leaves = [inner["conv_input"]["w"], inner["conv_mid"]["w"],
              inner["conv_output"]["w"]]
    leaves += [u["w"] for u in inner["upscale"]]
    leaves += [b[k]["w"] for b in inner["blocks"] for k in ("conv1", "conv2")]
    for w in leaves:
        w.mul_(10.0).requires_grad_(True)
    lr = torch.randn(LR_SHAPE, generator=torch.Generator().manual_seed(4),
                     requires_grad=True)
    return params, leaves, lr


def _run(cfg):
    """apply_plane_sr(train=True) and the gradients of a loss over its
    output w.r.t. the SR leaves and the planes; the blocks recomputed."""
    params, leaves, lr = _sr(cfg)
    before = ps.BlockRecompute.blocks
    out = ps.apply_plane_sr(params, cfg, lr, train=True)
    grads = torch.autograd.grad((out.float() ** 2).sum(), leaves + [lr])
    return out, grads, ps.BlockRecompute.blocks - before


def _trunk_runs(tile_size):
    """The trunk's runs in training: one a plane, or one a tile of 6 of
    the 10^2 planes (2 x 2), the planes as one batch."""
    return LR_SHAPE[0] if tile_size is None else 4


@pytest.mark.parametrize("remat_every", [1, 3])
@pytest.mark.parametrize("tile_size", [None, 6])
@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_kept_and_recomputed_activations_are_bit_equal(compute_dtype,
                                                       tile_size,
                                                       remat_every):
    cfg = dataclasses.replace(CFG, compute_dtype=compute_dtype,
                              tile_size=tile_size, remat_every=remat_every)
    out_k, grads_k, n_k = _run(dataclasses.replace(cfg, remat=False))
    out_r, grads_r, n_r = _run(dataclasses.replace(cfg, remat=True))
    assert torch.equal(out_k, out_r)
    assert len(grads_k) == len(grads_r)
    for gk, gr in zip(grads_k, grads_r):
        assert torch.equal(gk, gr)
    assert any(g.abs().max() > 0 for g in grads_k[:-1])
    assert (n_k, n_r) == (0, _trunk_runs(tile_size) * CFG.n_blocks)


def test_kept_bytes_at_the_papers_stage1_shape():
    # 3 planes x 256 channels x f32 x the ReLU maps' areas: sides 332,
    # 328, ..., 208 (the 200^2 plane padded by 68, less the input conv's
    # 2 and each block's 4)
    area = sum(s * s for s in range(332, 207, -4))
    assert area == 2_376_448
    assert 3 * 256 * 4 * area == 7_300_448_256
    assert ps.edsr_kept_bytes(ps.PlaneSRConfig(), (3, 48, 200, 200),
                              torch.float32) == 7_300_448_256
    assert ps.edsr_kept_bytes(
        ps.PlaneSRConfig(compute_dtype="bfloat16"), (3, 48, 200, 200),
        torch.float32) == 7_300_448_256 // 2


def _saved_relu_bytes(cfg, monkeypatch):
    """The bytes of the ReLU outputs that autograd saves in an
    apply_plane_sr(train=True) forward, read through a saved-tensor pack
    hook (each storage once)."""
    relus = []
    real = torch.relu

    def relu(x):
        y = real(x)
        relus.append(y)       # alive, so no later tensor reuses its memory
        return y

    monkeypatch.setattr(torch, "relu", relu)
    params, _, lr = _sr(cfg)
    saved = []

    def pack(t):
        saved.append(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        ps.apply_plane_sr(params, cfg, lr, train=True)
    monkeypatch.setattr(torch, "relu", real)
    ptrs = {y.data_ptr() for y in relus}
    kept = {t.data_ptr(): t.nbytes for t in saved if t.data_ptr() in ptrs}
    return sum(kept.values()), len(kept)


@pytest.mark.parametrize("compute_dtype,tile_size",
                         [(None, None), ("bfloat16", None), (None, 6)])
def test_kept_bytes_are_what_autograd_saves(compute_dtype, tile_size,
                                            monkeypatch):
    cfg = dataclasses.replace(CFG, compute_dtype=compute_dtype,
                              tile_size=tile_size)
    nbytes, n = _saved_relu_bytes(dataclasses.replace(cfg, remat=False),
                                  monkeypatch)
    assert n == _trunk_runs(tile_size) * CFG.n_blocks
    assert nbytes == ps.edsr_kept_bytes(cfg, LR_SHAPE, torch.float32)
    # the recompute keeps none of them
    assert _saved_relu_bytes(dataclasses.replace(cfg, remat=True),
                             monkeypatch) == (0, 0)


TP = types.SimpleNamespace(model_parallel=2)
NO_TP = types.SimpleNamespace(model_parallel=1)
GB = 10 ** 9


@pytest.mark.parametrize("remat,kept,room,device,mesh,want", [
    # a stated value stands, whatever the room, the device or the mesh
    (True, 1, 80 * GB, "cuda", None, True),
    (True, 1, 80 * GB, "cpu", TP, True),
    (False, 80 * GB, 1, "cuda", None, False),
    (False, 80 * GB, 1, "cpu", TP, False),
    # unstated: keep when the kept bytes are at most half the room
    (None, 7 * GB, 14 * GB, "cuda", None, False),
    (None, 7 * GB + 1, 14 * GB, "cuda", None, True),
    (None, 7 * GB, 14 * GB, "cuda:1", NO_TP, False),
    # unstated: recompute on the CPU and under a tensor-parallel mesh
    (None, 1, 80 * GB, "cpu", None, True),
    (None, 1, 80 * GB, "cuda", TP, True)])
def test_the_decision(remat, kept, room, device, mesh, want):
    cfg = dataclasses.replace(CFG, remat=remat)
    assert ps.edsr_remat(cfg, kept, room, torch.device(device), mesh) is want


@pytest.mark.parametrize("decided", [True, False])
def test_apply_plane_sr_decides_once_a_call_in_training(decided,
                                                        monkeypatch):
    calls = []

    def edsr_remat(cfg, kept_bytes, room, device, mesh=None):
        calls.append((cfg.remat, kept_bytes, room, device.type, mesh))
        return decided

    monkeypatch.setattr(ps, "edsr_remat", edsr_remat)
    assert CFG.remat is None
    _, _, n = _run(CFG)
    kept = ps.edsr_kept_bytes(CFG, LR_SHAPE, torch.float32)
    assert calls == [(None, kept, 0, "cpu", None)]
    assert n == (LR_SHAPE[0] * CFG.n_blocks if decided else 0)
    # eval and no_grad do not ask
    params, _, lr = _sr(CFG)
    ps.apply_plane_sr(params, CFG, lr, train=False)
    with torch.no_grad():
        ps.apply_plane_sr(params, CFG, lr, train=True)
    assert len(calls) == 1


def test_from_cfg_reads_a_stated_remat_and_leaves_an_unstated_one_none():
    def cfg(model):
        return ps.PlaneSRConfig.from_cfg({"model": model}, 4, 48,
                                         "bilinear", True)

    assert cfg({}).remat is None
    assert cfg({"remat": True}).remat is True
    assert cfg({"remat": False}).remat is False


@pytest.mark.parametrize("remat", [None, False])
def test_the_plane_sr_span_counts_the_recomputed_blocks(corpus, remat,
                                                        monkeypatch):
    exp = _stage1(corpus, f"logs/remat_{remat}")
    _only_sr_draws(exp, monkeypatch)
    # unstated: recomputed on the CPU; False: kept
    exp.sr_cfg = dataclasses.replace(exp.sr_cfg, remat=remat)
    _, recs = _profiled(lambda: exp.train_iteration(2))
    inner = exp.sr_params["inner"]
    n_blocks = len(inner["blocks"])
    n_convs = 3 + 2 * n_blocks + len(inner["upscale"])
    sr_rec = next(r for r in recs if r["name"] == "plane_sr")
    assert sr_rec["args"] == {
        "conv_data_grads": 3 * n_convs,
        "recomputed_blocks": 3 * n_blocks if remat is None else 0}
