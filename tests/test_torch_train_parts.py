"""The small parts of the Experiment's training half: nvsr_tpu_torch's
occupancy box, density fn, patch pixels, consistency step, optimizer
states, plane buffer and coverage histograms against their nvsr_tpu
counterparts, on numpy-seeded inputs.

Tolerances, each with its reason:
* estimate_occupied_box on one analytic density field: equal (the same
  lattice rounding, no summation);
* make_density_fn: the same f32 gather and decoder, summed in another
  order: atol 1e-6 (measured 3.0e-8);
* avg_downsample_pixels: f32 means of 9 values in [0, 1] in another
  order, atol 2.5e-7, two ULPs at 1 (measured 6.0e-8); the patch
  choosers: equal (integer indices from the same numpy draws);
* train_step with consistency_iter against JAX's: the tolerances of
  tests/test_torch_train.py's plain-path step, loss rtol 1e-5 and every
  gradient within 2e-5 of its group's largest (measured 1.9e-6);
* ModuleOptimizer.state and the planes' Adam state after the same steps:
  f32 Adam arithmetic in another order, atol 1e-6 (measured 6.0e-8);
  the step counts equal;
* the plane buffer: stepped planes atol 1e-6 as the optimizers
  (measured 2.4e-7 after seven steps); what a
  buffer saves is reloaded bit for bit, Adam leaves included; the redraw
  order, the plane statistics (numpy on the same arrays) and
  jump_start's scene counts equal;
* PlaneCoverage: a copy of JAX's numpy code: equal counts and PNG bytes.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nvsr_tpu import planes_store as jps
from nvsr_tpu import render as jrender
from nvsr_tpu import train as jtrain
from nvsr_tpu.models import triplane as jtri
from nvsr_tpu.ops import occupancy as jocc
from nvsr_tpu.ops import resize as jresize
from nvsr_tpu.utils.coverage import PlaneCoverage as JCoverage
from nvsr_tpu_torch import bridge
from nvsr_tpu_torch import planes_store as tps
from nvsr_tpu_torch import render as trender
from nvsr_tpu_torch import train as ttrain
from nvsr_tpu_torch.models import triplane as ttri
from nvsr_tpu_torch.ops import occupancy as tocc
from nvsr_tpu_torch.ops import resize as tresize
from nvsr_tpu_torch.utils import io as tio
from nvsr_tpu_torch.utils.coverage import PlaneCoverage as TCoverage
from torch_port_helpers import np_decoder, port_cfg, t

JCFG = jtri.TriplaneConfig(dec_channels=16, num_plane_channels=8,
                           dec_density_layers=2, dec_rgb_layers=2,
                           proj_combination="avg",
                           viewdir_proj_combination="concat_pos")
BOX = np.array([[-1.3, -1.1, -0.7, -np.pi, -np.pi / 2],
                [1.2, 1.4, 0.9, np.pi, np.pi / 2]], np.float32)


# --- occupancy and density ---------------------------------------------------

@pytest.mark.parametrize("threshold", [0.2, 0.9, 5.0])
def test_estimate_occupied_box_equal(threshold):
    """An analytic field (a ball off the box's centre): the box where it
    is occupied, and the scene box where nothing is."""
    centre = np.array([0.3, -0.2, 0.1], np.float32)
    box_j = jocc.estimate_occupied_box(
        lambda p: 1.0 - 4.0 * jnp.sum((p - centre) ** 2, -1), BOX, grid=20,
        threshold=threshold, margin=1.0)
    box_t = tocc.estimate_occupied_box(
        lambda p: 1.0 - 4.0 * torch.sum((p - torch.from_numpy(centre)) ** 2,
                                        -1), BOX, grid=20,
        threshold=threshold, margin=1.0)
    np.testing.assert_array_equal(box_t.numpy(), np.asarray(box_j))


def test_make_density_fn_matches_jax(rng):
    params = np_decoder(rng, JCFG)
    pos = rng.standard_normal((3, 8, 12, 12)).astype(np.float32)
    pts = rng.uniform(-1.2, 1.2, (500, 3)).astype(np.float32)
    sj = jtri.make_density_fn(jax.tree.map(jnp.asarray, params), JCFG,
                              jnp.asarray(pos), jnp.asarray(BOX))(
        jnp.asarray(pts))
    st = ttri.make_density_fn(bridge.decoder_from_jax(params, "cpu"),
                              port_cfg(JCFG), t(pos), BOX)(t(pts))
    assert st.shape == (500,) and np.asarray(sj).std() > 1e-2
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0, atol=1e-6)


# --- consistency iterations --------------------------------------------------

def test_avg_downsample_pixels_matches_jax(rng):
    px = rng.uniform(size=(5 * 9, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tresize.avg_downsample_pixels(t(px), 3).numpy(),
        np.asarray(jresize.avg_downsample_pixels(jnp.asarray(px), 3)),
        rtol=0, atol=2.5e-7)


@pytest.mark.parametrize("ds", [2, 4])
def test_patch_choosers_match_jax(ds):
    lr = np.random.default_rng(1).uniform(size=(9, 7, 3))
    out_j = jtrain.choose_patch_pixels(np.random.default_rng(5), lr, 100, ds)
    out_t = ttrain.choose_patch_pixels(np.random.default_rng(5), lr, 100, ds)
    for a, b in zip(out_j, out_t):
        np.testing.assert_array_equal(a, b)
    ro = np.random.default_rng(2).standard_normal((9 * ds, 7 * ds, 3))
    rd = np.random.default_rng(3).standard_normal((9 * ds, 7 * ds, 3))
    sel_j = jtrain.select_patch_rays(np.random.default_rng(5), lr, ro, rd,
                                     100, ds)
    sel_t = ttrain.select_patch_rays(np.random.default_rng(5), lr, t(ro),
                                     t(rd), 100, ds)
    for a, b in zip(sel_j, sel_t):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def test_consistency_step_matches_jax(rng):
    """A consistency iteration: 2x2-ray patches, both passes' rgb
    averaged per patch against the LR target, the loss weighted by
    im_inconsistency_loss_w (not rendering_loss_w)."""
    planes = {"pos": (0.5 * rng.standard_normal((3, 8, 16, 16))
                      ).astype(np.float32),
              "view": (0.5 * rng.standard_normal((8, 6, 6))
                       ).astype(np.float32)}
    params = np_decoder(rng, JCFG)
    params["members"][0]["fc_alpha"]["b"] += 2.0
    dirs = rng.uniform(-0.2, 0.2, (32, 2)).astype(np.float32)
    d = np.concatenate([dirs, -np.ones((32, 1), np.float32)], -1)
    ro = np.broadcast_to(np.array([0.0, 0.0, 1.8], np.float32), (32, 3))
    ro = np.ascontiguousarray(ro)
    target = rng.uniform(size=(8, 3)).astype(np.float32)
    kw = dict(consistency_iter=True, ds_factor=2, share_coarse_fine=True,
              train_sr=False, rendering_loss_w=3.0,
              im_inconsistency_loss_w=0.5)
    rays = jrender.make_ray_bundle(jnp.asarray(ro), jnp.asarray(d), 0.8,
                                   3.2, use_viewdirs=True)
    mj, gj = jtrain.train_step(
        jax.tree.map(jnp.asarray, params), None, None,
        jax.tree.map(jnp.asarray, planes), jnp.asarray(BOX), rays,
        jnp.asarray(target), jax.random.PRNGKey(5), model_cfg=JCFG,
        sr_cfg=None,
        rcfg=jrender.RenderConfig(num_coarse=8, num_fine=8, perturb=False),
        flags=jtrain.StepFlags(**kw))
    mt, gt = ttrain.train_step(
        bridge.decoder_from_jax(params, "cpu"), None, None,
        bridge.planes_from_jax(planes, "cpu"), BOX,
        trender.make_ray_bundle(t(ro), t(d), 0.8, 3.2, use_viewdirs=True),
        t(target), torch.Generator().manual_seed(0),
        model_cfg=port_cfg(JCFG), sr_cfg=None,
        rcfg=trender.RenderConfig(num_coarse=8, num_fine=8, perturb=False),
        flags=ttrain.StepFlags(**kw))
    assert abs(float(mt["loss"]) - float(mj["loss"])) <= 1e-5 * float(
        mj["loss"])
    lj, tree = jax.tree.flatten(jax.tree.map(np.asarray, gj))
    lt = tree.flatten_up_to(jax.tree.map(lambda x: x.numpy(), gt))
    for a, b in zip(lj, lt):
        assert np.abs(a - b).max() <= 2e-5 * (np.abs(a).max() + 1e-8)
    # the weight is im_inconsistency_loss_w: the gradient of 0.5 * loss
    g_full = ttrain.train_step(
        bridge.decoder_from_jax(params, "cpu"), None, None,
        bridge.planes_from_jax(planes, "cpu"), BOX,
        trender.make_ray_bundle(t(ro), t(d), 0.8, 3.2, use_viewdirs=True),
        t(target), torch.Generator().manual_seed(0),
        model_cfg=port_cfg(JCFG), sr_cfg=None,
        rcfg=trender.RenderConfig(num_coarse=8, num_fine=8, perturb=False),
        flags=ttrain.StepFlags(**dict(kw, im_inconsistency_loss_w=1.0)))[1]
    torch.testing.assert_close(gt["planes"]["pos"],
                               0.5 * g_full["planes"]["pos"])


# --- optimizer states --------------------------------------------------------

def _tree(rng):
    return {"dc": np_decoder(rng, JCFG), "df": np_decoder(rng, JCFG)}


def test_module_optimizer_state_matches_optax(rng, tmp_path):
    """ModuleOptimizer.state against optax.adam's after the same three
    steps; a state pickled by the port loads in a plain pickle.load as
    optax's own classes and restores JAX's optimizer; a state of JAX's
    restores the port's, bit for bit."""
    params = _tree(rng)
    grads = [jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(
        np.float32), params) for _ in range(3)]
    jopt = jtrain.ModuleOptimizer(jax.tree.map(jnp.asarray, params), 1e-2)
    topt = ttrain.ModuleOptimizer(bridge.decoder_from_jax(params, "cpu"),
                                  1e-2)
    fresh = topt.state
    assert int(fresh[0].count) == 0 and isinstance(fresh[1], tio.EmptyState)
    for g in grads:
        jopt.accumulate(jax.tree.map(jnp.asarray, g))
        jopt.step()
        topt.accumulate(bridge.decoder_from_jax(g, "cpu"))
        topt.step()
    js = jax.tree.map(np.asarray, jopt.state)
    ts = bridge.optimizer_state_to_jax(topt.state)
    assert int(ts[0].count) == int(js[0].count) == 3
    for a, b in zip(jax.tree.leaves(js[0]), jax.tree.leaves(tuple(ts[0]))):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)

    path = str(tmp_path / "c.ckpt")
    tio.save_pickle(path, {"optimizer": ts}, suffix="ckpt")
    with open(path, "rb") as f:
        loaded = pickle.load(f)["optimizer"]
    assert type(loaded[0]) is type(js[0]) and type(loaded[1]) is type(js[1])
    jopt.state = jax.tree.unflatten(jax.tree.structure(jopt.state),
                                    jax.tree.leaves(loaded))
    for a, b in zip(jax.tree.leaves(jopt.state), jax.tree.leaves(
            tuple(ts[0]))):
        np.testing.assert_array_equal(np.asarray(a), b)

    # JAX's state into a new port optimizer: the same leaves, then the
    # same next step
    topt2 = ttrain.ModuleOptimizer(bridge.decoder_from_jax(
        jax.tree.map(np.asarray, jopt.params), "cpu"), 1e-2)
    topt2.state = js
    for a, b in zip(jax.tree.leaves(js[0]), jax.tree.leaves(tuple(
            bridge.optimizer_state_to_jax(topt2.state)[0]))):
        np.testing.assert_array_equal(b, a)
    with pytest.raises(KeyError):
        topt2.state = (tio.ScaleByAdamState(js[0].count, {"dc": js[0].mu[
            "dc"]}, {"dc": js[0].nu["dc"]}), tio.EmptyState())


# --- the plane buffer --------------------------------------------------------

def _stores(tmp_path, scenes, rng):
    locs = []
    arrays = {}
    for side in ("jax", "port"):
        loc = tmp_path / side
        loc.mkdir()
        locs.append(str(loc))
    for sc in scenes:
        pos = rng.standard_normal((3, 4, 6, 6)).astype(np.float32)
        view = rng.standard_normal((4, 3, 3)).astype(np.float32)
        arrays[sc] = (pos, view)
        for loc in locs:
            for best in (False, True):
                jps.PlaneStore([loc], backend="npz").save(
                    sc, jps.ScenePlanes(jnp.asarray(pos), jnp.asarray(view),
                                        BOX), as_best=best)
    return locs, arrays


def _buffers(locs, scenes, **kw):
    jb = jps.PlanesBuffer(jps.PlaneStore([locs[0]], backend="npz"), scenes,
                          lr=1e-2, rng=np.random.default_rng(3), **kw)
    tb = tps.PlanesBuffer(tps.PlaneStore([locs[1]], backend="npz"), scenes,
                          lr=1e-2, rng=np.random.default_rng(3),
                          device="cpu", **kw)
    return jb, tb


def _assert_scene_close(jb, tb, sc, atol):
    jp, tp = jb.get(sc), tb.get(sc)
    np.testing.assert_allclose(tp.planes_pos.numpy(),
                               np.asarray(jp.planes_pos), rtol=0, atol=atol)
    np.testing.assert_allclose(tp.plane_view.numpy(),
                               np.asarray(jp.plane_view), rtol=0, atol=atol)


def test_planes_buffer_matches_jax(tmp_path, rng):
    """Redraws by the cadence, Adam steps through the buffer with an lr
    change, frozen scenes, save_params (rolling and best) and the
    statistics, against JAX's PlanesBuffer on the same stores."""
    scenes = ["a", "b", "c", "d"]
    locs, _ = _stores(tmp_path, scenes, rng)
    jb, tb = _buffers(locs, scenes, buffer_size=2, steps_per_buffer=3,
                      frozen_scenes=["d"])
    assert jb.draw_scenes() == tb.draw_scenes()
    for step in range(7):
        for sc in jb.cur_scenes:
            g = {"pos": rng.standard_normal((3, 4, 6, 6)).astype(np.float32),
                 "view": rng.standard_normal((4, 3, 3)).astype(np.float32)}
            jb.apply_grads(sc, jax.tree.map(jnp.asarray, g))
            tb.apply_grads(sc, bridge.planes_from_jax(g, "cpu"))
            _assert_scene_close(jb, tb, sc, 1e-6)
        if step == 2:
            jb.set_lr(3e-3)
            tb.set_lr(3e-3)
        new_j, new_t = jb.step_cadence(), tb.step_cadence()
        assert new_j == new_t
        assert sorted(jb.resident) == sorted(tb.resident)
    assert tb.lr == 3e-3
    # frozen: never stepped, never dirty
    if "d" in tb.resident:
        assert "d" not in tb.dirty
    jb.save_params()
    tb.save_params()
    jb.save_params(as_best=True)
    tb.save_params(as_best=True)
    for sc in ("a", "b", "c"):
        for best in (False, True):
            pj, sj = jb.store.load(sc, prefer_best=best,
                                   opt_state_template=jb._opt_template(sc))
            pt, st = tb.store.load(sc, prefer_best=best, with_opt_state=True)
            np.testing.assert_allclose(pt.planes_pos.numpy(),
                                       np.asarray(pj.planes_pos), atol=1e-6)
            lj = [np.asarray(x) for x in jax.tree.leaves(sj)]
            lt = [np.asarray(x) for x in st.leaves()]
            assert len(lj) == len(lt) == 11
            for a, b in zip(lj, lt):
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
    sj, st = jb.get_plane_stats(viewdir=True), tb.get_plane_stats(
        viewdir=True)
    for k in ("mean", "std"):
        np.testing.assert_allclose(st[k], np.asarray(sj[k]), atol=1e-6)


def test_planes_buffer_reloads_what_it_saved(tmp_path, rng):
    """A scene saved after Adam steps loads back into a new buffer with
    its planes and every Adam leaf bit-equal, and saved again without a
    step it writes the same leaves (both backends)."""
    for backend in ("npz", "native"):
        loc = tmp_path / backend
        loc.mkdir()
        store = tps.PlaneStore([str(loc)], backend=backend)
        store.save("s", tps.ScenePlanes(t(rng.standard_normal(
            (3, 4, 6, 6)).astype(np.float32)), t(rng.standard_normal(
                (4, 3, 3)).astype(np.float32)), BOX))
        buf = tps.PlanesBuffer(store, ["s"], lr=1e-2, device="cpu",
                               rng=np.random.default_rng(0))
        buf.draw_scenes()
        for _ in range(2):
            buf.apply_grads("s", {"pos": torch.ones(3, 4, 6, 6),
                                  "view": -torch.ones(4, 3, 3)})
        buf.save_params()
        saved = [np.asarray(tio_leaf) for tio_leaf in
                 store.load("s", with_opt_state=True)[1].leaves()]
        buf2 = tps.PlanesBuffer(store, ["s"], lr=1e-2, device="cpu",
                                rng=np.random.default_rng(0))
        buf2.draw_scenes()
        torch.testing.assert_close(buf2.get("s").planes_pos,
                                   buf.get("s").planes_pos, rtol=0, atol=0)
        again = [np.asarray(x.numpy() if torch.is_tensor(x) else x)
                 for x in buf2.opt.state("s").leaves()]
        for a, b in zip(saved, again):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
        assert int(np.asarray(saved[0]).reshape(-1)[0]) == 2


def test_jump_start_matches_jax(tmp_path, rng):
    scenes = ["a", "b", "c", "d", "e"]
    locs, _ = _stores(tmp_path, scenes, rng)
    jb, tb = _buffers(locs, scenes, buffer_size=2, steps_per_buffer=2)
    jb.draw_scenes()
    tb.draw_scenes()
    assert jb.jump_start((0.5,), on=True) == tb.jump_start((0.5,), on=True)
    assert tb.steps_per_buffer == -1
    assert jb.jump_start(on=False) == tb.jump_start(on=False)
    assert tb.steps_per_buffer == 2 and sorted(tb.resident) == sorted(
        jb.resident)


# --- coverage ----------------------------------------------------------------

def test_plane_coverage_matches_jax(rng, tmp_path):
    names = ["coarse_a_0", "coarse_a_1"]
    cj, ct = JCoverage(names, logging_res=32), TCoverage(names,
                                                         logging_res=32)
    for _ in range(3):
        grid = rng.uniform(-1.2, 1.2, (200, 2)).astype(np.float32)
        for c in (cj, ct):
            c.update("coarse_a_0", grid)
            c.update("unknown", grid)
    np.testing.assert_array_equal(ct.counts["coarse_a_0"],
                                  cj.counts["coarse_a_0"])
    pj = cj.save(str(tmp_path / "jax"))
    pt = ct.save(str(tmp_path / "port"))
    assert [os.path.basename(p) for p in pt] == [os.path.basename(p)
                                                 for p in pj]
    for a, b in zip(pj, pt):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
