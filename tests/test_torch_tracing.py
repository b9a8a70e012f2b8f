"""The port's spans (nvsr_tpu_torch/utils/tracing.py) on the CPU, at the
tiny sizes of tests/test_torch_experiment_train.py: a no-op without a
profiler; under one, one `train_iteration` root a training iteration
with its phases as children, the same spans in the profiler's Chrome
trace on the records' clock, no change to any number the iteration
computes, a capped list; and the benchmark's per-phase metrics in a tiny
traced rehearsal of each training cell (gpubench/spans.py)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from helpers_synth import write_blender_scene
from nvsr_tpu_torch import experiment as texp
from nvsr_tpu_torch.experiment import Experiment
from nvsr_tpu_torch.utils import tracing
from test_experiment import _mini_cfg
from test_torch_experiment_baseline import _baseline_cfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGE1 = {"4,8,8": ["lego", "ship"], "2,16,8": ["lego", "ship"]}
PHASES = ("input", "forward", "backward", "optimizer")
CELLS = {"mipnerf_baseline.train": "train",
         "trainmodels.train_stage1": "stage1"}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("tracing_corpus")
    for name in ("lego", "ship"):
        write_blender_scene(str(root / "synt"), name, size=32)
    return root


def _stage1(corpus, logdir):
    exp = Experiment(_mini_cfg(corpus, logdir=logdir, train_groups=STAGE1,
                               iters=6),
                     root_path=str(corpus), device="cpu")
    exp.planes_buffer.draw_scenes()
    exp._update_active_scenes()
    return exp


def _baseline(corpus, logdir):
    exp = Experiment(_baseline_cfg(corpus, logdir), root_path=str(corpus),
                     device="cpu")
    exp._update_active_scenes()
    return exp


def _profiled(fn):
    """fn() under a CPU profiler, from an empty span list -> (profiler,
    records)."""
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof, tracing.records()


def _only_sr_draws(exp, monkeypatch):
    real = exp.image_sampler.sample

    def sample():
        while True:
            scene, img = real()
            if scene in exp.scene_coupler.downsample_couples:
                return scene, img

    monkeypatch.setattr(exp.image_sampler, "sample", sample)


def _children(recs, index):
    return [r["name"] for r in recs if r["parent"] == index]


def test_without_a_profiler_a_span_is_the_shared_noop(corpus):
    tracing.clear()
    assert tracing.span("input") is tracing.span("forward", iteration=3)
    with tracing.span("input") as s:
        s.set(kind="lr")
    exp = _stage1(corpus, "logs/off")
    exp.train_iteration(0)
    assert tracing.records() == [] and tracing.dropped() == 0


def test_an_iteration_records_one_root_and_its_phases(corpus, monkeypatch):
    base = _baseline(corpus, "logs/base_on")
    _, recs = _profiled(lambda: base.train_iteration(7))
    roots = [r for r in recs if r["name"] == "train_iteration"]
    assert len(roots) == 1 and roots[0]["parent"] is None
    root = roots[0]["index"]
    assert roots[0]["args"]["iteration"] == 7
    kind = roots[0]["args"]["kind"]
    assert kind in ("lr", "consistency")
    assert _children(recs, root) == ["input", "forward", "backward",
                                     "optimizer"]
    forward = next(r["index"] for r in recs if r["name"] == "forward")
    assert _children(recs, forward) == ["render.coarse", "render.fine"] + (
        ["consistency_loss"] if kind == "consistency" else [])
    assert all(r["iteration"] == 7 for r in recs)

    exp = _stage1(corpus, "logs/sr_on")
    _only_sr_draws(exp, monkeypatch)
    _, recs = _profiled(lambda: exp.train_iteration(2))
    roots = [r for r in recs if r["name"] == "train_iteration"]
    assert len(roots) == 1 and roots[0]["args"] == {"iteration": 2,
                                                     "kind": "sr"}
    root = roots[0]["index"]
    assert _children(recs, root) == ["input", "occupancy", "input",
                                     "forward", "backward", "optimizer"]
    forward = next(r["index"] for r in recs if r["name"] == "forward")
    assert _children(recs, forward) == ["plane_sr", "render.coarse",
                                        "render.fine"]
    # every conv of the EDSR takes one data gradient per plane (the
    # three LR planes are trained through it), and on the CPU every
    # residual block of every plane is recomputed in the backward
    inner = exp.sr_params["inner"]
    n_convs = 3 + 2 * len(inner["blocks"]) + len(inner["upscale"])
    sr_rec = next(r for r in recs if r["name"] == "plane_sr")
    assert sr_rec["args"] == {"conv_data_grads": 3 * n_convs,
                              "recomputed_blocks": 3 * len(inner["blocks"])}
    assert all(r["iteration"] == 2 for r in recs)
    for r in recs:
        assert r["start_ns"] <= r["end_ns"]
        assert r["ms"] == pytest.approx((r["end_ns"] - r["start_ns"]) * 1e-6)
    # the phases follow one another inside the root
    phases = [r for r in recs if r["parent"] == root]
    assert all(a["end_ns"] <= b["start_ns"]
               for a, b in zip(phases, phases[1:]))
    assert phases[0]["start_ns"] >= roots[0]["start_ns"]
    assert phases[-1]["end_ns"] <= roots[0]["end_ns"]


def test_the_chrome_trace_holds_the_same_spans(corpus, monkeypatch,
                                               tmp_path):
    exp = _stage1(corpus, "logs/chrome")
    _only_sr_draws(exp, monkeypatch)

    def two():
        exp.train_iteration(0)
        exp.train_iteration(1)

    prof, recs = _profiled(two)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base_us = trace["baseTimeNanoseconds"] / 1e3
    events = sorted((e for e in trace["traceEvents"]
                     if e.get("ph") == "X"
                     and e.get("cat") == "user_annotation"
                     and e["name"].startswith(tracing.PREFIX)),
                    key=lambda e: e["ts"])
    assert [e["name"] for e in events] == [tracing.PREFIX + r["name"]
                                           for r in recs]
    for i, (e, r) in enumerate(zip(events, recs)):
        assert abs(e["ts"] + base_us - r["start_ns"] / 1e3) < 1000.0
        # the innermost earlier event that encloses this one
        outer = [j for j in range(i) if events[j]["ts"] <= e["ts"]
                 and e["ts"] + e["dur"] <= events[j]["ts"]
                 + events[j]["dur"]]
        assert (outer[-1] if outer else None) == r["parent"], r


def _leaf_tensors(exp):
    leaves = []

    def walk(tree):
        if isinstance(tree, dict):
            for k in sorted(tree):
                walk(tree[k])
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                walk(v)
        elif torch.is_tensor(tree):
            leaves.append(tree.detach().clone())

    walk(exp.decoder_opt.params)
    walk(exp.sr_opt.params)
    for s in sorted(exp.planes_buffer.resident):
        walk(exp.planes_buffer.resident[s].params())
    return leaves


def test_the_spans_change_no_number(corpus, monkeypatch):
    """Two iterations with the profiler on and two with it off, from the
    same config: the losses, the gradients of each step and the
    parameters after them are bit-equal."""
    grads = []
    real = texp.train_step

    def keep(*a, **kw):
        metrics, g = real(*a, **kw)
        grads[-1].append([x.clone() for x in
                          torch.utils._pytree.tree_leaves(g)])
        return metrics, g

    monkeypatch.setattr(texp, "train_step", keep)
    runs = []
    for on in (True, False):
        exp = _stage1(corpus, f"logs/bits_{on}")
        grads.append([])

        def two():
            exp.train_iteration(0)
            exp.train_iteration(1)

        if on:
            _, recs = _profiled(two)
            assert sum(r["name"] == "train_iteration" for r in recs) == 2
        else:
            tracing.clear()
            two()
            assert tracing.records() == []
        losses = [m[3].clone() for m in exp._pending_metrics]
        runs.append((losses, grads[-1], _leaf_tensors(exp)))
    (l_on, g_on, p_on), (l_off, g_off, p_off) = runs
    assert len(g_on) == len(g_off) == 2
    for a, b in zip(l_on + sum(g_on, []) + p_on,
                    l_off + sum(g_off, []) + p_off):
        assert torch.equal(a, b)


def test_the_cap_drops_records_and_counts_them(monkeypatch):
    monkeypatch.setattr(tracing, "CAP", 3)

    def five():
        with tracing.span("train_iteration", iteration=0):
            for _ in range(4):
                with tracing.span("input"):
                    torch.ones(2).sum()

    _, recs = _profiled(five)
    assert [r["name"] for r in recs] == ["train_iteration", "input",
                                         "input"]
    assert tracing.dropped() == 2
    tracing.clear()
    assert tracing.records() == [] and tracing.dropped() == 0


def test_a_traced_rehearsal_of_each_cell_reports_the_phases():
    """Each training cell at the benchmark's tiny CPU sizes
    (gpubench/tests), --trace 1 with the profiled iterations first in the
    window (so a slow host cannot end the window before them), in a
    process without JAX (the harness refuses to report in one that loaded
    it): the four phase metrics of the cell, each positive, and over the
    traced iterations no more than the traced window."""
    tests = os.path.join(ROOT, "gpubench", "tests",
                         "test_gpubench_harness.py")
    script = (
        "import importlib.util, json, sys, torch\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "spec = importlib.util.spec_from_file_location('gpubench_harness_"
        f"tests', {tests!r})\n"
        "m = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(m)\n"
        "from gpubench import harness, run\n"
        "from nvsr_tpu_torch.utils import tracing\n"
        f"for cell in {sorted(CELLS)!r}:\n"
        "    tracing.clear()\n"
        "    ctx = harness.Context(cell, 1234567891011, 0.3, 1,\n"
        "                          torch.device('cpu'),\n"
        "                          overrides=dict(m.TINY[cell], trace_skip=0))\n"
        "    out = run.measure(ctx, 1, 'cpu')\n"
        "    print(json.dumps({'cell': cell, 'out': out,\n"
        "                      'traced': len(ctx.work['traced'])}))\n")
    p = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    lines = [json.loads(x) for x in p.stdout.splitlines()
             if x.startswith("{")]
    assert sorted(x["cell"] for x in lines) == sorted(CELLS)
    for x in lines:
        out, n = x["out"], x["traced"]
        assert out["correct"], out["checks"]
        names = [f"{ph}_ms.{CELLS[x['cell']]}" for ph in PHASES]
        values = [out["metrics"][k]["value"] for k in names]
        assert all(v > 0 for v in values), dict(zip(names, values))
        assert n > 0
        assert np.sum(values) * n * 1e-3 <= out["device"]["window_s"]
