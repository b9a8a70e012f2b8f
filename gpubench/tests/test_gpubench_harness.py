"""The benchmark's harness on the CPU: BENCHMARK.json against its
format, every entry resolved to its files by name, a cell and
a metric added as files and entries alone, the import check, and a tiny
rehearsal of each traffic driver. Run: python -m pytest gpubench/tests."""

import ast
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from gpubench import harness, run  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
# tiny CPU sizes of each cell
TINY = {
    "mipnerf_baseline.train": {
        "image": 32, "views": {"train": 3, "val": 2, "test": 1},
        "trace_skip": 4, "trace_iters": 4,
        "config": {"nerf.train.num_random_rays": 32,
                   "models.coarse.hidden_size": 32,
                   "nerf.train.num_coarse": 8, "nerf.train.num_fine": 8}},
    "trainmodels.train_stage1": {
        "image": 32, "views": {"train": 3, "val": 2, "test": 1},
        "trace_skip": 4, "trace_iters": 4,
        "config": {"dataset.dir.train": {"8,8,4": ["lego", "ship"],
                                         "2,32,4": ["lego", "ship"]},
                   "models.coarse.dec_channels": 16,
                   "super_resolution.model.hidden_size": 8,
                   "super_resolution.model.n_blocks": 1,
                   "nerf.train.num_random_rays": 32,
                   "nerf.train.num_coarse": 8, "nerf.train.num_fine": 8}},
}


def tiny_run(cell, seed=1234567891011, trace=0, seconds=0.3, root=ROOT,
             sizes=None):
    ctx = harness.Context(cell, seed, seconds, trace, torch.device("cpu"),
                          root=root, overrides=TINY[sizes or cell])
    return ctx, run.measure(ctx, 1, "cpu")


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"][:2] == ["python3", "gpubench/run.py"]
    assert SPEC["paths"] == ["gpubench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert len(SPEC["workloads"]) <= 24


def test_names_units_and_keys(spec=SPEC):
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source",
                           "workloads"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}}
    names = []
    for group, allowed in keys.items():
        for e in spec[group]:
            assert set(e) <= allowed, (group, e)
            assert NAME.match(e["name"]), e["name"]
            names.append(e["name"])
            for k in ("why", "layer", "source"):
                if k in e:
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    metric_names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    for w in spec["workloads"]:
        assert NAME.match(w["config"])
        assert NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
    for c in spec["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])


def test_every_entry_resolves_by_name(spec=SPEC):
    for w in spec["workloads"]:
        files = harness.cell_files(spec, w["name"])
        for kind, path in files.items():
            assert path.is_file(), (w["name"], kind, path)
        assert harness.load_driver(json.loads(files["traffic"].read_text())
                                   ["driver"]).run
        ends = harness.metrics_for(spec, w["name"], 0)
        assert "setup_s" in [m["name"] for m in ends] and len(ends) >= 2
        assert harness.metrics_for(spec, w["name"], 1)
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(harness.load_metric(m["name"]).read), m["name"]
    for m in spec["per_layer"]:
        # each cell a per-layer metric names reports the metric it moves
        for w in m.get("workloads", [x["name"] for x in spec["workloads"]]):
            assert m["moves"] in [e["name"] for e in
                                  harness.metrics_for(spec, w, 0)], (m, w)
    for c in spec["configs"]:
        assert (ROOT / c["file"]).is_file()


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module


def test_no_module_imports_jax_or_the_jax_package():
    for path in (ROOT / "gpubench").rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "nvsr_tpu"}, path
        if "reference" in path.parts:
            assert "nvsr_tpu_torch" not in tops, path


def test_forbidden_modules_compare_whole_top_level_names():
    mods = {"jax.numpy": 1, "nvsr_tpu_torch.render": 1, "nvsr_tpu.ops": 1,
            "flaxish": 1, "jaxlib": 1}
    assert harness.forbidden_modules(mods) == ["jax.numpy", "jaxlib",
                                               "nvsr_tpu.ops"]


def _no_result(cwd):
    p = subprocess.run(
        SPEC["command"] + ["--workload", SPEC["workloads"][0]["name"],
                           "--seed", "5", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300)
    return p.returncode != 0 and p.stdout.strip() == ""


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("checks a machine without a card")
    assert _no_result(ROOT)


def test_only_the_benchmark_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and gpubench/ (no
    program), the command exits non-zero with no result, card or not."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    assert _no_result(tmp_path)


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_rehearsal_of_each_cell(cell, trace):
    ctx, out = tiny_run(cell, trace=trace)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    names = {m["name"] for m in harness.metrics_for(ctx.spec, cell, trace)}
    assert set(out["metrics"]) <= names
    if not trace:
        # the host-clock metrics exist on any device
        assert set(out["metrics"]) == names
    for v in out["checks"].values():
        assert v["value"] <= v["limit"]
    # the window is whole rounds of the mix, so every seed does the
    # same work
    assert ctx.record["iterations"] % len(ctx.record["round"]) == 0


def test_a_cell_and_a_metric_added_as_files_and_entries(tmp_path):
    """A new traffic mix, its limits, a new per-layer metric and their
    BENCHMARK.json entries run with no file of the harness edited."""
    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads(json.dumps(SPEC))
    g = tmp_path / "gpubench"
    mix = json.loads((g / "traffic" / "train_stage1.json").read_text())
    mix["density_bias"] = 0.5
    (g / "traffic" / "train_dim.json").write_text(json.dumps(mix))
    shutil.copy(g / "limits" / "trainmodels.train_stage1.json",
                g / "limits" / "trainmodels.train_dim.json")
    (g / "metrics" / "iterations_in_window.py").write_text(
        "def read(ctx):\n    return ctx.record.get('iterations')\n")
    spec["workloads"].append({"name": "trainmodels.train_dim",
                              "config": "trainmodels",
                              "traffic": "train_dim", "chips": 1,
                              "why": "a dimmer random field"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "trainmodels.train_stage1" in m.get("workloads", ()):
            m["workloads"].append("trainmodels.train_dim")
    spec["per_layer"].append({"name": "iterations_in_window",
                              "unit": "count", "better": "higher",
                              "source": "host_clock",
                              "layer": "training iteration",
                              "moves": "train_iter_ms.stage1",
                              "workloads": ["trainmodels.train_dim"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    script = (
        "import json, sys, torch\n"
        f"sys.path[:0] = [{str(tmp_path)!r}, {str(ROOT)!r}]\n"
        "from gpubench import harness, run\n"
        f"ov = {TINY['trainmodels.train_stage1']!r}\n"
        "ctx = harness.Context('trainmodels.train_dim', 77, 0.3, 1,"
        " torch.device('cpu'), overrides=ov)\n"
        "print(json.dumps(run.measure(ctx, 1, 'cpu')))\n")
    p = subprocess.run([sys.executable, "-c", script], cwd=tmp_path,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["metrics"]["iterations_in_window"]["value"] >= 4


def test_kernels_are_attributed_to_the_operator_that_launched_them():
    from gpubench import trace
    ev = [{"ph": "X", "cat": "cpu_op", "name": "aten::cudnn_convolution",
           "ts": 0, "dur": 50, "args": {"External id": 7}},
          {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 60,
           "dur": 10, "args": {"External id": 8}},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
           "ts": 10, "dur": 2, "args": {"External id": 7, "correlation": 1}},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
           "ts": 62, "dur": 2, "args": {"External id": 8, "correlation": 2}},
          {"ph": "X", "cat": "kernel", "name": "fft2d_r2c", "ts": 20,
           "dur": 30, "args": {"correlation": 1}},
          {"ph": "X", "cat": "kernel", "name": "sgemm", "ts": 70, "dur": 5,
           "args": {"External id": 8, "correlation": 2}}]
    red = trace.Reduced(ev)
    assert red.launched_by == ["aten::cudnn_convolution", "aten::mm"]
    secs, n = red.op_kernel_time(lambda op: "conv" in op)
    assert n == 1 and abs(secs - 30e-6) < 1e-12
    assert abs(red.busy_s - 35e-6) < 1e-12
