"""The harness on the CPU: every cell end to end at small shapes, the
refusal without a card, finding a new cell, configuration and metric by
name alone, and the modules a run loads."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import harness

ROOT = harness.ROOT
SPEC = harness.benchmark_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_and_is_correct_at_small_shapes(name, small_run):
    ctx, out, line = small_run(name)
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
    assert set(line["checks"]) == set(ctx.limits)
    e2e = {m["name"] for m in harness.metrics_of(SPEC, name, "end_to_end")}
    assert set(line["metrics"]) == e2e
    assert all(v["value"] > 0 for v in line["metrics"].values())


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reports_every_per_layer_metric(name, small_run):
    _, _, line = small_run(name, trace=True)
    assert line["correct"], line["checks"]
    want = {m["name"] for m in harness.metrics_of(SPEC, name, "per_layer")}
    # kernel rooflines and device memory need the card; the CPU run has neither
    want -= {m for m in want if m.endswith("_roofline") or m.startswith("peak_mem")}
    assert want <= set(line["metrics"])
    assert 0 < len(line["breakdown"]["idle_gaps"]) <= 10
    assert line["device"]["window_s"] > 0


def test_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0],
                           "--seed", "1", "--seconds", "1", "--trace", "1"],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_a_new_cell_config_and_metric_are_found_by_name(tmp_path):
    """A later change adds a cell as files and entries only."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name in ("sdirt_tpu_torch", "lenses"):
        os.symlink(os.path.join(ROOT, name), root / name)
    bench = root / "benchmark"
    cfg = json.loads((bench / "configs" / "rf50mm_f4_mlp512.json").read_text())
    cfg.update(name="dummy_cfg", res=[32, 48], bs=2)
    (bench / "configs" / "dummy_cfg.json").write_text(json.dumps(cfg))
    traffic = json.loads((bench / "traffic" / "render.json").read_text())
    traffic.update(scene_pool=2, check_span=2, check_batches=1, warm_batches=1,
                   profile_first=0, profile_steps=1)
    (bench / "traffic" / "dummy_mix.json").write_text(json.dumps(traffic))
    (bench / "limits" / "dummy.cell.json").write_text(
        (bench / "limits" / "rf50_mlp.render.json").read_text())
    (bench / "metrics" / "dummy_steps.py").write_text(
        "def read(rec):\n    return float(rec['n_steps'])\n")
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append({"name": "dummy_cfg", "source": "x", "file":
                            "benchmark/configs/dummy_cfg.json", "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "dummy.cell", "config": "dummy_cfg",
                              "traffic": "dummy_mix", "chips": 1, "why": "x"})
    spec["per_layer"].append({"name": "dummy_steps", "unit": "steps", "better": "higher",
                              "source": "host_clock", "layer": "x",
                              "moves": "render_pairs_per_s", "workloads": ["dummy.cell"]})
    for m in spec["end_to_end"]:
        if "workloads" in m and "rf50_mlp.render" in m["workloads"]:
            m["workloads"].append("dummy.cell")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(root)!r})\n"
        "from benchmark import harness\n"
        "spec = harness.benchmark_spec()\n"
        "ctx = harness.make_context(harness.find_workload(spec, 'dummy.cell'), 5, 'cpu')\n"
        "out = harness.run_loop(ctx, 0.0, True, until_step=3)\n"
        "print(json.dumps(harness.result_line(ctx, out, True, spec)))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["metrics"]["dummy_steps"]["value"] == 3.0
    assert "mfu.render" not in line["metrics"]   # listed for other cells only


def test_a_run_loads_no_jax_and_no_jax_package():
    """The top-level names of every module a small run of each cell loads,
    the reference's included, compared whole: sdirt_tpu_torch is allowed,
    sdirt_tpu is not."""
    code = (
        "import sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        f"sys.path.insert(0, {os.path.dirname(os.path.abspath(__file__))!r})\n"
        "from conftest import _small_run\n"
        "from benchmark import harness, calibrate\n"
        f"for name in {CELLS!r}:\n"
        "    _small_run(name, trace=True)\n"
        "assert 'sdirt_tpu_torch' in sys.modules\n"
        "print(harness.banned_modules())\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_banned_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "sdirt_tpu_torch_like", sys)
    assert harness.banned_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.banned_modules() == ["jax"]
