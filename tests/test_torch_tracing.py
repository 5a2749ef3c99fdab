"""The port's tracer (sdirt_tpu_torch/utils/trace.py) on the CPU: off by
default and outside a profiler, the render unchanged by it, the spans'
nesting, request ids and self times under ``torch.profiler`` and in its
Chrome trace, the DataLoader's counters, spans on other threads, what
``snapshot()`` hands the benchmark's readers, and one session per
profiler run.

Sizes are the smallest the render takes: N 2, 16x24, ks 7, nets of width
32; the train step runs a one-layer stand-in for DDDNet.
"""

import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness
from sdirt_tpu_torch import dfdp_net
from sdirt_tpu_torch.dfdp.datasets import DataLoader
from sdirt_tpu_torch.dfdp.train import create_dfdp_state, dfdp_train_step
from sdirt_tpu_torch.dp import fused_trace
from sdirt_tpu_torch.psfnet.arch import build_psfnet
from sdirt_tpu_torch.render import dense_bf16, fused_conv
from sdirt_tpu_torch.render.pipeline import render_dp
from sdirt_tpu_torch.utils import trace

KS = 7
N, H, W = 2, 16, 24
RENDER_KW = dict(d_sensor=62.25, d_min=-200.0, d_max=-20000.0, ks=KS)
NETS = {"fused": "mlp@32", "scan": "mlp@32", "basis": "mlpb@32x8"}
RENDER_SPANS = ("render.psf_mlp", "render.dp_conv", "render.camera")
READERS = ("psf_mlp_ms.render", "dp_conv_ms.render", "render_prep_host_ms.train",
           "host_stall_ms.train", "loader_cpu_ms.train")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _tracer_off():
    """Each test starts and ends with the tracer off."""
    trace.disable()
    yield
    trace.disable()


def _net(variant):
    torch.manual_seed(0)
    net = build_psfnet(NETS[variant], KS).eval()
    for layer in net.layers():
        layer.reset_parameters()
    # a fitted net's PSF taps are positive, with no large cancelling mass
    last = net.layers()[-1]
    with torch.no_grad():
        last.weight.abs_()
        last.bias.add_(0.2)
    return net


class _Lens:
    """What dfdp_net._render_batch reads of a lens: its device and render."""

    device = torch.device("cpu")

    def __init__(self, variant):
        self.variant, self.net = variant, _net(variant)

    def render(self, img, depth, foc_dist, train=False, generator=None):
        return render_dp(self.net, img, depth, foc_dist, variant=self.variant,
                         train=train, generator=generator, **RENDER_KW)


def _scene(seed=0):
    rng = np.random.default_rng(seed)
    aif = rng.uniform(0, 1, (N, 3, H, W)).astype(np.float32)
    depth = rng.uniform(0.3, 10.0, (N, 1, H, W)).astype(np.float32)
    return aif, depth


def _render(variant, lens=None):
    aif, depth = _scene()
    gen = torch.Generator().manual_seed(3)
    return dfdp_net._render_batch(lens or _Lens(variant), aif, depth, gen,
                                  train=True)


class _DepthNet(torch.nn.Module):
    """A one-layer stand-in for DDDNet: what dfdp_grads reads of a net."""

    train_mode = "dfdp"

    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(6, 1, 3, padding=1)

    def forward(self, x):
        return {"pred_depth_est": self.conv(x)}


class _Scenes:
    """A dataset of numbered arrays, each made from its index and rng."""

    def __len__(self):
        return 10

    def __getitem__(self, j, rng=None):
        return np.full((2, 3), j, np.float32), rng.uniform(0, 1, (4,))


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof


def test_off_by_default_and_outside_a_profiler():
    before = trace.snapshot()
    assert not trace.on()
    _render("fused")
    render_dp(_net("fused"), torch.rand(1, 3, H, W), -torch.rand(1, 1, H, W) * 1e3,
              None, variant="fused", **RENDER_KW)
    list(DataLoader(_Scenes(), batch_size=2, num_workers=2))
    assert trace.snapshot() == before


@pytest.mark.parametrize("variant", ["fused", "basis", "scan"])
def test_render_is_bit_equal_with_tracing_on(variant):
    lens = _Lens(variant)
    off = _render(variant, lens)
    trace.enable()
    on = _render(variant, lens)
    trace.disable()
    assert torch.isfinite(off[0]).all()
    for a, b in zip(off, on):
        assert torch.equal(a, b)
    spans = trace.snapshot()["spans"]
    assert {"render.prep", "render", *RENDER_SPANS} <= set(spans)


@pytest.mark.parametrize("variant", ["fused", "basis", "scan"])
def test_spans_nest_under_the_profiler(variant, tmp_path):
    lens = _Lens(variant)
    state = create_dfdp_state(_DepthNet(), 1e-4, 10)

    def step():
        stack, depth, _ = _render(variant, lens)
        dfdp_train_step(state, stack, depth)

    prof = _profiled(step)
    snap = trace.snapshot()
    recs = snap["records"]
    by_name = {r["name"]: r for r in recs}
    assert sorted(by_name) == sorted(
        ["render.prep", "render", *RENDER_SPANS, "train_step", "train_step.grads",
         "train_step.update"])
    assert len(recs) == len(by_name)
    parents = {"render.prep": None, "render": None, "train_step": None,
               **{n: "render" for n in RENDER_SPANS},
               "train_step.grads": "train_step", "train_step.update": "train_step"}
    for name, parent in parents.items():
        r = by_name[name]
        want = None if parent is None else by_name[parent]["id"]
        assert r["parent"] == want, name
        assert r["root"] == (r["id"] if parent is None else by_name[parent]["root"])
    # children lie inside their parent; self time is the parent's less theirs
    for name in ("render", "train_step"):
        r = by_name[name]
        kids = [k for k in recs if k["parent"] == r["id"]]
        assert all(r["start_ns"] <= k["start_ns"] <= k["end_ns"] <= r["end_ns"]
                   for k in kids)
        covered = sum(k["end_ns"] - k["start_ns"] for k in kids) / 1e6
        assert r["self_ms"] == pytest.approx(r["wall_ms"] - covered, abs=1e-6)
    for r in recs:
        assert r["device_ms"] == r["wall_ms"]        # the CPU: host wall time
        assert 0 <= r["cpu_ms"] and r["self_ms"] <= r["wall_ms"]
        row = snap["spans"][r["name"]]
        assert row["count"] == 1 and row["self_ms"] == r["self_ms"]
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    notes = {e["name"] for e in json.loads(path.read_text())["traceEvents"]
             if e.get("cat") == "user_annotation"}
    assert set(by_name) <= notes


def test_loader_counts_each_batch_and_keeps_its_batches():
    def batches():
        return list(DataLoader(_Scenes(), batch_size=3, shuffle=True, num_workers=3,
                               seed=5))

    off = batches()
    trace.enable()
    on = batches()
    trace.disable()
    assert len(on) == len(off) == 4
    for a, b in zip(off, on):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    snap = trace.snapshot()
    assert snap["counters"]["loader.batches"] == 4
    assert snap["counters"]["loader.work_wall_s"] > 0
    assert snap["counters"]["loader.work_cpu_s"] >= 0
    assert snap["spans"]["loader.wait"]["count"] == 4
    assert all(r["parent"] is None for r in snap["records"])


def test_spans_on_other_threads_keep_their_own_stack():
    trace.enable()
    inner = []

    def work():
        with trace.span("worker") as s:
            with trace.span("worker.inner") as t:
                inner.append((s, t))

    with trace.span("main") as main:
        thread = threading.Thread(target=work)
        thread.start()
        thread.join(timeout=30)
        assert not thread.is_alive()
        with trace.span("main.child") as child:
            pass
    (worker, worker_inner), = inner
    assert worker.parent is None and worker.root == worker.id
    assert worker_inner.parent == worker.id and worker_inner.root == worker.id
    assert child.parent == main.id and child.root == main.id
    assert worker.thread != main.thread
    counts = {k: v["count"] for k, v in trace.snapshot()["spans"].items()}
    assert counts == {"main": 1, "main.child": 1, "worker": 1, "worker.inner": 1}


def test_snapshot_feeds_the_readers_and_keeps_the_launch_counters():
    loader = iter(DataLoader(_Scenes(), batch_size=2, num_workers=2))
    state = create_dfdp_state(_DepthNet(), 1e-4, 10)
    lens = _Lens("fused")

    def step():
        next(loader)
        stack, depth, _ = _render("fused", lens)
        dfdp_train_step(state, stack, depth)

    _profiled(step)
    snap = trace.snapshot()
    assert snap["launches"] == {"k1": fused_trace.launches, "k2": fused_conv.launches,
                                "k3": dense_bf16.launches}
    assert set(snap["counters"]) == {"loader.batches", "loader.work_wall_s",
                                     "loader.work_cpu_s"}
    for row in snap["spans"].values():
        assert set(row) == {"count", "wall_ms", "cpu_ms", "device_ms", "self_ms"}
    values = {}
    for name in READERS:
        loop = name.rsplit(".", 1)[1]
        values[name] = harness.load_reader(name).read(
            {"loop": loop, "profile": {"steps": 1}})
    assert all(v is not None and v >= 0 for v in values.values()), values
    assert values["psf_mlp_ms.render"] == snap["spans"]["render.psf_mlp"]["device_ms"]


def test_each_profiler_run_is_a_session_of_its_own():
    lens = _Lens("fused")
    _profiled(lambda: [_render("fused", lens) for _ in range(2)])
    first = trace.snapshot()
    assert first["spans"]["render"]["count"] == 2
    _render("fused", lens)                           # off: recorded nowhere
    _profiled(lambda: _render("fused", lens))
    second = trace.snapshot()
    assert second["session"] == first["session"] + 1
    assert second["spans"]["render"]["count"] == 1
    assert {r["id"] for r in second["records"]}.isdisjoint(
        r["id"] for r in first["records"])


def test_a_session_keeps_at_most_max_spans_and_reset_empties_it(monkeypatch):
    monkeypatch.setattr(trace, "MAX_SPANS", 3)
    trace.enable()
    for _ in range(5):
        with trace.span("s"):
            trace.count("c")
    snap = trace.snapshot()
    assert snap["spans"]["s"]["count"] == 3 and snap["dropped"] == 2
    assert snap["counters"] == {"c": 5}
    trace.reset()
    snap = trace.snapshot()
    assert (snap["records"], snap["counters"], snap["dropped"]) == ([], {}, 0)
