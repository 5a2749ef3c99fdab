"""The plain reference against the program at small sizes on the CPU, and
the lower-precision controls against the cells' limits."""

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.loops import common
from benchmark.reference import dddnet, render, weights

RENDER_CELLS = ("rf50_mlp.render", "rf35_basis.render")


def _ctx(name):
    spec = harness.benchmark_spec()
    return harness.make_context(harness.find_workload(spec, name), 7, "cpu")


def _batch(cfg, res=(32, 48), bs=2, seed=5):
    ds = common.scenes({**cfg, "res": list(res)}, bs, seed)
    return next(iter(common.loader(ds, bs, 1, seed, shuffle=False)))


@pytest.mark.parametrize("name", RENDER_CELLS)
def test_reference_render_matches_the_program(name, monkeypatch):
    ctx = _ctx(name)
    cfg = {**ctx.config, "res": [32, 48]}
    monkeypatch.setenv("SDIRT_RENDER_VARIANT", cfg["render_variant"])
    aif, depth = _batch(cfg)
    lens = common.build_lens(cfg, "cpu")
    gen = torch.Generator().manual_seed(3)
    state = gen.get_state()
    got, _, _ = common.render_stack(lens, aif, depth, gen)
    want = common.reference_render(cfg, [(aif, depth, state)], "cpu")
    gaps = common.render_gaps([got], want)
    assert gaps["max_abs_gap"] < 1e-5 and gaps["mean_abs_gap"] < 1e-7
    # the noise is drawn: the noisy stack differs from a noise-free render
    clean = common.reference_render(cfg, [(aif, depth, None)], "cpu")[0]
    assert float((want[0] - clean).abs().mean()) > 1e-6


@pytest.mark.parametrize("name", RENDER_CELLS)
def test_render_control_fails_the_limits(name, monkeypatch):
    """The program's int8 path, the cells' control, is not correct."""
    ctx = _ctx(name)
    cfg = {**ctx.config, "res": [32, 48]}
    monkeypatch.setenv("SDIRT_RENDER_VARIANT", cfg["control_variant"])
    aif, depth = _batch(cfg, seed=9)
    lens = common.build_lens(cfg, "cpu")
    gen = torch.Generator().manual_seed(4)
    state = gen.get_state()
    got, _, _ = common.render_stack(lens, aif, depth, gen)
    want = common.reference_render(cfg, [(aif, depth, state)], "cpu")
    correct, _ = harness.judge(common.render_gaps([got], want), ctx.limits)
    assert not correct


def test_reference_depth_net_matches_the_program():
    from sdirt_tpu_torch.dfdp.basenet import build_basenet, compute_loss, linear_depth

    cfg = _ctx("rf50_mlp.train").config
    path = common.path(cfg["depth_net"]["weights"])
    prog = build_basenet(path, device="cpu", train=True)
    ref = dddnet.build(weights.load_tree(path), "cpu")
    gen = torch.Generator().manual_seed(0)
    stack = torch.rand((2, 6, 128, 192), generator=gen)
    depth = torch.rand((2, 1, 128, 192), generator=gen) * 3 + 0.5
    out_p = prog(stack)["pred_depth_est"]
    out_r = ref(stack)
    assert float((out_p - out_r).detach().abs().max()) < 1e-5
    log_d, mask = linear_depth(depth)
    loss_p = compute_loss({"pred_depth_est": out_p}, log_d, mask)["total"]
    assert loss_p.item() == pytest.approx(dddnet.loss(out_r, depth).item(), rel=1e-6)
    # the running statistics follow the same rule
    for (k, a), (_, b) in zip(prog.state_dict().items(), ref.state_dict().items()):
        if "running" in k:
            assert torch.allclose(a, b, atol=1e-6), k


def test_reference_upload_quantises_as_the_trainer():
    aif = np.linspace(0, 1, 2 * 3 * 4 * 6, dtype=np.float32).reshape(2, 3, 4, 6)
    depth = np.linspace(0.4, 5.0, 2 * 4 * 6, dtype=np.float32).reshape(2, 1, 4, 6)
    img, d = render.upload(aif, depth, "cpu")
    assert torch.equal(img * 255, torch.round(img * 255))
    assert torch.equal(d, torch.from_numpy(depth.astype(np.float16)).float())
