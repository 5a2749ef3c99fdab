"""On the card: each cell's program run is correct and its control is not,
at the cells' own sizes over a short run (``python -m pytest -m gpu
benchmark/tests``). The limits' readings come from benchmark/calibrate.py
over a dozen seeds; this keeps the comparison honest at one seed."""

import pytest

from benchmark import harness

SPEC = harness.benchmark_spec()
RENDER = [w["name"] for w in SPEC["workloads"] if w["traffic"] == "render"]
TRAIN = [w["name"] for w in SPEC["workloads"] if w["traffic"] == "train"]


def _run(name, device, variant=None, seed=2 ** 31 + 3):
    workload = harness.find_workload(SPEC, name)
    ctx = harness.make_context(workload, seed, device, variant=variant)
    out = harness.run_loop(ctx, 0.0, False, until_step=ctx.traffic["check_span"])
    return harness.judge(out["checks"], ctx.limits)


@pytest.mark.gpu
@pytest.mark.parametrize("name", RENDER)
def test_render_cell_correct_and_control_not(name, cuda_device):
    ok, table = _run(name, cuda_device)
    assert ok, table
    variant = harness.load_json(harness.ROOT, "benchmark", "configs",
                                f"{harness.find_workload(SPEC, name)['config']}.json")["control_variant"]
    ok, table = _run(name, cuda_device, variant=variant)
    assert not ok, table


@pytest.mark.gpu
@pytest.mark.parametrize("name", TRAIN)
def test_train_cell_correct_and_control_not(name, cuda_device):
    from benchmark.loops import train

    workload = harness.find_workload(SPEC, name)
    ctx = harness.make_context(workload, 2 ** 31 + 5, cuda_device)
    st = train.setup(ctx)
    train.release(st)
    ref = train.reference_steps(st, ctx)
    ok, table = harness.judge({**train.render_check(st, ctx), **train.compare(st, ref)},
                              ctx.limits)
    assert ok, table
    ctl = train.reference_steps(st, ctx, tf32=True)
    as_program = {"check_losses": ctl["losses"], "grad1": ctl["grad1"], "delta": ctl["delta"]}
    ok, table = harness.judge(train.compare(as_program, ref),
                              {k: v for k, v in ctx.limits.items() if not k.startswith("render")})
    assert not ok, table
