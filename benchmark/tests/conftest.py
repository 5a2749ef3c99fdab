"""Settings of the benchmark's own tests (``python -m pytest benchmark/tests``):
the ``gpu`` marker, and small shapes for the CPU runs of the cells."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the smallest shapes the cells' nets take: DDDNet's pooling branch needs
# H / 4 >= 32, and the lens square pixels (H : W = 2 : 3)
SMALL = {
    "render": {"config": {"res": [32, 48], "bs": 2},
               "traffic": {"scene_pool": 4, "check_span": 3, "check_batches": 2,
                           "warm_batches": 1, "profile_first": 1, "profile_steps": 2}},
    "train": {"config": {"res": [128, 192], "bs": 4},
              "traffic": {"dataset_len": 32, "loader_workers": 2, "check_steps": 2,
                          "profile_first": 1, "profile_steps": 1}},
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; the test decides inside itself and "
        "skips without one")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: runs on the H100 machine")
    return "cuda:0"


def _small_run(name, seed=2 ** 31 + 11, trace=False, device="cpu", variant=None):
    """One run of a cell at SMALL shapes on ``device``: (context, outcome,
    result line)."""
    from benchmark import harness

    spec = harness.benchmark_spec()
    workload = harness.find_workload(spec, name)
    kind = harness.load_json(ROOT, "benchmark", "traffic",
                             f"{workload['traffic']}.json")["loop"]
    ctx = harness.make_context(workload, seed, device, overrides=SMALL[kind],
                               variant=variant)
    out = harness.run_loop(ctx, 0.0, trace, until_step=4)
    return ctx, out, harness.result_line(ctx, out, trace, spec)


@pytest.fixture
def small_run():
    """_small_run, for the tests."""
    return _small_run
