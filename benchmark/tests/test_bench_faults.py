"""Each fault a cell can have, planted under the timed path, makes the
run's ``correct`` false; the rest of the run is the harness's own."""

import pytest
import torch

from benchmark.loops import common

RENDER_CELLS = ("rf50_mlp.render", "rf35_basis.render")


def _altered(render):
    def fn(lens, aif, depth, gen):
        stack, d, a = render(lens, aif, depth, gen)
        stack = stack.clone()
        stack[0, :, :4, :4] += 0.05
        return stack, d, a
    return fn


def _half_batch(render):
    def fn(lens, aif, depth, gen):
        n = aif.shape[0] // 2
        stack, d, a = render(lens, aif[:n], depth[:n], gen)
        return torch.cat([stack, stack]), torch.cat([d, d]), torch.cat([a, a])
    return fn


@pytest.mark.parametrize("fault", [_altered, _half_batch])
@pytest.mark.parametrize("name", RENDER_CELLS)
def test_render_faults_are_not_correct(name, fault, small_run, monkeypatch):
    monkeypatch.setattr(common, "render_stack", fault(common.render_stack))
    _, _, line = small_run(name)
    assert not line["correct"], line["checks"]


def _unchanged(step):
    from sdirt_tpu_torch.dfdp.train import dfdp_grads

    def fn(state, stack, depth, *a, **k):
        return dfdp_grads(state.net, stack, depth)
    return fn


def _train_half_batch(step):
    def fn(state, stack, depth, *a, **k):
        n = stack.shape[0] // 2
        return step(state, stack[:n], depth[:n], *a, **k)
    return fn


@pytest.mark.parametrize("fault", [_unchanged, _train_half_batch])
def test_train_faults_are_not_correct(fault, small_run, monkeypatch):
    import sdirt_tpu_torch.dfdp.train as program_train

    monkeypatch.setattr(program_train, "dfdp_train_step",
                        fault(program_train.dfdp_train_step))
    _, _, line = small_run("rf50_mlp.train")
    assert not line["correct"], line["checks"]
