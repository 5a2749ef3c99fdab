"""The benchmark's FLOP and byte counts against hand counts."""

import pytest

from benchmark.counts import dddnet, k2, peaks, render

MLP = {"hidden": 512, "hidden_layers": 8, "ks": 21}
BASIS = {"hidden": 256, "hidden_layers": 8, "basis_k": 48, "ks": 21}


def test_surrogate_dense_flops():
    # 3 -> 128 -> 512, 8 x 512 -> 512, 512 -> 441
    assert render.dense_flops(render.surrogate_dims(MLP)) == 2 * (
        3 * 128 + 128 * 512 + 8 * 512 * 512 + 512 * 441) == 4_777_728
    # 3 -> 64 -> 256, 8 x 256 -> 256, 256 -> 48 -> 441
    assert render.dense_flops(render.surrogate_dims(BASIS)) == 2 * (
        3 * 64 + 64 * 256 + 8 * 256 * 256 + 256 * 48 + 48 * 441) == 1_148_640


@pytest.mark.parametrize("psfnet, tflop", [(MLP, 3.7594), (BASIS, 0.9054)])
def test_render_flops_per_sample(psfnet, tflop):
    per_pixel = render.dense_flops(render.surrogate_dims(psfnet)) + 2 * 441 * 3
    assert render.render_flops(psfnet, 512, 768) == 2 * 512 * 768 * per_pixel
    assert render.render_flops(psfnet, 512, 768) / 1e12 == pytest.approx(tflop, abs=1e-4)


def test_k2_bound_at_the_training_shape():
    n, h, w, c, ks = 4, 512, 768, 3, 21
    nbytes = n * h * w * c * 4 + ks * ks * n * 2 * h * w * 2 + 2 * n * h * w * c * 4
    assert nbytes == 2_831_155_200
    ms, what = k2.bound_ms(n, h, w, c, ks)
    assert what == "bytes"
    assert ms == pytest.approx(nbytes / 3.35e12 * 1e3)
    assert ms == pytest.approx(0.8451, abs=1e-4)


def _conv(cin, cout, k, out_elems, d=2):
    return 2 * cin * k ** d * cout * out_elems


def hand_forward_flops(b, h, w):
    """DDDNet's convolutions counted layer by layer from the architecture."""
    p = lambda f: (h // f) * (w // f)  # noqa: E731
    tower = (_conv(3, 32, 3, p(1)) + _conv(32, 64, 3, p(1)) + _conv(64, 64, 3, p(2))
             + _conv(64, 128, 3, p(2)) + _conv(128, 128, 3, p(2))
             + _conv(128, 128, 3, p(4))
             + _conv(128, 32, 1, p(128)) + _conv(128, 32, 1, p(32))
             + _conv(192, 96, 3, p(4)) + _conv(96, 32, 1, p(4)))
    v = lambda dd, f: dd * p(f)  # noqa: E731
    matching = (_conv(64, 32, 3, v(20, 4), 3) + _conv(32, 48, 3, v(10, 8), 3)
                + _conv(48, 64, 3, v(10, 8), 3) + _conv(64, 64, 3, v(5, 16), 3)
                + _conv(64, 64, 3, v(5, 16), 3)
                + _conv(64, 64, 3, v(10, 8), 3) + _conv(128, 64, 3, v(10, 8), 3)
                + _conv(64, 64, 4, v(10, 8), 3)          # transposed: per input
                + _conv(64, 1, 3, v(20, 4), 3))
    return b * (2 * tower + matching)


@pytest.mark.parametrize("b, h, w", [(1, 128, 192), (4, 512, 768)])
def test_dddnet_forward_flops(b, h, w):
    assert dddnet.forward_flops(b, h, w) == hand_forward_flops(b, h, w)
    assert dddnet.train_step_flops(b, h, w) == 3 * hand_forward_flops(b, h, w)


def test_dddnet_step_least_time():
    # 3.73 TFLOP a bs-4 512x768 step: 55.6 ms at the f32 peak
    assert dddnet.train_step_flops(4, 512, 768) / peaks.F32_FLOPS == pytest.approx(
        0.0556, abs=1e-4)


def test_peaks():
    assert (peaks.BF16_FLOPS, peaks.F32_FLOPS, peaks.HBM_BYTES_PER_S) == (989e12, 67e12, 3.35e12)
