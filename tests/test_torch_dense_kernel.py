"""K3, the dense bf16 layer with its bias, ReLU and rounding in the GEMM's
epilogue (render/dense_bf16.py, csrc/dense_bf16.cu), and the PSF MLPs that
run through it (render/mlp_fast.py, render/basis.py).

The CPU tests hold the wrapper's plain path to the code it replaced, bit for
bit, and check its layout and its refusals. The tests marked ``gpu`` hold
the kernel to the plain version on the card and skip without one. This file
imports neither JAX nor the JAX package, so on the card:

  python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_dense_kernel.py

Tolerance on the card: the kernel and cuBLAS sum the same exact f32
products of bf16 operands in another order, so their f32 sums differ by a
few f32 ulps of the sum of |products|; where that moves a value across a
bf16 rounding midpoint the outputs differ by one bf16 ulp. Held: at most
one ulp apart, on under 1% of the elements (measured on an H100: equal at
every layer of both nets, PERF.md section 6). Near the ReLU's zero a sum may
cancel to a value of any small size, so there only the absolute gap is
bounded, by one bf16 ulp of the layer's largest output.
"""

import numpy as np
import pytest
import torch

from sdirt_tpu_torch.psfnet.arch import build_psfnet
from sdirt_tpu_torch.render import basis, dense_bf16, mlp_fast
from sdirt_tpu_torch.utils import kernels

KS = 21
# (K, N) of every layer through K3 in the two benchmarked surrogates:
# rf50mm's mlp (10 trunk layers, then the tap-major head) and rf35mm's
# mlpb@256x48 (the 11 layers of the coefficient chain)
RF50_SHAPES = [(3, 128, False), (128, 512, False), (512, 512, False), (512, 441, True)]
RF35_SHAPES = [(3, 64, False), (64, 256, False), (256, 256, False), (256, 48, False)]
RENDER_ROWS = 4 * 2 * 512 * 768


def agreement(got, want):
    """How far a bf16 output of the kernel lies from the plain version's:
    (the most bf16 ulps between them where the larger lies above 1/256 of
    the largest output, the largest absolute gap, the share of outputs that
    differ). Both sum the same exact products of bf16 operands in f32 in
    another order, which moves a value by an ulp where it lies near a
    rounding midpoint; near the ReLU's zero a sum may cancel to any small
    value, so there only the absolute gap means anything. Compared in
    slices, to keep the f32 copies small. chip_smoke.py:k3_agreement is a
    copy, for the card."""
    top = float(want.abs().max())
    worst, gap, differ = 0, 0.0, 0
    for a, r in zip(got.reshape(-1).split(1 << 24), want.reshape(-1).split(1 << 24)):
        a32, r32 = a.float(), r.float()
        # bit patterns of values >= 0 are ordered as integers
        ulps = (a.view(torch.int16).int() - r.view(torch.int16).int()).abs()
        worst = max(worst, int(ulps.masked_fill(torch.maximum(a32, r32) < top / 256, 0).max()))
        gap = max(gap, float((a32 - r32).abs().max()))
        differ += int((ulps != 0).sum())
    return worst, gap, differ / want.numel()


# --- the code the wrapper replaced, as it was -------------------------------

def _old_bf16_trunk(layers, x):
    h = x.to(torch.bfloat16)
    for w, b in layers:
        h = mlp_fast.mm_f32(h, w.to(torch.bfloat16).t()).add_(b).relu_()
        h = h.to(torch.bfloat16)
    return h


def _old_mlp_psf_tapmajor(net, o, ks):
    layers = mlp_fast.dense_layers(net)
    x = mlp_fast.stack_views(o)
    h = _old_bf16_trunk(layers[:-1], x)
    w, b = layers[-1]
    psf = mlp_fast.mm_f32(w.to(torch.bfloat16), h.to(torch.bfloat16).t())
    psf.add_(b[:, None]).relu_()
    n = o.shape[0]
    return psf.to(torch.bfloat16).reshape(ks * ks, n, 2, x.shape[0] // (2 * n))


def _old_basis_coeffs(net, o):
    layers = mlp_fast.dense_layers(net)
    h = _old_bf16_trunk(layers[:-1], mlp_fast.stack_views(o))
    return h.float().reshape(o.shape[0], 2, -1, h.shape[-1])


def _net(name, seed):
    torch.manual_seed(seed)
    net = build_psfnet(name, KS).eval()
    for layer in net.layers():
        layer.reset_parameters()
    with torch.no_grad():
        net.layers()[-1].bias.add_(0.2)
    return net


def _queries(seed, shape, device="cpu"):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1, 1, (*shape, 3)).astype(np.float32)
    o[..., 2] = rng.uniform(0, 1, shape)
    return torch.from_numpy(o).to(device)


def _layer(seed, rows, k, n, device="cpu"):
    """A layer's seeded inputs: ReLU'd activations (queries in [-1, 1] for
    K = 3), the Linear default's uniform weights, small biases."""
    g = torch.Generator(device).manual_seed(seed)
    if k == 3:
        x = torch.rand((rows, k), generator=g, device=device) * 2 - 1
    else:
        x = torch.randn((rows, k), generator=g, device=device).relu_()
    w = (torch.rand((n, k), generator=g, device=device) * 2 - 1) / k ** 0.5
    b = (torch.rand((n,), generator=g, device=device) * 2 - 1) * 0.1
    return x.to(torch.bfloat16), w.to(torch.bfloat16), b


# --- CPU ----------------------------------------------------------------------

@pytest.mark.parametrize("name", ["mlp", "mlpb@256x48"])
def test_plain_path_equals_replaced_code(name):
    """On the CPU the trunk, the tap-major head and the basis coefficients
    take the plain version: the replaced code's numbers, bit for bit."""
    net = _net(name, 0)
    o = _queries(1, (2, 8, 12))
    before = dense_bf16.launches
    with torch.no_grad():
        layers = mlp_fast.dense_layers(net)
        x = mlp_fast.stack_views(o)
        assert torch.equal(mlp_fast.bf16_trunk(layers[:-1], x),
                           _old_bf16_trunk(layers[:-1], x))
        if name == "mlp":
            got, want = (mlp_fast.mlp_psf_tapmajor(net, o, KS),
                         _old_mlp_psf_tapmajor(net, o, KS))
        else:
            got, want = basis.basis_coeffs(net, o), _old_basis_coeffs(net, o)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)
    assert dense_bf16.launches == before


def test_tapmajor_head_layout_and_bias_per_tap():
    """The head's output is [N, rows]: the dense layer's transpose, with the
    bias of tap t added to row t. Operands on a grid of 1/4 keep every f32
    sum exact, so both orders agree with the float64 truth exactly."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.integers(0, 9, (37, 16)) / 4.0).to(torch.bfloat16)
    w = torch.from_numpy(rng.integers(-4, 5, (441, 16)) / 4.0).to(torch.bfloat16)
    b = torch.from_numpy(np.arange(441) / 8.0 - 20.0).float()
    tm = dense_bf16.dense_relu(x, w, b, tapmajor=True)
    dense = dense_bf16.dense_relu(x, w, b)
    assert tuple(tm.shape) == (441, 37) and tuple(dense.shape) == (37, 441)
    assert torch.equal(tm, dense.t())
    truth = np.maximum(w.double().numpy() @ x.double().numpy().T
                       + b.double().numpy()[:, None], 0.0)
    assert torch.equal(tm, torch.from_numpy(truth).float().to(torch.bfloat16))


@pytest.mark.parametrize("n,tapmajor,want", [(48, False, 64), (64, False, 64),
                                             (128, False, 128), (256, False, 256),
                                             (441, False, 256), (512, False, 256),
                                             (441, True, 256), (48, True, 256)])
def test_tile_width_follows_the_layer(n, tapmajor, want):
    assert dense_bf16.tile_n(n, tapmajor) == want


def test_wrapper_on_cpu_takes_plain_version():
    x, w, b = _layer(3, 50, 3, 64)
    before = dense_bf16.launches
    got = dense_bf16.dense_relu(x, w, b)
    assert torch.equal(got, dense_bf16.dense_relu_ref(x, w, b))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (50, 64)
    assert dense_bf16.launches == before


def _bad_inputs():
    x, w, b = _layer(4, 10, 16, 32)
    yield "dtype x", (x.float(), w, b), TypeError
    yield "dtype w", (x, w.float(), b), TypeError
    yield "dtype b", (x, w, b.to(torch.bfloat16)), TypeError
    yield "shape K", (x[:, :8].contiguous(), w, b), ValueError
    yield "shape b", (x, w, b[:16].contiguous()), ValueError
    yield "rank", (x[None], w, b), ValueError
    yield "device", (x.to("meta"), w, b), ValueError
    yield "non-contiguous", (torch.cat([x, x], 1)[:, ::2], w, b), ValueError


@pytest.mark.parametrize("args,err", [(a, e) for _, a, e in _bad_inputs()],
                         ids=[i for i, _, _ in _bad_inputs()])
def test_wrapper_rejects_bad_input(args, err):
    with pytest.raises(err):
        dense_bf16.dense_relu(*args)


def test_wrapper_rejects_inputs_that_require_grad():
    """The kernel has no backward: with autograd on, an input that requires
    grad is refused; under no_grad (every caller) the parameters pass."""
    x, w, b = _layer(5, 10, 16, 32)
    b.requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        dense_bf16.dense_relu(x, w, b)
    with torch.no_grad():
        dense_bf16.dense_relu(x, w, b)


def test_agreement_counts_ulps_away_from_zero():
    """One bf16 ulp at 1.0 counts; a gap of many ulps below 1/256 of the
    largest output (the ReLU's cancelling sums) counts only as a gap."""
    want = torch.tensor([0.0, 1e-6, 1.0, 2.0, 4.0]).to(torch.bfloat16)
    got = want.clone()
    got[1] = 0.0
    got[2] = 1.0 + 2.0 ** -7
    worst, gap, share = agreement(got, want)
    assert worst == 1 and gap == 2.0 ** -7 and share == 2 / 5
    assert agreement(want, want) == (0, 0.0, 0.0)


def test_kernel_source_is_built_with_the_others():
    assert "dense_bf16" in kernels.SOURCES


# --- on the card --------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def _assert_close(got, want):
    """At most one bf16 ulp apart, on under 1% of the elements; near the
    ReLU's zero (below 1/256 of the largest output) the gap is bounded by
    one bf16 ulp of the largest output instead."""
    assert got.shape == want.shape and got.dtype == want.dtype == torch.bfloat16
    worst, gap, share = agreement(got, want)
    assert worst <= 1
    assert gap <= float(want.abs().max()) * 2.0 ** -8
    assert share < 0.01


def _check_layer(rows, k, n, tapmajor, seed=6):
    x, w, b = _layer(seed, rows, k, n, "cuda")
    before = dense_bf16.launches
    got = dense_bf16.dense_relu(x, w, b, tapmajor=tapmajor)
    want = dense_bf16.dense_relu_ref(x, w, b, tapmajor=tapmajor)
    torch.cuda.synchronize()
    assert dense_bf16.launches == before + 1
    _assert_close(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("k,n,tapmajor", RF50_SHAPES + RF35_SHAPES,
                         ids=[f"{k}to{n}{'_tapmajor' if t else ''}"
                              for k, n, t in RF50_SHAPES + RF35_SHAPES])
def test_dense_kernel_matches_plain(k, n, tapmajor):
    """Every (K, N) of both surrogates at the render's 3 145 728 rows; the
    first layer's K = 3 goes through the wrapper's zero pad."""
    _cuda()
    _check_layer(RENDER_ROWS, k, n, tapmajor)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 127, 1000, 2 * 256 * 384, 2 * 512 * 768])
@pytest.mark.parametrize("k,n,tapmajor", [(512, 512, False), (512, 441, True),
                                          (3, 64, False), (256, 48, False)],
                         ids=["512to512", "head", "3to64", "256to48"])
def test_dense_kernel_ragged_rows(rows, k, n, tapmajor):
    """Row counts off the 128-row tile (and, in the head, off the 256-row
    one), down to one row; 2 x 256 x 384 and 2 x 512 x 768 are the bs-1
    renders."""
    _cuda()
    _check_layer(rows, k, n, tapmajor, seed=rows)


@pytest.mark.gpu
def test_dense_kernel_pads_k_exactly():
    """K = 3 padded to 8 by the wrapper (and to 64 by TMA's zero fill): on
    operands whose sums are exact in any order the kernel equals the plain
    version bit for bit, and its inputs are left as they were."""
    _cuda()
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.integers(-4, 5, (1000, 3)) / 4.0).to(torch.bfloat16).cuda()
    w = torch.from_numpy(rng.integers(-4, 5, (128, 3)) / 4.0).to(torch.bfloat16).cuda()
    b = torch.from_numpy(rng.integers(-4, 5, 128) / 8.0).float().cuda()
    x0, w0 = x.clone(), w.clone()
    got = dense_bf16.dense_relu(x, w, b)
    assert torch.equal(got, dense_bf16.dense_relu_ref(x, w, b))
    assert torch.equal(x, x0) and torch.equal(w, w0)


@pytest.mark.gpu
def test_dense_kernel_tapmajor_is_the_transpose():
    """The head's tap-major output holds the dense layer's values: tap t
    of row r is row r's output t, its bias along the taps."""
    _cuda()
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.integers(0, 9, (3001, 512)) / 64.0).to(torch.bfloat16).cuda()
    w = torch.from_numpy(rng.integers(-4, 5, (441, 512)) / 64.0).to(torch.bfloat16).cuda()
    b = torch.from_numpy(np.arange(441) / 64.0 - 3.0).float().cuda()
    tm = dense_bf16.dense_relu(x, w, b, tapmajor=True)
    dense = dense_bf16.dense_relu(x, w, b)
    assert tuple(tm.shape) == (441, 3001)
    # sums of products on a 1/4096 grid below 2^24 ulps: exact in any order
    assert torch.equal(tm, dense.t())
    assert torch.equal(tm, dense_bf16.dense_relu_ref(x, w, b, tapmajor=True))


@pytest.mark.gpu
def test_dense_kernel_rejects_misaligned_input():
    _cuda()
    x, w, b = _layer(9, 64, 16, 32, "cuda")
    flat = torch.empty(x.numel() + 1, dtype=torch.bfloat16, device="cuda")
    moved = flat[1:].view(64, 16)
    moved.copy_(x)
    with pytest.raises(ValueError, match="16-byte"):
        dense_bf16.dense_relu(moved, w, b)


@pytest.mark.gpu
@pytest.mark.parametrize("name,variant", [("mlp", "fused"), ("mlpb@256x48", "basis")])
def test_render_launches_k3_per_layer(name, variant):
    """A render runs every bf16 layer through K3: 11 launches (rf50mm's
    10 trunk layers and the head; rf35mm's 11 coefficient layers), and its
    PSF MLP agrees with the plain chain on the CPU."""
    _cuda()
    from sdirt_tpu_torch.render.pipeline import render_dp

    net = _net(name, 10).cuda()
    img = torch.rand((1, 3, 64, 96), generator=torch.Generator().manual_seed(11)).cuda()
    depth = -(500 + 1000 * torch.rand((1, 1, 64, 96),
                                      generator=torch.Generator().manual_seed(12))).cuda()
    before = dense_bf16.launches
    render_dp(net, img, depth, None, d_sensor=62.25, d_min=-200.0, d_max=-20000.0,
              ks=KS, variant=variant)
    torch.cuda.synchronize()
    assert dense_bf16.launches == before + 11
    o = _queries(13, (2, 16, 24))
    with torch.no_grad():
        if variant == "fused":
            got = mlp_fast.mlp_psf_pixelmajor(net, o.cuda(), KS).cpu()
            want = mlp_fast.mlp_psf_pixelmajor(net.cpu(), o, KS)
            # sum-normalised taps: a few one-ulp flips through 11 layers
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=5e-3)
        else:
            got = basis.basis_coeffs(net, o.cuda()).cpu()
            want = basis.basis_coeffs(net.cpu(), o)
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                       atol=5e-3 * float(want.abs().max()))
