"""The PyTorch port's render variants against the JAX package on the CPU:
the basis student (PSFMLPBasis, "mlpb@WxK"), the static-scale int8 trunk
(quantize_mlp, quant_trunk, the fused_int8 PSF), the basis convolution,
render_dp per variant, the int8 pack's cache, the partial warm start, the
shipped basis students of both lenses and, for the slice as a whole, the
variant gate on a cut of the real flat captures.

Inputs come from numpy with a seed and go to both sides; the weights are
carried across with utils/weights.py. The JAX fused variants run Pallas in
interpret mode on the CPU, as the JAX package's own tests run them. Sizes
follow tests/test_fused_render.py and tests/test_render_basis.py: N 2,
16x24, ks 7, "mlp" and "mlpb@64x12" with the basis made non-negative and
its bias raised by 0.2 (a fitted student's taps carry no large cancelling
mass). Each tolerance has the gap measured when it was set beside it.
"""

import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdirt_tpu.psfnet.arch import build_psfnet as jax_build_psfnet
from sdirt_tpu.render import basis as jax_basis
from sdirt_tpu.render import mlp_fast as jax_mlp
from sdirt_tpu.render.pipeline import render_dp as jax_render_dp
from sdirt_tpu_torch.psfnet.arch import PSFMLPBasis, build_psfnet
from sdirt_tpu_torch.render import basis, mlp_fast, pipeline
from sdirt_tpu_torch.render.pipeline import render_dp
from sdirt_tpu_torch.utils.weights import flax_to_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KS = 7
N, H, W, C = 2, 16, 24, 3
RENDER_KW = dict(d_sensor=62.25, d_min=-200.0, d_max=-20000.0, ks=KS)

torch.set_num_threads(2)


def _pair(name, seed=0, fitted_like=True):
    """A Flax net (seeded init) and its carried-across torch copy."""
    params = jax_build_psfnet(name, KS).init(jax.random.PRNGKey(seed),
                                            jnp.zeros((1, 3)))
    params = jax.tree.map(np.asarray, params)
    if fitted_like and name.startswith("mlpb"):
        last = max(params["params"], key=lambda s: int(s.split("_")[-1]))
        params["params"][last]["kernel"] = np.abs(params["params"][last]["kernel"])
        params["params"][last]["bias"] = params["params"][last]["bias"] + 0.2
    flat = flax.traverse_util.flatten_dict(params, sep="/")
    net = build_psfnet(name, KS)
    net.load_state_dict(flax_to_torch(flat))
    return params, net.eval()


@pytest.fixture(scope="module")
def mlp():
    return _pair("mlp")


@pytest.fixture(scope="module")
def mlpb():
    return _pair("mlpb@64x12")


def _queries(rng, shape):
    o = rng.uniform(-1, 1, (*shape, 3)).astype(np.float32)
    o[..., 2] = rng.uniform(0, 1, shape)
    return o


def _scene(seed):
    rng = np.random.default_rng(seed)
    return (_queries(rng, (N, H, W)),
            rng.uniform(0, 1, (N, H, W, C)).astype(np.float32))


def test_build_psfnet_basis_names():
    net = build_psfnet("mlpb@64x12", KS)
    assert isinstance(net, PSFMLPBasis) and net.linear_head
    dims = [(lin.in_features, lin.out_features) for lin in net.layers()]
    assert dims == [(3, 16), (16, 64)] + [(64, 64)] * 8 + [(64, 12), (12, KS * KS)]
    assert build_psfnet("mlpb@64", KS).basis_k == 64
    assert not build_psfnet("mlp", KS).linear_head


def test_psfmlp_basis_matches_flax():
    params, net = _pair("mlpb@64x12", fitted_like=False)     # a signed basis
    x = _queries(np.random.default_rng(0), (257,))
    ref = np.asarray(jax_build_psfnet("mlpb@64x12", KS).apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert (ref < 0).any()          # the head is linear: no output ReLU
    # measured 2.4e-7 of the largest output
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("name", ["mlp", "mlpb@64x12"])
def test_quantize_mlp_matches_jax(name):
    params, net = _pair(name)
    ref = jax_mlp.quantize_mlp(params)
    got = mlp_fast.quantize_mlp(net)
    assert len(got["wq"]) == len(ref["wq"]) == net.n_layers - 3
    for wq_j, wq_t, sc_j, sc_t in zip(ref["wq"], got["wq"], ref["sc"], got["sc"]):
        assert wq_t.dtype == torch.int8
        # the torch pack holds the [out, in] transpose of the Flax pack
        np.testing.assert_array_equal(wq_t.numpy().T, np.asarray(wq_j))
        # measured: equal
        np.testing.assert_allclose(sc_t.numpy(), np.asarray(sc_j), rtol=1e-6, atol=0)


@pytest.mark.parametrize("name", ["mlp", "mlpb@64x12"])
def test_quant_trunk_matches_jax(name):
    params, net = _pair(name)
    o, _ = _scene(1)
    x = jax_mlp.stack_views(jnp.asarray(o))
    ref = np.asarray(jax_mlp.quant_trunk(jax_mlp.dense_layers(params),
                                         jax_mlp.quantize_mlp(params), x))
    with torch.no_grad():
        got = mlp_fast.quant_trunk(mlp_fast.dense_layers(net),
                                   mlp_fast.quantize_mlp(net),
                                   mlp_fast.stack_views(torch.from_numpy(o)))
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    # integer products are exact on both sides; measured: equal. The band
    # is the JAX package's bf16 one, relative to the largest activation
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=5e-3 * np.abs(ref).max())


def test_fused_int8_psf_matches_jax(mlp):
    params, net = mlp
    o, _ = _scene(2)
    ref = np.asarray(jax_mlp.mlp_psf_pixelmajor(
        params, jnp.asarray(o), KS, quant=jax_mlp.quantize_mlp(params)))
    with torch.no_grad():
        got = mlp_fast.mlp_psf_pixelmajor(net, torch.from_numpy(o), KS,
                                          quant=mlp_fast.quantize_mlp(net))
    assert tuple(got.shape) == ref.shape == (N, H, W, 2, KS, KS)
    # sum-normalised taps; measured 1.5e-8 (the JAX package's band: 5e-3)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=5e-3)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 5e-3)])
def test_basis_dp_conv_matches_jax(mlpb, dtype, tol):
    params, net = mlpb
    o, img = _scene(3)
    rl_j, rr_j = jax_basis.basis_dp_conv(params, jnp.asarray(o), jnp.asarray(img),
                                         KS, compute_dtype=getattr(jnp, dtype))
    with torch.no_grad():
        rl, rr = basis.basis_dp_conv(net, torch.from_numpy(o), torch.from_numpy(img),
                                     KS, compute_dtype=getattr(torch, dtype))
    # measured 1.8e-7 (f32) and 1.2e-7 (bf16), both views
    np.testing.assert_allclose(rl.numpy(), np.asarray(rl_j), rtol=0, atol=tol)
    np.testing.assert_allclose(rr.numpy(), np.asarray(rr_j), rtol=0, atol=tol)


def test_basis_int8_dp_conv_matches_jax(mlpb):
    params, net = mlpb
    o, img = _scene(4)
    rl_j, rr_j = jax_basis.basis_dp_conv(params, jnp.asarray(o), jnp.asarray(img),
                                         KS, quant=jax_mlp.quantize_mlp(params))
    with torch.no_grad():
        rl, rr = basis.basis_dp_conv(net, torch.from_numpy(o), torch.from_numpy(img),
                                     KS, quant=mlp_fast.quantize_mlp(net))
    # measured 1.8e-7, both views
    np.testing.assert_allclose(rl.numpy(), np.asarray(rl_j), rtol=0, atol=5e-3)
    np.testing.assert_allclose(rr.numpy(), np.asarray(rr_j), rtol=0, atol=5e-3)


def test_basis_matches_the_ports_scan(mlpb):
    """The basis render is a reassociation of the scan's per-pixel sum."""
    _, net = mlpb
    rng = np.random.default_rng(5)
    img = torch.from_numpy(rng.uniform(0, 1, (N, C, H, W)).astype(np.float32))
    depth = torch.from_numpy(-rng.uniform(100, 1000, (N, 1, H, W)).astype(np.float32))
    outs = {v: render_dp(net, img, depth, None, variant=v, **RENDER_KW)
            for v in ("scan", "basis", "basis_int8")}
    # measured 1.6e-3 (basis) and 2.9e-3 (basis_int8)
    for v in ("basis", "basis_int8"):
        np.testing.assert_allclose(outs[v].numpy(), outs["scan"].numpy(),
                                   rtol=0, atol=1e-2)


RENDER_CASES = [("mlp", "scan", {}), ("mlp", "fused", {}), ("mlp", "fused_int8", {}),
                ("mlp", "scan", {"scan_right": "noflip"}),
                ("mlp", "scan", {"scan_right": "f32"}),
                ("mlp", "scan", {"mlp_bf16": False}),
                ("mlpb@64x12", "scan", {}), ("mlpb@64x12", "basis", {}),
                ("mlpb@64x12", "basis_int8", {})]


@pytest.mark.parametrize("name,variant,kw", RENDER_CASES,
                         ids=[f"{n}-{v}" + "".join(f"-{k}={x}" for k, x in kw.items())
                              for n, v, kw in RENDER_CASES])
def test_render_dp_variant_matches_jax(mlp, mlpb, name, variant, kw):
    params, net = mlp if name == "mlp" else mlpb
    apply = jax_build_psfnet(name, KS).apply
    rng = np.random.default_rng(6)
    img = rng.uniform(0, 1, (N, C, H, W)).astype(np.float32)
    depth = -rng.uniform(100, 1000, (N, 1, H, W)).astype(np.float32)
    jkw = {"scan_right": "flip", "mlp_bf16": True, **kw}
    # The int8 variants are held against the JAX function run op by op:
    # under jit, XLA rewrites the f32 requantisation between the int8 GEMMs
    # (acc * wse + be, * 1/sa), so a third of the jitted trunk's int8
    # activations land one step off its own op-by-op values (up to 5.5e-2
    # of the activations here), and the jitted render moves up to 2.2e-2
    # from the op-by-op one. The port's trunk equals the op-by-op one.
    with jax.disable_jit(variant.endswith("_int8")):
        ref = np.asarray(jax_render_dp(apply, params, img, depth, [-1000.0],
                                       variant=variant, **jkw, **RENDER_KW))
    got = render_dp(net, torch.from_numpy(img), torch.from_numpy(depth),
                    [-1000.0], variant=variant, **jkw, **RENDER_KW)
    assert tuple(got.shape) == (N, 2 * C, H, W)
    # the JAX package's own variant band (tests/test_fused_render.py,
    # tests/test_render_basis.py); measured at most 2.4e-3
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-2)


def test_variant_from_environment(mlp, monkeypatch):
    _, net = mlp
    rng = np.random.default_rng(7)
    img = torch.from_numpy(rng.uniform(0, 1, (1, C, H, W)).astype(np.float32))
    depth = torch.from_numpy(-rng.uniform(100, 1000, (1, 1, H, W)).astype(np.float32))
    monkeypatch.delenv("SDIRT_RENDER_VARIANT", raising=False)
    assert pipeline.resolve_variant() == "fused"
    monkeypatch.setenv("SDIRT_RENDER_VARIANT", "fused_int8")
    assert pipeline.resolve_variant() == "fused_int8"
    got = render_dp(net, img, depth, None, **RENDER_KW)
    want = render_dp(net, img, depth, None, variant="fused_int8", **RENDER_KW)
    assert torch.equal(got, want)
    monkeypatch.setenv("SDIRT_RENDER_VARIANT", "int4")
    with pytest.raises(ValueError, match="not in"):
        render_dp(net, img, depth, None, **RENDER_KW)
    with pytest.raises(ValueError, match="scan_right"):
        render_dp(net, img, depth, None, variant="scan", scan_right="left",
                  **RENDER_KW)


def test_head_mismatch_raises(mlp, mlpb):
    img = torch.zeros((1, C, H, W))
    depth = -torch.ones((1, 1, H, W)) * 500
    for variant in ("fused", "fused_int8"):
        with pytest.raises(ValueError, match="linear"):
            render_dp(mlpb[1], img, depth, None, variant=variant, **RENDER_KW)
    for variant in ("basis", "basis_int8"):
        with pytest.raises(ValueError, match="all-ReLU"):
            render_dp(mlp[1], img, depth, None, variant=variant, **RENDER_KW)


def test_int8_cache_quantises_again_after_a_weight_change():
    _, net = _pair("mlp", seed=3)
    first = pipeline.get_quant(net)
    assert pipeline.get_quant(net) is first          # cached
    with torch.no_grad():
        net.Dense_4.weight.mul_(2.0)                 # in place, as a step would
    second = pipeline.get_quant(net)
    assert second is not first
    ref = mlp_fast.quantize_mlp(net)
    for a, b in zip(second["sc"], ref["sc"]):
        assert torch.equal(a, b)
    assert not torch.equal(first["sc"][2], second["sc"][2])
    # a load_state_dict is an in-place copy too
    _, other = _pair("mlp", seed=4)
    net.load_state_dict(other.state_dict())
    third = pipeline.get_quant(net)
    for a, b in zip(third["wq"], mlp_fast.quantize_mlp(other)["wq"]):
        assert torch.equal(a, b)
    # at most QUANT_CACHE_SIZE nets are kept, first in first out
    nets = [_pair("mlp@32", seed=s)[1] for s in range(pipeline.QUANT_CACHE_SIZE + 1)]
    for n in nets:
        pipeline.get_quant(n)
    assert len(pipeline._QUANT_CACHE) == pipeline.QUANT_CACHE_SIZE
    assert id(nets[0]) not in pipeline._QUANT_CACHE


def test_partial_warm_start_carries_the_trunk(tmp_path):
    from sdirt_tpu_torch.psfnet.surrogate import PSFNetLens

    lens_file = os.path.join(ROOT, "lenses", "rf50mm", "lens_web.json")
    kw = dict(kernel_size=KS, sensor_res=(512, 768), device="cpu")
    teacher = PSFNetLens(lens_file, model_name="mlp@64", seed=1, **kw)
    path = str(tmp_path / "teacher.npz")
    teacher.save_net(path)
    student = PSFNetLens(lens_file, model_name="mlpb@64x12", seed=2, **kw)
    before = {k: v.clone() for k, v in student.net.state_dict().items()}
    student.load_net(path)
    after = student.net.state_dict()
    t_state = teacher.net.state_dict()
    for i in range(10):                              # 3 -> 16 -> 64 -> [64 x 8]
        for leaf in ("weight", "bias"):
            assert torch.equal(after[f"Dense_{i}.{leaf}"], t_state[f"Dense_{i}.{leaf}"])
    for i in (10, 11):                               # coefficients, basis
        for leaf in ("weight", "bias"):
            assert torch.equal(after[f"Dense_{i}.{leaf}"], before[f"Dense_{i}.{leaf}"])
    other = PSFNetLens(lens_file, model_name="mlp@32", **{**kw, "kernel_size": 5})
    with pytest.raises(ValueError, match="no same-shaped"):
        other.load_net(path)


@pytest.mark.parametrize("lens", ["rf50mm", "rf35mm"])
def test_shipped_basis_students_match_flax(lens):
    """The exported promoted students, loaded strictly by the port, against
    the Flax net that the JAX package's PSFNetLens.load_net restores."""
    from sdirt_tpu.psfnet.surrogate import PSFNetLens as JaxLens
    from sdirt_tpu_torch.psfnet.surrogate import PSFNetLens

    name = "mlpb@256x48"
    lens_file = os.path.join(ROOT, "lenses", lens, "lens_web.json")
    jlens = JaxLens(lens_file, model_name=name, kernel_size=21, sensor_res=(512, 768))
    jlens.load_net(os.path.join(ROOT, "ckpt", lens, f"F4_PSFNet_{name}"))
    tlens = PSFNetLens(lens_file, model_name=name, kernel_size=21,
                       sensor_res=(512, 768), device="cpu")
    tlens.load_net(os.path.join(ROOT, "sdirt_tpu_torch", "weights", lens,
                                f"F4_PSFNet_{name}.npz"))
    x = _queries(np.random.default_rng(8), (4096,))
    ref = np.asarray(jlens.net.apply(jlens.params, jnp.asarray(x)))
    with torch.no_grad():
        got = tlens.net(torch.from_numpy(x)).numpy()
    # measured 1.6e-7 of the largest output
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


CROP = (slice(192, 320), slice(288, 480))      # 128x192 window of 512x768


class _Cropped:
    def __init__(self, ds, n):
        self.ds, self.n = ds, n

    def __len__(self):
        return self.n

    def __getitem__(self, i, rng=None):
        return [np.ascontiguousarray(a[..., CROP[0], CROP[1]])
                for a in self.ds.__getitem__(i, rng)]


# the JAX rows the port's gate rows are held against, per surrogate
JAX_GATE_ROWS = {"mlp": ("scan",), "mlpb@256x48": ("scan", "basis", "basis_int8")}


@pytest.fixture(scope="module")
def flat_jax(tmp_path_factory):
    """The JAX app's flat scores (test_dp_images) of one flat scene cut to
    128x192, for the rf35mm lens with the config's mlp and the promoted
    basis student, per variant of JAX_GATE_ROWS: {net: (cut set, {variant:
    [psnr_l, psnr_r, ssim_l, ssim_r, perc_l, perc_r]})}."""
    import csv
    import importlib.util

    from sdirt_tpu.dfdp import factory as jax_factory
    from sdirt_tpu_torch.dfdp import factory
    from sdirt_tpu_torch.utils.config import load_config

    spec = importlib.util.spec_from_file_location(
        "jax_dfdp_net", os.path.join(ROOT, "apps", "dfdp_net.py"))
    app = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(app)
    old = os.getcwd(), os.environ.get("SDIRT_RENDER_VARIANT")
    os.chdir(ROOT)
    try:
        out = {}
        for net, variants in JAX_GATE_ROWS.items():
            args = load_config("configs/dfdp_by_sdirt_rf35mm.yml")
            if net != "mlp":
                args["test"].update(psfnet_model=net,
                                    psfnet_path=f"./ckpt/rf35mm/F4_PSFNet_{net}")
            flat = _Cropped(factory.get_flat_sample_set(args), 1)
            _, jax_lens = jax_factory.get_lens(args)
            rows = {}
            for variant in variants:
                os.environ["SDIRT_RENDER_VARIANT"] = variant
                args["results_dir"] = str(tmp_path_factory.mktemp("jax_flat"))
                avg = app.test_dp_images(jax_lens, flat, "flat", args)
                with open(os.path.join(args["results_dir"], "DPimages", "res.csv")) as f:
                    rec = next(csv.DictReader(f))
                rows[variant] = [*avg, float(rec["perc_l"]), float(rec["perc_r"])]
            out[net] = (flat, rows)
        return out
    finally:
        os.chdir(old[0])
        if old[1] is None:
            os.environ.pop("SDIRT_RENDER_VARIANT", None)
        else:
            os.environ["SDIRT_RENDER_VARIANT"] = old[1]


@pytest.mark.parametrize("net,variants", [
    ("mlp", ["fused", "fused_int8", "scan"]),
    ("mlpb@256x48", ["scan", "basis", "basis_int8"])])
def test_gate_rows_match_jax(flat_jax, monkeypatch, net, variants):
    """The slice as a whole: each variant's flat scores on the cut scene,
    through the port's gate with the shipped rf35mm nets, against the JAX
    app's scores of the same variant where the JAX CPU run has it (the
    basis student's rows), else of its scan render: PSNR within the JAX
    package's 0.1 dB gate, SSIM within 2e-3, the perceptual distance within
    5%. (basis_int8 itself sits 0.17 / 0.14 dB below the scan render on
    this cut, in the JAX package as in the port.)"""
    from sdirt_tpu_torch import gate_render_variants as gate

    flat, ref = flat_jax[net]
    monkeypatch.chdir(ROOT)
    monkeypatch.setattr(gate, "get_flat_sample_set", lambda cfg: flat)
    argv = ["--config", "configs/dfdp_by_sdirt_rf35mm.yml", "--device", "cpu",
            "--limit", "1", "--variants", *variants]
    if net == "mlp":
        argv.append("--f32-baseline")
    else:
        argv += ["--model", net, "--psfnet", f"./ckpt/rf35mm/F4_PSFNet_{net}"]
    rows = gate.main(argv)
    assert [r["variant"] for r in rows] == (["scan_f32"] if net == "mlp" else []) + variants
    for r in rows:
        want = ref.get(r["variant"], ref["scan"])
        got = [r[k] for k in gate.SCORES]
        # measured: mlp rows within 0.033 dB of the JAX scan, the basis
        # student's within 0.033 dB (scan), 0.0 (basis, basis_int8) of the
        # JAX row of the same variant
        np.testing.assert_allclose(got[:2], want[:2], rtol=0, atol=0.1)
        np.testing.assert_allclose(got[2:4], want[2:4], rtol=0, atol=2e-3)
        np.testing.assert_allclose(got[4:], want[4:], rtol=5e-2, atol=0)
        assert r["k2_launches"] == 0            # the CPU takes the plain version
