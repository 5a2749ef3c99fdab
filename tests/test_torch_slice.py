"""The PyTorch port's serve path as a whole (``--stage sample``) against the
JAX app on the CPU, at a reduced size, and the port's package rules: no
import of JAX or of the JAX package, entry points that default to the card,
configs read as the JAX app reads them.
"""

import ast
import glob
import importlib.util
import inspect
import os

import flax
import numpy as np
import pytest
import torch

from sdirt_tpu_torch import dfdp_net, fit_psfnet
from sdirt_tpu_torch.dfdp import basenet, factory
from sdirt_tpu_torch.optics.lens import Lens
from sdirt_tpu_torch.psfnet.surrogate import PSFNetLens
from sdirt_tpu_torch.utils.config import load_config
from sdirt_tpu_torch.utils.device import resolve_device
from sdirt_tpu_torch.utils.weights import load_npz

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "dfdp_by_sdirt_rf50mm.yml")
CROP = (slice(192, 320), slice(288, 480))      # 128x192 window of 512x768
FORBIDDEN = {"jax", "jaxlib", "flax", "orbax", "optax", "cv2", "PIL",
             "pandas", "matplotlib", "sdirt_tpu"}


class Cropped:
    """The first n samples of a set, each array cut to the CROP window."""

    def __init__(self, ds, n):
        self.ds, self.n = ds, n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return [np.ascontiguousarray(a[..., CROP[0], CROP[1]]) for a in self.ds[i]]


def _jax_app():
    spec = importlib.util.spec_from_file_location(
        "jax_dfdp_net", os.path.join(ROOT, "apps", "dfdp_net.py"))
    app = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(app)
    return app


def test_stage_sample_reduced_matches_jax(tmp_path, monkeypatch):
    """One flat scene and one frame of each depth set, cut to 128x192, through
    the port (plain versions on the CPU) and the JAX app (its scan render,
    as the reference numbers were made)."""
    from sdirt_tpu.dfdp import factory as jax_factory

    monkeypatch.chdir(ROOT)
    monkeypatch.setenv("SDIRT_RENDER_VARIANT", "scan")
    app = _jax_app()
    args = load_config(CONFIG)
    args.update(results_dir=str(tmp_path), train_mode="dfdp",
                save_images=False, save_ckpt=False)

    flat = Cropped(factory.get_flat_sample_set(args), 1)
    _, jax_lens = jax_factory.get_lens(args)
    ref_flat = app.test_dp_images(jax_lens, flat, "flat", args)
    _, lens = factory.get_lens(args, device="cpu")
    for variant, tol_db in (("fused", 0.1), ("scan", 0.1)):
        rec = dfdp_net.test_dp_images(lens, flat, variant)[0]
        got = [rec[k] for k in ("psnr_l", "psnr_r", "ssim_l", "ssim_r")]
        # the JAX package's render-variant gate: 0.1 dB
        np.testing.assert_allclose(got[:2], ref_flat[:2], rtol=0, atol=tol_db)
        np.testing.assert_allclose(got[2:], ref_flat[2:], rtol=0, atol=2e-3)

    variables = flax.traverse_util.unflatten_dict(load_npz(
        factory.ported_weights(args["train"]["dfdpnet_pretrained"])), sep="/")
    net = basenet.build_basenet(
        factory.ported_weights(args["train"]["dfdpnet_pretrained"]),
        device="cpu")
    for tag, ds in zip(("box", "f2d", "casual"),
                       factory.get_depth_sample_set(args)):
        ds = Cropped(ds, 1)
        ref = app.test_depth(variables["params"], variables["batch_stats"],
                             ds, tag, args)
        got = dfdp_net.test_depth(net, ds, "cpu")
        for k, v in ref.items():
            assert abs(got[k] - v) <= 0.005, (tag, k, got[k], v)


def _package_files():
    files = glob.glob(os.path.join(ROOT, "sdirt_tpu_torch", "**", "*.py"),
                      recursive=True)
    return sorted(files) + [os.path.join(ROOT, "chip_smoke.py")]


@pytest.mark.parametrize("path", _package_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_forbidden_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


# the modules of the training slice, which the import guard above must see
TRAIN_SLICE = ("dfdp/cvops.py", "dfdp/datasets.py", "dfdp/train.py",
               "dfdp/basenet.py", "dfdp/models/layers.py", "dfdp/monitor.py",
               "dfdp/factory.py", "render/camera.py", "render/pipeline.py",
               "utils/checkpoint.py", "utils/stall.py", "utils/logging.py",
               "dfdp_net.py")


def test_import_guard_covers_the_training_slice():
    files = {os.path.relpath(p, os.path.join(ROOT, "sdirt_tpu_torch"))
             for p in _package_files()}
    assert set(TRAIN_SLICE) <= files


# the modules of the render-variants slice
VARIANT_SLICE = ("psfnet/arch.py", "psfnet/surrogate.py", "render/mlp_fast.py",
                 "render/basis.py", "render/pipeline.py", "dfdp/perceptual.py",
                 "gate_render_variants.py")


def test_import_guard_covers_the_variants_slice():
    files = {os.path.relpath(p, os.path.join(ROOT, "sdirt_tpu_torch"))
             for p in _package_files()}
    assert set(VARIANT_SLICE) <= files


# the modules of the deblur / F/1.8 / stack / thin-lens slice
CONFIGS_SLICE = ("dfdp/models/dddnet.py", "dfdp/models/layers.py",
                 "dfdp/basenet.py", "dfdp/train.py", "dfdp/monitor.py",
                 "dfdp/factory.py", "psfnet/stack.py", "psfnet/thinlens.py",
                 "utils/weights.py", "eval_farfield_ab.py", "dfdp_net.py")


def test_import_guard_covers_the_configs_slice():
    files = {os.path.relpath(p, os.path.join(ROOT, "sdirt_tpu_torch"))
             for p in _package_files()}
    assert set(CONFIGS_SLICE) <= files


# the modules of the optics slice (lens analysis, coherent PSFs, lens
# design, baselines)
OPTICS_SLICE = ("core/rays.py", "optics/sampling.py", "optics/surfaces.py",
                "optics/lens.py", "optics/analysis.py", "optics/optimize.py",
                "dp/psf.py", "dp/coherent.py", "utils/png.py", "psfnet/arch.py",
                "psfnet/surrogate.py", "psfnet/train.py", "psfnet/related_psf.py",
                "psfnet/baselines.py", "render/perpixel.py", "fit_psfnet.py",
                "coherent_demo.py", "demo_lens_design.py")


def test_import_guard_covers_the_optics_slice():
    files = {os.path.relpath(p, os.path.join(ROOT, "sdirt_tpu_torch"))
             for p in _package_files()}
    assert set(OPTICS_SLICE) <= files


AB_ARMS = ["--arm", "f4", "ckpt/rf50mm/Sdirt_f4_farfield",
           "ckpt/rf50mm/F4_PSFNet_mlp", "21", "--val-len", "1"]


def test_farfield_ab_defaults_to_the_card_and_raises_without_one(monkeypatch):
    """python -m sdirt_tpu_torch.eval_farfield_ab runs on the card unless
    --device names the CPU, and raises without a card instead of falling
    back; so do the new lenses."""
    from sdirt_tpu_torch import eval_farfield_ab
    from sdirt_tpu_torch.psfnet.thinlens import ThinLens

    assert inspect.signature(ThinLens.__init__).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    monkeypatch.chdir(ROOT)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_farfield_ab.main(AB_ARMS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ThinLens(50.0, 1.8, 21, [24, 36], (64, 96))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dfdp_net.main(["--stage", "sample", "--train-mode", "deblur", "--config",
                       "configs/dfdp_synthetic_train_128_deblur_cpu.yml"])


def test_gate_entry_point_defaults_to_the_card():
    from sdirt_tpu_torch import gate_render_variants

    assert gate_render_variants.parse_args([]).device == "cuda"


@pytest.mark.parametrize("variant", ["scan", "fused", "fused_int8", "basis",
                                     "basis_int8"])
def test_variants_raise_without_a_card(monkeypatch, variant):
    """Each variant, asked for on the card (the default device), raises
    without one instead of running on the CPU."""
    from sdirt_tpu_torch import gate_render_variants
    from sdirt_tpu_torch.render.pipeline import VARIANTS

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    assert variant in VARIANTS
    monkeypatch.chdir(ROOT)
    basis = variant.startswith("basis")
    argv = ["--variants", variant, "--config", "configs/dfdp_by_sdirt_rf35mm.yml"]
    if basis:
        argv += ["--model", "mlpb@256x48", "--psfnet",
                 "./ckpt/rf35mm/F4_PSFNet_mlpb@256x48"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gate_render_variants.main(argv)
    monkeypatch.setenv("SDIRT_RENDER_VARIANT", variant)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dfdp_net.main(["--stage", "sample", "--config",
                       "configs/dfdp_by_sdirt_rf35mm.yml"])


ENTRY_POINTS = [PSFNetLens.__init__, Lens.__init__, basenet.build_basenet,
                factory.get_lens, dfdp_net.run_sample, dfdp_net.run_eval,
                dfdp_net.train, resolve_device]


@pytest.mark.parametrize("fn", ENTRY_POINTS, ids=lambda f: f.__qualname__)
def test_entry_points_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_fit_entry_point_defaults_to_the_card():
    from sdirt_tpu_torch import coherent_demo, demo_lens_design

    assert fit_psfnet.parse_args([]).device == "cuda"
    assert coherent_demo.parse_args([]).device == "cuda"
    assert demo_lens_design.parse_args([]).device == "cuda"


def test_entry_points_raise_without_a_card(monkeypatch):
    from sdirt_tpu_torch import coherent_demo, demo_lens_design

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    monkeypatch.chdir(ROOT)
    args = load_config(CONFIG)
    calls = [lambda: PSFNetLens("lenses/rf50mm/lens_web.json"),
             lambda: basenet.build_basenet(),
             lambda: factory.get_lens(args),
             lambda: dfdp_net.run_sample(args),
             lambda: dfdp_net.main(["--stage", "sample", "--config", CONFIG]),
             lambda: dfdp_net.main(["--stage", "train", "--config", CONFIG]),
             lambda: dfdp_net.main(["--stage", "full", "--config", CONFIG]),
             lambda: dfdp_net.train(args),
             lambda: Lens("lenses/rf35mm/lens_web.json"),
             lambda: fit_psfnet.main(["--skip-analysis", "--iters", "0"]),
             lambda: fit_psfnet.main(["--iters", "0"]),
             lambda: coherent_demo.main([]),
             lambda: demo_lens_design.main([])]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yml")))


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_config_reader_matches_pyyaml(path):
    # the JAX app's reader is PyYAML's safe_load plus the same two casts
    assert load_config(path) == _jax_app().config(path)
