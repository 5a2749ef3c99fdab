"""Nothing of the JAX package is left to port: a check, not a claim.

  (a) every public function or class that a ``sdirt_tpu/**.py`` module
      defines exists in the port's module of the same path, or is mapped in
      RENAMED to the port's name for it, or is listed in JAX_ONLY with the
      JAX construct it is;
  (b) every name of ``sdirt_tpu._EXPORTS`` and of each sub-package's
      ``__init__`` resolves in the port's package of the same name;
  (c) every ``add_argument`` flag of ``apps/*.py`` and of each ported
      ``scripts/*.py`` is in its port entry point's parser (``--cpu`` is
      the port's ``--device``);
  (d) every file in ``apps/`` and ``scripts/`` is mapped to its port entry
      point in ENTRY_POINTS or listed in NOT_PORTED with the reason.

A new unlisted name, flag or file fails here; so does a table entry that no
longer matches anything.
"""

import ast
import glob
import importlib
import inspect
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, "sdirt_tpu")

# JAX name (module path relative to the package, "." name) -> the port's
# qualified name(s) for it
RENAMED = {
    "dfdp/models/dddnet.Disp": ["sdirt_tpu_torch.dfdp.models.dddnet.softmin_disparity"],
    "dfdp/train.DfDPState": ["sdirt_tpu_torch.dfdp.train.DfDPTrainState"],
    "psfnet/train.sample_training_points": [
        "sdirt_tpu_torch.psfnet.train.draw_training_samples",
        "sdirt_tpu_torch.psfnet.train.training_points"],
    "render/fused_conv_pallas.fused_dp_conv_tapmajor": [
        "sdirt_tpu_torch.render.fused_conv.fused_dp_conv_tapmajor"],
}

# JAX name -> the JAX-specific construct it is, which the port has no use for
JAX_ONLY = {
    "parallel/mesh.replicated": "a jax.sharding.NamedSharding for replicated "
                                "arrays; the port's ranks each hold their own copy",
    "parallel/mesh.data_sharded": "a jax.sharding.NamedSharding along the data "
                                  "axis; the port's ranks slice their batch "
                                  "(parallel/mesh.py:shard_batch)",
    "native.NativeLoaderUnavailable": "the JAX engine's signal to fall back to "
                                      "cv2; the port has no cv2 to fall back to "
                                      "and raises NativeBuildError",
}

# apps/ and scripts/ files -> the port's entry point (python -m ...)
ENTRY_POINTS = {
    "apps/coherent_demo.py": "sdirt_tpu_torch.coherent_demo",
    "apps/dfdp_net.py": "sdirt_tpu_torch.dfdp_net",
    "apps/fit_psfnet.py": "sdirt_tpu_torch.fit_psfnet",
    "scripts/demo_lens_design.py": "sdirt_tpu_torch.demo_lens_design",
    "scripts/distill_basis_student.py": "sdirt_tpu_torch.distill_basis_student",
    "scripts/dp_disparity_probe.py": "sdirt_tpu_torch.dp_disparity_probe",
    "scripts/eval_depth_ckpt.py": "sdirt_tpu_torch.eval_depth_ckpt",
    "scripts/eval_farfield_ab.py": "sdirt_tpu_torch.eval_farfield_ab",
    "scripts/finetune_real_loo.py": "sdirt_tpu_torch.finetune_real_loo",
    "scripts/gate_render_variants.py": "sdirt_tpu_torch.gate_render_variants",
    "scripts/gate_rf35_student.py": "sdirt_tpu_torch.gate_rf35_student",
    "scripts/probe_teacher_l1.py": "sdirt_tpu_torch.probe_teacher_l1",
    "scripts/run_train_supervised.sh": "sdirt_tpu_torch.run_train_supervised",
    "scripts/watch_dfdp_training.py": "sdirt_tpu_torch.watch_dfdp_training",
}

_TPU_HOST = ("drives a TPU host and its job queue; a GPU host runs the port "
             "without such a queue")
_BENCH = ("a measurement script of the JAX package: the port's benchmark "
          "(ROADMAP §1 item 1) takes its place; chip_smoke.py measures the same "
          "stages meanwhile")
_REFERENCE = ("the port's own tooling: runs the JAX package on the CPU to write "
              "what the port is held against (sdirt_tpu_torch/reference/, "
              "sdirt_tpu_torch/weights/)")
NOT_PORTED = {
    **{f"scripts/{n}_tpu_queue.py": _TPU_HOST
       for n in ("r4", "r4b", "r4c", "r4d", "r4e", "r4f", "r4g", "r4h", "r4i",
                 "r5", "r5b")},
    "scripts/tpu_queue_runner.py": _TPU_HOST,
    "scripts/tpu_preflight.py": _TPU_HOST,
    "scripts/basis_student_queue.py": _TPU_HOST,
    "scripts/post_v4ws_pipeline.py": _TPU_HOST,
    "scripts/handoff_rf35_to_v4ws.sh": _TPU_HOST,
    "scripts/w256_then_v4ws.sh": _TPU_HOST,
    "scripts/timed_trainer_stop.py": "a one-off stop schedule for a trainer on a "
                                     "TPU host",
    "scripts/ci.sh": "the JAX package's CI",
    "scripts/gate_scan_right.py": "probes a bf16 right-view fault of the TPU scan, "
                                  "which the port's scan does not have",
    "scripts/probe_scan_right.py": "probes a bf16 right-view fault of the TPU scan, "
                                   "which the port's scan does not have",
    "scripts/bench_fused_trace.py": _BENCH,
    "scripts/bench_render_variants.py": _BENCH,
    "scripts/profile_render_stages.py": _BENCH,
    "scripts/probe_trace_stages.py": _BENCH,
    "scripts/export_torch_weights.py": _REFERENCE,
    **{os.path.relpath(p, ROOT): _REFERENCE
       for p in glob.glob(os.path.join(ROOT, "scripts", "make_*_reference.py"))},
}

# a flag of the JAX entry point -> the port's flag that takes its place
FLAG_RENAMES = {"--cpu": "--device"}


def _jax_modules():
    """(path relative to the package without .py, importable name) of every
    sdirt_tpu/**.py module."""
    out = []
    for path in sorted(glob.glob(os.path.join(JAX_PKG, "**", "*.py"), recursive=True)):
        rel = os.path.relpath(path, JAX_PKG)[:-3]
        rel = rel[:-len("/__init__")] if rel.endswith("/__init__") else rel
        if rel == "__init__":
            continue
        out.append((rel, "sdirt_tpu." + rel.replace("/", ".")))
    return out


def _public_defs(mod):
    """The public functions and classes (jitted ones included) that the
    module defines itself."""
    return sorted(k for k, v in vars(mod).items()
                  if not k.startswith("_") and not inspect.ismodule(v) and callable(v)
                  and getattr(v, "__module__", None) == mod.__name__)


def _resolve(qualname):
    mod, _, name = qualname.rpartition(".")
    return getattr(importlib.import_module(mod), name)


MODULES = _jax_modules()


@pytest.mark.parametrize("rel,name", MODULES, ids=[r for r, _ in MODULES])
def test_every_public_name_has_a_counterpart(rel, name):
    jmod = importlib.import_module(name)
    try:
        port = importlib.import_module(name.replace("sdirt_tpu", "sdirt_tpu_torch", 1))
    except ModuleNotFoundError:
        port = None
    missing = []
    for defn in _public_defs(jmod):
        key = f"{rel}.{defn}"
        if key in RENAMED:
            for target in RENAMED[key]:
                _resolve(target)
        elif key not in JAX_ONLY and (port is None or not hasattr(port, defn)):
            missing.append(key)
    assert not missing, f"not in the port, RENAMED or JAX_ONLY: {missing}"


def test_the_tables_name_only_what_exists():
    """Every RENAMED and JAX_ONLY key is a public definition of the JAX
    package that the port does not have under its own name; every JAX_ONLY
    entry says why."""
    defined = {f"{rel}.{d}" for rel, name in MODULES
               for d in _public_defs(importlib.import_module(name))}
    for key in [*RENAMED, *JAX_ONLY]:
        assert key in defined, key
        rel, _, defn = key.rpartition(".")
        port = "sdirt_tpu_torch." + rel.replace("/", ".")
        try:
            assert not hasattr(importlib.import_module(port), defn), key
        except ModuleNotFoundError:
            pass
    assert not set(RENAMED) & set(JAX_ONLY)
    assert all(len(why) > 20 for why in JAX_ONLY.values())


def test_top_level_exports_resolve():
    import sdirt_tpu
    import sdirt_tpu_torch

    assert sdirt_tpu_torch.__version__ == sdirt_tpu.__version__
    assert sorted(sdirt_tpu_torch._EXPORTS) == sorted(sdirt_tpu._EXPORTS)
    for name, mod in sdirt_tpu._EXPORTS.items():
        value = getattr(sdirt_tpu_torch, name)
        assert value is getattr(importlib.import_module(
            mod.replace("sdirt_tpu", "sdirt_tpu_torch", 1)), name), name
    assert set(dir(sdirt_tpu_torch)) >= set(sdirt_tpu._EXPORTS)
    with pytest.raises(AttributeError):
        sdirt_tpu_torch.not_a_name


def _reexports(init_path, package):
    """The names a JAX sub-package's __init__ imports (a star import gives
    the public names of its module)."""
    names = []
    for node in ast.parse(open(init_path).read()).body:
        if not isinstance(node, ast.ImportFrom):
            continue
        for alias in node.names:
            if alias.name == "*":
                src = importlib.import_module(f"{package}.{node.module}")
                names += [k for k in vars(src) if not k.startswith("_")]
            else:
                names.append(alias.asname or alias.name)
    return names


SUBPACKAGES = sorted(
    os.path.relpath(os.path.dirname(p), JAX_PKG).replace("/", ".")
    for p in glob.glob(os.path.join(JAX_PKG, "**", "__init__.py"), recursive=True)
    if os.path.dirname(p) != JAX_PKG)


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_exports_resolve(sub):
    names = _reexports(os.path.join(JAX_PKG, *sub.split("."), "__init__.py"),
                       f"sdirt_tpu.{sub}")
    port = importlib.import_module(f"sdirt_tpu_torch.{sub}")
    missing = [n for n in names if not hasattr(port, n)]
    assert not missing, (sub, missing)


def _flags(path):
    """The option strings and positional names of every add_argument call."""
    out = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "add_argument":
            out |= {a.value for a in node.args
                    if isinstance(a, ast.Constant) and isinstance(a.value, str)}
    return out


def _port_file(module):
    return os.path.join(ROOT, *module.split(".")) + ".py"


@pytest.mark.parametrize("script", sorted(s for s in ENTRY_POINTS if s.endswith(".py")))
def test_entry_point_flags_are_the_jax_ones(script):
    want = {FLAG_RENAMES.get(f, f) for f in _flags(os.path.join(ROOT, script))}
    got = _flags(_port_file(ENTRY_POINTS[script]))
    assert not want - got, (script, sorted(want - got))


def test_every_app_and_script_is_ported_or_listed():
    files = sorted(os.path.relpath(p, ROOT)
                   for d in ("apps", "scripts") for p in glob.glob(os.path.join(ROOT, d, "*"))
                   if os.path.isfile(p))
    unlisted = [f for f in files if f not in ENTRY_POINTS and f not in NOT_PORTED]
    assert not unlisted, f"neither ported nor listed: {unlisted}"
    assert not set(ENTRY_POINTS) & set(NOT_PORTED)
    for f in [*ENTRY_POINTS, *NOT_PORTED]:
        assert f in files, f"listed but not in the repository: {f}"
    for module in ENTRY_POINTS.values():
        assert callable(importlib.import_module(module).main), module
