"""The PyTorch port's basis-student workflow against the JAX package: the
distillation (sdirt_tpu_torch/distill_basis_student.py), the teacher probe
(probe_teacher_l1.py) and the rf35mm student gate (gate_rf35_student.py).

References: sdirt_tpu_torch/reference/distill_jax_cpu.json and
distill_queries.npz (scripts/make_distill_reference.py: three float64
distillation steps of the JAX script on explicit queries) and
student_gate_jax_cpu.json (scripts/make_student_gate_reference.py: the JAX
gate script at 512x768 and 128x192).
"""

import json
import os

import numpy as np
import pytest
import torch

from sdirt_tpu_torch import distill_basis_student as distill
from sdirt_tpu_torch import gate_rf35_student, probe_teacher_l1
from sdirt_tpu_torch.psfnet.surrogate import PSFNetLens
from sdirt_tpu_torch.psfnet.train import create_train_state, make_eval_fn
from sdirt_tpu_torch.utils.weights import flax_to_torch, torch_to_flax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(ROOT, "sdirt_tpu_torch", "reference")
RF50 = os.path.join(ROOT, "lenses", "rf50mm", "lens_web.json")
WEIGHTS = os.path.join(ROOT, "sdirt_tpu_torch", "weights")
GATE_DB = 0.05


@pytest.fixture(scope="module")
def ref():
    with open(os.path.join(REF, "distill_jax_cpu.json")) as f:
        out = json.load(f)
    with np.load(os.path.join(REF, "distill_queries.npz")) as z:
        out["inp"] = z["inp"]
        out["init"] = {k[len("init/"):]: z[k] for k in z.files if k.startswith("init/")}
    return out


def _lens(model, ckpt=None):
    lens = PSFNetLens(RF50, model_name=model, kernel_size=21, sensor_res=(512, 768),
                      device="cpu")
    return lens if ckpt is None else lens.load_net(os.path.join(WEIGHTS, ckpt))


def _strip(key):
    return key[len("params/"):] if key.startswith("params/") else key


def test_distill_steps_match_jax_float64(ref):
    """Three steps at the promoted shape (teacher mlp, student mlpb@256x48
    warm from mlp@256, bs 8192, AdamW on the cosine of lr 5e-5 over
    iters // 3) on the JAX run's queries, in float64: every loss and every
    leaf's change over the steps within 1e-6 relative."""
    teacher = _lens(ref["teacher"][0], "rf50mm/F4_PSFNet_mlp.npz")
    student = _lens(ref["student"], "rf50mm/F4_PSFNet_mlp@256.npz")
    # the leaves the warm start leaves at their initialisation: the JAX run's
    student.net.load_state_dict({**student.net.state_dict(), **flax_to_torch(ref["init"])})
    teacher.net.double().eval()
    start = {k: v.clone() for k, v in student.net.double().state_dict().items()}
    state = create_train_state(student.net, ref["lr"], ref["iters"])
    step = distill.make_distill_step(teacher.net, state, ref["ks"])
    losses = [float(step(torch.from_numpy(q).double())) for q in ref["inp"]]
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-6)
    end = student.net.state_dict()
    delta = {_strip(k): float(np.linalg.norm(v)) for k, v in torch_to_flax(
        {k: end[k] - start[k] for k in end}).items()}
    want = {_strip(k): v for k, v in ref["delta_norms"].items()}
    assert set(delta) == set(want)
    for k, v in want.items():
        # the f32 export of a float64 difference: ~1e-8 relative
        assert abs(delta[k] - v) <= 1e-6 * v, (k, delta[k], v)


def test_warm_start_loads_the_jax_leaves(ref):
    """The student's trunk warm start (PSFNetLens.load_net's partial load of
    a PSFMLP tree) loads exactly the leaves the JAX partial load does."""
    fresh = _lens(ref["student"])
    before = {k: v.copy() for k, v in torch_to_flax(fresh.net.state_dict()).items()}
    after = torch_to_flax(fresh.load_net(
        os.path.join(WEIGHTS, "rf50mm", "F4_PSFNet_mlp@256.npz")).net.state_dict())
    loaded = sorted(_strip(k) for k in after if not np.array_equal(after[k], before[k]))
    assert loaded == sorted(_strip(k) for k in ref["warm_loaded"])
    assert len(after) == ref["warm_leaves"]


def _small_eval(monkeypatch, module, bs, spp):
    """The module's truth eval at bs points x spp rays."""
    monkeypatch.setattr(module, "make_eval_fn",
                        lambda lens, ks: make_eval_fn(lens, ks=ks, bs=bs, spp=spp))


def _tiny_run(tmp_path, out, *extra):
    teacher = tmp_path / "teacher.npz"
    if not teacher.exists():
        lens = PSFNetLens(RF50, model_name="mlp@32", kernel_size=11,
                          sensor_res=(512, 768), seed=1, device="cpu")
        lens.save_net(str(teacher))
    return distill.main(["--teacher", "mlp@32", "--teacher-ckpt", str(teacher),
                         "--student", "mlpb@32x4", "--bs", "32", "--iters", "6",
                         "--eval-every", "3", "--ks", "11", "--device", "cpu",
                         "--out", str(tmp_path / out), *extra])


def test_resume_replays_the_unbroken_stream(tmp_path, monkeypatch):
    """A run cut after its first checkpoint and resumed with --resume
    continues from that step on the unbroken run's draws: the same losses,
    evaluations and saved student."""
    _small_eval(monkeypatch, distill, 4, 64)
    whole = _tiny_run(tmp_path, "whole")
    assert len(whole["losses"]) == 6 and [e[0] for e in whole["evals"]] == [3, 6]
    cut = _tiny_run(tmp_path, "cut")
    os.remove(tmp_path / "cut" / "state" / "step_6.pt")
    resumed = _tiny_run(tmp_path, "cut", "--resume")
    assert resumed["start"] == 3
    assert resumed["losses"] == whole["losses"][3:] == cut["losses"][3:]
    assert resumed["evals"] == whole["evals"][1:]
    a = np.load(whole["student"])
    b = np.load(resumed["student"])
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_probe_equals_the_fit_eval(monkeypatch):
    """probe_teacher_l1 is make_eval_fn on the net, from a generator seeded
    123 (a small eval here)."""
    _small_eval(monkeypatch, probe_teacher_l1, 16, 1024)
    got = probe_teacher_l1.main(["--lens", RF50, "--model", "mlpb@256x48",
                                 "--ckpt", "ckpt/rf50mm/F4_PSFNet_mlpb@256x48",
                                 "--device", "cpu"])
    lens = _lens("mlpb@256x48", "rf50mm/F4_PSFNet_mlpb@256x48.npz")
    l1, l2 = make_eval_fn(lens, bs=16, spp=1024)(lens.net,
                                                 torch.Generator().manual_seed(123))
    assert (got["l1"], got["l2"]) == (float(l1), float(l2))
    assert 0 < got["l1"] < 1e-2


def _arguments(source: str) -> dict:
    """{flag: its default (a literal), or None} of every add_argument."""
    import ast

    out = {}
    for node in ast.walk(ast.parse(source)):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument"
                and node.args and isinstance(node.args[0], ast.Constant)):
            kw = {k.arg: k.value for k in node.keywords}
            out[node.args[0].value] = (ast.literal_eval(kw["default"])
                                       if "default" in kw else None)
    return out


@pytest.mark.parametrize("script,module", [
    ("distill_basis_student", distill), ("probe_teacher_l1", probe_teacher_l1),
    ("gate_rf35_student", gate_rf35_student)])
def test_flags_are_the_jax_scripts(script, module):
    """Each entry point takes the JAX script's flags, with its defaults, and
    --device."""
    with open(os.path.join(ROOT, "scripts", f"{script}.py")) as f:
        jax_args = _arguments(f.read())
    with open(module.__file__) as f:
        port_args = _arguments(f.read())
    assert set(port_args) == set(jax_args) | {"--device"}
    required = {"distill_basis_student": ["--out", "x"],
                "gate_rf35_student": ["--student-ckpt", "x"]}.get(script, [])
    port = vars(module.parse_args(required))
    for flag, default in jax_args.items():
        if default is not None:
            got = port[flag[2:].replace("-", "_")]
            assert (tuple(got) if isinstance(got, list) else got) == default, flag


@pytest.fixture(scope="module")
def gate_ref():
    with open(os.path.join(REF, "student_gate_jax_cpu.json")) as f:
        return json.load(f)["128x192"]


@pytest.mark.parametrize("run,argv", [
    ("mlp", []),
    ("mlpb", ["--student", "mlpb@256x48", "--variants", "basis", "scan", "scan_f32"])])
def test_student_gate_matches_jax(gate_ref, run, argv, monkeypatch):
    """The gate at 128x192 on the CPU (K2's plain version on the fused rows):
    the calibration and every agreement within 0.05 dB of the JAX script's
    run, and the same verdicts."""
    want = gate_ref["runs"][run]
    monkeypatch.setattr(gate_rf35_student, "RES", (128, 192))
    out = gate_rf35_student.main(["--student-ckpt", want["student_ckpt"],
                                  "--device", "cpu", *argv])
    cal = gate_ref["calibration"]
    assert abs(out["calibration"][0] - cal["psnr_l"]) <= GATE_DB
    assert abs(out["calibration"][1] - cal["psnr_r"]) <= GATE_DB
    assert list(out["rows"]) == list(want["rows"])
    for v, row in want["rows"].items():
        got = out["rows"][v]
        assert abs(got["agree_l"] - row["agree_l"]) <= GATE_DB, (v, got, row)
        assert abs(got["agree_r"] - row["agree_r"]) <= GATE_DB, (v, got, row)
        assert got["verdict"] == row["verdict"]


@pytest.mark.parametrize("name", ["mlp@64", "mlpb@64x12"])
def test_bf16_scan_rounds_each_dense_as_flax(name):
    """The scan variant's bf16 network rounds as a bf16 Flax Dense does:
    the product to bf16, then the bias added and rounded again. Rounding
    once (torch's Linear with its bias in the GEMM) moved the gate's scan
    agreement on the linear-head student by 0.4 dB from the JAX run's."""
    import flax
    import jax
    import jax.numpy as jnp

    from sdirt_tpu.psfnet.arch import build_psfnet as jax_build
    from sdirt_tpu_torch.psfnet.arch import build_psfnet
    from sdirt_tpu_torch.render.pipeline import _bf16_fn
    from sdirt_tpu_torch.utils.weights import flax_to_torch

    model = jax_build(name, 21)
    params = model.init(jax.random.PRNGKey(4), jnp.zeros((1, 3)))
    net = build_psfnet(name, 21)
    flat = {"params/" + k: np.asarray(v) for k, v in
            flax.traverse_util.flatten_dict(params["params"], sep="/").items()}
    net.load_state_dict(flax_to_torch(flat))
    rng = np.random.default_rng(8)
    q = np.stack([rng.uniform(-1, 1, 512), rng.uniform(-1, 1, 512),
                  rng.uniform(0, 1, 512)], -1).astype(np.float32)
    pb = jax.tree.map(lambda t: t.astype(jnp.bfloat16), params)
    want = np.asarray(model.apply(pb, jnp.asarray(q).astype(jnp.bfloat16)).astype(jnp.float32))
    with torch.no_grad():
        got = _bf16_fn(net)(torch.from_numpy(q)).numpy()
    # the same roundings; the f32 sums of exact bf16 products differ in
    # order only, which moves a rare value one bf16 step (2^-8 relative)
    scale = np.abs(want).max()
    assert np.mean(np.abs(got - want)) <= 1e-4 * scale
    assert np.abs(got - want).max() <= 2 ** -6 * scale
