"""The port's supervised relaunch (``python -m
sdirt_tpu_torch.run_train_supervised``, the counterpart of
scripts/run_train_supervised.sh) with a stand-in child in place of the
trainer, and its log watcher (``python -m
sdirt_tpu_torch.watch_dfdp_training``) against the JAX package's
scripts/watch_dfdp_training.py on a log the port writes.
"""

import importlib.util
import inspect
import logging
import os
import sys

import numpy as np
import pytest

from sdirt_tpu_torch import dfdp_net, run_train_supervised, watch_dfdp_training
from sdirt_tpu_torch.dfdp.monitor import ResultsMonitor
from sdirt_tpu_torch.utils.logging import set_logger
from sdirt_tpu_torch.utils.stall import STALL_EXIT_CODE

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# a child that takes the first exit code of its file, rewrites the rest and
# exits with it; a code of 137 is a SIGKILL, as the OOM killer sends
CHILD = """
import os, signal, sys
path = sys.argv[1]
codes = open(path).read().split()
with open(path + ".launches", "a") as f:
    f.write(" ".join(sys.argv[2:]) + "\\n")
code, rest = (int(codes[0]), codes[1:]) if codes else (1, [])
open(path, "w").write(" ".join(rest))
if code == 137:
    os.kill(os.getpid(), signal.SIGKILL)
sys.exit(code)
"""


@pytest.fixture
def stand_in(tmp_path, monkeypatch):
    """Replace the trainer's command by CHILD reading its exit codes from a
    file; returns a function that writes the codes and one that reads the
    launches' arguments."""
    path = str(tmp_path / "codes")

    def command(config, extra=()):
        return [sys.executable, "-c", CHILD, path, config, *extra]

    monkeypatch.setattr(run_train_supervised, "train_command", command)

    def codes(*values):
        with open(path, "w") as f:
            f.write(" ".join(map(str, values)))

    def launches():
        with open(path + ".launches") as f:
            return f.read().splitlines()

    return codes, launches


def test_relaunches_until_the_trainer_exits_cleanly(stand_in, capsys):
    """Exit 43 (the stall watchdog), then a SIGKILL (137), then 0: three
    launches with the same arguments, and exit 0."""
    codes, launches = stand_in
    codes(STALL_EXIT_CODE, 137, 0)
    rc = run_train_supervised.supervise("cfg.yml", ["--out", "x"], pause_s=0)
    assert rc == 0
    assert launches() == ["cfg.yml --out x"] * 3
    out = capsys.readouterr().out
    assert "trainer exited rc=43" in out and "trainer exited rc=137" in out
    assert "=== supervised relaunch #2 (" in out
    assert out.rstrip().endswith("=== training completed cleanly ===")


def test_gives_up_after_max_retries(stand_in, monkeypatch, capsys):
    """A trainer that always fails: MAX_RETRIES + 1 launches, each followed
    by the script's 15 s pause, then exit 1."""
    codes, launches = stand_in
    codes(*[1] * 10)
    monkeypatch.setenv("MAX_RETRIES", "3")
    pauses = []
    monkeypatch.setattr(run_train_supervised.time, "sleep", pauses.append)
    assert run_train_supervised.main(["cfg.yml"]) == 1
    assert len(launches()) == 4 and pauses == [15.0] * 4
    assert capsys.readouterr().out.rstrip().endswith("=== giving up after 3 relaunches ===")


def test_the_defaults_are_the_scripts(stand_in, monkeypatch):
    """Eight relaunches by default, and the trainer's train stage with the
    caller's arguments; the trainer's own default device (the card)."""
    codes, launches = stand_in
    codes(*[1] * 10)
    monkeypatch.delenv("MAX_RETRIES", raising=False)
    assert run_train_supervised.supervise("cfg.yml", pause_s=0) == 1
    assert len(launches()) == 9
    monkeypatch.undo()      # the real train_command again
    cmd = run_train_supervised.train_command("c.yml", ["--out", "o"])
    assert cmd[1:] == ["-m", "sdirt_tpu_torch.dfdp_net", "--config", "c.yml",
                       "--stage", "train", "--out", "o"]
    assert 'ap.add_argument("--device", default="cuda")' in inspect.getsource(dfdp_net.main)


def _monitor(rng):
    mon = ResultsMonitor()
    for _ in range(2):
        gt = rng.uniform(0.5, 5.0, (16, 24))
        mon.set_outputs({"gt_depth": gt,
                         "pred_depth_est": gt * rng.uniform(0.8, 1.25, gt.shape)})
        mon.compute_metrics()
    return mon


def _write_log(result_dir):
    """A training log as dfdp_net.train writes it: per epoch the synthetic
    validation, the real sets' tests (box first) and the epoch's loss line,
    through the port's set_logger and ResultsMonitor.logging."""
    src = inspect.getsource(dfdp_net)
    for line in ('f"Validate Depth Est on {scene}"',
                 'f"Test Depth Est on {scene} ({t_infer:.2f}s inference)"',
                 'f"Epoch {epoch}: train loss {epoch_loss / max(n_steps, 1):.4f} "'):
        assert line in src, line
    set_logger(result_dir)
    rng = np.random.default_rng(0)
    try:
        for epoch in range(3):
            if epoch:
                logging.info(f"Epoch {epoch - 1}: train loss {0.5 / epoch:.4f} "
                             f"(4 steps, 12.3s)")
            logging.info("Validate Depth Est on synthetic")
            _monitor(rng).logging(epoch, 2)
            for scene in ("box", "flat", "casual"):
                logging.info(f"Test Depth Est on {scene} (0.12s inference)")
                _monitor(rng).logging(epoch, 2)
    finally:
        for h in list(logging.getLogger().handlers):
            h.close()
            logging.getLogger().removeHandler(h)
    return os.path.join(result_dir, "train.log")


@pytest.mark.parametrize("floor", [None, "0.3"])
def test_watch_table_equals_the_jax_scripts(tmp_path, monkeypatch, capsys, floor):
    log = _write_log(str(tmp_path))
    argv = [log] + ([] if floor is None else ["--floor", floor])
    spec = importlib.util.spec_from_file_location(
        "jax_watch", os.path.join(ROOT, "scripts", "watch_dfdp_training.py"))
    jax_watch = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_watch)
    monkeypatch.setattr(sys, "argv", ["watch_dfdp_training.py", *argv])
    jax_watch.main()
    ref = capsys.readouterr().out
    watch_dfdp_training.main(argv)
    got = capsys.readouterr().out
    assert got == ref
    rows = got.splitlines()[1:]
    assert len(rows) == 3 and "nan" not in " ".join(rows[1:])
