"""glnn_tpu_torch CLIs end to end on the CPU, the out.npz handoff in both
directions between the packages, and the port's import isolation."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

DATASET = "synth-n512-c5-f32-d8-noise3.0"
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture()
def workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _args(*extra):
    return ["--device", "-1", "--dataset", DATASET, "--max_epoch", "4",
            "--patience", "10", *extra]


def _out(workdir, model):
    return (workdir / "outputs" / "transductive" / DATASET / model / "seed_0"
            / "out.npz")


def _check_out(path, rows=512, classes=5):
    out = np.load(path)["arr_0"]
    assert out.shape == (rows, classes)
    np.testing.assert_allclose(np.exp(out).sum(1), 1.0, rtol=1e-4)
    assert (path.parent.parent / "exp_results").exists()
    return out


@pytest.mark.parametrize("teacher", ["SAGE", "MLP"])
def test_port_teacher_then_student(workdir, capsys, teacher):
    from glnn_tpu_torch.cli import train_student, train_teacher

    train_teacher.main(_args("--teacher", teacher))
    _check_out(_out(workdir, teacher))
    train_student.main(_args("--teacher", teacher, "--student", "MLP"))
    _check_out(_out(workdir, f"{teacher}_MLP"))
    lines = capsys.readouterr().out.split("\n")
    scores = [float(l) for l in lines if l.strip()]
    assert len(scores) == 2 and all(0.0 <= s <= 1.0 for s in scores)


def test_jax_teacher_drives_port_student(workdir):
    from glnn_tpu.cli.train_teacher import main as jax_teacher
    from glnn_tpu_torch.cli import train_student

    jax_teacher(_args("--teacher", "GCN"))
    train_student.main(_args("--teacher", "GCN", "--student", "MLP"))
    _check_out(_out(workdir, "GCN_MLP"))


def test_port_teacher_drives_jax_student(workdir):
    from glnn_tpu.cli.train_student import main as jax_student
    from glnn_tpu_torch.cli import train_teacher

    train_teacher.main(_args("--teacher", "SAGE", "--num_exp", "2"))
    jax_student(_args("--teacher", "SAGE", "--student", "MLP"))
    _check_out(_out(workdir, "SAGE_MLP"))
    # --num_exp 2: one line of mean and std per score
    line = (_out(workdir, "SAGE").parent.parent / "exp_results").read_text()
    assert len(line.split()) == 2


@pytest.mark.parametrize("flag", [
    ["--exp_setting", "ind"], ["--n_shards", "2"],
    ["--sampler_tier", "window"], ["--compute_dtype", "bfloat16"],
    ["--feature_aug_k", "2"], ["--compute_min_cut"], ["--save_results"],
    ["--dataset", "cora"]])
def test_unported_flags_raise(workdir, flag):
    from glnn_tpu_torch.cli import train_teacher

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train_teacher.main(_args("--teacher", "SAGE", *flag))


def test_gpu_ordinal_without_gpu_raises(workdir, monkeypatch):
    from glnn_tpu_torch.cli import train_teacher

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = _args("--teacher", "SAGE")
    args[1] = "0"
    with pytest.raises(RuntimeError, match="--device -1"):
        train_teacher.main(args)


def test_debug_checks_stop_on_non_finite_loss(workdir):
    from glnn_tpu_torch.cli import train_teacher

    cfg = workdir / "c.yaml"          # no synth rows: the CLI's rate holds
    cfg.write_text("defaults:\n  num_layers: 2\n  hidden_dim: 16\n")
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        train_teacher.main(_args("--teacher", "MLP", "--debug_checks",
                                 "--learning_rate", "1e30",
                                 "--model_config_path", str(cfg)))


def test_student_fails_without_teacher(workdir):
    from glnn_tpu_torch.cli import train_student

    with pytest.raises(ValueError, match="No such file"):
        train_student.main(_args("--teacher", "SAGE", "--student", "MLP"))


def test_port_imports_neither_jax_nor_glnn_tpu():
    code = """
import importlib, pkgutil, sys
import glnn_tpu_torch
names = [m.name for m in pkgutil.walk_packages(glnn_tpu_torch.__path__,
                                               'glnn_tpu_torch.')]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = [m for m in sys.modules
       if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'glnn_tpu')]
assert not bad, bad
assert len(names) >= 25, names
print(len(names))
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
