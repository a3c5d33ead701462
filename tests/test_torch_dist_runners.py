"""The runners inside a rank: `--n_shards 4` on 4 gloo ranks (CPU) for the
paths that tests/test_torch_dist_cli.py leaves out (the MLP teacher in
both settings, and the inductive MLP student), each out.npz against the
port's single-process run (argmax agreement on >= 0.99 of the nodes, the
bar of that file). The data-parallel MLP epoch is the single-device
epoch up to summation order, from the same initial weights.

And the seam itself: the op surface, the models and the engine load no
module of `glnn_tpu_torch.distributed`; a rank brings its sharding to
them (cli/sharded.py passes the engine a rank placement, and a halo
shard brings its own op forms)."""

import subprocess
import sys

import numpy as np
import pytest

DATASET = "synth-n512-c5-f32-d8-noise3.0"
EPOCHS = ["--max_epoch", "15", "--patience", "10"]


def _args(root, *extra):
    return ["--device", "-1", "--dataset", DATASET, *EPOCHS,
            "--output_path", str(root / "outputs"), *extra]


def _out(root, model, setting):
    path = next((root / "outputs").rglob(
        f"{setting}/**/{model}/seed_0/out.npz"))
    out = np.load(path)["arr_0"]
    assert out.shape == (512, 5) and np.isfinite(out).all()
    return out, path.parent / "log"


def _agree(a, b) -> float:
    return float((a.argmax(1) == b.argmax(1)).mean())


def _check_log(log):
    text = log.read_text()
    for r in range(4):
        assert f"rank {r} of 4: backend gloo, device cpu" in text
    assert "launches {" in text


def _scores(capsys, n_scores):
    lines = [line for line in capsys.readouterr().out.split("\n")
             if line.strip()]
    assert lines and all(len(line.split()) == n_scores for line in lines)
    assert all(0.0 <= float(s) <= 1.0 for line in lines for s in line.split())


@pytest.mark.parametrize("setting,extra", [
    ("transductive", []),
    ("inductive", ["--exp_setting", "ind"]),
])
def test_mlp_teacher_n_shards_matches_single_process(
        tmp_path, monkeypatch, capsys, setting, extra):
    from glnn_tpu_torch.cli import train_teacher

    monkeypatch.chdir(tmp_path)
    for name, shards in (("port4", ["--n_shards", "4"]), ("port1", [])):
        train_teacher.main(_args(tmp_path / name, "--teacher", "MLP",
                                 *extra, *shards))
    _scores(capsys, 2 if setting == "inductive" else 1)
    out4, log = _out(tmp_path / "port4", "MLP", setting)
    _check_log(log)
    out1, _ = _out(tmp_path / "port1", "MLP", setting)
    agree = _agree(out4, out1)
    assert agree >= 0.99, f"MLP {setting} --n_shards 4 vs port1: {agree}"


def test_inductive_student_n_shards_matches_single_process(
        tmp_path, monkeypatch, capsys):
    from glnn_tpu_torch.cli import train_student, train_teacher

    monkeypatch.chdir(tmp_path)
    ind = ["--exp_setting", "ind"]
    teacher = tmp_path / "teacher"
    train_teacher.main(_args(teacher, "--teacher", "GCN", *ind))
    capsys.readouterr()
    for name, shards in (("port4", ["--n_shards", "4"]), ("port1", [])):
        train_student.main(_args(tmp_path / name, "--teacher", "GCN",
                                 "--student", "MLP", "--out_t_path",
                                 str(teacher / "outputs"), *ind, *shards))
    _scores(capsys, 2)
    out4, log = _out(tmp_path / "port4", "GCN_MLP", "inductive")
    _check_log(log)
    out1, _ = _out(tmp_path / "port1", "GCN_MLP", "inductive")
    agree = _agree(out4, out1)
    assert agree >= 0.99, f"inductive student --n_shards 4 vs port1: {agree}"


def test_ops_nn_and_engine_load_nothing_of_distributed():
    code = ("import sys\n"
            "import glnn_tpu_torch.ops, glnn_tpu_torch.nn.models, "
            "glnn_tpu_torch.train.engine\n"
            "print(sorted(m for m in sys.modules "
            "if m.startswith('glnn_tpu_torch.distributed')))\n")
    done = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert done.returncode == 0, done.stderr
    assert done.stdout.strip() == "[]", done.stdout
