"""glnn_tpu_torch CLIs end to end on the CPU, the out.npz handoff in both
directions between the packages (transductive and inductive), the output
layout of --exp_setting ind and --feature_aug_k against glnn_tpu's,
--save_results and --compute_min_cut, and the port's import isolation."""

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


def _out(workdir, model, setting="transductive"):
    return (workdir / "outputs" / setting / DATASET / model / "seed_0"
            / "out.npz")


IND = "inductive/split_rate_0.2"


def _tree(root):
    """The directories under root/outputs, relative to root."""
    return sorted(str(p.relative_to(root))
                  for p in (root / "outputs").rglob("*") if p.is_dir())


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


@pytest.mark.parametrize("teacher", ["SAGE", "GCN", "MLP"])
def test_port_inductive_teacher_then_student(workdir, capsys, teacher):
    from glnn_tpu_torch.cli import train_student, train_teacher

    train_teacher.main(_args("--teacher", teacher, "--exp_setting", "ind"))
    _check_out(_out(workdir, teacher, IND))
    train_student.main(_args("--teacher", teacher, "--student", "MLP",
                             "--exp_setting", "ind"))
    _check_out(_out(workdir, f"{teacher}_MLP", IND))
    # two scores per line: score_test_tran, score_test_ind
    lines = [l for l in capsys.readouterr().out.split("\n") if l.strip()]
    assert len(lines) == 2
    assert all(len(l.split()) == 2 for l in lines)
    assert all(0.0 <= float(s) <= 1.0 for l in lines for s in l.split())


@pytest.mark.parametrize("teacher_pkg", ["jax", "port"])
def test_inductive_handoff_between_packages(tmp_path, monkeypatch,
                                            teacher_pkg):
    """A teacher of one package drives the other's student in ind, and both
    packages lay out the same directories."""
    from glnn_tpu.cli import train_student as jax_student
    from glnn_tpu.cli import train_teacher as jax_teacher
    from glnn_tpu_torch.cli import train_student, train_teacher

    ports = (train_teacher, train_student)
    jaxes = (jax_teacher, jax_student)
    teacher, student = ((jaxes[0], ports[1]) if teacher_pkg == "jax"
                        else (ports[0], jaxes[1]))
    trees = []
    for root, (t, s) in ((tmp_path / "mixed", (teacher, student)),
                         (tmp_path / "jax", jaxes)):
        root.mkdir()
        monkeypatch.chdir(root)
        t.main(_args("--teacher", "GCN", "--exp_setting", "ind"))
        s.main(_args("--teacher", "GCN", "--student", "MLP",
                     "--exp_setting", "ind"))
        _check_out(_out(root, "GCN_MLP", IND))
        trees.append(_tree(root))
    assert trees[0] == trees[1]
    assert f"outputs/{IND}/{DATASET}/GCN_MLP/seed_0" in trees[0]


def _jax_run_dirs(root, argv, student=False):
    """The run directory glnn_tpu's path functions give for a CLI argv
    (after its reroutes), with root as the working directory."""
    from glnn_tpu.cli import common as jax_common
    from glnn_tpu.cli import train_student as jax_student
    from glnn_tpu.cli import train_teacher as jax_teacher

    args = (jax_student if student else jax_teacher).get_args(argv)
    jax_common.apply_output_path_reroutes(args, is_student=student)
    name = f"{args.teacher}_{args.student}" if student else args.teacher
    return jax_common.teacher_output_dir(args, name).relative_to(root)


@pytest.mark.parametrize("setting", ["tran", "ind"])
def test_feature_aug_dirs_equal_jax(tmp_path, monkeypatch, setting):
    """--feature_aug_k 2 reroutes under aug_features/aug_hop_2 and renames
    the teacher GA2GCN and the student GA2MLP, as glnn_tpu does; the
    student reads the plain GCN teacher's out.npz (seed 0). In tran both
    packages' CLIs run and lay out the same directories; glnn_tpu's ind
    feature-aug path raises (it writes into the read-only np.asarray view
    of a jax.Array, glnn_tpu/cli/train_teacher.py:221), so in ind the port
    is held to glnn_tpu's path functions."""
    from glnn_tpu.cli import train_student as jax_student
    from glnn_tpu.cli import train_teacher as jax_teacher
    from glnn_tpu_torch.cli import train_student, train_teacher

    common = ["--exp_setting", setting]
    runs = [(train_teacher, _args("--teacher", "GCN", *common)),
            (train_teacher, _args("--teacher", "GCN", "--feature_aug_k", "2",
                                  *common)),
            (train_student, _args("--teacher", "GCN", "--student", "MLP",
                                  "--feature_aug_k", "2", *common))]
    root = tmp_path / "port"
    root.mkdir()
    monkeypatch.chdir(root)
    for cli, argv in runs:
        cli.main(argv)
    for (cli, argv), model in zip(runs[1:], ("GA2GCN", "GCN_GA2MLP")):
        run_dir = _jax_run_dirs(root, argv, student=cli is train_student)
        assert run_dir.parts[1:3] == ("aug_features", "aug_hop_2")
        assert run_dir.parts[-2] == model
        _check_out(root / run_dir / "out.npz")
    if setting == "tran":
        jax_root = tmp_path / "jax"
        jax_root.mkdir()
        monkeypatch.chdir(jax_root)
        for cli, argv in runs:
            (jax_teacher if cli is train_teacher else jax_student).main(argv)
        assert _tree(root) == _tree(jax_root)


@pytest.mark.parametrize("setting,fields", [("tran", 7), ("ind", 9)])
def test_save_results_round_trips(workdir, setting, fields):
    """model.ckpt holds the best model's state dict: loaded into a fresh
    Model, its exact eval gives out.npz again; loss_and_score.npz has one
    row per eval of 7 (tran) or 9 (ind) fields."""
    from glnn_tpu_torch.cli import train_student, train_teacher
    from glnn_tpu_torch.graph.datasets import load_data
    from glnn_tpu_torch.nn import Model
    from glnn_tpu_torch.train import make_eval_fn
    from glnn_tpu_torch.utils import graph_split, load_model

    sub = "transductive" if setting == "tran" else IND
    for main, model, extra in ((train_teacher.main, "GCN", []),
                               (train_student.main, "GCN_MLP",
                                ["--student", "MLP"])):
        main(_args("--teacher", "GCN", "--exp_setting", setting,
                   "--save_results", *extra))
        run_dir = _out(workdir, model, sub).parent
        rows = np.load(run_dir / "loss_and_score.npz")["arr_0"]
        assert rows.shape == (4, fields)
        np.testing.assert_array_equal(rows[:, 0], [1, 2, 3, 4])
        assert (run_dir / "model.ckpt").is_file()

    g, labels, idx_train, idx_val, idx_test = load_data(DATASET, "./data")
    feats = torch.from_numpy(np.asarray(g.ndata["feat"], np.float32))
    conf = dict(model_name="GCN", num_layers=2, hidden_dim=64, feat_dim=32,
                label_dim=5, dropout_ratio=0.5, norm_type="none")
    model = Model(conf)
    model.load_state_dict(load_model(
        _out(workdir, "GCN", sub).parent / "model.ckpt"))
    evaluate = make_eval_fn(model, exact=True)
    if setting == "tran":
        want = evaluate(g.to_device("cpu"), feats).numpy()
    else:
        idx_obs = graph_split(idx_train, idx_val, idx_test, 0.2, 0)[3]
        want = evaluate(g.to_device("cpu"), feats).numpy()
        want[idx_obs] = evaluate(g.subgraph(idx_obs).to_device("cpu"),
                                 feats[idx_obs]).numpy()
    got = np.load(_out(workdir, "GCN", sub))["arr_0"]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("setting", ["tran", "ind"])
def test_compute_min_cut_writes_in_tran_only(workdir, setting):
    from glnn_tpu_torch.cli import train_student, train_teacher

    sub = "transductive" if setting == "tran" else IND
    train_teacher.main(_args("--teacher", "GCN", "--exp_setting", setting,
                             "--compute_min_cut"))
    train_student.main(_args("--teacher", "GCN", "--student", "MLP",
                             "--exp_setting", setting, "--compute_min_cut"))
    for model in ("GCN", "GCN_MLP"):
        path = _out(workdir, model, sub).parent.parent / "min_cut_loss"
        if setting == "ind":
            assert not path.exists()
            continue
        value = float(path.read_text().strip())
        assert 0.0 < value <= 1.0


@pytest.mark.parametrize("flag", [["--dataset", "cora"]])
def test_unported_flags_raise(workdir, flag):
    from glnn_tpu_torch.cli import train_teacher

    # every option is ported (test_torch_dist_cli.py runs --n_shards for
    # every teacher); the CPF loader without cora.npz raises the JAX
    # package's ValueError
    with pytest.raises(ValueError, match="cora.npz"):
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
