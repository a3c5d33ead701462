"""`--n_shards 4` through the port's CLIs on 4 gloo ranks (CPU): each
out.npz against `glnn_tpu`'s `--n_shards 4` run and the port's
single-process run (argmax agreement on >= 0.99 of the nodes, the bar of
tests/test_dist_runner.py), and the run's log (every rank's backend and
device, the launches line).

GAT and APPNP run on the less noisy synth graph (noise 0.5), where every
run converges within 8 epochs: on the noise-3.0 graph GAT reaches 0.84-0.87
test accuracy, and two runs from different initial weights (the port's
and JAX's single-process teachers) agree there on about 0.80 of the
nodes, so agreement says nothing of the sharded path. The halo steps
themselves are held to JAX's from its initial weights, and to the port's
single-process steps with dropout on, in
tests/test_torch_halo_attention.py. The locality relabel's per-tier edge
budget is held to JAX's without processes."""

import numpy as np
import pytest
import torch

from native_tiers import tier  # noqa: F401  (fixture: native, numpy)

DATASET = "synth-n512-c5-f32-d8-noise3.0"
EASY = ["--dataset", "synth-n512-c5-f32-d8-noise0.5", "--max_epoch", "8"]
EPOCHS = ["--max_epoch", "15", "--patience", "10"]


def _args(root, *extra):
    return ["--device", "-1", "--dataset", DATASET, *EPOCHS,
            "--output_path", str(root / "outputs"), *extra]


def _out(root, model, setting="transductive"):
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
    assert "launches {" in text and '"plain_on_cuda": 0' in text


@pytest.mark.parametrize("teacher,extra,setting", [
    ("SAGE", ["--sage_sampling", "full"], "transductive"),
    ("GCN", ["--exp_setting", "ind"], "inductive"),
    ("GAT", EASY + ["--save_results"], "transductive"),
    ("APPNP", EASY, "transductive"),
    ("APPNP", EASY + ["--exp_setting", "ind"], "inductive"),
])
def test_teacher_n_shards_matches_jax_and_single_process(
        tmp_path, monkeypatch, capsys, teacher, extra, setting):
    from glnn_tpu.cli.train_teacher import main as jax_teacher
    from glnn_tpu_torch.cli import train_teacher

    monkeypatch.chdir(tmp_path)
    runs = {"port4": ["--n_shards", "4"], "port1": [],
            "jax4": ["--n_shards", "4"]}
    for name, shards in runs.items():
        main = jax_teacher if name == "jax4" else train_teacher.main
        main(_args(tmp_path / name, "--teacher", teacher, *extra, *shards))
    lines = capsys.readouterr().out.split("\n")
    n_scores = 2 if setting == "inductive" else 1
    assert all(len(line.split()) == n_scores for line in lines if line.strip())
    out4, log = _out(tmp_path / "port4", teacher, setting)
    _check_log(log)
    for name in ("port1", "jax4"):
        agree = _agree(out4, _out(tmp_path / name, teacher, setting)[0])
        assert agree >= 0.99, f"{teacher} --n_shards 4 vs {name}: {agree}"
    if "--save_results" in extra:
        _check_saved_eval(log.parent, out4, extra)


def _check_saved_eval(run_dir, out4, extra):
    """The sharded run's out.npz (its halo exact eval, unrelabelled) is the
    single-device exact eval of its saved best weights on the original
    graph, up to summation order."""
    from glnn_tpu_torch.cli import train_teacher
    from glnn_tpu_torch.graph.datasets import load_synth_data
    from glnn_tpu_torch.nn.models import Model
    from glnn_tpu_torch.train import make_eval_fn
    from glnn_tpu_torch.utils import get_training_config, load_model
    from glnn_tpu_torch.utils.config import merge_args_with_config

    dataset = extra[extra.index("--dataset") + 1]
    g, labels, *_ = load_synth_data(dataset, 0, 20, 30)
    args = train_teacher.get_args(["--teacher", "GAT"])
    conf = merge_args_with_config(
        dict(vars(args), feat_dim=g.ndata["feat"].shape[1],
             label_dim=int(labels.max()) + 1),
        get_training_config(args.model_config_path, "GAT", dataset))
    model = Model(conf)
    model.load_state_dict(load_model(run_dir / "model.ckpt"))
    got = make_eval_fn(model, exact=True)(
        g.to_device("cpu"), torch.as_tensor(g.ndata["feat"])).numpy()
    np.testing.assert_allclose(out4, got, rtol=1e-4, atol=1e-4)


def test_student_n_shards_matches_jax_and_single_process(tmp_path,
                                                         monkeypatch):
    from glnn_tpu.cli.train_student import main as jax_student
    from glnn_tpu_torch.cli import train_student, train_teacher

    monkeypatch.chdir(tmp_path)
    teacher = tmp_path / "teacher"
    train_teacher.main(_args(teacher, "--teacher", "GCN"))
    outs = {}
    # from other initial weights the students agree once trained to the
    # teacher (60 epochs; 15 leave them at 0.90)
    for name, shards in (("port4", ["--n_shards", "4"]), ("port1", []),
                         ("jax4", ["--n_shards", "4"])):
        main = jax_student if name == "jax4" else train_student.main
        main(_args(tmp_path / name, "--teacher", "GCN", "--student", "MLP",
                   "--out_t_path", str(teacher / "outputs"), *shards,
                   "--max_epoch", "60", "--patience", "60"))
        outs[name] = _out(tmp_path / name, "GCN_MLP")
    _check_log(outs["port4"][1])
    for name in ("port1", "jax4"):
        agree = _agree(outs["port4"][0], outs[name][0])
        assert agree >= 0.99, f"student --n_shards 4 vs {name}: {agree}"


def test_student_from_sharded_gat_teacher(tmp_path, monkeypatch):
    """A data-parallel MLP student distilled from the sharded GAT teacher's
    out.npz agrees with the single-process student from the same out.npz."""
    from glnn_tpu_torch.cli import train_student, train_teacher

    monkeypatch.chdir(tmp_path)
    teacher = tmp_path / "teacher"
    train_teacher.main(_args(teacher, "--teacher", "GAT", "--n_shards", "4",
                             *EASY))
    outs = {}
    for name, shards in (("port4", ["--n_shards", "4"]), ("port1", [])):
        train_student.main(_args(tmp_path / name, "--teacher", "GAT",
                                 "--student", "MLP", "--out_t_path",
                                 str(teacher / "outputs"), *shards, *EASY))
        outs[name] = _out(tmp_path / name, "GAT_MLP")
    _check_log(outs["port4"][1])
    agree = _agree(outs["port4"][0], outs["port1"][0])
    assert agree >= 0.99, f"student --n_shards 4 vs port1: {agree}"


def test_sampled_sage_teacher_n_shards_finishes(tmp_path, monkeypatch,
                                                capsys):
    from glnn_tpu_torch.cli import train_teacher

    monkeypatch.chdir(tmp_path)
    train_teacher.main(_args(tmp_path, "--teacher", "SAGE", "--n_shards", "4",
                             "--max_epoch", "3"))
    score = capsys.readouterr().out.split()
    assert len(score) == 1 and 0.0 <= float(score[0]) <= 1.0
    out, log = _out(tmp_path, "SAGE")
    np.testing.assert_allclose(np.exp(out).sum(1), 1.0, rtol=1e-4)
    _check_log(log)
    assert "halo graph: 512 nodes, rows 128 per shard" in log.read_text()


def test_locality_relabel_budget_follows_the_tier(tier, monkeypatch):
    """The relabel of a graph above the numpy tier's edge budget (patched
    down to 1,000 edges in both packages; the synth graph has more): the
    native tier relabels it to the arrays of JAX's `_locality_relabel`
    with its library, the numpy tier skips it as JAX's does without its
    library. Each logs its tier."""
    import logging

    from glnn_tpu import native as jnative
    from glnn_tpu.cli import train_teacher as jax_teacher
    from glnn_tpu.graph.datasets import load_synth_data as jax_load
    from glnn_tpu_torch.cli import sharded
    from glnn_tpu_torch.graph.datasets import load_synth_data

    monkeypatch.setitem(sharded.LOCALITY_MAX_EDGES, "numpy", 1000)
    monkeypatch.setattr(jax_teacher, "_LOCALITY_MAX_EDGES", 1000)
    if tier == "numpy":
        monkeypatch.setattr(jnative, "available", lambda: False)
    g, labels, *idxs = load_synth_data(DATASET, 0, 20, 30)
    gj, labels_j, *idxs_j = jax_load(DATASET, 0, 20, 30)
    assert g.num_edges() > 1000
    feats = np.asarray(g.ndata["feat"])
    lines = []
    logger = logging.getLogger("test_torch_dist_cli.relabel")
    monkeypatch.setattr(logger, "info", lines.append)
    got = sharded.locality_relabel(g, feats, labels, tuple(idxs), 4, logger)
    want = jax_teacher._locality_relabel(gj, np.asarray(gj.ndata["feat"]),
                                         labels_j, tuple(idxs_j), 4, logger)
    if tier == "numpy":
        assert got[4] is None and want[4] is None and got[0] is g
        assert "the numpy label-propagation tier's budget" in lines[0]
        return
    assert "locality relabel: native label propagation" in lines[0]
    np.testing.assert_array_equal(got[4], want[4])
    np.testing.assert_array_equal(got[0].src, want[0].src)
    np.testing.assert_array_equal(got[0].dst, want[0].dst)
    for a, b in zip(got[1:3] + got[3], want[1:3] + want[3]):
        np.testing.assert_array_equal(a, b)
