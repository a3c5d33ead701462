"""glnn_tpu_torch.experiments against the repository's JAX harness: every
experiment's dry-run plan equal to `experiments/run_experiments.py`'s flag
for flag (only the entry point differs), `reproduce_all --dry_run`, the
aggregator's table byte-equal to `experiments/aggregate_table3.py`'s (and
its one repaired divergence), a real `glnn_synth` run on the CPU, a failing
child, and the CLIs' stdout contract (the score line last). The JAX
harness scripts import no JAX; they run here as subprocesses."""

import importlib.util
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from glnn_tpu_torch.experiments import (aggregate_table3, reproduce_all,
                                        run_experiments)

REPO = Path(__file__).resolve().parent.parent
SYNTH = "synth-n256-c3-f16-d6-noise3.0"
ENTRY = {"train_teacher.py": "glnn_tpu_torch.cli.train_teacher",
         "train_student.py": "glnn_tpu_torch.cli.train_student"}


def _plan(text):
    return [line[2:].split() for line in text.splitlines()
            if line.startswith("+ ")]


def _no_child(*args, **kwargs):
    raise AssertionError(f"a dry run started a child: {args}")


def _same_plan(jax_cmds, port_cmds):
    """Equal flag for flag; JAX runs the repo-root scripts, the port the
    CLI modules."""
    assert len(port_cmds) == len(jax_cmds) > 0
    for j, p in zip(jax_cmds, port_cmds):
        assert p[0] == j[0] == sys.executable
        assert p[1:3] == ["-m", ENTRY[Path(j[1]).name]]
        assert p[3:] == j[2:]


@pytest.mark.parametrize("extra", [[], ["--device", "-1", "--data_path",
                                        "d"]], ids=["defaults", "cpu_data"])
@pytest.mark.parametrize("exp", sorted(run_experiments.EXPERIMENTS))
def test_dry_run_plan_equals_jax(exp, extra, capsys, monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    res = subprocess.run([sys.executable,
                          str(REPO / "experiments" / "run_experiments.py"),
                          exp, "--dry_run", *extra], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    monkeypatch.setattr(subprocess, "run", _no_child)
    run_experiments.main([exp, "--dry_run", *extra])
    _same_plan(_plan(res.stdout), _plan(capsys.readouterr().out))
    assert not list(tmp_path.iterdir())            # nothing written


def test_reproduce_all_dry_run(tmp_path):
    """The assertions tests/test_cli.py holds the JAX script to, then its
    CLI plan against the JAX script's, flag for flag."""
    res = subprocess.run(
        [sys.executable, "-m", "glnn_tpu_torch.experiments.reproduce_all",
         "--dry_run"], capture_output=True, text=True, cwd=tmp_path,
        env=run_experiments.child_env(), timeout=120)
    assert res.returncode == 0, res.stderr
    out = res.stdout
    assert "not ported" in out
    assert out.count("--max_epoch 200") >= 24
    assert "--dataset ogbn-products --num_exp 10 --max_epoch 40" in out
    assert "aggregate_table3" in out
    assert not list(tmp_path.iterdir())            # nothing written

    jax = subprocess.run(
        ["bash", str(REPO / "experiments" / "reproduce_all.sh"), "--dry_run",
         "./data"], capture_output=True, text=True, cwd=tmp_path, timeout=120)
    assert jax.returncode == 0, jax.stderr
    cli = [c for c in _plan(jax.stdout) if Path(c[1]).name in ENTRY]
    _same_plan(cli, [c for c in _plan(out) if c[2] in ENTRY.values()])


def test_reproduce_all_dry_run_starts_no_child(capsys, monkeypatch,
                                               tmp_path):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(subprocess, "run", _no_child)
    reproduce_all.main(["--dry_run", "--device", "-1", str(tmp_path / "d")])
    plan = _plan(capsys.readouterr().out)
    assert len(plan) == 1 + sum(1 for c in plan if c[2] in ENTRY.values())
    assert all(c[c.index("--device") + 1] == "-1"
               for c in plan if c[2] in ENTRY.values())
    assert not list(tmp_path.iterdir())


def _exp_results(root, rel, *rows):
    path = root.joinpath(*rel.split("/"), "exp_results")
    path.parent.mkdir(parents=True)
    path.write_text("".join(r + "\n" for r in rows))


def _tree(root):
    """tran, ind and student runs, several rows (the last counts), an empty
    file, and the noisy-feature and feature-aug reroutes (skipped)."""
    _exp_results(root, "transductive/cora/SAGE", " 0.7000\t 0.0100\t",
                 " 0.7929\t 0.0050\t")
    _exp_results(root, "inductive/split_rate_0.2/cora/SAGE",
                 " 0.8000\t 0.7920\t 0.0100\t 0.0100\t")
    _exp_results(root, "transductive/cora/SAGE_MLP", " 0.7828\t 0.0060\t")
    _exp_results(root, "inductive/split_rate_0.2/cora/SAGE_MLP",
                 " 0.7700\t 0.7300\t 0.0200\t 0.0300\t")
    _exp_results(root, "transductive/ogbn-products/SAGE",
                 " 0.7612\t 0.0040\t")
    _exp_results(root, "inductive/split_rate_0.2/ogbn-arxiv/SAGE_MLP3w4",
                 " 0.6600\t 0.6100\t 0.0010\t 0.0020\t")
    _exp_results(root, "transductive/pubmed/SAGE")
    _exp_results(root, "noisy_features/noise_0.5/inductive/split_rate_0.2/"
                 "cora/SAGE", " 0.1000\t 0.1000\t 0.0100\t 0.0100\t")
    _exp_results(root, "aug_features/aug_hop_1/inductive/split_rate_0.2/"
                 "ogbn-arxiv/SAGE_GA1MLP3w4", " 0.2\t 0.2\t 0.0\t 0.0\t")


def _jax_aggregate(outputs, out):
    res = subprocess.run([sys.executable,
                          str(REPO / "experiments" / "aggregate_table3.py"),
                          "--outputs", str(outputs), "--out", str(out)],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    return res.stdout


@pytest.mark.parametrize("runs", [True, False], ids=["tree", "no_outputs"])
def test_aggregator_table_equals_jax(runs, tmp_path, capsys):
    outputs = tmp_path / "outputs"
    if runs:
        _tree(outputs)
    printed = _jax_aggregate(outputs, tmp_path / "jax.txt")
    aggregate_table3.main(["--outputs", str(outputs), "--out",
                           str(tmp_path / "port.txt")])
    assert capsys.readouterr().out == printed
    assert ((tmp_path / "port.txt").read_bytes()
            == (tmp_path / "jax.txt").read_bytes())
    if runs:
        assert "79.29±0.50" in printed and "--" in printed


def test_aggregator_setting_is_the_first_component(tmp_path, capsys):
    """The repaired divergence: a transductive run with a path component
    that starts with "ind" is tran in the port and ind in JAX's
    aggregator (its `any(p.startswith("ind") ...)`)."""
    outputs = tmp_path / "outputs"
    _exp_results(outputs, "transductive/index_sweep/cora/SAGE",
                 " 0.8100\t 0.0010\t")
    spec = importlib.util.spec_from_file_location(
        "jax_aggregate_table3", REPO / "experiments" / "aggregate_table3.py")
    jax_agg = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_agg)
    assert list(jax_agg.collect(outputs)) == [("ind", "cora", "SAGE")]
    assert list(aggregate_table3.collect(outputs)) == [("tran", "cora",
                                                        "SAGE")]
    jax_table = _jax_aggregate(outputs, tmp_path / "jax.txt")
    aggregate_table3.main(["--outputs", str(outputs), "--out",
                           str(tmp_path / "port.txt")])
    port_table = capsys.readouterr().out
    tran, ind = (f"{'cora':>14} {'SAGE':>6} {s:>7}   81.00±0.10"
                 for s in ("tran", "ind"))
    assert tran in port_table and ind not in port_table
    assert ind in jax_table and tran not in jax_table


def test_glnn_synth_runs_on_the_cpu(tmp_path):
    res = subprocess.run(
        [sys.executable, "-m", "glnn_tpu_torch.experiments.run_experiments",
         "glnn_synth", "--device", "-1", "--datasets", SYNTH],
        capture_output=True, text=True, cwd=tmp_path,
        env=run_experiments.child_env(), timeout=600)
    assert res.returncode == 0, res.stderr
    assert res.stdout.count("= ") == 4             # each child's seconds
    rows = (tmp_path / "glnn_synth.txt").read_text().splitlines()
    want = [(f"tran/{SYNTH}/SAGE", 2), (f"tran/{SYNTH}/GLNN", 2),
            (f"ind/{SYNTH}/SAGE", 4), (f"ind/{SYNTH}/GLNN", 4)]
    assert len(rows) == len(want)
    dirs = {"SAGE": "SAGE", "GLNN": "SAGE_MLP"}
    for line, (label, n) in zip(rows, want):
        got_label, row = line.split("\t", 1)
        assert got_label.strip() == label
        values = [float(v) for v in row.split()]
        assert len(values) == n and all(0.0 <= v <= 1.0 for v in values)
        setting, _, model = label.split("/")
        sub = ("transductive" if setting == "tran"
               else "inductive/split_rate_0.2")
        run = tmp_path / "outputs" / sub / SYNTH / dirs[model]
        assert (run / "exp_results").read_text().split() == row.split()
        for seed in (0, 1):
            out = np.load(run / f"seed_{seed}" / "out.npz")["arr_0"]
            assert out.shape == (256, 3) and np.isfinite(out).all()
            lse = np.log(np.exp(out.astype(np.float64)).sum(1))
            assert np.abs(lse).max() <= 1e-4
            text = (run / f"seed_{seed}" / "log").read_text()
            assert "device: cpu" in text and "host graph ops: " in text
            assert '"plain_on_cuda": 0}' in text.splitlines()[-1]


def test_failing_child_fails_the_harness(tmp_path):
    res = subprocess.run(
        [sys.executable, "-m", "glnn_tpu_torch.experiments.run_experiments",
         "glnn_synth", "--device", "-1", "--datasets", "cora",
         "--data_path", str(tmp_path / "d")],
        capture_output=True, text=True, cwd=tmp_path,
        env=run_experiments.child_env(), timeout=300)
    assert res.returncode != 0
    assert "command failed:" in res.stderr
    assert "-m glnn_tpu_torch.cli.train_teacher" in res.stderr
    assert "--dataset cora" in res.stderr
    assert f"ValueError: {tmp_path / 'd' / 'cora.npz'} doesn't exist" \
        in res.stderr
    assert not (tmp_path / "glnn_synth.txt").exists()


def test_cli_stdout_ends_with_the_score_line(tmp_path):
    """The harness keeps each child's last stdout line: an ind teacher and
    its student with --num_exp 2 print that line and nothing else."""
    common = ["--device", "-1", "--dataset", SYNTH, "--exp_setting", "ind",
              "--num_exp", "2", "--max_epoch", "5", "--patience", "5",
              "--teacher", "SAGE"]
    for cli in ("train_teacher", "train_student"):
        res = subprocess.run(
            [sys.executable, "-m", f"glnn_tpu_torch.cli.{cli}", *common],
            capture_output=True, text=True, cwd=tmp_path,
            env=run_experiments.child_env(), timeout=300)
        assert res.returncode == 0, res.stderr
        lines = [ln for ln in res.stdout.splitlines() if ln.strip()]
        assert len(lines) == 1, res.stdout
        scores = [float(v) for v in lines[0].split()]
        assert len(scores) == 4 and all(math.isfinite(s) for s in scores)
