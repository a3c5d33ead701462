"""No run loads JAX or the JAX package (whole top-level names), and the
benchmark refuses to run without the card."""

import subprocess
import sys

from gnnbench.harness import FORBIDDEN
from gnnbench.tests.tiny import ROOT

RUN = """
import sys
sys.path.insert(0, {root!r})
import torch
from glnn_tpu_torch import ops
ops._tier_selected = lambda device: True
from gnnbench.harness import forbidden_modules
from gnnbench.tests.tiny import run
res = run({cell!r}, traced=True)
print(sorted({{m.split('.')[0] for m in sys.modules}}))
print('FORBIDDEN', forbidden_modules())
"""


def test_no_jax_in_a_run_of_each_loop():
    for cell in ("arxiv-gat-powerlaw", "products-mlp-serve"):
        out = subprocess.run(
            [sys.executable, "-c", RUN.format(root=str(ROOT), cell=cell)],
            capture_output=True, text=True, timeout=600, cwd=str(ROOT))
        assert out.returncode == 0, out.stderr[-3000:]
        top = eval(out.stdout.splitlines()[-2])
        assert "glnn_tpu_torch" in top and "gnnbench" in top
        assert not set(top) & set(FORBIDDEN)
        assert out.stdout.splitlines()[-1] == "FORBIDDEN []"


def test_whole_names_are_compared(monkeypatch):
    from gnnbench import harness

    monkeypatch.setitem(sys.modules, "glnn_tpu_torch_extra", sys)
    assert "glnn_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "glnn_tpu.ops", sys)
    assert "glnn_tpu" in harness.forbidden_modules()


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, str(ROOT / "gnnbench" / "run.py"), "--workload",
         "products-mlp-serve", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, timeout=300, cwd=str(ROOT),
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
