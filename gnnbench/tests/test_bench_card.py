"""One short run of a cell on the card: the result line's keys, the
device it names, `correct` and the checks beside their limits."""

import json
import subprocess
import sys

import pytest

from gnnbench.tests.tiny import ROOT


@pytest.mark.chip
def test_serving_cell_runs_on_the_card(card):
    out = subprocess.run(
        [sys.executable, str(ROOT / "gnnbench" / "run.py"), "--workload",
         "products-mlp-serve", "--seed", str(2 ** 31 + 7), "--seconds", "3"],
        capture_output=True, text=True, timeout=600, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"] and list(res)[-1] == "checks"
    assert res["correct"] and res["attempted"] > 0 and res["failed"] == 0
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert set(res["metrics"]) == {"setup_s", "infer_p95_ms"}
    assert out.stderr.strip().splitlines()[-1].startswith("check request_gap")
