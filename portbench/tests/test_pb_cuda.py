"""On the card: one short run of a cell end to end, through the command
`BENCHMARK.json` names."""

import json
import subprocess
import sys

import pytest


@pytest.mark.cuda
def test_a_short_run_is_correct(card, tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "vitb16.train.b256", "--seed", "2147483659", "--seconds", "3",
         "--trace", "1"], capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["busy_s"] > 0
    assert "step_mfu.train" in line["metrics"]
    assert list(line)[-1] == "checks"
