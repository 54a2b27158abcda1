"""The control at a size a test run holds: the reference in fp8, and the
planted faults, put in the program's place, read far above what the
program reads; and the card's run of the control, at the cells' sizes, is
``python3 -m portbench.control`` (``test_control_on_the_card``)."""

import subprocess
import sys

import pytest

from portbench import control, run
from portbench.tests import tiny


@pytest.mark.parametrize("name", ["mistral7b.train.s4096",
                                  "vitb16.train.b256"])
def test_training_control_reads_above_the_program(name):
    cell = tiny.cell(name)
    rows = {r["reading"]: r for r in control.train_readings(cell, 31, "cpu")}
    line, _ = run.execute(run.Run(cell, 31, 0.3, False, device="cpu"))
    sound = {k: v["value"] for k, v in line["checks"].items()}
    # the control fails one of the cell's numbers: it reads 3x or more of
    # the sound run's
    assert max(rows["fp8"][k] / sound[k] for k in sound) >= 3.0, (rows, sound)
    assert max(rows["half_batch"][k] / sound[k] for k in sound) >= 3.0


def test_serving_control_reads_above_the_program():
    cell = tiny.cell("mistral7b.serve.open")
    rows = {r["reading"]: r for r in control.serve_readings(cell, 31, "cpu",
                                                            0.3)}
    line, _ = run.execute(run.Run(cell, 31, 0.3, False, device="cpu"))
    sound = line["checks"]["served_gap"]["value"]
    assert rows["altered_token"]["served_gap"] > 1.0
    assert rows["fp8"]["served_gap"] >= 3.0 * sound, (rows, sound)


@pytest.mark.cuda
def test_control_on_the_card(card):
    """The control's readings at the cells' own sizes, one seed."""
    out = subprocess.run(
        [sys.executable, "-m", "portbench.control", "--workload",
         "vitb16.train.b256", "--seeds", "101"],
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    assert '"reading": "fp8"' in out.stdout
