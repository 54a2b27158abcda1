"""BENCHMARK.json keeps to the benchmark's format and limits, and every file a
cell, configuration or metric names is there and loads."""

import json
import os
import re

import pytest

from portbench import cells, program
from portbench.weights import n_params

BENCH = cells.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
# a width: hidden, intermediate, latent, state or projection sizes, head
# sizes, keys ending in _dim or _rank, expansion factors, experts a token
WIDTHS = re.compile(r"(hidden_size|intermediate_size|latent|state_size|"
                    r"proj|head_size|_dim$|_rank$|expan|experts_per_tok)")


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["portbench"]
    assert len(json.dumps(BENCH)) < 64 * 1024
    for word in BENCH["command"]:
        assert 1 <= len(word) <= 200 and not word.startswith("/")
    n = len(BENCH["workloads"])
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, n // 4)


def test_names_units_and_lines():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    for name in names:
        assert NAME.match(name), name
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in BENCH[k]}) == len(BENCH[k])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for x in BENCH["configs"] + BENCH["workloads"] + BENCH["per_layer"]:
        for key in ("why", "layer", "source"):
            if key in x:
                assert 1 <= len(x[key]) <= 200 and "\n" not in x[key] \
                    and "\t" not in x[key], (x["name"], key)


def test_end_to_end_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for cell in CELLS:
        reported = [m for m in e2e.values()
                    if cell in m.get("workloads", CELLS)]
        assert "setup_s" in [m["name"] for m in reported]
        assert len(reported) >= 2


def test_per_layer_metrics_move_what_their_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in CELLS
            assert cell in moved.get("workloads", CELLS)
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] \
                or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in CELLS:
        assert any(cell in m["workloads"] for m in BENCH["per_layer"])


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_files(config):
    assert config["file"].startswith("portbench/configs/")
    c = cells.load_json(os.path.join(cells.ROOT, config["file"]))
    for key in config["reduced"]:
        assert key in c["changed"]
        assert not WIDTHS.search(key), key
    assert set(c["changed"]) == set(config["reduced"])
    assert program.config(c, {"remat": False}) is not None
    assert n_params(c) > 0


@pytest.mark.parametrize("cell", CELLS)
def test_cells_load_with_their_files(cell):
    c = cells.load_cell(cell)
    assert c.chips in (1, 4)
    assert c.limits and all(v > 0 for v in c.limits.values())
    assert cells.driver(c.driver).run
    for m in c.per_layer:
        assert callable(cells.metric_reader(m["name"]))


def test_pending_cells_load_and_keep_to_the_same_rules():
    """A pending cell's entries would pass these tests in BENCHMARK.json."""
    full = cells.catalog()
    names = [w["name"] for w in full["workloads"]]
    assert len(set(names)) == len(names)
    for cell in set(names) - set(CELLS):
        c = cells.load_cell(cell)
        assert c.end_to_end and c.per_layer and c.limits
        for m in c.per_layer:
            assert m["moves"] in {e["name"] for e in c.end_to_end}


def test_every_metric_file_is_named_in_the_benchmark():
    named = {m["name"] for m in cells.catalog()["per_layer"]}
    files = {f[:-3] for f in os.listdir(os.path.join(cells.HERE, "metrics"))
             if f.endswith(".py") and not f.startswith("_")}
    assert files == named
