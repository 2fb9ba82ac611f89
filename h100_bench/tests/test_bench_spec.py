"""BENCHMARK.json against the benchmark's contract, and every piece it
names found by name."""

import json
import os
import re

import pytest

from h100_bench import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
E2E = {m["name"]: m for m in BENCH["end_to_end"]}
PER_LAYER = {m["name"]: m for m in BENCH["per_layer"]}
CELLS = {w["name"]: w for w in BENCH["workloads"]}


def _cells_of(metric):
    return metric.get("workloads", list(CELLS))


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["paths"]) <= 16
    assert len(BENCH["command"]) <= 32
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= len(BENCH["configs"]) <= 24
    assert 1 <= len(CELLS) <= 24
    assert 1 <= len(E2E) <= 16 and 1 <= len(PER_LAYER) <= 128


def test_names_units_and_lines():
    names = ([c["name"] for c in BENCH["configs"]] + list(CELLS)
             + list(E2E) + list(PER_LAYER))
    names += [w[k] for w in CELLS.values() for k in ("config", "traffic")]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for m in list(E2E.values()) + list(PER_LAYER.values()):
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in CELLS.values()]
                 + [c["source"] for c in BENCH["configs"]]
                 + [m["layer"] for m in PER_LAYER.values()]
                 + BENCH["command"]):
        assert LINE.match(text), text
    assert len(set(E2E) | set(PER_LAYER)) == len(E2E) + len(PER_LAYER)


def test_entries_have_just_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in CELLS.values():
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in E2E.values():
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in PER_LAYER.values():
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}


def test_every_moves_is_reported_where_its_metric_is():
    for m in PER_LAYER.values():
        assert m["moves"] in E2E, m
        for cell in _cells_of(m):
            assert cell in _cells_of(E2E[m["moves"]]), (m["name"], cell)


def test_every_cell_reports_enough():
    assert "setup_s" in E2E and "workloads" not in E2E["setup_s"]
    for cell in CELLS:
        e2e = [n for n, m in E2E.items() if cell in _cells_of(m)]
        assert "setup_s" in e2e and len(e2e) >= 2, cell
        assert any(cell in _cells_of(m) for m in PER_LAYER.values()), cell


def test_a_quantity_split_by_kind_keeps_its_layer():
    by_base = {}
    for m in PER_LAYER.values():
        by_base.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(layers) == 1 for layers in by_base.values()), by_base


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_pieces_found_by_name(cell):
    c = spec.Cell(BENCH, cell)
    cfg_entry = {x["name"]: x for x in BENCH["configs"]}[
        CELLS[cell]["config"]]
    assert cfg_entry["file"] == os.path.relpath(
        os.path.join(spec.HERE, "configs", cfg_entry["name"] + ".json"),
        spec.ROOT)
    assert c.config["reduced"] == cfg_entry["reduced"]
    assert c.traffic["mode"] in ("train_closed", "serve_closed")
    for m in c.per_layer:
        assert callable(spec.metric_reader(m["name"]))
    assert c.limits and all("limit" in v for v in c.limits.values())


def test_files_under_paths_are_named_from_names():
    for path in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", path)
        assert not path.startswith("/") and ".." not in path.split("/")
    assert BENCH["command"][1].startswith(BENCH["paths"][0] + "/")


def test_full_check_fits_its_time():
    cells = 24  # later PRs may fill the benchmark
    runs = 2 + 14 * cells
    total = runs * (BENCH["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


def test_at_most_a_quarter_of_cells_on_four_chips():
    four = sum(w["chips"] == 4 for w in CELLS.values())
    assert four <= max(1, len(CELLS) // 4)
