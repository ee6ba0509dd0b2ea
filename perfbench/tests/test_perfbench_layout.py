"""``BENCHMARK.json`` keeps to the benchmark's contract, and every cell,
configuration, driver and metric it names is found by name."""
import json
import re

import pytest

from perfbench.harness import core

BENCH = core.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
#: Keys that name a width, which ``reduced`` may never list.
WIDTH = re.compile(r"(_dim|_rank)$|^(hidden_size|intermediate_size|"
                   r"moe_intermediate_size|num_experts_per_tok|state_size)$|"
                   r"expan|latent")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert (core.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_a_full_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    total = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_names_units_and_lines():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names)), group
        for n in names:
            assert NAME.match(n), n
    for m in METRICS:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and _line(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])


def test_end_to_end_and_per_layer_entries():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert next(m for m in BENCH["end_to_end"]
                if m["name"] == "setup_s")["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("host_clock", "device_trace", "program_span",
                               "program_counter")
        assert m["moves"] in names and _line(m["layer"])
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_cell_found_by_name(cell):
    entry = core.cell_entry(BENCH, cell)
    wl = core.workload(cell)
    assert (wl["config"], wl["traffic"]) == (entry["config"],
                                             entry["traffic"])
    assert (core.PB / "traffic" / f"{wl['driver']}.py").exists()
    drv = core.driver(wl["driver"])
    for fn in ("setup", "window", "check"):
        assert callable(getattr(drv, fn))
    assert wl["limits"] and all(v > 0 for v in wl["limits"].values())
    e2e = core.selected_metrics(BENCH, cell, trace=False)
    per_layer = core.selected_metrics(BENCH, cell, trace=True)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert per_layer
    reported = {m["name"] for m in e2e}
    assert all(m["moves"] in reported for m in per_layer)


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_found_by_name(config):
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    assert entry["file"] == f"perfbench/configs/{config}.json"
    doc = core.config(config)
    assert doc["name"] == config and doc["source"] == entry["source"]
    assert doc["reduced"] == entry["reduced"]
    for k in entry["reduced"]:
        assert k in doc
        assert not WIDTH.search(k), k
    assert core.stated_dtype(doc) == doc["torch_dtype"]
    assert any(w["config"] == config for w in BENCH["workloads"])


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_found_by_name(metric):
    reader = core.metric_reader(metric)
    assert callable(reader.read)


def test_per_layer_lists_only_cells_that_report_what_it_moves():
    for m in BENCH["per_layer"]:
        for cell in m["workloads"]:
            reported = {e["name"] for e in
                        core.selected_metrics(BENCH, cell, trace=False)}
            assert m["moves"] in reported, (m["name"], cell)


def test_one_layer_name_per_layer():
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_benchmark_json_is_plain_json():
    json.loads((core.ROOT / "BENCHMARK.json").read_text())
