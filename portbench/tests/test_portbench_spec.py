"""BENCHMARK.json against the contract's shape: every cell, configuration,
traffic mix and per-layer metric resolves to its files by name, and every
name and unit keeps to the allowed characters."""
import importlib.util
import json
import os
import re

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|projection|head|expansion")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_resolves(conf):
    assert NAME.match(conf["name"])
    assert conf["file"].startswith("portbench/")
    with open(os.path.join(ROOT, conf["file"])) as f:
        cfg = json.load(f)
    assert cfg["name"] == conf["name"]
    assert cfg["reduced"] == conf["reduced"]
    for key in conf["reduced"]:
        assert NAME.match(key) and key in cfg and not WIDTH.search(key)
    assert any(w["config"] == conf["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_resolves(cell):
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert cell["chips"] in (1, 4) and 1 <= len(cell["why"]) <= 200
    assert cell["config"] in {c["name"] for c in BENCH["configs"]}
    path = os.path.join(BENCH_DIR, "traffic", f"{cell['traffic']}.json")
    with open(path) as f:
        traffic = json.load(f)
    assert os.path.exists(os.path.join(BENCH_DIR, "drivers", f"{traffic['driver']}.py"))
    e2e = [m for m in BENCH["end_to_end"]
           if "workloads" not in m or cell["name"] in m["workloads"]]
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    layer = [m for m in BENCH["per_layer"] if cell["name"] in m.get("workloads", [])]
    assert layer
    reported = {m["name"] for m in e2e}
    for m in layer:
        assert m["moves"] in reported, (m["name"], cell["name"])


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_names_units(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    if metric in BENCH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                    "host_clock")
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert "\n" not in metric["layer"] and 1 <= len(metric["layer"]) <= 200


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_reader_resolves(metric):
    path = os.path.join(BENCH_DIR, "metrics", f"{metric['name']}.py")
    spec = importlib.util.spec_from_file_location("reader", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert callable(mod.read)


def test_metric_names_unique():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert len({w["name"] for w in BENCH["workloads"]}) == len(BENCH["workloads"])
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(BENCH["workloads"])
