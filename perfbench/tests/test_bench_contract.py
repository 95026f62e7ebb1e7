"""`BENCHMARK.json` keeps to the benchmark's contract: names, units and
shapes of entries; every file it names is under its paths."""

import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _text_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["paths"]) <= 16
    assert len(BENCH["command"]) <= 32
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    for word in BENCH["command"]:
        assert _text_ok(word) and not word.startswith("/")


@pytest.mark.parametrize("section", sorted(KEYS))
def test_names_units_and_keys(section):
    entries = BENCH[section]
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        allowed = KEYS[section] | ({"workloads"} if section in (
            "end_to_end", "per_layer") else set())
        assert KEYS[section] <= set(e) <= allowed, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert _text_ok(e[key]), (e["name"], key)


def test_configs_cells_and_metrics_refer_to_each_other():
    configs = {c["name"] for c in BENCH["configs"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for c in BENCH["configs"]:
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    assert {w["config"] for w in BENCH["workloads"]} == configs
    for w in BENCH["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"])
        assert os.path.isfile(os.path.join(
            ROOT, "perfbench", "traffic", w["traffic"] + ".json"))
    assert len({(w["config"], w["traffic"])
                for w in BENCH["workloads"]}) == len(cells)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert set(m.get("workloads", cells)) <= cells
        assert os.path.isfile(os.path.join(ROOT, "perfbench", "metrics",
                                           m["name"] + ".py"))
    for cell in cells:
        reported = [m for m in BENCH["per_layer"]
                    if cell in m.get("workloads", cells)]
        assert reported, cell


def test_metrics_of_one_layer_name_it_alike():
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_a_roofline_share_is_named_for_its_kernel():
    for m in BENCH["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
