"""The harness loads neither JAX nor the JAX package, compared by whole
top-level module names, and finds configurations, mixes and metrics by
name, so that an addition edits no file."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from perfbench import harness

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "mcos_tpu_torch_like", object())
    assert "mcos_tpu_torch" not in harness.FORBIDDEN
    held = harness.forbidden_modules()
    assert "mcos_tpu_torch_like" not in held
    monkeypatch.setitem(sys.modules, "mcos_tpu.api.server", object())
    assert "mcos_tpu" in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    assert "jaxlib" in harness.forbidden_modules()


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module.split(".")[0]


def test_no_benchmark_source_imports_jax_or_the_jax_package():
    for base, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                names = set(_imports(os.path.join(base, f)))
                assert not names & set(harness.FORBIDDEN), f


def test_reference_and_load_generator_import_nothing_of_the_program():
    for sub in ("reference", "oracles"):
        for f in os.listdir(os.path.join(HERE, sub)):
            if f.endswith(".py"):
                names = set(_imports(os.path.join(HERE, sub, f)))
                assert not any(n.startswith("mcos") for n in names), f
    names = set(_imports(os.path.join(HERE, "loadgen.py")))
    assert names <= {"__future__", "json", "sys", "threading", "time",
                     "urllib"}


def test_a_process_that_loads_the_port_holds_no_jax():
    code = ("import sys; sys.path.insert(0, %r); "
            "from mcos_tpu_torch.api import server; "
            "from perfbench import harness; "
            "print(harness.forbidden_modules())" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stderr[-2000:]


@pytest.fixture
def copy(tmp_path):
    dst = tmp_path / "checkout"
    dst.mkdir()
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    shutil.copytree(HERE, dst / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return dst


def _snapshot(root):
    out = {}
    for base, _, files in os.walk(root):
        for f in files:
            p = os.path.join(base, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


#: A traffic generator of another shape than `options`: a strike ladder at
#: one maturity, its own parameters, no `length`.
LADDER = """
import random


def generate(config, mix, seed):
    rng = random.Random(seed)
    base = dict(config["requests"][mix["route"]], **mix["request"])
    out = []
    for _ in range(mix["rounds"]):
        for k in rng.sample(mix["strikes"], len(mix["strikes"])):
            out.append(dict(base, spot=mix["spot"], strike=float(k),
                            T=mix["maturity"], is_call=True))
    return out


def warm_bodies(config, mix):
    return generate(config, mix, 0)[:1]
"""

#: An oracle that needs no reference: every answer a positive price.
POSITIVE = """
def reference(cfg, bodies, device, dtype=None):
    return [None] * len(bodies)


def served(response):
    return response["price"]


def compare(served, ref):
    return {"nonpositive": float(sum(1 for p in served if not p > 0))}
"""


def test_an_addition_is_new_files_and_entries_only(copy):
    before = _snapshot(copy)
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    cfg = json.loads((copy / "perfbench/configs/svj_nifty.json").read_text())
    cfg["name"] = "svj_dummy"
    (copy / "perfbench/configs/svj_dummy.json").write_text(json.dumps(cfg))
    (copy / "perfbench/traffic/ladder.py").write_text(LADDER)
    (copy / "perfbench/oracles/positive.py").write_text(POSITIVE)
    mix = {"route": "/api/price", "generator": "ladder",
           "oracle": "positive", "clients": 2,
           "request": {"num_paths": 4096}, "spot": 22500.0,
           "strikes": [21500, 22500, 23500], "maturity": 28 / 365,
           "rounds": 40, "check": "all", "trace_seconds": 1.0,
           "limits": {"nonpositive": 0}}
    (copy / "perfbench/traffic/ladder_c2.json").write_text(json.dumps(mix))
    (copy / "perfbench/metrics/dummy.count.py").write_text(
        "def read(run):\n    return float(len(run.window))\n")
    bench["configs"].append({"name": "svj_dummy", "source": "x",
                             "file": "perfbench/configs/svj_dummy.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "svj_dummy.ladder_c2",
                               "config": "svj_dummy", "traffic": "ladder_c2",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "dummy.count", "unit": "req",
                               "better": "higher", "source": "host_clock",
                               "layer": "service", "moves": "req_per_s",
                               "workloads": ["svj_dummy.ladder_c2"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _snapshot(copy)
    changed = {k for k in before if before[k] != after.get(k)}
    assert changed == {"BENCHMARK.json"}
    cell = harness.Cell("svj_dummy.ladder_c2", root=str(copy))
    assert cell.config["name"] == "svj_dummy" and cell.mix["clients"] == 2
    assert [m["name"] for m in cell.metrics("per_layer")] == ["dummy.count"]
    reader = harness.load_module(
        str(copy / "perfbench/metrics/dummy.count.py"), "dummy_count")
    assert reader.read(type("R", (), {"window": [1, 2]})) == 2.0
    # A whole run of the new cell on the CPU, from the copy's files.
    out = subprocess.run(
        [sys.executable, os.path.join(HERE, "tests", "cpu_run.py"),
         "svj_dummy.ladder_c2", "7", "--root", str(copy)], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["attempted"] > 0
    assert result["checks"] == {"nonpositive": {"value": 0.0, "limit": 0}}
    assert set(result["metrics"]) == {"req_per_s", "p50_ms", "setup_s"}
    assert _snapshot(copy) == after


def test_a_run_without_the_program_gives_no_result(copy):
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "svj_nifty.quote_c8", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=copy, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
