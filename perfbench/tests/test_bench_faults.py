"""Whole runs on the CPU, past the look for a card: a sound run comes out
correct, and each fault a cell can have, planted under the timed path,
makes `correct` false."""

import json
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
CELLS = ("svj_nifty.quote_c8", "rough_heston_lift.price_c2",
         "svj_nifty.greeks_wide_c2")


def _run(workload, fault=None):
    args = [sys.executable, os.path.join(HERE, "cpu_run.py"), workload,
            "3141592653"] + (["--fault", fault] if fault else [])
    out = subprocess.run(args, cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", [None, "half_batch", "altered_answer"])
def test_correct_holds_only_for_the_sound_path(workload, fault):
    result = _run(workload, fault)
    assert result["attempted"] > 0 and result["failed"] == 0
    assert result["correct"] is (fault is None), result["checks"]
    assert list(result)[-1] == "checks"


def test_a_model_greek_cut_from_the_graph_fails_the_greeks_cell():
    result = _run("svj_nifty.greeks_wide_c2", "zero_kappa_greek")
    assert result["attempted"] > 0 and result["failed"] == 0
    assert result["correct"] is False, result["checks"]
    assert result["checks"]["flat_greeks_gap"]["value"] >= 1.0
