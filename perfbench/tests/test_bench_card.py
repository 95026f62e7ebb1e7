"""A whole run on the card, short: the result line's shape. Skips without
a CUDA device."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@pytest.mark.card
@pytest.mark.parametrize("traced", [0, 1])
def test_a_short_quote_run_on_the_card(card, traced):
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "svj_nifty.quote_c8", "--seed", str(2**31 + 11), "--seconds", "5",
         "--trace", str(traced)], cwd=ROOT, capture_output=True, text=True,
        timeout=360)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    if traced:
        assert result["device"]["busy_s"] > 0
        assert "device_idle_share" in result["metrics"]
    else:
        assert set(result["metrics"]) == {"req_per_s", "p50_ms", "setup_s"}
