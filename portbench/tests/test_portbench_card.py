"""One short run of each cell on a CUDA card through run.py, as the
benchmark's command runs it (`python -m pytest -m cuda portbench/tests`
on a machine with a card; skips without one)."""

import json
import subprocess
import sys

import pytest

from portbench.tests.conftest import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["secpol.sweep"])
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_on_the_card_prints_a_correct_result(cell, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark runs on the card only")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed", "2147483659",
         "--seconds", "3", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "check" and line["correct"] is True, out.stderr[-4000:]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert line["device"]["kind"] == torch.cuda.get_device_name(0)
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert "device_idle_pct" in line["metrics"] and "breakdown" in line
        roof = line["metrics"].get("guard_kernels_roofline")
        assert roof is None or 0 < roof["value"] <= 100
    else:
        bench = json.loads((ROOT / "BENCHMARK.json").read_text())
        assert set(line["metrics"]) == {m["name"] for m in bench["end_to_end"]}
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
