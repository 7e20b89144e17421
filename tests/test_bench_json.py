"""Driver-contract test for bench.py: the FIRST stdout line must be a
complete, valid JSON object with the metric keys — printed before any
secondary probe runs (round-3 regression: an external timeout during a
late secondary left stdout empty, BENCH_r03.json rc=124/parsed:null)."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_bench_first_stdout_line_is_headline_json():
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py"),
         "--cpu", "--size=32", "--steps=5", "--no-secondaries"],
        capture_output=True, text=True, timeout=600, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    assert lines, f"no stdout at all; stderr: {proc.stderr[-2000:]}"
    rec = json.loads(lines[0])
    assert rec["unit"] == "cell-updates/s"
    assert rec["value"] > 0
    assert rec["device"]["platform"] == "cpu"
    assert rec["device"]["count"] >= 1 and rec["device"]["kind"]
    assert "dct" in rec["metric"].lower() or \
        rec["extra"]["projection"] == "dct"
    assert rec["extra"]["finite"] is True
    # the headline is the only stdout line (driver contract: ONE line)
    assert len(lines) == 1, lines
