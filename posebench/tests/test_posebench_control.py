"""On the card: each cell's control, the configuration's next lower
precision in the program's place (the port's own int8 serving path for a
served bf16 model; the reference with its conv operands in fp8 for bf16
training), at the cell's own size on three seeds, is not correct. Run with
`python -m pytest posebench/tests/test_posebench_control.py` on a machine
with a card; here it skips."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())


def _control(workload: str) -> str:
    from posebench import harness

    c = harness.Cell(workload, REPO)
    return c.config["controls"][c.traffic["driver"]]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
@pytest.mark.parametrize("seed", [3_100_000_001, 3_100_000_002, 3_100_000_003])
def test_the_control_is_not_correct(card, workload, seed):
    out = subprocess.run(
        [sys.executable, "posebench/run.py", "--workload", workload, "--seed", str(seed),
         "--seconds", "3", "--control", _control(workload)],
        capture_output=True, text=True, cwd=str(REPO), timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is False, line["checks"]
