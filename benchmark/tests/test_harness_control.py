"""The control of the comparison, on a card at each cell's own size: the
reference in the precision below the configuration's (fp8 for bf16, int4
for int8) put in the program's place must fail the cell's limit, on three
seeds, while the program's own tokens pass it.

    python -m pytest benchmark/tests/test_harness_control.py -q -m card
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)
SECONDS = "10"


def cells():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    return [c["name"] for c in bench["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", cells())
@pytest.mark.parametrize("seed", SEEDS)
def test_the_control_fails_where_the_program_passes(card, cell, seed):
    sys.path.insert(0, str(REPO / "benchmark"))
    from harness import spec
    bench = spec.load_benchmark()
    control = spec.config(bench, spec.cell(bench, cell)["config"])["control"]
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell,
                        "--seed", str(seed), "--seconds", SECONDS, "--trace", "0",
                        "--control", control], cwd=REPO, capture_output=True,
                       text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    res = json.loads(p.stdout.splitlines()[-1])
    limit = res["checks"]["max_logit_gap"]["limit"]
    print(f"{cell} seed {seed}: program {res['checks']['max_logit_gap']['value']}"
          f" control {res['control']['max_logit_gap']} limit {limit}")
    assert res["correct"], res["checks"]
    assert res["control"]["max_logit_gap"] > limit, res["control"]
