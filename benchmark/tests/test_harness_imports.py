"""What a run may load and where it may run: no JAX and no JAX package,
compared by whole top-level names; a reference that imports nothing of the
program; no result without a card, or outside a checkout of the repo."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from harness import guard

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent


def test_the_guard_compares_whole_top_level_names():
    assert guard.forbidden_loaded({"swiftllm_tpu_torch": 1,
                                   "swiftllm_tpu_torch.ops": 1}) == []
    assert guard.forbidden_loaded({"swiftllm_tpu.ops": 1}) == ["swiftllm_tpu"]
    assert guard.forbidden_loaded({"jax._src": 1, "flax": 1, "jaxlib": 1}) == \
        ["flax", "jax", "jaxlib"]
    assert guard.forbidden_loaded({"jaxtyping": 1, "numpy": 1}) == []


def imported(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert imported(path) <= {"__future__", "math", "torch"}


def test_no_file_of_the_benchmark_imports_jax():
    for path in BENCH.rglob("*.py"):
        assert not imported(path) & guard.FORBIDDEN, path


def run_py(cwd, *args):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "benchmark/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300, env=env)


ARGS = ("--workload", "qwen2-7b.chat-poisson", "--seed", "2147483659",
        "--seconds", "1", "--trace", "0")


def test_no_result_without_a_card():
    p = run_py(REPO, *ARGS)
    assert p.returncode == 2, p.stderr
    assert "CUDA" in p.stderr
    assert not any(line.startswith("{") for line in p.stdout.splitlines())


def test_no_result_in_a_directory_of_the_benchmark_alone(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = run_py(tmp_path, *ARGS)
    assert p.returncode != 0
    assert not any(line.startswith("{") for line in p.stdout.splitlines())


def test_a_small_run_loads_no_jax():
    code = ("import sys; sys.path[:0] = ['benchmark/tests', 'benchmark', '.'];"
            "from smallcell import run_small; from harness import guard;"
            "r = run_small('tiny-qwen2', 'tiny-open', 5, seconds=0.5);"
            "print(r['correct'], guard.forbidden_loaded())")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.split()[-2:] == ["True", "[]"]


def test_every_cell_and_metric_has_its_files():
    from harness import spec
    bench = spec.load_benchmark()
    for c in bench["workloads"]:
        cfg = spec.config(bench, c["config"])
        assert {"published", "engine", "init", "reference", "precision",
                "control"} <= set(cfg)
        assert spec.traffic(c["traffic"])["check_requests"] >= 1
        assert spec.limits(c["name"])["max_logit_gap"] > 0
        for m in spec.end_to_end(bench, c["name"]):
            spec.reader("end_to_end", m["name"])
        for m in spec.per_layer(bench, c["name"]):
            spec.reader("metrics", m["name"])
    assert json.loads((REPO / "BENCHMARK.json").read_text())["paths"] == ["benchmark"]
