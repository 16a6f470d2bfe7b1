"""Small cells for the CPU tests: the tiny configurations and traffic under
``tests/data``, run through the harness with the card's check left out."""

import asyncio
import contextlib
import json
import time
from pathlib import Path

from harness import runner, spec

DATA = Path(__file__).resolve().parent / "data"


def bench_for(config: str) -> dict:
    """A benchmark of one cell ``tiny.x`` of ``tests/data/<config>.json``
    reporting every end-to-end metric."""
    with open(DATA.parents[2] / "BENCHMARK.json", encoding="utf-8") as f:
        e2e = [{k: v for k, v in m.items() if k != "workloads"}
               for m in json.load(f)["end_to_end"]]
    return {"configs": [{"name": "tiny",
                         "file": f"benchmark/tests/data/{config}.json"}],
            "workloads": [{"name": "tiny.x", "config": "tiny", "traffic": "x",
                           "chips": 1}],
            "end_to_end": e2e, "per_layer": []}


@contextlib.contextmanager
def standing_in(traffic: str, limit: float):
    """The run on the CPU, with ``tests/data/<traffic>.json`` as the cell's
    traffic mix and ``limit`` as its comparison's limit."""
    with open(DATA / f"{traffic}.json", encoding="utf-8") as f:
        params = dict(json.load(f), name=traffic)
    saved = runner.DEVICE, spec.traffic, spec.limits
    runner.DEVICE = "cpu"
    spec.traffic = lambda name: params
    spec.limits = lambda cell_name: {"max_logit_gap": limit}
    try:
        yield
    finally:
        runner.DEVICE, spec.traffic, spec.limits = saved


def run_small(config: str, traffic: str, seed: int, seconds: float = 1.5,
              limit: float = 1e-3, control: str | None = None) -> dict:
    with standing_in(traffic, limit):
        return asyncio.run(runner.run_cell(
            bench_for(config), "tiny.x", seed, seconds, False,
            t_start=time.perf_counter(), control=control))
