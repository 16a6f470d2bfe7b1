"""One run of one cell: set-up, the measured window, the comparison with the
reference, and the metrics, as the result's dictionary.

What is printed on the way (set-up phases, how late the generator ran, the
card) goes to standard output before the result's line; the numbers the
comparison judged go to standard error last, each beside its limit.
"""

from __future__ import annotations

import asyncio
import dataclasses
import math
import os
import subprocess
import sys
import time

import torch

from harness import check, costs, serve, spec, trace
from harness.traffic import Traffic


@dataclasses.dataclass
class Run:
    """What a reader of a metric reads."""
    cfg: dict
    widths: dict
    seconds: float
    reqs: list                  # every request of the window (traffic.Req)
    t0: float                   # host clock at the window's start
    phases: dict                # set-up phases, seconds
    setup_s: float
    stats: dict                 # EngineStats over the window (deltas)
    steps: list | None = None   # serve.Step of each dispatch (traced runs)
    body: trace.Body | None = None   # the traced window's device records


def process_age_s() -> float:
    """Seconds since this process started (the kernel's clock ticks)."""
    try:
        with open("/proc/self/stat", encoding="ascii") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        return (time.clock_gettime(time.CLOCK_BOOTTIME)
                - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = "nvidia-smi not available"
    return out.splitlines()[0] if out else "nvidia-smi printed nothing"


def delta(a: dict, b: dict) -> dict:
    return {k: b[k] - a[k] for k in a if isinstance(a[k], int)}


async def window(engine, traffic: Traffic, seconds: float) -> tuple:
    """(every request of the window, the window's start on the host
    clock)."""
    if traffic.params["loop"] == "open":
        reqs = traffic.open_schedule(seconds)
        return reqs, await serve.open_loop(engine, reqs, seconds)
    reqs: list = []
    t0 = await serve.closed_loop(engine, traffic, seconds, reqs)
    return reqs, t0


def kv_page_bytes(model) -> int:
    """Bytes of one KV page: a block's rows over every layer."""
    layers, _, lanes = model.kv_cache.shape
    return (model.kv_cache.element_size() * layers * lanes
            * model.engine_config.block_size)


def say(*a) -> None:
    print(*a, flush=True)


# Where the program runs: the card (the tests' small cells set "cpu").
DEVICE = "cuda"


async def run_cell(bench: dict, cell_name: str, seed: int, seconds: float,
                   traced: bool, *, t_start: float, age_at_start: float = 0.0,
                   phases: dict | None = None,
                   control: str | None = None) -> dict:
    """One run; returns the result's dictionary (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, ``breakdown`` when traced, ``kv``,
    and ``checks`` last). A traced run whose profile lost an edge mark
    raises ``trace.MarksLost`` once the program's state is freed."""
    device = DEVICE
    cell = spec.cell(bench, cell_name)
    cfg = spec.config(bench, cell["config"])
    params = spec.traffic(cell["traffic"])
    limits = spec.limits(cell_name)
    widths = costs.model_widths(cfg)
    phases = dict(phases or {})
    engine = await serve.set_up(cfg, widths, seed, device, phases)
    loops = asyncio.create_task(engine.start_all_event_loops())
    traffic = Traffic(params, seed, widths["V"])
    setup_s = age_at_start + time.perf_counter() - t_start
    parts = dict(interpreter=age_at_start, **phases)
    parts["other"] = setup_s - sum(parts.values())
    say("setup: " + ", ".join(f"{k} {v:.3f} s" for k, v in parts.items())
        + f"; setup_s {setup_s:.3f} s")
    graphs = engine.model.graphs
    if graphs is not None:
        say(f"warm-up: {len(graphs.table)} graphs captured in "
            f"{graphs.capture_s:.3f} s, {engine.model.num_hbm_blocks} KV pages")
    first_use0 = graphs.first_use if graphs is not None else 0
    records = None
    log = serve.StepLog(engine.model, rows=traced)
    stats0 = engine.stats.snapshot()
    if traced:
        with trace.profiling() as prof:
            reqs, t0 = await window(engine, traffic, seconds)
        records = trace.device_records(prof)
    else:
        reqs, t0 = await window(engine, traffic, seconds)
    log.remove()
    stats = delta(stats0, engine.stats.snapshot())
    captured = (graphs.first_use - first_use0) if graphs is not None else 0
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    pool = engine.model.num_hbm_blocks
    page_bytes = kv_page_bytes(engine.model)
    loops.cancel()
    try:
        await loops
    except asyncio.CancelledError:
        pass
    serve.free(engine)
    if device == "cuda":
        say(f"freed: {torch.cuda.memory_allocated()} bytes still allocated")
    body = trace.body(records) if records is not None else None
    if body is not None:
        whole = sum(r.end - r.start for r in body.records) / 1e9
        say(f"trace: {len(body.records)} device records on streams "
            f"{sorted({r.stream for r in body.records})}; busy {body.busy_s:.6f} s, "
            f"records {whole:.6f} s whole, {sum(body.exclusive_ns) / 1e9:.6f} s "
            f"exclusive, window {body.window_s:.6f} s")
    if params["loop"] == "open":
        late = sorted(1e3 * (r.sent - r.due) for r in reqs if r.sent is not None)
        say(f"generator: {len(late)} requests sent, late by p50 "
            f"{late[len(late) // 2]:.3f} ms, p99 {late[int(0.99 * (len(late) - 1))]:.3f} "
            f"ms, max {late[-1]:.3f} ms")
    say(f"window: {len(reqs)} requests, {sum(len(r.tokens) for r in reqs)} "
        f"output tokens, {stats.get('num_steps', 0)} steps, "
        f"{captured} graphs first used inside it")
    kv = {"pages_peak": log.pages_peak, "pages": pool, "page_bytes": page_bytes,
          "peak_bytes": log.pages_peak * page_bytes, "pool_bytes": pool * page_bytes}
    say(f"kv: at most {log.pages_peak} of {pool} pages in use "
        f"({kv['peak_bytes'] / 1e9:.3f} of {kv['pool_bytes'] / 1e9:.3f} GB, "
        f"{100 * log.pages_peak / max(pool, 1):.2f}% of the pool); "
        f"memory_peak_bytes {peak}")
    run = Run(cfg, widths, seconds, reqs, t0, phases, setup_s,
              stats, log.steps if traced else None, body)

    failed = sum(1 for r in reqs if not r.done)
    t_check = time.perf_counter()
    readings = check.compare(cfg, widths, seed, reqs, params["check_requests"],
                             device, control)
    readings["seconds"] = round(time.perf_counter() - t_check, 3)
    checks = {"failed_requests": {"value": failed, "limit": 0}}
    if "max_logit_gap" in readings:
        checks["max_logit_gap"] = {"value": readings["max_logit_gap"],
                                   "limit": limits["max_logit_gap"]}
    correct = (failed == 0 and "max_logit_gap" in readings
               and all(c["value"] <= c["limit"] for c in checks.values()))
    say("check: " + ", ".join(f"{k} {v}" for k, v in readings.items()))

    metrics = {}
    entries = (spec.per_layer(bench, cell_name) if traced
               else spec.end_to_end(bench, cell_name))
    for m in entries:
        value = spec.reader("metrics" if traced else "end_to_end", m["name"])(run)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
           "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": len(reqs), "failed": failed,
              "metrics": metrics, "device": dev}
    if body is not None:
        dev["busy_s"] = body.busy_s
        dev["window_s"] = body.window_s
        result["breakdown"] = {"device_ops": body.top_ops(),
                               "idle_gaps": body.idle_gaps()}
    if control:
        result["control"] = {"precision": control,
                             "max_logit_gap": readings.get("control_max_logit_gap")}
    if device == "cuda":
        say(f"card: {card_line()}")
    result["kv"] = kv
    result["checks"] = checks
    for k, c in checks.items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr,
              flush=True)
    return result
