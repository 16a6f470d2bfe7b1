"""The system under test: ``swiftllm_tpu_torch``'s ``Engine``, set up from a
configuration file and driven through ``Engine.add_request_and_stream``.

Set-up, in phases: the kernels loaded (built on a checkout's first run), the
weights drawn on the card and handed to the program through
``worker/weights.py:build_shard`` (which quantizes a quantized
configuration, as a deployment does at load), the KV cache sized by the
program's own profile, and the warm-up: ``Engine.warmup`` at the greedy
temperature alone (``greedy_warmup``), the only step shapes greedy traffic
meets, each run once and captured as CUDA graphs at every plan.

``StepLog`` sits around the calls into ``LlamaModel.forward_async``. In
every run it keeps the most KV pages in use at a dispatch (the block
managers' count, pages held by running requests); in a traced run it also
records each step the engine dispatches (its rows, their tokens, their
cached tokens, whether they sample): the step composition that the
per-layer metrics reckon work from.

The process is served as it is shipped: the harness leaves the garbage
collector as the program leaves it.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import gc
import itertools
import time

import torch

from harness import weights as bench_weights
from harness.traffic import Req, Traffic

# How long after the window's close a request may still finish.
GRACE_S = 60.0


@dataclasses.dataclass
class Step:
    tokens: int         # the step's token bucket
    rows: list          # (n_tokens, cached, samples) of each scheduled row


class StepLog:
    """Around the model's ``forward_async``: the most KV pages in use at a
    dispatch (``pages_peak``), and with ``rows`` on every step
    dispatched."""

    def __init__(self, model, rows: bool):
        self.model = model
        self.real = model.forward_async
        self.rows = rows
        self.steps: list = []
        self.pages_peak = 0
        model.forward_async = self

    def __call__(self, scheduled, *args, **kwargs):
        used = sum(m.num_blocks - m.num_free_blocks
                   for m in self.model.hbm_block_mgrs)
        self.pages_peak = max(self.pages_peak, used)
        if not self.rows:
            return self.real(scheduled, *args, **kwargs)
        rows = [(s.n_tokens, s.request.num_cached_tokens, bool(s.samples_token))
                for s in scheduled]
        out = self.real(scheduled, *args, **kwargs)
        self.steps.append(Step(self.model.last_key.tokens, rows))
        return out

    def remove(self) -> None:
        self.model.forward_async = self.real


@contextlib.contextmanager
def feeding(make):
    """While on, every ``LlamaModel.load_weights`` takes ``make(engine
    config, model config, device, mesh)`` in place of the checkpoint."""
    from swiftllm_tpu_torch.worker import weights as program_weights
    real = program_weights.load_params
    program_weights.load_params = make
    try:
        yield
    finally:
        program_weights.load_params = real


def engine_config(cfg: dict):
    from swiftllm_tpu_torch.config import EngineConfig
    return EngineConfig(model_path="", use_dummy=True, **cfg["engine"])


async def set_up(cfg: dict, widths: dict, seed: int, device: str,
                 phases: dict):
    """The engine, warmed up; ``phases`` gets each phase's seconds."""
    from swiftllm_tpu_torch.config import LlamaModelConfig
    from swiftllm_tpu_torch.models.llama import compute_inv_freq
    from swiftllm_tpu_torch.ops import build
    from swiftllm_tpu_torch.server.engine import Engine
    from swiftllm_tpu_torch.worker.weights import build_shard

    t = time.perf_counter()
    if device == "cuda":
        build.build_kernels()
    phases["extensions"] = time.perf_counter() - t

    ec = engine_config(cfg)
    mc = LlamaModelConfig.from_hf_dict(cfg["published"])

    def make(ec_, mc_, dev, mesh):
        t0 = time.perf_counter()
        drawn = bench_weights.draw(widths, cfg["init"], seed, dev)

        def get(key, layer):
            return drawn[key] if layer is None else drawn["layers"][key][layer]
        params = build_shard(mc_, ec_.quant, getattr(torch, ec_.dtype), mesh, get,
                             cast_first=False)
        params["inv_freq"] = torch.from_numpy(compute_inv_freq(mc_)).to(dev)
        drawn.clear()
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()
        phases["weights"] = time.perf_counter() - t0
        return params

    t = time.perf_counter()
    engine = Engine(ec, mc, device=device)
    with feeding(make):
        await engine.initialize(tokenizer_backend="inline")
    if device == "cuda":
        torch.cuda.synchronize()
    phases["kv_profile"] = time.perf_counter() - t - phases["weights"]

    t = time.perf_counter()
    if engine.model.graphs is not None:
        await greedy_warmup(engine)
        torch.cuda.synchronize()
    phases["warmup"] = time.perf_counter() - t
    return engine


async def greedy_warmup(engine) -> None:
    """``Engine.warmup`` at the greedy temperature alone: each of the step
    shapes greedy traffic meets runs once on the model's thread and is
    captured at every plan. (``warmup(bucket_keys=...)`` with the same keys
    would capture without running a step, but on a fresh engine its first
    bf16 product is then the model thread's first, and cuBLAS makes that
    thread's handle inside the capture, which fails.)"""
    from swiftllm_tpu_torch.server import engine as engine_mod
    temperatures = engine_mod.WARMUP_TEMPERATURES
    engine_mod.WARMUP_TEMPERATURES = (0.0,)
    try:
        await engine.warmup()
    finally:
        engine_mod.WARMUP_TEMPERATURES = temperatures


async def consume(engine, r: Req) -> None:
    from swiftllm_tpu_torch.server.structs import RawRequest
    raw = RawRequest("", r.output_len, prompt_token_ids=r.prompt)
    async for out in engine.add_request_and_stream(raw):
        r.stamps.append(time.perf_counter())
        r.tokens.append(out.token_id)
    r.done = len(r.tokens) == r.output_len


async def _finish(tasks: list, deadline: float) -> None:
    """Wait for every task until ``deadline``; cancel what is left (its
    requests count as failed); raise what a task raised."""
    if not tasks:
        return
    done, pending = await asyncio.wait(
        tasks, timeout=max(0.0, deadline - time.perf_counter()))
    for t in pending:
        t.cancel()
    if pending:
        await asyncio.wait(pending)
    for t in done:
        if t.exception() is not None:
            raise t.exception()


async def open_loop(engine, reqs: list, seconds: float) -> float:
    """Send each request at its due time (from ``t0``, returned), then wait
    for every one."""
    t0 = time.perf_counter() + 0.01
    tasks = []
    for r in reqs:
        r.due = t0 + r.due_s
        delay = r.due - time.perf_counter()
        if delay > 0:
            await asyncio.sleep(delay)
        r.sent = time.perf_counter()
        tasks.append(asyncio.create_task(consume(engine, r)))
    await _finish(tasks, t0 + seconds + GRACE_S)
    return t0


async def closed_loop(engine, traffic: Traffic, seconds: float,
                      reqs: list) -> float:
    """``clients`` clients, each sending its next request when its last one
    ends, until the window closes; then wait for those in flight."""
    p = traffic.params
    t0 = time.perf_counter()
    close = t0 + seconds
    ks = itertools.count()

    async def client():
        while time.perf_counter() < close:
            k = next(ks)
            if k >= p["pool"]:
                raise RuntimeError(f"the traffic's pool of {p['pool']} "
                                   "requests ran out inside the window")
            r = traffic.request(k)
            r.sent = r.due = time.perf_counter()
            if r.sent >= close:
                break
            reqs.append(r)
            await consume(engine, r)

    await _finish([asyncio.create_task(client()) for _ in range(p["clients"])],
                  close + GRACE_S)
    return t0


def free(engine) -> None:
    """Release the program's state on the card: its graphs, weights and
    cache, and the threads that ran its steps."""
    model = engine.model
    engine._model_executor.shutdown(wait=True)
    engine._resolve_executor.shutdown(wait=True)
    if model is not None:
        if model.graphs is not None:
            model.graphs.clear()
        model.graphs = None
        model.params = model.kv_cache = model.token_feedback = None
        model.cpu_cache = None
    engine.model = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
