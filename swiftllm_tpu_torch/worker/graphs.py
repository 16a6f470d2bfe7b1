"""One CUDA graph per step bucket: the port's counterpart of the JAX
package's compiled step programs (``swiftllm_tpu/worker/model.py:
_get_step_fn``, ``_lower``).

A step of the port is some 1,570 launches at 8B width (49 a layer), each
queued from Python; the card idles while the host queues them. A CUDA graph
records one step's launches once and queues them all again with one
``replay()``. ``LlamaModel.execute_packed`` (``worker/model.py``) runs every
step and every multi-step window of a model at tp = dp = 1 on the card that
way:

- **The key** (``graph_key``): the ``BucketKey``, whether logits are
  returned, the step's attention plans (``ops/paged_attention.py:
  step_plans``), the two environment switches (``models/llama.py:
  step_switches``) and the engine's ``use_pallas`` and
  ``enable_logprobs``. ``live_rows`` changes from step to step within a bucket
  and sets the attention kernels' key splits, so the graph is keyed by the
  plans it leads to, and captured over the most rows that keep them
  (``plan_rows``): a replay launches the plans an eager step would.
- **A graph** (``CapturedStep``) holds its static input, the packed i32
  batch of ``packed_len(key)``, and its static outputs (tokens, logits
  where asked, logprobs where on). Before each replay the pinned batch is
  copied into the static input on the step's stream; the tokens' copy to
  the host (``PendingTokens``) is queued right after the replay on the same
  stream, before any later replay can overwrite the outputs.
- **Capture** runs the step's Python once on a side stream under
  ``capture_error_mode="thread_local"`` (the engine's resolve thread
  queries events and allocates pinned memory meanwhile), into one memory
  pool shared by every graph of the table: replays run one at a time on one
  stream, so each graph's scratch may reuse another's. A capture executes
  nothing, so the first use of a key runs the step eagerly to serve its
  batch (building the kernels and the INT4 kernel's tensor maps on the
  way), and then captures it.
- **Warm-up** (``server/engine.py:Engine.warmup``) runs each step shape of
  serving greedy and sampled and captures every plan of each bucket it
  runs, so a key's first use while serving is the exception, not the rule:
  ``first_use`` counts them (a first use inside the warm-up, which sets
  ``warming``, is not counted).
- **Executables**: an instantiated graph holds device memory outside the
  caching allocator, which CUDA keeps for later captures when the
  graph goes (``ExecMemory``); the KV budget reserves it
  (``LlamaModel.profile_num_blocks``).
- **Launch counts**: a capture's launches are taken back out of
  ``build.launch_counts`` and added again at each replay, so the counts
  keep meaning "launches queued".
- The cache, the feedback buffer, the weights and the LoRA stacks are read
  at the addresses a capture saw: the model drops its table whenever it
  allocates them anew, and sizes the kernels' split counters before the
  first capture (``build.hold_counters``).

A capture or a replay that fails raises; nothing falls back to the eager
step. Where graphs do not run (the CPU, world size > 1) is the model's
rule, not this module's. ``capture`` is a parameter of ``StepGraphs``: the
CPU tests pass a stand-in that runs the step on the static buffers at each
replay.
"""

from __future__ import annotations

import time
import weakref
from typing import Callable, NamedTuple

import torch

from swiftllm_tpu_torch.models.llama import StepSwitches
from swiftllm_tpu_torch.ops import build
from swiftllm_tpu_torch.ops import paged_attention as pa


class GraphKey(NamedTuple):
    """What a captured step is specialised to: the bucket, whether it returns
    logits, its attention plans, the environment switches, and the two
    engine settings the step reads (kernels or plain versions, logprobs),
    which a caller may change on a live model."""
    bucket: object                       # worker.batch_builder.BucketKey
    return_logits: bool
    plans: pa.StepPlans
    switches: StepSwitches
    use_kernels: bool = True
    logprobs: bool = False


def graph_key(bucket, return_logits: bool, live_rows: int,
              switches: StepSwitches, *, use_kernels: bool = True,
              logprobs: bool = False, **widths) -> tuple[GraphKey, int]:
    """(the graph key of a step of ``bucket`` whose rows from ``live_rows`` on
    have no query, the rows its graph plans over: ``plan_rows``).
    ``widths``: ``step_plans``' keyword arguments (the shard's heads, the
    page size, the window, the card's SM count)."""
    return (GraphKey(bucket, bool(return_logits),
                     pa.step_plans(bucket, live_rows, **widths),
                     StepSwitches(*switches), bool(use_kernels),
                     bool(logprobs)),
            pa.plan_rows(bucket, live_rows, **widths))


class CapturedStep:
    """One captured step: the static input ``flat``, the static ``outputs``
    (tokens, logits or None, logprobs or None), the graph, the launches its
    capture queued (``launches``, added to ``build.launch_counts`` at each
    replay), the seconds its capture took and its replays so far."""

    def __init__(self, flat: torch.Tensor, graph, outputs: tuple,
                 launches: dict, seconds: float):
        self.flat = flat
        self.graph = graph
        self.outputs = outputs
        self.launches = launches
        self.seconds = seconds
        self.replays = 0

    def load(self, flat: torch.Tensor) -> None:
        """Copy a step's packed batch (pinned, on the host) into the static
        input, on the current stream."""
        self.flat.copy_(flat, non_blocking=True)

    def replay(self) -> tuple:
        """Queue the step on the current stream; returns the static
        outputs."""
        self.graph.replay()
        for k, n in self.launches.items():
            build.launch_counts[k] += n
        self.replays += 1
        return self.outputs


def cuda_capture(fn: Callable[[], tuple], state: tuple, pool,
                 stream: torch.cuda.Stream):
    """Capture ``fn()`` into a ``torch.cuda.CUDAGraph`` on ``stream``, its
    allocations from ``pool``; returns (graph, fn's outputs). Nothing runs:
    ``state`` (the tensors the step updates in place) is left as it was."""
    graph = torch.cuda.CUDAGraph()
    stream.wait_stream(torch.cuda.current_stream(stream.device))
    with torch.cuda.stream(stream):
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            outputs = fn()
        finally:
            graph.capture_end()
    torch.cuda.current_stream(stream.device).wait_stream(stream)
    return graph, outputs


_capture_streams: dict[torch.device, torch.cuda.Stream] = {}


def capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The side stream every capture on ``device`` runs on, made once.
    cuBLAS keeps a workspace per stream; one small product of each kind
    here makes this stream's outside any capture, so that no capture takes
    it from a graph pool, and one stream keeps it to one workspace."""
    device = build.card(device)
    if device not in _capture_streams:
        stream = torch.cuda.Stream(device)
        with torch.cuda.stream(stream):
            for dt in (torch.bfloat16, torch.float32):
                a = torch.ones(16, 16, dtype=dt, device=device)
                torch.addmm(a[0], a, a).mm(a)
        stream.synchronize()
        _capture_streams[device] = stream
    return _capture_streams[device]


def anchor_graph(pool, device: torch.device) -> torch.cuda.CUDAGraph:
    """A graph of one small kernel, captured into ``pool`` and never
    replayed. A pool is released once no graph holds it; this one keeps it,
    and what it reserved, while no step graph is in it (between the
    profile's probe and the first capture of serving)."""
    stream = capture_stream(device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            torch.zeros(1, device=device)
        finally:
            graph.capture_end()
    return graph


class ExecMemory:
    """The device memory of one card's graph executables, which lies outside
    the caching allocator. It grows with a graph's launches, so it is
    counted in units of one layer of one step (a step of L layers holds L, a
    window of S such steps S * L). CUDA keeps what it once gave: a
    graph dropped leaves its bytes to later captures, so what the card holds
    for them follows the most units ever alive at once in the process
    (``peak``; ``live`` now), at about ``per_unit`` bytes a unit, which
    ``LlamaModel.profile_num_blocks`` measures on its captures."""

    def __init__(self):
        self.per_unit = 0.0
        self.live = 0
        self.peak = 0

    def hold(self, units: int) -> None:
        self.live += units
        self.peak = max(self.peak, self.live)

    def release(self, units: int) -> None:
        self.live -= units

    def to_take(self, units: int) -> int:
        """Bytes the card must still give for ``units`` more alive beside the
        live ones."""
        return int(max(0, self.live + units - self.peak) * self.per_unit)


_exec_memory: dict[torch.device, ExecMemory] = {}


def exec_memory(device) -> ExecMemory:
    """``device``'s ExecMemory, made once."""
    return _exec_memory.setdefault(build.card(device), ExecMemory())


class StepGraphs:
    """The graph table of one model: ``GraphKey`` -> ``CapturedStep``, their
    shared memory pool, the bytes captures made the pool reserve
    (``pool_bytes``, since the pool was made), the seconds spent
    capturing (``capture_s``) and the keys first used outside a warm-up
    (``first_use``; ``warming`` is set while one runs). ``capture`` is
    ``cuda_capture`` on the card; a stand-in takes the same arguments.
    ``layers``: the model's, what a step's graph holds of ``ExecMemory``."""

    def __init__(self, device: torch.device, capture=cuda_capture,
                 layers: int = 1):
        self.device = torch.device(device)
        self._capture = capture
        self.layers = layers
        self.table: dict[GraphKey, CapturedStep] = {}
        self.pool = self._anchor = None
        if capture is cuda_capture:
            self.pool = torch.cuda.graph_pool_handle()
            self._anchor = anchor_graph(self.pool, self.device)
        self.pool_bytes = 0
        self.capture_s = 0.0
        self.first_use = 0
        self.warming = False

    def clear(self) -> None:
        """Drop every graph; the pool and what it reserved stay."""
        self.table.clear()

    def capture(self, key: GraphKey, fn: Callable[[torch.Tensor], tuple],
                flat: torch.Tensor, state: tuple) -> CapturedStep:
        """Capture ``fn(flat)`` (the step on the static input ``flat``, which
        updates ``state`` in place) under ``key``."""
        if key in self.table:
            raise RuntimeError(f"graph {key} is captured already")
        cuda = self._capture is cuda_capture
        stream = capture_stream(self.device) if cuda else None
        before = dict(build.launch_counts)
        reserved = torch.cuda.memory_reserved(self.device) if cuda else 0
        t0 = time.perf_counter()
        graph, outputs = self._capture(lambda: fn(flat), state, self.pool,
                                       stream)
        seconds = time.perf_counter() - t0
        launches = {k: n - before[k] for k, n in build.launch_counts.items()
                    if n != before[k]}
        build.launch_counts.update(before)
        if cuda:
            self.pool_bytes += torch.cuda.memory_reserved(self.device) - reserved
        self.capture_s += seconds
        entry = CapturedStep(flat, graph, tuple(outputs), launches, seconds)
        mem, units = exec_memory(self.device), key.bucket.steps * self.layers
        mem.hold(units)
        weakref.finalize(entry, mem.release, units)
        self.table[key] = entry
        return entry
