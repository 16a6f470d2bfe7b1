"""Engine — the async orchestrator of the control plane.

Capability parity with the reference's ``swiftllm/server/engine.py:16-181``:
``initialize()``, ``add_request_and_stream()``, ``add_request_and_wait()``,
``start_all_event_loops()``, a tokenization loop and a main step loop.

A copy of ``swiftllm_tpu/server/engine.py`` for the PyTorch port. It builds
the port's ``LlamaModel`` (on ``device``, "cuda" unless the caller asks for
"cpu"), caps pages with the port's kernel cap, resolves tokens by waiting on
a CUDA event (off the event loop) and reading the pinned host copy the step
queued (the logprobs with them, under ``enable_logprobs``), and traces with
``torch.profiler``. Speculative decoding (the drafting scheduler, verify
steps, the accept loop and its warm-up) and prefix caching (the scheduler's
``prefix_matcher`` wired to ``model.match_prefix``) run as in the JAX
package, and so do swap preemption (the pipeline drained before a swap-out,
whose pages the model's page mover copies on the step's stream; a request
aborted while swapped returns its host pages) and LoRA routing by adapter
name.

- With tp/dp > 1 the engine runs on rank 0: its model announces every step
  and swap op to the follower ranks (``parallel/distributed.py``), requests
  are pinned to dp groups at admission, and ``stop_followers`` releases the
  followers on every way out of the serving loop.
- The step batch is a SARATHI mixed prefill+decode token batch (the scheduler
  enables the piggybacking the reference left as a comment, scheduler.py:92-99).
- ``model.forward`` runs in a thread-pool executor so device steps never
  block the event loop (reference engine.py:30-35 does the same).
- Tokenization runs in a worker process via ProcessPoolExecutor instead of a
  Ray actor (reference engine.py:60,104).
- EOS stop and request abort are supported (the reference has neither:
  structs.py:57, api_server.py:75 TODO).
"""

from __future__ import annotations

import asyncio
import time
from concurrent.futures import ThreadPoolExecutor

from swiftllm_tpu_torch.config import EngineConfig, LlamaModelConfig
from swiftllm_tpu_torch.server.scheduler import ScheduledSeq, Scheduler
from swiftllm_tpu_torch.server.structs import RawRequest, Request, StepOutput
from swiftllm_tpu_torch.server.tokenization import TokenizationEngine


# The default warm-up runs every step shape at each of these temperatures,
# as the JAX engine's warm-up does: a bucket's ``sampling`` bit picks the
# greedy head or the sampler, so each is a step (a graph) of its own.
WARMUP_TEMPERATURES = (0.0, 1.0)


def warmup_steps(cfg: EngineConfig, temperature: float, new_id, made: list):
    """The default warm-up's steps at ``temperature``, in order, as (rows,
    multi_step, requests whose pages go after the step): prefill-only steps
    of 1, 2, 4, ... chunk rows, a decode-only step, the multi-step window
    (``multi_step_decode`` > 1), every pow2 chunk size below the full chunk,
    SARATHI mixed steps, and greedy with ``enable_spec_decode`` verify steps
    of 1, 2, 4, ... spec rows up to ``spec_max_rows``. Each request made
    takes its seq id from ``new_id()`` and goes into ``made``, whose pages
    and ids the caller releases at the end. Nothing runs here: the engine
    runs each step (``Engine.warmup``), ``warmup_buckets`` only buckets it."""
    from swiftllm_tpu_torch.utils import next_power_of_2, tile_q_for
    chunk = min(cfg.prefill_chunk_size, cfg.max_tokens_in_batch,
                cfg.max_seq_len - 8)
    max_chunk_rows = max(1, min(cfg.max_tokens_in_batch // max(chunk, 1),
                                cfg.max_batch_size - 1))
    chunk_rows = []
    n = 1
    while n <= max_chunk_rows:
        chunk_rows.append(n)
        n *= 2

    def request(n_prompt):
        r = Request(RawRequest("", 4, temperature=temperature))
        r.set_prompt_token_ids([1] * n_prompt)
        r.seq_id = new_id()
        made.append(r)
        return r

    reqs = [request(chunk) for _ in range(chunk_rows[-1] + 1)]
    ra, rest = reqs[0], reqs[1:]
    for n_rows in chunk_rows:                              # prefill-only
        yield [ScheduledSeq(r, chunk) for r in reqs[:n_rows]], 1, reqs[1:n_rows]
    ra.num_cached_tokens = chunk                           # ra keeps its pages
    ra.output_token_ids.append(0)
    yield [ScheduledSeq(ra, 1)], 1, []                     # decode-only
    ra.num_cached_tokens += 1
    ra.output_token_ids.append(0)
    if cfg.multi_step_decode > 1:
        # The S-step window (and, in deferred-commit mode, the decode
        # kernel's variant for it).
        S = cfg.multi_step_decode
        yield [ScheduledSeq(ra, 1)], S, []
        ra.num_cached_tokens += S
        ra.output_token_ids.extend([0] * S)
    align = tile_q_for(next_power_of_2(chunk))
    size = align
    while size < chunk:
        yield [ScheduledSeq(rest[0], size)], 1, [rest[0]]
        size *= 2
    # Mixed steps carry a tile-padded decode block on top of the chunks;
    # mirror the scheduler's budget.
    mixed_max = max(1, (cfg.max_tokens_in_batch - align) // max(chunk, 1))
    for n_rows in [n for n in chunk_rows if n <= mixed_max]:
        yield ([ScheduledSeq(ra, 1)]                       # SARATHI mixed
               + [ScheduledSeq(r, chunk) for r in rest[:n_rows]]), 1, rest[:n_rows]
        ra.num_cached_tokens += 1
        ra.output_token_ids.append(0)
    if cfg.enable_spec_decode and temperature == 0.0:
        # Verify steps: q bucket spec_k + 1 (pinned), the span head; the
        # token bucket floats with the spec row count, so every pow2 row
        # count up to spec_max_rows runs.
        spec_reqs = []
        n_rows = 1
        while n_rows <= min(cfg.spec_max_rows, cfg.max_batch_size):
            while len(spec_reqs) < n_rows:
                rs = request(4)
                rs.num_cached_tokens = 4
                rs.output_token_ids.append(0)
                spec_reqs.append(rs)
            yield [ScheduledSeq(rs, 1 + cfg.spec_k,
                                drafts=tuple([0] * cfg.spec_k))
                   for rs in spec_reqs[:n_rows]], 1, []
            n_rows *= 2


def warmup_buckets(cfg: EngineConfig) -> list:
    """The buckets of the default warm-up's steps at every temperature, in
    the order they first run, without running a step (``select_buckets``
    of each; ids from a counter, no pages)."""
    import itertools
    from swiftllm_tpu_torch.worker.batch_builder import select_buckets
    keys = []
    for temperature in WARMUP_TEMPERATURES:
        for rows, multi_step, _ in warmup_steps(
                cfg, temperature, itertools.count().__next__, []):
            key = select_buckets([rows], cfg, multi_step=multi_step)
            if key not in keys:
                keys.append(key)
    return keys


class EngineStats:
    """Step-level serving metrics (the reference has only prints, SURVEY.md §5.5)."""

    def __init__(self):
        self.num_steps = 0
        self.num_tokens_generated = 0
        self.num_prompt_tokens = 0
        self.num_requests_finished = 0
        self.num_preemptions = 0
        self.num_spec_drafted = 0     # draft tokens submitted for verification
        self.num_spec_accepted = 0    # draft tokens confirmed by the model
        self.total_step_time = 0.0

    def snapshot(self) -> dict:
        return {
            "num_steps": self.num_steps,
            "num_tokens_generated": self.num_tokens_generated,
            "num_prompt_tokens": self.num_prompt_tokens,
            "num_requests_finished": self.num_requests_finished,
            "num_preemptions": self.num_preemptions,
            "num_spec_drafted": self.num_spec_drafted,
            "num_spec_accepted": self.num_spec_accepted,
            "avg_step_ms": (1e3 * self.total_step_time / self.num_steps
                            if self.num_steps else 0.0),
        }


class Engine:
    def __init__(self, engine_config: EngineConfig,
                 model_config: LlamaModelConfig | None = None,
                 device: str = "cuda"):
        self.engine_config = engine_config
        self.device = device
        self.model_config = model_config or LlamaModelConfig.load_from_model_path(
            engine_config.model_path)
        self.initialized = False

        self.model = None
        self.scheduler: Scheduler | None = None
        self.tokenizer: TokenizationEngine | None = None
        self.eos_ids: set[int] = (self.model_config.eos_token_ids()
                                  if engine_config.eos_stop else set())

        import collections
        self.untokenized_raw_requests: list[tuple[Request, str]] = []
        self._pending_steps = collections.deque()   # dispatched, values pending
        self._work_event = asyncio.Event()
        # The model thread launches on this engine's card, whichever card a
        # new thread would start on.
        from swiftllm_tpu_torch.worker.model import bind_device
        self._model_executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="model-step",
            initializer=bind_device, initargs=(device,))
        # Token resolution blocks on the device→host copy; it must not occupy
        # the dispatch thread or the pipeline serializes on it.
        self._resolve_executor = ThreadPoolExecutor(max_workers=1,
                                                    thread_name_prefix="resolve")
        self.stats = EngineStats()
        self._crashed: BaseException | None = None

    async def initialize(self, tokenizer_backend: str = "process"):
        """Build model, load weights, size + allocate the KV cache, create the
        scheduler and tokenizer (reference engine.py:37-63)."""
        cfg = self.engine_config
        from swiftllm_tpu_torch.worker.model import LlamaModel

        self.model = LlamaModel(cfg, self.model_config, device=self.device)
        self.model.load_weights()
        self.model.init_kvcache_and_swap(graph_buckets=warmup_buckets(cfg))
        self.scheduler = Scheduler(self.model_config, cfg,
                                   self.model.num_hbm_blocks,
                                   dp_size=self.model.dp)
        if cfg.enable_prefix_caching:
            self.scheduler.prefix_matcher = self.model.match_prefix
        self.tokenizer = TokenizationEngine(
            cfg.model_path, backend=tokenizer_backend, use_dummy=cfg.use_dummy,
            vocab_size=self.model_config.vocab_size)
        self.initialized = True
        if cfg.warmup_at_init:
            await self.warmup()

    async def warmup(self, bucket_keys=None):
        """Run the serving working set of step shapes once before traffic
        (``warmup_steps``): prefill-only steps of 1, 2, 4, ... chunk rows, a
        decode-only step, a multi-step window when ``multi_step_decode`` >
        1, every pow2 chunk size below the full chunk, SARATHI mixed steps,
        and with ``enable_spec_decode`` a verify step of 1, 2, 4, ... spec
        rows up to ``spec_max_rows``. Each runs at both
        ``WARMUP_TEMPERATURES``, greedy and sampled, as the JAX engine's
        warm-up does (a bucket's ``sampling`` bit is a step of its own);
        verify steps greedy only, as there. Pages and ids are released
        after each pass. Each is one real step through the normal dispatch
        path, so the kernels are built and every step shape has run before
        the first request.

        With CUDA graphs (the card, world size 1) each step is followed by
        ``model.capture`` of its bucket: every plan a step of it can meet
        (live rows 1 to ``key.rows``), under the environment's switches
        now. Serving within the warmed buckets then captures nothing;
        a key it does first use is counted in ``model.graphs.first_use``.
        Where steps run eagerly (the CPU, world size > 1,
        ``cuda_graphs=False``) the steps run and nothing is captured.

        With ``bucket_keys`` it only captures, as the JAX engine's explicit
        keys only compile: ``model.capture`` of each key, every plan a step
        of it can meet, and no step runs. That needs graphs (the card, world
        size 1); elsewhere it raises."""
        if bucket_keys is not None:
            for key in bucket_keys:
                await self._run_on_model_async(self.model.capture, key)
            return
        cfg, model = self.engine_config, self.model

        def run_pass(temperature):
            mgr_ids = self.scheduler.id_managers[0]
            made = []
            try:
                for rows, multi_step, done in warmup_steps(
                        cfg, temperature, mgr_ids.get_id, made):
                    # Warm-up rows belong to dp group 0; the other groups
                    # idle (graphs run at world size 1 only).
                    model.forward(rows, groups=[rows] + [[]] * (model.dp - 1),
                                  multi_step=multi_step)
                    if model.graphs is not None:
                        model.capture(model.last_key)
                    model.free_seqs_resources(done)
            finally:
                model.free_seqs_resources(made)
                mgr_ids.free_ids([r.seq_id for r in made])

        def run_steps():
            if model.graphs is not None:
                model.graphs.warming = True
            try:
                for temperature in WARMUP_TEMPERATURES:
                    run_pass(temperature)
            finally:
                if model.graphs is not None:
                    model.graphs.warming = False

        await self._run_on_model_async(run_steps)

    # --- request entry points (reference engine.py:65-87) ----------------------
    def _fits(self, req: Request) -> bool:
        """Reject requests that could never complete — length over
        ``max_seq_len``, total KV pages over one dp group's whole pool, or
        over the kernels' pages-per-seq cap. Without the page check a
        too-big prompt would sit at the FCFS queue head forever (the
        scheduler's no-skip-ahead rule would then starve every request
        behind it)."""
        cfg = self.engine_config
        total = req.prompt_len + req.output_len
        from swiftllm_tpu_torch.utils import cdiv
        from swiftllm_tpu_torch.ops.paged_attention import max_pages_cap
        # Both attention paths index with int32 positions, so the cap holds
        # for either; it lies far above any pool, which binds in practice.
        pages_ceiling = min(self.model.num_hbm_blocks,
                            max_pages_cap(cfg.block_size))
        if (total <= cfg.max_seq_len
                and cdiv(total, cfg.block_size) <= pages_ceiling):
            return True
        req.aborted = True
        req.finished_event.set()
        return False

    def submit(self, raw_request: RawRequest) -> Request:
        """Enqueue a request and return its handle immediately — so callers
        hold something to ``abort_request`` even before the first token
        (e.g. a client that disconnects while the request is still queued)."""
        req = Request(raw_request)
        if raw_request.lora:
            # Unknown adapter = client error; reject at submit like over-length
            # prompts (no silent base-model fallback).
            slot = self.model.lora_slots.get(raw_request.lora)
            if slot is None:
                req.aborted = True
                req.finished_event.set()
                return req
            req.lora_slot = slot
        if raw_request.prompt_token_ids is not None:
            req.set_prompt_token_ids(list(raw_request.prompt_token_ids))
            if self._fits(req):
                self.scheduler.on_requests_arrival([req])
        else:
            self.untokenized_raw_requests.append((req, raw_request.prompt))
        self._work_event.set()
        return req

    async def add_request_and_stream(self, raw_request: RawRequest):
        """Submit and yield one StepOutput per generated token. Aborts the
        request if the consumer stops early (disconnect/cancel)."""
        req = self.submit(raw_request)
        try:
            async for out in self.stream_outputs(req):
                yield out
        finally:
            if not req.is_finished():
                self.abort_request(req)

    async def stream_outputs(self, req: Request):
        """Yield one StepOutput per generated token of an already-submitted
        request.

        The loop ends on the finish event + drained queue, NOT on
        ``is_finished()`` alone: with pipelined dispatch a request is
        finished-by-count one step before its last token value resolves."""
        while True:
            get_task = asyncio.ensure_future(req.output_q.get())
            ev_task = asyncio.ensure_future(req.finished_event.wait())
            done, _ = await asyncio.wait({get_task, ev_task},
                                         return_when=asyncio.FIRST_COMPLETED)
            if get_task in done:
                ev_task.cancel()
                yield get_task.result()
                if req.finished_event.is_set() and req.output_q.empty():
                    break
            else:
                get_task.cancel()
                while not req.output_q.empty():   # drain late arrivals
                    yield req.output_q.get_nowait()
                break

    async def add_request_and_wait(self, raw_request: RawRequest) -> tuple[Request, list[int]]:
        """Submit and wait for completion; returns (request, output_token_ids).
        If the wait is cancelled (e.g. the HTTP client disconnected), the
        request is aborted so it stops holding KV pages and batch slots."""
        req = self.submit(raw_request)
        try:
            await req.finished_event.wait()
        except asyncio.CancelledError:
            self.abort_request(req)
            raise
        return req, req.output_token_ids

    def abort_request(self, req: Request):
        """Abort a queued or running request (reference TODO api_server.py:75)."""
        req.aborted = True
        self._work_event.set()

    # --- profiling (the reference has no tracer, SURVEY.md §5.1) ---------------
    def start_profile(self, trace_dir: str):
        """Begin a torch.profiler trace of the serving loop (host, and the
        device on a GPU); stop_profile writes it to trace_dir."""
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.device(self.device).type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._profiler = torch.profiler.profile(activities=acts)
        self._profiler.start()
        self._trace_dir = trace_dir

    def stop_profile(self):
        import os
        prof = getattr(self, "_profiler", None)
        if prof is not None:
            prof.stop()
            os.makedirs(self._trace_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(self._trace_dir,
                                                  "trace.json"))
            self._profiler = None

    # --- event loops (reference engine.py:89-171) -------------------------------
    async def _tokenize_event_loop(self):
        while True:
            if not self.untokenized_raw_requests:
                await self._wait_for_work()
                continue
            batch = self.untokenized_raw_requests
            self.untokenized_raw_requests = []
            prompts = [p for _, p in batch]
            token_ids = await self.tokenizer.batched_tokenize(prompts)
            arrived = []
            for (req, _), ids in zip(batch, token_ids):
                req.set_prompt_token_ids(ids)
                if not req.aborted and self._fits(req):
                    arrived.append(req)
            self.scheduler.on_requests_arrival(arrived)
            self._work_event.set()

    async def _wait_for_work(self):
        self._work_event.clear()
        await self._work_event.wait()

    def _release_request(self, r: Request):
        """Free every resource a terminal (finished/aborted) request holds.
        Idempotent via ``resources_freed``."""
        if r.resources_freed or r.seq_id < 0:
            return
        r.resources_freed = True
        self.model.free_seqs_resources([r])
        if getattr(r, "swapped", False):
            self.model.free_swap_resources([r])
            self.scheduler.on_swap_in_done([r])   # return its CPU-block budget
        self.scheduler.id_manager_for(r).free_id(r.seq_id)

    async def _run_on_model_async(self, fn, *args):
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(self._model_executor, fn, *args)

    def _dispatch(self, batch, groups=None, steps: int = 1):
        """Dispatch one step and apply its COUNT effects (token values arrive
        at resolution). ``steps`` S > 1 runs the batch through S chained
        decode steps in ONE program (scheduler qualifies the batch): counts
        advance by S per row so the pipelined next dispatch builds on the
        post-span state, and the on-device feedback buffer chains the input
        tokens. Returns the pending-step record."""
        tokens_dev, rows = self.model.forward_async(batch, groups=groups,
                                                    multi_step=steps)
        lp_dev = self.model.last_logprobs   # PendingTokens of f32[B*span], or None
        key = self.model.last_key
        span = (key.spec if key is not None and key.spec
                else key.steps if key is not None else max(steps, 1))
        entries = []   # (request, output position, batch row, drafts|None)
        for i, s in enumerate(rows):
            if s is None:
                continue
            r = s.request
            was_prefill = r.is_prefill_stage()
            samples = s.samples_token   # evaluate BEFORE mutating num_cached_tokens
            if s.drafts:
                # Spec-verify row: only the span's FIRST token is certainly
                # cached; accepted drafts join the count at resolution.
                r.num_cached_tokens += 1
                r.output_token_ids.append(None)
                r.output_logprobs.append(None)
                entries.append((r, len(r.output_token_ids) - 1, i, s.drafts))
                self.stats.num_spec_drafted += len(s.drafts)
                r.spec_drafted += len(s.drafts)
                continue
            r.num_cached_tokens += s.n_tokens if steps <= 1 else steps
            if was_prefill:
                self.stats.num_prompt_tokens += s.n_tokens
            if samples:
                # One placeholder per span token: finish-by-count must see
                # the full post-span length before the values resolve.
                n = max(steps, 1)
                r.output_token_ids.extend([None] * n)
                r.output_logprobs.extend([None] * n)
                # A row without drafts in a verify step is a verify row with
                # none (drafts ()): it takes its span's first token alone.
                entries.append((r, len(r.output_token_ids) - n, i,
                                () if key is not None and key.spec else None))
        self.stats.num_steps += 1
        return (tokens_dev, entries, time.perf_counter(), lp_dev, span)

    async def _resolve(self, pending):
        """Block (off the event loop) for a dispatched step's token values and
        apply them: fill placeholders, stream, EOS-stop, finish events. Spec
        rows (drafts is not None) additionally run the accept loop: the
        longest prefix of drafts matching the model's own per-position tokens
        is confirmed, plus the bonus token after it."""
        tokens_dev, entries, t_dispatch, lp_dev, span = pending
        loop = asyncio.get_running_loop()
        # Waits on the step's CUDA event, then reads the pinned host copy.
        tokens = await loop.run_in_executor(self._resolve_executor,
                                            tokens_dev.numpy)
        lps = (await loop.run_in_executor(self._resolve_executor, lp_dev.numpy)
               if lp_dev is not None else None)
        tokens2 = tokens.reshape(-1, span)
        lps2 = lps.reshape(-1, span) if lps is not None else None
        self.stats.total_step_time += time.perf_counter() - t_dispatch
        for r, pos, i, drafts in entries:
            if r.aborted or pos >= len(r.output_token_ids):
                continue   # aborted, or truncated by an earlier EOS
            vals = [int(tokens2[i, 0])]
            if drafts:
                for j, d in enumerate(drafts):
                    if d != vals[-1]:   # draft j+1 must equal the model's
                        break           # token at span position j
                    vals.append(int(tokens2[i, j + 1]))
                self.stats.num_spec_accepted += len(vals) - 1
                r.spec_accepted += len(vals) - 1
            elif drafts is None and span > 1:
                # Multi-step decode row: every span position is a real
                # sampled token (the scan chained them on device).
                vals = [int(v) for v in tokens2[i, :span]]
            # EOS truncation WITHIN the accepted run, then output-len clamp.
            for j, v in enumerate(vals):
                if v in self.eos_ids and pos + j + 1 < r.output_len:
                    vals = vals[: j + 1]
                    r.stopped_on_eos = True
                    break
            vals = vals[: max(1, r.output_len - pos)]
            if drafts:
                # Accepted drafts' KV is valid (they equal the confirmed
                # outputs); rejected/readout-truncated span KV is masked by
                # seq_lens and overwritten by the real tokens later.
                r.num_cached_tokens += len(vals) - 1
            # Spec rows appended ONE placeholder (extend with the accepted
            # tail); multi-step rows appended one per span position (fill in
            # place). The generic loop covers both.
            for j, v in enumerate(vals):
                if pos + j < len(r.output_token_ids):
                    r.output_token_ids[pos + j] = v
                else:
                    r.output_token_ids.append(v)
                    r.output_logprobs.append(None)
            for j, v in enumerate(vals):
                lp = float(lps2[i, j]) if lps2 is not None else None
                if pos + j < len(r.output_logprobs):
                    r.output_logprobs[pos + j] = lp
                r.output_q.put_nowait(StepOutput(v, r, logprob=lp))
            self.stats.num_tokens_generated += len(vals)
            if r.stopped_on_eos:
                del r.output_token_ids[pos + len(vals):]   # in-flight overshoot
                del r.output_logprobs[pos + len(vals):]
                from swiftllm_tpu_torch.server.spec import rollback_state
                rollback_state(r, r.prompt_len + len(r.output_token_ids))
            elif drafts is None and len(vals) < span:
                # Multi-step span clamped by output_len (scheduler normally
                # prevents this): drop the unfilled tail placeholders so the
                # count reflects real tokens only.
                del r.output_token_ids[pos + len(vals): pos + span]
                del r.output_logprobs[pos + len(vals): pos + span]
            if r.is_finished() and pos + len(vals) == len(r.output_token_ids):
                r.finished_event.set()
                self.stats.num_requests_finished += 1

    async def _drain_pipeline(self):
        while self._pending_steps:
            await self._resolve(self._pending_steps.popleft())

    @staticmethod
    def _tokens_ready(pending) -> bool:
        return pending[0].is_ready()

    async def _step(self) -> bool:
        """One engine iteration, pipelined up to ``pipeline_depth`` steps deep:
        keep dispatching (the on-device feedback buffer feeds step N's samples
        to step N+1 with no host round-trip) and resolve token VALUES
        opportunistically once their async device→host copies land. On a
        high-latency host↔chip link the resolve RTT spans several step times;
        a 1-deep pipeline would serialize on it."""
        # Reap finished/aborted requests before every scheduling decision —
        # finish-by-count is known at dispatch time while token VALUES
        # resolve one step later.
        self.scheduler.reap_terminal(self._release_request)
        if self._pending_steps and self.scheduler.spec_regime():
            # Speculative drafting needs RESOLVED token values; entering the
            # spec regime flushes the async pipeline once (spec steps then
            # resolve synchronously anyway).
            await self._drain_pipeline()
            self.scheduler.reap_terminal(self._release_request)
        decision = self.scheduler.get_next_batch()

        if decision.recompute:
            # Preempt-by-recompute: token VALUES must be resolved before the
            # reset (re-prefill feeds them back as known ids), so drain the
            # pipeline; then free pages + seq ids and zero the cached count —
            # the scheduler already requeued the victims at the waiting head.
            await self._drain_pipeline()
            await self._run_on_model_async(self.model.free_seqs_resources,
                                           decision.recompute)
            for r in decision.recompute:
                self.scheduler.id_manager_for(r).free_id(r.seq_id)
                r.seq_id = -1
                r.num_cached_tokens = 0
            self.stats.num_preemptions += len(decision.recompute)
        if decision.swap_out:
            # Resolve the pipeline's tokens first (the victims' last tokens
            # must be known on the host). Memory order needs no wait: the
            # page mover runs on the step's stream, after the steps that
            # wrote these pages.
            await self._drain_pipeline()
            await self._run_on_model_async(self.model.swap_out_seqs, decision.swap_out)
            self.scheduler.on_swap_out_done(decision.swap_out)
            for r in decision.swap_out:
                r.swapped = True
            self.stats.num_preemptions += len(decision.swap_out)
        if decision.swap_in:
            await self._run_on_model_async(self.model.swap_in_seqs, decision.swap_in)
            self.scheduler.on_swap_in_done(decision.swap_in)
            for r in decision.swap_in:
                r.swapped = False

        progressed = bool(decision.batch or decision.swap_in
                          or decision.swap_out or decision.recompute)
        if decision.batch:
            self._pending_steps.append(
                await self._run_on_model_async(self._dispatch, decision.batch,
                                               decision.groups, decision.steps))
            if any(s.drafts for s in decision.batch):
                # Spec steps resolve synchronously: the number of confirmed
                # tokens (and hence every count the next scheduling round
                # depends on) is value-dependent. Speculation trades pipeline
                # depth for multi-token steps.
                await self._drain_pipeline()

        # Resolve: force the head while the pipeline is over-full, drain
        # everything whose copy already landed, and block on the head when
        # there is nothing else to keep the device busy with.
        depth = self.engine_config.pipeline_depth
        while len(self._pending_steps) > depth:
            await self._resolve(self._pending_steps.popleft())
            progressed = True
        while self._pending_steps and self._tokens_ready(self._pending_steps[0]):
            await self._resolve(self._pending_steps.popleft())
            progressed = True
        if not decision.batch and self._pending_steps:
            await self._resolve(self._pending_steps.popleft())
            progressed = True
        return progressed

    async def _main_event_loop(self):
        while True:
            progressed = await self._step()
            if (not progressed and not self._pending_steps
                    and not self.scheduler.has_pending()):
                await self._wait_for_work()
            else:
                # Yield to the event loop so request/abort coroutines run.
                await asyncio.sleep(0)

    async def start_all_event_loops(self):
        """Run both loops forever (reference engine.py:173-181)."""
        assert self.initialized, "call await engine.initialize() first"
        try:
            await asyncio.gather(self._tokenize_event_loop(), self._main_event_loop())
        except BaseException as e:
            self._crashed = e
            raise
        finally:
            self.stop_followers()

    def stop_followers(self):
        """Release the follower ranks (tp/dp > 1) from their loops, on every
        way out of the serving loop: a crash, a cancellation, a shutdown.
        It runs on the model thread, after any step still in flight there,
        so the stop never interleaves with a step's broadcast; a second call
        does nothing."""
        from swiftllm_tpu_torch.parallel import distributed
        if distributed.world_size() > 1:
            self._model_executor.submit(distributed.stop_followers).result()
