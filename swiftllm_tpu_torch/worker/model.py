"""LlamaModel — the data-plane worker of the PyTorch port, one per rank.

A port of ``swiftllm_tpu/worker/model.py``:
``load_weights`` (with ``_load_loras``) / ``profile_num_blocks`` /
``init_kvcache_and_swap`` / ``forward_async`` / ``execute_packed`` /
``forward`` / ``swap_out_seqs`` / ``swap_in_seqs`` /
``free_swap_resources`` / ``free_seqs_resources`` / ``match_prefix``, with
the same host guard on the decode kernel's row contract. A bucket key with
``sampling`` runs the sampler in place of the greedy head, one with
``steps`` > 1 runs ``decode_multi_step``, one with ``spec`` > 0 (a
speculative verify step) the span head over every position of each row's
span, and with ``enable_logprobs`` every step also returns its chosen
tokens' logprobs.

- The model runs on ``device`` ("cuda" unless the caller asks for "cpu"), and
  raises when asked for a GPU it does not find.
- ``profile_num_blocks`` runs the worst-case bucket once on a small probe
  cache, and the other buckets that need the most memory (``profile_keys``:
  sampled, verify, a window) on empty batches, and takes their scratch from
  ``torch.cuda.max_memory_allocated()`` (the JAX package reads it from the
  compiled program instead); with graphs it captures them too, whose pool
  stays reserved, and keeps room for the executables of every graph the
  engine's warm-up will take; then it sizes the cache from
  ``torch.cuda.mem_get_info()`` and ``hbm_mem_utilization``.
- ``forward_async`` never synchronises: the batch goes up through pinned
  memory with ``non_blocking=True``, every write stays on the current
  stream (so step N+1 reads step N's tokens from the feedback buffer in
  order), and the tokens come back through a ``PendingTokens`` handle.
- CUDA graphs (``worker/graphs.py``): on the card at world size 1 (tp = dp
  = 1), every step and every multi-step window is the replay of a graph
  captured once per graph key, the first use of a key running eagerly and
  capturing after it; ``capture`` captures a bucket ahead of traffic (the
  JAX package's ``_lower``), every plan of it, as the engine's warm-up does
  after each of its steps. Steps run eagerly, as ``models/llama.py``'s
  step function, on the CPU (no graphs there) and at world size > 1 (gloo's
  collectives cannot be captured, and NCCL's have not run: one card), and
  with ``cuda_graphs=False`` (a comparison's and the tests' way to the
  eager step on the card).
- Swap preemption: the host pool is one page-locked tensor
  ``[L, num_cpu_blocks * block_size, W]`` in the cache's type, allocated
  when the scheduler can swap (``preemption_mode="swap"`` and
  ``num_cpu_blocks`` > 0). Whole sequences move page by page through the
  page mover (``ops/swap_pages.py``), every request of a swap in one launch
  on the step's stream; nothing waits for the card.
- LoRA adapters (``lora_paths``) are stacked into the params on the device
  (``worker/lora.py``) and applied in every step by ``models/llama.py``.
- Speculative decoding and prefix caching run (the scheduler drafts and
  matches; the model verifies spans and installs matched pages).
- tp/dp > 1 (``parallel/``): one process per rank, rank = dp_rank * tp +
  tp_rank. Each rank holds its shard of the weights, its dp group's cache
  at its shard's lanes, its group's feedback buffer and a host pool of its
  shard's lanes. Rank 0 (the primary) builds each step and broadcasts it
  (``forward_async``); the other ranks replay it (``execute_packed``, from
  ``distributed.follower_loop``), and the swap ops through their payloads
  (``apply_swap_out/in/free``). Every rank runs ``init_kvcache_and_swap``
  at once: the profile's probe step is a collective step too, and
  ``agree_num_blocks`` gives every rank rank 0's count.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from swiftllm_tpu_torch.config import EngineConfig, LlamaModelConfig
from swiftllm_tpu_torch.models.llama import (FP8_SCALE_LANES, make_step_fn,
                                             step_switches)
from swiftllm_tpu_torch.ops import build
from swiftllm_tpu_torch.ops import int4_matmul
from swiftllm_tpu_torch.ops import paged_attention as pa
from swiftllm_tpu_torch.ops.swap_pages import pinned_pool, swap_pages
from swiftllm_tpu_torch.parallel import distributed
from swiftllm_tpu_torch.parallel.mesh import (effective_num_kv_heads,
                                              make_mesh, param_specs,
                                              shard_params)
from swiftllm_tpu_torch.server.scheduler import ScheduledSeq
from swiftllm_tpu_torch.server.structs import RawRequest, Request
from swiftllm_tpu_torch.utils import GB, cdiv, next_power_of_2
from swiftllm_tpu_torch.worker.batch_builder import (build_step_batch,
                                                     pack_step_batch,
                                                     packed_len,
                                                     select_buckets)
from swiftllm_tpu_torch.worker.block_manager import BlockManager
from swiftllm_tpu_torch.worker.graphs import (StepGraphs, capture_stream,
                                              exec_memory, graph_key)


def _assert_decode_prefix(batch_np, key, dp: int):
    """Host-side guard for the decode kernel's row contract: valid decode
    rows must form a CONTIGUOUS PREFIX of each dp group's row axis, with flat
    token b belonging to row b. build_step_batch packs decode rows first, so
    this should never fire for engine traffic; it turns a violating direct
    caller's wrong attention into a stack trace."""
    q_lens = np.asarray(batch_np.q_lens).reshape(dp, -1)
    if key.q_len > 1:
        dec = np.asarray(batch_np.decode_row).reshape(dp, -1)
        valid = (q_lens > 0) & dec
    else:
        valid = q_lens > 0
    counts = valid.sum(axis=1)
    for g in range(dp):
        n = int(counts[g])
        if n and not valid[g, :n].all():
            raise ValueError(
                f"dp group {g}: decode-kind rows are not a contiguous prefix "
                f"(valid rows at {np.nonzero(valid[g])[0].tolist()}) — this "
                "violates the decode kernel's row contract; pack decode rows "
                "first (see worker/batch_builder.build_step_batch)")


def quantized_stacks(params) -> dict:
    """The quantized weights of ``params`` (INT8 ``q`` or INT4 ``q4``
    stacks, and the head), by name."""
    named = {**params["layers"], "lm_head": params["lm_head"]}
    return {k: v for k, v in named.items()
            if isinstance(v, dict) and ("q" in v or "q4" in v)}


def check_quantized_widths(params, t_max: int) -> None:
    """Refuse quantized weights that the weight kernels cannot take in a
    step of up to ``t_max`` rows: K a multiple of 16 (INT8), and for INT4
    K/2 a multiple of 16 once a step can pass ``int4_matmul.WIDE_ABOVE``
    tokens (the wide configuration copies its rows by TMA). Raises
    ``ValueError`` naming the weight and its shape."""
    for name, v in quantized_stacks(params).items():
        q = v.get("q", v.get("q4"))
        if q.shape[-1] % 16 and ("q" in v or t_max > int4_matmul.WIDE_ABOVE):
            kind = "INT8 K" if "q" in v else (
                f"INT4 K/2 (steps of up to {t_max} rows)")
            raise ValueError(f"{name}: quantized weight {tuple(q.shape)}; the "
                             f"weight kernels take {kind} only in multiples of 16")


def check_attention_shape(mc: LlamaModelConfig, tp: int = 1,
                          num_kv_eff: int | None = None) -> None:
    """Refuse a model whose shard's attention the kernels cannot take: a
    head_dim other than 64 or 128, or a GQA group above
    ``paged_attention.MAX_GROUP`` (e.g. 128 query heads over 8 kv heads).
    A shard holds n_q / tp query heads over ``num_kv_eff`` / tp kv heads
    (kv heads replicated up to tp). Raises ``ValueError`` naming n_q, n_kv,
    head_dim and the group; the card keeps no plain fallback."""
    n_kv = mc.num_kv_heads if num_kv_eff is None else num_kv_eff
    pa.check_attention_shape(mc.num_q_heads // tp, n_kv // tp, mc.head_dim)


class PendingTokens:
    """A step's sampled tokens (or their logprobs) on their way to the host.
    On the GPU the copy into pinned host memory is queued behind the step
    (``non_blocking``) and a CUDA event marks its end; ``numpy()`` waits on
    that event only. The copy is taken at once either way: a graph's static
    outputs are overwritten by its next replay."""

    def __init__(self, tokens: torch.Tensor):
        self._event = None
        if tokens.device.type == "cuda":
            self._host = torch.empty(tokens.shape, dtype=tokens.dtype,
                                     pin_memory=True)
            self._host.copy_(tokens, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = tokens.clone()

    def is_ready(self) -> bool:
        return self._event is None or self._event.query()

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


def bind_device(device) -> None:
    """Make ``device`` the calling thread's current card, where it names one.
    The current card is per thread, and a thread that never set it is on
    card 0: the thread that builds the model, the engine's model thread and
    a follower's loop each call this before they touch the card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)


class LlamaModel:
    def __init__(self, engine_config: EngineConfig,
                 model_config: LlamaModelConfig | None = None,
                 device: str | torch.device = "cuda",
                 cuda_graphs: bool = True):
        self.engine_config = engine_config
        self.model_config = model_config or LlamaModelConfig.load_from_model_path(
            engine_config.model_path)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("LlamaModel: no CUDA device found; pass "
                               "device='cpu' to run on the CPU")
        bind_device(self.device)
        # f32 products in full f32 on the card (PyTorch's default, stated).
        torch.backends.cuda.matmul.allow_tf32 = False
        # This rank's place in the (dp, tp) layout: a collective call with
        # tp/dp > 1, which every rank makes here.
        self.mesh = make_mesh(engine_config.dp_size, engine_config.tp_size,
                              self.device)
        self.dp = self.mesh.dp
        self.tp = self.mesh.tp
        self.num_kv_eff = effective_num_kv_heads(self.model_config.num_kv_heads,
                                                 self.tp)
        self.dtype = getattr(torch, engine_config.dtype)
        self.kv_dtype = (torch.float8_e4m3fn
                         if engine_config.kv_quant == "fp8" else self.dtype)
        if (self.device.type == "cuda" and engine_config.use_pallas
                and self.dtype != torch.bfloat16):
            raise ValueError("the CUDA attention kernels take bfloat16 "
                             "activations: use dtype='bfloat16', or "
                             "use_pallas=False for the plain PyTorch path")
        self.params = None
        self.kv_cache = None          # [L, S, W], updated in place each step
        self.token_feedback = None    # i32[max_seqs + 1], last sample per seq
        self.last_logprobs = None     # PendingTokens of the last dispatch's
                                      # f32 logprobs (enable_logprobs), or None
        self.last_key = None          # BucketKey of the most recent dispatch
        self.lora_slots: dict[str, int] = {}   # adapter name -> slot (>= 1)
        self.lora_targets: tuple[str, ...] = ()
        self.cpu_cache = None         # pinned host [L, cpu_slots, W], or None
        self.hbm_block_mgrs: list[BlockManager] = []
        self.cpu_block_mgr: BlockManager | None = None
        self.num_blocks_per_shard = 0
        # The rule for CUDA graphs: on the card, at world size 1, unless the
        # caller asks for the eager step (``cuda_graphs=False``).
        self.graphs = (StepGraphs(self.device,
                                  layers=self.model_config.num_layers)
                       if (cuda_graphs and self.device.type == "cuda"
                           and distributed.world_size() == 1) else None)
        self.profiled: dict = {}      # profile_num_blocks' budget, in bytes:
                                      # step scratch, graph pool, graph
                                      # executables (and their count), a page

    # --- init -----------------------------------------------------------------
    def load_weights(self):
        from swiftllm_tpu_torch.worker.weights import load_params
        if self.graphs is not None:
            self.graphs.clear()       # they hold the old weights' addresses
        self.params = load_params(self.engine_config, self.model_config,
                                  self.device, self.mesh)
        if self.engine_config.lora_paths:
            self._load_loras()

    def _load_loras(self):
        """Stack the configured LoRA adapters into the params on the device:
        ``layers["lora_<target>"] = {"A": [L, n, r, in], "B": [L, n, out,
        r]}`` (B laid out for ``lora_add``'s GEMM, ``weights.lora_entry``)
        and ``lora_scale`` f32[n], each cut to this rank's shard
        (``mesh.param_specs``). lora_paths: "name=/path,name2=/path2", or
        "dummy:a,b[,r=K]" for seeded random adapters (tests, no files). The
        adapters are read in f32 and cast to the activation dtype here."""
        from swiftllm_tpu_torch.worker.lora import (load_lora_adapters,
                                                    make_dummy_loras)
        from swiftllm_tpu_torch.worker.weights import lora_entry
        spec_raw, mc = self.engine_config.lora_paths, self.model_config
        if spec_raw.startswith("dummy:"):
            r, names = 8, []
            for p in (p for p in spec_raw[len("dummy:"):].split(",") if p):
                if p.startswith("r="):
                    r = int(p[2:])
                else:
                    names.append(p)
            entries, scales, slots, targets = make_dummy_loras(
                names, mc, self.num_kv_eff, np.float32, r=r)
        else:
            paths = dict(item.split("=", 1)
                         for item in spec_raw.split(",") if item)
            entries, scales, slots, targets = load_lora_adapters(
                paths, mc, self.num_kv_eff, np.float32)
        self.lora_slots, self.lora_targets = slots, targets
        specs = param_specs(lora_targets=targets)["layers"]
        mine = shard_params({k: {h: torch.from_numpy(a) for h, a in v.items()}
                             for k, v in entries.items()},
                            specs, self.mesh.tp_rank, self.tp)
        for k, v in mine.items():
            self.params["layers"][k] = lora_entry(
                {h: a.to(self.device, self.dtype) for h, a in v.items()})
        self.params["lora_scale"] = torch.from_numpy(scales).to(self.device)

    def _lanes(self) -> int:
        """This rank's cache lane width: [K_all ‖ V_all] of its n_kv_eff / tp
        heads, plus under fp8 KV one tile of per-token power-of-2 K/V scale
        lanes (models/llama.py)."""
        mc = self.model_config
        lanes = 2 * (self.num_kv_eff // self.tp) * mc.head_dim
        if self.engine_config.kv_quant == "fp8":
            lanes += FP8_SCALE_LANES
        return lanes

    def _cache_shape(self, num_blocks: int) -> tuple[int, int, int]:
        """[L, S, W]: S = (num_blocks + 1) * block_size (+1 garbage page),
        W = ``_lanes()``."""
        mc, cfg = self.model_config, self.engine_config
        return (mc.num_layers, (num_blocks + 1) * cfg.block_size, self._lanes())

    def _allocate(self, num_blocks: int):
        """Zeroed cache and feedback buffer (this rank's dp group's), and a
        fresh block manager for each dp group (the primary's scheduler
        places every group's pages). The cache starts at zero so a page
        never read before holds no NaN."""
        cfg = self.engine_config
        if self.graphs is not None:
            self.graphs.clear()       # they hold the old cache's address
        self.num_blocks_per_shard = num_blocks
        self.kv_cache = torch.zeros(self._cache_shape(num_blocks),
                                    dtype=self.kv_dtype, device=self.device)
        self.token_feedback = torch.zeros(cfg.max_seqs_in_block_table + 1,
                                          dtype=torch.int32, device=self.device)
        self.hbm_block_mgrs = [BlockManager(
            f"hbm{g}", num_blocks, cfg.block_size, cfg.max_seqs_in_block_table,
            cfg.max_blocks_per_seq,
            enable_prefix_caching=cfg.enable_prefix_caching)
            for g in range(self.dp)]

    def profile_keys(self, probe) -> list:
        """The buckets whose steps need the most memory, ``probe`` (the
        greedy prefill of the most tokens) first: the same bucket sampled
        (the sampler's int64 candidate keys over [rows, V] and, with
        ``enable_logprobs``, the log-softmax), with spec decode a sampled
        verify step of ``spec_max_rows`` spans (its head over every span
        position, [rows * q bucket, V]), and with ``multi_step_decode`` S >
        1 a sampled window of S steps (deferred or not as
        ``SWIFTLLM_DEFER_KV`` says now). Each key but the probe's is
        ``select_buckets``' for such a batch."""
        cfg = self.engine_config

        def sampled(n: int, n_tokens: int, drafts=()) -> list:
            return [[ScheduledSeq(Request(RawRequest("", 1, temperature=1.0)),
                                  n_tokens, drafts) for _ in range(n)]]
        keys = [probe, dataclasses.replace(probe, sampling=1)]
        if cfg.enable_spec_decode:
            keys.append(select_buckets(
                sampled(min(cfg.spec_max_rows, cfg.max_batch_size),
                        1 + cfg.spec_k, (0,) * cfg.spec_k), cfg))
        if cfg.multi_step_decode > 1:
            keys.append(select_buckets(sampled(cfg.max_batch_size, 1), cfg,
                                       multi_step=cfg.multi_step_decode))
        return keys

    def profile_num_blocks(self, graph_buckets=()) -> int:
        """KV pages that fit the device. On a probe cache, run the
        worst-case bucket once (a greedy prefill of the most tokens), then
        the other buckets of ``profile_keys`` on an empty batch of their
        shape (a step allocates by shape, not by value), all eagerly, and
        take their scratch as the rise of ``max_memory_allocated``. With
        graphs, capture each of those steps too: the graph pool keeps what
        it reserved (``graphs.StepGraphs``), so ``mem_get_info()`` counts it
        as used, and the captures of serving reuse it (a key's first use
        runs eagerly, so both pools are needed); the probe's bucket is
        captured at every plan. The graphs' executables take device memory
        outside the allocator (some 6.5 MB a step graph at 8B width, 32
        layers, on an H100), which CUDA keeps once given
        (``graphs.ExecMemory``): the budget keeps what every graph of
        ``graph_buckets`` (every plan of each, as the engine's warm-up
        captures them; ``server/engine.py:warmup_buckets``) will take
        beyond what the card holds for graphs already, at the bytes a layer
        of a step that these captures took. Give the cache what is left of
        ``mem_get_info()``'s total times ``hbm_mem_utilization`` (right
        for one rank a card; ranks that share a card take
        ``num_hbm_blocks``). The probe steps run on every rank at once, as a
        step does. With quantized weights the probe's bucket (over 256
        tokens) runs ``quant.proj``, so the scratch holds its bf16 copy of
        the largest weight (or ``lm_head`` chunk), more than the INT4
        kernel's split-K workspace of a decode bucket needs."""
        cfg, mc = self.engine_config, self.model_config
        if cfg.num_hbm_blocks is not None:
            return cfg.num_hbm_blocks
        block_bytes = (mc.num_layers * self._lanes() * self.kv_dtype.itemsize
                       * cfg.block_size)
        if self.device.type == "cpu":
            # No probe on the host: a 1 GB budget, as the JAX package's CPU
            # backend assumes.
            return max(1, GB // block_bytes)
        chunk = min(cfg.prefill_chunk_size, cfg.max_tokens_in_batch,
                    cfg.max_seq_len - 1)
        n_rows = max(1, min(cfg.max_tokens_in_batch // chunk,
                            cfg.max_batch_size))
        self._allocate(n_rows * cdiv(chunk, cfg.block_size))
        groups = []
        for g in range(self.dp):
            groups.append([])
            for i in range(n_rows):
                r = Request(RawRequest("", 1))
                r.set_prompt_token_ids([0] * chunk)
                r.seq_id, r.dp_group = i, g
                groups[g].append(ScheduledSeq(r, chunk))
        torch.cuda.synchronize(self.device)
        torch.cuda.reset_peak_memory_stats(self.device)
        base = torch.cuda.memory_allocated(self.device)
        graphs, self.graphs = self.graphs, None       # the probe runs eagerly
        try:
            self.forward([s for grp in groups for s in grp], groups)
            keys = self.profile_keys(self.last_key)
            for key in keys[1:]:
                self.execute_packed(
                    np.zeros(self.dp * packed_len(key), np.int32), key)
            torch.cuda.synchronize(self.device)
        finally:
            self.graphs = graphs
        scratch = torch.cuda.max_memory_allocated(self.device) - base
        pool = execs = n_graphs = 0
        if graphs is not None:
            mem = exec_memory(self.device)
            peak0 = mem.peak
            capture_stream(self.device)     # its cuBLAS workspace made first
            torch.cuda.synchronize(self.device)
            free0 = torch.cuda.mem_get_info(self.device)[0]
            held0 = torch.cuda.memory_reserved(self.device)
            self.capture(keys[0])       # every plan of the probe's bucket
            for key in keys[1:]:
                self.capture(key, live_rows=0)
            torch.cuda.synchronize(self.device)
            # What the captures took outside the allocator: the graphs'
            # executables, for the units they raised the peak by.
            outside = (free0 - torch.cuda.mem_get_info(self.device)[0]
                       - (torch.cuda.memory_reserved(self.device) - held0))
            if outside > 0 and mem.peak > peak0:
                mem.per_unit = outside / (mem.peak - peak0)
            pool = graphs.pool_bytes
            graphs.clear()   # dropped with the probe cache; the pool stays
            plans = [len(self._plan_keys(k)) for k in graph_buckets]
            n_graphs = sum(plans)
            execs = mem.to_take(graphs.layers * sum(
                n * k.steps for n, k in zip(plans, graph_buckets)))
        self.kv_cache = self.token_feedback = None
        self.hbm_block_mgrs = []
        torch.cuda.empty_cache()
        # The graph pool's reserved bytes are used memory here already.
        free, total = torch.cuda.mem_get_info(self.device)
        usable = (int(total * cfg.hbm_mem_utilization) - (total - free)
                  - scratch - execs)
        num = usable // block_bytes
        self.profiled = dict(scratch=scratch, graph_pool=pool,
                             graph_execs=execs, graphs=n_graphs,
                             block_bytes=block_bytes)
        if num <= 0:
            raise RuntimeError(
                f"no device memory left for the KV cache: total={total / GB:.1f}GB "
                f"free={free / GB:.1f}GB scratch={scratch / GB:.1f}GB "
                f"graph pool={pool / GB:.1f}GB graph executables="
                f"{execs / GB:.1f}GB")
        return int(num)

    def init_kvcache_and_swap(self, num_blocks_per_shard: int | None = None,
                              graph_buckets=()):
        """Allocate the KV cache (sized by ``profile_num_blocks`` unless
        given, then agreed with rank 0; ``graph_buckets`` are the buckets
        whose every plan it budgets graphs for), the feedback buffer and the host
        swap pool's block manager. The pool itself, ``[L, num_cpu_blocks *
        block_size, W]`` at this rank's lanes in the cache's type and
        page-locked on a GPU host (``pinned_pool``), is allocated only when
        the scheduler can swap (``preemption_mode="swap"``,
        ``num_cpu_blocks`` > 0; otherwise it preempts by recompute and never
        touches it). It is left uninitialised: a page is read only after a
        swap-out wrote it. The host pages' block manager is one for all dp
        groups, kept in step on every rank. On the card it first refuses
        quantized weights that the weight kernels cannot take
        (``check_quantized_widths``) and a shard's attention shape that the
        attention kernels cannot take (``check_attention_shape``)."""
        cfg = self.engine_config
        if self.device.type == "cuda" and cfg.use_pallas:
            check_quantized_widths(self.params, self._max_weight_rows())
            check_attention_shape(self.model_config, self.tp, self.num_kv_eff)
        if num_blocks_per_shard is None:
            num_blocks_per_shard = self.profile_num_blocks(graph_buckets)
        num_blocks_per_shard = distributed.agree_num_blocks(num_blocks_per_shard)
        self._allocate(num_blocks_per_shard)
        self.cpu_block_mgr = BlockManager(
            "cpu", cfg.num_cpu_blocks, cfg.block_size,
            self.dp * cfg.max_seqs_in_block_table, cfg.max_blocks_per_seq)
        self.cpu_cache = None
        if cfg.preemption_mode == "swap" and cfg.num_cpu_blocks > 0:
            L, _, W = self._cache_shape(0)
            shape = (L, cfg.num_cpu_blocks * cfg.block_size, W)
            self.cpu_cache = (pinned_pool(shape, self.kv_dtype)
                              if self.device.type == "cuda"
                              else torch.empty(shape, dtype=self.kv_dtype))

    @property
    def num_hbm_blocks(self) -> int:
        return self.num_blocks_per_shard

    # --- the step --------------------------------------------------------------
    def forward_async(self, scheduled: list[ScheduledSeq],
                      groups: list[list[ScheduledSeq]] | None = None,
                      return_logits: bool = False, multi_step: int = 1):
        """Dispatch one step WITHOUT waiting for it.

        Returns (tokens, rows[, logits]): ``tokens`` is a ``PendingTokens``
        whose copy to the host is already queued. The next step can be
        dispatched before this one's values reach the host: the builder
        reads unresolved tokens from the on-device feedback buffer. With
        ``multi_step`` S > 1 (a pure-decode batch) the dispatch runs S chained
        decode steps and the tokens come out [B_bucket * S], row-major. With
        dp > 1 ``groups`` holds each dp group's rows; with several ranks the
        packed batch is broadcast, and every rank runs the step."""
        if groups is None:
            assert self.dp == 1, "pass explicit dp groups when dp > 1"
            groups = [scheduled]
        batch_np, key, rows = build_step_batch(groups, self.hbm_block_mgrs,
                                               self.engine_config,
                                               multi_step=multi_step)
        if self.engine_config.use_pallas:
            _assert_decode_prefix(batch_np, key, self.dp)
        flat, key = distributed.broadcast_step(
            pack_step_batch(batch_np, self.dp), key, dp=self.dp,
            return_logits=return_logits)
        out = self.execute_packed(flat, key, return_logits)
        if return_logits:
            tokens, logits = out
            return tokens, rows, logits
        return out, rows

    def execute_packed(self, flat_np: np.ndarray, key,
                       return_logits: bool = False):
        """Run one dispatch from a packed batch buffer (every dp group's; this
        rank runs its own group's slice): one step, or the ``key.steps``
        chained decode steps of a multi-step window. Followers enter here
        from ``distributed.follower_loop``. Returns the tokens'
        ``PendingTokens`` (and the f32 logits tensor when asked, single
        steps only), every dp group's. With ``enable_logprobs`` the
        logprobs' copy to the host is queued too, as ``last_logprobs``.
        With graphs the step is a replay (``_graph_step``), else it runs
        eagerly."""
        self.last_key = key
        n = packed_len(key)
        local = flat_np[self.mesh.dp_rank * n:(self.mesh.dp_rank + 1) * n]
        # Rows from live_rows on have no query: the attention kernels plan
        # their key splits over the rows below it (a host integer, read from
        # the group's q_lens, after its T token ids and B q_starts).
        q_lens = local[key.tokens + key.rows:key.tokens + 2 * key.rows]
        live = np.flatnonzero(q_lens > 0)
        live_rows = int(live[-1]) + 1 if live.size else 0
        flat = torch.from_numpy(np.ascontiguousarray(local))
        if self.device.type == "cuda":
            flat = flat.pin_memory()
        switches = step_switches()
        if self.graphs is None:
            tokens, logits, lp = self._step_fn(key, return_logits, live_rows,
                                               switches)(
                self.params, self.kv_cache, self.token_feedback,
                flat.to(self.device, non_blocking=True))
        else:
            tokens, logits, lp = self._graph_step(flat, key, return_logits,
                                                  live_rows, switches)
        self.last_logprobs = PendingTokens(lp) if lp is not None else None
        pending = PendingTokens(tokens)
        return (pending, logits) if return_logits else pending

    def _step_fn(self, key, return_logits: bool, live_rows: int, switches):
        """``models/llama.py:make_step_fn`` for bucket ``key``."""
        cfg = self.engine_config
        return make_step_fn(
            self.model_config, page_size=cfg.block_size, q_bucket=key.q_len,
            use_kernels=cfg.use_pallas, T=key.tokens, B=key.rows, Pg=key.pages,
            return_logits=return_logits, use_sampler=bool(key.sampling),
            return_logprobs=cfg.enable_logprobs, sample_span=key.spec,
            multi_step=key.steps, live_rows=live_rows, mesh=self.mesh,
            switches=switches)

    def _graph_key_args(self) -> dict:
        """``graph_key``'s keyword arguments: the engine settings the step
        reads, and ``step_plans``' for this rank's shard. The CPU has no
        SMs: its plain versions never split, and neither do its plans."""
        mc, cfg = self.model_config, self.engine_config
        return dict(use_kernels=cfg.use_pallas, logprobs=cfg.enable_logprobs,
                    n_q=mc.num_q_heads // self.tp,
                    n_kv=self.num_kv_eff // self.tp, hd=mc.head_dim,
                    page_size=cfg.block_size,
                    window=mc.sliding_window or 0,
                    n_sms=(build.sm_count(self.kv_cache.device)
                           if self.device.type == "cuda" else 0))

    def _graph_step(self, flat: torch.Tensor, key, return_logits: bool,
                    live_rows: int, switches):
        """One step from its graph: the batch copied into the graph's static
        input and the graph replayed. A key's first use runs the step
        eagerly on its batch, then captures it, and outside a warm-up counts
        in ``graphs.first_use``. Returns (tokens, logits or None, logprobs or
        None); logits are copied out of the graph."""
        gkey, rows = graph_key(key, return_logits, live_rows, switches,
                               **self._graph_key_args())
        entry = self.graphs.table.get(gkey)
        if entry is None:
            if not self.graphs.warming:
                self.graphs.first_use += 1
            out = self._step_fn(key, return_logits, live_rows, switches)(
                self.params, self.kv_cache, self.token_feedback,
                flat.to(self.device, non_blocking=True))
            self._capture(gkey, rows)
            return out
        entry.load(flat)
        tokens, logits, lp = entry.replay()
        return tokens, None if logits is None else logits.clone(), lp

    def _capture(self, gkey, rows: int):
        """Capture the step of graph key ``gkey`` over ``rows`` rows, on a
        static input of its bucket's shape (the capture reads nothing)."""
        key = gkey.bucket
        if not self.graphs.table:
            self._size_counters()
        flat = torch.zeros(packed_len(key), dtype=torch.int32,
                           device=self.device)
        step = self._step_fn(key, gkey.return_logits, rows, gkey.switches)
        return self.graphs.capture(
            gkey, lambda f: step(self.params, self.kv_cache,
                                 self.token_feedback, f),
            flat, (self.kv_cache, self.token_feedback))

    def _max_weight_rows(self) -> int:
        """The most rows a quantized projection or the head takes in a step:
        the largest bucket, or a verify step's spans."""
        cfg = self.engine_config
        return max(next_power_of_2(max(cfg.token_buckets)),
                   next_power_of_2(cfg.max_batch_size) * next_power_of_2(cfg.spec_k + 1))

    def _size_counters(self):
        """Size the kernels' split counters for the largest bucket, once,
        and pin them while the graph table lives: ``units + 2`` of the
        widest decode or prefill plan, and one a tile and token tile of the
        widest quantized projection or head (INT8 or INT4): 16-token tiles
        up to 256 tokens, 256-token tiles of the largest bucket or verify
        head above."""
        if self.device.type != "cuda":
            return
        cfg, mc = self.engine_config, self.model_config
        dev = self.kv_cache.device
        rows = next_power_of_2(cfg.max_batch_size)
        max_q = next_power_of_2(max(cfg.token_buckets))
        w = self._graph_key_args()
        build.device_counters("paged_attention", dev, 2 + pa.max_split_units(
            rows, max_q, n_q=w["n_q"], n_kv=w["n_kv"], hd=w["hd"]))
        quantized = list(quantized_stacks(self.params).values())
        if quantized and cfg.use_pallas:
            owner = "int8_matmul" if "q" in quantized[0] else "int4_matmul"
            n_max = max(v["s"].shape[-1] for v in quantized)
            build.device_counters(
                owner, dev, cdiv(n_max, int4_matmul.BM) * max(
                    cdiv(int4_matmul.WIDE_ABOVE, int4_matmul.TOKEN_WIDTHS[0]),
                    cdiv(self._max_weight_rows(), int4_matmul.WIDE_NT)))
        build.hold_counters(dev, self.graphs)

    def capture(self, key, live_rows: int | None = None) -> int:
        """Capture bucket ``key``'s step without serving, the counterpart of
        the JAX package's ``_lower``: for ``live_rows``, or by default for
        every plan a step of the key can meet (``live_rows`` 1 to
        ``key.rows``), under the environment's switches now, returning no
        logits (as serving asks for none). Returns how many graphs it
        captured (a plan already captured is skipped). Raises where graphs
        do not run."""
        if self.graphs is None:
            raise RuntimeError("this model runs its steps eagerly (CPU, "
                               "world size > 1 or cuda_graphs=False): "
                               "nothing to capture")
        n = 0
        for gkey, rows in self._plan_keys(key, live_rows).items():
            if gkey not in self.graphs.table:
                self._capture(gkey, rows)
                n += 1
        return n

    def _plan_keys(self, key, live_rows: int | None = None) -> dict:
        """The graph keys (no logits, the environment's switches now) of a
        step of bucket ``key`` over ``live_rows``, or over every live row
        count from 1 to ``key.rows``, each with the rows its graph plans
        over (``graph_key``)."""
        switches, widths = step_switches(), self._graph_key_args()
        out = {}
        for live in ([live_rows] if live_rows is not None
                     else range(1, key.rows + 1)):
            gkey, rows = graph_key(key, False, live, switches, **widths)
            out.setdefault(gkey, rows)
        return out

    def forward(self, scheduled: list[ScheduledSeq],
                groups: list[list[ScheduledSeq]] | None = None,
                return_logits: bool = False, multi_step: int = 1):
        """Run one step synchronously. Returns (tokens i32[B_bucket], rows
        [, logits f32[B_bucket, V]]) as numpy; rows[i] is the ScheduledSeq of
        row i (None for padding). With ``multi_step`` S > 1 the tokens are
        [B_bucket * S], row-major. B_bucket counts every dp group's rows."""
        out = self.forward_async(scheduled, groups, return_logits, multi_step)
        if return_logits:
            tokens, rows, logits = out
            return tokens.numpy(), rows, logits.cpu().numpy()
        tokens, rows = out
        return tokens.numpy(), rows

    # --- swap (host offload) ------------------------------------------------
    # Whole-sequence granularity, as in the JAX package; the pages of every
    # request of one swap move in ONE launch of the page mover, on the step's
    # stream, so nothing here waits for the card (the engine drains its
    # pipeline before a swap-out to resolve tokens, not for memory order).
    # The primary encodes each swap as a payload, announces it, and applies
    # it as every follower does: each rank moves its shard's lanes of its
    # own dp group's pages into (or out of) its own pool, and every rank
    # keeps the host block manager in step.

    def _cpu_key(self, g: int, seq_id: int) -> int:
        """Row of the host pool's block table: seq ids are per dp group."""
        return g * self.engine_config.max_seqs_in_block_table + seq_id

    def _page_bytes(self) -> int:
        """Bytes of one page across all layers (this rank's lanes)."""
        return (self.model_config.num_layers * self.engine_config.block_size
                * self._lanes() * self.kv_dtype.itemsize)

    @staticmethod
    def _encode_swap_payload(entries) -> np.ndarray:
        """[per request: dp_group, seq_id, n_tokens, n_pages, page ids...]:
        the flat i32 wire format every rank replays a swap op from
        (``distributed.broadcast_swap``)."""
        out: list[int] = []
        for g, seq_id, n_tokens, pages in entries:
            out += [g, seq_id, n_tokens, len(pages)]
            out += [int(p) for p in pages]
        return np.asarray(out, np.int32)

    @staticmethod
    def _decode_swap_payload(payload: np.ndarray):
        i, n = 0, len(payload)
        while i < n:
            g, seq_id, n_tokens, n_pages = (int(x) for x in payload[i:i + 4])
            yield g, seq_id, n_tokens, np.asarray(payload[i + 4:i + 4 + n_pages])
            i += 4 + n_pages

    def swap_out_seqs(self, requests: list[Request]):
        """Offload whole sequences' KV pages to the host pool and free their
        device pages. The pages past ``num_cached_tokens`` hold nothing
        cached and stay behind."""
        if not requests:
            return
        payload = self._encode_swap_payload(
            [(r.dp_group, r.seq_id, r.num_cached_tokens,
              self.hbm_block_mgrs[r.dp_group].seq_block_ids(r.seq_id))
             for r in requests])
        distributed.broadcast_swap(distributed.OP_SWAP_OUT, payload)
        self.apply_swap_out(payload)
        for r in requests:
            self.hbm_block_mgrs[r.dp_group].free_seq(r.seq_id)

    def apply_swap_out(self, payload: np.ndarray):
        """Every rank: allocate the host pages of each sequence, and move the
        pages of this rank's dp group out of the cache in one launch. Device
        page ids come from the payload: followers track no device pages."""
        src, dst = [], []
        for g, seq_id, n_tokens, dev in self._decode_swap_payload(payload):
            host = self.cpu_block_mgr.allocate_fresh_for_seq(
                self._cpu_key(g, seq_id), n_tokens)
            assert len(dev) >= len(host), (len(dev), len(host))
            if g == self.mesh.dp_rank:
                src.append(dev[:len(host)])
                dst.append(host)
        if src:
            swap_pages(self.kv_cache, self.cpu_cache, np.concatenate(src),
                       np.concatenate(dst), self.engine_config.block_size)

    def swap_in_seqs(self, requests: list[Request]):
        """Restore swapped-out sequences into fresh device pages (allocated
        here, by the primary's block managers, and sent in the payload) and
        free their host pages (a later swap-out that reuses them is queued
        after this copy on the same stream)."""
        if not requests:
            return
        payload = self._encode_swap_payload(
            [(r.dp_group, r.seq_id, r.num_cached_tokens,
              self.hbm_block_mgrs[r.dp_group].allocate_fresh_for_seq(
                  r.seq_id, r.num_cached_tokens))
             for r in requests])
        distributed.broadcast_swap(distributed.OP_SWAP_IN, payload)
        self.apply_swap_in(payload)

    def apply_swap_in(self, payload: np.ndarray):
        """Every rank: move the pages of this rank's dp group back into the
        cache in one launch, and free every sequence's host pages."""
        src, dst = [], []
        for g, seq_id, _, dev in self._decode_swap_payload(payload):
            key = self._cpu_key(g, seq_id)
            if g == self.mesh.dp_rank:
                src.append(self.cpu_block_mgr.seq_block_ids(key).copy())
                dst.append(dev)
            self.cpu_block_mgr.free_seq(key)
        if src:
            swap_pages(self.cpu_cache, self.kv_cache, np.concatenate(src),
                       np.concatenate(dst), self.engine_config.block_size)

    def free_swap_resources(self, requests: list[Request]):
        """Release the host pages of requests that died while swapped out
        (on every rank)."""
        if self.cpu_block_mgr is None or not requests:
            return
        payload = self._encode_swap_payload(
            [(r.dp_group, r.seq_id, 0, ()) for r in requests])
        distributed.broadcast_swap(distributed.OP_SWAP_FREE, payload)
        self.apply_swap_free(payload)

    def apply_swap_free(self, payload: np.ndarray):
        for g, seq_id, _, _ in self._decode_swap_payload(payload):
            self.cpu_block_mgr.free_seq(self._cpu_key(g, seq_id))

    def free_seqs_resources(self, requests: list[Request]):
        """Release all pages of finished sequences."""
        for r in requests:
            self.hbm_block_mgrs[r.dp_group].free_seq(r.seq_id)

    def match_prefix(self, request: Request) -> int:
        """Automatic prefix caching: install cached full prompt pages into the
        newly admitted request's page list and mark those tokens cached.
        The scheduler calls it at admission (after seq_id and dp_group are
        assigned, before the step batch is built)."""
        matched = self.hbm_block_mgrs[request.dp_group].match_prefix(
            request.seq_id, request.prompt_token_ids,
            namespace=request.lora_slot)
        if matched:
            request.num_cached_tokens = matched
        return matched
