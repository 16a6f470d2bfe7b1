"""LlamaModel — the data-plane worker of the PyTorch port.

A port of ``swiftllm_tpu/worker/model.py`` at tp = dp = 1:
``load_weights`` / ``profile_num_blocks`` / ``init_kvcache_and_swap`` /
``forward_async`` / ``execute_packed`` / ``forward`` /
``free_seqs_resources`` / ``match_prefix``, with the same host guard on the
decode kernel's row contract. A bucket key with ``sampling`` runs the sampler
in place of the greedy head, one with ``steps`` > 1 runs
``decode_multi_step``, one with ``spec`` > 0 (a speculative verify step) the
span head over every position of each row's span, and with
``enable_logprobs`` every step also returns its chosen tokens' logprobs.

- The model runs on ``device`` ("cuda" unless the caller asks for "cpu"), and
  raises when asked for a GPU it does not find.
- ``profile_num_blocks`` runs the worst-case bucket once on a small probe
  cache and takes its scratch from ``torch.cuda.max_memory_allocated()``
  (the JAX package reads it from the compiled program instead), then sizes
  the cache from ``torch.cuda.mem_get_info()`` and ``hbm_mem_utilization``.
- ``forward_async`` never synchronises: the batch goes up through pinned
  memory with ``non_blocking=True``, every write stays on the current
  stream (so step N+1 reads step N's tokens from the feedback buffer in
  order), and the tokens come back through a ``PendingTokens`` handle.
- Speculative decoding and prefix caching run (the scheduler drafts and
  matches; the model verifies spans and installs matched pages). Swap with a
  host pool, LoRA and tp/dp > 1 are refused in ``__init__`` with
  ``NotImplementedError`` naming the ``ROADMAP.md`` item that brings them.
  With ``preemption_mode="recompute"`` the scheduler never swaps, so no host
  swap pool is allocated.
"""

from __future__ import annotations

import numpy as np
import torch

from swiftllm_tpu_torch.config import EngineConfig, LlamaModelConfig
from swiftllm_tpu_torch.models.llama import (FP8_SCALE_LANES,
                                             decode_multi_step, forward_shard,
                                             unpack_step_batch)
from swiftllm_tpu_torch.server.scheduler import ScheduledSeq
from swiftllm_tpu_torch.server.structs import RawRequest, Request
from swiftllm_tpu_torch.utils import GB, cdiv
from swiftllm_tpu_torch.worker.batch_builder import (build_step_batch,
                                                     pack_step_batch)
from swiftllm_tpu_torch.worker.block_manager import BlockManager


def _refuse_unsupported(ec: EngineConfig, mc: LlamaModelConfig) -> None:
    """Raise for every configuration this slice of the port does not run."""
    refused = [
        (ec.preemption_mode == "swap" and ec.num_cpu_blocks > 0,
         "preemption_mode='swap' with num_cpu_blocks > 0", "2 (swap)"),
        (bool(ec.lora_paths), "LoRA adapters", "8 (multi-LoRA)"),
        (ec.tp_size > 1 or ec.dp_size > 1, "tp_size/dp_size > 1",
         "9 (parallelism)"),
    ]
    for bad, what, item in refused:
        if bad:
            raise NotImplementedError(
                f"the PyTorch port does not run {what} yet: ROADMAP.md "
                f"queue 1, item {item}")


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


class PendingTokens:
    """A step's sampled tokens (or their logprobs) on their way to the host.
    On the GPU the copy into pinned host memory is queued behind the step
    (``non_blocking``) and a CUDA event marks its end; ``numpy()`` waits on
    that event only."""

    def __init__(self, tokens: torch.Tensor):
        self._event = None
        if tokens.device.type == "cuda":
            self._host = torch.empty(tokens.shape, dtype=tokens.dtype,
                                     pin_memory=True)
            self._host.copy_(tokens, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = tokens

    def is_ready(self) -> bool:
        return self._event is None or self._event.query()

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


class LlamaModel:
    def __init__(self, engine_config: EngineConfig,
                 model_config: LlamaModelConfig | None = None,
                 device: str | torch.device = "cuda"):
        self.engine_config = engine_config
        self.model_config = model_config or LlamaModelConfig.load_from_model_path(
            engine_config.model_path)
        _refuse_unsupported(engine_config, self.model_config)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("LlamaModel: no CUDA device found; pass "
                               "device='cpu' to run on the CPU")
        # f32 products in full f32 on the card (PyTorch's default, stated).
        torch.backends.cuda.matmul.allow_tf32 = False
        self.dp = 1
        self.tp = 1
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
        self.lora_slots: dict[str, int] = {}
        self.hbm_block_mgrs: list[BlockManager] = []
        self.num_blocks_per_shard = 0

    # --- init -----------------------------------------------------------------
    def load_weights(self):
        from swiftllm_tpu_torch.worker.weights import load_params
        self.params = load_params(self.engine_config, self.model_config,
                                  self.device)

    def _lanes(self) -> int:
        """Cache lane width: [K_all ‖ V_all], plus under fp8 KV one tile of
        per-token power-of-2 K/V scale lanes (models/llama.py)."""
        mc = self.model_config
        lanes = 2 * mc.num_kv_heads * mc.head_dim
        if self.engine_config.kv_quant == "fp8":
            lanes += FP8_SCALE_LANES
        return lanes

    def _cache_shape(self, num_blocks: int) -> tuple[int, int, int]:
        """[L, S, W]: S = (num_blocks + 1) * block_size (+1 garbage page),
        W = ``_lanes()``."""
        mc, cfg = self.model_config, self.engine_config
        return (mc.num_layers, (num_blocks + 1) * cfg.block_size, self._lanes())

    def _allocate(self, num_blocks: int):
        """Zeroed cache and feedback buffer, and a fresh block manager. The
        cache starts at zero so a page never read before holds no NaN."""
        cfg = self.engine_config
        self.num_blocks_per_shard = num_blocks
        self.kv_cache = torch.zeros(self._cache_shape(num_blocks),
                                    dtype=self.kv_dtype, device=self.device)
        self.token_feedback = torch.zeros(cfg.max_seqs_in_block_table + 1,
                                          dtype=torch.int32, device=self.device)
        self.hbm_block_mgrs = [BlockManager(
            "hbm0", num_blocks, cfg.block_size, cfg.max_seqs_in_block_table,
            cfg.max_blocks_per_seq,
            enable_prefix_caching=cfg.enable_prefix_caching)]

    def profile_num_blocks(self) -> int:
        """KV pages that fit the device: run the worst-case bucket once on a
        probe cache, take its scratch as the rise of
        ``max_memory_allocated``, and give the cache what is left of
        ``mem_get_info()``'s total times ``hbm_mem_utilization``. With
        quantized weights the probe's bucket (over 256 tokens) runs
        ``quant.proj``, so the scratch holds its bf16 copy of the largest
        weight (or ``lm_head`` chunk), more than the INT4 kernel's split-K
        workspace of a decode bucket needs."""
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
        reqs = []
        for i in range(n_rows):
            r = Request(RawRequest("", 1))
            r.set_prompt_token_ids([0] * chunk)
            r.seq_id = i
            reqs.append(r)
        torch.cuda.synchronize(self.device)
        torch.cuda.reset_peak_memory_stats(self.device)
        base = torch.cuda.memory_allocated(self.device)
        self.forward([ScheduledSeq(r, chunk) for r in reqs])
        scratch = torch.cuda.max_memory_allocated(self.device) - base
        self.kv_cache = self.token_feedback = None
        self.hbm_block_mgrs = []
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info(self.device)
        usable = int(total * cfg.hbm_mem_utilization) - (total - free) - scratch
        num = usable // block_bytes
        if num <= 0:
            raise RuntimeError(
                f"no device memory left for the KV cache: total={total / GB:.1f}GB "
                f"free={free / GB:.1f}GB scratch={scratch / GB:.1f}GB")
        return int(num)

    def init_kvcache_and_swap(self, num_blocks_per_shard: int | None = None):
        """Allocate the KV cache (sized by ``profile_num_blocks`` unless given)
        and the feedback buffer. No host swap pool: this slice preempts by
        recompute only."""
        if num_blocks_per_shard is None:
            num_blocks_per_shard = self.profile_num_blocks()
        self._allocate(num_blocks_per_shard)

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
        decode steps and the tokens come out [B_bucket * S], row-major."""
        if groups is None:
            groups = [scheduled]
        assert len(groups) == 1, "the port runs at dp = 1"
        batch_np, key, rows = build_step_batch(groups, self.hbm_block_mgrs,
                                               self.engine_config,
                                               multi_step=multi_step)
        if self.engine_config.use_pallas:
            _assert_decode_prefix(batch_np, key, self.dp)
        # Rows from live_rows on have no query: the attention kernels plan
        # their key splits over the rows below it (a host integer; the rows
        # bucket is pinned to max_batch_size).
        live = np.flatnonzero(np.asarray(batch_np.q_lens) > 0)
        live_rows = int(live[-1]) + 1 if live.size else 0
        out = self.execute_packed(pack_step_batch(batch_np, self.dp), key,
                                  return_logits, live_rows)
        if return_logits:
            tokens, logits = out
            return tokens, rows, logits
        return out, rows

    def execute_packed(self, flat_np: np.ndarray, key,
                       return_logits: bool = False,
                       live_rows: int | None = None):
        """Run one dispatch from a packed batch buffer: one step, or the
        ``key.steps`` chained decode steps of a multi-step window. Returns
        the tokens' ``PendingTokens`` (and the f32 logits tensor when asked,
        single steps only). With ``enable_logprobs`` the logprobs' copy to
        the host is queued too, as ``last_logprobs``. ``live_rows``: rows
        from it on have no query (None: any row may)."""
        self.last_key = key
        flat = torch.from_numpy(flat_np)
        if self.device.type == "cuda":
            flat = flat.pin_memory().to(self.device, non_blocking=True)
        cfg = self.engine_config
        batch = unpack_step_batch(flat, key.tokens, key.rows, key.pages,
                                  page_size=cfg.block_size,
                                  garbage_slot=self.kv_cache.shape[1] - cfg.block_size)
        kw = dict(cfg=self.model_config, page_size=cfg.block_size,
                  q_bucket=key.q_len, use_kernels=cfg.use_pallas,
                  use_sampler=bool(key.sampling),
                  return_logprobs=cfg.enable_logprobs, live_rows=live_rows)
        logits = lp = None
        if key.steps > 1:
            assert not return_logits, "logits come from single steps only"
            tokens, *rest = decode_multi_step(
                self.params, self.kv_cache, self.token_feedback, batch,
                multi_step=key.steps, **kw)
        else:
            tokens, logits, *rest = forward_shard(
                self.params, self.kv_cache, self.token_feedback, batch,
                return_logits=return_logits, sample_span=key.spec, **kw)
        if cfg.enable_logprobs:
            lp = PendingTokens(rest[0])
        self.last_logprobs = lp
        pending = PendingTokens(tokens)
        return (pending, logits) if return_logits else pending

    def forward(self, scheduled: list[ScheduledSeq],
                groups: list[list[ScheduledSeq]] | None = None,
                return_logits: bool = False, multi_step: int = 1):
        """Run one step synchronously. Returns (tokens i32[B_bucket], rows
        [, logits f32[B_bucket, V]]) as numpy; rows[i] is the ScheduledSeq of
        row i (None for padding). With ``multi_step`` S > 1 the tokens are
        [B_bucket * S], row-major."""
        out = self.forward_async(scheduled, groups, return_logits, multi_step)
        if return_logits:
            tokens, rows, logits = out
            return tokens.numpy(), rows, logits.cpu().numpy()
        tokens, rows = out
        return tokens.numpy(), rows

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
