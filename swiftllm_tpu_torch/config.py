"""Engine and model configuration.

Capability parity with the reference's ``swiftllm/engine_config.py:4-84`` and
``swiftllm/model_config.py:5-46``, extended with knobs for mesh shape,
static-shape bucketing, quantization and chunked prefill.

A copy of ``swiftllm_tpu/config.py`` with every field kept, so a config means
the same in both packages. In this package ``use_pallas=True`` selects the
hand-written CUDA kernels and ``False`` their plain PyTorch versions.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

from swiftllm_tpu_torch.utils import cdiv


@dataclasses.dataclass
class EngineConfig:
    """All engine knobs.

    The defaults are the JAX package's, so one config means the same in both
    packages; every knob is still a knob.
    """

    # --- model / weights ---
    model_path: str = ""
    use_dummy: bool = False            # random weights, no checkpoint (reference engine_config.py:36-40)
    dtype: str = "bfloat16"            # activations+weights compute dtype
    quant: str = "none"                # weight quantization: none | int8 | int4
    kv_quant: str = "none"             # KV-cache quantization: none | fp8.
                                       # fp8 stores per-token power-of-2 K/V
                                       # scales in a trailing lane tile of the
                                       # cache (models/llama.py fp8_scales) —
                                       # no tuning knob needed.

    # --- paged KV cache ---
    block_size: int = 16               # tokens per KV page (reference default 16)
    hbm_mem_utilization: float = 0.9   # fraction of free HBM given to the KV cache
    num_hbm_blocks: int | None = None  # explicit page-count override (skips profiling)
    num_cpu_blocks: int = 2048         # host-offload swap space, in pages
    preemption_mode: str = "swap"      # "swap" (reference parity: KV pages
                                       # offload to host) or "recompute"
                                       # (free pages, re-prefill on
                                       # re-admission; forced when
                                       # num_cpu_blocks == 0)
    max_seqs_in_block_table: int = 1024
    max_blocks_per_seq: int = 2048     # => 32Ki tokens/seq at block_size 16

    # --- batching ---
    max_batch_size: int = 128          # max sequences per step
    max_tokens_in_batch: int = 2048    # per-step flat-token budget
    prefill_chunk_size: int = 512      # SARATHI chunk; prompts longer than this are
                                       # prefilled over several steps, piggybacked on decodes
    enable_chunked_prefill: bool = True
    enable_prefix_caching: bool = False   # share identical full prompt pages
                                          # across requests (beyond-reference;
                                          # see worker/block_manager.py)

    # --- static-shape bucketing (the JAX package compiles one program per
    # bucket tuple; the port pads to the same buckets) ---
    token_buckets: tuple[int, ...] = ()      # default derived: pow2 from 16 .. max_tokens_in_batch
    page_buckets: tuple[int, ...] = ()       # default derived: pow2 from 16 .. max_blocks_per_seq

    # --- parallelism ---
    tp_size: int = 1                   # tensor-parallel mesh axis ("tp")
    dp_size: int = 1                   # data-parallel mesh axis ("dp")

    # --- serving ---
    max_output_len: int = 4096
    enable_logprobs: bool = False      # compute each sampled token's raw
                                       # log-softmax (one pmax+psum per step);
                                       # exposed per-request via the API
    eos_stop: bool = True              # stop on EOS token (reference has no EOS handling, structs.py:57)
    warmup_at_init: bool = False       # pre-compile the core step programs at
                                       # engine startup (see Engine.warmup)
    pipeline_depth: int = 8            # max dispatched steps with unresolved token
                                       # values; sized so depth*step_time covers the
                                       # device→host copy latency (EOS can overshoot
                                       # by up to this many speculative tokens)

    multi_step_decode: int = 1         # scan S pure-decode steps inside ONE
                                       # jitted program when the whole batch
                                       # is in decode stage (models/llama.py
                                       # decode_multi_step): per-dispatch
                                       # overhead (launch + H2D batch + D2H
                                       # tokens) is
                                       # paid once per S tokens. EOS inside a
                                       # span truncates at resolution (same
                                       # overshoot rule as the pipeline)

    # --- speculative decoding (prompt-lookup / n-gram drafting) ---
    enable_spec_decode: bool = False   # draft tokens by n-gram lookup in the
                                       # request's own context and verify them
                                       # in ONE multi-token step (the chunked-
                                       # prefill span machinery). Greedy
                                       # requests only; lossless (output is
                                       # bit-identical to plain decode). Spec
                                       # steps resolve synchronously (accepted
                                       # count is value-dependent), so this
                                       # trades pipeline depth for multi-token
                                       # steps — a win when drafts accept.
    spec_k: int = 4                    # max draft tokens verified per step
    spec_ngram_max: int = 3            # longest context n-gram to match
    spec_ngram_min: int = 2            # shortest n-gram worth trusting
    spec_max_rows: int = 16            # draft only while the decode batch is
                                       # at most this many rows: large-batch
                                       # decode is bandwidth-bound (weights
                                       # stream once per step regardless), so
                                       # speculation pays extra FLOPs for no
                                       # win there — and the cap pins the
                                       # spec token buckets warmup compiles
    spec_adaptive: bool = True         # acceptance-adaptive drafting: scale
                                       # each request's draft budget to its
                                       # measured acceptance; suppress
                                       # drafting (probing periodically) for
                                       # requests whose drafts keep missing —
                                       # a spec step costs a pipeline flush,
                                       # so low-acceptance text must not pay
                                       # it every step
    spec_min_acceptance: float = 0.4   # suppress below this realized rate
    spec_probe_interval: int = 32      # while suppressed, re-probe every Nth
                                       # decode opportunity (history decays at
                                       # each probe so regime changes recover)

    # --- multi-LoRA ---
    lora_paths: str = ""               # "name=/path,name2=/path2" HF-peft
                                       # adapters stacked into the step program
                                       # (worker/lora.py); "dummy:a,b[,r=K]"
                                       # generates random adapters (tests)

    # --- kernels ---
    use_pallas: bool = True            # the hand-written CUDA kernels for paged
                                       # attention and INT4 projections; False
                                       # = the plain PyTorch gather reference
                                       # and quant.proj (the name is the JAX
                                       # package's, kept so configs match)

    # --- compilation ---
    compilation_cache_dir: str = "~/.cache/swiftllm_tpu/xla"
    # Persistent XLA compilation cache of the JAX package; kept so configs
    # match. The PyTorch port compiles no step programs and ignores it.

    def __post_init__(self):
        assert self.preemption_mode in ("swap", "recompute")
        assert self.kv_quant in ("none", "fp8")
        if self.kv_quant == "fp8":
            # 8-bit cache rows tile at 32 sublanes; page-granular DMAs need
            # page offsets aligned to that tile.
            assert self.block_size % 32 == 0, \
                "kv_quant='fp8' requires block_size to be a multiple of 32"
        if not self.token_buckets:
            buckets, b = [], 16
            while b < self.max_tokens_in_batch:
                buckets.append(b)
                b *= 2
            buckets.append(self.max_tokens_in_batch)
            # A decode-only step at full batch needs one token per row, and
            # the scheduler's liveness guarantee (a full tile-padded decode
            # block plus one prefill chunk tile always fits SOME bucket)
            # needs covering even for tiny token budgets.
            from swiftllm_tpu_torch.utils import next_power_of_2, tile_q_for
            rows = next_power_of_2(self.max_batch_size)
            tile = tile_q_for(next_power_of_2(
                min(self.prefill_chunk_size, self.max_tokens_in_batch)))
            need = max(rows, cdiv(rows, tile) * tile + tile if tile > 1 else 1)
            if need > buckets[-1]:
                buckets.append(need)
            self.token_buckets = tuple(sorted(set(buckets)))
        if not self.page_buckets:
            buckets, b = [], 4
            while b < self.max_blocks_per_seq:
                buckets.append(b)
                b *= 2
            buckets.append(self.max_blocks_per_seq)
            self.page_buckets = tuple(sorted(set(buckets)))

    @property
    def max_seq_len(self) -> int:
        return self.max_blocks_per_seq * self.block_size

    @staticmethod
    def add_cli_args(parser: argparse.ArgumentParser):
        """Register every knob as a CLI flag (reference engine_config.py:25-84)."""
        for f in dataclasses.fields(EngineConfig):
            name = "--" + f.name.replace("_", "-")
            if f.type == "bool" or isinstance(f.default, bool):
                parser.add_argument(name, type=lambda s: s.lower() in ("1", "true", "yes"),
                                    default=f.default)
            elif f.name in ("token_buckets", "page_buckets"):
                continue
            elif f.name == "num_hbm_blocks":
                parser.add_argument(name, type=int, default=None)
            else:
                parser.add_argument(name, type=type(f.default), default=f.default)

    @staticmethod
    def from_cli_args(args: argparse.Namespace) -> "EngineConfig":
        names = {f.name for f in dataclasses.fields(EngineConfig)}
        return EngineConfig(**{k: v for k, v in vars(args).items() if k in names})


@dataclasses.dataclass
class LlamaModelConfig:
    """Llama-family architecture description, parsed from HF ``config.json``
    (reference model_config.py:5-46)."""

    num_layers: int
    num_q_heads: int
    num_kv_heads: int
    hidden_size: int
    head_dim: int
    ffn_inter_dim: int
    vocab_size: int
    max_position_embeddings: int
    rms_norm_eps: float
    rope_theta: float = 10000.0
    rope_scaling: dict | float | None = None
    tie_word_embeddings: bool = False
    bos_token_id: int | None = None
    eos_token_id: int | list[int] | None = None
    # Qwen2-style additive bias on the q/k/v projections (no o/mlp bias).
    qkv_bias: bool = False
    # Sliding-window attention (Mistral v0.1, Qwen2 with use_sliding_window):
    # every query attends to at most the last `sliding_window` key positions.
    # None/0 = full causal. Masking happens in the attention kernels; the KV
    # cache still pages the full context (no rolling buffer), so page usage
    # is unchanged — only the attention pattern narrows.
    sliding_window: int | None = None

    def __post_init__(self):
        assert self.num_q_heads % self.num_kv_heads == 0

    @property
    def gqa_group_size(self) -> int:
        return self.num_q_heads // self.num_kv_heads

    def kv_slot_bytes(self, itemsize: int) -> int:
        """Bytes of K+V for ONE token across ALL layers (model_config.py:36-41)."""
        return 2 * self.num_layers * self.num_kv_heads * self.head_dim * itemsize

    def block_bytes(self, block_size: int, itemsize: int) -> int:
        return self.kv_slot_bytes(itemsize) * block_size

    @staticmethod
    def from_hf_dict(cfg: dict) -> "LlamaModelConfig":
        model_type = cfg.get("model_type", "llama")
        assert model_type in ("llama", "qwen2", "mistral"), \
            f"unsupported model family {model_type!r} (llama/qwen2/mistral)"
        # Sliding window: Mistral applies it whenever set (v0.1; v0.3+ sets
        # null); Qwen2 carries the field but only honors it when
        # use_sliding_window is true (HF modeling_qwen2 semantics).
        sliding_window = cfg.get("sliding_window")
        if model_type == "qwen2" and not cfg.get("use_sliding_window", False):
            sliding_window = None
        assert cfg.get("hidden_act", "silu") == "silu"
        hidden = cfg["hidden_size"]
        n_q = cfg["num_attention_heads"]
        return LlamaModelConfig(
            num_layers=cfg["num_hidden_layers"],
            num_q_heads=n_q,
            num_kv_heads=cfg.get("num_key_value_heads", n_q),
            hidden_size=hidden,
            head_dim=cfg.get("head_dim") or hidden // n_q,
            ffn_inter_dim=cfg["intermediate_size"],
            vocab_size=cfg["vocab_size"],
            max_position_embeddings=cfg.get("max_position_embeddings", 2048),
            rms_norm_eps=cfg.get("rms_norm_eps", 1e-5),
            rope_theta=cfg.get("rope_theta", 10000.0),
            rope_scaling=cfg.get("rope_scaling"),
            tie_word_embeddings=cfg.get("tie_word_embeddings", False),
            bos_token_id=cfg.get("bos_token_id"),
            eos_token_id=cfg.get("eos_token_id"),
            # Qwen2 always carries qkv bias; llama-arch checkpoints may opt in
            # via HF's attention_bias flag.
            qkv_bias=(model_type == "qwen2"
                      or bool(cfg.get("attention_bias", False))),
            sliding_window=sliding_window,
        )

    @staticmethod
    def load_from_model_path(model_path: str) -> "LlamaModelConfig":
        with open(os.path.join(model_path, "config.json"), encoding="utf-8") as f:
            return LlamaModelConfig.from_hf_dict(json.load(f))

    def eos_token_ids(self) -> set[int]:
        if self.eos_token_id is None:
            return set()
        if isinstance(self.eos_token_id, int):
            return {self.eos_token_id}
        return set(self.eos_token_id)
