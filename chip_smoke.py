"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --compare-multi-step   # a measurement, not the smoke
    python3 chip_smoke.py --compare-graphs       # a measurement, not the smoke
    python3 chip_smoke.py --graphs               # the [graphs] phase alone
    python3 chip_smoke.py --compare-splits       # a measurement, not the smoke
    python3 chip_smoke.py --compare-prefill      # a measurement, not the smoke
    python3 chip_smoke.py --sweep-int4           # a measurement, not the smoke
    python3 chip_smoke.py --compare-int8         # a measurement, not the smoke
    python3 chip_smoke.py --sweep-int8           # a measurement, not the smoke
    python3 chip_smoke.py --groups               # [groups], [step qwen2] and
                                                 # [serve qwen2]
    python3 chip_smoke.py --sweep-swap           # a measurement, not the smoke
    python3 chip_smoke.py --compare-swap-norm    # a measurement, not the smoke
    python3 chip_smoke.py --compare-rope         # a measurement, not the smoke
    python3 chip_smoke.py --parallel             # phase 6 alone
    python3 chip_smoke.py --quant                # the weight and layer
                                                 # kernels' phases alone
    python3 chip_smoke.py --layer-ops            # the [layer_ops] phase alone

Phases (any failure exits non-zero; nothing is caught and passed over):
  0. the card's name and power limit, torch and CUDA versions;
  1. build the hand-written kernels from swiftllm_tpu_torch/ops/csrc;
  2. each kernel against its plain PyTorch version at Llama-3-8B width
     (and two cases at Llama-3.2-1B width, one of them at q bucket 4096 in
     a bucket of 128 rows), with times and bounds, and one
     planted fault (a decode row short of one page) that must fail; in
     every case with multi-token rows the span write first, folded into
     the rope kernel as the model runs it (rope_qkv or rope_qkv_fp8 with
     the step's scatter slots: the whole cache byte-equal to
     store_kv_plain, q_rot and the unscattered kv_new rows equal, two
     planted faults, a slot one row off and the rows left in kv_new with
     the cache skipped, that must fail; out-of-range slots dropped, with a
     third, a write at slot S wrapped to 0; its kernel-table row the fold
     less the kernel without slots, in turns); the
     attention kernels' variants on the same cases (an fp8 cache, a sliding
     window of 4096 and of 50, and both), each with its times and bounds,
     with two more planted faults (the V scale left out, the window off by
     one); both attention kernels at every GQA group from 1 to 8, head_dim
     64 and 128 ([groups]: every variant, 3 splits forced, the planted
     faults at group 7, group 7 timed against group 8 in turns); the INT4 dequant-matmul at the four 8B projection shapes and
     T = 1, 16, 128 and 256 and at ragged ones, against its plain version
     and its plan's split-then-merge, two launches bit-identical, timed at
     every shape and T, with two planted faults (the nibbles unpacked
     interleaved, a split left out of the merge) that must fail; the INT8
     matmul (int8_matmul, no Pallas kernel: XLA's fusion of the int8 ->
     bf16 convert into proj's dot) at the four 8B projection shapes and the
     head (128,256 x 4,096), at T = 1, 16, 128 and 256, at ragged shapes,
     at the tp = 2 shards' K (2,048 and 7,168) and with forced splits,
     against its plain version and its plan's split-then-merge, two
     launches bit-identical, no register spilled (ptxas), timed at every
     shape and T beside the proj route (dequantize, then F.linear) and
     F.linear on bf16 weights, with three planted faults (a K chunk dropped, the weights of another
     layer, a split left out of the merge) that must fail; both weight
     kernels' wide configuration (T > 256: tiles of 256 tokens, pairs of
     blocks sharing x; INT4 with quant.proj's two rounded half-products) at
     ragged shapes (T = 257, 300, 600), at the four 8B projection shapes
     (T = 300, 512, 1,024, 2,048; 4 splits forced at 512), INT8's head at
     640 rows and the tp = 2 shards at T = 512, against its plain version
     and its plan's split-then-merge, two launches bit-identical, bit-equal
     on integer inputs, timed beside the proj route, F.linear on bf16
     weights and the bound (INT8 also at T = 128 and 256 with the wide
     tile forced beside the narrow plan), with five planted faults (x
     multicast to the wrong block of the pair, the last partial token tile
     dropped, INT4's halves summed before rounding, one chunk's products
     dropped at a unit's start or end, a segment of a cut unit left out
     of the merge) that must fail, and no build whose ptxas report says
     it serialised the wide kernel's wgmmas; the layer's
     elementwise kernels (layer_ops: add_rms_norm, rope_qkv, rope_qkv_fp8,
     silu_mul, no Pallas kernel: XLA's fusions in layer_step, rope_qkv_fp8's
     with the quantizing kv_new build of an fp8 cache) at 8B width and T =
     1, 16, 128 and 2,048, at Qwen2-0.5B's (head_dim 64, q/k/v biases), at
     a tp = 2 shard's of 8B (4 kv heads of 128) and at Llama-2-7B's and
     Llama-2-13B's (32 and 40 heads of 128, two and four rope units a
     thread) at T = 1 and 128, rope_qkv bit-equal to its plain version, rope_qkv_fp8 byte-equal to
     its plain version (rope_qkv_plain, then quantize_kv_plain) on rows of
     magnitudes 1e-4 to 1e7 that reach both ends of the scale clip, a row of
     zeros, an outlier and a row whose rotated k rounds onto a scale's edge,
     the other two within one bf16 rounding, both with a cache and slots
     (-1, S, a span from mid-page) byte-equal to store_kv_plain, seven
     planted faults (eps left
     out, the residual not written back, a plus in RoPE, gate and up
     swapped, the fp8 row's K and V scale lanes swapped, its K scale taken
     before the bf16 rounding, two kv heads' rows swapped)
     that must fail, each timed beside its byte bound, its plain version and
     (add_rms_norm) F.rms_norm, the three programmatic launches
     (add_rms_norm, rope_qkv, rope_qkv_fp8) also each launch after a kernel
     of another kind; the
     decode kernel's deferred-commit (`pend`) variant on 16 rows (3 of
     them pad rows) with histories of 1 to 2,048 keys, for npend 1, 2, 4
     and 8 of a window of 8, with a sliding
     window and on the long rows, the cache byte-identical afterwards, with
     two planted faults (a history one key too long, the pending slots
     shifted by one) that must fail; the verify spans of speculative
     decoding (the span write folded into the rope kernel, then the prefill
     kernel at q bucket 8 over 12 spans of 2 to 5 tokens that start
     mid-page, beside 4 decode-kind rows) in
     bf16, fp8, window 50 and on long rows with window 4096, with a planted
     fault (the spans' first query position off by one), the split path (the
     planner's split count and one split against each other and against
     split_kv_attention_plain, as on the long decode rows of bf16 and fp8,
     and on those rows in a bucket of 128 rows planned over their 3 live
     rows), and the bf16-score variant at q bucket 8; the
     prefill kernel's bf16-score variant on the prefill and deep-chunk
     cases, against its plain version and the f32 kernel (both timed on
     each), and on the
     prefill case with its row maxima pinned at the f32 kernels' tolerance,
     which the f32 kernel must fail; the page mover of swap preemption
     (swap_pages, no TPU counterpart) at 8B width, bf16 pages of 16 and fp8
     pages of 32, scattered and consecutive page lists, out to the pinned
     host pool and back in to other device pages, byte-identical to its
     plain version with the rest of cache and pool unchanged, a planted
     fault (the destination pages one further) that must fail, and one
     round trip of 128 pages timed against the host link's byte bound
     (measured), each direction's share of the link's rate that way, the
     plain version and cudaMemcpy2DAsync per run;
  3. one whole mixed step, kernels against plain versions, 4 layers: at 8B
     width in bf16, with INT4 and with INT8 weights in buckets of 256 and
     512 tokens (every projection and the head through the weight kernel,
     no int8 weight converted; quant.proj's plain run converts every one), with
     an fp8 KV cache (rope_qkv_fp8 in place of rope_qkv, no other launch for
     the rows), and with INT4 and fp8 (every kernel run: add_rms_norm 2L + 1
     times, rope_qkv or rope_qkv_fp8 and silu_mul L times; the plain run
     none of them); at
     Mistral-7B width with its window of 4096 and rows whose histories
     exceed it; then 8 decode steps of 8 rows at
     8B width, 4 layers, as one multi-step window (fused write, and deferred
     commit) against 8 sequential single steps: tokens and caches; then one
     verify step (2 decode rows, 6 spec rows), kernels against plain, and
     against 5 sequential decode steps fed the same drafts; then prompts
     whose 1,024-token prefix match_prefix installs, their tails' logits
     against full prefills of the same prompts, with a planted fault (the
     pages of another prompt installed) that must fail; then a mixed step
     with two LoRA adapters (rank 16 on q, v, o and gate, halves of std
     0.02, written as peft files), kernels against plain versions, base
     rows bit-equal to a step without adapters, adapter rows against
     weights with the adapter merged in;
  4. the serving path, every engine serving each step from a CUDA graph
     (worker/graphs.py; each engine's graphs, replays, capture seconds and
     graph pool logged as [graphs <run>], every step a replay or a key's
     first use, the pool within the profile's budget for it, check_pool;
     every profile's launch counts held against the kernels the profiler
     saw on the device, device_launches, and PyTorch's own kernels'
     launches and share of device time logged, aten_share): first
     [graphs], the default
     EngineConfig at 8B width, 32 layers, bf16 (phase_graphs): the default
     warm-up (every step shape greedy and sampled, every plan of each
     bucket captured): its graphs, wall time, pool and the device memory
     its graphs' executables took, each against the profile's budget, a
     decode and a mixed step's replay
     against the eager step (logits; the capture's launches against the
     eager step's, and the kernels the replay ran on the device against
     the capture's), 8 requests served eagerly
     and from graphs with equal tokens, greedy and with three sampled, with
     no graph captured while serving, warmup(bucket_keys) capturing
     exactly those buckets, and two planted faults (a warm-up without its
     sampled pass must fail the zero-capture check; replays without their
     batch copied in must fail the token check); then the port's
     Engine at full width (32 layers, dummy weights), 8 concurrent
     requests, launch counts of every kernel: 8B in
     bf16, with INT4 and with INT8 weights (the weight kernels' launches
     held to 7 a layer and the head in every step, prefill buckets too;
     both profiled again on the route before the weight kernels,
     dequantize then F.linear, for the share of device time its copies
     took; the prefill step's device ms, TTFT and KV pages of each
     profile), 8B with an fp8 KV cache (which
     also serves one prompt of 16,500 tokens; rope_qkv_fp8 once a layer in
     every step, its device time a launch), and Mistral-7B-v0.1 width
     with its sliding window (prompts of 5,000 and 8,192 tokens among the
     8); then the bf16 8B engine three times more with logprobs on and
     three of the 8 requests sampled (temperature 0.8, top-k 20, seeded):
     multi_step_decode 1, 8 and 8 with SWIFTLLM_DEFER_KV=1, whose tokens
     must be equal; each engine released before the next one sizes its
     cache; last, an 8B engine with spec decode (spec_k 4) and prefix
     caching on weights whose greedy continuation is known
     (`seeded_weights(successor=True)`), warmed up (verify steps too), then
     serving with no graph captured but for the bf16-score switch's new
     keys: a 1,024-token shared prefix (shared pages
     byte-unchanged), then, with prefix matching off, the 8 prompts plain,
     with n-gram drafts and with oracle drafts under
     SWIFTLLM_TILE_BF16_SCORES=1 (every draft accepted, fewer steps); on
     these weights the next token is a function of the last one alone, so
     this engine checks paths, launches and the accept loop, not attention
     values (phase 3 checks those); then Qwen2-0.5B at full width (24
     layers, GQA group 7, head_dim 64, biases) on successor weights, from
     graphs after its warm-up, its tokens equal to an eager plain-path
     engine's; then swap preemption at the default
     EngineConfig (2,048 host pages) on a device pool too small for the 8
     requests of 1,500-token prompts, in bf16 and with an fp8 cache: every
     swapped page back byte-identical, tokens equal to a roomy engine's,
     both pools full again; then multi-LoRA: the two adapters through
     lora_paths, a mixed batch whose base requests equal an engine's
     without adapters and whose adapter requests equal one-adapter engines
     serving each alone, an unknown adapter refused, a decode step's device
     operations and time with adapters and without;
  5. /generate over HTTP through the port's build_app (the bf16 engine);
     then the api_server command line itself (--use-dummy true on
     Llama-3-8B's config.json, every other flag at its default): /generate,
     /v1/completions with logprobs and a streamed /v1/chat/completions give
     the same tokens, and the server exits 0 on SIGINT;
  6. tensor and data parallelism: ranks of this script (--rank-phase, the
     torchrun environment), all on the one card over gloo (NCCL refuses
     two ranks on one device). [tp2 step]: 8B width, 4 layers, a mixed step
     at tp = 2 in bf16, fp8 KV, INT4 and INT8, each rank's kernels against
     their plain versions at the shard's widths and every kernel launched on
     every rank, the gathered logits against tp = 1's, and a planted fault
     (the decode kernel's last KV head skipped) that every one of those
     checks must reject; [serve tp1], [serve
     tp2] (swapping, a follower replaying the swaps) and [serve dp2 tp2]
     (four ranks): 8B-width engines of 16 layers whose tokens must equal
     tp = 1's, with wall, TTFT, decode tok/s and each rank's memory; [http tp2]: the
     api_server command line at tp = 2, /generate, then SIGTERM to rank 0
     ends both ranks;
and [examples]: examples/offline_torch.py on the card at its tiny dummy
size, in a process of its own; then one {"kernels": [...]} line (every C
entry that launches a kernel, the page mover included) and, last,
{"ok": true, "device": {...}}.

With --compare-graphs it builds the kernels and runs only compare_graphs:
one full-width engine serving the same 8 requests in turns eagerly and from
CUDA graphs, single steps and windows of 8, then each under the profiler.
With --graphs it runs only the [graphs] phase. With --compare-multi-step it
builds the kernels and runs only compare_multi_step: one full-width engine decoding the same 8 requests in
turns with single steps, windows of 8 and windows of 8 with deferred commit,
without a profiler, several rounds in one process on one card. With
--compare-splits it runs only compare_splits: the verify spans and the long
decode rows (also in a bucket of 128 rows) at one split and at the
planner's choice, timed in turn. With --compare-prefill it times the prefill
kernel once on the cases of its kernel-table rows (mixed step, deep chunk
under a window, verify spans at the plan and at one split): run it from two
checkouts in turns to compare two builds on one card. With
--sweep-int4 it builds only the weight kernels and times int4_matmul at
each 8B shape and T for every token width and split count its plan chooses
from, then both formats' wide configuration at T = 512, 1,024 and 2,048 for
its plan and each forced schedule, beside the plans' models (the evidence
for int4_matmul.py's constants). With --compare-int8 it builds every
kernel (logging this checkout's build seconds) and times int8_matmul at
each 8B shape and the head, int4_matmul at each 8B shape, T = 1, 16, 128,
256 (and both at w_gate T = 512, 1,024), through the wrappers alone, so a
copy in an earlier checkout times that checkout's kernels; the narrow
configuration (T <= 256) both back to back and alone (time_alone_ms). With --sweep-int8 it
times int8_matmul at each 8B shape and T = 1, 16, 128, 256 for every token
width and split count its plan chooses from and fits the plan's model (the
evidence for int8_matmul.py's constants). With --groups it builds the
kernels and runs only [groups], [step qwen2] and [serve qwen2]. With
--sweep-swap it builds only swap_pages, runs the mover's part of phase 2,
then times 128 pages each way at several grids against cudaMemcpy2DAsync
per run and the link's rate, and round trips at those grids alone and
beside a decode-like load (the evidence for swap_pages.py's MOVER_BLOCKS).
With --compare-swap-norm it builds swap_pages and add_rms_norm and times
both through their wrappers alone (the mover's round trip each way with
the link's shares and beside the load; add_rms_norm back to back and
after a kernel): run it from two checkouts in turns. With --compare-rope
it builds the rope kernels (and the row build or the span write where a
checkout has them apart) and times them through their wrappers alone (8B
T = 1, 16, 128, 2,048 and Qwen2-0.5B T = 1, 128, back to back and after a
kernel; then the span write at 8B width on FOLD_SHAPES, bf16 and fp8, the
fold or the parent's pair rope_qkv + store_kv): run it from two checkouts
in turns.
With --parallel it builds the kernels and runs only phase 6. With
--layer-ops it builds only the layer kernels and runs only the [layer_ops]
phase. With --quant it builds the kernels and runs
only the [int4] and [int8] phases, both wide configurations, phase 3's INT8
and INT4 steps, the [layer_ops] phase (the fp8 row build is rope_qkv_fp8)
and phase 3's fp8 step.

It imports nothing of JAX. Reports too long for the console (the kernels'
ptxas report, the profiler tables) go to chiprun_out/, and so does a copy of
every line this script logs (chip_smoke.log), and the api_server's output
(api_server.log).
"""

from __future__ import annotations

import asyncio
import contextlib
import gc
import inspect
import itertools
import json
import math
import os
import re
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from swiftllm_tpu_torch.config import EngineConfig, LlamaModelConfig
from swiftllm_tpu_torch.models.llama import compute_inv_freq, rope_tables
from swiftllm_tpu_torch.ops import build
from swiftllm_tpu_torch.ops import int4_matmul as im
from swiftllm_tpu_torch.ops import int8_matmul as im8
from swiftllm_tpu_torch.ops import layer_ops as lo
from swiftllm_tpu_torch.ops import paged_attention as pa
from swiftllm_tpu_torch.ops import quantize_kv as qkv
from swiftllm_tpu_torch.ops.quantize_kv import quantize_kv_plain
from swiftllm_tpu_torch.ops.swap_pages import (page_slots, pinned_pool,
                                               swap_pages, swap_pages_plain)
from swiftllm_tpu_torch.parallel.mesh import SINGLE
from swiftllm_tpu_torch.server.api_server import build_app
from swiftllm_tpu_torch.server.engine import Engine
from swiftllm_tpu_torch.server.scheduler import ScheduledSeq
from swiftllm_tpu_torch.server.structs import RawRequest, Request
from swiftllm_tpu_torch.utils import cdiv, tile_q_for
from swiftllm_tpu_torch.worker import weights
from swiftllm_tpu_torch.worker.model import LlamaModel
from swiftllm_tpu_torch.worker.quant import (nibbles, proj, quantize_int4,
                                             quantize_int8,
                                             quantize_weight_torch)

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 tensor cores
# Kernel against plain version, both f32 inside and rounded once to bf16 at
# the end: they may land one or two bf16 ulps apart (an ulp is 2^-8 to 2^-7
# of the value), which rtol 1e-2 allows; atol 2e-3 covers outputs near 0.
# Outputs of long rows are small (median |out| about 0.03 at 2,048 keys), so
# atol must stay well below them: check_planted_fault shows that a decode
# kernel skipping one page of a long history fails at this tolerance.
ATOL, RTOL = 2e-3, 1e-2
# The INT4 kernel against its plain version: both accumulate in f32 and round
# once to bf16, so rtol 1e-2 again covers an ulp or two. Outputs are O(1)
# (median |y| about 0.8 for these inputs), so atol 1e-3 sits far below them;
# the interleaved-nibble fault must fail at this tolerance.
INT4_ATOL = 1e-3
# The INT8 kernel against its plain version: both sum in f32 (in another
# order), round to bf16, scale and round again, so the first rounding may
# land a bf16 step apart and the second add one more: two ulps, up to 2^-6
# of the value (an ulp is 2^-8 to 2^-7 of it), which rtol 2e-2 allows (the
# card showed two ulps at 0.6 on the first run of the kernel). Outputs are
# O(1) (median |y| about 0.8 for N(0, 1) inputs and N(0, 0.02) weights at
# K = 4,096), so atol 1e-3 sits far below them; a K chunk dropped (128 of
# 4,096 columns) moves outputs by about 0.2 and another layer's weights
# move all of them: both faults must fail.
INT8_ATOL, INT8_RTOL = 1e-3, 2e-2
REPS = 20
SLEEP_CYCLES = 20_000_000       # about 10 ms at the H100's clock
L2_BYTES = 50 * 2**20           # H100 L2: timed weights cycle through more
OUT_DIR = Path("chiprun_out")
# A kernel's mean device ms a launch in the bf16 serving run's profile
# (_profile, quant "none"), by entry: add_rms_norm's kernel row takes it.
STEP_LAUNCH_MS: dict = {}
DEVICE = "cuda"

SOURCE_OF = {n: f"swiftllm_tpu_torch/ops/csrc/{src}"
             for n, (src, _) in build.SOURCES.items()}
# The kernels every step of the kernel path launches: attention and the
# layer's elementwise work; with an fp8 cache rope_qkv_fp8, which builds the
# cache rows too, in place of rope_qkv.
PATH_KERNELS = pa.KERNELS + ("add_rms_norm", "rope_qkv", "silu_mul")
FP8_PATH_KERNELS = pa.KERNELS + ("add_rms_norm", "rope_qkv_fp8", "silu_mul")
REPLACES = {
    "paged_decode_attention": "swiftllm_tpu/ops/paged_attention.py:248",
    "paged_decode_attention_pend": "swiftllm_tpu/ops/paged_attention.py:297",
    "paged_prefill_attention": "swiftllm_tpu/ops/paged_attention.py:843",
    "paged_prefill_attention_bf16s": "swiftllm_tpu/ops/paged_attention.py:1163",
    "int4_matmul": "swiftllm_tpu/ops/int4_matmul.py:61",
    # No Pallas kernel: XLA's fusion of the int8 -> bf16 convert into
    # proj's dot.
    "int8_matmul": "swiftllm_tpu/worker/quant.py:112",
    # No Pallas kernel: XLA's fusions in layer_step (510) of rms_norm with
    # the residual add, of the bias adds, apply_rope and the kv_new
    # concatenation (with an fp8 cache, the quantizing kv_new build), and
    # of SiLU times up. The rope kernels also take, given a step's slots,
    # the fused span write of paged_attention.py:_tiles_kernel (942).
    "add_rms_norm": "swiftllm_tpu/models/llama.py:244",
    "rope_qkv": "swiftllm_tpu/models/llama.py:208",
    "rope_qkv_fp8": "swiftllm_tpu/models/llama.py:587",
    "silu_mul": "swiftllm_tpu/models/llama.py:619",
    # No Pallas kernel: the swap's gather and device_get.
    "swap_pages": "swiftllm_tpu/worker/model.py:397",
}
# The bf16-score variant against its plain version. Both round the scores,
# the exponent argument and P to bf16, but against different maxima (the
# kernel's running maximum moves every 32 keys, the plain version takes the
# row's), so a probability may differ by a bf16 step, 2^-8 of it near the
# maximum and more where exp2's argument is large and P small: the output,
# a P-weighted mean of V values of O(1), moves by a few 1e-3. The f32 kernel
# comes about as close, so this bound cannot tell the two apart; cases whose
# row maxima are pinned (pin_row_max) take ATOL / RTOL, which the f32
# kernel must fail. Against the f32 kernel: the JAX package's own bound for
# the variant, 3e-2.
BF16S_ATOL, BF16S_RTOL = 1e-2, 2e-2
BF16S_VS_F32 = 3e-2


def log(*a):
    """Print a line, and keep it in chiprun_out/chip_smoke.log: a console
    that shows only the end of a long output loses the first phases."""
    print(*a, flush=True)
    with open(OUT_DIR / "chip_smoke.log", "a", encoding="utf-8") as f:
        print(*a, file=f)


def time_ms(fn, reps=REPS, warmup=3) -> float:
    """Mean time of fn() on the card, from CUDA events around `reps` calls.
    A sleep kernel queued first holds the card while the host queues the
    calls, so that a call whose host side outlasts its kernel (tens of µs
    for a wrapper) does not leave the card idle inside the timed window.
    A plain version that synchronises waits the sleep out before the first
    call and is timed with its host side, as before."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def time_alone_ms(fn, reps=REPS) -> float:
    """Time that fn() adds on the card after a kernel of another kind: an
    empty kernel queued before each call, less that kernel's own time
    (timed alone, the same way). A programmatic launch (int8_matmul,
    add_rms_norm) may start before the kernel before it has completed, so
    back-to-back launches (time_ms) overlap each other. Here each call
    follows the empty kernel, as one follows a kernel of another kind in a
    step; but a programmatic call may still start once the empty kernel's
    blocks have exited, before its grid has completed, so the figure keeps
    that overlap with the kernel before, as a step does (a kernel's records in a step's profile, STEP_LAUNCH_MS,
    keep none of it)."""
    gap = lambda: torch.cuda._sleep(0)
    return time_ms(lambda: (gap(), fn()), reps) - time_ms(gap, reps)


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """Least time (ms) for the work: the larger of bytes over the HBM rate and
    bf16 operations over the tensor-core peak."""
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return (1e3 * max(tb, tf), "bytes" if tb >= tf else "operations")


# ---------------------------------------------------------------------------
# Phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------

def fp8_rows(g, n, KH, device):
    """n cache rows of N(0, 1) K and V values quantized as the model
    quantizes them (e4m3 bytes, scale lanes last), drawn from g."""
    kv = torch.randn(n, 2 * KH, generator=g, device=device)
    return quantize_kv_plain(kv[:, :KH], kv[:, KH:])


def paged_case(gen, device, *, rows, n_q, n_kv, hd, page_size, layers=2,
               q_bucket=1, fp8=False, rows_bucket=0):
    """rows: list of (q_len, seq_len). Decode rows (q_len 1) first, packed so
    flat token b is row b; multi-token spans follow, aligned to 128 tokens as
    the batch builder aligns them. Pages are a random permutation of the pool
    (scattered); the pool's last page is the garbage page, in no row. The
    step's q and kv_new are what the model's rope kernel makes of N(0, 1)
    q, k, v at the tokens' positions ("rope": those inputs; the plain
    version's q_rot and rows, which the kernel matches bit for bit): with
    fp8 the cache and kv_new are quantized rows with their scale lanes. The
    page table has rows_bucket rows when that is more than the rows' own
    power of two (the engine pins it to max_batch_size); its "live_rows" is
    then the rows' count, as the batch builder gives it, else None."""
    W = 2 * n_kv * hd
    B = max(1 << max(len(rows) - 1, 0).bit_length(), rows_bucket)
    n_pages_row = [cdiv(s, page_size) for _, s in rows]
    n_pages = sum(n_pages_row) + 4
    S = (n_pages + 1) * page_size
    Pg = max(n_pages_row)
    align = tile_q_for(q_bucket)        # the batch builder's span alignment
    q_starts, cursor = [], 0
    for i, (ql, _) in enumerate(rows):
        if ql > 1 and (i == 0 or rows[i - 1][0] == 1):
            cursor = cdiv(cursor, align) * align
        q_starts.append(cursor)
        cursor += ql if ql == 1 else cdiv(ql, align) * align
    T = max(1 << max(cursor - 1, 0).bit_length(), B)

    perm = torch.randperm(n_pages, generator=gen).tolist()
    pt = torch.zeros(B, Pg, dtype=torch.int32)
    slots = torch.full((T,), S - page_size, dtype=torch.int32)  # garbage
    q_lens = torch.zeros(B, dtype=torch.int32)
    seq_lens = torch.zeros(B, dtype=torch.int32)
    q_st = torch.full((B,), T, dtype=torch.int32)
    positions = torch.zeros(T, dtype=torch.int32)
    used = 0
    for b, (ql, sl) in enumerate(rows):
        pages = perm[used:used + n_pages_row[b]]
        used += n_pages_row[b]
        pt[b, :len(pages)] = torch.tensor(pages, dtype=torch.int32)
        q_lens[b], seq_lens[b], q_st[b] = ql, sl, q_starts[b]
        for i in range(ql):
            pos = sl - ql + i
            slots[q_starts[b] + i] = pages[pos // page_size] * page_size + pos % page_size
            positions[q_starts[b] + i] = pos
    # Decode-kind and prefill-kind q_lens, and the scatter slots: -1 (dropped)
    # for decode-kind tokens, whose write the decode kernel does itself, and
    # for pad tokens, as the model's unpack_step_batch gives them.
    n_dec = sum(1 for ql, _ in rows if ql == 1)
    scatter = torch.where(slots == S - page_size, -1, slots)
    scatter[:n_dec] = -1
    bf = dict(device=device, dtype=torch.bfloat16)
    g = torch.Generator(device=device).manual_seed(int(torch.randint(1 << 30, (1,), generator=gen)))
    inv_freq = 1.0 / 500000.0 ** (torch.arange(0, hd, 2, device=device) / hd)
    rope = (torch.randn(T, n_q * hd, generator=g, **bf),
            *(torch.randn(T, W // 2, generator=g, **bf) for _ in range(2)),
            rope_tables(positions.to(device), inv_freq, torch.bfloat16))
    if fp8:
        cache = fp8_rows(g, layers * S, W // 2, device).view(layers, S, -1)
        q, kv_new = lo.rope_qkv_fp8_plain(*rope)
    else:
        cache = torch.randn(layers, S, W, generator=g, **bf)
        q, kv_new = lo.rope_qkv_plain(*rope)
    return dict(
        q=q.view(T, n_q, hd), cache=cache, kv_new=kv_new, n_kv=n_kv, rope=rope,
        page_table=pt.to(device), kv_slots=slots.to(device),
        q_starts=q_st.to(device), q_lens=q_lens.to(device),
        seq_lens=seq_lens.to(device), rows=rows, page_size=page_size,
        sm_scale=1.0 / math.sqrt(hd), layer=layers - 1, q_bucket=q_bucket,
        live_rows=len(rows) if B > len(rows) and rows_bucket else None,
        n_dec=n_dec, dec_lens=torch.where(q_lens == 1, q_lens, 0).to(device),
        pre_lens=torch.where(q_lens > 1, q_lens, 0).to(device),
        scatter=scatter.to(device))


def _decode(case, cache, impl, window=0):
    return impl(case["q"], cache, case["kv_new"], case["page_table"],
                case["dec_lens"],
                case["seq_lens"], case["kv_slots"], case["layer"],
                n_kv=case["n_kv"], page_size=case["page_size"],
                sm_scale=case["sm_scale"], window=window)


def _store(case, cache):
    """The case's span write by its plain version (a set-up that fills the
    cache for an attention kernel)."""
    pa.store_kv_plain(cache, case["kv_new"], case["scatter"], case["layer"])


def _fold(case, cache, slots=None):
    """The case's span write as the model runs it: the rope kernel of its
    cache type on its rope inputs with the scatter slots (or `slots`),
    writing the prefill-kind rows to `cache`; returns (q_rot [T, n_q, hd],
    the rows it left in kv_new)."""
    rope = lo.rope_qkv_fp8 if case["cache"].dtype == pa.FP8 else lo.rope_qkv
    q, kv = rope(*case["rope"], cache=cache,
                 slots=case["scatter"] if slots is None else slots,
                 layer=case["layer"])
    return q.view(case["q"].shape), kv


def _prefill(case, cache, impl, window=0, **extra):
    kw = dict(n_kv=case["n_kv"], page_size=case["page_size"],
              sm_scale=case["sm_scale"], window=window, **extra)
    if impl is pa.paged_prefill_attention:
        kw["q_bucket"] = case["q_bucket"]
    return impl(case["q"], cache, case["page_table"], case["q_starts"],
                case["pre_lens"],
                case["seq_lens"], case["layer"], **kw)


def _valid_tokens(case, kind):
    toks = []
    for b, (ql, _) in enumerate(case["rows"]):
        if (ql == 1) == (kind == "decode"):
            s = int(case["q_starts"][b])
            toks += list(range(s, s + ql))
    return torch.tensor(toks, device=case["q"].device)


def _compare(got, want, atol=ATOL, rtol=RTOL):
    """(max |got - want|, median |want|, worst |got - want| over the
    tolerance atol + rtol |want|). They agree when the last is at most 1."""
    g, w = got.float(), want.float()
    d = (g - w).abs()
    ratio = (d / (atol + rtol * w.abs())).max().item()
    if not bool(torch.isfinite(g).all()):
        ratio = math.inf
    return d.max().item(), w.abs().median().item(), ratio


def _cache_equal(a, b, page_size):
    """Bit-identical caches, the garbage page (last page_size slots) excluded."""
    bits = torch.uint8 if a.element_size() == 1 else torch.int16
    return torch.equal(a[:, :-page_size].view(bits), b[:, :-page_size].view(bits))


def _visible(pos: int, window: int) -> int:
    """Keys the query at position pos sees: 0 .. pos, the last `window`."""
    return min(pos + 1, window) if window else pos + 1


def _decode_costs(case, window=0, write=True):
    """Bytes and operations the decode rows need: the visible history keys'
    rows read once (rows of the cache's own size: an fp8 row is its e4m3
    bytes and the scale lanes), kv_new read and (unless `write` is off: the
    deferred-commit variant) its slot written, q read, out written for every
    token; 4*hd operations per query head and key."""
    hd, n_q = case["q"].shape[2], case["q"].shape[1]
    row_bytes = case["kv_new"].shape[1] * case["kv_new"].element_size()
    rows = [(ql, sl) for ql, sl in case["rows"] if ql == 1]
    n = len(rows)
    keys = sum(_visible(sl - 1, window) for _, sl in rows)
    nbytes = ((keys - n) * row_bytes + (2 if write else 1) * n * row_bytes
              + 2 * (n * n_q * hd + case["q"].shape[0] * n_q * hd))
    return nbytes, 4 * n_q * hd * keys


def _prefill_costs(case, window=0):
    """As _decode_costs for the multi-token rows: the keys any query of the
    row sees read once, q read, out written; operations per visible pair."""
    hd, n_q = case["q"].shape[2], case["q"].shape[1]
    row_bytes = case["cache"].shape[2] * case["cache"].element_size()
    rows = [(ql, sl) for ql, sl in case["rows"] if ql > 1]
    keys = sum(min(sl, ql + window - 1) if window else sl for ql, sl in rows)
    nbytes = (keys * row_bytes
              + 2 * (sum(ql for ql, _ in rows) * n_q * hd
                     + case["q"].shape[0] * n_q * hd))
    flops = 4 * n_q * hd * sum(_visible(pos, window) for ql, sl in rows
                               for pos in range(sl - ql, sl))
    return nbytes, flops


def _dense_kv(case, cache, kind, window=0):
    """The rows' K and V gathered dense in bf16 ([n, n_kv, K, hd]; an fp8
    cache dequantized) with a visibility mask [n, 1, Q, K] (a band under a
    window), for the scaled_dot_product_attention yardstick."""
    hd, n_kv = case["q"].shape[2], case["n_kv"]
    S, KH = cache.shape[1], n_kv * hd
    rows = [(b, ql, sl) for b, (ql, sl) in enumerate(case["rows"])
            if (ql == 1) == (kind == "decode")]
    Kmax = max(sl for _, _, sl in rows)
    Qmax = max(ql for _, ql, _ in rows)
    n = len(rows)
    dev = case["q"].device
    k = torch.zeros(n, n_kv, Kmax, hd, device=dev, dtype=torch.bfloat16)
    v = torch.zeros_like(k)
    qd = torch.zeros(n, case["q"].shape[1], Qmax, hd, device=dev, dtype=torch.bfloat16)
    mask = torch.zeros(n, 1, Qmax, Kmax, device=dev, dtype=torch.bool)
    for i, (b, ql, sl) in enumerate(rows):
        slots = pa._row_slots(case["page_table"][b], sl, case["page_size"],
                              S // case["page_size"])
        kv = pa.dequantize_kv(
            pa.as_bytes(cache)[case["layer"], slots].view(cache.dtype), KH
        ).to(torch.bfloat16)
        k[i, :, :sl] = kv[:, :KH].reshape(sl, n_kv, hd).transpose(0, 1)
        v[i, :, :sl] = kv[:, KH:].reshape(sl, n_kv, hd).transpose(0, 1)
        s = int(case["q_starts"][b])
        qd[i, :, :ql] = case["q"][s:s + ql].transpose(0, 1)
        qpos = torch.arange(sl - ql, sl, device=dev)[:, None]
        kpos = torch.arange(Kmax, device=dev)[None, :]
        mask[i, 0, :ql] = (kpos <= qpos) & ((kpos > qpos - window) if window else True)
        mask[i, 0, ql:, 0] = True   # pad queries see key 0: no all-masked rows
    return qd, k, v, mask


def _bytes_equal(a, b) -> bool:
    """Two tensors' bytes equal (of any dtype, fp8 included)."""
    return torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def check_fold(case, c_k, c_p, name):
    """The span write folded into the rope kernel: the case's rope inputs
    through the kernel with the scatter slots on `c_k` and the plain rows
    (the rope kernel's plain version) through store_kv_plain on `c_p`. The
    whole cache byte-equal (no row of the garbage page or out of range
    written), q_rot bit-equal and the rows left in kv_new (the unscattered
    tokens': decode-kind and pad) byte-equal to the plain version's. The
    planted faults must fail the same checks: each prefill-kind row written
    one slot further, and each left in kv_new with the cache skipped.
    Returns (q_rot, kv_new) as the kernel left them, for the attention
    kernels that follow."""
    before = c_k.clone()
    q_k, kv_k = _fold(case, c_k)
    _store(case, c_p)
    keep = case["scatter"] < 0
    assert _bytes_equal(c_k, c_p), f"{name}: the fold's cache differs from store_kv_plain"
    assert torch.equal(q_k, case["q"]), f"{name}: the fold's q_rot differs"
    assert _bytes_equal(kv_k[keep], case["kv_new"][keep]), \
        f"{name}: the fold's unscattered kv_new rows differ"
    off = before.clone()
    shifted = torch.where(keep, -1, case["scatter"] + 1)
    pa.store_kv_plain(off, case["kv_new"], shifted, case["layer"])
    assert not _bytes_equal(c_k, off), f"{name}: a slot one row off passes"
    assert not _bytes_equal(c_k, before), \
        f"{name}: rows left in kv_new with the cache skipped pass"
    return q_k, kv_k


def check_fold_bounds(case, name):
    """Out-of-range slots (S, S + 7, -2 and 2^31 - 1 on four prefill-kind
    tokens) are dropped: their rows go to kv_new, and the whole cache is
    byte-equal to store_kv_plain's with those slots. The planted fault, a
    write at the out-of-range slot S wrapped to slot 0, must fail it."""
    S = case["cache"].shape[1]
    slots = case["scatter"].clone()
    pre = (slots >= 0).nonzero().flatten()[:4]
    slots[pre] = torch.tensor([S, S + 7, -2, 2**31 - 1], dtype=torch.int32,
                              device=slots.device)
    c_k, c_p = case["cache"].clone(), case["cache"].clone()
    _, kv_k = _fold(case, c_k, slots)
    pa.store_kv_plain(c_p, case["kv_new"], slots, case["layer"])
    assert _bytes_equal(c_k, c_p), f"{name}: an out-of-range slot was written"
    assert _bytes_equal(kv_k[pre], case["kv_new"][pre]), \
        f"{name}: a dropped row is not in kv_new"
    wrapped = c_p.clone()
    pa.as_bytes(wrapped)[case["layer"], 0] = pa.as_bytes(case["kv_new"])[pre[0]]
    assert not _bytes_equal(c_k, wrapped), f"{name}: a write at slot S wrapped to 0 passes"
    log(f"[kernels] {name}: the fold drops out-of-range slots (S, S + 7, -2, "
        f"2^31 - 1: rows in kv_new, cache byte-equal); the planted fault (slot S "
        f"written at 0) rejected")


def check_kernels(case, *, name, results, window=0):
    """Run the case through kernels and plain versions; check outputs and the
    cache; time each kernel, its plain version and a library yardstick. With
    prefill-kind rows the span write runs first, folded into the rope kernel
    as the model runs it (check_fold), and the attention kernels read the
    q_rot and kv_new it left."""
    ps = case["page_size"]
    has_dec = case["n_dec"] > 0
    has_pre = any(ql > 1 for ql, _ in case["rows"])
    c_k = case["cache"].clone()
    c_p = case["cache"].clone()
    kcase = case
    if has_pre:
        q_k, kv_k = check_fold(case, c_k, c_p, name)
        kcase = dict(case, q=q_k, kv_new=kv_k)
    out = {}
    if has_dec:
        got = _decode(kcase, c_k, pa.paged_decode_attention, window)
        want = _decode(case, c_p, pa.paged_decode_attention_plain, window)
        idx = _valid_tokens(case, "decode")
        out["paged_decode_attention"] = _compare(got[idx], want[idx])
        if has_pre is False:
            assert torch.equal(got[len(idx):], torch.zeros_like(got[len(idx):]))
    if has_pre:
        got = _prefill(kcase, c_k, pa.paged_prefill_attention, window)
        want = _prefill(case, c_p, pa.paged_prefill_attention_plain, window)
        idx = _valid_tokens(case, "prefill")
        out["paged_prefill_attention"] = _compare(got[idx], want[idx])
    assert _cache_equal(c_k, c_p, ps), f"{name}: cache after the writes differs"
    for k_, (err, med, ratio) in out.items():
        log(f"[kernels] {name} {k_}: max_abs_err {err:.3g}, median |want| "
            f"{med:.3g}, worst {ratio:.3g} of the tolerance")
        assert ratio <= 1, f"{name}: {k_} disagrees with its plain version"
    log(f"[kernels] {name}: cache bit-identical after the writes (garbage "
        f"page excluded{'; the fold: whole cache byte-equal to store_kv_plain, q_rot and the unscattered kv_new rows equal, two planted faults rejected' if has_pre else ''})")
    if results is None:
        return

    sdpa = torch.nn.functional.scaled_dot_product_attention
    if has_dec:
        nbytes, flops = _decode_costs(case, window)
        qd, k, v, mask = _dense_kv(case, c_k, "decode", window)  # NOT timed
        results["paged_decode_attention"] = dict(
            max_abs_err=out["paged_decode_attention"][0],
            ms=time_ms(lambda: _decode(case, c_k, pa.paged_decode_attention, window)),
            plain_ms=time_ms(lambda: _decode(case, c_p, pa.paged_decode_attention_plain,
                                             window), reps=3),
            library_ms=time_ms(lambda: sdpa(qd, k, v, attn_mask=mask, enable_gqa=True)),
            **dict(zip(("bound_ms", "bound_by"), bound(nbytes, flops))))
    if has_pre:
        results["span write"] = span_write_row(case, c_k, c_p)
        nbytes, flops = _prefill_costs(case, window)
        qd, k, v, mask = _dense_kv(case, c_k, "prefill", window)  # NOT timed
        results["paged_prefill_attention"] = dict(
            max_abs_err=out["paged_prefill_attention"][0],
            ms=time_ms(lambda: _prefill(case, c_k, pa.paged_prefill_attention, window)),
            plain_ms=time_ms(lambda: _prefill(case, c_p, pa.paged_prefill_attention_plain,
                                              window), reps=3),
            library_ms=time_ms(lambda: sdpa(qd, k, v, attn_mask=mask, enable_gqa=True)),
            **dict(zip(("bound_ms", "bound_by"), bound(nbytes, flops))))
    log("[time] library_ms: scaled_dot_product_attention on K/V gathered "
        "dense (and dequantized) beforehand, outside the timed region, with "
        "a band mask under a window; index_copy_ of the prefill-kind rows "
        "for the span write")
    for k_, r in results.items():
        log(f"[time] {name} {k_}: " + ", ".join(
            f"{a}={b:.4f}" if isinstance(b, float) else f"{a}={b}"
            for a, b in r.items()))


def span_write_log(label: str, row: dict) -> None:
    log(f"[span write] {label}: {json.dumps(row)}")


def span_write_row(case, c_k, c_p) -> dict:
    """The kernel table's row of the span write, which has no launch of its
    own since it rides in the rope kernel: ms the rope kernel's launch with
    the scatter slots less its launch without them, on the same inputs, in
    turns (without, with, with, without); bound one write of each
    prefill-kind row; plain store_kv_plain; library index_copy_ of the
    prefill-kind rows (selected outside the timed region)."""
    rope = lo.rope_qkv_fp8 if case["cache"].dtype == pa.FP8 else lo.rope_qkv
    bare = lambda: rope(*case["rope"])                      # noqa: E731
    t = [time_ms(bare if i in (0, 3) else lambda: _fold(case, c_k)) for i in range(4)]
    n_tok = int(case["pre_lens"].sum())
    row_bytes = case["kv_new"].shape[1] * case["kv_new"].element_size()
    keep = case["scatter"] >= 0                      # selection NOT timed
    slots_l = case["scatter"][keep].long()
    rows_l = pa.as_bytes(case["kv_new"])[keep]
    lib_cache = pa.as_bytes(c_k)[case["layer"]]
    return dict(max_abs_err=0.0, ms=(t[1] + t[2] - t[0] - t[3]) / 2,
                fold_ms=(t[1] + t[2]) / 2, rope_ms=(t[0] + t[3]) / 2,
                plain_ms=time_ms(lambda: _store(case, c_p), reps=3),
                library_ms=time_ms(lambda: lib_cache.index_copy_(0, slots_l, rows_l)),
                **dict(zip(("bound_ms", "bound_by"), bound(n_tok * row_bytes, 0))))


def check_planted_fault(case):
    """The tolerance must catch a subtly wrong kernel. Run the decode kernel
    with the longest row's seq_len cut by one page, so that it skips the 16
    history keys before the new one, and require that its output for that
    row fails the comparison with the plain version on the true inputs (the
    longest decode row)."""
    b = int((case["seq_lens"] * (case["dec_lens"] > 0)).argmax())
    cut = dict(case, seq_lens=case["seq_lens"].clone())
    cut["seq_lens"][b] -= case["page_size"]
    got = _decode(cut, case["cache"].clone(), pa.paged_decode_attention)
    want = _decode(case, case["cache"].clone(), pa.paged_decode_attention_plain)
    err, med, ratio = _compare(got[b], want[b])
    log(f"[kernels] planted fault (decode row of {int(case['seq_lens'][b])} "
        f"keys, last {case['page_size']} history keys skipped): max_abs_err "
        f"{err:.3g}, median |want| {med:.3g}, worst {ratio:.3g} of the "
        f"tolerance")
    assert ratio > 1, "the tolerance lets a decode kernel skip a page"


def check_fault_v_scale(case):
    """Planted fault, fp8: the V scale left out. The plain version runs on a
    copy whose V-scale lanes (cache and kv_new) hold 1.0, so it weights the
    stored V bytes as they are; the kernel on the true bytes must fail the
    comparison with it."""
    KH = case["n_kv"] * case["q"].shape[2]
    bad = dict(case, cache=case["cache"].clone(), kv_new=case["kv_new"].clone())
    pa.as_bytes(bad["cache"])[:, :, 2 * KH + 1] = 0x38       # 1.0 in e4m3
    pa.as_bytes(bad["kv_new"])[:, 2 * KH + 1] = 0x38
    got = _decode(case, case["cache"].clone(), pa.paged_decode_attention)
    want = _decode(bad, bad["cache"], pa.paged_decode_attention_plain)
    idx = _valid_tokens(case, "decode")
    err, med, ratio = _compare(got[idx], want[idx])
    log(f"[kernels] planted fault (fp8 decode, the V scale left out): "
        f"max_abs_err {err:.3g}, median |want| {med:.3g}, worst {ratio:.3g} "
        f"of the tolerance")
    assert ratio > 1, "the tolerance lets a kernel leave the V scale out"


def check_fault_window_edge(case, window):
    """Planted fault: the window off by one (>= for >). The plain version
    with a window of window + 1 sees one key more; the kernel with `window`
    must fail the comparison with it on the rows longer than the window."""
    got = _decode(case, case["cache"].clone(), pa.paged_decode_attention, window)
    want = _decode(case, case["cache"].clone(), pa.paged_decode_attention_plain,
                   window + 1)
    idx = torch.tensor([b for b, (ql, sl) in enumerate(case["rows"])
                        if ql == 1 and sl > window], device=got.device)
    err, med, ratio = _compare(got[idx], want[idx])
    log(f"[kernels] planted fault (decode, window {window} against "
        f"{window + 1}, {len(idx)} rows longer than it): max_abs_err {err:.3g}, "
        f"median |want| {med:.3g}, worst {ratio:.3g} of the tolerance")
    assert ratio > 1, "the tolerance lets the window be off by one"


# The deferred-commit (`pend`) variant of the decode kernel: a window of
# PEND_S inner steps, as multi_step_decode = 8 gives it.
PEND_S = 8


def pend_case(gen, device, hists, npend, n_pad=0, heads=None):
    """A deferred-commit decode case at 8B width (or `heads`: n_q, n_kv,
    hd), at inner step npend - 1 of
    a window: row b has hists[b] keys in the cache (on scattered pages),
    npend - 1 completed window tokens in kv_pend[layer, :npend - 1, b] and
    the current one in kv_new[b]; the last n_pad rows of the row axis are pad
    rows. The cache slots of the window's positions hold unrelated rows (the
    window is not committed), and the pending slots from npend - 1 on hold
    stale rows of three times the magnitude."""
    case = paged_case(gen, device, rows=[(1, h + npend) for h in hists],
                      page_size=16, **(heads or dict(n_q=32, n_kv=8, hd=128)))
    L, _, W = case["cache"].shape
    B = case["page_table"].shape[0]
    assert B - len(hists) == n_pad, (B, len(hists), n_pad)
    g = torch.Generator(device=device).manual_seed(100 + npend)
    case["kv_pend"] = torch.randn(L, PEND_S, B, W, generator=g, device=device,
                                  dtype=torch.bfloat16)
    case["kv_pend"][:, npend - 1:] *= 3
    case["npend"] = npend
    return case


def _pend(case, impl, window=0, npend=None, kv_pend=None):
    return impl(case["q"], case["cache"], case["kv_new"],
                case["kv_pend"] if kv_pend is None else kv_pend,
                case["page_table"], case["dec_lens"], case["seq_lens"],
                case["layer"], npend=npend or case["npend"], n_kv=case["n_kv"],
                page_size=case["page_size"], sm_scale=case["sm_scale"],
                window=window)


def _committed(case):
    """A copy of the case's cache as a commit of the window's completed
    tokens leaves it: pending slot j of row b at position hist + j."""
    c = case["cache"].clone()
    ps, npend, layer = case["page_size"], case["npend"], case["layer"]
    pt = case["page_table"].cpu()
    for b, (_, sl) in enumerate(case["rows"]):
        for j in range(npend - 1):
            pos = sl - npend + j
            c[layer, int(pt[b, pos // ps]) * ps + pos % ps] = case["kv_pend"][layer, j, b]
    return c


def check_pend(case, *, name, window=0, results=None, smi=""):
    """The deferred-commit variant against its plain version; the cache
    byte-identical afterwards (all of it: nothing may be written); pad rows
    zero; and against the default variant on the committed cache."""
    before = case["cache"].clone()
    got = _pend(case, pa.paged_decode_attention_pend, window)
    want = _pend(case, pa.paged_decode_attention_pend_plain, window)
    torch.cuda.synchronize()
    assert torch.equal(case["cache"].view(torch.int16), before.view(torch.int16)), (
        f"{name}: the deferred-commit variant wrote the cache")
    idx = _valid_tokens(case, "decode")
    assert not got[len(idx):].any(), f"{name}: pad rows are not zero"
    err, med, ratio = _compare(got[idx], want[idx])
    c_fused = _committed(case)
    fused = _decode(case, c_fused, pa.paged_decode_attention, window)
    ferr, _, fratio = _compare(got[idx], fused[idx])
    log(f"[kernels] {name} paged_decode_attention_pend (npend {case['npend']}"
        f"): max_abs_err {err:.3g}, median |want| {med:.3g}, worst {ratio:.3g} "
        f"of the tolerance; cache byte-identical; against the default variant "
        f"on the committed cache: max_abs_err {ferr:.3g}"
        f"{' (bit-identical)' if torch.equal(got[idx], fused[idx]) else ''}")
    assert ratio <= 1, f"{name}: the pend variant disagrees with its plain version"
    assert fratio <= 1, f"{name}: the pend variant disagrees with the default one"
    if results is None:
        return
    nbytes, flops = _decode_costs(case, window, write=False)
    qd, k, v, mask = _dense_kv(case, c_fused, "decode", window)      # NOT timed
    sdpa = torch.nn.functional.scaled_dot_product_attention
    results["paged_decode_attention_pend"] = r = dict(
        max_abs_err=err,
        ms=time_ms(lambda: _pend(case, pa.paged_decode_attention_pend, window)),
        plain_ms=time_ms(lambda: _pend(case, pa.paged_decode_attention_pend_plain,
                                       window), reps=3),
        library_ms=time_ms(lambda: sdpa(qd, k, v, attn_mask=mask, enable_gqa=True)),
        **dict(zip(("bound_ms", "bound_by"), bound(nbytes, flops))))
    fused_ms = time_ms(lambda: _decode(case, c_fused, pa.paged_decode_attention, window))
    fb = bound(*_decode_costs(case, window))[0]
    log(f"[time] {name} paged_decode_attention_pend: " + ", ".join(
        f"{a}={b:.4f}" if isinstance(b, float) else f"{a}={b}" for a, b in r.items())
        + f"; the default variant (fused write) on the same rows, in turn: "
        f"{fused_ms:.4f} ms, bound {fb:.4f} ({smi})")


def check_pend_faults(case):
    """Two planted faults the tolerance must catch. A history one key too
    long: the kernel told npend - 1 reads position hist from the cache, where
    the uncommitted window left unrelated bytes, and shifts the pending
    slots. Reading pending slot npend - 1: the kernel is handed the pending
    buffer shifted by one slot, so its last read is the stale one."""
    want = _pend(case, pa.paged_decode_attention_pend_plain)
    idx = _valid_tokens(case, "decode")
    npend = case["npend"]
    for what, got in (
            ("a history one key too long",
             _pend(case, pa.paged_decode_attention_pend, npend=npend - 1)),
            (f"pending slots shifted by one, slot {npend - 1} read",
             _pend(case, pa.paged_decode_attention_pend,
                   kv_pend=case["kv_pend"].roll(-1, dims=1).contiguous()))):
        err, med, ratio = _compare(got[idx], want[idx])
        log(f"[kernels] planted fault (pend, npend {npend}: {what}): "
            f"max_abs_err {err:.3g}, median |want| {med:.3g}, worst "
            f"{ratio:.3g} of the tolerance")
        assert ratio > 1, f"the tolerance lets the pend variant pass with {what}"


def phase_pend(device, smi) -> dict:
    """The `pend` variant at 8B width: 16 rows of which the last 3 are pad
    rows, histories of 1 to 2,048 keys, npend 1, 2, S/2 and S of a window of
    S = 8 (the window of several rows crosses a page boundary), also under a
    sliding window of 50; the long rows with and without a window of 4096;
    the planted faults; and the timed case, 16 live rows at npend S/2."""
    gen = torch.Generator().manual_seed(5)
    hists = [1 + round(i * 2047 / 12) for i in range(13)]           # 1 .. 2048
    assert any(h % 16 + PEND_S > 16 for h in hists)   # a window crosses a page
    for npend in (1, 2, PEND_S // 2, PEND_S):
        case = pend_case(gen, device, hists, npend, n_pad=3)
        check_pend(case, name="pend 8B 13 rows and 3 pad rows")
        if npend == PEND_S:
            check_pend(case, name="pend window 50 8B 13 rows and 3 pad rows",
                       window=50)
        if npend == PEND_S // 2:
            check_pend_faults(case)
    for npend in (1, PEND_S):
        case = pend_case(gen, device, [20000, 16385, 1], npend, n_pad=1)
        for window in (0, 4096):
            check_pend(case, name=f"pend window {window} 8B long rows",
                       window=window)
    results = {}
    timed = pend_case(gen, device, [1 + round(i * 2047 / 15) for i in range(16)],
                      PEND_S // 2)
    check_pend(timed, name="pend 8B 16 rows", results=results, smi=smi)
    return results["paged_decode_attention_pend"]


# The verify step of speculative decoding (spec_k 4): q bucket
# next_pow2(spec_k + 1) = 8, spans of [next token] + 1 to 4 drafts.
SPEC_K = 4
SPEC_Q = 8


def verify_rows():
    """4 decode-kind rows and 12 spans of 2 to 5 tokens over histories of 1
    to 2,048 keys (every fourth history to a decode row), the spans starting
    and ending mid-page."""
    hists = [1 + round(i * 2046 / 15) for i in range(16)]      # 1 .. 2047
    rows = [(1, h) for h in hists[1::4]]
    spans = [h for i, h in enumerate(hists) if i % 4 != 1]
    rows += [(2 + j % SPEC_K, h + 2 + j % SPEC_K) for j, h in enumerate(spans)]
    assert all((sl - ql) % 16 for ql, sl in rows[4:])
    return rows


def check_fault_span_start(case):
    """Planted fault: each span's first query position off by one. The
    prefill kernel runs with seq_lens one longer than the true ones, so its
    queries sit one position late and see one key more (the slot past the
    span, which holds unrelated rows); its output must fail the comparison
    with the plain version on the true inputs."""
    c = case["cache"].clone()
    _store(case, c)
    late = dict(case, seq_lens=case["seq_lens"] + (case["pre_lens"] > 0).int())
    got = _prefill(late, c, pa.paged_prefill_attention)
    want = _prefill(case, c, pa.paged_prefill_attention_plain)
    idx = _valid_tokens(case, "prefill")
    err, med, ratio = _compare(got[idx], want[idx])
    log(f"[kernels] planted fault (verify spans, the first query position off "
        f"by one): max_abs_err {err:.3g}, median |want| {med:.3g}, worst "
        f"{ratio:.3g} of the tolerance")
    assert ratio > 1, "the tolerance lets a verify span start one position late"


def _plan(case, kind, window=0):
    """The planner's split plan for the case's decode or prefill launch (over
    the rows below its live_rows)."""
    B, Pg = case["page_table"].shape
    B = pa.split_rows(B, case["live_rows"])
    n_kv, ps = case["n_kv"], case["page_size"]
    n_sms = torch.cuda.get_device_properties(case["q"].device).multi_processor_count
    if kind == "decode":
        return pa.decode_split_plan(B, n_kv, Pg, ps, n_sms, window=window)
    return pa.prefill_split_plan(B, case["q_bucket"], case["q"].shape[1] // n_kv,
                                 n_kv, Pg, ps, n_sms, window=window,
                                 hd=case["q"].shape[2])


def _split_calls(case, kind, window=0):
    """The case's decode or prefill attention at forced split counts:
    (kernel(n, cache), the split plain version at the planner's plan, the
    case's cache with its spans stored). kernel runs at n splits (None: the
    planner's choice) on the cache it is given."""
    c = case["cache"].clone()
    if kind == "prefill":
        _store(case, c)
    kw = dict(n_kv=case["n_kv"], page_size=case["page_size"],
              sm_scale=case["sm_scale"], window=window)
    live = dict(live_rows=case["live_rows"])
    if kind == "decode":
        args = lambda cc: (case["q"], cc, case["kv_new"], case["page_table"],
                           case["dec_lens"], case["seq_lens"], case["kv_slots"],
                           case["layer"])
        kernel = lambda n, cc: pa.paged_decode_attention(*args(cc), splits=n,
                                                         **kw, **live)
        name = "paged_decode_attention"
    else:
        args = lambda cc: (case["q"], cc, case["page_table"], case["q_starts"],
                           case["pre_lens"], case["seq_lens"], case["layer"])
        kernel = lambda n, cc: pa.paged_prefill_attention(
            *args(cc), splits=n, q_bucket=case["q_bucket"], **kw, **live)
        name = "paged_prefill_attention"
    plain = lambda: pa.split_kv_attention_plain(
        name, *args(c.clone()), split=_plan(case, kind, window), **kw)
    return kernel, plain, c


def check_splits(case, kind, label, window=0):
    """The kernel's split path: the planner's choice (which must split) and
    one split against each other and against split_kv_attention_plain at the
    planner's plan, within ATOL / RTOL over the case's tokens of `kind`."""
    n_split, chunk = _plan(case, kind, window)
    assert n_split > 1, f"{label}: the planner does not split ({n_split}, {chunk})"
    kernel, plain, c = _split_calls(case, kind, window)
    idx = _valid_tokens(case, kind)
    one, planned = kernel(1, c.clone())[idx], kernel(None, c.clone())[idx]
    want = plain()[idx]
    for what, a, b in (("1 split against the plan", one, planned),
                       ("the plan against split_kv_attention_plain", planned, want),
                       ("1 split against split_kv_attention_plain", one, want)):
        err, med, ratio = _compare(a, b)
        log(f"[kernels] {label} {kind} splits ({n_split} of {chunk} keys): {what}: "
            f"max_abs_err {err:.3g}, median |want| {med:.3g}, worst {ratio:.3g} "
            f"of the tolerance")
        assert ratio <= 1, f"{label}: {what} disagree"


def phase_verify(device, smi) -> dict:
    """The unfused mode of the TPU tile kernel, as speculative verify steps
    run it at 8B width: the spans' rows written by the rope kernel (the
    span write folded in, check_fold), then paged_prefill_attention
    at q bucket 8 over spans that start and end mid-page, with the decode
    kernel on the decode-kind rows; in bf16, fp8, window 50, and on the long
    rows (20,000 and 16,385 keys) with window 4096; the planted fault; the
    split path (check_splits); the bf16-score variant at q bucket 8
    on the bf16 case, on it with its row maxima pinned
    (at ATOL / RTOL, with the control), and on the long rows without a
    window. Times the bf16 case; returns its paged_prefill_attention row."""
    gen = torch.Generator().manual_seed(6)
    w8b = dict(n_q=32, n_kv=8, hd=128, page_size=16, q_bucket=SPEC_Q)
    rows = verify_rows()
    results = {}
    case = paged_case(gen, device, rows=rows, **w8b)
    check_kernels(case, name="verify 8B 4 decode rows and 12 spans", results=results)
    check_fault_span_start(case)
    check_splits(case, "prefill", "verify 8B")
    check_bf16s(case, "verify 8B 4 decode rows and 12 spans")
    check_bf16s(pin_row_max(case, gen), "verify 8B, row maxima pinned",
                atol=ATOL, rtol=RTOL, control=True)
    long_rows = [(1, 1), (5, 20000), (3, 16385)]
    for fp8 in (False, True):
        tag = "fp8 " if fp8 else ""
        case = paged_case(gen, device, rows=rows, fp8=fp8, **w8b)
        for window in ((0, 50) if fp8 else (50,)):
            check_kernels(case, name=f"{tag}window {window} verify 8B", results=None,
                          window=window)
        case = paged_case(gen, device, rows=long_rows, fp8=fp8, **w8b)
        check_kernels(case, name=f"{tag}window 4096 verify 8B long rows",
                      results=None, window=4096)
        if not fp8:
            check_bf16s(case, "verify 8B long rows, no window")
    r = results["paged_prefill_attention"]
    log(f"[time] verify spans (q bucket {SPEC_Q}) paged_prefill_attention: "
        f"{r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ({r['bound_by']}), plain "
        f"{r['plain_ms']:.4f}, library {r['library_ms']:.4f} ({smi})")
    return r


def compare_splits(smi):
    """The split path's gain: the verify spans of phase_verify (prefill
    kernel) and the long decode rows of phase_kernels (decode kernel, bf16
    and fp8; and bf16 in a bucket of 128 rows, planned over its 3 live
    rows), each at one split and at the planner's choice, timed in turn (1,
    plan, plan, 1) on one card in one process."""
    gen = torch.Generator().manual_seed(6)
    w8b = dict(n_q=32, n_kv=8, hd=128, page_size=16)
    cases = [("verify spans (q bucket 8)", "prefill",
              paged_case(gen, "cuda", rows=verify_rows(), q_bucket=SPEC_Q, **w8b))]
    for fp8 in (False, True):
        cases.append((f"{'fp8 ' if fp8 else ''}decode long rows", "decode",
                      paged_case(gen, "cuda", rows=[(1, 20000), (1, 16385), (1, 1)],
                                 fp8=fp8, **w8b)))
    cases.append(("decode long rows in a bucket of 128 rows", "decode",
                  paged_case(gen, "cuda", rows=[(1, 20000), (1, 16385), (1, 1)],
                             rows_bucket=128, **w8b)))
    for label, kind, case in cases:
        kernel, _, c = _split_calls(case, kind)
        plan = _plan(case, kind)
        t = [time_ms(lambda: kernel(n, c)) for n in (1, None, None, 1)]
        log(f"[compare] {label}: 1 split against the plan {plan} (splits, chunk), "
            f"in turn: {t[0]:.4f}, {t[1]:.4f}, {t[2]:.4f}, {t[3]:.4f} ms ({smi})")


def compare_prefill(smi):
    """The prefill kernel's (f32 scores) time on the cases of its kernel
    table rows: the mixed step, the deep chunk under a window of 4096, and
    the verify spans at the planner's split and at one split; then the
    decode kernel on its table's 16 rows, and both on the mixed step and the
    16 rows at GQA group 8 (64 query heads over the 8 kv heads); one process
    times each once, so that two builds can be compared in turns."""
    gen = torch.Generator().manual_seed(8)
    w8b = dict(n_q=32, n_kv=8, hd=128, page_size=16)
    mixed = ([(1, 40 + 97 * i) for i in range(8)]
             + [(512, 512), (512, 1536), (300, 812)])
    cases = [("mixed step", paged_case(gen, "cuda", rows=mixed, q_bucket=512, **w8b), 0),
             ("deep chunk, window 4096",
              paged_case(gen, "cuda", rows=[(1, 9000), (512, 6000)], q_bucket=512,
                         **w8b), 4096),
             ("verify spans", paged_case(gen, "cuda", rows=verify_rows(),
                                         q_bucket=SPEC_Q, **w8b), 0)]
    out = []
    for label, case, window in cases:
        c = case["cache"].clone()
        _store(case, c)
        for splits in ((None, 1) if label == "verify spans" else (None,)):
            t = time_ms(lambda: _bf16s(case, c, False, window=window, splits=splits))
            out.append(f"{label}{'' if splits is None else ', one split'} {t:.4f}")
    seq = [1 + round(i * 2047 / 15) for i in range(16)]
    for group in (4, 8):
        w = dict(w8b, n_q=8 * group)
        dec = paged_case(gen, "cuda", rows=[(1, s) for s in seq], **w)
        cd = dec["cache"].clone()
        out.append(f"decode 16 rows, group {group} "
                   f"{time_ms(lambda: _decode(dec, cd, pa.paged_decode_attention)):.4f}")
        if group == 8:
            pre = paged_case(gen, "cuda", rows=mixed, q_bucket=512, **w)
            cp = pre["cache"].clone()
            _store(pre, cp)
            out.append(f"mixed step, group 8 {time_ms(lambda: _bf16s(pre, cp, False)):.4f}")
    log(f"[compare] prefill kernel: {'; '.join(out)} ms ({smi})")


def _bf16s(case, cache, on: bool, **extra):
    """paged_prefill_attention with SWIFTLLM_TILE_BF16_SCORES set to `on`
    (and the wrapper's keywords `extra`)."""
    old = os.environ.get("SWIFTLLM_TILE_BF16_SCORES")
    os.environ["SWIFTLLM_TILE_BF16_SCORES"] = "1" if on else "0"
    try:
        return _prefill(case, cache, pa.paged_prefill_attention, **extra)
    finally:
        if old is None:
            del os.environ["SWIFTLLM_TILE_BF16_SCORES"]
        else:
            os.environ["SWIFTLLM_TILE_BF16_SCORES"] = old


def _bf16s_plain(case, cache):
    return pa.paged_prefill_attention_plain(
        case["q"], cache, case["page_table"], case["q_starts"], case["pre_lens"],
        case["seq_lens"], case["layer"], n_kv=case["n_kv"],
        page_size=case["page_size"], sm_scale=case["sm_scale"], bf16_scores=True)


def check_bf16s(case, label, atol=BF16S_ATOL, rtol=BF16S_RTOL, control=False):
    """The bf16-score kernel on `case` (its spans stored first), launched
    once and no f32 launch, against its plain version at atol / rtol and
    against the f32 kernel within BF16S_VS_F32, over the spans' tokens. With
    `control` the f32 kernel must fail atol / rtol against the bf16-score
    plain version: the tolerance then tells the two variants apart. Returns
    (max_abs_err, the stored cache)."""
    c = case["cache"].clone()
    _store(case, c)
    build.reset_launch_counts()
    got = _bf16s(case, c, True)
    torch.cuda.synchronize()
    assert build.launch_counts["paged_prefill_attention_bf16s"] == 1, label
    assert build.launch_counts["paged_prefill_attention"] == 0, label
    f32 = _bf16s(case, c, False)
    want = _bf16s_plain(case, c)
    idx = _valid_tokens(case, "prefill")
    err, med, ratio = _compare(got[idx], want[idx], atol, rtol)
    ferr, _, fratio = _compare(got[idx], f32[idx], BF16S_VS_F32, BF16S_VS_F32)
    _, _, cratio = _compare(f32[idx], want[idx], atol, rtol)
    log(f"[kernels] {label} paged_prefill_attention_bf16s: max_abs_err "
        f"{err:.3g}, median |want| {med:.3g}, worst {ratio:.3g} of the "
        f"tolerance (atol {atol}, rtol {rtol}); against the f32 kernel "
        f"max_abs_err {ferr:.3g}, worst {fratio:.3g} of {BF16S_VS_F32}; the f32 "
        f"kernel against the bf16-score plain version: worst {cratio:.3g} of "
        f"the tolerance{' (control: must exceed 1)' if control else ''}")
    assert ratio <= 1, f"{label}: the bf16-score kernel disagrees with its plain version"
    assert fratio <= 1, f"{label}: the bf16-score kernel strays from the f32 one"
    assert not torch.equal(got, f32), "the variable changed nothing"
    if control:
        assert cratio > 1, f"{label}: the tolerance lets f32 scores pass as bf16 ones"
    return err, c


def pin_row_max(case, gen, gap=2.0):
    """The case with every query of kv head h along one direction (8 u_h
    plus N(0, 0.3) a dim) and key 0 of every row set to c u_h, c so that
    each query's raw score with key 0 tops its score with every key of the
    layer and of every span row that the span write stores by `gap` (a span that
    starts at position 0 writes key 0 itself, so its kv_new row is set
    too): the kernel's running maximum (key 0 is in its first key tile) and
    the plain version's row maximum are then the same m, and the two round
    the exponent argument against the same bf16(m)."""
    q = case["q"].float()
    cache, kv_new = case["cache"].clone(), case["kv_new"].clone()
    n_kv, hd, ps, layer = case["n_kv"], q.shape[2], case["page_size"], case["layer"]
    grp = q.shape[1] // n_kv
    g = torch.Generator(device=q.device).manual_seed(int(torch.randint(1 << 30, (1,), generator=gen)))
    slots0 = case["page_table"][:, 0].long() * ps
    at0 = torch.isin(case["scatter"].long(), slots0[case["pre_lens"] > 0])
    for h in range(n_kv):
        u = torch.randn(hd, generator=g, device=q.device)
        u = u / u.norm()
        qh = 8 * u + 0.3 * torch.randn(q.shape[0], grp, hd, generator=g, device=q.device)
        q[:, h * grp:(h + 1) * grp] = qh
        qh = qh.reshape(-1, hd).bfloat16().float()
        keys = torch.cat([cache[layer, :, h * hd:(h + 1) * hd],
                          kv_new[:, h * hd:(h + 1) * hd]]).float()
        top = (qh @ keys.T).amax(1)
        c = ((top + gap) / (qh @ u)).amax()
        cache[layer, slots0, h * hd:(h + 1) * hd] = (c * u).bfloat16()
        kv_new[at0, h * hd:(h + 1) * hd] = (c * u).bfloat16()
    return dict(case, q=q.bfloat16(), cache=cache, kv_new=kv_new, rope=None)


def phase_bf16s(device, smi) -> dict:
    """The bf16-score variant on the mixed prefill case (8 decode rows and
    chunks of 512, 512 and 300) and on a deep chunk (512 tokens after 5,488
    keys), through check_bf16s at BF16S_ATOL / BF16S_RTOL, the mixed case
    with its control; then the mixed case with its row maxima pinned
    (pin_row_max) at ATOL / RTOL, with its control; an fp8 call with the
    variable set must launch the f32 kernel. Times the mixed case beside the
    f32 kernel."""
    gen = torch.Generator().manual_seed(7)
    w8b = dict(n_q=32, n_kv=8, hd=128, page_size=16, q_bucket=512)
    mixed = ([(1, 40 + 97 * i) for i in range(8)]
             + [(512, 512), (512, 1536), (300, 812)])
    case = paged_case(gen, device, rows=mixed, **w8b)
    err, c = check_bf16s(case, "mixed 8B")
    nbytes, flops = _prefill_costs(case)
    qd, k, v, mask = _dense_kv(case, c, "prefill")          # NOT timed
    sdpa = torch.nn.functional.scaled_dot_product_attention
    f32_ms = time_ms(lambda: _bf16s(case, c, False))
    row = dict(max_abs_err=err,
               ms=time_ms(lambda: _bf16s(case, c, True)),
               plain_ms=time_ms(lambda: _bf16s_plain(case, c), reps=3),
               library_ms=time_ms(lambda: sdpa(qd, k, v, attn_mask=mask,
                                               enable_gqa=True)),
               **dict(zip(("bound_ms", "bound_by"), bound(nbytes, flops))))
    log("[time] mixed 8B paged_prefill_attention_bf16s: " + ", ".join(
        f"{a}={b:.4f}" if isinstance(b, float) else f"{a}={b}"
        for a, b in row.items()) + f"; the f32 kernel, timed just before it, "
        f"{f32_ms:.4f} ms ({smi})")
    del qd, k, v, mask, c
    deep = paged_case(gen, device, rows=[(1, 9000), (512, 6000)], **w8b)
    _, c = check_bf16s(deep, "mixed 8B deep history")
    # The deep chunk is 128 units (16 query tiles x 8 kv heads), one a block,
    # each walking about 100 key tiles: no queue or load balance in play,
    # only the work of a tile. The f32 kernel at one split, as the variant.
    f32_deep = time_ms(lambda: _bf16s(deep, c, False, splits=1))
    bf16s_deep = time_ms(lambda: _bf16s(deep, c, True))
    log(f"[time] deep chunk (128 units, one a block) paged_prefill_attention_bf16s "
        f"{bf16s_deep:.4f} ms, the f32 kernel at one split {f32_deep:.4f} ms; "
        f"the mixed case {row['ms']:.4f} against {f32_ms:.4f} ({smi})")
    del c
    check_bf16s(pin_row_max(case, gen), "mixed 8B, row maxima pinned",
                atol=ATOL, rtol=RTOL, control=True)
    # The gate: an fp8 cache keeps f32 scores whatever the variable says.
    case = paged_case(gen, device, rows=mixed, fp8=True, **w8b)
    c = case["cache"].clone()
    _store(case, c)
    build.reset_launch_counts()
    assert torch.equal(_bf16s(case, c, True), _bf16s(case, c, False))
    torch.cuda.synchronize()
    assert build.launch_counts["paged_prefill_attention_bf16s"] == 0
    log("[kernels] SWIFTLLM_TILE_BF16_SCORES=1 with an fp8 cache: the f32 "
        "kernel, byte-equal output")
    return row


LAYER_TS = (1, 16, 128, 2048)    # a decode step, a decode bucket, the serving
                                  # bucket, prefill
LAYER_TABLE = 128                  # the kernel table's row (PERF.md)
# Qwen/Qwen2-0.5B's config.json: head_dim 64, q/k/v biases.
QWEN2_05B = dict(num_q_heads=14, num_kv_heads=2, hidden_size=896, head_dim=64,
                 ffn_inter_dim=4864, vocab_size=151936,
                 max_position_embeddings=32768, rms_norm_eps=1e-6,
                 rope_theta=1000000.0, qkv_bias=True)
# The layer kernels' widths: (name, Ts). A tp = 2 rank's shard of
# Llama-3-8B holds 16 q and 4 kv heads and half the MLP. Llama-2-7B's and
# Llama-2-13B's heads (32 and 40, no GQA) give a token 1,024 and 1,280 rope
# units, past one a thread: the rope kernels' two- and four-unit builds.
LAYER_WIDTHS = (("8B", LAYER_TS),
                ("Qwen2-0.5B", (1, 128)),
                ("8B tp=2 shard", (1, 128)),
                ("Llama-2-7B", (1, 128)),
                ("Llama-2-13B", (1, 128)))
# One bf16 rounding of the output, as tests/test_torch_layer_ops.py states
# it: add_rms_norm's h (a variance summed in another order, the card's
# rsqrtf) and silu_mul (expf) may land a bf16 step (2^-8 to 2^-7 of the
# value) from their plain versions. The planted faults move outputs by
# O(1): eps left out (on rows of mean square 1e-6, where eps = 1e-5
# triples the scale), gate and up swapped.
LAYER_RTOL = 2.0 ** -7
# rope_qkv_fp8's rows: q, k and v scaled by these magnitudes in turn (dummy
# weights give K/V near 1e-4; 1e7 is past the lowest scale, where the clip
# to +-448 acts), v three times k.
FP8_MAGNITUDES = (1e-4, 1.0, 3e4, 1e7)


# meta-llama/Llama-2-7b-hf's and Llama-2-13b-hf's config.json.
LLAMA2_7B = dict(num_q_heads=32, num_kv_heads=32, hidden_size=4096, head_dim=128,
                 ffn_inter_dim=11008, vocab_size=32000,
                 max_position_embeddings=4096, rms_norm_eps=1e-5,
                 rope_theta=10000.0)
LLAMA2_13B = dict(LLAMA2_7B, num_q_heads=40, num_kv_heads=40, hidden_size=5120,
                  ffn_inter_dim=13824)


def layer_widths(name: str) -> dict:
    return {"8B": LLAMA3_8B, "Qwen2-0.5B": QWEN2_05B,
            "8B tp=2 shard": dict(LLAMA3_8B, num_q_heads=16, num_kv_heads=4,
                                  ffn_inter_dim=7168),
            "Llama-2-7B": LLAMA2_7B, "Llama-2-13B": LLAMA2_13B}[name]


def layer_close(got, want) -> tuple[bool, float]:
    """(within one bf16 rounding: rtol and atol LAYER_RTOL, the atol of the
    output's largest magnitude; max |got - want|)."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    ok = bool((err <= LAYER_RTOL * (w.abs() + w.abs().max())).all())
    return ok, err.max().item()


def rope_plus_fault(q, k, v, tables, bias=None):
    """The planted fault: RoPE with sin negated (x1*cos + x2*sin in place
    of the minus, and the second half's plus a minus)."""
    cos, sin = tables
    return lo.rope_qkv_plain(q, k, v, (cos, -sin), bias)


def layer_inputs(gen, mc, T, device):
    """One layer's elementwise inputs at mc's widths (bf16): a residual
    stream x and a branch output r whose rows' mean squares run from 1e-6
    (the first row: eps acts) to 1, norm weights 1 + N(0, 0.1); q, k, v N(0,
    1), the tables of T positions drawn in [1, max_position_embeddings), biases
    N(0, 0.5) when mc has them; gate N(0, 2), up N(0, 1)."""
    D, inter, hd = mc.hidden_size, mc.ffn_inter_dim, mc.head_dim
    QH, KH = mc.num_q_heads * hd, mc.num_kv_heads * hd

    def n(*shape, std=1.0):
        return torch.randn(*shape, generator=gen, device=device) * std
    mag = 10.0 ** -((torch.arange(T, device=device) + 3) % 4)[:, None]
    bf = torch.bfloat16
    pos = torch.randint(1, mc.max_position_embeddings, (T,), generator=gen,
                        device=device)
    inv_freq = torch.from_numpy(compute_inv_freq(mc)).to(device)
    return dict(
        x=(n(T, D) * mag).to(bf), r=(n(T, D) * mag).to(bf),
        w=(1 + n(D, std=0.1)).to(bf),
        q=n(T, QH).to(bf), k=n(T, KH).to(bf), v=n(T, KH).to(bf),
        tables=rope_tables(pos, inv_freq, bf),
        bias=(tuple(n(m, std=0.5).to(bf) for m in (QH, KH, KH))
              if mc.qkv_bias else None),
        gate=n(T, inter, std=2.0).to(bf), up=n(T, inter).to(bf))


TRAP_ROW = 3     # fp8_inputs' row whose rotated k rounds onto a scale's edge


def fp8_inputs(a: dict) -> dict:
    """rope_qkv_fp8's inputs from layer_inputs' `a`: q, k and v rows times
    FP8_MAGNITUDES in turn (the biases as drawn), and where the rows are
    there: row 1 of k and v all zero after the bias add (k = -bk, v = -bv),
    row 2 of v one outlier (1,000 times its row), and, without biases, row
    TRAP_ROW a trap for a scale taken before the bf16 rounding: its rotated
    k's absmax is x1 * cos - x2 * sin at lane 0 with cos 1, sin 0.5, x1 =
    1.75, x2 = -0.002, so 1.751 before the rounding (scale 64) and 1.75
    after it (scale 128), every other value of the row below 1e-3."""
    T = a["q"].shape[0]
    mag = torch.tensor(FP8_MAGNITUDES, device=a["q"].device).repeat(
        cdiv(T, len(FP8_MAGNITUDES)))[:T, None]
    bias = a["bias"]
    q, k, v = ((a[n].float() * mag * s).to(torch.bfloat16)
               for n, s in (("q", 1), ("k", 1), ("v", 3)))
    cos, sin = (t.clone() for t in a["tables"])
    if T > 2:
        k[1] = 0 if bias is None else -bias[1]
        v[1] = 0 if bias is None else -bias[2]
        v[2, 11] = 1000 * mag[2, 0]
    if T > TRAP_ROW and bias is None:
        half = cos.shape[-1]
        k[TRAP_ROW] = (a["k"][TRAP_ROW].float() * 1e-4).to(torch.bfloat16)
        k[TRAP_ROW, 0], k[TRAP_ROW, half] = 1.75, -0.002
        cos[TRAP_ROW, 0, 0], sin[TRAP_ROW, 0, 0] = 1.0, 0.5
    return dict(q=q, k=k, v=v, tables=(cos, sin), bias=bias)


def fp8_row_faults(q, k, v, tables, bias, n_kv: int) -> dict:
    """The planted faults of the fp8 row, each as its bytes: the K and V
    scale lanes swapped; the scales taken from the rotated k before its
    bf16 rounding (the values scaled as they should be); the first two kv
    heads' K lanes swapped."""
    _, want = lo.rope_qkv_fp8_plain(q, k, v, tables, bias)
    rows = want.view(torch.uint8)
    KH = k.shape[1]
    hd = KH // n_kv
    swapped = rows.clone()
    swapped[:, [2 * KH, 2 * KH + 1]] = rows[:, [2 * KH + 1, 2 * KH]]
    heads = rows.clone()
    heads[:, :hd], heads[:, hd:2 * hd] = rows[:, hd:2 * hd], rows[:, :hd]
    # The scale from the unrounded rotation, in f32 from the same bf16
    # products as the plain version rounds them.
    kb = k if bias is None else k + bias[1]
    vb = v if bias is None else v + bias[2]
    cos, sin = (t.float() for t in tables)
    x1, x2 = kb.view(k.shape[0], n_kv, hd).float().chunk(2, dim=-1)
    r = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    unrounded = torch.cat([r(x1 * cos) - r(x2 * sin), r(x2 * cos) + r(x1 * sin)],
                          dim=-1).reshape(k.shape[0], KH)
    _, kv = lo.rope_qkv_plain(q, k, v, tables, bias)
    sk = qkv.fp8_scales(unrounded.abs().amax(dim=1))
    sv = qkv.fp8_scales(vb.float().abs().amax(dim=1))
    stored = torch.cat([kv[:, :KH].float() * sk[:, None], kv[:, KH:].float() * sv[:, None]],
                       dim=1).clamp(-448.0, 448.0)
    lanes = stored.new_zeros(k.shape[0], pa.FP8_SCALE_LANES)
    lanes[:, 0], lanes[:, 1] = sk, sv
    early = torch.cat([stored, lanes], dim=1).to(pa.FP8).view(torch.uint8)
    return {"the K and V scale lanes swapped": swapped,
            "the K scale taken before the bf16 rounding": early,
            "two kv heads' rows swapped": heads}


def bytes_diff(got, want) -> str:
    """Where two fp8 row builds differ: how many bytes, and the first few
    (row, lane, got, want)."""
    g, w = got.view(torch.uint8), want.view(torch.uint8)
    where = (g != w).nonzero()[:6].tolist()
    return f"{int((g != w).sum())} bytes differ: " + ", ".join(
        f"({r}, {c}: {g[r, c].item():#04x} vs {w[r, c].item():#04x})"
        for r, c in where)


def check_rope_fp8(a, n_kv: int, label: str) -> str:
    """rope_qkv_fp8 against its plain version (rope_qkv_plain, then
    quantize_kv_plain) on fp8_inputs(a): q_rot bit-equal, the row byte-equal;
    where the special rows are there (T > TRAP_ROW), the planted faults
    (fp8_row_faults) must differ from the kernel's row, the K scale's on the
    trap row (without biases). Returns what it checked."""
    f = fp8_inputs(a)
    q, k, v, tables, bias = f["q"], f["k"], f["v"], f["tables"], f["bias"]
    q2, row = lo.rope_qkv_fp8(q, k, v, tables, bias)
    want_q, want = lo.rope_qkv_fp8_plain(q, k, v, tables, bias)
    assert torch.equal(q2, want_q), f"{label}: rope_qkv_fp8's q_rot differs"
    assert torch.equal(row.view(torch.uint8), want.view(torch.uint8)), \
        f"{label}: rope_qkv_fp8's row: {bytes_diff(row, want)}"
    T, KH = k.shape
    scales = want[:, 2 * KH:2 * KH + 2].float()
    clip = int((want[:, :2 * KH].float().abs() == 448).sum())
    n_faults = 0
    if T > TRAP_ROW:
        assert scales.min() == 2.0 ** -9 and clip > 0, (scales, clip)
        assert scales[1].tolist() == [256.0, 256.0], scales[1]   # the zero row
        for fault, bad in fp8_row_faults(q, k, v, tables, bias, n_kv).items():
            got = row.view(torch.uint8)
            if fault.startswith("the K scale"):
                if bias is not None:
                    continue
                assert scales[TRAP_ROW, 0] == 128.0, scales[TRAP_ROW]
                got, bad = got[TRAP_ROW], bad[TRAP_ROW]
            assert not torch.equal(got, bad), f"{label}: {fault} passes"
            n_faults += 1
    return (f"rope_qkv_fp8 byte-equal (scales {scales.min().item():g} to "
            f"{scales.max().item():g}, {clip} values at the +-448 clip; "
            f"{n_faults} planted faults rejected)")


def fold_slots(gen, T: int, page_size: int = 16, edges: bool = True) -> tuple:
    """(slots i32[T], S) for the rope kernels' cache write: a span of T
    tokens from position 5 (mid-page) on scattered pages of a pool of S
    slots; with `edges`, where there are tokens enough, token 0 decode-kind
    (-1, its row left in kv_new) and token 2 at S (out of range: dropped,
    its row left in kv_new too)."""
    n_pages = cdiv(T + 5, page_size) + 2
    pages = torch.randperm(n_pages, generator=gen, device=gen.device)
    pos = torch.arange(T, device=gen.device) + 5
    slots = (pages[pos // page_size] * page_size + pos % page_size).int()
    S = n_pages * page_size
    if edges and T > 2:
        slots[0], slots[2] = -1, S
    return slots, S


def check_rope_fold(gen, a, label) -> str:
    """rope_qkv on `a` and rope_qkv_fp8 on fp8_inputs(a), each with a cache
    of 2 layers and fold_slots' slots at layer 1, against their plain
    versions then store_kv_plain: the whole cache byte-equal, q_rot
    bit-equal, the rows left in kv_new (the unscattered tokens') byte-equal.
    Returns what it checked."""
    T, KH = a["k"].shape
    slots, S = fold_slots(gen, T)
    f = fp8_inputs(a)
    for fn, plain, args, cache in (
            (lo.rope_qkv, lo.rope_qkv_plain, (a["q"], a["k"], a["v"], a["tables"], a["bias"]),
             torch.randn(2, S, 2 * KH, generator=gen, device=gen.device).bfloat16()),
            (lo.rope_qkv_fp8, lo.rope_qkv_fp8_plain,
             (f["q"], f["k"], f["v"], f["tables"], f["bias"]),
             fp8_rows(gen, 2 * S, KH, gen.device).view(2, S, -1))):
        want_c = cache.clone()
        q2, kv = fn(*args, cache=cache, slots=slots, layer=1)
        want_q, want_kv = plain(*args)
        pa.store_kv_plain(want_c, want_kv, slots, 1)
        keep = (slots < 0) | (slots >= S)
        assert _bytes_equal(cache, want_c), f"{label}: {fn.__name__}'s cache write differs"
        assert torch.equal(q2, want_q), f"{label}: {fn.__name__} with slots: q_rot differs"
        assert _bytes_equal(kv[keep], want_kv[keep]), \
            f"{label}: {fn.__name__} with slots: the unscattered rows differ"
    return (f"with a cache ({int((~keep).sum())} of {T} rows written from position "
            f"5 on, {int(keep.sum())} left in kv_new) byte-equal to store_kv_plain")


def check_layer_ops(gen, a, eps, n_kv, label) -> tuple[dict, str]:
    """The four kernels against their plain versions on inputs `a`
    (layer_inputs): add_rms_norm with and without the residual (x' bit-equal,
    h within one rounding), rope_qkv bit-equal, rope_qkv_fp8 byte-equal on
    its own inputs (check_rope_fp8), silu_mul within one rounding; the
    planted faults (eps left out, the residual not written back, the plus
    in RoPE, gate and up swapped, and rope_qkv_fp8's) must fail the same
    checks. Returns each kernel's max |err| and what rope_qkv_fp8's check
    saw."""
    x, r, w = a["x"], a["r"], a["w"]
    h, x2 = lo.add_rms_norm(x, r, w, eps)
    want_h, want_x = lo.add_rms_norm_plain(x, r, w, eps)
    ok_h, err_h = layer_close(h, want_h)
    assert torch.equal(x2, want_x), f"{label}: add_rms_norm's residual differs"
    assert ok_h, f"{label}: add_rms_norm's h off by {err_h}"
    h0, x0 = lo.add_rms_norm(x, None, w, eps)
    ok0, err0 = layer_close(h0, lo.add_rms_norm_plain(x, None, w, eps)[0])
    assert ok0 and x0 is x, f"{label}: add_rms_norm without residual off by {err0}"
    no_eps = lo.add_rms_norm_plain(x, r, w, 0.0)[0]
    assert not layer_close(h, no_eps)[0], f"{label}: eps left out passes"
    assert not torch.equal(x, want_x), \
        f"{label}: the residual not written back passes"

    q, k, v, tables, bias = a["q"], a["k"], a["v"], a["tables"], a["bias"]
    q2, kv = lo.rope_qkv(q, k, v, tables, bias)
    want_q, want_kv = lo.rope_qkv_plain(q, k, v, tables, bias)
    assert torch.equal(q2, want_q) and torch.equal(kv, want_kv), \
        (f"{label}: rope_qkv differs, q {(q2.float() - want_q.float()).abs().max()}, "
         f"kv {(kv.float() - want_kv.float()).abs().max()}")
    fq, fkv = rope_plus_fault(q, k, v, tables, bias)
    assert not (torch.equal(q2, fq) or torch.equal(kv, fkv)), \
        f"{label}: RoPE with the plus passes"
    fp8_seen = check_rope_fp8(a, n_kv, label)
    fp8_seen += "; both " + check_rope_fold(gen, a, label)

    gate, up = a["gate"], a["up"]
    out = lo.silu_mul(gate, up)
    ok_s, err_s = layer_close(out, lo.silu_mul_plain(gate, up))
    assert ok_s, f"{label}: silu_mul off by {err_s}"
    assert not layer_close(out, lo.silu_mul_plain(up, gate))[0], \
        f"{label}: gate and up swapped passes"
    return dict(add_rms_norm=err_h, rope_qkv=0.0, rope_qkv_fp8=0.0,
                silu_mul=err_s), fp8_seen


def layer_costs(a) -> dict:
    """Bytes each kernel must move (each input read once, each output
    written once)."""
    def nb(*ts):
        return sum(t.numel() * t.element_size() for t in ts if t is not None)
    x, r, w = a["x"], a["r"], a["w"]
    q, k, v, (cos, sin), bias = a["q"], a["k"], a["v"], a["tables"], a["bias"]
    gate, up = a["gate"], a["up"]
    T, KH = k.shape
    rope_in = nb(q, k, v, cos, sin, *(bias or ()))
    return {"add_rms_norm": nb(x, r, w) + 2 * nb(x),
            "rope_qkv": rope_in + nb(q, k, v),
            "rope_qkv_fp8": rope_in + nb(q) + T * (2 * KH + pa.FP8_SCALE_LANES),
            "silu_mul": 3 * nb(gate)}


def layer_calls(a, eps) -> dict:
    """Each layer kernel's (wrapper, plain version, library call or None)
    on inputs `a`; rope_qkv_fp8's on fp8_inputs(a)."""
    x, r, w = a["x"], a["r"], a["w"]
    q, k, v, tables, bias = a["q"], a["k"], a["v"], a["tables"], a["bias"]
    f = fp8_inputs(a)
    fa = (f["q"], f["k"], f["v"], f["tables"], f["bias"])
    gate, up = a["gate"], a["up"]
    return {
        "add_rms_norm": (lambda: lo.add_rms_norm(x, r, w, eps),
                         lambda: lo.add_rms_norm_plain(x, r, w, eps),
                         lambda: F.rms_norm(x, (x.shape[1],), w, eps)),
        "rope_qkv": (lambda: lo.rope_qkv(q, k, v, tables, bias),
                     lambda: lo.rope_qkv_plain(q, k, v, tables, bias), None),
        "rope_qkv_fp8": (lambda: lo.rope_qkv_fp8(*fa),
                         lambda: lo.rope_qkv_fp8_plain(*fa), None),
        "silu_mul": (lambda: lo.silu_mul(gate, up),
                     lambda: lo.silu_mul_plain(gate, up), None)}


def phase_layer_ops(device, smi) -> dict:
    """[layer_ops]: add_rms_norm, rope_qkv, rope_qkv_fp8 and silu_mul
    against their plain versions (check_layer_ops, planted faults included)
    at Llama-3-8B width and T in LAYER_TS, at Qwen2-0.5B's (head_dim 64,
    biases), at a tp = 2 shard's of 8B (4 kv heads of 128) and at
    Llama-2-7B's and Llama-2-13B's (the rope kernels' two- and four-unit
    builds) at T = 1 and 128. Times each kernel, its plain version and, for add_rms_norm,
    F.rms_norm (the norm alone: no single PyTorch call adds the residual
    too; none computes the others) against its byte bound. add_rms_norm,
    rope_qkv and rope_qkv_fp8 launch programmatically: back to back
    (time_ms) each launch overlaps the one before, so they are also timed
    after a kernel of another kind (time_alone_ms), which they may still
    overlap; their rows' ms is replaced by their launches' mean in the
    serving runs' profiles (STEP_LAUNCH_MS), which overlaps nothing.
    Returns the kernel table's rows (8B, T = LAYER_TABLE)."""
    gen = torch.Generator(device=device).manual_seed(13)
    rows = {}
    for name, ts in LAYER_WIDTHS:
        mc = LlamaModelConfig(num_layers=1, **layer_widths(name))
        eps = mc.rms_norm_eps
        units = lo.rope_units(mc.num_q_heads, mc.num_kv_heads, mc.head_dim)
        for T in ts:
            a = layer_inputs(gen, mc, T, device)
            label = (f"{name} T={T} ({units} rope units, "
                     f"{next(u for u in (1, 2, 4) if units <= 512 * u)} a thread)")
            errs, fp8_seen = check_layer_ops(gen, a, eps, mc.num_kv_heads, label)
            nbytes = layer_costs(a)
            parts = []
            for kern, (fn, plain, lib) in layer_calls(a, eps).items():
                ms, plain_ms = time_ms(fn), time_ms(plain)
                lib_ms = time_ms(lib) if lib else None
                bound_ms, bound_by = bound(nbytes[kern], 0)
                t = f"{ms:.4f} ms"
                if kern != "silu_mul":
                    t += f" back to back, {time_alone_ms(fn):.4f} after a kernel"
                parts.append(
                    f"{kern} {t} (bound {bound_ms:.5f}, {bound_by}; "
                    f"{nbytes[kern] / 2**20:.2f} MiB; plain {plain_ms:.4f}"
                    f"{f', F.rms_norm {lib_ms:.4f}' if lib else ''}; max |err| "
                    f"{errs[kern]:.3g})")
                if name == "8B" and T == LAYER_TABLE:
                    rows[kern] = dict(max_abs_err=errs[kern], ms=ms,
                                      plain_ms=plain_ms, bound_ms=bound_ms,
                                      bound_by=bound_by, library_ms=lib_ms)
            log(f"[layer_ops] {label}: within their tolerances (rope_qkv "
                f"bit-equal, {fp8_seen}), the four planted faults rejected; "
                + "; ".join(parts) + f" ({smi})")
    return rows


def time_sampler(device, smi):
    """The heads of a step at the serving decode bucket (128 rows) and 8B's
    vocab, each timed alone: the greedy argmax, the sampler (exact top-256
    candidates, masks, the hash noise), the logprob head. On the card the
    sampler must also repeat itself: the same seeds give the same tokens."""
    from swiftllm_tpu_torch.models import sampling
    g = torch.Generator(device=device).manual_seed(21)
    B, V = 128, 128256
    logits = (torch.randn(B, V, generator=g, device=device) * 1.3
              ).to(torch.bfloat16).float()
    knobs = dict(temperature=torch.full((B,), 0.8, device=device),
                 top_p=torch.full((B,), 0.95, device=device),
                 top_k=torch.full((B,), 20, device=device, dtype=torch.int32),
                 seeds=torch.arange(B, device=device, dtype=torch.int32))
    toks = sampling.sample_tokens(logits, **knobs)
    assert torch.equal(toks, sampling.sample_tokens(logits, **knobs))
    assert bool((toks != sampling.exact_greedy(logits)).any())
    # The CPU draws the same tokens from the same logits and seeds: the
    # candidates' order is pinned and the noise is a hash.
    cpu = sampling.sample_tokens(logits.cpu(), **{k: v.cpu() for k, v in knobs.items()})
    n_same = int((cpu == toks.cpu()).sum())
    log(f"[sampler] {B} rows, vocab {V}, temperature 0.8, top-k 20, top-p "
        f"0.95: the card repeats itself; {n_same}/{B} tokens equal the CPU's "
        f"draws from the same logits and seeds")
    # (A near-tie in the nucleus or in the argmax may fall either way: the
    # softmax and the two logs are each device's own.)
    assert n_same >= B - 4, "the card's draws differ from the CPU's"
    for name, fn in (
            ("exact_greedy", lambda: sampling.exact_greedy(logits)),
            ("sample_tokens", lambda: sampling.sample_tokens(logits, **knobs)),
            ("chosen_logprobs", lambda: sampling.chosen_logprobs(logits, toks))):
        log(f"[time] {name} [{B}, {V}] f32: {time_ms(fn):.4f} ms ({smi})")


def phase_kernels(device) -> dict:
    gen = torch.Generator().manual_seed(0)
    w8b = dict(n_q=32, n_kv=8, hd=128, page_size=16)
    seq = [1 + round(i * 2047 / 15) for i in range(16)]          # 1 .. 2048
    results = {}
    dec = paged_case(gen, device, rows=[(1, s) for s in seq], **w8b)
    check_kernels(dec, name="decode 8B 16 rows", results=results)
    check_planted_fault(dec)
    # Rows past 16Ki tokens: the range where the TPU decode kernel switches
    # to its staged page table; this kernel reads the table the same way.
    long_rows = [(1, 20000), (1, 16385), (1, 1)]
    case = paged_case(gen, device, rows=long_rows, **w8b)
    check_kernels(case, name="decode 8B long rows", results=None)
    check_splits(case, "decode", "decode 8B long rows")
    # The same rows in a bucket of 128 rows (the engine's at the default
    # max_batch_size): the plan counts the 3 live rows, not the bucket.
    check_splits(paged_case(gen, device, rows=long_rows, rows_bucket=128, **w8b),
                 "decode", "decode 8B long rows in a bucket of 128")
    mixed = ([(1, 40 + 97 * i) for i in range(8)]
             + [(512, 512), (512, 1536), (300, 812)])
    mres = {}
    case = paged_case(gen, device, rows=mixed, q_bucket=512, **w8b)
    check_kernels(case, name="mixed 8B", results=mres)
    check_fold_bounds(case, "mixed 8B")
    span_write_log("mixed 8B", mres["span write"])
    results["paged_prefill_attention"] = mres["paged_prefill_attention"]

    # The variants, on the same cases: an fp8 cache, a window, and both. A
    # window of 4096 reaches past every row of the 16-row and the mixed case
    # (it must change nothing there) and skips pages of the long rows; a
    # window of 50 cuts most rows of the first two. The last case has a
    # chunk whose first query's window starts 1,393 keys into its history.
    deep = [(1, 9000), (512, 6000)]
    for fp8 in (False, True):
        tag = "fp8 " if fp8 else ""
        kw = dict(w8b, fp8=fp8)
        for rows, label, qb, windows in (
                ([(1, s) for s in seq], "decode 8B 16 rows", 1, (0, 50, 4096)),
                (long_rows, "decode 8B long rows", 1, (0, 4096)),
                (mixed, "mixed 8B", 512, (0, 50, 4096)),
                (deep, "mixed 8B deep history", 512, (4096,))):
            case = paged_case(gen, device, rows=rows, q_bucket=qb, **kw)
            for window in windows:
                if not fp8 and window == 0:
                    continue            # the default mode, checked above
                timed = not (window == 4096 and max(s for _, s in rows) <= 4096)
                res = {} if timed else None
                check_kernels(case, name=f"{tag}window {window} {label}",
                              results=res, window=window)
                if fp8 and window == 0 and label == "mixed 8B":
                    check_fold_bounds(case, "fp8 mixed 8B")
                    span_write_log("fp8 mixed 8B", res["span write"])
            if label == "decode 8B long rows" and fp8:
                check_splits(case, "decode", "fp8 decode 8B long rows")
            if label == "decode 8B 16 rows":
                if fp8:
                    check_fault_v_scale(case)
                check_fault_window_edge(case, 50)
    w1b = dict(n_q=32, n_kv=8, hd=64, page_size=16)
    check_kernels(paged_case(gen, device, q_bucket=512, rows=(
        [(1, 1), (1, 333), (1, 1000)] + [(200, 200), (77, 589)]), **w1b),
        name="mixed 1B (hd 64)", results=None)
    # A 1B engine's 4,096-token chunks at max_batch_size 128: q bucket 4096
    # (256 tiles a row at head_dim 64) over a bucket of 128 rows.
    check_kernels(paged_case(gen, device, q_bucket=4096, rows_bucket=128, rows=(
        [(1, 700), (1, 2)] + [(2048, 2048), (1024, 3072), (1000, 1000)]), **w1b),
        name="1B q bucket 4096, 128 rows", results=None)
    return results


# F2: every GQA group from 1 to 8, at head_dim 64 and 128. Decode rows
# first, then chunks (one of 77 tokens after 512 keys), at q bucket 128; the
# verify spans at q bucket SPEC_Q start and end mid-page.
GROUP_ROWS = [(1, 5), (1, 70), (1, 300), (33, 33), (20, 100), (77, 589)]
GROUP_SPANS = [(1, 40), (1, 333), (3, 22), (5, 105), (2, 260), (4, 611)]
GROUP_HISTS = [1, 30, 200, 700]          # the pend variant's cached keys


def check_forced_splits(case, kind, label, n=3):
    """The decode or prefill kernel at `n` splits forced against one split
    and against the unsplit plain version (ATOL / RTOL), over the case's
    tokens of `kind`: the partial states' layout at the case's group."""
    kernel, _, c = _split_calls(case, kind)
    idx = _valid_tokens(case, kind)
    one, forced = kernel(1, c.clone())[idx], kernel(n, c.clone())[idx]
    want = (_decode(case, c.clone(), pa.paged_decode_attention_plain) if kind == "decode"
            else _prefill(case, c.clone(), pa.paged_prefill_attention_plain))[idx]
    for what, a, b in ((f"{n} splits against 1", forced, one),
                       (f"{n} splits against the plain version", forced, want)):
        err, _, ratio = _compare(a, b)
        assert ratio <= 1, f"{label} {kind}: {what}: worst {ratio:.3g} of the tolerance"
    return err


def phase_groups(device, smi) -> None:
    """Fault F2: both attention kernels at every GQA group from 1 to 8, head
    dims 64 and 128, two kv heads (the kernels run a group under the least
    of 1, 2, 4, 8 at or above it; bands of dead rows at 3, 5, 6, 7), each
    against its plain version (ATOL / RTOL; caches bit-identical): the
    decode kernel in bf16, fp8, window 50 and fp8 with window 50, 3 splits
    forced, and its `pend` variant (npend 1 and 8, also under window 50);
    the prefill kernel on the same rows in the same variants, 3 splits
    forced, on verify spans that start and end mid-page (the span write
    folded into the rope kernel, then the kernel: the unfused mode) and in its bf16-score variant on those spans.
    At group 7 the planted faults (a decode row's last page skipped, each
    span's first query one position late) must fail. Then the decode and
    prefill kernels' times at group 7 against group 8 on the same kv heads
    (Qwen2-7B's 4 at head_dim 128, Qwen2-0.5B's 2 at 64), in turns, and at
    each of those shapes the bound, the plain version's time and
    scaled_dot_product_attention's on the same K/V gathered dense (the
    kernel table's yardstick)."""
    gen = torch.Generator().manual_seed(11)
    for hd in (64, 128):
        for group in range(1, 9):
            heads = dict(n_q=2 * group, n_kv=2, hd=hd)
            tag = f"group {group} (gmax {pa.group_bound(group)}) hd {hd}"
            for fp8 in (False, True):
                case = paged_case(gen, device, rows=GROUP_ROWS, q_bucket=128, fp8=fp8,
                                  page_size=16, **heads)
                for window in (0, 50):
                    check_kernels(case, name=f"{tag}{' fp8' if fp8 else ''} window "
                                  f"{window}", results=None, window=window)
                for kind in ("decode", "prefill"):
                    check_forced_splits(case, kind, tag)
                if group == 7 and not fp8:
                    check_planted_fault(case)
            spans = paged_case(gen, device, rows=GROUP_SPANS, q_bucket=SPEC_Q,
                               page_size=16, **heads)
            check_kernels(spans, name=f"{tag} verify spans", results=None)
            check_bf16s(spans, f"{tag} verify spans")
            if group == 7:
                check_fault_span_start(spans)
            for npend in (1, PEND_S):
                pc = pend_case(gen, device, GROUP_HISTS, npend, heads=heads)
                check_pend(pc, name=f"{tag} pend")
                if npend == PEND_S:
                    check_pend(pc, name=f"{tag} pend window 50", window=50)
            log(f"[groups] {tag}: decode and prefill kernels, every variant, "
                f"against their plain versions")
    mixed = ([(1, 40 + 97 * i) for i in range(8)]
             + [(512, 512), (512, 1536), (300, 812)])
    seq = [1 + round(i * 2047 / 15) for i in range(16)]
    for hd, n_kv in ((128, 4), (64, 2)):
        cases = {}
        for group in (8, 7):
            g = torch.Generator().manual_seed(12)
            w = dict(n_q=group * n_kv, n_kv=n_kv, hd=hd, page_size=16)
            dec = paged_case(g, device, rows=[(1, s) for s in seq], **w)
            pre = paged_case(g, device, rows=mixed, q_bucket=512, **w)
            cp = pre["cache"].clone()
            _store(pre, cp)
            cases[group] = (dec, pre, cp)
        t = {8: [], 7: []}
        for group in (8, 7, 7, 8):
            dec, pre, cp = cases[group]
            cd = dec["cache"].clone()
            t[group].append((time_ms(lambda: _decode(dec, cd, pa.paged_decode_attention)),
                             time_ms(lambda: _prefill(pre, cp, pa.paged_prefill_attention))))
        fmt = lambda g, i: " / ".join(f"{x[i]:.4f}" for x in t[g])
        log(f"[groups] time, {n_kv} kv heads of head_dim {hd}, in turns (8, 7, 7, 8): "
            f"decode (16 rows to 2,048 keys) group 8 {fmt(8, 0)} ms, group 7 "
            f"{fmt(7, 0)} ms; prefill (the mixed case: 8 decode rows, chunks of 512, "
            f"512, 300) group 8 {fmt(8, 1)} ms, group 7 {fmt(7, 1)} ms ({smi})")
        sdpa = torch.nn.functional.scaled_dot_product_attention
        parts = []
        for group in (8, 7):
            dec, pre, cp = cases[group]
            cd = dec["cache"].clone()
            for kind, case, cache, costs, plain in (
                    ("decode", dec, dec["cache"], _decode_costs,
                     lambda: _decode(dec, cd, pa.paged_decode_attention_plain)),
                    ("prefill", pre, cp, _prefill_costs,
                     lambda: _prefill(pre, cp, pa.paged_prefill_attention_plain))):
                qd, k, v, mask = _dense_kv(case, cache, kind)   # NOT timed
                lib = time_ms(lambda: sdpa(qd, k, v, attn_mask=mask, enable_gqa=True))
                b_ms, b_by = bound(*costs(case))
                parts.append(f"group {group} {kind} bound {b_ms:.4f} ms ({b_by}), "
                             f"plain {time_ms(plain, reps=3):.4f} ms, SDPA on "
                             f"gathered K/V {lib:.4f} ms")
        log(f"[groups] {n_kv} kv heads of head_dim {hd}: " + "; ".join(parts)
            + f" ({smi})")


# ---------------------------------------------------------------------------
# Phase 2, INT4: the dequant-matmul against its plain version
# ---------------------------------------------------------------------------

# (N, K) of the 8B projections: wq and wo, wk and wv, w_gate and w_up, w_down.
INT4_SHAPES = {"wq/wo": (4096, 4096), "wk/wv": (1024, 4096),
               "w_gate/w_up": (14336, 4096), "w_down": (4096, 14336)}
INT4_TABLE = ("w_gate/w_up", 128)      # the kernel table's row (PERF.md)
INT4_TS = (1, 16, 128, 256)            # the decode buckets the kernel serves


def int4_interleaved_plain(x, q4, s, layer):
    """The planted fault: the plain product with the nibbles unpacked
    INTERLEAVED (byte j -> columns 2j, 2j+1), the layout most W4A16 code
    assumes, instead of split-half."""
    lo, hi = nibbles(q4[layer])
    w = torch.stack([lo, hi], dim=-1).reshape(q4.shape[1], -1).float()
    return (x.float() @ w.T * s[layer]).to(x.dtype)


def _int4_stack(gen, N, K, L, device):
    """L layers of N(0, 0.02) weights drawn in f32 on the card and quantized
    there, one layer at a time."""
    qs = [quantize_weight_torch(torch.randn(N, K, generator=gen, device=device)
                                * 0.02, "int4") for _ in range(L)]
    return (torch.stack([q["q4"] for q in qs]), torch.stack([q["s"] for q in qs]))


def _weight_cycle(fmt, gen, N, K, device):
    """Random weight bytes (a byte a weight for "int8", two for "int4") and
    scales for timing at one shape: enough layers that a run cycling
    through them reads more weight bytes than L2 holds, as a step meets each
    layer's weights cold. Returns (q, s, layers)."""
    kb = K if fmt == "int8" else K // 2
    L = max(2, math.ceil(2 * L2_BYTES / (N * kb)))
    q = torch.randint(-127, 128, (L, N, kb), generator=gen, device=device,
                      dtype=torch.int8)
    return q, torch.rand(L, N, generator=gen, device=device) * 1e-2, L


def _int4_timings(gen, x, N, K, device):
    """Kernel, plain and library times at one shape. The kernel and the
    library call each cycle through more weight bytes than L2 holds.
    Library: F.linear on the weight dequantized to bf16 beforehand (the
    dequantization is not timed)."""
    T = x.shape[0]
    q4, s, L4 = _weight_cycle("int4", gen, N, K, device)
    it = itertools.count()
    ms = time_ms(lambda: im.int4_proj_stacked(x, q4, s, next(it) % L4))
    plain_ms = time_ms(lambda: im.int4_proj_stacked_plain(x, q4, s, next(it) % L4),
                       reps=3)
    Lb = max(2, math.ceil(2 * L2_BYTES / (N * K * 2)))
    wb = torch.stack([(torch.cat(nibbles(q4[i]), dim=-1).float()
                       * s[i][:, None]).to(torch.bfloat16) for i in range(Lb)])
    library_ms = time_ms(lambda: F.linear(x, wb[next(it) % Lb]))
    nbytes = T * K * 2 + N * K // 2 + N * 4 + T * N * 2
    host = {"int4_matmul": lambda: im.int4_proj_stacked(x, q4, s, 0),
            "F.linear": lambda: F.linear(x, wb[0])}
    host_us = {k: _host_us(f) for k, f in host.items()}
    del q4, wb
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                **dict(zip(("bound_ms", "bound_by"), bound(nbytes, 2 * T * N * K))),
                host_us=host_us)


def _host_us(fn, n=200) -> float:
    """Host time of one call (µs): n calls queued without a synchronise (the
    card's queue holds them), on the host's clock."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * t / n


def int4_dropped_split(x, q4, s, layer, plan):
    """The planted fault: split-then-merge with the second split's partial
    left out of the merge."""
    parts = im.int4_split_partials(x, q4, layer, plan)
    acc = sum(p for i, p in enumerate(parts) if i != 1)
    return (acc * s[layer].float()).to(x.dtype)


def _int4_check(x, q4, s, label):
    """int4_matmul at one shape against int4_proj_stacked_plain at layers 0
    and 3 (INT4_ATOL / RTOL), and against the plain split-then-merge of its
    own plan; a second launch must give the same bytes (a counter left
    unreset, or a merge out of split order, would not). Returns the worst
    _compare against the plain version."""
    T, K = x.shape
    plan = im.int4_plan(T, q4.shape[1], K, build.sm_count(x.device))
    errs = []
    for layer in (0, 3):
        got = im.int4_proj_stacked(x, q4, s, layer)
        again = im.int4_proj_stacked(x, q4, s, layer)
        assert torch.equal(got, again), f"int4_matmul {label}: two launches differ"
        errs.append(_compare(got, im.int4_proj_stacked_plain(x, q4, s, layer),
                             atol=INT4_ATOL))
        split = _compare(got, im.int4_proj_split_plain(x, q4, s, layer, plan),
                         atol=INT4_ATOL)
        assert max(errs[-1][2], split[2]) <= 1, (
            f"int4_matmul {label} layer {layer} disagrees: {errs[-1]}, split {split}")
    return max(errs, key=lambda e: e[2]), plan


def phase_int4(device, smi) -> dict:
    """int4_matmul against int4_proj_stacked_plain in bf16 at the 8B shapes
    and ragged ones, T in {1, 16, 128, 256} (ragged: 3, 37, 200), layers 0
    and 3 of a 4-layer stack, two launches bit-identical; the planted faults
    (interleaved nibbles, a split left out of the merge) must fail; times at
    every 8B shape and T."""
    gen = torch.Generator(device=device).manual_seed(4)
    # The card's quantizer gives quantize_int4's bytes (the CPU tests hold
    # it against the JAX package's; here, on the card, once).
    w = torch.randn(1024, 4096, generator=gen, device=device) * 0.02
    ref = quantize_int4(w.cpu().numpy())
    got = quantize_weight_torch(w, "int4")
    assert np.array_equal(got["q4"].cpu().numpy(), ref["q4"]), "q4 bytes differ"
    assert np.array_equal(got["s"].cpu().numpy(), ref["s"]), "scales differ"
    log("[int4] quantize_weight_torch on the card: the bytes and scales of "
        "quantize_int4 (1024 x 4096)")
    # Ragged edges: N off the 128-row tile, K/2 off the chunk and (for K =
    # 300) off TMA's 16-byte rows (the kernel's own copy path), T off every
    # token tile.
    for N, K in ((200, 300), (1000, 4128)):
        q4, s = _int4_stack(gen, N, K, 4, device)
        for T in (3, 37, 200):
            x = torch.randn(T, K, generator=gen, device=device).to(torch.bfloat16)
            _int4_check(x, q4, s, f"N={N} K={K} T={T}")
        log(f"[int4] ragged N {N}, K {K}: matches at T = 3, 37, 200, two "
            "launches bit-identical")
    row, table, faults = None, [], []
    for label, (N, K) in INT4_SHAPES.items():
        q4, s = _int4_stack(gen, N, K, 4, device)
        worst, plans = (0.0, 0.0, 0.0), []
        for T in INT4_TS:
            x = torch.randn(T, K, generator=gen, device=device).to(torch.bfloat16)
            err, plan = _int4_check(x, q4, s, f"{label} T={T}")
            worst = max(worst, err, key=lambda e: e[2])
            plans.append(f"T {T}: {plan.nt}x{plan.t_tiles} tokens, {plan.splits} "
                         f"splits, {plan.units} units")
            if plan.splits > 1 and len(faults) < 2 and T in (16, 128):
                ferr = _compare(im.int4_proj_stacked(x, q4, s, 3),
                                int4_dropped_split(x, q4, s, 3, plan), atol=INT4_ATOL)
                faults.append((label, T, plan.splits, ferr))
                assert ferr[2] > 1, "the tolerance lets a merge without a split pass"
            r = dict(max_abs_err=err[0], **_int4_timings(gen, x, N, K, device))
            table.append((label, T, r))
            if (label, T) == INT4_TABLE:
                row = {k: v for k, v in r.items() if k != "host_us"}
        log(f"[int4] {label} (N {N}, K {K}): matches the plain version and its "
            f"plan's split-then-merge at T = {', '.join(map(str, INT4_TS))}, "
            f"layers 0 and 3, two launches bit-identical: max_abs_err "
            f"{worst[0]:.3g}, median |want| {worst[1]:.3g}, worst {worst[2]:.3g} "
            f"of the tolerance (atol {INT4_ATOL}, rtol {RTOL}); plans: "
            + "; ".join(plans))
        if label == "w_gate/w_up":
            x = torch.randn(128, K, generator=gen, device=device).to(torch.bfloat16)
            err = _compare(im.int4_proj_stacked(x, q4, s, 3),
                           int4_interleaved_plain(x, q4, s, 3), atol=INT4_ATOL)
            log(f"[int4] planted fault (nibbles unpacked interleaved, T 128): "
                f"max_abs_err {err[0]:.3g}, median |want| {err[1]:.3g}, worst "
                f"{err[2]:.3g} of the tolerance")
            assert err[2] > 1, "the tolerance lets an interleaved unpack pass"
        del q4, s
        torch.cuda.empty_cache()
    assert len(faults) == 2, faults
    for label, T, n, err in faults:
        log(f"[int4] planted fault (the second of {n} splits left out of the "
            f"merge, {label} T {T}): max_abs_err {err[0]:.3g}, median |want| "
            f"{err[1]:.3g}, worst {err[2]:.3g} of the tolerance")
    log("[time] int4_matmul library_ms: F.linear on the weight dequantized to "
        "bf16 beforehand (not timed); kernel and library cycle through more "
        "weight bytes than L2 holds; host_us: the host's time to queue one "
        "call of the wrapper and of F.linear")
    for label, T, r in table:
        log(f"[time] int4_matmul {label} T={T}: " + ", ".join(
            f"{a}={b:.4f}" if isinstance(b, float) else f"{a}={b}"
            for a, b in r.items()) + f" ({smi})")
    return row


def wide_plan_text(p) -> str:
    """A wide plan in words: pairs, whole units, the most segments a cut
    unit has."""
    return (f"{p.grid // 2} pairs, {p.per} of {p.units} units whole, cut units "
            f"of at most {p.splits} segments")


def sweep_wide(smi):
    """The evidence behind the wide configuration's plan (both formats): its
    time at each 8B shape and T = 512, 1,024, 2,048 for its plan, the
    schedules that splits 1, 2, 4 and 8 force (every unit whole; every unit
    cut into that many pieces, stream-K) and the schedules its search weighs
    on every pair that fits (the units of every full wave whole, of one wave
    less, or none, the rest stream-K), those that differ, each beside the
    plan's model of it (int4_matmul.wide_plan_us); then the model's
    constants fitted to those times (fit_wide_model)."""
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    n_sms = build.sm_count(torch.device(DEVICE, 0))
    fit, rows = n_sms // im.CLUSTER, []
    for fmt in ("int8", "int4"):
        f = wide_fmt(fmt)
        halves = 2 if fmt == "int4" else 1
        for label, (N, K) in INT4_SHAPES.items():
            q, s, L8 = _weight_cycle(fmt, gen, N, K, DEVICE)
            for T in (512, 1024, 2048):
                x = torch.randn(T, K, generator=gen, device=DEVICE).to(torch.bfloat16)
                plans = {"plan": f["plan"](T, N, K, n_sms)}
                plans.update({f"splits {sp}": f["plan"](T, N, K, n_sms, sp)
                              for sp in (1, 2, 4, 8)})
                units = plans["plan"].units
                for whole in (units // fit * fit, max(0, units // fit - 1) * fit, 0):
                    if (units - whole) * plans["plan"].chunks >= im.WIDE_MIN_RANGE * fit:
                        plans[f"whole {whole}"] = im.make_wide_plan(T, N, K, halves, fit,
                                                                     whole)
                out, seen, it = [], set(), itertools.count()
                for name, p in plans.items():
                    if p in seen:
                        continue
                    seen.add(p)
                    t = time_ms(lambda: wide_launch(fmt, x, q, s, next(it) % L8, p))
                    rows.append((p, halves, t, name == "plan", f"{fmt} {label} T={T}"))
                    out.append(f"{name} ({wide_plan_text(p)}) {t:.4f} "
                               f"({im.wide_plan_us(p, n_sms, halves) / 1e3:.4f})")
                log(f"[sweep] {f['name']} wide {label} T={T}: " + "; ".join(out)
                    + f" ms measured (modelled) ({smi})")
            del q, s
            torch.cuda.empty_cache()
    fit_wide_model(rows, n_sms)


def fit_wide_model(rows, n_sms) -> None:
    """Fits int4_matmul.wide_plan_us's constants to the sweep's rows (plan,
    halves, measured ms, whether it is the plan's own, label) whose pairs
    all fit at once: least squares of the relative error, the plans' own
    rows weighted 3. Logs the constants (int4_matmul.py takes them from
    here) and the worst error of the plans' own rows under them, and
    leaves the module's constants as they were."""
    from scipy.optimize import least_squares
    rows = [r for r in rows if r[0].grid // im.CLUSTER <= n_sms // im.CLUSTER]
    names = ("WIDE_LAUNCH_US", "WIDE_CHUNK_US", "WIDE_UNIT_US", "WIDE_PART_US",
             "WIDE_MERGE_US")
    saved = {k: getattr(im, k) for k in names}

    def put(v):
        im.WIDE_LAUNCH_US, c1, c2, im.WIDE_UNIT_US, im.WIDE_PART_US, im.WIDE_MERGE_US = v
        im.WIDE_CHUNK_US = {1: c1, 2: c2}

    def err(r):
        return im.wide_plan_us(r[0], n_sms, r[1]) / (1e3 * r[2]) - 1
    try:
        v = least_squares(lambda v: (put(v), [(3 if r[3] else 1) * err(r) for r in rows])[1],
                          [saved["WIDE_LAUNCH_US"], saved["WIDE_CHUNK_US"][1],
                           saved["WIDE_CHUNK_US"][2], saved["WIDE_UNIT_US"],
                           saved["WIDE_PART_US"], saved["WIDE_MERGE_US"]],
                          bounds=(0, 100)).x
        put(v)
        worst = max((r for r in rows if r[3]), key=lambda r: abs(err(r)))
        log(f"[fit] wide model, {len(rows)} rows whose pairs fit (plans weighted 3): "
            f"WIDE_LAUNCH_US {v[0]:.3g}, WIDE_CHUNK_US {{1: {v[1]:.3g}, 2: {v[2]:.3g}}}, "
            f"WIDE_UNIT_US {v[3]:.3g}, WIDE_PART_US {v[4]:.3g}, WIDE_MERGE_US "
            f"{v[5]:.3g}; the plans' rows within {100 * abs(err(worst)):.1f}% (worst "
            f"{worst[4]}), every row within "
            f"{100 * max(abs(err(r)) for r in rows):.1f}%")
    finally:
        for k, val in saved.items():
            setattr(im, k, val)


def sweep_narrow(fmt, smi) -> list:
    """The evidence behind a weight kernel's narrow plan (T <= 256; fmt
    "int8" or "int4"): its time at each 8B projection shape and T in
    INT4_TS for every token width the plan may take (down to a quarter of
    the widest) and K splits 1, 2, 3, 4, 6, 8, 16 (those that give distinct
    plans), each beside the plan's model of it (plan_us) and the plan's own
    choice; each launch alone (time_alone_ms), as a step runs most of them.
    Returns the rows (plan, measured ms, whether it is the plan's own,
    label)."""
    mod, fn = ((im8, im8.int8_proj_stacked) if fmt == "int8"
               else (im, im.int4_proj_stacked))
    plan_of = im8.int8_plan if fmt == "int8" else im.int4_plan
    gen = torch.Generator(device=DEVICE).manual_seed(6)
    n_sms = build.sm_count(torch.device(DEVICE, 0))
    rows = []
    for label, (N, K) in INT4_SHAPES.items():
        q, s, L = _weight_cycle(fmt, gen, N, K, DEVICE)
        for T in INT4_TS:
            x = torch.randn(T, K, generator=gen, device=DEVICE).to(torch.bfloat16)
            chosen = plan_of(T, N, K, n_sms)
            widest = next(w for w in im.TOKEN_WIDTHS if w >= min(T, im.TOKEN_WIDTHS[-1]))
            out, it, times = [], itertools.count(), {}
            for nt in (w for w in im.TOKEN_WIDTHS if widest // 4 <= w <= widest):
                seen = set()
                for sp in (1, 2, 3, 4, 6, 8, 16):
                    p = plan_of(T, N, K, n_sms, sp, nt)
                    if p.splits in seen:
                        continue
                    seen.add(p.splits)
                    t = time_alone_ms(lambda: fn(x, q, s, next(it) % L, splits=sp, nt=nt))
                    times[p] = t
                    rows.append((p, t, p == chosen, f"{label} T={T}"))
                    out.append(f"{nt}x{p.t_tiles}/{p.splits} {t:.4f} "
                               f"({mod.plan_us(p, n_sms) / 1e3:.4f})")
            if chosen not in times:
                times[chosen] = time_alone_ms(lambda: fn(x, q, s, next(it) % L))
                rows.append((chosen, times[chosen], True, f"{label} T={T}"))
                out.append(f"plan {times[chosen]:.4f} "
                           f"({mod.plan_us(chosen, n_sms) / 1e3:.4f})")
            best = min(times.values())
            log(f"[sweep] {fmt}_matmul {label} T={T}, plan {chosen.nt}x"
                f"{chosen.t_tiles}/{chosen.splits} (token width x tiles / splits) "
                f"{times[chosen] / best:.3f}x the best measured: "
                + ", ".join(out) + f" ms measured (modelled) ({smi})")
        del q, s
        torch.cuda.empty_cache()
    return rows


def sweep_int4(smi):
    """int4_matmul's narrow sweep (sweep_narrow), then the wide
    configuration's, both formats (sweep_wide)."""
    sweep_narrow("int4", smi)
    sweep_wide(smi)


# ---------------------------------------------------------------------------
# Phase 2, INT8: the W8A16 matmul against its plain version
# ---------------------------------------------------------------------------

# (N, K) of the 8B projections and the head; the tp = 2 shards of the
# in-sharded projections (wo and w_down: K halved); ragged shapes (N off the
# 128-row tile, K off the 128-byte chunk).
INT8_SHAPES = dict(INT4_SHAPES, lm_head=(128256, 4096))
INT8_TP2_SHAPES = {"wo tp2": (4096, 2048), "w_down tp2": (4096, 7168)}
INT8_RAGGED = ((200, 272), (1000, 4128))
INT8_TABLE = ("w_gate/w_up", 128)      # the kernel table's row (PERF.md)


def _int8_stack(gen, N, K, L, device):
    """L layers of N(0, 0.02) weights drawn in f32 on the card and quantized
    there, one layer at a time."""
    qs = [quantize_weight_torch(torch.randn(N, K, generator=gen, device=device)
                                * 0.02, "int8") for _ in range(L)]
    return torch.stack([q["q"] for q in qs]), torch.stack([q["s"] for q in qs])


def _int8_check(x, q, s, label, splits=None):
    """int8_matmul at one shape (the plan's splits, or `splits` forced)
    against int8_proj_stacked_plain at its first and last layer (INT8_ATOL /
    INT8_RTOL), and against the plain split-then-merge of its plan; a second
    launch must give the same bytes. Returns the worst _compare against the
    plain version, and the plan."""
    T, K = x.shape
    plan = im8.int8_plan(T, q.shape[1], K, build.sm_count(x.device), splits)
    errs = []
    for layer in sorted({0, q.shape[0] - 1}):
        got = im8.int8_proj_stacked(x, q, s, layer, splits=splits)
        again = im8.int8_proj_stacked(x, q, s, layer, splits=splits)
        assert torch.equal(got, again), f"int8_matmul {label}: two launches differ"
        errs.append(_compare(got, im8.int8_proj_stacked_plain(x, q, s, layer),
                             atol=INT8_ATOL, rtol=INT8_RTOL))
        split = _compare(got, im8.int8_proj_split_plain(x, q, s, layer, plan),
                         atol=INT8_ATOL, rtol=INT8_RTOL)
        assert max(errs[-1][2], split[2]) <= 1, (
            f"int8_matmul {label} layer {layer} disagrees: {errs[-1]}, split {split}")
    return max(errs, key=lambda e: e[2]), plan


def int8_faults(x, q, s, plan) -> dict:
    """The planted faults, each a plain product the kernel's output (at the
    last layer) must disagree with: a K chunk of 128 columns dropped, the
    weights of the layer before, and (when the plan splits) the second
    split left out of the merge. Returns each fault's _compare."""
    L, K = q.shape[0], x.shape[1]
    got = im8.int8_proj_stacked(x, q, s, L - 1)
    dropped = x.clone()
    dropped[:, 128:256] = 0
    out = {"a K chunk dropped": im8.int8_proj_stacked_plain(dropped, q, s, L - 1),
           "the layer before's weights": im8.int8_proj_stacked_plain(x, q, s, L - 2)}
    if plan.splits > 1:
        parts = im8.int8_split_partials(x, q, L - 1, plan)
        acc = sum(p for i, p in enumerate(parts) if i != 1)
        out["a split left out of the merge"] = (
            acc.to(x.dtype).float() * s[L - 1]).to(x.dtype)
    assert K >= 256
    return {k: _compare(got, v, atol=INT8_ATOL, rtol=INT8_RTOL) for k, v in out.items()}


def _int8_timings(gen, x, N, K, device):
    """Kernel, plain and yardstick times at one shape: the kernel, proj's
    route before it (the layer's weights dequantized to bf16, then F.linear:
    quant.proj) and F.linear on bf16 weights of the same shape each cycle
    through more weight bytes than L2 holds. The kernel and F.linear are
    timed alone (time_alone_ms: ms, library_ms) and back to back (time_ms:
    ms_b2b, where one int8_matmul's prologue overlaps the one before)."""
    T = x.shape[0]
    q, s, L8 = _weight_cycle("int8", gen, N, K, device)
    it = itertools.count()
    ms = time_alone_ms(lambda: im8.int8_proj_stacked(x, q, s, next(it) % L8))
    ms_b2b = time_ms(lambda: im8.int8_proj_stacked(x, q, s, next(it) % L8))
    plain_ms = time_ms(lambda: im8.int8_proj_stacked_plain(x, q, s, next(it) % L8),
                       reps=3)
    proj_ms = time_ms(lambda: proj(x, {"q": q[next(it) % L8], "s": s[0]}))
    del q
    Lb = max(2, math.ceil(2 * L2_BYTES / (N * K * 2)))
    wb = torch.randn(Lb, N, K, generator=gen, device=device).to(torch.bfloat16)
    library_ms = time_alone_ms(lambda: F.linear(x, wb[next(it) % Lb]))
    del wb
    torch.cuda.empty_cache()
    nbytes = T * K * 2 + N * K + N * 4 + T * N * 2
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, proj_ms=proj_ms,
                ms_b2b=ms_b2b,
                **dict(zip(("bound_ms", "bound_by"), bound(nbytes, 2 * T * N * K))))


def phase_int8(device, smi) -> dict:
    """int8_matmul against int8_proj_stacked_plain in bf16: at ragged shapes
    (T = 3, 37, 200), at the 8B shapes and the head and at the tp = 2
    shards' K (T in INT4_TS), with forced splits, layers 0 and 3 of a
    4-layer stack (the head: a one-layer stack, as the model passes it),
    two launches bit-identical; the planted faults (int8_faults) must fail;
    times at every 8B shape and T. Returns the kernel table's row."""
    gen = torch.Generator(device=device).manual_seed(8)
    # The card's quantizer gives quantize_int8's bytes (the CPU tests hold
    # it against the JAX package's; here, on the card, once).
    w = torch.randn(1024, 4096, generator=gen, device=device) * 0.02
    ref = quantize_int8(w.cpu().numpy())
    got = quantize_weight_torch(w, "int8")
    assert np.array_equal(got["q"].cpu().numpy(), ref["q"]), "q bytes differ"
    assert np.array_equal(got["s"].cpu().numpy(), ref["s"]), "scales differ"
    log("[int8] quantize_weight_torch on the card: the bytes and scales of "
        "quantize_int8 (1024 x 4096)")
    for N, K in INT8_RAGGED:
        q, s = _int8_stack(gen, N, K, 4, device)
        for T in (3, 37, 200):
            x = torch.randn(T, K, generator=gen, device=device).to(torch.bfloat16)
            _int8_check(x, q, s, f"N={N} K={K} T={T}")
        log(f"[int8] ragged N {N}, K {K}: matches at T = 3, 37, 200, two "
            "launches bit-identical")
    row, table, faults = None, [], {}
    for label, (N, K) in {**INT8_SHAPES, **INT8_TP2_SHAPES}.items():
        q, s = _int8_stack(gen, N, K, 1 if label == "lm_head" else 4, device)
        worst, plans = (0.0, 0.0, 0.0), []
        for T in INT4_TS:
            x = torch.randn(T, K, generator=gen, device=device).to(torch.bfloat16)
            err, plan = _int8_check(x, q, s, f"{label} T={T}")
            worst = max(worst, err, key=lambda e: e[2])
            plans.append(f"T {T}: {plan.nt}x{plan.t_tiles} tokens, {plan.splits} "
                         f"splits, {plan.units} units")
            if T in (16, 128) and label != "lm_head":
                forced = _int8_check(x, q, s, f"{label} T={T} 3 splits", splits=3)
                worst = max(worst, forced[0], key=lambda e: e[2])
            if label == "w_down" and T == 16:
                faults = int8_faults(x, q, s, forced[1])
            if label in INT8_SHAPES:
                r = dict(max_abs_err=err[0], **_int8_timings(gen, x, N, K, device))
                table.append((label, T, r))
                if (label, T) == INT8_TABLE:
                    row = {k: v for k, v in r.items() if k not in ("proj_ms", "ms_b2b")}
        log(f"[int8] {label} (N {N}, K {K}): matches the plain version and its "
            f"plan's split-then-merge at T = {', '.join(map(str, INT4_TS))}"
            f"{'' if label == 'lm_head' else ' (and 3 splits forced at T = 16, 128)'}, "
            f"{'one layer' if label == 'lm_head' else 'layers 0 and 3'}, two "
            f"launches bit-identical: max_abs_err {worst[0]:.3g}, median |want| "
            f"{worst[1]:.3g}, worst {worst[2]:.3g} of the tolerance (atol "
            f"{INT8_ATOL}, rtol {INT8_RTOL}); plans: " + "; ".join(plans))
        del q, s
        torch.cuda.empty_cache()
    assert len(faults) == 3, faults
    for name, err in faults.items():
        log(f"[int8] planted fault ({name}, w_down T 16): max_abs_err "
            f"{err[0]:.3g}, median |want| {err[1]:.3g}, worst {err[2]:.3g} of "
            "the tolerance")
        assert err[2] > 1, f"the tolerance lets {name} pass"
    log("[time] int8_matmul library_ms: F.linear on bf16 weights of the same "
        "shape; proj_ms: quant.proj, the route before the kernel (the layer's "
        "weights dequantized to bf16, then F.linear); kernel, proj and library "
        "cycle through more weight bytes than L2 holds; ms and library_ms each "
        "call alone (time_alone_ms), ms_b2b the kernel's launches back to back")
    for label, T, r in table:
        log(f"[time] int8_matmul {label} T={T}: " + ", ".join(
            f"{a}={b:.4f}" if isinstance(b, float) else f"{a}={b}"
            for a, b in r.items()) + f" ({smi})")
    return row


def compare_int8(smi):
    """The weight kernels' times, once each in one process, cycling through
    more weight bytes than L2 holds: int8_matmul at each shape of
    INT8_SHAPES and T in INT4_TS (the narrow configuration), int4_matmul at
    INT4_SHAPES and INT4_TS, and both at w_gate T = 512 and 1,024 (the wide
    configuration); at T <= 256 launches back to back (time_ms) and each
    alone (time_alone_ms), since an int8_matmul launch may overlap the one
    before it. It calls only the wrappers (int8_proj_stacked and
    int4_proj_stacked with (x, q, s, layer)), so this script copied into an
    earlier checkout times that checkout's kernels: run the two in turns
    (parent, change, change, parent) to compare builds on one card."""
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    out = {"int8_matmul": [], "int4_matmul": []}
    for fmt, shapes in (("int8", INT8_SHAPES), ("int4", INT4_SHAPES)):
        fn = im8.int8_proj_stacked if fmt == "int8" else im.int4_proj_stacked
        for label, (N, K) in shapes.items():
            q, s, L = _weight_cycle(fmt, gen, N, K, DEVICE)
            ts = INT4_TS + ((512, 1024) if label == "w_gate/w_up" else ())
            for T in ts:
                x = torch.randn(T, K, generator=gen, device=DEVICE).to(torch.bfloat16)
                it = itertools.count()
                t = time_ms(lambda: fn(x, q, s, next(it) % L))
                alone = (f" (alone {time_alone_ms(lambda: fn(x, q, s, next(it) % L)):.4f})"
                         if T <= 256 else "")
                out[f"{fmt}_matmul"].append(f"{label} T={T} {t:.4f}{alone}")
            del q, s
            torch.cuda.empty_cache()
    for k, v in out.items():
        log(f"[compare] {k}: {'; '.join(v)} ms ({smi})")


def sweep_int8(smi):
    """int8_matmul's narrow sweep (sweep_narrow), then the plan's model
    constants fitted to its times (fit_int8_model)."""
    fit_int8_model(sweep_narrow("int8", smi), build.sm_count(torch.device(DEVICE, 0)))


def fit_int8_model(rows, n_sms) -> None:
    """Fits int8_matmul.plan_us's constants to the sweep's rows (plan,
    measured ms, whether it is the plan's own, label) within 1.5 times the
    best of their shape and T (the plans worth choosing between; many
    splits of a wide token tile write partials the model does not weigh):
    least squares of the relative error. Logs the constants (int8_matmul.py
    takes them from here) and, at each shape and T, the time of the plan
    int8_plan then chooses against the best measured, and leaves the
    module's constants as they were."""
    from scipy.optimize import least_squares
    best_of = {}
    for r in rows:
        best_of[r[3]] = min(best_of.get(r[3], math.inf), r[1])
    timed = {(r[3], r[0]): r[1] for r in rows}
    rows = [r for r in rows if r[1] <= 1.5 * best_of[r[3]]]
    names = ("LAUNCH_US", "UNIT_US", "PRODUCT_CYCLES", "NT_CYCLES", "MERGE_US",
             "MERGE_US_PER_KB", "BYTES_PER_US")
    saved = {k: getattr(im8, k) for k in names}

    def put(v):
        for k, val in zip(names, v):
            setattr(im8, k, float(val))

    def err(r):
        return im8.plan_us(r[0], n_sms) / (1e3 * r[1]) - 1
    try:
        lo = [0, 0, 0, 0, 0, 0, 1e5]
        hi = [50, 50, 500, 10, 50, 1, 1e7]
        v = least_squares(lambda v: (put(v), [err(r) for r in rows])[1],
                          [saved[k] for k in names], bounds=(lo, hi)).x
        put(v)
        im8.int8_plan.cache_clear()
        picks = []
        for label, (N, K) in INT4_SHAPES.items():
            for T in INT4_TS:
                p = im8.int8_plan(T, N, K, n_sms)
                t = timed.get((f"{label} T={T}", p))
                picks.append(f"{label} T={T} {p.nt}x{p.t_tiles}/{p.splits} "
                             + (f"{t / best_of[f'{label} T={T}']:.3f}x" if t else "not timed"))
        log("[fit] int8 narrow model: " + ", ".join(
            f"{k} {val:.4g}" for k, val in zip(names, v))
            + f"; {len(rows)} rows within 1.5x of their best, each within "
            f"{100 * max(abs(err(r)) for r in rows):.1f}%; int8_plan under it "
            f"chooses (against the best measured): " + "; ".join(picks))
    finally:
        put([saved[k] for k in names])
        im8.int8_plan.cache_clear()


# ---------------------------------------------------------------------------
# Phase 2, the weight kernels' wide configuration (T > 256)
# ---------------------------------------------------------------------------

WIDE_TS = (300, 512, 1024, 2048)       # a part tile and the prefill buckets
WIDE_HEAD_T = 640                      # a verify head of 128 rows x 5
# INT4's wide configuration against its plain version (proj's arithmetic):
# both round each half's f32 sum (O(100) for these inputs, summed in
# another order) to bf16, so a half may land a bf16 step apart, 0.25 to 1
# before the scale, about 0.01 after it, on outputs of O(1): atol 2e-2
# covers two such steps, rtol 2e-2 the two roundings after them, as INT8's.
# Where the two halves nearly cancel, one such step is more than that of a
# small output: int4_flip_compare counts an output within the tolerance
# also where it equals, within it, proj's arithmetic with a half one bf16
# step off, and reports how many needed that. A dropped token tile or
# misplaced x rows move outputs by O(1): those faults fail. The roundings
# themselves are held bit for bit on integer inputs (wide_exact).
INT4_WIDE_ATOL, INT4_WIDE_RTOL = 2e-2, 2e-2
WIDE_SEEDS = (101, 202, 303, 404)      # the cut units' readings over seeds


def int4_wide_halves(x, q4, layer, plan=None, drop=None):
    """The two half sums [T, N] of the INT4 wide configuration, each rounded
    to x's dtype: proj's (one product of each half), or as `plan`'s
    schedule takes them (int4_matmul.wide_half_sums: a cut unit's segments
    summed in K order, `drop` one left out)."""
    lo, hi = nibbles(q4[layer])
    half = q4.shape[2]
    if plan is None:
        return (F.linear(x[:, :half], lo.to(x.dtype)),
                F.linear(x[:, half:], hi.to(x.dtype)))
    xf = x.float()
    return tuple(t.to(x.dtype) for t in im.wide_half_sums(
        [xf[:, :half], xf[:, half:]], [lo.float(), hi.float()], plan, drop))


def bf16_step(t, d: int):
    """t with every element d bf16 steps away from it (its bit pattern plus
    d; a step below zero gives NaN, which no comparison takes)."""
    return t if d == 0 else (t.view(torch.int16) + d).view(t.dtype)


def int4_flip_compare(got, halves, s_row, tol) -> tuple:
    """got against proj's arithmetic on `halves` (each half's sum rounded to
    bf16; their bf16 sum times the scale s_row, rounded): _compare's triple,
    then the worst ratio once each half may be one bf16 step off (each
    output held to the nearest of the nine), and how many outputs were
    outside the tolerance before that. The check takes the fourth."""
    lo, hi = halves
    want = ((lo + hi).float() * s_row).to(got.dtype)
    base = _compare(got, want, *tol)
    g = got.float()

    def ratio(w):
        w = w.float()
        return (g - w).abs() / (tol[0] + tol[1] * w.abs())
    best = ratio(want)
    n_out = int((best > 1).sum().item())
    if n_out:
        for dl in (-1, 0, 1):
            for dh in (-1, 0, 1):
                if dl or dh:
                    w = ((bf16_step(lo, dl) + bf16_step(hi, dh)).float() * s_row).to(got.dtype)
                    best = torch.fmin(best, ratio(w))
    worst = best.max().item() if bool(torch.isfinite(g).all()) else math.inf
    return base + (worst, n_out)


def wide_fmt(fmt: str) -> dict:
    """A format's wrapper, plain versions, plan and tolerance."""
    if fmt == "int8":
        return dict(kernel=im8.int8_proj_stacked, plain=im8.int8_proj_stacked_plain,
                    split=im8.int8_proj_split_plain, plan=im8.int8_plan,
                    key="q", tol=(INT8_ATOL, INT8_RTOL), name="int8_matmul")
    return dict(kernel=im.int4_proj_stacked, plain=im.int4_proj_wide_plain,
                split=im.int4_wide_split_plain, plan=im.int4_plan, key="q4",
                tol=(INT4_WIDE_ATOL, INT4_WIDE_RTOL), name="int4_matmul")


def wide_launch(fmt, x, q, s, layer, plan):
    """The wide configuration launched by `plan` through the format's C
    entry, as its wrapper launches the plan it chooses: a schedule that the
    plan would not choose (make_wide_plan's), for a measurement or a check.
    The plan must be one for these shapes."""
    T, K = x.shape
    N, name = q.shape[1], wide_fmt(fmt)["name"]
    assert (plan.nt, plan.t_tiles, plan.tiles) == (im.WIDE_NT, cdiv(T, im.WIDE_NT),
                                                   cdiv(N, im.BM)), plan
    y = torch.empty(T, N, dtype=x.dtype, device=x.device)
    ws = cnt = None
    if plan.splits > 1:
        ws = torch.empty(im.partials(plan), dtype=torch.float32, device=x.device)
        cnt = build.device_counters(name, x.device, plan.tiles * plan.t_tiles)
    build.launch(name, x.device, x.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(),
                 None if ws is None else ws.data_ptr(),
                 None if cnt is None else cnt.data_ptr(), T, N, K, q.shape[0], layer,
                 plan.nt, plan.t_tiles, plan.splits, plan.per, plan.grid)
    return y


@contextlib.contextmanager
def equal_cuts():
    """The wide plans without stream-K, as before it: every unit whole, or
    every unit cut into 2, 3, 4, 6 or 8 equal pieces (wide_plan's forced
    splits), whichever the plan's model times least. The plan caches are
    cleared on entry and on exit."""
    plan = im.wide_plan

    def cuts(T, N, K, n_sms, splits, halves):
        if splits is not None:
            return plan(T, N, K, n_sms, splits, halves)
        return min((plan(T, N, K, n_sms, sp, halves) for sp in (1, 2, 3, 4, 6, 8)),
                   key=lambda p: im.wide_plan_us(p, n_sms, halves))
    im.wide_plan = cuts
    im.int4_plan.cache_clear()
    im8.int8_plan.cache_clear()
    try:
        yield
    finally:
        im.wide_plan = plan
        im.int4_plan.cache_clear()
        im8.int8_plan.cache_clear()


def _wide_stack(fmt, gen, N, K, L, device):
    """L layers of N(0, 0.02) weights quantized on the card."""
    return (_int8_stack if fmt == "int8" else _int4_stack)(gen, N, K, L, device)


def wide_tile_halves_swapped(y):
    """The planted fault "x multicast to the wrong block of the cluster":
    each block's 128 token rows of x landed in the other block's half of
    the 256-token tile, so the outputs of the two halves of every whole
    tile trade places."""
    f = y.clone()
    for t0 in range(0, y.shape[0] - 255, 256):
        f[t0:t0 + 128], f[t0 + 128:t0 + 256] = y[t0 + 128:t0 + 256], y[t0:t0 + 128]
    return f


def wide_last_tile_dropped(y):
    """The planted fault: the last, partial token tile never stored (zeros)."""
    f = y.clone()
    f[y.shape[0] // 256 * 256:] = 0
    return f


def wide_compare(fmt, got, x, q, s, layer, plan=None, drop=None,
                 fault=lambda t: t) -> tuple:
    """got against the format's plain version (plan None) or its plain
    split-then-merge of `plan` (`drop`: a segment left out), each output
    moved by `fault` (a planted fault's expected output), within the
    format's tolerance: (max_abs_err, median |want|, the worst ratio with no
    half a step off, the worst ratio the check takes, outputs that needed a
    step). INT8 takes the ratio as it is (one f32 sum, rounded); INT4
    allows each half one bf16 step (int4_flip_compare)."""
    f = wide_fmt(fmt)
    if fmt == "int4":
        return int4_flip_compare(got, [fault(h) for h in int4_wide_halves(
            x, q, layer, plan, drop)], s[layer].float(), f["tol"])
    want = (f["plain"](x, q, s, layer) if plan is None
            else f["split"](x, q, s, layer, plan, drop))
    e = _compare(got, fault(want), *f["tol"])
    return e + (e[2], 0)


def _wide_check(fmt, x, q, s, label, splits=None, faults=False, plan=None):
    """The kernel's wide configuration at one shape (its plan's schedule,
    `splits` forced, or `plan` launched through wide_launch) against the
    plain version at its first and last layer and against the plain
    split-then-merge of its plan (wide_compare); a second launch gives the
    same bytes. With `faults`, the planted faults of the tiles
    (wide_tile_halves_swapped, and at a partial last tile
    wide_last_tile_dropped) must fail. Returns the worst compare, the plan
    and the faults' compares."""
    f = wide_fmt(fmt)
    T, K = x.shape
    if plan is None:
        plan = f["plan"](T, q.shape[1], K, build.sm_count(x.device), splits)
        run = lambda layer: f["kernel"](x, q, s, layer, splits=splits)
    else:
        run = lambda layer: wide_launch(fmt, x, q, s, layer, plan)
    assert plan.nt == im.WIDE_NT, plan
    errs, bad = [], {}
    for layer in sorted({0, q.shape[0] - 1}):
        got = run(layer)
        assert torch.equal(got, run(layer)), f"{f['name']} {label}: two launches differ"
        errs.append(wide_compare(fmt, got, x, q, s, layer))
        split = wide_compare(fmt, got, x, q, s, layer, plan)
        assert max(errs[-1][3], split[3]) <= 1, (
            f"{f['name']} {label} layer {layer} disagrees: {errs[-1]}, split {split}")
        errs.append(split)
    if faults:
        layer = q.shape[0] - 1
        bad["x multicast to the wrong block"] = wide_compare(
            fmt, got, x, q, s, layer, fault=wide_tile_halves_swapped)
        if T % 256:
            bad["the last partial token tile dropped"] = wide_compare(
                fmt, got, x, q, s, layer, fault=wide_last_tile_dropped)
        for name, e in bad.items():
            assert e[3] > 1, f"the tolerance lets '{name}' pass ({fmt} {label})"
    return max(errs, key=lambda e: e[3]), plan, bad


def wide_exact(fmt, gen, N, K, T, device) -> dict:
    """Integer inputs (x in [-4, 4], any weight byte, scales 2^-10), on which
    every f32 sum is exact: the wide configuration must equal its plain
    version bit for bit at the plan's schedule, at splits 1 and 4 forced
    and with stream-K on every pair. For INT4 the plain version rounds each half to bf16 before their sum, so the
    planted fault "halves summed before rounding" (the narrow
    configuration's single rounding, int4_proj_stacked_plain) must differ.
    Returns the planted fault's share of differing outputs (INT4)."""
    f = wide_fmt(fmt)
    x = torch.randint(-4, 5, (T, K), generator=gen, device=device).to(torch.bfloat16)
    kb = K if fmt == "int8" else K // 2
    q = torch.randint(-128, 128, (2, N, kb), generator=gen, device=device,
                      dtype=torch.int8)
    if fmt == "int8":
        q.clamp_(min=-127)
    s = torch.full((2, N), 2.0 ** -10, device=device)
    n_sms = build.sm_count(x.device)
    everywhere = stream_k_everywhere(fmt, T, N, K, n_sms)
    for splits in (None, 1, 4, everywhere):
        if isinstance(splits, im.MatmulPlan):
            got, plan = wide_launch(fmt, x, q, s, 1, splits), splits
        else:
            got = f["kernel"](x, q, s, 1, splits=splits)
            plan = f["plan"](T, N, K, n_sms, splits)
        want = f["split"](x, q, s, 1, plan)
        assert torch.equal(got, want), (
            f"{f['name']} N={N} K={K} T={T} {wide_plan_text(plan)}: not bit-equal "
            f"on integer inputs ({(got != want).float().mean().item():.4f} differ)")
    out = {}
    if fmt == "int4":
        share = (got != im.int4_proj_stacked_plain(x, q, s, 1)).float().mean().item()
        assert share > 0.01, f"halves summed before rounding pass ({share})"
        out["halves summed before rounding"] = share
    return out


def stream_k_everywhere(fmt, T, N, K, n_sms):
    """The wide schedule with every unit stream-K on every pair that fits
    (make_wide_plan, no unit whole; fewer pairs where they would have less
    than WIDE_MIN_RANGE chunks each): the cuts fall where the balance puts
    them, not at a split's equal bounds."""
    halves = 2 if fmt == "int4" else 1
    chunks = halves * cdiv(K // halves, im.WIDE_KC)
    units = cdiv(cdiv(N, im.BM), im.CLUSTER) * cdiv(T, im.WIDE_NT)
    pairs = max(1, min(n_sms // im.CLUSTER, units * chunks // im.WIDE_MIN_RANGE))
    return im.make_wide_plan(T, N, K, halves, pairs, 0)


def wide_schedule_faults(fmt, x, q, s) -> dict:
    """The planted faults of the wide kernel's schedule, each an expected
    output that the kernel's (at the last layer) must disagree with: one
    chunk's products dropped at a unit's start (its first chunk: x's first
    64 columns, INT4's low half) and at its end (its last: x's last 64,
    INT4's high half), as an in-flight pipeline off by one chunk would drop
    them; and, every unit stream-K on every pair (stream_k_everywhere), the
    second segment of the first cut unit left out of the merge. Returns
    each fault's wide_compare."""
    L, (T, K) = q.shape[0], x.shape
    got = wide_fmt(fmt)["kernel"](x, q, s, L - 1)
    res = {}
    for end, cols in (("start", slice(0, 64)), ("end", slice(K - 64, K))):
        xd = x.clone()
        xd[:, cols] = 0
        res[f"one chunk's products dropped at a unit's {end}"] = wide_compare(
            fmt, got, xd, q, s, L - 1)
    plan = stream_k_everywhere(fmt, T, q.shape[1], K, build.sm_count(x.device))
    cut = im.wide_cut_units(plan, 2 if fmt == "int4" else 1)
    assert cut, plan
    res["a segment of a cut unit left out of the merge"] = wide_compare(
        fmt, wide_launch(fmt, x, q, s, L - 1, plan), x, q, s, L - 1, plan,
        drop=(min(cut), 1))
    for k, e in res.items():
        assert e[3] > 1, f"the tolerance lets '{k}' pass ({fmt} T={T})"
    return res


def wide_seed_readings(fmt, device) -> None:
    """The plan's schedule of wq and w_down (cut units, stream-K, at T =
    300 and 512), every unit whole, and stream-K on every pair
    (stream_k_everywhere), over WIDE_SEEDS: each launch against the plain version and its plan's
    split-then-merge (wide_compare, which the check holds to 1); logs the
    worst reading before a half's step, the worst the check takes and the
    outputs that needed a step."""
    f = wide_fmt(fmt)
    n_sms = build.sm_count(torch.device(device, 0))
    for label in ("wq/wo", "w_down"):
        N, K = INT4_SHAPES[label]
        for sched in ("the plan", "every unit whole", "stream-K on every pair"):
            base = check = 0.0
            flips, cut = 0, set()
            for seed in WIDE_SEEDS:
                gen = torch.Generator(device=device).manual_seed(seed)
                q, s = _wide_stack(fmt, gen, N, K, 1, device)
                for T in (300, 512):
                    x = torch.randn(T, K, generator=gen, device=device).to(torch.bfloat16)
                    plan = (f["plan"](T, N, K, n_sms) if sched == "the plan" else
                            f["plan"](T, N, K, n_sms, 1) if sched == "every unit whole"
                            else stream_k_everywhere(fmt, T, N, K, n_sms))
                    cut.add((T, len(im.wide_cut_units(plan, 2 if fmt == "int4" else 1))))
                    got = wide_launch(fmt, x, q, s, 0, plan)
                    for p in (None, plan):
                        e = wide_compare(fmt, got, x, q, s, 0, p)
                        assert e[3] <= 1, (f["name"], label, sched, seed, T, e)
                        base, check, flips = max(base, e[2]), max(check, e[3]), flips + e[4]
                del q, s
            log(f"[{fmt} wide] {label}, {sched} (cut units at T, count: {sorted(cut)}), "
                f"{len(WIDE_SEEDS)} seeds x T = 300, 512 against the plain version and "
                f"the split-then-merge: worst {base:.3g} of the tolerance before a half's "
                f"step, {check:.3g} after; {flips} outputs needed a step")


def _wide_timings(fmt, gen, x, N, K, device):
    """Kernel, plain, proj-route and library times at one shape, and the
    bound: the kernel, quant.proj (the route before the wide configuration:
    the layer's weights dequantized to bf16, then F.linear) and F.linear on
    bf16 weights of the same shape each cycle through more weight bytes
    than L2 holds."""
    f = wide_fmt(fmt)
    T = x.shape[0]
    kb = K if fmt == "int8" else K // 2
    q, s, L8 = _weight_cycle(fmt, gen, N, K, device)
    it = itertools.count()
    ms = time_ms(lambda: f["kernel"](x, q, s, next(it) % L8))
    plain_ms = time_ms(lambda: f["plain"](x, q, s, next(it) % L8), reps=3)
    proj_ms = time_ms(lambda: proj(x, {f["key"]: q[next(it) % L8], "s": s[0]}))
    del q
    Lb = max(2, math.ceil(2 * L2_BYTES / (N * K * 2)))
    wb = torch.randn(Lb, N, K, generator=gen, device=device).to(torch.bfloat16)
    library_ms = time_ms(lambda: F.linear(x, wb[next(it) % Lb]))
    del wb
    torch.cuda.empty_cache()
    nbytes = T * K * 2 + N * kb + N * 4 + T * N * 2
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, proj_ms=proj_ms,
                **dict(zip(("bound_ms", "bound_by"), bound(nbytes, 2 * T * N * K))))


def phase_wide(fmt: str, device, smi) -> dict:
    """The wide configuration of int8_matmul or int4_matmul (T > 256):
    against its plain version at ragged shapes (T = 257, 300, 600), at the
    four 8B projection shapes (T in WIDE_TS, layers 0 and 3 of a 4-layer
    stack, with 4 splits forced at T = 512), at INT8's head (640 rows) and
    at the tp = 2 shards (T = 512), and at T = 512 also with every unit
    stream-K on every pair (stream_k_everywhere); the plan's cut units of
    wq and w_down at T = 300 and 512 over WIDE_SEEDS (wide_seed_readings);
    two launches bit-identical; bit-equal on integer inputs (wide_exact);
    the planted faults must fail (the tiles' at w_gate T = 300 and 512, the
    schedule's at T = 512, wide_schedule_faults, INT4's rounding in
    wide_exact); times at every 8B shape and T, and at T = 128 and 256 with
    the wide tile forced beside the narrow plan's (INT8). Returns {(shape,
    T): timings}."""
    f = wide_fmt(fmt)
    gen = torch.Generator(device=device).manual_seed(14 if fmt == "int8" else 41)
    # Ragged: N off the 128-row tile and an odd tile count (the last pair's
    # second block computes past N and writes nothing), K (INT4: K/2) off
    # the 64-byte chunk, T off the 256-token tile.
    for N, K in ((300, 1056), (1000, 4128)):
        q, s = _wide_stack(fmt, gen, N, K, 4, device)
        for T in (257, 300, 600):
            x = torch.randn(T, K, generator=gen, device=device).to(torch.bfloat16)
            _wide_check(fmt, x, q, s, f"N={N} K={K} T={T}")
        log(f"[{fmt} wide] ragged N {N}, K {K}: matches at T = 257, 300, 600, "
            "two launches bit-identical")
        del q, s
    shapes = dict(INT4_SHAPES, **INT8_TP2_SHAPES)
    if fmt == "int8":
        shapes["lm_head"] = INT8_SHAPES["lm_head"]
    table, faults = {}, {}
    for label, (N, K) in shapes.items():
        head, tp2 = label == "lm_head", label in INT8_TP2_SHAPES
        Ts = (WIDE_HEAD_T,) if head else (512,) if tp2 else WIDE_TS
        q, s = _wide_stack(fmt, gen, N, K, 1 if head else 4, device)
        worst, plans = (0.0, 0.0, 0.0, 0.0, 0), []
        for T in Ts:
            x = torch.randn(T, K, generator=gen, device=device).to(torch.bfloat16)
            err, plan, bad = _wide_check(fmt, x, q, s, f"{label} T={T}",
                                         faults=label == "w_gate/w_up" and T in (300, 512))
            faults.update({(k, T): v for k, v in bad.items()})
            if label == "w_gate/w_up" and T == 512:
                faults.update({(k, T): v for k, v in
                               wide_schedule_faults(fmt, x, q, s).items()})
            flips = err[4]
            worst = max(worst, err, key=lambda e: e[3])
            plans.append(f"T {T}: {wide_plan_text(plan)}")
            if T == 512 and not head:
                for forced in (_wide_check(fmt, x, q, s, f"{label} T={T} 4 splits", splits=4),
                               _wide_check(fmt, x, q, s, f"{label} T={T} stream-K everywhere",
                                           plan=stream_k_everywhere(
                                               fmt, T, N, K, build.sm_count(x.device)))):
                    worst = max(worst, forced[0], key=lambda e: e[3])
                    flips = max(flips, forced[0][4])
            if not tp2:
                table[(label, T)] = dict(
                    max_abs_err=err[0], **_wide_timings(fmt, gen, x, N, K, device),
                    model_ms=im.wide_plan_us(plan, build.sm_count(x.device),
                                             2 if fmt == "int4" else 1) / 1e3)
        log(f"[{fmt} wide] {label} (N {N}, K {K}): matches the plain version and "
            f"its plan's split-then-merge at T = {', '.join(map(str, Ts))}"
            f"{'' if head else ' (and at T = 512 4 splits forced, and stream-K on every pair)'}, "
            f"{'one layer' if head else 'layers 0 and 3'}, two launches "
            f"bit-identical: max_abs_err {worst[0]:.3g}, median |want| "
            f"{worst[1]:.3g}, worst {worst[3]:.3g} of the tolerance (atol "
            f"{f['tol'][0]}, rtol {f['tol'][1]}; before a half's step "
            f"{worst[2]:.3g}, outputs that needed one at most {flips}); plans: "
            + "; ".join(plans))
        del q, s
        torch.cuda.empty_cache()
    wide_seed_readings(fmt, device)
    for N, K in ((14336, 4096), (1024, 4096), (300, 1024)):
        for T in (512, 300):
            faults.update({(k, T): v for k, v in wide_exact(fmt, gen, N, K, T, device).items()})
        log(f"[{fmt} wide] integer inputs, N {N}, K {K}, T 300 and 512: the "
            "kernel equals its plain version bit for bit (the plan's schedule, "
            "splits 1 and 4 forced, stream-K on every pair)")
    for fault in ("multicast", "tile dropped", "unit's start", "unit's end", "merge"):
        assert any(fault in k for k, _ in faults), fault
    assert fmt == "int8" or any("rounding" in k for k, _ in faults)
    for (name, T), e in faults.items():
        if isinstance(e, float):
            log(f"[{fmt} wide] planted fault ({name}, T {T}): {100 * e:.1f}% of "
                "the outputs differ from the kernel's on integer inputs")
        else:
            log(f"[{fmt} wide] planted fault ({name}, w_gate T {T}): max_abs_err "
                f"{e[0]:.3g}, median |want| {e[1]:.3g}, worst {e[3]:.3g} of the "
                "tolerance")
    if fmt == "int8":
        # The wide tile in the decode buckets, forced, beside the narrow
        # plan's launch: evidence for a later int8_matmul change, not used.
        for label, (N, K) in INT4_SHAPES.items():
            q, s, L8 = _weight_cycle(fmt, gen, N, K, device)
            it = itertools.count()
            for T in (128, 256):
                x = torch.randn(T, K, generator=gen, device=device).to(torch.bfloat16)
                table[(label, T)] = dict(
                    narrow_ms=time_alone_ms(lambda: f["kernel"](x, q, s, next(it) % L8)),
                    wide_ms=time_alone_ms(lambda: f["kernel"](x, q, s, next(it) % L8,
                                                              nt=im.WIDE_NT)),
                    **dict(zip(("bound_ms", "bound_by"), bound(
                        T * K * 2 + N * K + N * 4 + T * N * 2, 2 * T * N * K))))
            del q, s
            torch.cuda.empty_cache()
    log(f"[time] {f['name']} wide configuration: library_ms F.linear on bf16 "
        "weights of the same shape; proj_ms quant.proj, the route before it "
        "(the layer's weights dequantized to bf16, then F.linear); model_ms "
        "the plan's modelled time (int4_matmul.wide_plan_us); kernel, "
        "proj and library cycle through more weight bytes than L2 holds"
        + ("; at T = 128 and 256 narrow_ms is the plan's launch, wide_ms the "
           "wide tile forced, each launch alone (time_alone_ms)" if fmt == "int8" else ""))
    for (label, T), r in table.items():
        log(f"[time] {f['name']} wide {label} T={T}: " + ", ".join(
            f"{a}={b:.4f}" if isinstance(b, float) else f"{a}={b}"
            for a, b in r.items()) + f" ({smi})")
    return table


# ---------------------------------------------------------------------------
# Phase 2, swap: the page mover against its plain version
# ---------------------------------------------------------------------------

SWAP_N = 128            # pages of a timed round trip


def page_runs(src_pages, dst_pages) -> np.ndarray:
    """(source page, destination page, pages) of each maximal run of pages
    consecutive on both sides, as int32 [3, n_runs]."""
    runs = []
    for s, d in zip(np.asarray(src_pages).tolist(), np.asarray(dst_pages).tolist()):
        if runs and s == runs[-1][0] + runs[-1][2] and d == runs[-1][1] + runs[-1][2]:
            runs[-1][2] += 1
        else:
            runs.append([s, d, 1])
    return np.ascontiguousarray(np.array(runs, np.int32).T)


def copy_page_runs(src, dst, src_pages, dst_pages, page_size):
    """The yardstick, swiftLLM's swap_blocks form: one cudaMemcpy2DAsync per
    run of consecutive pages, the layers as its rows (csrc/swap_pages.cu,
    copy_page_runs; the port never calls it)."""
    runs = page_runs(src_pages, dst_pages)
    row = src.shape[2] * src.element_size()
    err = build.entry("copy_page_runs")(
        src.data_ptr(), dst.data_ptr(), runs.ctypes.data, runs.shape[1],
        src.shape[0], src.shape[1] * row, dst.shape[1] * row, page_size * row,
        build.stream(torch.device(DEVICE)))
    assert err == 0, f"cudaMemcpy2DAsync failed with CUDA error {err}"


def link_rates(nbytes=2**30) -> tuple[float, float]:
    """Bytes/s of one 1 GiB copy_ pinned -> card and one card -> pinned, by
    CUDA events: the host link's rate each way, as this card sees it."""
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(nbytes, dtype=torch.uint8, device=DEVICE)
    rates = tuple(nbytes / (1e-3 * time_ms(
        lambda: dst.copy_(src, non_blocking=True), reps=3, warmup=1))
        for dst, src in ((dev, host), (host, dev)))
    del host, dev
    return rates


def overlap_ms(load, swap, reps=3) -> tuple[float, float, float]:
    """load() on the current stream and swap() on a side stream, started
    together behind a sleep kernel: the mean over `reps` of the makespan, of
    the load's own span and of the swap's own span (ms, CUDA events). The
    swap as a server would run it beside a step that it does not wait for."""
    side = torch.cuda.Stream()
    ev = lambda: torch.cuda.Event(enable_timing=True)  # noqa: E731
    sums = np.zeros(3)
    for rep in range(reps + 1):          # the first is a warm-up
        torch.cuda.synchronize()
        torch.cuda._sleep(SLEEP_CYCLES)
        start, l0, l1, s0, s1, end = (ev() for _ in range(6))
        start.record()
        side.wait_event(start)
        with torch.cuda.stream(side):
            s0.record()
            swap()
            s1.record()
        l0.record()
        load()
        l1.record()
        torch.cuda.current_stream().wait_stream(side)
        end.record()
        end.synchronize()
        if rep:
            sums += (start.elapsed_time(end), l0.elapsed_time(l1),
                     s0.elapsed_time(s1))
    return tuple(sums / reps)


def _page_bytes_of(t, pages, page_size):
    return t.view(torch.uint8)[:, page_slots(pages, page_size).to(t.device)]


def check_mover(cache, pool, src, host, back, ps, label):
    """Out (cache pages `src` to pool pages `host`), then in (pool pages
    `host` to cache pages `back`), the kernel against the plain version on
    copies: the whole pool and the whole cache byte-identical to the plain
    results (so nothing but the named pages changed), and the pages at
    `back` byte-identical to those that left `src`. One launch a way.
    Returns the cache before and the cache the plain version gives."""
    before = cache.clone()
    pool_plain = pool.clone()
    build.reset_launch_counts()
    swap_pages(cache, pool, src, host, ps)
    torch.cuda.synchronize()
    swap_pages_plain(before, pool_plain, src, host, ps)
    assert torch.equal(pool.view(torch.uint8), pool_plain.view(torch.uint8)), \
        f"{label}: the pool after the swap-out differs from the plain version's"
    swap_pages(pool, cache, host, back, ps)
    torch.cuda.synchronize()
    want = before.clone()
    swap_pages_plain(pool_plain, want, host, back, ps)
    assert torch.equal(cache.view(torch.uint8), want.view(torch.uint8)), \
        f"{label}: the cache after the swap-in differs from the plain version's"
    assert torch.equal(_page_bytes_of(cache, back, ps), _page_bytes_of(before, src, ps))
    assert build.launch_counts["swap_pages"] == 2, build.launch_counts
    log(f"[swap] mover {label}: {len(src)} pages out and back in to other "
        f"pages, byte-identical, the rest of the cache and the pool as the "
        f"plain version leaves them; 2 launches")
    return before, want


def phase_swap_mover(smi) -> dict:
    """The page mover at 8B width (32 layers, 8 kv heads of 128): bf16 pages
    of 16 and fp8 pages of 32 (rows of 2,176 B, scale lanes included),
    scattered and consecutive page lists, out to the pinned pool and back
    in to other device pages, against the plain version; a planted fault
    (every destination page one further) must fail. Then one round trip of SWAP_N bf16 pages,
    timed, against the host link's byte bound (its rate measured here, and
    each way's share of it), the plain version and cudaMemcpy2DAsync per
    run, and beside a decode-like load (overlap_swap). Returns the times
    (ms) by name."""
    rate_in, rate_out = link_rates()
    log(f"[swap] host link: pinned -> card {rate_in / 1e9:.2f} GB/s, card -> "
        f"pinned {rate_out / 1e9:.2f} GB/s (one 1 GiB copy_ each way; {smi})")
    g = torch.Generator(device=DEVICE).manual_seed(31)
    rng = np.random.default_rng(31)
    lanes = 2 * LLAMA3_8B["num_kv_heads"] * LLAMA3_8B["head_dim"]
    out = {}
    for kv, ps, W, n_dev, n_host in (("bf16", 16, lanes, 1024, 512),
                                     ("fp8", 32, lanes + pa.FP8_SCALE_LANES, 512, 256)):
        dtype = torch.bfloat16 if kv == "bf16" else pa.FP8
        cache = torch.empty(32, n_dev * ps, W, dtype=dtype, device=DEVICE)
        cache.view(torch.uint8).random_(0, 256, generator=g)
        pool = pinned_pool((32, n_host * ps, W), dtype)      # the engines' pool
        pool.view(torch.uint8).fill_(0xA5)
        page_bytes = 32 * ps * W * cache.element_size()
        lists = swap_lists(rng, n_dev, n_host)
        for layout, (s, h, b) in lists.items():
            before, want = check_mover(cache, pool, s, h, b, ps,
                                       f"{kv} pages of {ps} ({page_bytes} B), {layout}")
            if kv == "bf16" and layout == "consecutive":
                bad = before.clone()
                swap_pages(pool, bad, h, b + 1, ps)
                torch.cuda.synchronize()
                assert not torch.equal(bad.view(torch.uint8), want.view(torch.uint8)), \
                    "a destination page off by one passes the check"
                log("[swap] planted fault (every destination page one further) fails")
                del bad
            del before, want
        if kv == "bf16":
            moved = SWAP_N * page_bytes
            bound_ms = 1e3 * (moved / rate_out + moved / rate_in)
            for layout, (s, h, b) in lists.items():
                t_out = time_ms(lambda: swap_pages(cache, pool, s, h, ps))
                t_in = time_ms(lambda: swap_pages(pool, cache, h, b, ps))
                t_lib = time_ms(lambda: (copy_page_runs(cache, pool, s, h, ps),
                                         copy_page_runs(pool, cache, h, b, ps)))
                line = (f"[swap] round trip of {SWAP_N} {layout} bf16 pages "
                        f"({moved / 2**20:.0f} MiB a way): mover {t_out + t_in:.4f} "
                        f"ms ({link_shares(moved, t_out, t_in, rate_out, rate_in)}); "
                        f"the link's byte bound {bound_ms:.4f} ms; cudaMemcpy2DAsync "
                        f"per run ({page_runs(s, h).shape[1]} runs out, "
                        f"{page_runs(h, b).shape[1]} in) {t_lib:.4f} ms "
                        f"({t_out + t_in - t_lib:+.4f} ms mover - copies)")
                if layout == "scattered":
                    t_plain = time_ms(lambda: (swap_pages_plain(cache, pool, s, h, ps),
                                               swap_pages_plain(pool, cache, h, b, ps)),
                                      reps=3, warmup=1)
                    line += f"; plain {t_plain:.4f} ms"
                    out.update(ms=t_out + t_in, out_ms=t_out, in_ms=t_in,
                               bound_ms=bound_ms, library_ms=t_lib,
                               plain_ms=t_plain)
                log(line + f" ({smi})")
                if layout == "scattered":
                    out.update(overlap_swap(cache, pool, s, h, b, ps, t_out + t_in, smi))
        del cache, pool
        torch.cuda.empty_cache()
    return out


def decode_like_load(ms):
    """A load that reads weights as a decode step does: bf16 GEMMs of 16
    tokens through [4096, 28672] (an 8B MLP's width), as many as take about
    `ms`. Returns (load, its GEMMs, its ms alone)."""
    g = torch.Generator(device=DEVICE).manual_seed(37)
    x = torch.randn(16, 4096, dtype=torch.bfloat16, device=DEVICE, generator=g)
    w = torch.randn(4096, 28672, dtype=torch.bfloat16, device=DEVICE, generator=g)
    n = max(1, round(ms / time_ms(lambda: torch.matmul(x, w))))

    def load():
        for _ in range(n):
            torch.matmul(x, w)
    return load, n, time_ms(load, reps=3, warmup=1)


def link_shares(moved, t_out, t_in, rate_out, rate_in) -> str:
    """Each direction's time, its rate and its share of the host link's rate
    that way (link_rates, measured in the same run)."""
    return "; ".join(
        f"{way} {t:.4f} ms, {moved / (1e-3 * t) / 1e9:.2f} GB/s, "
        f"{100 * moved / (1e-3 * t) / rate:.1f}% of the link's {what}"
        for way, t, rate, what in (("out", t_out, rate_out, "card -> pinned"),
                                   ("in", t_in, rate_in, "pinned -> card")))


def swap_lists(rng, n_dev, n_host):
    """SWAP_N pages out and back in to other device pages, scattered and
    consecutive: {layout: (cache pages, pool pages, cache pages back)}."""
    src = rng.permutation(n_dev)[:SWAP_N]
    return {"scattered": (src, rng.permutation(n_host)[:SWAP_N],
                          rng.permutation(np.setdiff1d(np.arange(n_dev), src))[:SWAP_N]),
            "consecutive": (np.arange(100, 100 + SWAP_N), np.arange(SWAP_N),
                            np.arange(300, 300 + SWAP_N))}


def mover_setup():
    """An 8B bf16 cache of 1,024 pages of 16 and a pinned pool of 512 (64 KiB
    a page and layer), seeded, the page lists (swap_lists) and the bytes a
    way of SWAP_N pages, beside the host link's rate each way (link_rates)."""
    rate_in, rate_out = link_rates()
    ps, W, n_dev, n_host = 16, 2 * 8 * 128, 1024, 512
    g = torch.Generator(device=DEVICE).manual_seed(31)
    cache = torch.empty(32, n_dev * ps, W, dtype=torch.bfloat16, device=DEVICE)
    cache.view(torch.uint8).random_(0, 256, generator=g)
    pool = pinned_pool((32, n_host * ps, W), torch.bfloat16)
    pool.view(torch.uint8).random_(0, 256, generator=torch.Generator().manual_seed(3))
    lists = swap_lists(np.random.default_rng(31), n_dev, n_host)
    return rate_in, rate_out, ps, cache, pool, lists, SWAP_N * 32 * ps * W * 2


def sweep_swap(smi):
    """--sweep-swap: the page mover's grid (MOVER_BLOCKS) on SWAP_N
    scattered 8B bf16 pages (mover_setup): each way at several grids against
    cudaMemcpy2DAsync per run and the host link's rate measured here, every
    swap-in's pages checked; consecutive pages in; then round trips at
    those grids alone and on a side stream beside a decode-like load."""
    rate_in, rate_out, ps, cache, pool, lists, moved = mover_setup()
    s, h, b = lists["scattered"]
    gbs = lambda t: f"{moved / (1e-3 * t) / 1e9:.2f} GB/s"  # noqa: E731
    t_lib_out = time_ms(lambda: copy_page_runs(cache, pool, s, h, ps))
    t_lib_in = time_ms(lambda: copy_page_runs(pool, cache, h, b, ps))
    log(f"[sweep swap] link pinned -> card {rate_in / 1e9:.2f} GB/s, card -> "
        f"pinned {rate_out / 1e9:.2f} GB/s; {SWAP_N} scattered pages, "
        f"{moved / 2**20:.0f} MiB a way; cudaMemcpy2DAsync per run: out "
        f"{t_lib_out:.4f} ms ({gbs(t_lib_out)}), in {t_lib_in:.4f} ms "
        f"({gbs(t_lib_in)}) ({smi})")
    want_in = _page_bytes_of(pool, h, ps).to(DEVICE)
    rows_in = page_slots(b, ps).to(DEVICE)
    grids = (32, 16, 8, 4)
    for way, src, dst, sp_, dp_, rate in (("in", pool, cache, h, b, rate_in),
                                          ("out", cache, pool, s, h, rate_out)):
        parts = []
        for blocks in grids:
            if way == "in":
                cache.index_fill_(1, rows_in, 0)
            t = time_ms(lambda: swap_pages(src, dst, sp_, dp_, ps, blocks=blocks))
            if way == "in":
                assert torch.equal(_page_bytes_of(cache, b, ps), want_in), blocks
            parts.append(f"{blocks} blocks {t:.4f} ms ({gbs(t)}, "
                         f"{100 * moved / (1e-3 * t) / rate:.1f}%)")
        log(f"[sweep swap] {way}: " + "; ".join(parts) + f" ({smi})")
    sc, hc, bc = lists["consecutive"]
    t_in = time_ms(lambda: swap_pages(pool, cache, hc, bc, ps))
    t_lib = time_ms(lambda: copy_page_runs(pool, cache, hc, bc, ps))
    log(f"[sweep swap] consecutive pages in: swap_pages {t_in:.4f} ms "
        f"({gbs(t_in)}), cudaMemcpy2DAsync per run {t_lib:.4f} ms ({gbs(t_lib)}) "
        f"({smi})")
    lib = lambda: (copy_page_runs(cache, pool, s, h, ps),  # noqa: E731
                   copy_page_runs(pool, cache, h, b, ps))
    load, n, alone = decode_like_load(time_ms(lib))
    m, ld, sw = overlap_ms(load, lib)
    log(f"[sweep swap] beside a decode-like load ({n} GEMMs, {alone:.4f} ms "
        f"alone): cudaMemcpy2DAsync per run makespan {m:.4f} ms, load {ld:.4f} "
        f"(+{100 * (ld / alone - 1):.1f}%), swap {sw:.4f} ({smi})")
    for blocks in grids:
        def trip():
            swap_pages(cache, pool, s, h, ps, blocks=blocks)
            swap_pages(pool, cache, h, b, ps, blocks=blocks)
        t = time_ms(trip)
        m, ld, sw = overlap_ms(load, trip)
        log(f"[sweep swap] mover round trip, {blocks} blocks each way: {t:.4f} ms "
            f"alone; beside the load makespan {m:.4f} ms, load {ld:.4f} "
            f"(+{100 * (ld / alone - 1):.1f}%), swap {sw:.4f} ({smi})")


def compare_swap_norm(smi):
    """--compare-swap-norm: the page mover and add_rms_norm through their
    wrappers alone (swap_pages(src, dst, src_pages, dst_pages, page_size)
    and add_rms_norm(x, r, w, eps)), so that this script copied into an
    earlier checkout times that checkout's kernels: run the two in turns
    (parent, change, change, parent) to compare builds on one card. The
    mover: a round trip of SWAP_N 8B bf16 pages (mover_setup), scattered and
    consecutive, each direction against the host link's rate measured here
    and cudaMemcpy2DAsync per run, then beside a decode-like load
    (overlap_swap).
    add_rms_norm: at 8B width T = 1, 16, 128, 2,048 and Qwen2-0.5B's T = 1,
    128, back to back (time_ms) and after a kernel of another kind
    (time_alone_ms)."""
    rate_in, rate_out, ps, cache, pool, lists, moved = mover_setup()
    for layout, (s, h, b) in lists.items():
        t_out = time_ms(lambda: swap_pages(cache, pool, s, h, ps))
        t_in = time_ms(lambda: swap_pages(pool, cache, h, b, ps))
        l_out = time_ms(lambda: copy_page_runs(cache, pool, s, h, ps))
        l_in = time_ms(lambda: copy_page_runs(pool, cache, h, b, ps))
        log(f"[compare swap] {layout}: mover round trip {t_out + t_in:.4f} ms "
            f"({link_shares(moved, t_out, t_in, rate_out, rate_in)}); "
            f"cudaMemcpy2DAsync per run {l_out + l_in:.4f} ms (out {l_out:.4f}, "
            f"in {l_in:.4f}); link {rate_in / 1e9:.2f} / {rate_out / 1e9:.2f} GB/s "
            f"({smi})")
        if layout == "scattered":
            overlap_swap(cache, pool, s, h, b, ps, t_out + t_in, smi)
    del cache, pool
    torch.cuda.empty_cache()
    gen = torch.Generator(device=DEVICE).manual_seed(13)
    parts = []
    for widths, name, ts in ((LLAMA3_8B, "8B", LAYER_TS), (QWEN2_05B, "Qwen2-0.5B", (1, 128))):
        mc = LlamaModelConfig(num_layers=1, **widths)
        for T in ts:
            a = layer_inputs(gen, mc, T, DEVICE)
            x, r, w = a["x"], a["r"], a["w"]
            fn = lambda: lo.add_rms_norm(x, r, w, mc.rms_norm_eps)  # noqa: E731
            parts.append(f"{name} T={T} {time_ms(fn):.4f} back to back, "
                         f"{time_alone_ms(fn):.4f} after a kernel")
    log(f"[compare] add_rms_norm: {'; '.join(parts)} ms ({smi})")


# --compare-rope's span-write shapes at 8B width: (label, T, spans of
# prefill-kind tokens as (first token, tokens)); the other tokens -1. The
# phase-2 mixed step: 8 decode rows, then chunks of 512, 512 and 300 from
# token 128 on (the batch builder's alignment).
FOLD_SHAPES = (("T=128 prefill-kind", 128, ((0, 128),)),
               ("mixed step", 2048, ((128, 512), (640, 512), (1152, 300))),
               ("T=2,048 prefill-kind", 2048, ((0, 2048),)))


def compare_rope(smi):
    """--compare-rope: the rope kernel, the fp8 row build and the span write
    through their wrappers alone, so that this script copied into an
    earlier checkout times that checkout's kernels: run the two in turns
    (parent, change, change, parent) to compare builds on one card. The fp8
    row is rope_qkv_fp8 where the checkout has it, else the pair that built
    it before, rope_qkv(split=True) then quantize_kv. Without slots at 8B
    width T = 1, 16, 128, 2,048, and at Qwen2-0.5B's, Llama-2-7B's and
    Llama-2-13B's T = 1, 128; then the span write at 8B width on
    FOLD_SHAPES, bf16 and fp8: the rope kernel with the slots where the
    checkout folds it in, else the pair that wrote the rows before, the rope
    kernel then store_kv. Back to back (time_ms) and after a kernel of
    another kind (time_alone_ms)."""
    fused = hasattr(lo, "rope_qkv_fp8")
    folds = "slots" in inspect.signature(lo.rope_qkv).parameters
    gen = torch.Generator(device=DEVICE).manual_seed(13)
    for name, widths, ts in (("8B", LLAMA3_8B, LAYER_TS),
                             ("Qwen2-0.5B", QWEN2_05B, (1, 128)),
                             ("Llama-2-7B", LLAMA2_7B, (1, 128)),
                             ("Llama-2-13B", LLAMA2_13B, (1, 128))):
        mc = LlamaModelConfig(num_layers=1, **widths)
        for T in ts:
            a = layer_inputs(gen, mc, T, DEVICE)
            args = (a["q"], a["k"], a["v"], a["tables"], a["bias"])
            fns = {"rope_qkv": lambda: lo.rope_qkv(*args)}
            if fused:
                fns["rope_qkv_fp8"] = lambda: lo.rope_qkv_fp8(*args)
            else:       # only in a checkout from before rope_qkv_fp8
                fns["rope_qkv(split) + quantize_kv"] = lambda: qkv.quantize_kv(
                    *lo.rope_qkv(*args, split=True)[1])
            parts = [f"{k} {time_ms(fn):.4f} back to back, {time_alone_ms(fn):.4f} "
                     "after a kernel" for k, fn in fns.items()]
            log(f"[compare rope] {name} T={T}: {'; '.join(parts)} ms ({smi})")
    mc = LlamaModelConfig(num_layers=1, **LLAMA3_8B)
    KH = mc.num_kv_heads * mc.head_dim
    for label, T, spans in FOLD_SHAPES:
        a = layer_inputs(gen, mc, T, DEVICE)
        args = (a["q"], a["k"], a["v"], a["tables"], None)
        pool, S = fold_slots(gen, 2048, edges=False)
        slots = torch.full((T,), -1, dtype=torch.int32, device=DEVICE)
        at = 0
        for first, n in spans:
            slots[first:first + n] = pool[at:at + n]
            at += n
        parts = []
        for rope, cache in (
                (lo.rope_qkv, torch.zeros(2, S, 2 * KH, dtype=torch.bfloat16, device=DEVICE)),
                (lo.rope_qkv_fp8, torch.zeros(2, S, 2 * KH + pa.FP8_SCALE_LANES,
                                              dtype=pa.FP8, device=DEVICE))):
            if folds:
                fn = lambda: rope(*args, cache=cache, slots=slots, layer=1)  # noqa: E731
                what = f"{rope.__name__} with slots"
            else:       # only in a checkout from before the fold
                fn = lambda: pa.store_kv(cache, rope(*args)[1], slots, 1)  # noqa: E731
                what = f"{rope.__name__} + store_kv"
            parts.append(f"{what} {time_ms(fn):.4f} back to back, "
                         f"{time_alone_ms(fn):.4f} after a kernel")
        log(f"[compare fold] 8B {label} ({int((slots >= 0).sum())} of {T} tokens "
            f"written to the cache): {'; '.join(parts)} ms ({smi})")


def overlap_swap(cache, pool, s, h, b, ps, swap_ms, smi) -> dict:
    """A round trip of pages (s -> h -> b) beside a decode-like load: bf16
    GEMMs of 16 tokens through an 8B MLP's weights ([4096, 28672], read
    from HBM each time), as many as take about as long as the round trip.
    The mover and cudaMemcpy2DAsync per run each on a side stream against
    the load alone: how far each stretches the load (the mover takes SMs,
    the copies only the copy engines and memory bandwidth) and the
    makespan."""
    load, n, alone = decode_like_load(swap_ms)
    got = {}
    for name, fn in (("mover", swap_pages),
                     ("cudaMemcpy2DAsync per run", copy_page_runs)):
        got[name] = overlap_ms(load, lambda: (fn(cache, pool, s, h, ps),
                                              fn(pool, cache, h, b, ps)))
    log(f"[swap] a round trip beside a decode-like load ({n} GEMMs [16, 4096] "
        f"x [4096, 28672] bf16 on the step's stream, {alone:.4f} ms alone; "
        f"the swap on a side stream, both started together): "
        + "; ".join(f"{k}: makespan {m:.4f} ms, load {ld:.4f} ms "
                    f"(+{100 * (ld / alone - 1):.1f}%), swap {sw:.4f} ms"
                    for k, (m, ld, sw) in got.items()) + f" ({smi})")
    return {"overlap_load_ms": alone,
            "overlap_ms": {k: dict(makespan=m, load=ld, swap=sw)
                           for k, (m, ld, sw) in got.items()}}


# ---------------------------------------------------------------------------
# Phases 3-5: the model, the engine, HTTP
# ---------------------------------------------------------------------------

LLAMA3_8B = dict(num_q_heads=32, num_kv_heads=8, hidden_size=4096, head_dim=128,
                 ffn_inter_dim=14336, vocab_size=128256,
                 max_position_embeddings=8192, rms_norm_eps=1e-5,
                 rope_theta=500000.0)
# The same widths with the long context of meta-llama/Llama-3.1-8B's config:
# the fp8-KV engine serves a prompt past 16Ki tokens.
LLAMA31_8B = dict(LLAMA3_8B, max_position_embeddings=131072, rope_scaling=dict(
    rope_type="llama3", factor=8.0, low_freq_factor=1.0, high_freq_factor=4.0,
    original_max_position_embeddings=8192))
# mistralai/Mistral-7B-v0.1's config.json.
MISTRAL_7B = dict(num_q_heads=32, num_kv_heads=8, hidden_size=4096, head_dim=128,
                  ffn_inter_dim=14336, vocab_size=32000,
                  max_position_embeddings=32768, rms_norm_eps=1e-5,
                  rope_theta=10000.0, sliding_window=4096)


def _requests(specs, vocab, out_len=4):
    """(prompt_len, cached, n_tokens) -> port Requests scheduled for one step;
    cached tokens stand for a history already in the cache, with one output
    token to feed next when cached == prompt_len."""
    top = min(120000, vocab - 1)
    sched = []
    for i, (plen, cached, n) in enumerate(specs):
        r = Request(RawRequest("", out_len))
        r.set_prompt_token_ids([(31 * i + 7 * j) % top + 1 for j in range(plen)])
        if cached == plen:
            r.output_token_ids = [17 + i]
        r.num_cached_tokens = cached
        r.seq_id = i
        sched.append(ScheduledSeq(r, n))
    return sched


def seeded_weights(mc, quant: str = "none", seed: int = 0, std: float = 0.02,
                   mesh=SINGLE, successor: bool = False) -> dict:
    """One rank's shard (the whole model with `mesh` SINGLE) of weights
    whose whole values do not depend on tp: every weight drawn whole, one
    layer at a time, from a generator seeded by (seed, weight, layer), then
    quantized for `quant` and cut to the shard (weights.build_shard).
    Projections, embeddings and lm_head N(0, std), unit norms. With
    `successor`, the successor model (see successor()): embeddings N(0, 1)
    and lm_head row succ(t) = embed row t."""
    shapes = weights.weight_shapes(mc)
    keys = list(shapes)

    def draw(key, i):
        g = torch.Generator(device=DEVICE).manual_seed(
            seed * 1_000_003 + keys.index(key) * 1009 + (i or 0))
        return torch.empty(shapes[key], device=DEVICE).normal_(
            0.0, 1.0 if key == "embed" and successor else std, generator=g)

    def get(key, i):
        if "norm" in key:
            return torch.ones(shapes[key], device=DEVICE)
        if key == "lm_head" and successor:
            r = torch.arange(shapes[key][0], device=DEVICE)
            return draw("embed", None)[(r & ~7) | ((r - 1) & 7)]
        return draw(key, i)
    if successor:
        assert mc.vocab_size % 8 == 0 and not mc.tie_word_embeddings
    params = weights.build_shard(mc, quant, torch.bfloat16, mesh, get,
                                 cast_first=False)
    params["inv_freq"] = torch.from_numpy(compute_inv_freq(mc)).to(DEVICE)
    return params


@contextlib.contextmanager
def loading(seed: int, std: float = 0.02, successor: bool = False):
    """Every LlamaModel built meanwhile in this process loads
    seeded_weights(seed, std, successor) for its shard (LoRA adapters are
    still read from lora_paths)."""
    real = weights.load_params
    weights.load_params = lambda ec, mc, device, mesh: seeded_weights(
        mc, ec.quant, seed, std, mesh, successor)
    try:
        yield
    finally:
        weights.load_params = real


def layer_launches(layers: int, fp8: bool = False) -> dict:
    """The layer kernels' launches in one step of `layers` layers: with an
    fp8 cache rope_qkv_fp8 in place of rope_qkv."""
    return dict(add_rms_norm=2 * layers + 1, rope_qkv=0 if fp8 else layers,
                rope_qkv_fp8=layers if fp8 else 0, silu_mul=layers)


class WeightConversions(TorchDispatchMode):
    """Counts the dtype conversions of int8 tensors of at least 2^20
    elements (a quantized weight's: no activation is int8) that run while it
    is on: quant.proj's, which the weight kernels exist to avoid."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten._to_copy.default, torch.ops.aten.copy_.default):
            src = args[1] if func is torch.ops.aten.copy_.default else args[0]
            if src.dtype == torch.int8 and src.numel() >= 2**20:
                self.n += 1
        return func(*args, **(kwargs or {}))


def phase_step(quant="none", kv_quant="none", mistral=False, chunk=None):
    """One mixed step at 8B width, 4 layers: kernels against plain versions on
    the same weights (std 0.02 from a seeded generator, unit norms) and the
    same random cache. Greedy tokens must agree on every row whose top-2
    margin in the plain run exceeds twice the largest logit difference. With
    INT4 or INT8 weights two steps: 8 decode rows and a 128-token chunk, a
    bucket of 256 tokens, then with a 300-token chunk, a bucket of 512 (the
    weight kernels' wide configuration); the kernel runs send every
    projection and the head through the weight kernel (int4_matmul,
    int8_matmul), and no int8 weight is converted (WeightConversions), while
    the plain runs send them through quant.proj, which converts every one; a
    third run, the other kernels with the weight kernel's plain version,
    isolates it, under the same rule. With
    kv_quant="fp8" the cache holds quantized rows (pages of 32), and the
    kernel runs build the step's rows in rope_qkv_fp8's launch, once a layer
    (no other launch builds them). Every kernel run launches add_rms_norm
    2L + 1 times, rope_qkv (with an fp8 cache rope_qkv_fp8) and silu_mul L
    times (layer_launches), the plain run none of them. With
    `mistral` the widths and the window of 4096 are Mistral-7B-v0.1's, and
    three rows' histories exceed the window: decode rows of 4,097 and 5,000
    keys and a chunk after 5,488."""
    if quant != "none" and chunk is None:
        for n in (128, 300):
            phase_step(quant, kv_quant, chunk=n)
        return
    mc = LlamaModelConfig(num_layers=4, **(MISTRAL_7B if mistral else LLAMA3_8B))
    ec = dict(model_path="", use_dummy=True, dtype="bfloat16", quant=quant,
              kv_quant=kv_quant, block_size=32 if kv_quant == "fp8" else 16,
              preemption_mode="recompute", num_hbm_blocks=1024,
              max_blocks_per_seq=128, max_batch_size=16)
    specs = [(40 + 97 * i, 40 + 97 * i, 1) for i in range(8)]
    specs += ([(512, 0, 512), (1600, 1024, 512), (812, 512, 300)]
              if quant == "none" else [(812, 512, chunk)])
    if mistral:
        ec.update(num_hbm_blocks=2048, max_blocks_per_seq=512, max_batch_size=8)
        specs = [(n, n, 1) for n in (40, 500, 4096, 4999)]
        specs += [(512, 0, 512), (6000, 5488, 512), (812, 512, 300)]
    what = (f"{'Mistral-7B' if mistral else '8B'} width, 4 layers, quant {quant}, "
            f"kv_quant {kv_quant}, window {mc.sliding_window or 0}")
    # (run, use_pallas): the kernels; the plain versions; and, with quantized
    # weights, the other kernels with the weight kernel's plain version,
    # which isolates it (the same f32 sums and roundings).
    runs = [("kernels", True), ("plain", False)]
    weight_kernel = {"int4": (im, "int4_proj_stacked", "int4_matmul"),
                     "int8": (im8, "int8_proj_stacked", "int8_matmul")}.get(quant)
    if weight_kernel:
        runs.append((f"{quant} plain", True))
    logits, models, launches, conversions = {}, {}, {}, {}
    for run, use_kernels in runs:
        m = LlamaModel(EngineConfig(**ec, use_pallas=use_kernels), mc,
                       device=DEVICE)
        if run == "kernels":
            m.params = seeded_weights(mc, quant, seed=1234)
            g = torch.Generator(device=DEVICE).manual_seed(1234)
            m.init_kvcache_and_swap()
            if kv_quant == "fp8":
                KH = mc.num_kv_heads * mc.head_dim
                for layer in m.kv_cache:
                    layer.copy_(fp8_rows(g, layer.shape[0], KH, DEVICE))
            else:
                m.kv_cache.normal_(0.0, 1.0, generator=g)
            cache0 = m.kv_cache.clone()
        else:
            m.params = models["kernels"].params
            m.init_kvcache_and_swap()
            m.kv_cache.copy_(cache0)
        for i, (_, cached, _) in enumerate(specs):
            if cached:
                m.hbm_block_mgrs[0].allocate_for_seq(i, cached)
        build.reset_launch_counts()
        if weight_kernel:
            mod, fn, kernel = weight_kernel
            wrapper = getattr(mod, fn)
        if run.endswith(" plain"):
            setattr(mod, fn, {"int8": im8.int8_proj_stacked_plain,
                              "int4": im.int4_proj_plain}[quant])
        spy = WeightConversions()
        try:
            with spy:
                tokens, rows, lg = m.forward(_requests(specs, mc.vocab_size),
                                             return_logits=True)
        finally:
            if weight_kernel:
                setattr(mod, fn, wrapper)
        torch.cuda.synchronize()
        launches[run] = dict(build.launch_counts)
        if weight_kernel:
            # Every projection of every layer, and the head; on the kernel
            # route no int8 weight is converted, on quant.proj's every one
            # (the weight kernel's plain version converts too).
            want = 7 * mc.num_layers + 1 if run == "kernels" else 0
            assert launches[run][kernel] == want, (run, launches[run])
            assert (spy.n == 0 if run == "kernels" else
                    run != "plain" or spy.n >= 7 * mc.num_layers), (run, spy.n)
            conversions[run] = spy.n
        # The layer's elementwise work: two norms a layer and the final
        # one, one rope_qkv (or rope_qkv_fp8) and one silu_mul a layer; none
        # on the plain run. No other kernel is launched for an fp8 row.
        want = (layer_launches(mc.num_layers, kv_quant == "fp8") if use_kernels
                else dict.fromkeys(lo.KERNELS, 0))
        assert {k: launches[run][k] for k in lo.KERNELS} == want, (run, launches[run])
        live = [i for i, r in enumerate(rows) if r is not None]
        logits[run] = torch.from_numpy(lg[live])
        models[run] = m
        if run == "kernels" and quant == "int8":
            # The same step again is its graph's replay (its first use ran
            # eagerly, then was captured): int8_matmul's programmatic
            # launches must give the eager step's bits under the graph too.
            replays = lambda: sum(e.replays for e in m.graphs.table.values())
            r0 = replays()
            _, _, lg2 = m.forward(_requests(specs, mc.vocab_size), return_logits=True)
            torch.cuda.synchronize()
            assert replays() == r0 + 1, (r0, replays())
            assert np.array_equal(lg2[live], lg[live]), "the INT8 step's replay differs"
            log(f"[step] {quant} step, {m.last_key.tokens} tokens: the graph's replay "
                f"gives the eager step's logits bit for bit")
    a = logits["kernels"]
    assert torch.isfinite(a).all()
    for run, _ in runs[1:]:
        b = logits[run]
        assert torch.isfinite(b).all()
        diff = (a - b).abs().max().item()
        top2 = b.topk(2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        checked = margin > 2 * diff
        agree = a.argmax(-1) == b.argmax(-1)
        assert bool(agree[checked].all()), f"greedy tokens differ on a clear-margin row ({run})"
        log(f"[step] {what}, mixed step of {len(specs)} "
            f"rows ({models['kernels'].last_key.tokens} tokens; kernel launches "
            f"{launches['kernels']}), kernels against {run}: max |logit diff| "
            f"{diff:.4g} (logit std {b.std().item():.4g}); greedy tokens agree on "
            f"{int(agree.sum())}/{len(agree)} rows, {int(checked.sum())} rows "
            f"with margin > 2x diff all agree"
            + (f"; int8 weights converted: kernels {conversions['kernels']}, "
               f"{run} {conversions[run]}" if weight_kernel else ""))
    del models, logits, cache0
    torch.cuda.empty_cache()


# A top-2 logit margin counts as clear above twice the largest
# kernels-against-plain logit difference the step phases above measure
# (about 0.1 at these widths and weights).
CLEAR_MARGIN = 0.2


def last_head_zeroed(fn, group):
    """The planted fault of phase_qwen2_step: attention `fn` with the output
    of each kv head's last query head (the group's last head row, the one
    that a kernel tiled for a group of 8 holds beside its dead row) zero."""
    def call(*a, **kw):
        out = fn(*a, **kw)
        out[:, group - 1::group] = 0
        return out
    return call


def phase_qwen2_step():
    """Fault F2 in a step's values: Qwen2-0.5B's widths (QWEN2_05B: 14 query
    heads over 2 kv heads, a GQA group of 7, head_dim 64, q/k/v biases),
    4 layers, bf16, weights std 0.02 from a seeded generator (seeded_weights,
    biases included), a random cache. Two steps: 8 decode rows (a decode
    bucket: the decode kernel alone), then the 8 rows and two prefill
    chunks (a prefill bucket: both attention kernels, the rows written by
    the rope kernel), each
    with the kernels and with their plain versions from the same cache.
    Logits within CLEAR_MARGIN / 2 of the plain step's (the bound of the
    verify and graph steps), greedy tokens equal on every row whose top-2
    margin is clear of twice the difference; a planted fault
    (last_head_zeroed in both attention kernels) must exceed the bound."""
    mc = LlamaModelConfig(num_layers=4, **QWEN2_05B)
    group = mc.num_q_heads // mc.num_kv_heads
    ec = dict(model_path="", use_dummy=True, dtype="bfloat16",
              preemption_mode="recompute", num_hbm_blocks=1024,
              max_blocks_per_seq=128, max_batch_size=16)
    decode = [(40 + 97 * i, 40 + 97 * i, 1) for i in range(8)]
    steps = {"decode step": decode,
             "mixed step": decode + [(512, 0, 512), (812, 512, 300)]}
    params = cache0 = None
    for name, specs in steps.items():
        logits, tokens, launches = {}, {}, {}
        for run in ("kernels", "plain", "fault"):
            m = LlamaModel(EngineConfig(**ec, use_pallas=run != "plain"), mc,
                           device=DEVICE)
            if params is None:
                params = seeded_weights(mc, seed=777)
                assert "bq" in params["layers"], "no q/k/v biases"
            m.params = params
            m.init_kvcache_and_swap()
            if cache0 is None:
                g = torch.Generator(device=DEVICE).manual_seed(777)
                m.kv_cache.normal_(0.0, 1.0, generator=g)
                cache0 = m.kv_cache.clone()
            m.kv_cache.copy_(cache0)
            for i, (_, cached, _) in enumerate(specs):
                if cached:
                    m.hbm_block_mgrs[0].allocate_for_seq(i, cached)
            real = pa.paged_decode_attention, pa.paged_prefill_attention
            if run == "fault":
                pa.paged_decode_attention = last_head_zeroed(real[0], group)
                pa.paged_prefill_attention = last_head_zeroed(real[1], group)
            build.reset_launch_counts()
            try:
                _, rows, lg = m.forward(_requests(specs, mc.vocab_size),
                                        return_logits=True)
            finally:
                pa.paged_decode_attention, pa.paged_prefill_attention = real
            torch.cuda.synchronize()
            launches[run] = {k: v for k, v in build.launch_counts.items() if v}
            live = [i for i, r in enumerate(rows) if r is not None]
            logits[run] = torch.from_numpy(lg[live])
            tokens[run] = m.last_key.tokens
            del m
        a, b, f = logits["kernels"], logits["plain"], logits["fault"]
        assert torch.isfinite(a).all() and torch.isfinite(b).all()
        diff = (a - b).abs().max().item()
        fault = (f - b).abs().max().item()
        limit = CLEAR_MARGIN / 2
        log(f"[step qwen2] Qwen2-0.5B width (14 / 2 heads, group {group}, head_dim "
            f"64, biases), 4 layers, {name} of {len(specs)} rows "
            f"({tokens['kernels']} tokens; launches {launches['kernels']}), "
            f"kernels against plain: max |logit diff| {diff:.4g} (logit std "
            f"{b.std().item():.4g}, bound {limit}); greedy tokens agree on "
            f"{int((a.argmax(-1) == b.argmax(-1)).sum())}/{len(a)} rows; the "
            f"planted fault (each group's last head zero): {fault:.4g}")
        want = {"paged_decode_attention": mc.num_layers, "rope_qkv": mc.num_layers}
        if name == "mixed step":
            want.update(paged_prefill_attention=mc.num_layers)
        got = {k: launches["kernels"].get(k, 0) for k in
               ("paged_decode_attention", "rope_qkv", "paged_prefill_attention")}
        assert got == dict.fromkeys(got, 0) | want, launches["kernels"]
        assert not launches["plain"], launches["plain"]
        assert diff <= limit and greedy_agrees(a, b, diff), (name, diff)
        assert fault > limit, f"the bound lets the planted fault pass ({name}, {fault})"
    del params, cache0
    torch.cuda.empty_cache()


def phase_multi_step():
    """S = 8 decode steps of 8 rows at 8B width, 4 layers, through the
    kernels: 8 sequential single steps, then one multi-step window with the
    fused write, then one with deferred commit (SWIFTLLM_DEFER_KV=1), on the
    same weights and the same random cache. A row's tokens must equal the
    sequential run's up to its first step without a clear top-2 margin in
    the sequential logits, and the window's cache rows of every row that
    agrees throughout must be byte-equal after the commit. Launches: 4 a
    step of the default variant, or of the `pend` variant when deferred."""
    S = PEND_S
    mc = LlamaModelConfig(num_layers=4, **LLAMA3_8B)
    ec = dict(model_path="", use_dummy=True, dtype="bfloat16", block_size=16,
              preemption_mode="recompute", num_hbm_blocks=1024,
              max_blocks_per_seq=128, max_batch_size=16, enable_logprobs=True)
    hists = [40 + 97 * i for i in range(8)]          # 137 + 8 crosses a page
    n = len(hists)
    toks, lps, caches, first = {}, {}, {}, None
    margin = None
    for run in ("sequential", "fused", "deferred"):
        steps = 1 if run == "sequential" else S
        m = LlamaModel(EngineConfig(**ec, multi_step_decode=steps), mc,
                       device=DEVICE)
        if first is None:
            m.params = seeded_weights(mc, seed=4321)
            g = torch.Generator(device=DEVICE).manual_seed(4321)
            m.init_kvcache_and_swap()
            m.kv_cache.normal_(0.0, 1.0, generator=g)
            cache0 = m.kv_cache.clone()
            first = m
        else:
            m.params = first.params
            m.init_kvcache_and_swap()
            m.kv_cache.copy_(cache0)
        mgr = m.hbm_block_mgrs[0]
        for i, h in enumerate(hists):
            mgr.allocate_for_seq(i, h)
        sched = _requests([(h, h, 1) for h in hists], mc.vocab_size, out_len=64)
        os.environ["SWIFTLLM_DEFER_KV"] = "1" if run == "deferred" else "0"
        build.reset_launch_counts()
        try:
            if run == "sequential":
                t, lp, mg = [], [], []
                for _ in range(S):
                    tokens, rows, lg = m.forward(sched, return_logits=True)
                    assert [r is not None for r in rows[:n]] == [True] * n
                    lp.append(m.last_logprobs.numpy()[:n])
                    top2 = torch.from_numpy(lg[:n]).topk(2, dim=-1).values
                    mg.append((top2[:, 0] - top2[:, 1]).numpy())
                    t.append(tokens[:n])
                    for sq, tok in zip(sched, tokens[:n]):
                        sq.request.output_token_ids.append(int(tok))
                        sq.request.num_cached_tokens += 1
                toks[run], lps[run] = np.stack(t, 1), np.stack(lp, 1)
                margin = np.stack(mg, 1)                              # [n, S]
            else:
                tokens, rows = m.forward(sched, multi_step=S)
                assert [r is not None for r in rows[:n]] == [True] * n
                toks[run] = tokens.reshape(-1, S)[:n]
                lps[run] = m.last_logprobs.numpy().reshape(-1, S)[:n]
        finally:
            os.environ.pop("SWIFTLLM_DEFER_KV")
        torch.cuda.synchronize()
        launches = dict(build.launch_counts)
        want = {"paged_decode_attention": 0 if run == "deferred" else 4 * S,
                "paged_decode_attention_pend": 4 * S if run == "deferred" else 0,
                "paged_prefill_attention": 0}
        assert {k: launches[k] for k in want} == want, (run, launches)
        # The window's cache rows: positions hist .. hist + S - 1 of each row.
        slots = [[int(mgr.seq_block_ids(i)[p // 16]) * 16 + p % 16
                  for p in range(h, h + S)] for i, h in enumerate(hists)]
        caches[run] = torch.stack([m.kv_cache[:, sl] for sl in slots])  # [n, L, S, W]
        assert np.isfinite(lps[run]).all() and (lps[run] <= 0).all(), run
        if run != "sequential":
            m.params = None
        del m
    # Steps a row is checked on: up to its first step without a clear margin.
    unclear = margin <= CLEAR_MARGIN
    upto = np.where(unclear.any(1), unclear.argmax(1) + 1, S)
    for run in ("fused", "deferred"):
        same = toks[run] == toks["sequential"]
        for b in range(n):
            assert same[b, :upto[b]].all(), (
                f"{run}: row {b} differs from the sequential steps before its "
                f"first unclear margin: {toks[run][b]} vs {toks['sequential'][b]}")
        whole = same.all(1)
        for b in np.flatnonzero(whole):
            assert torch.equal(caches[run][b].view(torch.int16),
                               caches["sequential"][b].view(torch.int16)), (
                f"{run}: row {b}'s window differs in the cache")
        dlp = np.abs(lps[run] - lps["sequential"])[same].max()
        log(f"[multi-step] 8B width, 4 layers, {n} rows (histories "
            f"{hists[0]}..{hists[-1]}), S = {S}, {run} against {S} sequential "
            f"steps: {int(same.sum())}/{same.size} tokens equal, "
            f"{int(sum(upto))} required (clear margin > {CLEAR_MARGIN}), "
            f"{int(whole.sum())}/{n} rows equal throughout and their window "
            f"byte-equal in the cache; max |logprob diff| on equal tokens "
            f"{dlp:.3g}")
    del first, caches, cache0
    gc.collect()
    torch.cuda.empty_cache()


def _spec_requests(ids, hists, vocab, drafts=None, fed=None):
    """Decode-stage port Requests of rows `ids`: row i's prompt is hists[i]
    tokens, all cached; its outputs are 17 + i, then fed[i] (tokens already
    fed after it, cached too); it is scheduled with drafts[i] (a verify
    span) or alone."""
    out = []
    for i in ids:
        r = Request(RawRequest("", 64))
        r.set_prompt_token_ids([(31 * i + 7 * j) % min(120000, vocab - 1) + 1
                                for j in range(hists[i])])
        done = list(fed[i]) if fed else []
        r.output_token_ids = [17 + i] + done
        r.num_cached_tokens = hists[i] + len(done)
        r.seq_id = i
        d = tuple(drafts[i]) if drafts else ()
        out.append(ScheduledSeq(r, 1 + len(d), drafts=d))
    return out


def phase_verify_step():
    """One speculative verify step at 8B width, 4 layers: 2 decode rows and
    6 spec rows (drafts of 2 to 4 tokens, random) over histories of 40 to
    719 keys, through the kernels and through the plain versions, on the
    same weights and cache. Logits within CLEAR_MARGIN / 2 of each other,
    per-position tokens equal where the plain run's top-2 margin exceeds
    CLEAR_MARGIN. Then the same rows through 5 sequential single decode
    steps (kernels), fed the same drafts: each row's verify tokens must equal
    the sequential ones up to its first step without a clear margin."""
    mc = LlamaModelConfig(num_layers=4, **LLAMA3_8B)
    ec = dict(model_path="", use_dummy=True, dtype="bfloat16", block_size=16,
              preemption_mode="recompute", num_hbm_blocks=1024,
              max_blocks_per_seq=128, max_batch_size=16, enable_spec_decode=True,
              spec_k=SPEC_K)
    hists = [40 + 97 * i for i in range(8)]
    rng = np.random.default_rng(12)
    drafts = [()] * 2 + [tuple(int(t) for t in rng.integers(1, 120000, 2 + i % 3))
                         for i in range(6)]
    n = len(hists)
    out = {}
    first = None
    for run, use_kernels in (("kernels", True), ("plain", False)):
        m = LlamaModel(EngineConfig(**ec, use_pallas=use_kernels), mc, device=DEVICE)
        if first is None:
            m.params = seeded_weights(mc, seed=2468)
            g = torch.Generator(device=DEVICE).manual_seed(2468)
            m.init_kvcache_and_swap()
            m.kv_cache.normal_(0.0, 1.0, generator=g)
            cache0 = m.kv_cache.clone()
            first = m
        else:
            m.params = first.params
            m.init_kvcache_and_swap()
            m.kv_cache.copy_(cache0)
        for i, h in enumerate(hists):
            m.hbm_block_mgrs[0].allocate_for_seq(i, h)
        build.reset_launch_counts()
        tokens, rows, lg = m.forward(_spec_requests(range(n), hists, mc.vocab_size,
                                                    drafts=drafts), return_logits=True)
        torch.cuda.synchronize()
        assert m.last_key.spec == SPEC_Q and m.last_key.q_len == SPEC_Q
        want = (dict(paged_decode_attention=4, rope_qkv=4, paged_prefill_attention=4)
                if use_kernels else dict(paged_decode_attention=0, rope_qkv=0,
                                         paged_prefill_attention=0))
        assert {k: build.launch_counts[k] for k in want} == want, build.launch_counts
        spans = [r.n_tokens for r in rows[:n]]
        assert [r.request.seq_id for r in rows[:n]] == list(range(n))
        out[run] = (tokens.reshape(-1, SPEC_Q)[:n], torch.from_numpy(lg).view(
            -1, SPEC_Q, lg.shape[-1])[:n])
        if run == "plain":
            m.params = None
        del m
    a, b = out["kernels"][1], out["plain"][1]
    valid = torch.zeros(n, SPEC_Q, dtype=torch.bool)
    for i, sp in enumerate(spans):
        valid[i, :sp] = True
    assert torch.isfinite(a[valid]).all() and torch.isfinite(b[valid]).all()
    diff = (a - b).abs()[valid].max().item()
    top2 = b.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    clear = valid & (margin > CLEAR_MARGIN)
    agree = torch.from_numpy(out["kernels"][0] == out["plain"][0])
    log(f"[verify step] 8B width, 4 layers, 2 decode rows and 6 spec rows "
        f"(spans {spans}), kernels against plain: max |logit diff| {diff:.4g}; "
        f"tokens agree at {int(agree[valid].sum())}/{int(valid.sum())} positions, "
        f"{int(clear.sum())} with margin > {CLEAR_MARGIN} all agree")
    assert diff <= CLEAR_MARGIN / 2, f"verify step logits differ by {diff}"
    assert bool(agree[clear].all()), "verify tokens differ on a clear-margin position"

    # The same rows fed the same tokens, one decode step at a time.
    m = LlamaModel(EngineConfig(**ec, use_pallas=True), mc, device=DEVICE)
    m.params = first.params
    m.init_kvcache_and_swap()
    m.kv_cache.copy_(cache0)
    for i, h in enumerate(hists):
        m.hbm_block_mgrs[0].allocate_for_seq(i, h)
    seq_tok = np.full((n, SPEC_Q), -1)
    seq_margin = np.zeros((n, SPEC_Q))
    for j in range(SPEC_K + 1):
        live = [i for i in range(n) if j < spans[i]]
        sched = _spec_requests(live, hists, mc.vocab_size,
                               fed={i: drafts[i][:j] for i in live})
        tokens, rows, lg = m.forward(sched, return_logits=True)
        top2 = torch.from_numpy(lg).topk(2, dim=-1).values
        for b_, r in enumerate(rows):
            if r is not None:
                i = r.request.seq_id
                seq_tok[i, j] = tokens[b_]
                seq_margin[i, j] = float(top2[b_, 0] - top2[b_, 1])
    ver = out["kernels"][0]
    checked = 0
    for i in range(n):
        for j in range(spans[i]):
            if seq_margin[i, j] <= CLEAR_MARGIN:
                break
            assert ver[i, j] == seq_tok[i, j], (
                f"row {i} position {j}: verify {ver[i, j]}, sequential {seq_tok[i, j]}")
            checked += 1
    same = int(sum((ver[i, :spans[i]] == seq_tok[i, :spans[i]]).sum() for i in range(n)))
    log(f"[verify step] against {SPEC_K + 1} sequential decode steps fed the "
        f"same drafts: {same}/{int(valid.sum())} positions equal, {checked} "
        f"required (up to each row's first margin <= {CLEAR_MARGIN})")
    m.params = None
    del m, first, cache0
    gc.collect()
    torch.cuda.empty_cache()


def phase_prefix_step():
    """Prefix caching through the model at 8B width, 4 layers, on random
    weights (phase_step's kind) and a random cache: three prompts that share
    a 1,024-token prefix, and one prompt that shares nothing, each prefilled
    alone and in full (which registers their pages); then the three again as
    new requests whose pages match_prefix installs (the first prompt's
    prefix pages, and each prompt's own pages past it), their tails of 8 and
    9 tokens prefilled in one step. At each prompt's last position, the
    token the first decode step would take, the matched step's logits must
    be within CLEAR_MARGIN of the full prefill's (the two schedules differ
    in every GEMM's shape and in the attention tile) and its greedy token
    equal where the top-2 margin exceeds twice the difference. These logits
    depend on attention over the installed pages: a planted fault, the other
    prompt's pages installed in their place, must move them past the bound."""
    mc = LlamaModelConfig(num_layers=4, **LLAMA3_8B)
    ec = EngineConfig(model_path="", use_dummy=True, dtype="bfloat16",
                      block_size=16, preemption_mode="recompute",
                      num_hbm_blocks=1024, max_blocks_per_seq=128,
                      max_batch_size=16, enable_prefix_caching=True)
    m = LlamaModel(ec, mc, device=DEVICE)
    m.params = seeded_weights(mc, seed=1357)
    g = torch.Generator(device=DEVICE).manual_seed(1357)
    m.init_kvcache_and_swap()
    m.kv_cache.normal_(0.0, 1.0, generator=g)
    mgr = m.hbm_block_mgrs[0]
    top = min(120000, mc.vocab_size - 1)
    prefix = [(11 * j) % top + 1 for j in range(SPEC_PREFIX)]
    prompts = [prefix + [(2000 + 37 * i + 5 * j) % top + 1 for j in range(n)]
               for i, n in enumerate((40, 57, 9))]
    other = [(17 * j + 3) % top + 1 for j in range(len(prompts[0]))]

    def request(seq_id, ids):
        r = Request(RawRequest("", 4))
        r.set_prompt_token_ids(ids)
        r.seq_id = seq_id
        return r

    def step(reqs):
        """One step of `reqs` (their uncached tails): last-position logits
        by seq_id, and the step's kernel launches."""
        build.reset_launch_counts()
        _, rows, lg = m.forward([ScheduledSeq(r, r.prompt_len - r.num_cached_tokens)
                                 for r in reqs], return_logits=True)
        torch.cuda.synchronize()
        return ({rows[b].request.seq_id: torch.from_numpy(lg[b])
                 for b in range(len(rows)) if rows[b] is not None},
                dict(build.launch_counts))

    full = {}
    for i, ids in enumerate(prompts + [other]):
        full.update(step([request(i, ids)])[0])
    reqs = [request(4 + i, ids) for i, ids in enumerate(prompts)]
    matched = [m.match_prefix(r) for r in reqs]
    assert matched == [1056, 1072, 1024], matched
    shared = [mgr.seq_block_ids(r.seq_id)[:SPEC_PREFIX // 16].tolist() for r in reqs]
    assert shared[1] == shared[2] == shared[0] == mgr.seq_block_ids(0)[:SPEC_PREFIX // 16].tolist()
    got, launches = step(reqs)
    want = dict(paged_decode_attention=4, rope_qkv=4, paged_prefill_attention=4)
    assert {k: launches[k] for k in want} == want, launches
    a = torch.stack([got[4 + i] for i in range(3)])
    b = torch.stack([full[i] for i in range(3)])
    assert torch.isfinite(a).all() and torch.isfinite(b).all()
    diff = (a - b).abs().max().item()
    top2 = b.topk(2, dim=-1).values
    checked = (top2[:, 0] - top2[:, 1]) > 2 * diff
    agree = a.argmax(-1) == b.argmax(-1)
    # The planted fault: prompt 0 again, with the other prompt's pages in
    # place of the 66 it matched.
    bad = request(7, prompts[0])
    n = m.match_prefix(bad)
    mgr.block_table[7, :n // 16] = mgr.block_table[3, :n // 16]
    fault = (step([bad])[0][7] - full[0]).abs().max().item()
    log(f"[prefix step] 8B width, 4 layers: 3 prompts sharing a {SPEC_PREFIX}-token "
        f"prefix, matched {matched} tokens, their tails in one step against "
        f"their full prefills: max |logit diff| {diff:.4g} (logit std "
        f"{b.std().item():.4g}, bound {CLEAR_MARGIN}); greedy tokens agree on "
        f"{int(agree.sum())}/3, {int(checked.sum())} with margin > 2x diff all "
        f"agree; planted fault (another prompt's pages installed): max |logit "
        f"diff| {fault:.4g}")
    assert diff <= CLEAR_MARGIN, f"prefix-matched logits differ by {diff}"
    assert bool(agree[checked].all()), "prefix-matched tokens differ on a clear margin"
    assert fault > CLEAR_MARGIN, "the bound lets a prefix match install the wrong pages"
    m.params = None
    del m
    gc.collect()
    torch.cuda.empty_cache()


# LoRA adapters of the LoRA phases: rank 16 on q, v, o and gate of every
# layer, the halves N(0, 0.02) (a trained adapter's scale, not the dummy
# adapters' 2.0), alpha 32 (scale alpha / r = 2).
LORA_RANK, LORA_ALPHA, LORA_STD = 16, 32, 0.02
LORA_MODULES = {"q_proj": "self_attn", "v_proj": "self_attn",
                "o_proj": "self_attn", "gate_proj": "mlp"}


def write_peft_adapter(path: Path, widths: dict, layers: int, seed: int):
    """A peft checkpoint (adapter_config.json and adapter_model.safetensors,
    f32) of LORA_RANK on LORA_MODULES, drawn on the card from `seed`. The
    safetensors file is written by hand (an 8-byte header length, the JSON
    header, the raw little-endian data)."""
    D, hd = widths["hidden_size"], widths["head_dim"]
    dims = {"q_proj": (D, widths["num_q_heads"] * hd),
            "v_proj": (D, widths["num_kv_heads"] * hd),
            "o_proj": (widths["num_q_heads"] * hd, D),
            "gate_proj": (D, widths["ffn_inter_dim"])}
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    header, blobs, off = {}, [], 0
    for layer in range(layers):
        for mod, part in LORA_MODULES.items():
            din, dout = dims[mod]
            base = f"base_model.model.model.layers.{layer}.{part}.{mod}"
            for half, shape in (("lora_A", (LORA_RANK, din)),
                                ("lora_B", (dout, LORA_RANK))):
                t = torch.empty(shape, device=DEVICE).normal_(0.0, LORA_STD, generator=g)
                b = t.cpu().numpy().astype("<f4").tobytes()
                header[f"{base}.{half}.weight"] = dict(
                    dtype="F32", shape=list(shape), data_offsets=[off, off + len(b)])
                blobs.append(b)
                off += len(b)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    path.mkdir(parents=True, exist_ok=True)
    with open(path / "adapter_model.safetensors", "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for b in blobs:
            f.write(b)
    (path / "adapter_config.json").write_text(json.dumps(
        {"r": LORA_RANK, "lora_alpha": LORA_ALPHA,
         "target_modules": list(LORA_MODULES)}))


def _without_lora(params):
    """The params without their adapters (the same tensors)."""
    return dict({k: v for k, v in params.items() if k != "lora_scale"},
                layers={k: v for k, v in params["layers"].items()
                        if not k.startswith("lora_")})


def _merged(params, slot):
    """Base params with adapter `slot` merged into every projection it
    targets, W + alpha/r * B @ A in f32, rounded once to bf16."""
    layers = dict(_without_lora(params)["layers"])
    s = params["lora_scale"][slot - 1].item()
    for k, lw in params["layers"].items():
        if k.startswith("lora_"):
            name = k[len("lora_"):]
            delta = torch.einsum("lor,lri->loi", lw["B"][:, slot - 1].float(),
                                 lw["A"][:, slot - 1].float())
            layers[name] = (layers[name].float() + s * delta).to(layers[name].dtype)
    return dict(_without_lora(params), layers=layers)


def phase_lora_step(adapters: dict):
    """One mixed step at 8B width, 4 layers, with the two adapters of
    `adapters` (name -> peft dir; their first 4 layers): base, `a` and `b`
    rows (slot i % 3) of 8 decode rows and 3 chunks, on random weights (std
    0.02) and a random cache. The kernels against the plain versions under
    phase_step's rule; the base rows' logits equal to a step without
    adapters (the same kernels), bit for bit; each adapter's rows within
    CLEAR_MARGIN of a step on weights with that adapter merged in, tokens
    equal where the margin is clear, and the adapter's own effect on its
    rows (LoRA against no LoRA) more than 4 times that difference (an
    adapter applied to the wrong rows would move them about as far as the
    effect itself)."""
    mc = LlamaModelConfig(num_layers=4, **LLAMA3_8B)
    paths = ",".join(f"{k}={v}" for k, v in adapters.items())
    ec = dict(model_path="", use_dummy=True, dtype="bfloat16", block_size=16,
              preemption_mode="recompute", num_hbm_blocks=1024,
              max_blocks_per_seq=128, max_batch_size=16)
    specs = [(40 + 97 * i, 40 + 97 * i, 1) for i in range(8)]
    specs += [(512, 0, 512), (1600, 1024, 512), (812, 512, 300)]
    slots = [i % 3 for i in range(len(specs))]
    g = torch.Generator(device=DEVICE).manual_seed(2468)
    m = LlamaModel(EngineConfig(**ec, lora_paths=paths), mc, device=DEVICE)
    with loading(2468):
        m.load_weights()
    assert m.lora_slots == {"a": 1, "b": 2}, m.lora_slots
    assert m.lora_targets == ("w_gate", "wo", "wq", "wv"), m.lora_targets
    m.init_kvcache_and_swap()
    m.kv_cache.normal_(0.0, 1.0, generator=g)
    cache0 = m.kv_cache.clone()
    lora_params = m.params
    runs = {"kernels": (True, lora_params), "plain": (False, lora_params),
            "no LoRA": (True, _without_lora(lora_params)),
            "merged a": (True, _merged(lora_params, 1)),
            "merged b": (True, _merged(lora_params, 2))}
    logits = {}
    for run, (use_kernels, params) in runs.items():
        r_m = m if run == "kernels" else LlamaModel(
            EngineConfig(**ec, use_pallas=use_kernels), mc, device=DEVICE)
        r_m.params = params
        if r_m is not m:
            r_m.init_kvcache_and_swap()
        r_m.kv_cache.copy_(cache0)
        for i, (_, cached, _) in enumerate(specs):
            if cached:
                r_m.hbm_block_mgrs[0].allocate_for_seq(i, cached)
        sched = _requests(specs, mc.vocab_size)
        for s, slot in zip(sched, slots):
            s.request.lora_slot = slot if run in ("kernels", "plain") else 0
        build.reset_launch_counts()
        _, rows, lg = r_m.forward(sched, return_logits=True)
        torch.cuda.synchronize()
        assert all(rows[i].request is sched[i].request for i in range(len(sched)))
        logits[run] = torch.from_numpy(lg[:len(sched)])
        assert torch.isfinite(logits[run]).all(), run
        if r_m is not m:
            r_m.params = r_m.kv_cache = None
    sl = torch.tensor(slots)
    a, b = logits["kernels"], logits["plain"]
    diff = (a - b).abs().max().item()
    margin = b.topk(2, dim=-1).values
    checked = (margin[:, 0] - margin[:, 1]) > 2 * diff
    agree = a.argmax(-1) == b.argmax(-1)
    assert bool(agree[checked].all()), "greedy tokens differ on a clear-margin row"
    base_equal = torch.equal(a[sl == 0], logits["no LoRA"][sl == 0])
    merged, effect = [], []
    for slot, run in ((1, "merged a"), (2, "merged b")):
        rows_ = sl == slot
        d = (a[rows_] - logits[run][rows_]).abs().max().item()
        e = (a[rows_] - logits["no LoRA"][rows_]).abs().max().item()
        mm = logits[run][rows_].topk(2, dim=-1).values
        ok = ((mm[:, 0] - mm[:, 1]) > 2 * d)
        assert bool((a[rows_].argmax(-1) == logits[run][rows_].argmax(-1))[ok].all()), run
        merged.append(d)
        effect.append(e)
    log(f"[lora step] 8B width, 4 layers, adapters a and b (r {LORA_RANK}, "
        f"std {LORA_STD}, on q, v, o, gate), {len(specs)} rows (slots "
        f"{slots}): kernels against plain max |logit diff| {diff:.4g} (logit "
        f"std {b.std().item():.4g}), {int(checked.sum())} clear-margin rows "
        f"agree; base rows bit-equal to the step without adapters: "
        f"{base_equal}; adapter rows against merged weights max |diff| "
        f"{merged[0]:.4g} / {merged[1]:.4g}, the adapters' own effect "
        f"{effect[0]:.4g} / {effect[1]:.4g} (bounds: {CLEAR_MARGIN}, and the "
        f"effect over 4 times the merged difference)")
    assert base_equal, "base rows change when adapters are loaded"
    assert max(merged) <= CLEAR_MARGIN, merged
    assert min(effect) > 4 * max(merged), (effect, merged)
    m.params = m.kv_cache = None
    del m, lora_params, runs, cache0
    gc.collect()
    torch.cuda.empty_cache()


PROMPT_LENS = [17, 100, 250, 400, 600, 900, 1200, 1500]
# The serving runs, in order: name -> (model widths, engine options, the 8
# prompts' lengths, the length of one more prompt served alone or None).
# "none", "int4" and "int8" are the weight types of the earlier runs.
SERVE_RUNS = {
    "none": (LLAMA3_8B, {}, PROMPT_LENS, None),
    "int4": (LLAMA3_8B, dict(quant="int4"), PROMPT_LENS, None),
    "int8": (LLAMA3_8B, dict(quant="int8"), PROMPT_LENS, None),
    # fp8 KV (pages of 32, which the fp8 cache needs) and a prompt past the
    # 16,384 tokens at which the TPU decode kernel stages its page table.
    "fp8kv": (LLAMA31_8B, dict(kv_quant="fp8", block_size=32), PROMPT_LENS, 16500),
    # Prompts past the window of 4096: their chunked prefill and their decode
    # steps both cross it.
    "mistral": (MISTRAL_7B, {}, [17, 100, 250, 400, 600, 900, 5000, 8192], None),
    # Sampling, logprobs and multi-step decode: the bf16 engine with logprobs
    # on, three of the 8 requests sampled, 64 output tokens each; single
    # steps, windows of 8 with the fused write, and windows of 8 with
    # deferred commit (the decode kernel's `pend` variant).
    "ms1": (LLAMA3_8B, dict(enable_logprobs=True), PROMPT_LENS, None),
    "ms8": (LLAMA3_8B, dict(enable_logprobs=True, multi_step_decode=PEND_S),
            PROMPT_LENS, None),
    "ms8defer": (LLAMA3_8B, dict(enable_logprobs=True, multi_step_decode=PEND_S),
                 PROMPT_LENS, None),
}
LONG_OUT_LEN = 4
MS_RUNS = ("ms1", "ms8", "ms8defer")
MS_OUT_LEN = 64
MS_SAMPLED = {1: 1001, 4: 1004, 6: 1006}     # request index -> seed
# Predicted before the first run on the card (PERF.md): the 8 prompts
# take 4 prefill or mixed steps, as in the bf16 run; then 63 decode steps, or
# 7 windows of 8 (until the most advanced request has fewer than 8 tokens
# left) and 7 single steps. Every step launches the decode kernel once a
# layer (32), and a deferred inner step its `pend` variant instead.
MS_PREDICTED = {
    "ms1": dict(steps=67, paged_decode_attention=32 * 67,
                paged_decode_attention_pend=0),
    "ms8": dict(steps=18, paged_decode_attention=32 * 67,
                paged_decode_attention_pend=0),
    "ms8defer": dict(steps=18, paged_decode_attention=32 * 11,
                     paged_decode_attention_pend=32 * 56),
}


def serve_kernels(name: str) -> tuple:
    """Kernels the serving run `name` must launch."""
    if name == "fp8kv":
        return FP8_PATH_KERNELS
    extra = {"int4": ("int4_matmul",), "int8": ("int8_matmul",),
             "ms8defer": ("paged_decode_attention_pend",)}
    return PATH_KERNELS + extra.get(name, ())


def weight_kernel_launches(keys, layers: int) -> int:
    """The INT4 or INT8 kernel's launches over single steps of buckets
    `keys`: 7 projections a layer and the head in every step, whatever its
    tokens (above 256 in the wide configuration)."""
    assert all(k.steps == 1 and not k.spec for k in keys), keys
    return len(keys) * (7 * layers + 1)


def proj_route(key: str):
    """A quantized projection (`key` "q": INT8, "q4": INT4) as the port
    computed it before the weight kernels took it: quant.proj on the
    layer's weights (dequantized to bf16, then F.linear)."""
    return lambda x, q, s, layer, **kw: proj(x, {key: q[layer], "s": s[layer]})


def aten_share(events) -> tuple:
    """(launches, device ms, share of device time) of PyTorch's own kernels
    in a profile (at::native: elementwise, reduction, copy, concatenation,
    indexing), the work that eager PyTorch runs as small launches between
    the GEMMs and the port's kernels."""
    busy = sum(e.self_device_time_total for e in events)
    mine = [e for e in events
            if "at::native::" in e.key and e.self_device_time_total > 0]
    ms = sum(e.self_device_time_total for e in mine)
    return sum(e.count for e in mine), ms / 1e3, ms / max(busy, 1)


def copy_share(events) -> tuple:
    """(device ms, share of device time) of the copy kernels in a profile:
    PyTorch's copies and dtype conversions (direct_copy_kernel), where an
    int8 weight's conversion to bf16 runs."""
    busy = sum(e.self_device_time_total for e in events)
    copies = sum(e.self_device_time_total for e in events
                 if "direct_copy_kernel" in e.key)
    return copies / 1e3, copies / max(busy, 1)


async def serve_engine(name: str, smi: str, pools: dict, rates: dict,
                       outputs: dict):
    """The serving path at full width, 32 layers, as SERVE_RUNS[name] sets
    it: 8 concurrent requests, launch counts, pages back, the profile; the
    bf16 engine also answers /generate over HTTP, and the fp8-KV engine
    serves one long prompt more. The MS_RUNS engines get weights of std 0.02
    from one seed, sample three of their requests, collect every token's
    logprob (outputs[name]) and are held to MS_PREDICTED. The INT4 and INT8
    engines' weight kernels are held to their steps' buckets
    (weight_kernel_launches), and each is profiled again on the route before
    its weight kernel (proj_route, eagerly), for the share of device time
    its copies took and its prefill step's device ms. The decode rate goes to
    rates[name]. The engine is released before this returns, so that the
    next one sizes its cache on an empty card."""
    widths, ec_kw, prompt_lens, long_prompt = SERVE_RUNS[name]
    multi = name in MS_RUNS
    if name == "ms8defer":
        os.environ["SWIFTLLM_DEFER_KV"] = "1"
    mc = LlamaModelConfig(num_layers=32, **widths)
    ec = EngineConfig(model_path="", use_dummy=True, dtype="bfloat16",
                      preemption_mode="recompute", **ec_kw)
    t0 = time.perf_counter()
    engine = Engine(ec, mc, device=DEVICE)
    with loading(77) if multi else contextlib.nullcontext():
        await engine.initialize(tokenizer_backend="inline")
    mgr = engine.model.hbm_block_mgrs[0]
    free0 = mgr.num_free_blocks
    weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(engine.model.params))
    pages = engine.model.num_hbm_blocks
    pools[name] = pages * ec.block_size
    log(f"[serve {name}] engine up in {time.perf_counter() - t0:.1f} s: "
        f"weights {weight_bytes / 1e9:.3f} GB, {pages} "
        f"KV pages of {ec.block_size} tokens = {pools[name]} tokens, cache "
        f"{engine.model.kv_cache.dtype} {tuple(engine.model.kv_cache.shape)}")
    if name == "fp8kv":
        log(f"[serve {name}] pool {pools[name]} tokens against the bf16 "
            f"engine's {pools['none']}: {pools[name] / pools['none']:.4f} times "
            f"({smi})")
    loops = asyncio.create_task(engine.start_all_event_loops())
    out_len = MS_OUT_LEN if multi else 32
    top = min(128000, mc.vocab_size - 1)
    logprobs = {}

    async def one(i, n, n_out=out_len):
        ids = [(13 * i + 5 * j) % top + 1 for j in range(n)]
        kw = (dict(temperature=0.8, top_k=20, seed=MS_SAMPLED[i])
              if multi and i in MS_SAMPLED else {})
        t_sub = time.perf_counter()
        stamps, toks = [], []
        async for so in engine.add_request_and_stream(
                RawRequest("", n_out, prompt_token_ids=ids, **kw)):
            stamps.append(time.perf_counter())
            toks.append(so.token_id)
            logprobs.setdefault(i, []).append(so.logprob)
        return t_sub, stamps, toks

    keys, execute = [], engine.model.execute_packed

    def spy(flat, key, *a, **kw):
        keys.append(key)
        return execute(flat, key, *a, **kw)
    engine.model.execute_packed = spy
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    since = graph_state(engine)
    t_run = time.perf_counter()
    res = await asyncio.gather(*[one(i, n) for i, n in enumerate(prompt_lens)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    launches = dict(build.launch_counts)
    graph_report(engine, name, since, smi)
    for (_, stamps, toks), n in zip(res, prompt_lens):
        assert len(toks) == out_len, f"prompt {n}: {len(toks)} tokens"
        assert all(0 <= t < mc.vocab_size for t in toks)
    for k in serve_kernels(name):
        assert launches[k] > 0, f"{k} never launched on the {name} serving path"
    engine.model.execute_packed = execute
    if name in ("none", "fp8kv"):
        # One rope launch a layer in every step; with the fp8 cache the
        # launch that builds the rows, and no other.
        rope = {"none": "rope_qkv", "fp8kv": "rope_qkv_fp8"}
        assert launches[rope[name]] == mc.num_layers * len(keys), (
            launches, len(keys))
        assert launches[rope["fp8kv" if name == "none" else "none"]] == 0, launches
    if name in ("int4", "int8"):
        kernel = f"{name}_matmul"
        wide = sorted({k.tokens for k in keys if k.tokens > im.WIDE_ABOVE})
        assert launches[kernel] == weight_kernel_launches(keys, mc.num_layers), (
            launches[kernel], [k.tokens for k in keys])
        log(f"[serve {name}] {kernel} launched {launches[kernel]} times: 7 "
            f"projections x {mc.num_layers} layers and the head in each of the "
            f"{len(keys)} steps ({sum(k.tokens > im.WIDE_ABOVE for k in keys)} "
            f"of them in buckets of {wide} tokens, the wide configuration)")
    if multi:
        got = dict(launches, steps=engine.stats.num_steps)
        assert {k: got[k] for k in MS_PREDICTED[name]} == MS_PREDICTED[name], (
            name, got, MS_PREDICTED[name])
        lp = np.array([logprobs[i] for i in range(len(prompt_lens))], np.float64)
        assert np.isfinite(lp).all() and (lp <= 0).all(), f"{name}: logprobs"
        outputs[name] = [toks for _, _, toks in res]
        log(f"[serve {name}] launches and steps as predicted "
            f"({MS_PREDICTED[name]}); {lp.size} logprobs finite and <= 0 "
            f"(mean {lp.mean():.3f}; greedy requests {np.delete(lp, list(MS_SAMPLED), 0).mean():.3f}, "
            f"sampled {lp[list(MS_SAMPLED)].mean():.3f})")
    # The probe step sized the pool: the run's peak must fit the budget.
    peak = torch.cuda.max_memory_allocated()
    budget = torch.cuda.mem_get_info()[1] * ec.hbm_mem_utilization
    assert peak <= budget, (peak, budget)
    ttft = sorted(st[0] - t for t, st, _ in res)
    # Decode rate: tokens streamed after the last request's first token, over
    # the time from then to the last token (all 8 rows decoding).
    first = max(st[0] for _, st, _ in res)
    last = max(st[-1] for _, st, _ in res)
    n_after = sum(1 for _, st, _ in res for x in st if x > first)
    log(f"[serve {name}] 8 requests, prompts {prompt_lens}, {out_len} tokens "
        f"each, in {wall:.3f} s ({smi}); launches {launches}; peak allocated "
        f"{peak / 1e9:.2f} GB of a {budget / 1e9:.2f} GB budget")
    rates[name] = n_after / (last - first)
    log(f"[serve {name}] TTFT p50 {1e3 * ttft[len(ttft) // 2]:.1f} ms, max "
        f"{1e3 * ttft[-1]:.1f} ms; decode {n_after / (last - first):.1f} tok/s "
        f"({n_after} tokens after the last first token); output "
        f"{len(res) * out_len / wall:.1f} tok/s over the run; "
        f"{engine.stats.num_steps} steps ({smi})")
    await _pages_back(mgr, free0)
    if long_prompt:
        # One request alone, its prompt prefilled in chunks of 512 over a
        # history that passes 16,384 keys, then decode steps over all of it.
        build.reset_launch_counts()
        steps0 = engine.stats.num_steps
        t_sub, stamps, toks = await one(len(prompt_lens), long_prompt, LONG_OUT_LEN)
        torch.cuda.synchronize()
        assert len(toks) == LONG_OUT_LEN, f"long prompt: {len(toks)} tokens"
        assert all(0 <= t < mc.vocab_size for t in toks)
        long_launches = dict(build.launch_counts)
        for k in serve_kernels(name):
            assert long_launches[k] > 0, f"{k} never launched for the long prompt"
        log(f"[serve {name}] one request of {long_prompt} prompt tokens "
            f"({cdiv(long_prompt, ec.block_size)} pages), {LONG_OUT_LEN} output "
            f"tokens: TTFT {stamps[0] - t_sub:.3f} s, then "
            f"{1e3 * (stamps[-1] - stamps[0]) / (LONG_OUT_LEN - 1):.1f} ms a "
            f"token; {engine.stats.num_steps - steps0} steps; launches "
            f"{long_launches} ({smi})")
        await _pages_back(mgr, free0)
        log(f"[serve {name}] the long request finished and its pages are back "
            f"({mgr.num_free_blocks} free of {free0})")
    await _profile(engine, smi, name, out_len=65 if multi else 24)
    if name in ("int8", "int4"):
        # The route before the weight kernel, on the same engine, eagerly (so
        # that no graph of it joins the pool the profile budgeted).
        mod, fn = (im8, "int8_proj_stacked") if name == "int8" else (im, "int4_proj_stacked")
        wrapper, graphs = getattr(mod, fn), engine.model.graphs
        setattr(mod, fn, proj_route("q" if name == "int8" else "q4"))
        engine.model.graphs = None
        try:
            await _profile(engine, smi, f"{name}_proj")
        finally:
            setattr(mod, fn, wrapper)
            engine.model.graphs = graphs
        # The prefill step with the wide plans as they are (stream-K where
        # the model says it pays) and with equal_cuts' schedules, eagerly
        # (so that the graphs keep the plans they captured), one after the
        # other.
        steps = {}
        engine.model.graphs = None
        try:
            for label in ("plan", "cuts"):
                with equal_cuts() if label == "cuts" else contextlib.nullcontext():
                    got = {}
                    await _profile(engine, smi, f"{name}_{label}", prefill_ms=got)
                    steps.setdefault(label, []).extend(got.values())
        finally:
            engine.model.graphs = graphs
        log(f"[profile {name}] the prefill step's device ms, eagerly, one after "
            f"the other (plan, cuts): the plan's wide schedules "
            f"{' / '.join(f'{t:.3f}' for t in steps['plan'])}, equal_cuts' (every "
            f"unit whole or cut into equal pieces, no stream-K) "
            f"{' / '.join(f'{t:.3f}' for t in steps['cuts'])} ({smi})")
    if name in ("none", "ms8"):
        await _http(engine, mgr, free0, logprobs=multi)
    g = engine.model.graphs
    log(f"[graphs {name}] after the profile: {len(g.table)} graphs held, pool "
        f"{g.pool_bytes / 1e6:.1f} MB reserved{check_pool(engine, name)}")
    os.environ.pop("SWIFTLLM_DEFER_KV", None)
    loops.cancel()
    await asyncio.wait([loops])
    assert loops.cancelled()
    engine.model.params = engine.model.kv_cache = engine.model.token_feedback = None
    # Every local that holds the graphs goes too: they pin the split
    # counters (build.hold_counters) until they are collected.
    del engine, mgr, loops, g, execute
    graphs = None
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated()
    assert left < 2**30, f"{left / 1e9:.2f} GB still allocated after release"
    return launches


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


async def _http(engine, mgr, free0, logprobs=False):
    """Phase 5: /generate over HTTP on 127.0.0.1, non-streaming and
    streaming, through the port's build_app; with `logprobs` both answers
    carry each token's logprob (an engine with enable_logprobs)."""
    import aiohttp
    from aiohttp import web
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    runner = web.AppRunner(build_app(engine))
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", port)
    await site.start()
    url = f"http://127.0.0.1:{port}/generate"
    try:
        async with aiohttp.ClientSession() as http:
            ids = list(range(1, 41))
            async with http.post(url, json={"prompt_token_ids": ids, "output_len": 8,
                                            "logprobs": logprobs}) as r:
                assert r.status == 200, r.status
                body = await r.json()
            assert len(body["output_token_ids"]) == 8 and isinstance(body["output"], str)
            streamed, streamed_lp = [], []
            async with http.post(url, json={"prompt_token_ids": ids, "output_len": 8,
                                            "stream": True, "decode": False,
                                            "logprobs": logprobs}) as r:
                assert r.status == 200, r.status
                async for line in r.content:
                    if line.strip():
                        event = json.loads(line)
                        streamed.append(event["token_id"])
                        streamed_lp.append(event.get("logprob"))
            assert streamed == body["output_token_ids"], (streamed, body)
            if logprobs:
                assert streamed_lp == body["logprobs"], (streamed_lp, body)
                assert all(isinstance(x, float) and x <= 0 for x in streamed_lp)
        log(f"[http] /generate on 127.0.0.1:{port}: non-streaming and streaming "
            f"answers agree ({body['output_token_ids']}"
            f"{', logprobs ' + str([round(x, 3) for x in streamed_lp]) if logprobs else ''})")
        await _pages_back(mgr, free0)
    finally:
        await runner.cleanup()


def successor(t: int) -> int:
    return (t & ~7) | ((t + 1) & 7)


SPEC_PREFIX = 1024
SPEC_OUT_LEN = 32


QWEN_OUT = 16


@contextlib.contextmanager
def eager_models():
    """Every LlamaModel built meanwhile runs its steps eagerly
    (cuda_graphs=False): the plain path reads device values on the host, which
    no CUDA graph can capture."""
    real = LlamaModel.__init__

    def init(self, *a, cuda_graphs=True, **kw):
        real(self, *a, cuda_graphs=False, **kw)
    LlamaModel.__init__ = init
    try:
        yield
    finally:
        LlamaModel.__init__ = real


async def serve_qwen2(smi: str) -> dict:
    """Fault F2 end to end: Qwen2-0.5B at full width (24 layers, QWEN2_05B:
    14 query heads over 2 kv heads, a GQA group of 7, head_dim 64, q/k/v
    biases), bf16, 16 rows a step, weights from seeded_weights(successor=True),
    warmed up (every step from a CUDA graph), serving the 8 prompts of the bf16 run
    greedily, QWEN_OUT tokens each; then an engine on the plain path
    (use_pallas=False, eager, a pool of 1,024 pages) on the same weights
    serving them again: every
    request's tokens equal, every token the successor of the one before,
    pages back, and the kernel engine's attention kernels launched once a
    layer a step (its decode tok/s from graphs logged). The weights make the
    next token a function of the last one, so the tokens hold the paths and
    launches at group 7, not attention's values: phase_groups holds those
    kernel by kernel, and phase_qwen2_step a step's logits at this width.
    Returns the kernel engine's launches."""
    mc = LlamaModelConfig(num_layers=24, **QWEN2_05B)
    top = min(128000, mc.vocab_size - 1)
    prompts = [[(13 * i + 5 * j) % top + 1 for j in range(n)]
               for i, n in enumerate(PROMPT_LENS)]
    outs, launches = {}, {}
    # The plain path's attention gathers every row's pages dense (a row's
    # most pages, at the rows and query buckets): its engine takes a pool
    # and a page table sized for these requests.
    # The kernel engine takes 16 rows a step (its warm-up then captures the
    # plans of up to 16 live rows, not 128).
    small = dict(num_hbm_blocks=1024, max_blocks_per_seq=128, max_batch_size=8)
    for run, use_kernels in (("kernels", True), ("plain", False)):
        ec = EngineConfig(model_path="", use_dummy=True, dtype="bfloat16",
                          preemption_mode="recompute", use_pallas=use_kernels,
                          **(dict(max_batch_size=16) if use_kernels else small))
        t0 = time.perf_counter()
        engine = Engine(ec, mc, device=DEVICE)
        with loading(66, std=0.002, successor=True), (
                contextlib.nullcontext() if use_kernels else eager_models()):
            await engine.initialize(tokenizer_backend="inline")
        warm = ""
        if use_kernels:
            t_w = time.perf_counter()
            await engine.warmup()
            warm = (f", warm-up {time.perf_counter() - t_w:.1f} s, "
                    f"{graph_state(engine)[0]} graphs")
        mgr = engine.model.hbm_block_mgrs[0]
        free0 = mgr.num_free_blocks
        loops = asyncio.create_task(engine.start_all_event_loops())

        async def one(ids):
            stamps, toks = [], []
            async for so in engine.add_request_and_stream(
                    RawRequest("", QWEN_OUT, prompt_token_ids=ids)):
                stamps.append(time.perf_counter())
                toks.append(so.token_id)
            return stamps, toks
        build.reset_launch_counts()
        since = graph_state(engine) if use_kernels else None
        steps0 = engine.stats.num_steps
        t_run = time.perf_counter()
        res = await asyncio.gather(*[one(p) for p in prompts])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_run
        steps = engine.stats.num_steps - steps0
        launches[run] = dict(build.launch_counts)
        outs[run] = [toks for _, toks in res]
        for p, toks in zip(prompts, outs[run]):
            assert len(toks) == QWEN_OUT, (run, len(toks))
            assert [successor(t) for t in [p[-1]] + toks[:-1]] == toks, (run, p[-1], toks)
        await _pages_back(mgr, free0)
        first = max(st[0] for st, _ in res)
        last = max(st[-1] for st, _ in res)
        n_after = sum(1 for st, _ in res for x in st if x > first)
        if use_kernels:
            graph_report(engine, "qwen2", since, smi)
            for k in ("paged_decode_attention", "rope_qkv", "paged_prefill_attention"):
                assert launches[run][k] > 0, f"{k} never launched on the Qwen2 engine"
            assert launches[run]["paged_decode_attention"] == mc.num_layers * steps, (
                launches[run], steps)
        else:
            assert not any(launches[run].values()), launches[run]
        log(f"[serve qwen2 {run}] Qwen2-0.5B width (14 / 2 heads, group 7, head_dim "
            f"64, biases), 24 layers, up in {t_run - t0:.1f} s{warm}: 8 requests, "
            f"{QWEN_OUT} tokens each, in {wall:.3f} s, {steps} steps; decode "
            f"{n_after / (last - first):.1f} tok/s"
            f"{' from graphs' if use_kernels else ' (plain path, eager)'}; "
            f"launches {launches[run]} ({smi})")
        loops.cancel()
        await asyncio.wait([loops])
        engine.model.params = engine.model.kv_cache = engine.model.token_feedback = None
        del engine, mgr, loops
        gc.collect()
        torch.cuda.empty_cache()
    assert outs["kernels"] == outs["plain"], (outs["kernels"], outs["plain"])
    log(f"[serve qwen2] the kernel engine's tokens equal the plain path's on all "
        f"8 requests (request 0 begins {outs['kernels'][0][:6]})")
    return launches["kernels"]


async def serve_spec(smi: str) -> dict:
    """Phase 4, speculative decoding and prefix caching: a full-width 8B
    bf16 engine with enable_spec_decode (spec_k 4) and enable_prefix_caching,
    weights from seeded_weights(successor=True), warmed up (verify buckets included).
    In turn: (1) 8 requests sharing a 1,024-token prefix with distinct
    suffixes, the first alone, then 7: matched tokens, the second wave's
    TTFT, the shared pages byte-unchanged by it; (2) the 8 prompts of the
    bf16 run with spec off (the reference, "plain"); (3) the same with the
    n-gram proposer; (4) the same with an oracle proposing the plain run's
    continuation and SWIFTLLM_TILE_BF16_SCORES=1; (2)-(4) with prefix
    matching off, so that none rides the pages of another. Every wave: every
    token the successor of the one before, tokens equal to the plain run's,
    pages back, and per step one launch a layer of the decode kernel and of
    rope_qkv (which writes the spans' rows when the q bucket is above 1),
    and of the prefill kernel (or its bf16-score variant) when it is. The weights set the next token from the last one
    alone, with margins in the thousands: these checks hold the paths, the
    launches and the accept loop, not attention's values, which
    phase_verify_step and phase_prefix_step hold. Returns each kernel's
    launches over the waves."""
    from swiftllm_tpu_torch.server import spec as spec_mod
    mc = LlamaModelConfig(num_layers=32, **LLAMA3_8B)
    ec = EngineConfig(model_path="", use_dummy=True, dtype="bfloat16",
                      preemption_mode="recompute", enable_spec_decode=True,
                      spec_k=SPEC_K, enable_prefix_caching=True)
    t0 = time.perf_counter()
    engine = Engine(ec, mc, device=DEVICE)
    with loading(55, std=0.002, successor=True):
        await engine.initialize(tokenizer_backend="inline")
    model = engine.model
    keys = []
    execute = model.execute_packed

    def spy(flat, key, *a):
        keys.append(key)
        return execute(flat, key, *a)
    model.execute_packed = spy
    mem0 = memory_mark()
    t_warm = time.perf_counter()
    await engine.warmup()
    t_warm = time.perf_counter() - t_warm
    memory = check_warmup_memory(engine, mem0, "spec warm-up")
    since = graph_state(engine)
    warm = [k for k in keys if k.spec]
    assert warm and {k.q_len for k in warm} == {SPEC_Q}, keys
    assert not any(k.sampling for k in warm), warm
    assert since[0] == model.profiled["graphs"] and since[3] == 0, (
        since, model.profiled["graphs"])
    mgr = model.hbm_block_mgrs[0]
    free0 = mgr.num_free_blocks
    log(f"[serve spec] engine up and warmed in {time.perf_counter() - t0:.1f} s "
        f"({len(keys)} warm-up steps, {len(warm)} of them verify steps; the "
        f"warm-up {t_warm:.2f} s, {since[0]} graphs, "
        f"{model.graphs.capture_s:.2f} s capturing; pool "
        f"{model.graphs.pool_bytes / 1e6:.1f} MB{check_pool(engine, 'spec')}; "
        f"{memory}); {model.num_hbm_blocks} pages of {ec.block_size} ({smi})")
    matched = []
    real_match = model.match_prefix

    def match(req):
        n = real_match(req)
        matched.append((req.seq_id, n, mgr.seq_block_ids(req.seq_id)[:n // ec.block_size].tolist()))
        return n
    engine.scheduler.prefix_matcher = match
    loops = asyncio.create_task(engine.start_all_event_loops())
    top = min(128000, mc.vocab_size - 1)
    totals = dict.fromkeys(build.KERNELS, 0)

    async def wave(name, prompts, bf16s=False):
        keys.clear()
        held = set(model.graphs.table)
        before = graph_state(engine)
        build.reset_launch_counts()
        st0 = engine.stats.snapshot()
        os.environ["SWIFTLLM_TILE_BF16_SCORES"] = "1" if bf16s else "0"

        async def one(ids):
            t_sub = time.perf_counter()
            req = engine.submit(RawRequest("", SPEC_OUT_LEN, prompt_token_ids=ids))
            stamps, toks = [], []
            async for so in engine.stream_outputs(req):
                stamps.append(time.perf_counter())
                toks.append(so.token_id)
            return t_sub, stamps, toks
        # The oracle wave runs under the profiler: the kernels it saw on
        # the device against the launches counted (device_launches).
        ctx = (profiling(torch.profiler.ProfilerActivity.CUDA)
               if bf16s else contextlib.nullcontext())
        try:
            with ctx as prof:
                torch.cuda.synchronize()
                t_run = time.perf_counter()
                res = await asyncio.gather(*[one(p) for p in prompts])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t_run
        finally:
            os.environ.pop("SWIFTLLM_TILE_BF16_SCORES")
        await _pages_back(mgr, free0)
        launches = dict(build.launch_counts)
        if bf16s:
            if lost := edges_lost(prof):
                log(f"[serve spec] {name}: {lost}")
            seen = device_launches(prof.key_averages(), launches)
            log(f"[serve spec] {name}: launches counted, and kernels the "
                f"profiler saw on the device: " + ", ".join(
                    f"{k} {n} / {d}" for k, (n, d) in seen.items() if n or d))
        st = {k: engine.stats.snapshot()[k] - st0[k] for k in
              ("num_spec_drafted", "num_spec_accepted")}
        steps = len(keys)
        big = sum(k.q_len > 1 for k in keys)
        verify = sum(k.spec > 0 for k in keys)
        pre = "paged_prefill_attention_bf16s" if bf16s else "paged_prefill_attention"
        want = {"paged_decode_attention": 32 * steps, "rope_qkv": 32 * steps,
                pre: 32 * big}
        want["paged_prefill_attention" if bf16s else "paged_prefill_attention_bf16s"] = 0
        assert {k: launches[k] for k in want} == want, (name, launches, want)
        # Within the warm-up's switches serving captures nothing; the bf16
        # scores switch (SWIFTLLM_TILE_BF16_SCORES) is part of a graph's key
        # and the warm-up ran without it, so that wave's keys are new.
        new = set(model.graphs.table) - held
        if bf16s:
            assert new and all(k.switches.bf16_scores for k in new), new
        else:
            assert_no_captures(engine, before, f"spec, {name}")
        for k in totals:
            totals[k] += launches[k]
        outs = [toks for _, _, toks in res]
        for p, toks in zip(prompts, outs):
            assert len(toks) == SPEC_OUT_LEN, (name, len(toks))
            seq = [p[-1]] + toks
            assert all(b == successor(a) for a, b in zip(seq, seq[1:])), (name, seq[:12])
        first = max(stt[0] for _, stt, _ in res)
        last = max(stt[-1] for _, stt, _ in res)
        n_after = sum(1 for _, stt, _ in res for x in stt if x > first)
        ttft = sorted(stt[0] - t for t, stt, _ in res)
        log(f"[serve spec] {name}: {len(prompts)} requests, {SPEC_OUT_LEN} tokens "
            f"each, in {wall:.3f} s; {steps} steps ({big} with q bucket > 1, "
            f"{verify} verify: {32 * verify} of the {32 * big} prefill "
            f"launches, and of the rope launches that wrote the spans); drafted {st['num_spec_drafted']}, accepted "
            f"{st['num_spec_accepted']}; TTFT p50 {1e3 * ttft[len(ttft) // 2]:.1f} "
            f"ms, max {1e3 * ttft[-1]:.1f} ms; decode "
            f"{n_after / max(last - first, 1e-9):.1f} tok/s ({n_after} tokens after "
            f"the last first token); {len(new)} graphs captured while serving; "
            f"launches {launches} ({smi})")
        return outs, steps, st, ttft

    try:
        # (1) A shared 1,024-token prefix: one request alone, then seven.
        prefix = [(7 * j) % top + 1 for j in range(SPEC_PREFIX)]
        suffixes = [[(1000 + 31 * i + 3 * j) % top + 1 for j in range(40 + 10 * i)]
                    for i in range(8)]
        await wave("prefix wave 1 (1 request)", [prefix + suffixes[0]])
        shared = [p for sid, n, pages in matched for p in pages]
        assert not shared, matched
        # The first request's prefix pages: the registered chain of pages.
        chain, parent = [], -1
        for i in range(SPEC_PREFIX // ec.block_size):
            parent = mgr._prefix_map[
                (parent, tuple(prefix[i * ec.block_size:(i + 1) * ec.block_size]))]
            chain.append(parent)
        slots = (torch.tensor(chain, device=DEVICE)[:, None] * ec.block_size
                 + torch.arange(ec.block_size, device=DEVICE)[None, :]).reshape(-1)
        before = model.kv_cache[:, slots].clone()
        matched.clear()
        _, _, _, ttft2 = await wave("prefix wave 2 (7 requests)",
                                    [prefix + sfx for sfx in suffixes[1:]])
        assert len(matched) == 7 and all(n == SPEC_PREFIX and pg == chain
                                         for _, n, pg in matched), matched
        assert torch.equal(model.kv_cache[:, slots].view(torch.int16),
                           before.view(torch.int16)), "wave 2 changed the shared pages"
        log(f"[serve spec] prefix: each of the 7 matched {SPEC_PREFIX} tokens "
            f"({len(chain)} pages, the first request's); the shared pages are "
            f"byte-unchanged after wave 2 ({before.numel() * 2 / 1e6:.1f} MB); "
            f"wave 2 TTFT p50 {1e3 * ttft2[len(ttft2) // 2]:.1f} ms")
        del before
        # (2)-(4) The bf16 run's prompts: plain, n-gram drafts, oracle drafts,
        # with prefix matching off, so that each wave prefills its prompts in
        # full and the three differ in their decode and verify steps alone.
        engine.scheduler.prefix_matcher = None
        prompts = [[(13 * i + 5 * j) % top + 1 for j in range(n)]
                   for i, n in enumerate(PROMPT_LENS)]
        ec.enable_spec_decode = False
        plain, plain_steps, _, _ = await wave("plain (spec off)", prompts)
        ec.enable_spec_decode = True
        ngram, ngram_steps, st, _ = await wave("n-gram drafts", prompts)
        assert ngram == plain, "n-gram spec tokens differ from plain"
        seqs = [p + o for p, o in zip(prompts, plain)]

        def oracle(tokens, k, ngram_max=3, ngram_min=2):
            ctx = tokens.tolist()
            for sq in seqs:
                if len(ctx) < len(sq) and sq[:len(ctx)] == ctx:
                    return sq[len(ctx):len(ctx) + k]
            return []
        real_propose = spec_mod.propose
        spec_mod.propose = oracle
        try:
            orc, orc_steps, st, _ = await wave("oracle drafts, bf16 scores", prompts,
                                               bf16s=True)
        finally:
            spec_mod.propose = real_propose
        equal = [a == b for a, b in zip(orc, plain)]
        log(f"[serve spec] oracle: accepted {st['num_spec_accepted']} of "
            f"{st['num_spec_drafted']} drafts, {orc_steps} steps against "
            f"{plain_steps} plain and {ngram_steps} with n-gram drafts; tokens "
            f"equal to the plain run per request: {equal}")
        assert st["num_spec_accepted"] == st["num_spec_drafted"] > 0, st
        assert orc_steps < plain_steps and all(equal)
        graph_report(engine, "spec", since, smi)
    finally:
        loops.cancel()
        await asyncio.wait([loops])
    model.params = model.kv_cache = model.token_feedback = None
    del engine, model, mgr, loops
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated()
    assert left < 2**30, f"{left / 1e9:.2f} GB still allocated after release"
    return totals


SWAP_PROMPT, SWAP_OUT = 1500, 64
# Pages of the swapping engines: room for four of the 8 prompts, not for
# their 64 output tokens as well, so the scheduler swaps the tail out.
SWAP_PAGES = {"bf16": (16, 380), "fp8": (32, 190)}
SWAP_ROOMY = 1024


async def _serve_greedy(engine, prompts, out_len, loras=None):
    """Serve `prompts` at once; their output token lists."""
    loras = loras or [None] * len(prompts)
    res = await asyncio.gather(*[
        engine.add_request_and_wait(RawRequest("", out_len, prompt_token_ids=p,
                                               lora=lo))
        for p, lo in zip(prompts, loras)])
    return [list(toks) for _, toks in res]


async def _engine(ec, mc, seed, successor=True):
    """A full-width engine on seeded_weights from `seed`: the successor
    model, or with `successor` False random weights (std 0.02); its loops
    running."""
    t0 = time.perf_counter()
    engine = Engine(ec, mc, device=DEVICE)
    with loading(seed, std=0.002 if successor else 0.02, successor=successor):
        await engine.initialize(tokenizer_backend="inline")
    loops = asyncio.create_task(engine.start_all_event_loops())
    return engine, loops, time.perf_counter() - t0


async def _release(engine, loops):
    if loops is not None:
        loops.cancel()
        await asyncio.wait([loops])
    engine.model.params = engine.model.kv_cache = engine.model.token_feedback = None
    engine.model.cpu_cache = None
    del engine, loops
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated()
    assert left < 2**30, f"{left / 1e9:.2f} GB still allocated after release"


async def serve_swap(smi: str, kv: str) -> dict:
    """Swap preemption at 8B width, 32 layers, the default EngineConfig
    (preemption_mode "swap", 2,048 host pages) but for the device pages:
    8 requests of 1,500-token prompts and 64 output tokens on a pool that
    holds four of them (SWAP_PAGES), so the scheduler swaps. Every swapped
    sequence's pages are copied aside before its swap-out and must come back
    byte-identical after its swap-in (at other pages); the tokens must equal
    a roomy engine's (no preemption) on the same weights; both pools must be
    full again at the end. Weights: seeded_weights(successor=True) (the tokens are the
    successor chain, whatever the batch: these checks hold the paths and
    the pages, the byte check the KV). The byte check reads the cache, so
    that run waits for the card at every swap; the same requests are then
    served again by the engine's own swap methods, unwrapped, as a server
    runs them (no host wait; steps and the freed or reused pages follow in
    stream order), and must swap and give the same tokens again. Logs the
    mover's ms a page each way (CUDA events around each swap, read after the
    run) and its launches; returns the second run's launches."""
    ps, pages = SWAP_PAGES[kv]
    widths = LLAMA31_8B if kv == "fp8" else LLAMA3_8B
    mc = LlamaModelConfig(num_layers=32, **widths)
    kw = dict(model_path="", use_dummy=True, block_size=ps,
              kv_quant="fp8" if kv == "fp8" else "none")
    top = min(128000, mc.vocab_size - 1)
    prompts = [[(13 * i + 5 * j) % top + 1 for j in range(SWAP_PROMPT)]
               for i in range(8)]
    engine, loops, up = await _engine(EngineConfig(**kw, num_hbm_blocks=SWAP_ROOMY),
                                      mc, 91)
    want = await _serve_greedy(engine, prompts, SWAP_OUT)
    assert engine.stats.num_preemptions == 0
    await _release(engine, loops)
    ec = EngineConfig(**kw, num_hbm_blocks=pages)
    assert ec.preemption_mode == "swap" and ec.num_cpu_blocks == 2048
    engine, loops, up = await _engine(ec, mc, 91)
    model = engine.model
    mgr, cpu = model.hbm_block_mgrs[0], model.cpu_block_mgr
    saved, events, moved = {}, {"out": [], "in": []}, {"out": 0, "in": 0}
    real_out, real_in = model.swap_out_seqs, model.swap_in_seqs

    def timed(fn, way, reqs, n_pages):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        fn(reqs)
        t1.record()
        events[way].append((t0, t1))
        moved[way] += n_pages

    def swap_out(reqs):
        n = 0
        for r in reqs:
            own = mgr.seq_block_ids(r.seq_id)[:cdiv(r.num_cached_tokens, ps)]
            saved[r.seq_id] = _page_bytes_of(model.kv_cache, own, ps).clone()
            n += len(own)
        timed(real_out, "out", reqs, n)

    def swap_in(reqs):
        timed(real_in, "in", reqs, sum(cdiv(r.num_cached_tokens, ps) for r in reqs))
        for r in reqs:
            own = mgr.seq_block_ids(r.seq_id)[:cdiv(r.num_cached_tokens, ps)]
            assert torch.equal(_page_bytes_of(model.kv_cache, own, ps),
                               saved.pop(r.seq_id)), f"seq {r.seq_id}: pages changed"
    model.swap_out_seqs, model.swap_in_seqs = swap_out, swap_in
    log(f"[serve swap {kv}] engine up in {up:.1f} s: {pages} device pages of "
        f"{ps}, a host pool of {ec.num_cpu_blocks} pages "
        f"{tuple(model.cpu_cache.shape)} {model.cpu_cache.dtype}, pinned "
        f"{model.cpu_cache.is_pinned()}, {model._page_bytes()} B a page")
    build.reset_launch_counts()
    steps0 = engine.stats.num_steps
    t_run = time.perf_counter()
    got = await _serve_greedy(engine, prompts, SWAP_OUT)
    wall = time.perf_counter() - t_run
    launches = dict(build.launch_counts)
    torch.cuda.synchronize()
    times = {way: [a.elapsed_time(b) for a, b in ev] for way, ev in events.items()}
    n_swaps = len(times["out"]) + len(times["in"])
    await _pages_back(mgr, pages)
    await _pages_back(cpu, ec.num_cpu_blocks)
    assert engine.scheduler.num_free_cpu_blocks == ec.num_cpu_blocks
    assert engine.stats.num_preemptions >= 1 and not saved, (
        engine.stats.num_preemptions, list(saved))
    assert launches["swap_pages"] == n_swaps, (launches["swap_pages"], n_swaps)
    for k in FP8_PATH_KERNELS if kv == "fp8" else PATH_KERNELS:
        assert launches[k] > 0, f"{k} never launched on the swapping engine"
    for p, toks in zip(prompts, got):
        seq = [p[-1]] + toks
        assert all(b == successor(a) for a, b in zip(seq, seq[1:])), seq[:12]
    assert got == want, "swap run's tokens differ from the roomy run's"
    ms_out = sum(times["out"]) / moved["out"]
    ms_in = sum(times["in"]) / moved["in"]
    pb = model._page_bytes()
    log(f"[serve swap {kv}] 8 requests of {SWAP_PROMPT} prompt and {SWAP_OUT} "
        f"output tokens in {wall:.3f} s, {engine.stats.num_steps - steps0} "
        f"steps: {engine.stats.num_preemptions} swap-outs, "
        f"{len(times['in'])} swap-ins, every swapped page back byte-identical; "
        f"tokens equal to the roomy engine's ({SWAP_ROOMY} pages, no "
        f"preemption); both pools full again; swap_pages launched "
        f"{launches['swap_pages']} times; out {moved['out']} pages at "
        f"{ms_out:.4f} ms a page ({pb / (1e-3 * ms_out) / 1e9:.2f} GB/s), in "
        f"{moved['in']} at {ms_in:.4f} ms a page ({pb / (1e-3 * ms_in) / 1e9:.2f} "
        f"GB/s); launches {launches} ({smi})")
    # The same requests through the engine's own swap methods.
    del model.swap_out_seqs, model.swap_in_seqs
    preempted0 = engine.stats.num_preemptions
    build.reset_launch_counts()
    steps0 = engine.stats.num_steps
    since = graph_state(engine)
    t_run = time.perf_counter()
    got = await _serve_greedy(engine, prompts, SWAP_OUT)
    wall = time.perf_counter() - t_run
    launches = dict(build.launch_counts)
    swaps = engine.stats.num_preemptions - preempted0
    await _pages_back(mgr, pages)
    await _pages_back(cpu, ec.num_cpu_blocks)
    assert engine.scheduler.num_free_cpu_blocks == ec.num_cpu_blocks
    assert swaps >= 1 and launches["swap_pages"] >= 2 * swaps, (swaps, launches)
    for k in FP8_PATH_KERNELS if kv == "fp8" else PATH_KERNELS:
        assert launches[k] > 0, f"{k} never launched on the swapping engine"
    assert got == want, "the unwrapped swap run's tokens differ from the roomy run's"
    graph_report(engine, f"swap {kv}", since, smi)
    log(f"[serve swap {kv}] again through the engine's own swap methods (no "
        f"host wait): {wall:.3f} s, {engine.stats.num_steps - steps0} steps, "
        f"{swaps} swap-outs; tokens equal to the roomy engine's; both pools "
        f"full again; swap_pages launched {launches['swap_pages']} times; "
        f"launches {launches} ({smi})")
    await _release(engine, loops)
    return launches


LORA_PROMPTS = PROMPT_LENS
LORA_OF = [None, "a", "b", None, "a", "b", "a", None]
LORA_OUT = 16
LORA_SAME = 8           # leading tokens a one-adapter engine must reproduce


async def serve_lora(smi: str, adapters: dict) -> dict:
    """Multi-LoRA serving at 8B width, 32 layers, the default EngineConfig
    but for the device pages, on random weights (std 0.02, as
    phase_lora_step), where the adapters' std-0.02 halves move tokens: an
    engine with the two adapters of `adapters` read through lora_paths
    serves a mixed batch of base, `a` and `b` requests, requests 1 (`a`)
    and 2 (`b`) on one prompt. The base requests' tokens must equal those
    of an engine without adapters serving the same 8 prompts; every
    adapter request's tokens must differ from that engine's for its prompt,
    and `a`'s from `b`'s on the shared prompt; each adapter request's first
    LORA_SAME tokens must equal those of an engine that loads that adapter
    alone (so it sits in slot 1, where `b` sits in slot 2 of the mixed
    engine) and serves the same 8 prompts, the other adapter's requests as
    base requests: the same batch, so the same GEMM shapes, and the adapter
    routed by name. A request naming an unknown adapter is refused. Logs a
    decode step's device operations and device ms with adapters and without
    (torch.profiler); returns the mixed run's launches."""
    mc = LlamaModelConfig(num_layers=32, **LLAMA3_8B)
    kw = dict(model_path="", use_dummy=True, num_hbm_blocks=2048)
    top = min(128000, mc.vocab_size - 1)
    prompts = [[(29 * i + 3 * j) % top + 1 for j in range(n)]
               for i, n in enumerate(LORA_PROMPTS)]
    prompts[2] = prompts[1]
    paths = ",".join(f"{k}={v}" for k, v in adapters.items())
    engine, loops, up = await _engine(EngineConfig(**kw, lora_paths=paths), mc,
                                      92, successor=False)
    assert engine.model.lora_slots == {"a": 1, "b": 2}
    build.reset_launch_counts()
    since = graph_state(engine)
    mixed = await _serve_greedy(engine, prompts, LORA_OUT, LORA_OF)
    launches = dict(build.launch_counts)
    graph_report(engine, "lora", since, smi)
    for k in PATH_KERNELS:
        assert launches[k] > 0, f"{k} never launched on the LoRA engine"
    bad = engine.submit(RawRequest("", 4, prompt_token_ids=[1, 2, 3], lora="c"))
    assert bad.aborted and not bad.output_token_ids, "an unknown adapter was served"
    with_lora = await _decode_profile(engine, "lora", "a", smi)
    await _release(engine, loops)
    engine, loops, _ = await _engine(EngineConfig(**kw), mc, 92, successor=False)
    base = await _serve_greedy(engine, prompts, LORA_OUT)
    without = await _decode_profile(engine, "lora_off", None, smi)
    await _release(engine, loops)
    for i, lo in enumerate(LORA_OF):
        if lo is None:
            assert mixed[i] == base[i], f"base request {i}: {mixed[i]} vs {base[i]}"
        else:
            assert mixed[i] != base[i], f"adapter {lo} moved no token of request {i}"
    assert mixed[1] != mixed[2], "adapters a and b give the same tokens"
    agree = {}
    for name in adapters:
        engine, loops, _ = await _engine(
            EngineConfig(**kw, lora_paths=f"{name}={adapters[name]}"), mc, 92,
            successor=False)
        assert engine.model.lora_slots == {name: 1}
        alone = await _serve_greedy(engine, prompts, LORA_OUT,
                                    [lo if lo == name else None for lo in LORA_OF])
        await _release(engine, loops)
        for i, lo in enumerate(LORA_OF):
            if lo == name:
                assert alone[i][:LORA_SAME] == mixed[i][:LORA_SAME], (
                    name, i, alone[i], mixed[i])
                agree[i] = sum(a == b for a, b in zip(alone[i], mixed[i]))
            else:
                assert alone[i] == base[i], (name, i, alone[i], base[i])
    log(f"[serve lora] 8 requests (adapters {LORA_OF}, requests 1 and 2 on one "
        f"prompt), {LORA_OUT} tokens each, random weights: base requests equal "
        f"the engine without adapters; every adapter request differs from it "
        f"(tokens 1 and 2: a {mixed[1][:4]}, b {mixed[2][:4]}, base "
        f"{base[1][:4]}); each adapter request's first {LORA_SAME} tokens equal "
        f"a one-adapter engine's on the same batch (tokens equal of "
        f"{LORA_OUT}: {agree}); an unknown adapter refused at submit; launches "
        f"{launches} ({smi})")
    log(f"[serve lora] a decode step: {with_lora[0]:.1f} device operations and "
        f"{with_lora[1]:.3f} ms of device time with two adapters on 4 "
        f"projections, {without[0]:.1f} and {without[1]:.3f} ms without: "
        f"+{with_lora[0] - without[0]:.1f} operations, "
        f"+{with_lora[1] - without[1]:.3f} ms ({smi})")
    return launches


async def _decode_profile(engine, label, lora, smi, n_req=8, prompt=64, out_len=24):
    """Device operations (kernels and copies) and device ms a step, over 8
    requests of 64 prompt tokens and 24 output tokens (one prefill step,
    then decode steps) under torch.profiler; the table goes to
    chiprun_out/profile_<label>.txt."""
    from torch.profiler import ProfilerActivity
    reqs = [RawRequest("", out_len, lora=lora, prompt_token_ids=[
        (3 * i + j) % 1000 + 1 for j in range(prompt)]) for i in range(n_req)]
    torch.cuda.synchronize()
    steps0 = engine.stats.num_steps
    with profiling(ProfilerActivity.CPU, ProfilerActivity.CUDA) as prof:
        await asyncio.gather(*[engine.add_request_and_wait(r) for r in reqs])
        torch.cuda.synchronize()
    steps = engine.stats.num_steps - steps0
    events = prof.key_averages()
    dev = body_records(prof)
    ops = len(dev) / steps
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3 / steps
    assert ops > 0, "the profile shows no device operations"
    (OUT_DIR / f"profile_{label}.txt").write_text(events.table(
        sort_by="self_device_time_total", row_limit=40))
    log(f"[profile {label}] {n_req} requests, prompt {prompt}, {out_len} tokens "
        f"each: {steps} steps, {ops:.1f} device operations and {busy:.3f} ms "
        f"of device time a step ({smi})")
    return ops, busy


# Llama-3-8B's published config.json (meta-llama/Meta-Llama-3-8B).
LLAMA3_8B_CONFIG = {
    "architectures": ["LlamaForCausalLM"], "model_type": "llama",
    "hidden_size": 4096, "intermediate_size": 14336,
    "num_attention_heads": 32, "num_key_value_heads": 8,
    "num_hidden_layers": 32, "vocab_size": 128256,
    "max_position_embeddings": 8192, "rms_norm_eps": 1e-5,
    "rope_theta": 500000.0, "tie_word_embeddings": False,
    "hidden_act": "silu", "bos_token_id": 128000, "eos_token_id": 128001}


def phase_examples(smi: str) -> None:
    """[examples]: the port's offline example (examples/offline_torch.py) on
    the card at its tiny dummy size (examples/offline.py's: 4 layers, hidden
    256, its heads as 4 / 2 of 64), in a process of its own, as a user runs
    it: it must exit 0 and print every sequence's 20 tokens."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "examples/offline_torch.py", "--use-dummy",
                          "true"], capture_output=True, text=True, timeout=600)
    (OUT_DIR / "example_offline.log").write_text(out.stdout + out.stderr)
    assert out.returncode == 0, f"examples/offline_torch.py failed: {out.stderr[-3000:]}"
    seqs = re.findall(r"seq (\d+): \[([\d, ]+)\]", out.stdout)
    assert [int(i) for i, _ in seqs] == [0, 1, 2, 3], out.stdout[-2000:]
    assert all(len(t.split(", ")) == 20 for _, t in seqs), out.stdout[-2000:]
    decode = re.search(r"decode: .*", out.stdout).group(0)
    log(f"[examples] examples/offline_torch.py --use-dummy true on the card: exit 0 in "
        f"{time.perf_counter() - t0:.1f} s, 4 sequences of 20 tokens; {decode} ({smi})")


def http_cli(smi: str, tmp: Path):
    """Phase 5b: `python -m swiftllm_tpu_torch.server.api_server --model-path
    <dir> --use-dummy true --port <a free port>`, every engine flag at its
    default (swap with 2,048 host pages, the cache sized by profiling), on
    Llama-3-8B's config.json; once /health answers and /v1/models names
    this run's model directory (so the server that answers is this one),
    one /generate, one
    /v1/completions with logprobs and one streamed /v1/chat/completions of
    the same prompt, greedy: the three give the same token ids. Then SIGINT:
    the server must exit 0 within 60 s."""
    import signal
    import urllib.request
    (tmp / "llama3-8b").mkdir(parents=True, exist_ok=True)
    (tmp / "llama3-8b" / "config.json").write_text(json.dumps(LLAMA3_8B_CONFIG))
    log_path = OUT_DIR / "api_server.log"
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    model_dir = str(tmp / "llama3-8b")
    t0 = time.perf_counter()
    with open(log_path, "w", encoding="utf-8") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "swiftllm_tpu_torch.server.api_server",
             "--model-path", model_dir, "--use-dummy", "true",
             "--port", str(port)],
            stdout=out, stderr=subprocess.STDOUT,
            env=dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent)))
    url = f"http://127.0.0.1:{port}"

    def post(path, body):
        req = urllib.request.Request(url + path, data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        return urllib.request.urlopen(req, timeout=120)

    try:
        while True:
            assert proc.poll() is None, f"the server exited with {proc.returncode}"
            assert time.perf_counter() - t0 < 400, "the server did not come up"
            try:
                if urllib.request.urlopen(url + "/health", timeout=2).status == 200:
                    break
            except OSError:
                time.sleep(1)
        up = time.perf_counter() - t0
        served = json.load(urllib.request.urlopen(url + "/v1/models", timeout=10))
        assert served["data"][0]["id"] == model_dir, (served, model_dir)
        text = "the quick brown fox jumps"
        prompt = f"user: {text}\nassistant:"      # the dummy tokenizer's chat render
        gen = json.load(post("/generate", {"prompt": prompt, "output_len": 8}))
        ids = gen["output_token_ids"]
        cmp = json.load(post("/v1/completions", {"prompt": prompt, "max_tokens": 8,
                                                 "temperature": 0, "logprobs": 1}))
        choice = cmp["choices"][0]
        cmp_ids = [int(t) for t in re.findall(r"<(\d+)>", choice["text"])]
        lps = choice["logprobs"]["token_logprobs"]
        chunks = []
        with post("/v1/chat/completions", {"messages": [{"role": "user", "content": text}],
                                           "max_tokens": 8, "temperature": 0,
                                           "stream": True}) as resp:
            for line in resp:
                line = line.decode().strip()
                if line == "data: [DONE]":
                    break
                if line.startswith("data: "):
                    chunks.append(json.loads(line[6:]))
        streamed = "".join(c["choices"][0]["delta"].get("content", "") for c in chunks)
        chat_ids = [int(t) for t in re.findall(r"<(\d+)>", streamed)]
        stats = json.load(urllib.request.urlopen(url + "/stats", timeout=10))
        assert 1 <= len(ids) <= 8 and cmp_ids == ids and chat_ids == ids, (ids, cmp_ids, chat_ids)
        assert cmp["usage"]["completion_tokens"] == len(ids) and len(lps) == len(ids)
        assert chunks[-1]["choices"][0]["finish_reason"] in ("stop", "length")
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            rc = proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            raise AssertionError("the server hung on SIGINT")
    assert rc == 0, f"the server exited with {rc} (chiprun_out/api_server.log)"
    log(f"[http cli] api_server --use-dummy true --port {port} on Llama-3-8B's "
        f"config.json, other flags at their defaults: /health after {up:.1f} s, "
        f"/v1/models names this run's model directory; /generate, "
        f"/v1/completions (logprobs {lps}: null without --enable-logprobs) and "
        f"the streamed /v1/chat/completions ({len(chunks)} chunks) give the "
        f"same tokens {ids}; {stats['num_requests_finished']} requests "
        f"finished; exit code {rc} on SIGINT ({smi})")


async def phase_serve(smi: str, adapters: dict) -> dict:
    """Phases 4-5: the engines of SERVE_RUNS, one after another, then the
    speculative-decoding engine, the swapping engines (bf16 and fp8) and the
    LoRA engines (`adapters`: name -> peft dir)."""
    pools, outputs, rates = {}, {}, {}
    gc.collect()
    await phase_graphs(smi)
    launches = {name: await serve_engine(name, smi, pools, rates, outputs)
                for name in SERVE_RUNS}
    log("[serve] decode tok/s from graphs, 8 rows, in this run: " + ", ".join(
        f"{k} {v:.1f} ({v / rates['none']:.3f} x bf16)" for k, v in rates.items()
        if k in ("none", "int4", "int8", "fp8kv")) + f" ({smi})")
    launches["spec"] = await serve_spec(smi)
    launches["qwen2"] = await serve_qwen2(smi)
    for kv in SWAP_PAGES:
        launches[f"swap {kv}"] = await serve_swap(smi, kv)
    launches["lora"] = await serve_lora(smi, adapters)
    # The same requests through single steps, fused windows and deferred
    # windows: every request's tokens equal, the greedy and the seeded
    # sampled ones alike.
    base = outputs[MS_RUNS[0]]
    for name in MS_RUNS[1:]:
        for i, (a, b) in enumerate(zip(base, outputs[name])):
            assert a == b, (f"request {i} "
                            f"({'sampled' if i in MS_SAMPLED else 'greedy'}): "
                            f"{name} differs from {MS_RUNS[0]}: {b} vs {a}")
    log(f"[serve] {', '.join(MS_RUNS)}: all {len(base)} requests token-equal "
        f"({len(base) - len(MS_SAMPLED)} greedy, {len(MS_SAMPLED)} sampled "
        f"with seeds; {MS_OUT_LEN} tokens each); sampled request 1 begins "
        f"{base[1][:8]}, greedy request 0 {base[0][:8]}")
    return launches


# The device kernel each counted C entry launches, once a call, by the name
# the profiler records it under.
DEVICE_KERNEL = {"paged_decode_attention": "paged_decode_kernel",
                 "paged_decode_attention_pend": "paged_decode_kernel",
                 "paged_prefill_attention": "paged_prefill_kernel",
                 "paged_prefill_attention_bf16s": "paged_prefill_kernel",
                 "int4_matmul": "int4_matmul_kernel",
                 "int8_matmul": "int8_matmul_kernel",
                 "add_rms_norm": "add_rms_norm_kernel",
                 "rope_qkv": "rope_qkv_kernel<false",
                 "rope_qkv_fp8": "rope_qkv_kernel<true",
                 "silu_mul": "silu_mul_kernel",
                 "swap_pages": "swap_pages_kernel"}
# Device kernels recorded under more than one name: the weight kernels'
# wide configuration (csrc/wide_matmul.cuh, T > 256) under its own.
DEVICE_NAMES = {"int4_matmul_kernel": ("int4_matmul_kernel", "wide_matmul_kernel<true"),
                "int8_matmul_kernel": ("int8_matmul_kernel", "wide_matmul_kernel<false")}


def is_kernel(event, kern: str) -> bool:
    """Whether a profiler event is device kernel `kern` (DEVICE_KERNEL's
    value) under any of its names."""
    return (event.self_device_time_total > 0
            and any(n in event.key for n in DEVICE_NAMES.get(kern, (kern,))))


def device_launches(events, counts: dict) -> dict:
    """Holds launch counts (`counts`: entry -> launches, a graph replay's
    counted as its capture recorded) against the kernels the profiler saw
    on the device (`events`: key_averages() of the same run). The profiler
    is not an exact counter: CUPTI may drop a few activity records of a long
    run (one run on the H100 saw 5,145 of 5,152 launches). A kernel that ran
    but was not counted, or counted but never queued, shows as more on the
    device than counted or as fewer than 99% of the count: either fails.
    Returns {device kernel: (counted, on the device)}."""
    assert set(counts) <= set(DEVICE_KERNEL), set(counts) - set(DEVICE_KERNEL)
    out = {}
    for kern in sorted(set(DEVICE_KERNEL.values())):
        counted = sum(n for k, n in counts.items() if DEVICE_KERNEL[k] == kern)
        on_dev = sum(e.count for e in events if is_kernel(e, kern))
        lost = counted - on_dev
        assert 0 <= lost and 100 * lost <= counted, (kern, counted, on_dev)
        out[kern] = (counted, on_dev)
    return out


async def _profile(engine, smi: str, quant: str, n_req=8, prompt=64,
                   out_len=24, prefill_ms=None):
    """Where a step's time goes: n_req short requests (so mostly decode
    steps, after one prefill step of n_req x prompt tokens) under
    torch.profiler. Prints the kernels with the most device time and the
    device's busy share of the wall time; the full table goes to
    chiprun_out/profile_<quant>.txt. Every kernel's launch count is held
    against the kernels the profiler saw on the device (device_launches):
    replays count what their captures recorded, and this shows that they
    ran them. The quantized engines' runs (quant int4, int8 and their
    proj routes) also time each step between CUDA events and stream the
    requests: the largest step's (the prefill's) device ms, the TTFT and
    the engine's KV pages. A step of more than 256 tokens (the prefill)
    runs alone on the card, synchronised before and after, between two
    sleep kernels that mark it on the device's timeline: its device ms is
    the sum of the device records between them (step_device_ms), also put
    in prefill_ms[quant] when given. Its CUDA events' span, printed beside
    it, also takes in any time the card waits for the host, as on the proj
    route, which runs eagerly."""
    from torch.profiler import ProfilerActivity
    quantized = quant.startswith(("int4", "int8"))
    step_ms, execute = [], engine.model.execute_packed
    prefill_ms = {} if prefill_ms is None else prefill_ms

    def timed(flat, key, *a, **kw):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        alone = key.tokens > im.WIDE_ABOVE
        if alone:
            torch.cuda.synchronize()
            torch.cuda._sleep(STEP_MARK_CYCLES)
        e0.record()
        out = execute(flat, key, *a, **kw)
        e1.record()
        if alone:
            torch.cuda._sleep(STEP_MARK_CYCLES)
            torch.cuda.synchronize()
        step_ms.append((key.tokens, e0, e1, alone))
        return out

    async def first_token(r):
        t_sub, first = time.perf_counter(), None
        async for _ in engine.add_request_and_stream(r):
            first = first or time.perf_counter() - t_sub
        return first
    for attempt in range(2):
        torch.cuda.synchronize()
        steps0 = engine.stats.num_steps
        build.reset_launch_counts()
        step_ms.clear()
        reqs = [RawRequest("", out_len, prompt_token_ids=[
            (3 * i + j) % 1000 + 1 for j in range(prompt)]) for i in range(n_req)]
        if quantized:
            engine.model.execute_packed = timed
        try:
            with profiling(ProfilerActivity.CPU, ProfilerActivity.CUDA) as prof:
                t0 = time.perf_counter()
                ttft = await asyncio.gather(*[
                    first_token(r) if quantized else engine.add_request_and_wait(r)
                    for r in reqs])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            engine.model.execute_packed = execute
        lost = edges_lost(prof)
        if not lost:
            break
        # The profiler, not the engine, failed: the same requests once more,
        # then the checks below on what it kept.
        log(f"[profile {quant}] {lost}" + ("" if attempt else
                                          "; profiling the same requests again"))
    events = prof.key_averages()
    busy = sum(e.time_range.elapsed_us() for e in body_records(prof)
               if not is_mark(e)) / 1e6
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)
    (OUT_DIR / f"profile_{quant}.txt").write_text(events.table(
        sort_by="self_device_time_total", row_limit=40))
    log(f"[profile {quant}] {n_req} requests, prompt {prompt}, {out_len} tokens each: "
        f"wall {1e3 * wall:.1f} ms, device busy {1e3 * busy:.1f} ms "
        f"({100 * busy / wall:.1f}%), {engine.stats.num_steps - steps0} "
        f"dispatches; a token of a request: wall {1e3 * wall / out_len:.3f} ms, "
        f"device {1e3 * busy / out_len:.3f} ms, host (the rest) "
        f"{1e3 * (wall - busy) / out_len:.3f} ms; {n_req * out_len / wall:.1f} "
        f"tok/s ({smi})")
    for e in top[:8]:
        log(f"[profile {quant}]   {e.self_device_time_total / 1e3:9.3f} ms "
            f"{e.count:6d}x  {e.key[:90]}")
    n_at, at_ms, at_share = aten_share(events)
    steps = engine.stats.num_steps - steps0
    log(f"[profile {quant}] PyTorch's own elementwise, reduction and copy "
        f"kernels (at::native): {n_at} launches, {n_at / steps:.1f} a dispatch, "
        f"{at_ms:.3f} ms, {100 * at_share:.1f}% of device time")
    seen = device_launches(events, build.launch_counts)
    # A kernel record spans the launch's whole stay on the device, from its
    # start (which a programmatic launch may bring forward, to wait there
    # for the kernel before) to its end: it hides none of the launch's time,
    # whatever overlaps it. The programmatic launches' rows take it: the
    # bf16 run's add_rms_norm and rope_qkv, the fp8 run's rope_qkv_fp8.
    for entry in {"none": ("add_rms_norm", "rope_qkv"),
                  "fp8kv": ("rope_qkv_fp8",)}.get(quant, ()):
        recs = [e for e in events if is_kernel(e, DEVICE_KERNEL[entry])]
        n = sum(e.count for e in recs)
        t = sum(e.self_device_time_total for e in recs) / 1e3
        STEP_LAUNCH_MS[entry] = t / n
        log(f"[profile {quant}] {entry}: {STEP_LAUNCH_MS[entry]:.4f} ms a launch "
            f"on the device ({n} launches, {n / steps:.1f} a dispatch: the decode "
            f"steps' 128-token bucket and one prefill step's), {t:.3f} ms, "
            f"{100 * t / (1e3 * busy):.2f}% of device time")
    if quant in ("none", "fp8kv"):
        ew = {k: sum(e.self_device_time_total for e in events
                     if is_kernel(e, DEVICE_KERNEL[k])) / 1e3 for k in lo.KERNELS}
        log(f"[profile {quant}] the layer's elementwise kernels: "
            + ", ".join(f"{k} {t:.3f} ms ({100 * t / (1e3 * busy):.2f}%)"
                        for k, t in ew.items() if t)
            + f"; together {100 * sum(ew.values()) / (1e3 * busy):.2f}% of device "
            f"time, {sum(ew.values()) / steps:.4f} ms a dispatch")
    log(f"[profile {quant}] launches counted, and kernels the profiler saw on "
        f"the device: " + ", ".join(f"{k} {n} / {d}" for k, (n, d) in seen.items()
                                    if n or d))
    if quant == "int4":
        # One device kernel per INT4 projection: the split merge runs inside
        # the launch, no second pass.
        kern = [e for e in events if is_kernel(e, "int4_matmul_kernel")]
        launched, n_dev = seen["int4_matmul_kernel"]
        assert launched > 0, "int4_matmul never launched"
        assert not [e.key for e in events if "int4_matmul" in e.key
                    and e.self_device_time_total > 0 and e not in kern]
        t_int4 = sum(e.self_device_time_total for e in kern) / 1e3
        int4_steps = launched // (7 * engine.model_config.num_layers + 1)
        log(f"[profile {quant}] int4_matmul: {launched} launches, {n_dev} INT4 "
            f"kernels on the device ({launched - n_dev} record(s) lost to the "
            f"profiler; {len(kern)} instance(s), no second pass), "
            f"{t_int4:.3f} ms, {100 * t_int4 / (1e3 * busy):.1f}% of device time; "
            f"{t_int4 / int4_steps:.3f} ms a step in each of the {int4_steps} "
            "steps that ran it (7 projections a layer and the head)")
    if quant.startswith("int") or quant == "none":
        c_ms, c_share = copy_share(events)
        log(f"[profile {quant}] copy kernels (direct_copy_kernel: dtype "
            f"conversions, where an int8 weight becomes bf16): {c_ms:.3f} ms, "
            f"{100 * c_share:.1f}% of device time, {c_ms / steps:.3f} ms a "
            f"dispatch")
        if quant in ("int4", "int8"):
            # No weight is converted: the copies are the bf16 engine's (0.06
            # ms a dispatch: the logits and the tables). One step's weight
            # conversions took 19.5 ms (PR 12), 0.8 ms a dispatch over 24.
            assert c_ms / steps < 0.2, f"{quant}: weight conversions ({c_ms:.3f} ms)"
    if quantized:
        i = max(range(len(step_ms)), key=lambda j: step_ms[j][0])
        tokens, e0, e1, alone = step_ms[i]
        assert alone, tokens
        kern = "int8_matmul_kernel" if quant.startswith("int8") else "int4_matmul_kernel"
        dev_ms, n_rec, n_weight = step_device_ms(
            prof, sum(t[3] for t in step_ms[:i]), sum(t[3] for t in step_ms), kern)
        span = e0.elapsed_time(e1)
        assert 0 < dev_ms <= span, (dev_ms, span)
        ttft = sorted(ttft)
        prefill_ms[quant] = dev_ms
        log(f"[profile {quant}] the prefill step (the largest, a {tokens}-token bucket): "
            f"{dev_ms:.3f} ms of device time (the sum of its {n_rec} kernel "
            f"records, {n_weight} of them {kern}; {span:.3f} ms between its "
            f"CUDA events); TTFT p50 {1e3 * ttft[len(ttft) // 2]:.1f} ms, max "
            f"{1e3 * ttft[-1]:.1f} ms; {engine.model.num_hbm_blocks} KV pages ({smi})")
    return 1e3 * busy, steps


STEP_MARK_CYCLES = 1000   # _profile's sleep kernels around a step


PROFILE_PAD_S = 0.5          # the card idle before and after a profiled body
EDGE_MARK_CYCLES = 200_000   # the sleep kernels at a profiled body's edges
EDGE_MARK_US = 20            # a sleep kernel longer than this is an edge mark


def is_mark(event) -> bool:
    """Whether a profiler record is one of the sleep kernels (PyTorch's
    spin_kernel, which nothing else launches) that mark a profiled body's
    edges (long) or a step inside it (short)."""
    return "spin_kernel" in event.name


def device_records(prof) -> list:
    """The device records (kernels, copies, sets) of profile `prof`, in
    order of their start."""
    from torch.autograd import DeviceType
    return sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                   and not e.is_user_annotation
                   and getattr(e, "activity_type", None) != "gpu_user_annotation"),
                  key=lambda e: e.time_range.start)


def edge_marks(records: list) -> list:
    """The indices, in `records` (device_records), of the long sleep
    kernels that mark a profiled body's edges (profiling)."""
    return [k for k, e in enumerate(records)
            if is_mark(e) and e.time_range.elapsed_us() > EDGE_MARK_US]


def body_records(prof) -> list:
    """The device records of profiling's body: those between its marks, or,
    where the profiler dropped a mark (edges_lost), every record but the
    sleep kernels."""
    evs = device_records(prof)
    edges = edge_marks(evs)
    if len(edges) != 2:
        return [e for e in evs if not is_mark(e)]
    return evs[edges[0] + 1:edges[1]]


def edges_lost(prof) -> str:
    """'' if the profiler kept both of profiling's edge marks; else what it
    kept. With both kept it kept every record of the body: it drops
    records by their times only."""
    evs = device_records(prof)
    edges = edge_marks(evs)
    if len(edges) == 2:
        return ""
    return (f"the profiler kept {len(edges)} of the body's 2 edge marks "
            f"(records {edges} of {len(evs)}, "
            f"{sum(map(is_mark, evs)) - len(edges)} step marks)")


@contextlib.contextmanager
def profiling(*activities):
    """torch.profiler over the body: first a few small kernels and
    PROFILE_PAD_S of an idle card, then a long sleep kernel that marks the
    body's start; after it another that marks its end, and PROFILE_PAD_S
    more. The profiler keeps only the device records whose times, put on
    the host's clock, fall between its start and its stop, and on the H100
    machines the two clocks drift apart (kineto: "GPU op timestamp <
    runtime timestamp" by up to 18 ms within one profile). Records at a
    run's edges went missing so: three of a replay's first norms, a step
    mark, 896 records of the eager `proj` route's profile (kineto's
    "Out-of-range = 896") and once some four of its steps. The pads keep
    the body's records away from the edges; the marks show whether they
    did (edges_lost)."""
    from torch.profiler import profile
    with profile(activities=list(activities)) as prof:
        x = torch.zeros(1024, device=DEVICE)
        for _ in range(4):
            x.add_(1)
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
        torch.cuda._sleep(EDGE_MARK_CYCLES)
        yield prof
        torch.cuda.synchronize()
        torch.cuda._sleep(EDGE_MARK_CYCLES)
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)


def step_device_ms(prof, j: int, n: int, kern: str) -> tuple:
    """(device ms, device records, records of device kernel `kern`) of the
    j-th of the n steps that _profile marked in profile `prof`: the device
    records (kernels, copies, sets) between the step's two short sleep
    kernels (is_mark; the long ones mark the profiled body's edges), their
    durations summed. The step ran alone on the card, synchronised before
    and after, so every record there is its own. (The marks are kernels,
    not record_function ranges: the profiler records no host ranges on the
    engine's model thread, where the step runs.)"""
    evs = device_records(prof)
    marks = [k for k, e in enumerate(evs)
             if is_mark(e) and e.time_range.elapsed_us() <= EDGE_MARK_US]
    assert len(marks) == 2 * n, (
        f"{len(marks)} sleep kernels for {n} marked steps, at records {marks} "
        f"of {len(evs)}; the first records: "
        f"{[(e.name[:40], e.time_range.start) for e in evs[:6]]}")
    inside = evs[marks[2 * j] + 1:marks[2 * j + 1]]
    names = DEVICE_NAMES.get(kern, (kern,))
    return (sum(e.time_range.elapsed_us() for e in inside) / 1e3, len(inside),
            sum(any(n in e.name for n in names) for e in inside))


async def _pages_back(mgr, free0, timeout=10.0):
    """The engine frees a finished request's pages at its next scheduling
    round; wait for that, then require the pool back at its initial size."""
    t_end = time.perf_counter() + timeout
    while mgr.num_free_blocks != free0 and time.perf_counter() < t_end:
        await asyncio.sleep(0.01)
    assert mgr.num_free_blocks == free0, (mgr.num_free_blocks, free0)


def graph_state(engine) -> tuple:
    """(graphs captured, replays so far, engine steps so far, keys first
    used outside a warm-up so far) of an engine whose model serves from
    CUDA graphs, as every engine at tp = 1 on the card does."""
    g = engine.model.graphs
    assert g is not None, "the model runs eagerly: at tp = 1 on the card it must not"
    return (len(g.table), sum(e.replays for e in g.table.values()),
            engine.stats.num_steps, g.first_use)


def assert_no_captures(engine, since: tuple, label: str) -> None:
    """Since `since` (graph_state), the engine served every step as a
    replay: no graph captured, no key first used. What a warm-up owes
    serving within its buckets."""
    n0, r0, s0, f0 = since
    n, r, s, f = graph_state(engine)
    assert n == n0 and f == f0, (
        f"{label}: serving captured {n - n0} graphs ({f - f0} keys first used) "
        f"after the warm-up")
    assert r - r0 == s - s0 > 0, (label, r - r0, s - s0)


# What a graph pool may hold past the profile's budget: the caching
# allocator keeps allocations under 1 MiB (a graph's static tokens and
# logprobs) in segments of 2 MiB, at most one such segment a graph.
GRAPH_POOL_SMALL = 2 << 20


def check_pool(engine, label: str, pinned: int = 0) -> str:
    """Where the profile set the KV pages, the engine's graph pool must lie
    within the profile's budget for it, GRAPH_POOL_SMALL a graph held and
    `pinned` (bytes of outputs that graphs outside serving kept, such as
    _graph_step_check's logits). Returns the words for the log."""
    g, prof = engine.model.graphs, engine.model.profiled
    if not prof:
        return ""
    allowed = prof["graph_pool"] + pinned + GRAPH_POOL_SMALL * len(g.table)
    assert g.pool_bytes <= allowed, (
        f"{label}: the graph pool reserved {g.pool_bytes / 1e6:.1f} MB, the "
        f"profile budgeted {prof['graph_pool'] / 1e6:.1f} MB (allowed "
        f"{allowed / 1e6:.1f} MB with {len(g.table)} graphs and "
        f"{pinned / 1e6:.1f} MB pinned)")
    lost = (prof["graph_pool"] + prof["graph_execs"]) / prof["block_bytes"]
    pages = engine.model.num_hbm_blocks
    return (f" (within the {allowed / 1e6:.1f} MB allowed); the profile's "
            f"captures reserved {prof['graph_pool'] / 1e6:.1f} MB of it, "
            f"beside {prof['scratch'] / 1e6:.1f} MB of eager scratch, and "
            f"kept {prof['graph_execs'] / 1e6:.1f} MB for the executables of "
            f"{prof['graphs']} warm-up graphs: pool and executables "
            f"{lost:.1f} KV pages, {100 * lost / (pages + lost):.2f}% of the "
            f"{pages + lost:.0f} the cache had without them")


# How far the device memory a warm-up takes outside the allocator may pass
# the profile's reserve for its graphs' executables: the reserve's bytes a
# step come from fewer graphs, and the warm-up's eager steps load kernels
# no step ran before (the decode bucket's GEMMs, the sampler's), also
# outside the allocator.
GRAPH_EXECS_SLACK = 1.15
GRAPH_EXECS_LOADS = 64 << 20


def memory_mark() -> tuple:
    """(free device bytes, bytes the allocator reserved), synchronized."""
    torch.cuda.synchronize()
    return torch.cuda.mem_get_info()[0], torch.cuda.memory_reserved()


def check_warmup_memory(engine, before: tuple, label: str) -> str:
    """Since `before` (memory_mark, taken just before a default warm-up):
    the device memory taken outside the allocator, most of it the graphs'
    executables, must lie within GRAPH_EXECS_SLACK of the profile's reserve
    for them and GRAPH_EXECS_LOADS. Returns the words for the log."""
    prof = engine.model.profiled
    free, held = memory_mark()
    outside = (before[0] - free) - (held - before[1])
    allowed = GRAPH_EXECS_SLACK * prof["graph_execs"] + GRAPH_EXECS_LOADS
    assert outside <= allowed, (
        f"{label}: the warm-up took {outside / 1e6:.1f} MB outside the "
        f"allocator, the profile kept {prof['graph_execs'] / 1e6:.1f} MB for "
        f"{prof['graphs']} graphs")
    return (f"device memory free {before[0] / 1e9:.3f} GB before, "
            f"{free / 1e9:.3f} GB after: {outside / 1e6:.1f} MB outside the "
            f"allocator (the graphs' executables; the profile kept "
            f"{prof['graph_execs'] / 1e6:.1f} MB for {prof['graphs']} graphs, "
            f"{allowed / 1e6:.1f} MB allowed), "
            f"{(before[0] - free) / prof['block_bytes']:.1f} KV pages' worth "
            f"in all")


def graph_report(engine, label: str, since: tuple, smi: str,
                 pinned: int = 0) -> None:
    """Every engine step since `since` (graph_state) was the replay of a
    graph, or a key's first use (run eagerly, then captured); logs the
    table, its capture seconds and pool, and holds the pool to the
    profile's budget (check_pool)."""
    n0, r0, s0, f0 = since
    n, r, s, f = graph_state(engine)
    assert (n - n0) + (r - r0) == s - s0, (label, n - n0, r - r0, s - s0)
    assert f - f0 == n - n0, (label, f - f0, n - n0)
    assert r > r0, f"{label}: no step was a replay"
    g = engine.model.graphs
    log(f"[graphs {label}] {s - s0} steps: {n - n0} keys captured at first use "
        f"(first_use {f0} -> {f}), {r - r0} replays; {n} graphs held, "
        f"{g.capture_s:.2f} s capturing, "
        f"pool {g.pool_bytes / 1e6:.1f} MB reserved"
        f"{check_pool(engine, label, pinned)} ({smi})")


def eager_twin(model: LlamaModel) -> LlamaModel:
    """A LlamaModel built with cuda_graphs=False (the only way to the eager
    step on the card) that shares `model`'s weights, cache, feedback buffer,
    block managers and host pool: swapped in for `engine.model`, the same
    engine runs its steps eagerly, on the same state."""
    twin = LlamaModel(model.engine_config, model.model_config,
                      device=model.device, cuda_graphs=False)
    assert twin.graphs is None
    for k in ("params", "kv_cache", "token_feedback", "hbm_block_mgrs",
              "cpu_block_mgr", "cpu_cache", "num_blocks_per_shard",
              "lora_slots", "lora_targets"):
        setattr(twin, k, getattr(model, k))
    return twin


GRAPH_OUT = 32


def _graph_step_check(model, twin, label, specs, smi) -> dict:
    """One step of `specs` (_requests) with logits, three times on the same
    state (its cache writes are the same bytes each time): eagerly (`twin`),
    at its key's first use (eager, then captured) and as the replay, under
    torch.profiler. The replay's logits against the eager step's; the
    launches the capture recorded against the eager step's and the first
    use's, and the kernels the profiler saw the replay run against them
    (device_launches). Returns the logits' agreement and the bytes of the
    graph's static logits, which its pool keeps reserved."""
    from torch.profiler import ProfilerActivity
    mgr = model.hbm_block_mgrs[0]
    for i, (_, cached, _) in enumerate(specs):
        if cached:
            mgr.allocate_for_seq(i, cached)
    out, counts = {}, {}
    for run, m in (("eager", twin), ("first use", model), ("replay", model)):
        build.reset_launch_counts()
        sched = _requests(specs, model.model_config.vocab_size)
        with (profiling(ProfilerActivity.CUDA) if run == "replay"
              else contextlib.nullcontext()) as prof:
            tokens, rows, lg = m.forward(sched, return_logits=True)
            torch.cuda.synchronize()
        counts[run] = {k: v for k, v in build.launch_counts.items() if v}
        live = [i for i, r in enumerate(rows) if r is not None]
        out[run] = (tokens[live], torch.from_numpy(lg[live]))
    entry = [e for k, e in model.graphs.table.items()
             if k.bucket == model.last_key and k.return_logits]
    assert len(entry) == 1 and entry[0].replays == 1, entry
    launches = entry[0].launches
    assert counts["eager"] == counts["first use"] == launches, (
        label, counts, launches)
    if lost := edges_lost(prof):
        log(f"[graphs] {label} step: {lost}")
    seen = device_launches(prof.key_averages(), launches)
    assert all(n == d for n, d in seen.values()), (label, seen)
    a, b = out["eager"][1], out["replay"][1]
    assert torch.isfinite(a).all() and torch.isfinite(b).all()
    diff = (a - b).abs().max().item()
    same = torch.equal(a, b)
    assert (out["eager"][0] == out["replay"][0]).all(), f"{label}: greedy tokens differ"
    assert diff <= CLEAR_MARGIN / 2, (label, diff)
    model.free_seqs_resources([x.request for x in sched])
    log(f"[graphs] {label} step ({model.last_key}): the replay's logits "
        f"{'bit-identical to' if same else f'{diff:.4g} at most off'} the eager "
        f"step's ({a.numel()} logits), greedy tokens equal; the capture "
        f"recorded {launches}, the launches of the eager step and of the first "
        f"use (eager, then captured); the replay ran "
        f"{ {k: d for k, (_, d) in seen.items() if d} } on the device ({smi})")
    return dict(bit_identical=same, max_abs_diff=diff,
                logits_bytes=entry[0].outputs[1].nbytes)


async def phase_graphs(smi: str) -> None:
    """[graphs], phase 4: the default EngineConfig (swap preemption, 2,048
    host pages) at 8B width, 32 layers, bf16, seeded weights (std 0.02):
    the default warm-up (both temperatures, every plan of each bucket): its
    graphs, wall time, capture seconds, pool against the profile's budget,
    the device memory it took beside the pool against the profile's
    reserve for the graphs' executables, and the KV pages both cost; a
    decode step of 8 rows and a mixed step (8 decode rows and a 512-token
    chunk), each eagerly, at its key's first use and as a replay
    (_graph_step_check); the 8 requests of the bf16 run (GRAPH_OUT tokens
    each) served eagerly (the eager twin on the same engine) and from
    graphs, greedy and then with three of them sampled (temperature 0.8,
    top-k 20, seeded, as the logprob engines' are): tokens equal, and no
    graph captured while serving (assert_no_captures); the table cleared and
    `warmup(bucket_keys)` with the greedy buckets served: exactly those
    buckets captured, no step run, and the same requests again capture
    nothing new and give the same tokens; two planted faults: a warm-up with
    its sampled pass patched out must fail the zero-capture check on the
    sampled requests, and replays whose batch is not copied into the static
    input (CapturedStep.load made a no-op) must fail the token check."""
    from swiftllm_tpu_torch.server import engine as engine_mod
    from swiftllm_tpu_torch.worker import graphs as graphs_mod
    mc = LlamaModelConfig(num_layers=32, **LLAMA3_8B)
    ec = EngineConfig(model_path="", use_dummy=True)
    t0 = time.perf_counter()
    engine = Engine(ec, mc, device=DEVICE)
    with loading(77):
        await engine.initialize(tokenizer_backend="inline")
    model = engine.model
    table = model.graphs.table
    prof = model.profiled
    log(f"[graphs] the default EngineConfig's engine up in "
        f"{time.perf_counter() - t0:.1f} s: {model.num_hbm_blocks} pages of "
        f"{ec.block_size}; profile: eager scratch {prof['scratch'] / 1e6:.1f} "
        f"MB, graph pool {prof['graph_pool'] / 1e6:.1f} MB "
        f"({prof['graph_pool'] / prof['block_bytes']:.1f} pages), the "
        f"executables of {prof['graphs']} warm-up graphs "
        f"{prof['graph_execs'] / 1e6:.1f} MB "
        f"({prof['graph_execs'] / prof['block_bytes']:.1f} pages) ({smi})")
    twin = loops = None
    top = min(128000, mc.vocab_size - 1)
    prompts = [[(13 * i + 5 * j) % top + 1 for j in range(n)]
               for i, n in enumerate(PROMPT_LENS)]
    mgr = model.hbm_block_mgrs[0]
    free0 = mgr.num_free_blocks

    async def serve(m, label, sampled=False):
        engine.model = m
        build.reset_launch_counts()
        torch.cuda.synchronize()
        t_run = time.perf_counter()
        try:
            if sampled:
                res = await asyncio.gather(*[engine.add_request_and_wait(
                    RawRequest("", GRAPH_OUT, prompt_token_ids=p,
                               **(dict(temperature=0.8, top_k=20,
                                       seed=MS_SAMPLED[i])
                                  if i in MS_SAMPLED else {})))
                    for i, p in enumerate(prompts)])
                toks = [list(t) for _, t in res]
            else:
                toks = await _serve_greedy(engine, prompts, GRAPH_OUT)
            torch.cuda.synchronize()
        finally:
            engine.model = model
        wall = time.perf_counter() - t_run
        await _pages_back(mgr, free0)
        for k in PATH_KERNELS:
            assert build.launch_counts[k] > 0, f"{k} never launched ({label})"
        return toks, wall
    try:
        mem_w0 = memory_mark()
        pool_w0 = model.graphs.pool_bytes
        # Where the device memory outside the allocator goes: the warm-up's
        # steps (eager first uses and their captures) against its other
        # captures, each call between two synchronizations.
        spent = {"forward": [0, 0, 0], "capture": [0, 0, 0]}

        def measured(name):
            fn = getattr(model, name)

            def call(*a, **kw):
                f0, h0 = memory_mark()
                out = fn(*a, **kw)
                f1, h1 = memory_mark()
                acc = spent[name]
                acc[0] += (f0 - f1) - (h1 - h0)
                acc[1] += h1 - h0
                acc[2] += out if name == "capture" else 1
                return out
            setattr(model, name, call)
        for name in spent:
            measured(name)
        t0 = time.perf_counter()
        try:
            await engine.warmup()
        finally:
            for name in spent:
                delattr(model, name)
        warm = time.perf_counter() - t0
        log(f"[graphs] the warm-up's device memory outside the allocator: "
            f"{spent['forward'][0] / 1e6:.1f} MB in its {spent['forward'][2]} "
            f"steps (eager, each followed by its own capture; the allocator "
            f"reserved {spent['forward'][1] / 1e6:.1f} MB more), "
            f"{spent['capture'][0] / 1e6:.1f} MB in its "
            f"{spent['capture'][2]} other captures (allocator "
            f"{spent['capture'][1] / 1e6:.1f} MB) ({smi})")
        buckets = sorted({k.bucket for k in table},
                         key=lambda k: (k.sampling, k.q_len, k.tokens))
        log(f"[graphs] the default warm-up: {len(table)} graphs in {warm:.2f} s "
            f"of wall, {model.graphs.capture_s:.2f} s of it capturing; "
            f"{len(buckets)} buckets (tokens, q bucket, sampling) "
            f"{[(k.tokens, k.q_len, k.sampling) for k in buckets]}; graphs "
            f"a bucket {[sum(g.bucket == k for g in table) for k in buckets]}; "
            f"pool {model.graphs.pool_bytes / 1e6:.1f} MB reserved "
            f"({(model.graphs.pool_bytes - pool_w0) / 1e6:.1f} MB by the "
            f"warm-up; the profile budgeted {prof['graph_pool'] / 1e6:.1f} "
            f"MB){check_pool(engine, 'warm-up')}; "
            f"{check_warmup_memory(engine, mem_w0, 'warm-up')} ({smi})")
        assert model.graphs.first_use == 0, model.graphs.first_use
        assert len(table) == prof["graphs"], (len(table), prof["graphs"])
        twin = eager_twin(model)
        dec = [(64 + 37 * i, 64 + 37 * i, 1) for i in range(8)]
        pinned = sum(_graph_step_check(model, twin, label, specs, smi)
                     ["logits_bytes"] for label, specs in (
                         ("decode", dec), ("mixed", dec + [(512, 0, 512)])))
        loops = asyncio.create_task(engine.start_all_event_loops())
        want, wall_e = await serve(twin, "eager")
        want_s, wall_es = await serve(twin, "eager, sampled", sampled=True)
        since = graph_state(engine)
        replays0 = {k: e.replays for k, e in table.items()}
        got, wall_g = await serve(model, "graphs")
        served = {k.bucket for k, e in table.items()
                  if e.replays > replays0.get(k, 0)}
        assert_no_captures(engine, since, "greedy")
        since_s = graph_state(engine)
        got_s, wall_gs = await serve(model, "graphs, sampled", sampled=True)
        assert_no_captures(engine, since_s, "sampled")
        graph_report(engine, "graphs", since, smi, pinned)
        assert got == want, "the graph engine's tokens differ from the eager engine's"
        assert got_s == want_s, "sampled tokens from graphs differ from eager ones"
        assert got_s != want, "the sampled requests gave the greedy tokens"
        log(f"[graphs] 8 requests, {GRAPH_OUT} tokens each, greedy and then "
            f"{len(MS_SAMPLED)} of them sampled: the graph engine's tokens "
            f"equal the eager engine's (request 0 {got[0][:6]}, sampled "
            f"request 1 {got_s[1][:6]}), no graph captured while serving "
            f"after the warm-up; wall {wall_e:.3f} / {wall_es:.3f} s eager, "
            f"{wall_g:.3f} / {wall_gs:.3f} s from graphs ({smi})")
        keys = sorted(served, key=lambda k: (k.tokens, k.q_len, k.sampling))
        assert not any(k.sampling for k in keys), keys
        # The graphs' executables apart from eager steps: the device memory
        # freed outside the allocator when the table is dropped, and taken
        # there by captures that run no step (warmup(bucket_keys)).
        dropped = len(table)
        mem0 = memory_mark()
        model.graphs.clear()
        gc.collect()
        mem1 = memory_mark()
        steps0 = engine.stats.num_steps
        t0 = time.perf_counter()
        await engine.warmup(keys)
        warm_keys = time.perf_counter() - t0
        mem2 = memory_mark()
        freed = (mem1[0] - mem0[0]) + (mem1[1] - mem0[1])
        taken = (mem1[0] - mem2[0]) - (mem2[1] - mem1[1])
        log(f"[graphs] dropping the {dropped} graphs freed {freed / 1e6:.1f} "
            f"MB outside the allocator, and warmup(bucket_keys)' {len(table)} "
            f"captures then took {taken / 1e6:.1f} MB there (CUDA keeps "
            f"the executables' memory: graphs.ExecMemory, "
            f"{mc.num_layers * graphs_mod.exec_memory(model.device).per_unit / 1e6:.2f} "
            f"MB a step graph of {mc.num_layers} layers as the profiles "
            f"measured it) ({smi})")
        warmed = dict(table)
        assert {k.bucket for k in warmed} == set(keys), (keys, list(warmed))
        assert engine.stats.num_steps == steps0
        since = graph_state(engine)
        again, _ = await serve(model, "warmed")
        graph_report(engine, "warmed", since, smi, pinned)
        assert table == warmed, "serving the warmed buckets captured more graphs"
        assert again == want, "tokens after warmup(bucket_keys) differ"
        log(f"[graphs] warmup(bucket_keys) of the {len(keys)} greedy buckets "
            f"served ({[(k.tokens, k.q_len) for k in keys]}): {len(warmed)} "
            f"graphs, every plan of each, in {warm_keys:.2f} s, no step run; "
            f"the same requests again captured nothing new, tokens equal ({smi})")
        temperatures, engine_mod.WARMUP_TEMPERATURES = (
            engine_mod.WARMUP_TEMPERATURES, (0.0,))
        try:
            await engine.warmup()
        finally:
            engine_mod.WARMUP_TEMPERATURES = temperatures
        since = graph_state(engine)
        faulty, _ = await serve(model, "greedy-only warm-up", sampled=True)
        try:
            assert_no_captures(engine, since, "greedy-only warm-up")
        except AssertionError as e:
            caught = str(e)
        else:
            raise AssertionError("the planted fault (a warm-up without its "
                                 "sampled pass) passed the zero-capture check")
        assert faulty == want_s
        log(f"[graphs] planted fault, a warm-up with its sampled pass patched "
            f"out: the sampled requests fail the zero-capture check "
            f"({caught}), rejected")
        real_load = graphs_mod.CapturedStep.load
        graphs_mod.CapturedStep.load = lambda self, flat: None
        try:
            stale, _ = await serve(model, "fault")
        finally:
            graphs_mod.CapturedStep.load = real_load
        assert stale != want, "the planted fault (batches not copied in) passed"
        log(f"[graphs] planted fault, replays without their batch copied into "
            f"the static input: tokens differ from the eager engine's, rejected "
            f"(request 0 {stale[0][:6]})")
    finally:
        if twin is not None:      # it holds the weights and the cache too
            twin.params = twin.kv_cache = twin.token_feedback = None
            twin.cpu_cache = None
        twin = model = table = None
        await _release(engine, loops)


async def compare_graphs(smi: str, rounds: int = 5):
    """Eager steps against graph replays on ONE engine (Llama-3-8B width, 32
    layers, bf16, logprobs on), as compare_multi_step: `engine.model` is the
    model (graphs) or its eager twin (eager_twin: the same weights, cache
    and block managers), and ec.multi_step_decode 1 or 8, switched between
    runs. A run is 8 greedy requests of 64 prompt tokens and 65 output
    tokens, on the host's clock around a synchronise, with no profiler; the
    modes take turns in mirrored order, after one discarded run of each,
    ten runs of each in five rounds. Then one run of each mode under
    torch.profiler for the device's busy
    share (_profile; tables in OUT_DIR, profile_graphs_<mode>.txt)."""
    mc = LlamaModelConfig(num_layers=32, **LLAMA3_8B)
    ec = EngineConfig(model_path="", use_dummy=True, dtype="bfloat16",
                      preemption_mode="recompute", enable_logprobs=True,
                      multi_step_decode=PEND_S)
    engine = Engine(ec, mc, device=DEVICE)
    await engine.initialize(tokenizer_backend="inline")
    model = engine.model
    twin = eager_twin(model)
    loops = asyncio.create_task(engine.start_all_event_loops())
    modes = {"eager ms1": (twin, 1), "graphs ms1": (model, 1),
             "eager ms8": (twin, PEND_S), "graphs ms8": (model, PEND_S)}
    n_req, prompt, out_len = 8, 64, 65
    ms_a_token = {m: [] for m in modes}

    def reqs():
        return [RawRequest("", out_len, prompt_token_ids=[
            (3 * i + j) % 1000 + 1 for j in range(prompt)]) for i in range(n_req)]

    async def run(mode):
        engine.model, ec.multi_step_decode = modes[mode]
        steps0 = engine.stats.num_steps
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = await asyncio.gather(*[engine.add_request_and_wait(r) for r in reqs()])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steps = engine.stats.num_steps - steps0
        assert steps == (1 + 64 if modes[mode][1] == 1 else 1 + 8), (mode, steps)
        return 1e3 * wall / out_len, [toks for _, toks in outs]

    try:
        want = None
        for mode in modes:                                 # discarded runs
            _, toks = await run(mode)
            assert want is None or toks == want, f"{mode}: tokens differ"
            want = toks
        order = list(modes) + list(modes)[::-1]
        for r in range(rounds):
            for mode in order:
                ms, toks = await run(mode)
                assert toks == want, f"{mode}: tokens differ"
                ms_a_token[mode].append(ms)
            log(f"[compare graphs] round {r}: " + ", ".join(
                f"{m} {ms_a_token[m][-2]:.3f} {ms_a_token[m][-1]:.3f}"
                for m in modes) + " ms of wall a token of a request")
        for mode in modes:
            engine.model, ec.multi_step_decode = modes[mode]
            await _profile(engine, smi, "graphs_" + mode.replace(" ", "_"),
                           n_req, prompt, out_len)
        g = model.graphs
        log(f"[compare graphs] {len(g.table)} graphs, {g.capture_s:.2f} s "
            f"capturing, pool {g.pool_bytes / 1e6:.1f} MB reserved; profile "
            f"budget: eager scratch {model.profiled['scratch'] / 1e6:.1f} MB, "
            f"graph pool {model.profiled['graph_pool'] / 1e6:.1f} MB ({smi})")
    finally:
        engine.model = model
        loops.cancel()
        await asyncio.wait([loops])
    for m, v in ms_a_token.items():
        v = np.array(v)
        base = np.array(ms_a_token[m.replace("graphs", "eager")])
        q1, med, q3 = np.percentile(v, [25, 50, 75])
        log(f"[compare graphs] {m}: {len(v)} runs, wall a token median {med:.3f} "
            f"ms (quartiles {q1:.3f} to {q3:.3f}, min {v.min():.3f}, max "
            f"{v.max():.3f}), {n_req * 1e3 / med:.1f} tok/s; faster than the "
            f"eager run of the same turn in {int((v < base).sum())}/{len(v)} "
            f"({smi})")


async def compare_multi_step(smi: str, rounds: int = 4):
    """Single steps against windows of 8, fused and deferred, on ONE engine
    (Llama-3-8B width, 32 layers, bf16, logprobs on), so that the card, the
    process and the cache are the same: the scheduler reads
    multi_step_decode, and decode_multi_step SWIFTLLM_DEFER_KV, at every
    step, so a round switches them between runs. A run is 8 greedy requests
    of 64 prompt tokens and 65 output tokens (a prefill step, then 64 single
    decode steps or 8 windows), on the host's clock around a synchronise,
    with no profiler attached. The modes take turns in mirrored order
    (a b c c b a), after one discarded run of each."""
    mc = LlamaModelConfig(num_layers=32, **LLAMA3_8B)
    ec = EngineConfig(model_path="", use_dummy=True, dtype="bfloat16",
                      preemption_mode="recompute", enable_logprobs=True,
                      multi_step_decode=PEND_S)
    engine = Engine(ec, mc, device=DEVICE)
    await engine.initialize(tokenizer_backend="inline")
    loops = asyncio.create_task(engine.start_all_event_loops())
    modes = {"ms1": (1, "0"), "ms8": (PEND_S, "0"), "ms8defer": (PEND_S, "1")}
    n_req, prompt, out_len = 8, 64, 65
    ms_a_token = {m: [] for m in modes}

    async def run(mode):
        ec.multi_step_decode, os.environ["SWIFTLLM_DEFER_KV"] = modes[mode]
        reqs = [RawRequest("", out_len, prompt_token_ids=[
            (3 * i + j) % 1000 + 1 for j in range(prompt)]) for i in range(n_req)]
        steps0 = engine.stats.num_steps
        build.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = await asyncio.gather(*[engine.add_request_and_wait(r) for r in reqs])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steps = engine.stats.num_steps - steps0
        assert steps == (1 + 64 if mode == "ms1" else 1 + 8), (mode, steps)
        pend = build.launch_counts["paged_decode_attention_pend"]
        assert pend == (32 * 64 if mode == "ms8defer" else 0), (mode, pend)
        return 1e3 * wall / out_len, [toks for _, toks in outs]

    try:
        want = None
        for mode in modes:                                 # discarded runs
            _, toks = await run(mode)
            assert want is None or toks == want, f"{mode}: tokens differ"
            want = toks
        order = list(modes) + list(modes)[::-1]
        for r in range(rounds):
            for mode in order:
                ms, toks = await run(mode)
                assert toks == want, f"{mode}: tokens differ"
                ms_a_token[mode].append(ms)
            log(f"[compare] round {r}: " + ", ".join(
                f"{m} {ms_a_token[m][-2]:.3f} {ms_a_token[m][-1]:.3f}"
                for m in modes) + " ms of wall a token of a request")
    finally:
        os.environ.pop("SWIFTLLM_DEFER_KV", None)
        loops.cancel()
        await asyncio.wait([loops])
    base = np.array(ms_a_token["ms1"])
    for m, v in ms_a_token.items():
        v = np.array(v)
        q1, med, q3 = np.percentile(v, [25, 50, 75])
        log(f"[compare] {m}: {len(v)} runs, wall a token median {med:.3f} ms "
            f"(quartiles {q1:.3f} to {q3:.3f}, min {v.min():.3f}, max "
            f"{v.max():.3f}), {n_req * 1e3 / med:.1f} tok/s; faster than the "
            f"ms1 run of the same turn in {int((v < base).sum())}/{len(v)} "
            f"({smi})")


# ---------------------------------------------------------------------------
# Phase 6: tensor and data parallelism over torch.distributed. Ranks are
# processes of this script (--rank-phase), started with the torchrun
# environment, all on cuda:0: NCCL refuses two ranks on one device, so the
# step's collectives run over gloo, which takes CUDA tensors for all_reduce
# and broadcast (the only collectives the port's step uses).
# ---------------------------------------------------------------------------

DIST_BACKEND = "gloo"
TP_STEP_VARIANTS = {"bf16": {}, "fp8": dict(kv_quant="fp8", block_size=32),
                    "int4": dict(quant="int4"), "int8": dict(quant="int8")}
TP_HISTORIES = [40 + 97 * i for i in range(8)]     # the decode rows' keys
TP_FED = [(1009 * i + 17) % 120000 + 1 for i in range(8)]
# [tp2 step]'s checks. The tp = 1 kernels against their plain versions
# within TP_STEP_LIMIT: CLEAR_MARGIN, the absolute bound of the step phases
# above (they measure about 0.1 at these widths and weights; INT8's kernel
# rounds where quant.proj does); with INT4 weights twice that, as the plain
# INT4 projection (quant.proj) rounds each half-product to bf16 where the
# kernel rounds once (phase_step measures 0.14-0.34 for it, 0.08 for the
# kernel alone). The tp = 2 step rounds to
# bf16 where tp = 1 does not (each all-reduce adds one rounding of the
# residual stream a layer, and the shards' products are other GEMM shapes),
# as the kernels do against their plain versions: each rank's kernels
# against its plain versions, and the gathered logits against tp = 1's,
# within TP_LOGIT_FACTOR times the tp = 1 kernels' difference in the same
# run (or one bf16 ulp of the largest logit, if more). Greedy tokens agree
# on every row whose top-2 margin is clear of twice the difference.
TP_STEP_LIMIT = {"bf16": CLEAR_MARGIN, "fp8": CLEAR_MARGIN,
                 "int4": 2 * CLEAR_MARGIN, "int8": CLEAR_MARGIN}
TP_LOGIT_FACTOR = 3.0
# The tp/dp engines' depth: 8B widths at half its 32 layers, since each
# layer costs two gloo all-reduces staged through the host (3.3 ms each at
# tp = 2) and the run's time limit is shared with every phase.
SERVE_TP_LAYERS = 16
SERVE_TP_PAGES = 380                 # SWAP_PAGES' bf16 pool: 4 of the 8 fit
SERVE_TP_OUT = 32                    # the 4 admitted outgrow 380 pages
SERVE_DP_PAGES = 1024


def _rank_env(world: int, rank: int, port: int) -> dict:
    """The environment torchrun gives a rank (OMP_NUM_THREADS=1 included)."""
    return dict(os.environ, WORLD_SIZE=str(world), RANK=str(rank),
                LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                PYTHONPATH=str(Path(__file__).resolve().parent))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(phase: str, world: int, args: dict, timeout: float) -> list:
    """Run RANK_PHASES[phase](**args) in `world` processes of this script
    joined over gloo; each rank's result (JSON) in rank order. A rank that
    fails, or a group still running after `timeout` seconds (then killed),
    fails the run. Each rank's output: chiprun_out/rank_<phase>_<r>.log."""
    port = _free_port()
    procs = []
    for r in range(world):
        out = open(OUT_DIR / f"rank_{phase}_{r}.log", "w", encoding="utf-8")
        procs.append((subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--rank-phase",
             phase, json.dumps(args)], stdout=out, stderr=subprocess.STDOUT,
            env=_rank_env(world, r, port)), out))
    t_end = time.perf_counter() + timeout
    try:
        for p, _ in procs:
            p.wait(timeout=max(1.0, t_end - time.perf_counter()))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"{phase}: ranks still running after {timeout} s "
                             "(killed)") from None
    finally:
        for p, out in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            out.close()
    codes = [p.returncode for p, _ in procs]
    assert codes == [0] * world, (
        f"{phase}: rank exit codes {codes}; see chiprun_out/rank_{phase}_*.log")
    return [json.loads((OUT_DIR / f"rank_{phase}_{r}.json").read_text())
            for r in range(world)]


def tp_step(variant: str, out_path: str, fault: bool = False,
            chunk: int | None = None) -> dict:
    """[tp2 step] on this process's ranks (tp = the world size; 1 in the
    parent): 8B width, 4 layers, seeded_weights (std 0.02). A prefill step writes
    8 histories of 40 to 719 tokens; then one mixed step (the 8 decode rows
    and a fresh chunk: `chunk` tokens, by default 512, and with INT4 or INT8
    weights 128, a bucket of 256 tokens, which the weight kernels' narrow
    configuration takes; a chunk of 300 makes a 512-token bucket, their wide
    configuration) with the kernels, and the same step again from the same
    cache with their plain versions.
    Every rank runs every step (the primary's batch reaches the followers
    through the control channel). The kernels' logits go to out_path;
    returns the kernels-against-plain difference, whether greedy tokens
    agree on its clear-margin rows, and this rank's launches. With `fault`
    the kernel run's decode attention skips its last KV head (its queries'
    output zero): a planted fault that the checks must reject."""
    from swiftllm_tpu_torch.parallel import distributed
    tp = distributed.world_size()
    mc = LlamaModelConfig(num_layers=4, **LLAMA3_8B)
    kw = TP_STEP_VARIANTS[variant]
    ec = EngineConfig(model_path="", use_dummy=True, dtype="bfloat16",
                      preemption_mode="recompute", num_hbm_blocks=512,
                      max_blocks_per_seq=128, max_batch_size=16,
                      max_tokens_in_batch=4096, tp_size=tp, **kw)
    m = LlamaModel(ec, mc, device=DEVICE)
    m.params = seeded_weights(mc, ec.quant, seed=4321, mesh=m.mesh)
    m.init_kvcache_and_swap()
    chunk = chunk or (512 if ec.quant == "none" else 128)
    reqs = []
    for i, n in enumerate(TP_HISTORIES + [chunk]):
        r = Request(RawRequest("", 4))
        r.set_prompt_token_ids([(31 * i + 7 * j) % 120000 + 1 for j in range(n)])
        r.seq_id = i
        reqs.append(r)
    m.forward([ScheduledSeq(r, r.prompt_len) for r in reqs[:8]])
    # The decode rows are fed TP_FED, the same at any tp: the prefill step's
    # greedy samples may flip on a near tie between tp = 1 and tp = 2 (the
    # all-reduces round differently), and would then feed the two runs
    # different tokens.
    m.token_feedback[:8] = torch.tensor(TP_FED, dtype=torch.int32, device=DEVICE)
    for t, r in zip(TP_FED, reqs[:8]):
        r.output_token_ids.append(t)
        r.num_cached_tokens = r.prompt_len
    cache0, fb0 = m.kv_cache.clone(), m.token_feedback.clone()
    seen = []
    real = m.execute_packed

    def spy(flat, key, *a):
        seen.append((flat, key))
        return real(flat, key, *a)
    m.execute_packed = spy
    torch.cuda.synchronize()
    build.reset_launch_counts()
    decode = pa.paged_decode_attention
    if fault:
        def skip_last_kv_head(q, *a, n_kv, **kw):
            out = decode(q, *a, n_kv=n_kv, **kw)
            out[:, -(q.shape[1] // n_kv):] = 0
            return out
        pa.paged_decode_attention = skip_last_kv_head
    try:
        _, rows, lg = m.forward([ScheduledSeq(r, 1) for r in reqs[:8]]
                                + [ScheduledSeq(reqs[8], chunk)],
                                return_logits=True)
    finally:
        pa.paged_decode_attention = decode
    torch.cuda.synchronize()
    launches = dict(build.launch_counts)
    flat, key = seen[-1]
    m.kv_cache.copy_(cache0)
    m.token_feedback.copy_(fb0)
    m.engine_config.use_pallas = False
    _, plain = real(flat, key, True)
    live = [i for i, r in enumerate(rows) if r is not None]
    a = torch.from_numpy(lg[live])
    b = plain.float().cpu()[live]
    assert torch.isfinite(a).all() and torch.isfinite(b).all()
    diff = (a - b).abs().max().item()
    torch.save(a, out_path)
    gloo_ms = {}
    if tp > 1 and variant == "bf16" and not fault:
        # What one all-reduce of a decode step's and of a 2,048-token
        # step's activations costs over this backend (host clock around
        # 20 calls, the card synchronised before and after).
        for rows in (8, 2048):
            x = torch.ones(rows, mc.hidden_size, dtype=torch.bfloat16,
                           device=DEVICE)
            distributed.all_reduce_tp(x, m.mesh)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                distributed.all_reduce_tp(x, m.mesh)
            torch.cuda.synchronize()
            gloo_ms[rows] = 1e3 * (time.perf_counter() - t0) / 20
    return dict(diff=diff, greedy=greedy_agrees(a, b, diff), launches=launches,
                tokens=key.tokens, gloo_ms=gloo_ms,
                rows=len(live), n_q=mc.num_q_heads // tp,
                n_kv=m.num_kv_eff // tp, lanes=m.kv_cache.shape[2],
                std=b.std().item())


# [tp2 step]'s cases: (variant, chunk). The quantized variants also with a
# 300-token chunk, so that the shards run the weight kernels' wide
# configuration in a whole step.
TP_STEP_CASES = [(v, None) for v in TP_STEP_VARIANTS] + [("int8", 300), ("int4", 300)]


def tp_step_kernels(variant: str) -> tuple:
    if variant == "fp8":
        return FP8_PATH_KERNELS
    extra = {"int4": ("int4_matmul",), "int8": ("int8_matmul",)}
    return PATH_KERNELS + extra.get(variant, ())


def greedy_agrees(a, b, diff) -> bool:
    """Greedy tokens of logits `a` and `b` agree on every row whose top-2
    margin in `b` exceeds twice `diff`."""
    top2 = b.topk(2, dim=-1).values
    checked = (top2[:, 0] - top2[:, 1]) > 2 * diff
    return bool((a.argmax(-1) == b.argmax(-1))[checked].all())


def tp_step_checks(variant: str, one: dict, ranks: list, a, b) -> dict:
    """[tp2 step]'s checks of a tp = 1 run `one` (logits `b`) and its tp = 2
    ranks (gathered logits `a`): each check's name -> (passed, measured,
    bound)."""
    ulp = 2.0 ** (math.floor(math.log2(b.abs().max().item())) - 7)
    bound = TP_LOGIT_FACTOR * max(one["diff"], ulp)
    diff = (a - b).abs().max().item()
    limit = TP_STEP_LIMIT[variant]
    checks = {"tp=1 kernels against plain": (
        one["diff"] <= limit and one["greedy"], one["diff"], limit)}
    for r, res in enumerate(ranks):
        checks[f"rank {r} kernels against plain"] = (
            res["diff"] <= bound and res["greedy"], res["diff"], bound)
    checks["gathered tp=2 against tp=1"] = (
        diff <= bound and greedy_agrees(a, b, diff), diff, bound)
    return checks


def phase_tp_step(smi: str, tmp: Path):
    """[tp2 step]: each case of TP_STEP_CASES at tp = 1 here, then at tp = 2
    in two ranks (one process each, over gloo); every kernel of the step
    launched on every rank (the quantized variants' weight kernel 7L + 1
    times, and their 300-token chunks in a bucket of more than 256 tokens,
    which the wide configuration takes), and tp_step_checks: the tp = 1 kernels against their plain
    versions, each rank's at the shard's widths (16 q and 4 kv heads), and
    the gathered tp = 2 logits against tp = 1's. Then the bf16 step again
    with a planted fault (tp_step's `fault`) at tp = 1 and in both ranks:
    every check must reject it."""
    for variant, chunk in TP_STEP_CASES:
        t0 = time.perf_counter()
        name = variant + (f"_{chunk}" if chunk else "")
        one = tp_step(variant, str(tmp / f"tp1_{name}.pt"), chunk=chunk)
        gc.collect()
        torch.cuda.empty_cache()
        ranks = spawn_ranks("tp_step", 2, dict(variant=variant, chunk=chunk, out_path=str(
            tmp / f"tp2_{name}.pt")), timeout=240)
        for r, res in enumerate(ranks):
            for k in tp_step_kernels(variant):
                assert res["launches"][k] > 0, (variant, r, k, res["launches"])
        weights = {"int4": "int4_matmul", "int8": "int8_matmul"}.get(variant)
        if weights:
            # Every projection of the 4 layers and the head through the
            # format's kernel on every rank, in either configuration.
            for r, res in enumerate([one] + ranks):
                assert res["launches"][weights] == 7 * 4 + 1, (name, r, res["launches"])
        if chunk:
            assert one["tokens"] > im.WIDE_ABOVE, (name, one["tokens"])
        b = torch.load(tmp / f"tp1_{name}.pt")
        checks = tp_step_checks(variant, one, ranks,
                                torch.load(tmp / f"tp2_{name}.pt"), b)
        log(f"[tp2 step] {name}, backend {DIST_BACKEND}, 8B width, 4 layers, "
            f"{one['rows']} rows ({one['tokens']} tokens): per rank "
            f"{ranks[0]['n_q']} q / {ranks[0]['n_kv']} kv heads, {ranks[0]['lanes']} "
            f"cache lanes (logit std {one['std']:.4g}); max |logit diff| against "
            f"bound: {', '.join(f'{k} {v[1]:.4g} <= {v[2]:.4g}' for k, v in checks.items())}; "
            f"greedy tokens agree on every clear-margin row; rank launches "
            f"{[{k: r['launches'][k] for k in tp_step_kernels(variant)} for r in ranks]} "
            f"in {time.perf_counter() - t0:.1f} s")
        assert all(v[0] for v in checks.values()), (variant, checks)
        if ranks[0]["gloo_ms"]:
            log(f"[tp2 step] one {DIST_BACKEND} all_reduce of bf16 [rows, 4096] "
                f"on cuda:0 between the two ranks, ms a call (20 calls): "
                f"{ranks[0]['gloo_ms']} ({smi})")
        if variant == "bf16":
            good = one
    bad = tp_step("bf16", str(tmp / "tp1_fault.pt"), fault=True)
    gc.collect()
    torch.cuda.empty_cache()
    bad_ranks = spawn_ranks("tp_step", 2, dict(
        variant="bf16", out_path=str(tmp / "tp2_fault.pt"), fault=True),
        timeout=240)
    b = torch.load(tmp / "tp1_bf16.pt")
    checks = tp_step_checks("bf16", good, bad_ranks,
                            torch.load(tmp / "tp2_fault.pt"), b)
    checks["tp=1 kernels against plain"] = tp_step_checks("bf16", bad, [], b, b)[
        "tp=1 kernels against plain"]
    log(f"[tp2 step] planted fault (the decode kernel's last KV head skipped), "
        f"bf16: {', '.join(f'{k} {v[1]:.4g} against {v[2]:.4g}' for k, v in checks.items())}"
        f"; every check rejects it")
    assert not any(v[0] for v in checks.values()), checks


def serve_prompts(mc) -> list:
    top = min(128000, mc.vocab_size - 1)
    return [[(13 * i + 5 * j) % top + 1 for j in range(SWAP_PROMPT)]
            for i in range(8)]


async def _serve_timed(engine, prompts, out_len) -> dict:
    """Serve `prompts` at once: tokens, wall, TTFT and decode rate."""
    async def one(p):
        t_sub, stamps, toks = time.perf_counter(), [], []
        async for so in engine.add_request_and_stream(
                RawRequest("", out_len, prompt_token_ids=p)):
            stamps.append(time.perf_counter())
            toks.append(so.token_id)
        return t_sub, stamps, toks
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = await asyncio.gather(*[one(p) for p in prompts])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ttft = sorted(st[0] - t for t, st, _ in res)
    first = max(st[0] for _, st, _ in res)
    last = max(st[-1] for _, st, _ in res)
    n_after = sum(1 for _, st, _ in res for x in st if x > first)
    return dict(tokens=[toks for _, _, toks in res], wall=wall,
                ttft_p50=ttft[len(ttft) // 2], ttft_max=ttft[-1],
                decode_tok_s=n_after / (last - first) if last > first else 0.0)


async def _profile_collectives(engine, smi: str, name: str) -> dict:
    """_profile's decode-heavy run on rank 0 of a tp/dp engine, with the
    host time blocked in the step's all-reduces (every collective of the
    step is one), in the control channel's broadcasts, and in the model's
    dispatches (forward_async, which holds both) summed beside it."""
    dist = torch.distributed
    spent = {"all_reduce": [0.0, 0], "broadcast": [0.0, 0],
             "dispatch": [0.0, 0]}
    model = engine.model
    real = {"all_reduce": dist.all_reduce, "broadcast": dist.broadcast,
            "dispatch": model.forward_async}

    def timed(kind):
        def call(*a, **kw):
            t = time.perf_counter()
            out = real[kind](*a, **kw)
            spent[kind][0] += time.perf_counter() - t
            spent[kind][1] += 1
            return out
        return call
    dist.all_reduce, dist.broadcast = timed("all_reduce"), timed("broadcast")
    model.forward_async = timed("dispatch")
    t0 = time.perf_counter()
    try:
        busy_ms, steps = await _profile(engine, smi, name)
    finally:
        dist.all_reduce, dist.broadcast = real["all_reduce"], real["broadcast"]
        model.forward_async = real["dispatch"]
    return dict(wall_s=time.perf_counter() - t0, busy_ms=busy_ms, steps=steps,
                spent=spent)


def serve_rank(ec_kw: dict, seed: int, smi: str, profile: str = "") -> dict:
    """One rank of [serve tp2] / [serve dp2 tp2]: rank 0 runs the Engine on
    the 8 prompts (then, with `profile`, _profile_collectives under that
    name), the others follow. Returns this rank's launches, peak memory and
    the ops it replayed (followers), or the served tokens, times and
    profile (rank 0)."""
    from swiftllm_tpu_torch.parallel import distributed
    mc = LlamaModelConfig(num_layers=SERVE_TP_LAYERS, **LLAMA3_8B)
    ec = EngineConfig(model_path="", use_dummy=True, **ec_kw)
    if not distributed.is_primary():
        m = LlamaModel(ec, mc, device=DEVICE)
        with loading(seed, std=0.002, successor=True):
            m.load_weights()
        m.init_kvcache_and_swap()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops = []
        real = distributed.exchange_op

        def logged(*a, **kw):
            out = real(*a, **kw)
            ops.append(out[0])
            return out
        distributed.exchange_op = logged
        build.reset_launch_counts()
        distributed.follower_loop(m)
        torch.cuda.synchronize()
        return dict(launches=dict(build.launch_counts), ops=ops,
                    peak=torch.cuda.max_memory_allocated(), resident=resident,
                    cpu_free=m.cpu_block_mgr.num_free_blocks)

    async def body():
        engine = Engine(ec, mc, device=DEVICE)
        with loading(seed, std=0.002, successor=True):
            await engine.initialize(tokenizer_backend="inline")
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loops = asyncio.create_task(engine.start_all_event_loops())
        build.reset_launch_counts()
        out = await _serve_timed(engine, serve_prompts(mc), SERVE_TP_OUT)
        launches = dict(build.launch_counts)
        m = engine.model
        for mgr in m.hbm_block_mgrs:
            await _pages_back(mgr, m.num_hbm_blocks)
        prof = (await _profile_collectives(engine, smi, profile)
                if profile else None)
        loops.cancel()
        await asyncio.wait([loops])
        engine.stop_followers()
        return dict(out, launches=launches, stats=engine.stats.snapshot(),
                    profile=prof,
                    groups=[g.num_free_blocks for g in m.hbm_block_mgrs],
                    pages=m.num_hbm_blocks,
                    cpu_free=m.cpu_block_mgr.num_free_blocks,
                    peak=torch.cuda.max_memory_allocated(), resident=resident)
    return asyncio.run(body())


RANK_PHASES = {"tp_step": tp_step, "serve": serve_rank}


def rank_main(phase: str, args: dict) -> int:
    """A rank of a phase-6 run: join the group, run the phase, write the
    result where spawn_ranks reads it."""
    from swiftllm_tpu_torch.parallel import distributed
    distributed.initialize(DIST_BACKEND)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = int(os.environ["RANK"])
    print(f"rank {rank} of {os.environ['WORLD_SIZE']}: backend {DIST_BACKEND}, "
          f"device {DEVICE}", flush=True)
    result = RANK_PHASES[phase](**args)
    (OUT_DIR / f"rank_{phase}_{rank}.json").write_text(json.dumps(result))
    distributed.shutdown()
    return 0


async def serve_tp1_reference(ec_kw: dict, seed: int) -> dict:
    """The tp = 1 engine on the same successor weights and prompts."""
    mc = LlamaModelConfig(num_layers=SERVE_TP_LAYERS, **LLAMA3_8B)
    engine, loops, _ = await _engine(
        EngineConfig(model_path="", use_dummy=True, **ec_kw), mc, seed)
    out = await _serve_timed(engine, serve_prompts(mc), SERVE_TP_OUT)
    out["stats"] = engine.stats.snapshot()
    await _release(engine, loops)
    del engine, loops
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_serve_parallel(smi: str) -> None:
    """[serve tp2] and [serve dp2 tp2]: full-width engines (8B widths,
    SERVE_TP_LAYERS layers)
    on successor weights (seeded_weights), 8 prompts of 1,500 tokens and 32 output
    tokens each. tp = 2 at the default EngineConfig (swap preemption, 2,048
    host pages) on a pool of 380 pages, which holds four of the eight: the
    follower must replay swap-outs and swap-ins. dp = 2 x tp = 2 on four
    ranks, 1,024 pages a group: requests on both groups. Tokens equal the
    tp = 1 engine's on the same weights and the successor chain; every rank
    launches every attention kernel (and the swapping ranks the page
    mover)."""
    from swiftllm_tpu_torch.parallel.distributed import (OP_STEP, OP_STOP,
                                                         OP_SWAP_IN,
                                                         OP_SWAP_OUT)
    mc = LlamaModelConfig(num_layers=SERVE_TP_LAYERS, **LLAMA3_8B)
    seed = 93
    cases = [("serve tp2", 2, dict(tp_size=2, num_hbm_blocks=SERVE_TP_PAGES)),
             ("serve dp2 tp2", 4, dict(dp_size=2, tp_size=2,
                                      num_hbm_blocks=SERVE_DP_PAGES))]
    profile_of = {"serve tp2": "tp2"}
    t0 = time.perf_counter()
    want = asyncio.run(serve_tp1_reference(dict(num_hbm_blocks=SERVE_TP_PAGES),
                                           seed))
    for p, toks in zip(serve_prompts(mc), want["tokens"]):
        chain = [successor(p[-1])]
        while len(chain) < SERVE_TP_OUT:
            chain.append(successor(chain[-1]))
        assert toks == chain, "the tp=1 engine left the successor chain"
    log(f"[serve tp1] reference: 8B, {SERVE_TP_LAYERS} layers, 8 x {SWAP_PROMPT} prompt tokens, "
        f"{SERVE_TP_OUT} out, {SERVE_TP_PAGES} pages: wall {want['wall']:.3f} s, "
        f"TTFT p50 {1e3 * want['ttft_p50']:.1f} ms, decode "
        f"{want['decode_tok_s']:.1f} tok/s, {want['stats']['num_preemptions']} "
        f"preemptions, in {time.perf_counter() - t0:.1f} s ({smi})")
    for name, world, kw in cases:
        t0 = time.perf_counter()
        primary, *followers = spawn_ranks(
            "serve", world, dict(ec_kw=kw, seed=seed, smi=smi,
                                 profile=profile_of.get(name, "")), timeout=420)
        assert primary["tokens"] == want["tokens"], f"{name}: tokens differ from tp=1"
        for r, res in enumerate([primary] + followers):
            for k in PATH_KERNELS:
                assert res["launches"][k] > 0, (name, r, k, res["launches"])
        assert primary["groups"] == [primary["pages"]] * kw.get("dp_size", 1)
        ops = followers[0]["ops"]
        if name == "serve tp2":
            assert primary["stats"]["num_preemptions"] >= 1, primary["stats"]
            # (one op may move several requests: the counts need not match;
            # every rank's host pool full again shows they were replayed)
            n_out, n_in = ops.count(OP_SWAP_OUT), ops.count(OP_SWAP_IN)
            assert n_out >= 1 and n_in >= 1, ops
            for r, res in enumerate([primary] + followers):
                assert res["launches"]["swap_pages"] > 0, (r, res["launches"])
                assert res["cpu_free"] == 2048, (r, res["cpu_free"])
            swaps = (f"; the follower replayed {n_out} swap-out and {n_in} "
                     "swap-in ops")
        else:
            swaps = ""
        assert ops[-1] == OP_STOP
        assert ops.count(OP_STEP) == primary["stats"]["num_steps"], ops
        log(f"[{name}] backend {DIST_BACKEND}, {world} ranks on one card, 8B, "
            f"{SERVE_TP_LAYERS} layers, {kw}: tokens equal tp=1's; wall {primary['wall']:.3f} s, "
            f"TTFT p50 {1e3 * primary['ttft_p50']:.1f} ms, max "
            f"{1e3 * primary['ttft_max']:.1f} ms, decode "
            f"{primary['decode_tok_s']:.1f} tok/s, "
            f"{primary['stats']['num_steps']} steps, "
            f"{primary['stats']['num_preemptions']} preemptions{swaps}; per rank "
            f"resident after load "
            f"{[round(r['resident'] / 1e9, 2) for r in [primary] + followers]} GB, "
            f"peak while serving "
            f"{[round(r['peak'] / 1e9, 2) for r in [primary] + followers]} GB; "
            f"launches rank 0 {primary['launches']}; in "
            f"{time.perf_counter() - t0:.1f} s ({smi})")
        prof = primary["profile"]
        if prof:
            # (the profiled run's own line, [profile tp2], is rank 0's)
            held = "; ".join(
                f"{k} {t:.3f} s in {n} calls ({1e3 * t / max(n, 1):.3f} ms each)"
                for k, (t, n) in prof["spent"].items())
            log(f"[{name}] rank 0 under the profiler (8 requests, 64-token "
                f"prompts, 24 tokens each, {prof['steps']} steps, wall "
                f"{prof['wall_s']:.3f} s, device busy {prof['busy_ms']:.1f} "
                f"ms): the host held in {held} ({smi})")


def http_tp2(smi: str, tmp: Path):
    """[http tp2]: the api_server command line at tp = 2, two ranks started
    with the torchrun environment, both on cuda:0 (--device), gloo
    (--dist-backend), 512 pages each (--num-hbm-blocks: two ranks share the
    card), Llama-3-8B's config.json with dummy weights. One /generate is
    answered; then SIGTERM to rank 0: it stops the follower (OP_STOP) and
    both exit 0 within 90 s. Output: chiprun_out/api_server_tp2_<r>.log."""
    import signal
    import urllib.request
    model_dir = tmp / "llama3-8b-tp2"
    model_dir.mkdir(parents=True, exist_ok=True)
    (model_dir / "config.json").write_text(json.dumps(LLAMA3_8B_CONFIG))
    http_port, port = _free_port(), _free_port()
    procs = []
    t0 = time.perf_counter()
    for r in range(2):
        out = open(OUT_DIR / f"api_server_tp2_{r}.log", "w", encoding="utf-8")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "swiftllm_tpu_torch.server.api_server",
             "--model-path", str(model_dir), "--use-dummy", "true",
             "--port", str(http_port), "--host", "127.0.0.1",
             "--tp-size", "2", "--dist-backend", DIST_BACKEND,
             "--device", DEVICE + ":0", "--num-hbm-blocks", "512"],
            stdout=out, stderr=subprocess.STDOUT,
            env=_rank_env(2, r, port)), out))
    url = f"http://127.0.0.1:{http_port}"
    try:
        while True:
            for p, _ in procs:
                assert p.poll() is None, f"a rank exited with {p.returncode}"
            assert time.perf_counter() - t0 < 400, "the server did not come up"
            try:
                if urllib.request.urlopen(url + "/health", timeout=2).status == 200:
                    break
            except OSError:
                time.sleep(1)
        up = time.perf_counter() - t0
        req = urllib.request.Request(
            url + "/generate", data=json.dumps(
                {"prompt_token_ids": list(range(1, 41)), "output_len": 8}).encode(),
            headers={"Content-Type": "application/json"})
        t1 = time.perf_counter()
        gen = json.load(urllib.request.urlopen(req, timeout=120))
        took = time.perf_counter() - t1
        assert len(gen["output_token_ids"]) == 8, gen
        t2 = time.perf_counter()
        procs[0][0].send_signal(signal.SIGTERM)
        codes = [p.wait(timeout=90) for p, _ in procs]
        down = time.perf_counter() - t2
        assert codes == [0, 0], f"exit codes after SIGTERM: {codes}"
    finally:
        for p, out in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            out.close()
    follower = (OUT_DIR / "api_server_tp2_1.log").read_text()
    assert "follower rank 1 ready" in follower, follower[-2000:]
    log(f"[http tp2] api_server --tp-size 2 --dist-backend {DIST_BACKEND}, two "
        f"ranks on one card: up in {up:.1f} s, /generate answered 8 tokens "
        f"{gen['output_token_ids']} in {took:.3f} s; SIGTERM to rank 0: both "
        f"ranks exited 0 in {down:.1f} s ({smi})")


def ptxas_instances(reports: dict, checked: tuple,
                    quiet: bool = False) -> tuple[dict, list]:
    """From the kernels' ptxas reports: each instance of the kernels named in
    `checked` as (report, mangled name) -> [spill store bytes, spill load
    bytes, registers], and every line that says wgmmas were serialised in
    one of them (named in the line, or the entry function being compiled
    when ptxas said it). Every serialisation line is logged, unless
    `quiet`."""
    serial, found = [], {}
    for k, v in reports.items():
        fn = ""
        for line in v.splitlines():
            m = re.search(r"(?:Compiling entry function '|Function properties for )([^' ]+)", line)
            if m:
                fn = m.group(1)
            if "serializ" in line.lower():
                if not quiet:
                    log(f"[ptxas] {k}: {line.strip()} (compiling {fn})")
                if any(c in (line if "function '" in line else fn) for c in checked):
                    serial.append(line.strip())
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and any(c in fn for c in checked):
                found[(k, fn)] = [int(m.group(1)), int(m.group(2))]
            m = re.search(r"Used (\d+) registers", line)
            if m and (k, fn) in found and len(found[(k, fn)]) == 2:
                found[(k, fn)].append(int(m.group(1)))
    return found, serial


def check_ptxas(reports: dict) -> None:
    """Logs every line of the kernels' ptxas reports that says wgmmas were
    serialised, and each instance of the wide configuration's kernel
    (csrc/wide_matmul.cuh) and of the narrow INT8 kernel
    (int8_matmul_kernel) with its registers and spills. Fails unless both
    weight kernels' reports are there, each with the wide kernel and INT8's
    with its narrow one, and no instance of either had its wgmmas
    serialised (named in the line, or the entry function being compiled
    when ptxas said it) or spilled a register."""
    wide, bad = ptxas_instances(reports, ("wide_matmul_kernel", "int8_matmul_kernel"))
    for (k, fn), r in wide.items():
        what = ("int8_matmul_kernel<" + re.search(r"Li(\d+)E", fn).group(1) + ">"
                if "int8_matmul_kernel" in fn else
                f"{'INT4' if 'ILb1E' in fn else 'INT8'} wide_matmul_kernel")
        log(f"[ptxas] {k}: {what}: {r[2:] and r[2]} registers, {r[0]} bytes spill "
            f"stores, {r[1]} bytes spill loads")
        if r[0] or r[1]:
            bad.append(f"{k}: {what} spills ({r[0]} / {r[1]} bytes)")
    for k in ("int4_matmul", "int8_matmul"):
        if not any(kk == k and "wide_matmul_kernel" in fn for kk, fn in wide):
            bad.append(f"no ptxas report of {k}'s wide kernel")
    if sum(kk == "int8_matmul" and "int8_matmul_kernel" in fn for kk, fn in wide) != 4:
        bad.append("no ptxas report of each narrow INT8 kernel (NT = 16, 32, 64, 128)")
    assert not bad, f"ptxas report of the weight kernels: {bad}"


def check_rope_ptxas(reports: dict) -> None:
    """Each instance of the rope kernel (rope_qkv and rope_qkv_fp8 at one,
    two and four units a thread, with slots and without) with its registers
    and spills, logged; fails unless all twelve are in the report and none
    spills (the one-unit builds are capped at 40 registers for three blocks
    an SM)."""
    found, _ = ptxas_instances(reports, ("rope_qkv_kernel",), quiet=True)
    for (k, fn), r in sorted(found.items()):
        m = re.search(r"rope_qkv_kernelILb(\d)ELi(\d)ELb(\d)E", fn)
        log(f"[ptxas] {k}: rope_qkv_kernel<{'true' if m.group(1) == '1' else 'false'}, "
            f"{m.group(2)}, {'true' if m.group(3) == '1' else 'false'}>: "
            f"{r[2:] and r[2]} registers, {r[0]} bytes spill stores, {r[1]} bytes "
            "spill loads")
    assert len(found) == 12, f"ptxas report of the rope kernels: {sorted(found)}"
    assert not any(r[0] or r[1] for r in found.values()), \
        f"a rope kernel spills: {found}"


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--rank-phase"]:      # a rank of phase 6
        return rank_main(sys.argv[2], json.loads(sys.argv[3]))
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.log").write_text("")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[card] {smi}")
    log(f"[versions] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    if sys.argv[1:] == ["--sweep-swap"]:
        build.build_kernels(("swap_pages",))
        phase_swap_mover(smi)
        sweep_swap(smi)
        log(f"[total] {time.perf_counter() - t_start:.1f} s")
        return 0
    if sys.argv[1:] == ["--compare-swap-norm"]:
        t0 = time.perf_counter()
        build.build_kernels(("swap_pages", "add_rms_norm"))
        log(f"[build] swap_pages and add_rms_norm built in "
            f"{time.perf_counter() - t0:.1f} s ({Path.cwd()})")
        compare_swap_norm(smi)
        return 0
    if sys.argv[1:] == ["--compare-rope"]:
        # quantize_kv, store_kv: a checkout from before rope_qkv_fp8, or
        # from before the span write's fold, has that kernel.
        names = [n for n in ("rope_qkv", "rope_qkv_fp8", "quantize_kv", "store_kv")
                 if n in build.KERNELS]
        t0 = time.perf_counter()
        build.build_kernels(names)
        log(f"[build] {', '.join(names)} built in {time.perf_counter() - t0:.1f} s "
            f"({Path.cwd()})")
        compare_rope(smi)
        return 0
    if sys.argv[1:] == ["--layer-ops"]:
        check_rope_ptxas(build.build_kernels(lo.KERNELS))
        phase_layer_ops("cuda", smi)
        log(f"[total] {time.perf_counter() - t_start:.1f} s")
        return 0
    if sys.argv[1:] in (["--sweep-int4"], ["--sweep-int8"]):
        reports = build.build_kernels(("int4_matmul", "int8_matmul"))
        (OUT_DIR / "ptxas.txt").write_text("\n".join(
            f"== {k}\n{v}" for k, v in reports.items()))
        check_ptxas(reports)
        {"--sweep-int4": sweep_int4, "--sweep-int8": sweep_int8}[sys.argv[1]](smi)
        return 0
    if sys.argv[1:] == ["--compare-int8"]:
        # Every kernel, so that the log gives this checkout's build seconds
        # (none when an earlier run in it built them); then the weight kernels.
        t0 = time.perf_counter()
        build.build_kernels()
        log(f"[build] {len(build.KERNELS)} kernels built in "
            f"{time.perf_counter() - t0:.1f} s ({Path.cwd()})")
        compare_int8(smi)
        return 0
    t0 = time.perf_counter()
    reports = build.build_kernels()
    log(f"[build] {len(build.KERNELS)} kernels ({len(reports)} sources) built "
        f"in {time.perf_counter() - t0:.1f} s")
    (OUT_DIR / "ptxas.txt").write_text("\n".join(
        f"== {k}\n{v}" for k, v in reports.items()))
    check_ptxas(reports)
    check_rope_ptxas(reports)
    if sys.argv[1:] == ["--compare-multi-step"]:
        asyncio.run(compare_multi_step(smi))
        return 0
    if sys.argv[1:] == ["--compare-graphs"]:
        asyncio.run(compare_graphs(smi))
        log(f"[total] {time.perf_counter() - t_start:.1f} s")
        return 0
    if sys.argv[1:] == ["--graphs"]:
        asyncio.run(phase_graphs(smi))
        log(f"[total] {time.perf_counter() - t_start:.1f} s")
        return 0
    if sys.argv[1:] == ["--compare-splits"]:
        compare_splits(smi)
        return 0
    if sys.argv[1:] == ["--compare-prefill"]:
        compare_prefill(smi)
        return 0
    if sys.argv[1:] == ["--groups"]:
        phase_groups("cuda", smi)
        phase_qwen2_step()
        asyncio.run(serve_qwen2(smi))
        log(f"[total] {time.perf_counter() - t_start:.1f} s")
        return 0
    if sys.argv[1:] == ["--parallel"]:
        tmp = tempfile.TemporaryDirectory()
        phase_tp_step(smi, Path(tmp.name))
        phase_serve_parallel(smi)
        http_tp2(smi, Path(tmp.name))
        tmp.cleanup()
        log(f"[total] {time.perf_counter() - t_start:.1f} s")
        return 0
    if sys.argv[1:] == ["--quant"]:
        phase_int4("cuda", smi)
        phase_int8("cuda", smi)
        for fmt in ("int8", "int4"):
            phase_wide(fmt, "cuda", smi)
        phase_step("int8")
        phase_step("int4")
        phase_layer_ops("cuda", smi)
        phase_step(kv_quant="fp8")
        log(f"[total] {time.perf_counter() - t_start:.1f} s")
        return 0
    if sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}", file=sys.stderr)
        return 2
    for k, v in reports.items():
        for line in v.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[ptxas] {k}: {line.strip()}")

    t_mark = [time.perf_counter()]

    def mark(what):
        """Logs the seconds since the last mark: where a full run's time goes."""
        now = time.perf_counter()
        log(f"[phase] {what}: {now - t_mark[0]:.1f} s")
        t_mark[0] = now
    results = phase_kernels("cuda")
    mark("kernels")
    phase_groups("cuda", smi)
    mark("groups")
    results["paged_decode_attention_pend"] = phase_pend("cuda", smi)
    phase_verify("cuda", smi)
    results["paged_prefill_attention_bf16s"] = phase_bf16s("cuda", smi)
    results.update(phase_layer_ops("cuda", smi))
    time_sampler("cuda", smi)
    mark("pend, verify, bf16 scores, layer_ops, sampler")
    torch.cuda.empty_cache()
    results["int4_matmul"] = phase_int4("cuda", smi)
    results["int8_matmul"] = phase_int8("cuda", smi)
    for fmt in ("int8", "int4"):
        phase_wide(fmt, "cuda", smi)
    mark("int4, int8, wide")
    swap = phase_swap_mover(smi)
    phase_step()
    phase_step("int4")
    phase_step("int8")
    phase_step(kv_quant="fp8")
    phase_step("int4", kv_quant="fp8")
    phase_step(mistral=True)
    phase_qwen2_step()
    phase_multi_step()
    phase_verify_step()
    phase_prefix_step()
    tmp = tempfile.TemporaryDirectory()
    adapters = {}
    for name, seed in (("a", 101), ("b", 202)):
        adapters[name] = Path(tmp.name) / name
        write_peft_adapter(adapters[name], LLAMA3_8B, 32, seed)
    phase_lora_step(adapters)
    mark("swap mover, steps")
    launches = asyncio.run(phase_serve(smi, adapters))
    http_cli(smi, Path(tmp.name))
    phase_examples(smi)
    mark("engines, http, examples")
    gc.collect()
    torch.cuda.empty_cache()
    phase_tp_step(smi, Path(tmp.name))
    phase_serve_parallel(smi)
    http_tp2(smi, Path(tmp.name))
    mark("tp/dp")
    tmp.cleanup()
    # Launches: the decode kernel's and the layer kernels' on the
    # bf16 serving run (the path of the slices that brought them),
    # int4_matmul's and
    # int8_matmul's on the INT4 and INT8 runs, rope_qkv_fp8's on the fp8 KV
    # run, the `pend` variant's on the deferred multi-step run, the prefill
    # kernel's and its bf16-score variant's on the speculative-decoding
    # engine's waves, the page mover's on the bf16 swapping engine; the
    # other runs' counts are asserted and logged by their runs.
    run_of = {"int4_matmul": "int4", "int8_matmul": "int8",
              "rope_qkv_fp8": "fp8kv", "paged_decode_attention_pend": "ms8defer",
              "paged_prefill_attention": "spec",
              "paged_prefill_attention_bf16s": "spec", "swap_pages": "swap bf16"}
    # The programmatic launches' rows: their launches in the serving runs'
    # profiles (add_rms_norm's and rope_qkv's in bf16, rope_qkv_fp8's with
    # the fp8 cache), since back to back (phase_layer_ops) each overlaps the
    # one before.
    for n in ("add_rms_norm", "rope_qkv", "rope_qkv_fp8"):
        results[n]["ms"] = STEP_LAUNCH_MS[n]
    # The page mover's row: a 128-page round trip (two launches), byte-equal.
    results["swap_pages"] = dict(
        max_abs_err=0.0, bound_by="bytes",
        **{k: swap[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")})
    kernels = [dict(name=n, route="cuda", source=SOURCE_OF[n],
                    replaces=REPLACES[n],
                    launches=launches[run_of.get(n, "none")][n], **results[n])
               for n in REPLACES]
    assert {k["name"] for k in kernels} == set(build.KERNELS), kernels
    log(f"[swap] swap_pages: {json.dumps(dict(swap, launches={k: v['swap_pages'] for k, v in launches.items() if k.startswith('swap ')}))}")
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
