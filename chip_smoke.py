"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --compare-multi-step   # a measurement, not the smoke
    python3 chip_smoke.py --compare-splits       # a measurement, not the smoke
    python3 chip_smoke.py --compare-prefill      # a measurement, not the smoke
    python3 chip_smoke.py --compare-int4         # a measurement, not the smoke
    python3 chip_smoke.py --sweep-int4           # a measurement, not the smoke
    python3 chip_smoke.py --sweep-swap           # a measurement, not the smoke

Phases (any failure exits non-zero; nothing is caught and passed over):
  0. the card's name and power limit, torch and CUDA versions;
  1. build the hand-written kernels from swiftllm_tpu_torch/ops/csrc;
  2. each kernel against its plain PyTorch version at Llama-3-8B width
     (and two cases at Llama-3.2-1B width, one of them at q bucket 4096 in
     a bucket of 128 rows), with times and bounds, and one
     planted fault (a decode row short of one page) that must fail; the
     attention kernels' variants on the same cases (an fp8 cache, a sliding
     window of 4096 and of 50, and both), each with its times and bounds,
     with two more planted faults (the V scale left out, the window off by
     one); the INT4 dequant-matmul at the four 8B projection shapes and
     T = 1, 16, 128 and 256 and at ragged ones, against its plain version
     and its plan's split-then-merge, two launches bit-identical, timed at
     every shape and T, with two planted faults (the nibbles unpacked
     interleaved, a split left out of the merge) that must fail; the
     decode kernel's deferred-commit (`pend`) variant on 16 rows (3 of
     them pad rows) with histories of 1 to 2,048 keys, for npend 1, 2, 4
     and 8 of a window of 8, with a sliding
     window and on the long rows, the cache byte-identical afterwards, with
     two planted faults (a history one key too long, the pending slots
     shifted by one) that must fail; the verify spans of speculative
     decoding (store_kv, then the prefill kernel at q bucket 8 over 12 spans
     of 2 to 5 tokens that start mid-page, beside 4 decode-kind rows) in
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
     (measured), the plain version and cudaMemcpy2DAsync per run;
  3. one whole mixed step, kernels against plain versions, 4 layers: at 8B
     width in bf16, with INT4 weights in a bucket of 256 tokens, with an fp8
     KV cache, and with both; at Mistral-7B width with its window of 4096
     and rows whose histories exceed it; then 8 decode steps of 8 rows at
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
  4. the serving path: the port's Engine at full width (32 layers, dummy
     weights), 8 concurrent requests, launch counts of every kernel: 8B in
     bf16, with INT4 and with INT8 weights, 8B with an fp8 KV cache (which
     also serves one prompt of 16,500 tokens), and Mistral-7B-v0.1 width
     with its sliding window (prompts of 5,000 and 8,192 tokens among the
     8); then the bf16 8B engine three times more with logprobs on and
     three of the 8 requests sampled (temperature 0.8, top-k 20, seeded):
     multi_step_decode 1, 8 and 8 with SWIFTLLM_DEFER_KV=1, whose tokens
     must be equal; each engine released before the next one sizes its
     cache; last, an 8B engine with spec decode (spec_k 4) and prefix
     caching on weights whose greedy continuation is known
     (`_successor_weights`): a 1,024-token shared prefix (shared pages
     byte-unchanged), then, with prefix matching off, the 8 prompts plain,
     with n-gram drafts and with oracle drafts under
     SWIFTLLM_TILE_BF16_SCORES=1 (every draft accepted, fewer steps); on
     these weights the next token is a function of the last one alone, so
     this engine checks paths, launches and the accept loop, not attention
     values (phase 3 checks those); then swap preemption at the default
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
then one {"kernels": [...]} line and, last, {"ok": true, "device": {...}}.

With --compare-multi-step it builds the kernels and runs only
compare_multi_step: one full-width engine decoding the same 8 requests in
turns with single steps, windows of 8 and windows of 8 with deferred commit,
without a profiler, several rounds in one process on one card. With
--compare-splits it runs only compare_splits: the verify spans and the long
decode rows (also in a bucket of 128 rows) at one split and at the
planner's choice, timed in turn. With --compare-prefill it times the prefill
kernel once on the cases of its kernel-table rows (mixed step, deep chunk
under a window, verify spans at the plan and at one split): run it from two
checkouts in turns to compare two builds on one card. With --compare-int4
it builds only int4_matmul and times it once at each 8B shape and T = 1,
16, 128, 256; it calls nothing the kernel's earlier versions lack, so a copy
of this script in an earlier checkout times that checkout's kernel. With
--sweep-int4 it builds only int4_matmul and times it at each 8B shape and
T for every token width and split count its plan chooses from, beside the
plan's model (the evidence for int4_matmul.py's constants). With
--sweep-swap it builds only swap_pages and times a round trip of 128 pages
at several grids, alone and beside a decode-like load (the evidence for
swap_pages.py's MOVER_BLOCKS).

It imports nothing of JAX. Reports too long for the console (the kernels'
ptxas report, the profiler tables) go to chiprun_out/, and so does a copy of
every line this script logs (chip_smoke.log), and the api_server's output
(api_server.log).
"""

from __future__ import annotations

import asyncio
import gc
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

from swiftllm_tpu_torch.config import EngineConfig, LlamaModelConfig
from swiftllm_tpu_torch.models.llama import quantize_kv
from swiftllm_tpu_torch.ops import build
from swiftllm_tpu_torch.ops import int4_matmul as im
from swiftllm_tpu_torch.ops import paged_attention as pa
from swiftllm_tpu_torch.ops.swap_pages import (page_slots, pinned_pool,
                                               swap_pages, swap_pages_plain)
from swiftllm_tpu_torch.server.api_server import build_app
from swiftllm_tpu_torch.server.engine import Engine
from swiftllm_tpu_torch.server.scheduler import ScheduledSeq
from swiftllm_tpu_torch.server.structs import RawRequest, Request
from swiftllm_tpu_torch.utils import cdiv, tile_q_for
from swiftllm_tpu_torch.worker.model import LlamaModel
from swiftllm_tpu_torch.worker.quant import (nibbles, quantize_int4,
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
REPS = 20
SLEEP_CYCLES = 20_000_000       # about 10 ms at the H100's clock
L2_BYTES = 50 * 2**20           # H100 L2: timed weights cycle through more
OUT_DIR = Path("chiprun_out")
DEVICE = "cuda"

SOURCE_OF = {n: f"swiftllm_tpu_torch/ops/csrc/{src}"
             for n, (src, _) in build.SOURCES.items()}
REPLACES = {
    "paged_decode_attention": "swiftllm_tpu/ops/paged_attention.py:248",
    "paged_decode_attention_pend": "swiftllm_tpu/ops/paged_attention.py:297",
    "store_kv": "swiftllm_tpu/ops/paged_attention.py:942",
    "paged_prefill_attention": "swiftllm_tpu/ops/paged_attention.py:843",
    "paged_prefill_attention_bf16s": "swiftllm_tpu/ops/paged_attention.py:1163",
    "int4_matmul": "swiftllm_tpu/ops/int4_matmul.py:61",
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
    return quantize_kv(kv[:, :KH], kv[:, KH:])


def paged_case(gen, device, *, rows, n_q, n_kv, hd, page_size, layers=2,
               q_bucket=1, fp8=False, rows_bucket=0):
    """rows: list of (q_len, seq_len). Decode rows (q_len 1) first, packed so
    flat token b is row b; multi-token spans follow, aligned to 128 tokens as
    the batch builder aligns them. Pages are a random permutation of the pool
    (scattered); the pool's last page is the garbage page, in no row. With
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
    used = 0
    for b, (ql, sl) in enumerate(rows):
        pages = perm[used:used + n_pages_row[b]]
        used += n_pages_row[b]
        pt[b, :len(pages)] = torch.tensor(pages, dtype=torch.int32)
        q_lens[b], seq_lens[b], q_st[b] = ql, sl, q_starts[b]
        for i in range(ql):
            pos = sl - ql + i
            slots[q_starts[b] + i] = pages[pos // page_size] * page_size + pos % page_size
    # Decode-kind and prefill-kind q_lens, and the scatter slots: -1 (dropped)
    # for decode-kind tokens, whose write the decode kernel does itself, and
    # for pad tokens, as the model's unpack_step_batch gives them.
    n_dec = sum(1 for ql, _ in rows if ql == 1)
    scatter = torch.where(slots == S - page_size, -1, slots)
    scatter[:n_dec] = -1
    bf = dict(device=device, dtype=torch.bfloat16)
    g = torch.Generator(device=device).manual_seed(int(torch.randint(1 << 30, (1,), generator=gen)))
    q = torch.randn(T, n_q, hd, generator=g, **bf)
    if fp8:
        cache = fp8_rows(g, layers * S, W // 2, device).view(layers, S, -1)
        kv_new = fp8_rows(g, T, W // 2, device)
    else:
        cache = torch.randn(layers, S, W, generator=g, **bf)
        kv_new = torch.randn(T, W, generator=g, **bf)
    return dict(
        q=q, cache=cache, kv_new=kv_new, n_kv=n_kv,
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


def _store(case, cache, impl):
    impl(cache, case["kv_new"], case["scatter"], case["layer"])


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


def check_kernels(case, *, name, results, window=0):
    """Run the case through kernels and plain versions; check outputs and the
    cache; time each kernel, its plain version and a library yardstick."""
    ps = case["page_size"]
    has_dec = case["n_dec"] > 0
    has_pre = any(ql > 1 for ql, _ in case["rows"])
    c_k = case["cache"].clone()
    c_p = case["cache"].clone()
    out = {}
    if has_dec:
        got = _decode(case, c_k, pa.paged_decode_attention, window)
        want = _decode(case, c_p, pa.paged_decode_attention_plain, window)
        idx = _valid_tokens(case, "decode")
        out["paged_decode_attention"] = _compare(got[idx], want[idx])
        if has_pre is False:
            assert torch.equal(got[len(idx):], torch.zeros_like(got[len(idx):]))
    if has_pre:
        _store(case, c_k, pa.store_kv)
        _store(case, c_p, pa.store_kv_plain)
        assert _cache_equal(c_k, c_p, ps), f"{name}: store_kv cache differs"
        got = _prefill(case, c_k, pa.paged_prefill_attention, window)
        want = _prefill(case, c_p, pa.paged_prefill_attention_plain, window)
        idx = _valid_tokens(case, "prefill")
        out["paged_prefill_attention"] = _compare(got[idx], want[idx])
    assert _cache_equal(c_k, c_p, ps), f"{name}: cache after the writes differs"
    for k_, (err, med, ratio) in out.items():
        log(f"[kernels] {name} {k_}: max_abs_err {err:.3g}, median |want| "
            f"{med:.3g}, worst {ratio:.3g} of the tolerance")
        assert ratio <= 1, f"{name}: {k_} disagrees with its plain version"
    log(f"[kernels] {name}: cache bit-identical after the writes (garbage "
        f"page excluded{', store_kv checked alone too' if has_pre else ''})")
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
        # The work store_kv must do: one read and one write of the row of
        # each prefill-kind token (decode-kind and pad tokens are dropped).
        n_tok = int(case["pre_lens"].sum())
        row_bytes = case["kv_new"].shape[1] * case["kv_new"].element_size()
        keep = case["scatter"] >= 0                      # selection NOT timed
        slots_l = case["scatter"][keep].long()
        rows_l = pa.as_bytes(case["kv_new"])[keep]
        lib_cache = pa.as_bytes(c_k)[case["layer"]]
        results["store_kv"] = dict(
            max_abs_err=0.0,
            ms=time_ms(lambda: _store(case, c_k, pa.store_kv)),
            plain_ms=time_ms(lambda: _store(case, c_p, pa.store_kv_plain), reps=3),
            library_ms=time_ms(lambda: lib_cache.index_copy_(0, slots_l, rows_l)),
            **dict(zip(("bound_ms", "bound_by"), bound(2 * n_tok * row_bytes, 0))))
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
        "for store_kv")
    for k_, r in results.items():
        log(f"[time] {name} {k_}: " + ", ".join(
            f"{a}={b:.4f}" if isinstance(b, float) else f"{a}={b}"
            for a, b in r.items()))


def check_planted_fault(case):
    """The tolerance must catch a subtly wrong kernel. Run the decode kernel
    with the longest row's seq_len cut by one page, so that it skips the 16
    history keys before the new one, and require that its output for that
    row fails the comparison with the plain version on the true inputs."""
    b = int(case["seq_lens"].argmax())
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


def pend_case(gen, device, hists, npend, n_pad=0):
    """A deferred-commit decode case at 8B width, at inner step npend - 1 of
    a window: row b has hists[b] keys in the cache (on scattered pages),
    npend - 1 completed window tokens in kv_pend[layer, :npend - 1, b] and
    the current one in kv_new[b]; the last n_pad rows of the row axis are pad
    rows. The cache slots of the window's positions hold unrelated rows (the
    window is not committed), and the pending slots from npend - 1 on hold
    stale rows of three times the magnitude."""
    case = paged_case(gen, device, rows=[(1, h + npend) for h in hists],
                      n_q=32, n_kv=8, hd=128, page_size=16)
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
    _store(case, c, pa.store_kv)
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
        _store(case, c, pa.store_kv)
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
    run it at 8B width: store_kv of the spans, then paged_prefill_attention
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
    the verify spans at the planner's split and at one split; one process
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
        _store(case, c, pa.store_kv)
        for splits in ((None, 1) if label == "verify spans" else (None,)):
            t = time_ms(lambda: _bf16s(case, c, False, window=window, splits=splits))
            out.append(f"{label}{'' if splits is None else ', one split'} {t:.4f}")
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
    _store(case, c, pa.store_kv)
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
    layer and of every span row that store_kv writes by `gap` (a span that
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
    return dict(case, q=q.bfloat16(), cache=cache, kv_new=kv_new)


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
    _store(case, c, pa.store_kv)
    build.reset_launch_counts()
    assert torch.equal(_bf16s(case, c, True), _bf16s(case, c, False))
    torch.cuda.synchronize()
    assert build.launch_counts["paged_prefill_attention_bf16s"] == 0
    log("[kernels] SWIFTLLM_TILE_BF16_SCORES=1 with an fp8 cache: the f32 "
        "kernel, byte-equal output")
    return row


def time_quantize(device, smi):
    """The quantizing kv_new build (plain PyTorch ops, as the JAX package
    leaves it to XLA) against the bf16 build, per layer at 8B width, in the
    serving decode bucket (128 tokens) and the prefill bucket (2,048)."""
    g = torch.Generator(device=device).manual_seed(9)
    out = {}
    for T in (128, 2048):
        k = torch.randn(T, 1024, generator=g, device=device).to(torch.bfloat16)
        v = torch.randn(T, 1024, generator=g, device=device).to(torch.bfloat16)
        out[T] = time_ms(lambda: quantize_kv(k, v))
        plain = time_ms(lambda: torch.cat([k, v], dim=1).to(torch.bfloat16))
        log(f"[time] quantize_kv T={T} (8 kv heads of 128): {out[T]:.4f} ms a "
            f"layer, {32 * out[T]:.3f} ms over 32 layers; the bf16 build "
            f"{plain:.4f} ms a layer ({smi})")
    return out


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
    check_kernels(paged_case(gen, device, rows=mixed, q_bucket=512, **w8b),
                  name="mixed 8B", results=mres)
    results["store_kv"] = mres["store_kv"]
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
                check_kernels(case, name=f"{tag}window {window} {label}",
                              results={} if timed else None, window=window)
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
    for group in (1, 2, 8):      # the other GQA instances, tiny
        check_kernels(paged_case(gen, device, q_bucket=64, rows=(
            [(1, 5), (1, 70), (33, 33), (20, 100)]), n_q=2 * group, n_kv=2,
            hd=128, page_size=16), name=f"group {group}", results=None)
    return results


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


def _int4_cycle(gen, N, K, device):
    """Random int8 weights and scales for timing at one shape: enough layers
    that a run cycling through them reads more weight bytes than L2 holds,
    as a step meets each layer's weights cold. Returns (q4, s, layers)."""
    L4 = max(2, math.ceil(2 * L2_BYTES / (N * K // 2)))
    q4 = torch.randint(-128, 128, (L4, N, K // 2), generator=gen,
                       device=device, dtype=torch.int8)
    s = torch.rand(L4, N, generator=gen, device=device) * 1e-2
    return q4, s, L4


def _int4_timings(gen, x, N, K, device):
    """Kernel, plain and library times at one shape. The kernel and the
    library call each cycle through more weight bytes than L2 holds.
    Library: F.linear on the weight dequantized to bf16 beforehand (the
    dequantization is not timed)."""
    T = x.shape[0]
    q4, s, L4 = _int4_cycle(gen, N, K, device)
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


def sweep_int4(smi):
    """The evidence behind int4_matmul's plan: its time at each 8B shape and
    T in INT4_TS for every token width the plan may take (down to a quarter
    of the widest) and K splits 1, 2, 3, 4, 6, 8, 16 (those that give
    distinct plans), each beside the plan's model of it (int4_matmul.plan_us)
    and the plan's own choice."""
    gen = torch.Generator(device=DEVICE).manual_seed(6)
    n_sms = build.sm_count(torch.device(DEVICE, 0))
    for label, (N, K) in INT4_SHAPES.items():
        q4, s, L4 = _int4_cycle(gen, N, K, DEVICE)
        for T in INT4_TS:
            x = torch.randn(T, K, generator=gen, device=DEVICE).to(torch.bfloat16)
            chosen = im.int4_plan(T, N, K, n_sms)
            widest = max(w for w in im.TOKEN_WIDTHS
                         if w <= max(chosen.nt, min(T, im.TOKEN_WIDTHS[-1])))
            out, it = [], itertools.count()
            for nt in (w for w in im.TOKEN_WIDTHS if widest // 4 <= w <= widest):
                seen = set()
                for sp in (1, 2, 3, 4, 6, 8, 16):
                    p = im.int4_plan(T, N, K, n_sms, sp, nt)
                    if p.splits in seen:
                        continue
                    seen.add(p.splits)
                    t = time_ms(lambda: im.int4_proj_stacked(
                        x, q4, s, next(it) % L4, splits=sp, nt=nt))
                    out.append(f"{nt}x{p.t_tiles}/{p.splits} {t:.4f} "
                               f"({im.plan_us(p, n_sms) / 1e3:.4f})")
            log(f"[sweep] int4_matmul {label} T={T}, plan {chosen.nt}x"
                f"{chosen.t_tiles}/{chosen.splits} (token width x tiles / "
                f"splits): " + ", ".join(out) + f" ms measured (modelled) ({smi})")
        del q4, s
        torch.cuda.empty_cache()


def compare_int4(smi):
    """int4_matmul's time at each 8B shape and T in INT4_TS, once each in one
    process, cycling through more weight bytes than L2 holds. It calls only
    int4_proj_stacked(x, q4, s, layer), so this script, copied into an
    earlier checkout, times that checkout's kernel: run the two in turns
    (parent, change, change, parent) to compare builds on one card."""
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    out = []
    for label, (N, K) in INT4_SHAPES.items():
        q4, s, L4 = _int4_cycle(gen, N, K, DEVICE)
        for T in INT4_TS:
            x = torch.randn(T, K, generator=gen, device=DEVICE).to(torch.bfloat16)
            it = itertools.count()
            t = time_ms(lambda: im.int4_proj_stacked(x, q4, s, next(it) % L4))
            out.append(f"{label} T={T} {t:.4f}")
        del q4, s
        torch.cuda.empty_cache()
    log(f"[compare] int4_matmul: {'; '.join(out)} ms ({smi})")


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
        build.stream())
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
    (every destination page one further) must fail. Then one round trip of
    SWAP_N bf16 pages, timed, against the host link's byte bound (its rate
    measured here), the plain version and cudaMemcpy2DAsync per run.
    Returns the times (ms) by name."""
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
        src = rng.permutation(n_dev)[:SWAP_N]
        lists = {"scattered": (src, rng.permutation(n_host)[:SWAP_N],
                               rng.permutation(np.setdiff1d(np.arange(n_dev), src))[:SWAP_N]),
                 "consecutive": (np.arange(100, 100 + SWAP_N), np.arange(SWAP_N),
                                 np.arange(300, 300 + SWAP_N))}
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
                        f"ms (out {t_out:.4f}, in {t_in:.4f}: {moved / (1e-3 * t_out) / 1e9:.2f} "
                        f"and {moved / (1e-3 * t_in) / 1e9:.2f} GB/s); the link's "
                        f"byte bound {bound_ms:.4f} ms; cudaMemcpy2DAsync per run "
                        f"({page_runs(s, h).shape[1]} runs out, {page_runs(h, b).shape[1]} "
                        f"in) {t_lib:.4f} ms")
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


def sweep_swap(smi):
    """--sweep-swap: the mover's grid (MOVER_BLOCKS). A round trip of SWAP_N
    scattered 8B bf16 pages at each grid, alone and on a side stream beside
    a decode-like load, against cudaMemcpy2DAsync per run (the evidence for
    swap_pages.py's MOVER_BLOCKS)."""
    rate_in, rate_out = link_rates()
    ps, W, n_dev, n_host = 16, 2 * 8 * 128, 1024, 512
    g = torch.Generator(device=DEVICE).manual_seed(31)
    rng = np.random.default_rng(31)
    cache = torch.empty(32, n_dev * ps, W, dtype=torch.bfloat16, device=DEVICE)
    cache.view(torch.uint8).random_(0, 256, generator=g)
    pool = pinned_pool((32, n_host * ps, W), torch.bfloat16)
    s = rng.permutation(n_dev)[:SWAP_N]
    h = rng.permutation(n_host)[:SWAP_N]
    b = rng.permutation(np.setdiff1d(np.arange(n_dev), s))[:SWAP_N]
    moved = SWAP_N * 32 * ps * W * 2
    bound_ms = 1e3 * (moved / rate_out + moved / rate_in)
    lib = lambda: (copy_page_runs(cache, pool, s, h, ps),  # noqa: E731
                   copy_page_runs(pool, cache, h, b, ps))
    t_lib = time_ms(lib)
    load, n, alone = decode_like_load(t_lib)
    m, ld, sw = overlap_ms(load, lib)
    log(f"[sweep swap] link {rate_in / 1e9:.2f} / {rate_out / 1e9:.2f} GB/s, "
        f"round-trip bound {bound_ms:.4f} ms; load {n} GEMMs, {alone:.4f} ms "
        f"alone; cudaMemcpy2DAsync per run: {t_lib:.4f} ms alone, beside the "
        f"load makespan {m:.4f} ms, load {ld:.4f}, swap {sw:.4f} ({smi})")
    for blocks in (0, 1056, 264, 132, 66, 32, 16, 8):
        def trip():
            swap_pages(cache, pool, s, h, ps, blocks=blocks)
            swap_pages(pool, cache, h, b, ps, blocks=blocks)
        t_out = time_ms(lambda: swap_pages(cache, pool, s, h, ps, blocks=blocks))
        t_in = time_ms(lambda: swap_pages(pool, cache, h, b, ps, blocks=blocks))
        m, ld, sw = overlap_ms(load, trip)
        log(f"[sweep swap] mover, {blocks or SWAP_N * 32} blocks: round trip "
            f"{t_out + t_in:.4f} ms alone (out {t_out:.4f}, in {t_in:.4f}); "
            f"beside the load makespan {m:.4f} ms, load {ld:.4f} "
            f"(+{100 * (ld / alone - 1):.1f}%), swap {sw:.4f} ({smi})")


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


def _randomize(params, g, quant):
    """Unit norms and N(0, 0.02) weights from g, in place; a quantized weight
    is drawn in f32 one layer at a time and quantized on the card."""
    def fill(t):
        if not isinstance(t, dict):
            t.normal_(0.0, 0.02, generator=g)
            return
        q = t["q4"] if "q4" in t else t["q"]
        K = q.shape[-1] * (2 if "q4" in t else 1)
        for idx in (range(q.shape[0]) if q.dim() == 3 else [slice(None)]):
            qd = quantize_weight_torch(torch.empty(
                q.shape[-2], K, device=q.device).normal_(0.0, 0.02, generator=g), quant)
            for k, v in qd.items():
                t[k][idx].copy_(v)

    for k, t in list(params["layers"].items()) + [
            ("embed", params["embed"]), ("lm_head", params["lm_head"]),
            ("final_norm", params["final_norm"])]:
        if k.startswith("lora_"):      # adapters keep their own values
            continue
        if "norm" in k:
            t.fill_(1.0)
        else:
            fill(t)


def phase_step(quant="none", kv_quant="none", mistral=False):
    """One mixed step at 8B width, 4 layers: kernels against plain versions on
    the same weights (std 0.02 from a seeded generator, unit norms) and the
    same random cache. Greedy tokens must agree on every row whose top-2
    margin in the plain run exceeds twice the largest logit difference. With
    INT4 weights the step is 8 decode rows and a 128-token chunk, a bucket of
    256 tokens, so the kernel run sends every projection through
    int4_matmul and the plain run through quant.proj; a third run, the
    attention kernels with int4_matmul's plain version, isolates the INT4
    kernel, under the same rule. With kv_quant="fp8" the cache holds
    quantized rows (pages of 32). With `mistral` the widths and the window
    of 4096 are Mistral-7B-v0.1's, and three rows' histories exceed the
    window: decode rows of 4,097 and 5,000 keys and a chunk after 5,488."""
    mc = LlamaModelConfig(num_layers=4, **(MISTRAL_7B if mistral else LLAMA3_8B))
    ec = dict(model_path="", use_dummy=True, dtype="bfloat16", quant=quant,
              kv_quant=kv_quant, block_size=32 if kv_quant == "fp8" else 16,
              preemption_mode="recompute", num_hbm_blocks=1024,
              max_blocks_per_seq=128, max_batch_size=16)
    specs = [(40 + 97 * i, 40 + 97 * i, 1) for i in range(8)]
    specs += ([(512, 0, 512), (1600, 1024, 512), (812, 512, 300)]
              if quant == "none" else [(812, 512, 128)])
    if mistral:
        ec.update(num_hbm_blocks=2048, max_blocks_per_seq=512, max_batch_size=8)
        specs = [(n, n, 1) for n in (40, 500, 4096, 4999)]
        specs += [(512, 0, 512), (6000, 5488, 512), (812, 512, 300)]
    what = (f"{'Mistral-7B' if mistral else '8B'} width, 4 layers, quant {quant}, "
            f"kv_quant {kv_quant}, window {mc.sliding_window or 0}")
    # (run, use_pallas): the kernels; the plain versions; and, with INT4
    # weights, the attention kernels with int4_matmul's plain version, which
    # isolates the INT4 kernel (the same f32 sums, one rounding).
    runs = [("kernels", True), ("plain", False)]
    if quant == "int4":
        runs.append(("int4 plain", True))
    logits, models, launches = {}, {}, {}
    for run, use_kernels in runs:
        m = LlamaModel(EngineConfig(**ec, use_pallas=use_kernels), mc,
                       device=DEVICE)
        if run == "kernels":
            m.load_weights()
            g = torch.Generator(device=DEVICE).manual_seed(1234)
            _randomize(m.params, g, quant)
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
        int4_kernel = im.int4_proj_stacked
        if run == "int4 plain":
            im.int4_proj_stacked = im.int4_proj_stacked_plain
        try:
            tokens, rows, lg = m.forward(_requests(specs, mc.vocab_size),
                                         return_logits=True)
        finally:
            im.int4_proj_stacked = int4_kernel
        torch.cuda.synchronize()
        launches[run] = dict(build.launch_counts)
        if quant == "int4":
            want = 7 * mc.num_layers if run == "kernels" else 0
            assert launches[run]["int4_matmul"] == want, (run, launches[run])
        live = [i for i, r in enumerate(rows) if r is not None]
        logits[run] = torch.from_numpy(lg[live])
        models[run] = m
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
            f"with margin > 2x diff all agree")
    del models, logits, cache0
    torch.cuda.empty_cache()


# A top-2 logit margin counts as clear above twice the largest
# kernels-against-plain logit difference the step phases above measure
# (about 0.1 at these widths and weights).
CLEAR_MARGIN = 0.2


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
            m.load_weights()
            g = torch.Generator(device=DEVICE).manual_seed(4321)
            _randomize(m.params, g, "none")
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
                "store_kv": 0, "paged_prefill_attention": 0}
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
            m.load_weights()
            g = torch.Generator(device=DEVICE).manual_seed(2468)
            _randomize(m.params, g, "none")
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
        want = (dict(paged_decode_attention=4, store_kv=4, paged_prefill_attention=4)
                if use_kernels else dict(paged_decode_attention=0, store_kv=0,
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
    m.load_weights()
    g = torch.Generator(device=DEVICE).manual_seed(1357)
    _randomize(m.params, g, "none")
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
    want = dict(paged_decode_attention=4, store_kv=4, paged_prefill_attention=4)
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
    m.load_weights()
    _randomize(m.params, g, "none")
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
    return pa.KERNELS + (("int4_matmul",) if name == "int4" else ()) + (
        ("paged_decode_attention_pend",) if name == "ms8defer" else ())


async def serve_engine(name: str, smi: str, pools: dict, quantize_ms: dict,
                       outputs: dict):
    """The serving path at full width, 32 layers, as SERVE_RUNS[name] sets
    it: 8 concurrent requests, launch counts, pages back, the profile; the
    bf16 engine also answers /generate over HTTP, and the fp8-KV engine
    serves one long prompt more. The MS_RUNS engines get weights of std 0.02
    from one seed, sample three of their requests, collect every token's
    logprob (outputs[name]) and are held to MS_PREDICTED. The engine is
    released before this returns, so that the next one sizes its cache on an
    empty card."""
    widths, ec_kw, prompt_lens, long_prompt = SERVE_RUNS[name]
    multi = name in MS_RUNS
    if name == "ms8defer":
        os.environ["SWIFTLLM_DEFER_KV"] = "1"
    mc = LlamaModelConfig(num_layers=32, **widths)
    ec = EngineConfig(model_path="", use_dummy=True, dtype="bfloat16",
                      preemption_mode="recompute", **ec_kw)
    t0 = time.perf_counter()
    engine = Engine(ec, mc, device=DEVICE)
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
    if multi:
        _randomize(engine.model.params,
                   torch.Generator(device=DEVICE).manual_seed(77), "none")
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

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    t_run = time.perf_counter()
    res = await asyncio.gather(*[one(i, n) for i, n in enumerate(prompt_lens)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    launches = dict(build.launch_counts)
    for (_, stamps, toks), n in zip(res, prompt_lens):
        assert len(toks) == out_len, f"prompt {n}: {len(toks)} tokens"
        assert all(0 <= t < mc.vocab_size for t in toks)
    for k in serve_kernels(name):
        assert launches[k] > 0, f"{k} never launched on the {name} serving path"
    if name == "int4":
        n = launches["int4_matmul"]
        assert n % (7 * mc.num_layers) == 0, n     # one launch a projection
        log(f"[serve int4] int4_matmul launched {n} times: 7 projections x "
            f"{mc.num_layers} layers x {n // (7 * mc.num_layers)} steps of at "
            f"most {im.MAX_T} tokens")
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
        for k in pa.KERNELS:
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
    busy_ms, prof_steps = await _profile(engine, smi, name,
                                         out_len=65 if multi else 24)
    if ec.kv_quant == "fp8":
        q_ms = mc.num_layers * quantize_ms[128]
        log(f"[profile {name}] the quantizing kv_new build: {q_ms:.3f} ms a "
            f"decode step (32 layers at the 128-token bucket, timed alone) "
            f"against {busy_ms / prof_steps:.3f} ms of device time a step in "
            f"this profile ({prof_steps} steps): {100 * q_ms * prof_steps / busy_ms:.1f}%")
    if name in ("none", "ms8"):
        await _http(engine, mgr, free0, logprobs=multi)
    os.environ.pop("SWIFTLLM_DEFER_KV", None)
    loops.cancel()
    await asyncio.wait([loops])
    assert loops.cancelled()
    engine.model.params = engine.model.kv_cache = engine.model.token_feedback = None
    del engine, mgr, loops
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


def _successor_weights(params, g):
    """Weights of a model whose greedy continuation is known and robust:
    the next token is succ(t), the successor of the last one inside its
    block of 8 (t -> t+1, and the block's last back to its first), with a
    top-2 logit margin in the thousands. Embeddings N(0, 1), lm_head row
    succ(t) = embed row t, unit norms, every projection N(0, 0.002): the 32
    layers move the residual stream by about a tenth of the embedding, so
    attention and the MLPs run on real values and the argmax stays put. A
    verify step and a decode step round differently (other kernels, other
    GEMM shapes); near-tied logits would then turn a correct draft into a
    rejection by rounding alone. The sequence cycles with period 8, which
    the n-gram proposer finds once a cycle has been generated."""
    for k, t in params["layers"].items():
        if k.startswith("lora_"):      # adapters keep their own values
            continue
        if "norm" in k:
            t.fill_(1.0)
        else:
            t.normal_(0.0, 0.002, generator=g)
    params["final_norm"].fill_(1.0)
    embed, lm_head = params["embed"], params["lm_head"]
    assert lm_head.data_ptr() != embed.data_ptr(), "needs an untied lm_head"
    embed.normal_(0.0, 1.0, generator=g)
    V = embed.shape[0]
    assert V % 8 == 0
    t = torch.arange(V, device=embed.device)
    lm_head[(t & ~7) | ((t + 1) & 7)] = embed


def successor(t: int) -> int:
    return (t & ~7) | ((t + 1) & 7)


SPEC_PREFIX = 1024
SPEC_OUT_LEN = 32


async def serve_spec(smi: str) -> dict:
    """Phase 4, speculative decoding and prefix caching: a full-width 8B
    bf16 engine with enable_spec_decode (spec_k 4) and enable_prefix_caching,
    weights from _successor_weights, warmed up (verify buckets included).
    In turn: (1) 8 requests sharing a 1,024-token prefix with distinct
    suffixes, the first alone, then 7: matched tokens, the second wave's
    TTFT, the shared pages byte-unchanged by it; (2) the 8 prompts of the
    bf16 run with spec off (the reference, "plain"); (3) the same with the
    n-gram proposer; (4) the same with an oracle proposing the plain run's
    continuation and SWIFTLLM_TILE_BF16_SCORES=1; (2)-(4) with prefix
    matching off, so that none rides the pages of another. Every wave: every
    token the successor of the one before, tokens equal to the plain run's,
    pages back, and per step one launch a layer of the decode kernel, and of
    store_kv and the prefill kernel (or its bf16-score variant) when the q
    bucket is above 1. The weights set the next token from the last one
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
    await engine.initialize(tokenizer_backend="inline")
    model = engine.model
    _successor_weights(model.params, torch.Generator(device=DEVICE).manual_seed(55))
    keys = []
    execute = model.execute_packed

    def spy(flat, key, *a):
        keys.append(key)
        return execute(flat, key, *a)
    model.execute_packed = spy
    await engine.warmup()
    warm = [k for k in keys if k.spec]
    assert warm and {k.q_len for k in warm} == {SPEC_Q}, keys
    mgr = model.hbm_block_mgrs[0]
    free0 = mgr.num_free_blocks
    log(f"[serve spec] engine up and warmed in {time.perf_counter() - t0:.1f} s "
        f"({len(keys)} warm-up steps, {len(warm)} of them verify steps); "
        f"{model.num_hbm_blocks} pages of {ec.block_size}")
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
        try:
            torch.cuda.synchronize()
            t_run = time.perf_counter()
            res = await asyncio.gather(*[one(p) for p in prompts])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t_run
        finally:
            os.environ.pop("SWIFTLLM_TILE_BF16_SCORES")
        await _pages_back(mgr, free0)
        launches = dict(build.launch_counts)
        st = {k: engine.stats.snapshot()[k] - st0[k] for k in
              ("num_spec_drafted", "num_spec_accepted")}
        steps = len(keys)
        big = sum(k.q_len > 1 for k in keys)
        verify = sum(k.spec > 0 for k in keys)
        pre = "paged_prefill_attention_bf16s" if bf16s else "paged_prefill_attention"
        want = {"paged_decode_attention": 32 * steps, "store_kv": 32 * big,
                pre: 32 * big}
        want["paged_prefill_attention" if bf16s else "paged_prefill_attention_bf16s"] = 0
        assert {k: launches[k] for k in want} == want, (name, launches, want)
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
            f"{verify} verify: {32 * verify} of the {32 * big} store_kv and "
            f"prefill launches); drafted {st['num_spec_drafted']}, accepted "
            f"{st['num_spec_accepted']}; TTFT p50 {1e3 * ttft[len(ttft) // 2]:.1f} "
            f"ms, max {1e3 * ttft[-1]:.1f} ms; decode "
            f"{n_after / max(last - first, 1e-9):.1f} tok/s ({n_after} tokens after "
            f"the last first token); launches {launches} ({smi})")
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


async def _engine(ec, mc, seed, weights=_successor_weights):
    """A full-width engine on `weights` (_successor_weights by default)
    from `seed`, its loops running."""
    t0 = time.perf_counter()
    engine = Engine(ec, mc, device=DEVICE)
    await engine.initialize(tokenizer_backend="inline")
    weights(engine.model.params, torch.Generator(device=DEVICE).manual_seed(seed))
    loops = asyncio.create_task(engine.start_all_event_loops())
    return engine, loops, time.perf_counter() - t0


async def _release(engine, loops):
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
    full again at the end. Weights: _successor_weights (the tokens are the
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
    for k in pa.KERNELS:
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
    t_run = time.perf_counter()
    got = await _serve_greedy(engine, prompts, SWAP_OUT)
    wall = time.perf_counter() - t_run
    launches = dict(build.launch_counts)
    swaps = engine.stats.num_preemptions - preempted0
    await _pages_back(mgr, pages)
    await _pages_back(cpu, ec.num_cpu_blocks)
    assert engine.scheduler.num_free_cpu_blocks == ec.num_cpu_blocks
    assert swaps >= 1 and launches["swap_pages"] >= 2 * swaps, (swaps, launches)
    for k in pa.KERNELS:
        assert launches[k] > 0, f"{k} never launched on the swapping engine"
    assert got == want, "the unwrapped swap run's tokens differ from the roomy run's"
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


def _random_weights(params, g):
    _randomize(params, g, "none")


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
                                      92, _random_weights)
    assert engine.model.lora_slots == {"a": 1, "b": 2}
    build.reset_launch_counts()
    mixed = await _serve_greedy(engine, prompts, LORA_OUT, LORA_OF)
    launches = dict(build.launch_counts)
    for k in pa.KERNELS:
        assert launches[k] > 0, f"{k} never launched on the LoRA engine"
    bad = engine.submit(RawRequest("", 4, prompt_token_ids=[1, 2, 3], lora="c"))
    assert bad.aborted and not bad.output_token_ids, "an unknown adapter was served"
    with_lora = await _decode_profile(engine, "lora", "a", smi)
    await _release(engine, loops)
    engine, loops, _ = await _engine(EngineConfig(**kw), mc, 92, _random_weights)
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
            _random_weights)
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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    reqs = [RawRequest("", out_len, lora=lora, prompt_token_ids=[
        (3 * i + j) % 1000 + 1 for j in range(prompt)]) for i in range(n_req)]
    torch.cuda.synchronize()
    steps0 = engine.stats.num_steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        await asyncio.gather(*[engine.add_request_and_wait(r) for r in reqs])
        torch.cuda.synchronize()
    steps = engine.stats.num_steps - steps0
    events = prof.key_averages()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    ops = sum(e.count for e in dev) / steps
    busy = sum(e.self_device_time_total for e in dev) / 1e3 / steps
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


async def phase_serve(smi: str, quantize_ms: dict, adapters: dict) -> dict:
    """Phases 4-5: the engines of SERVE_RUNS, one after another, then the
    speculative-decoding engine, the swapping engines (bf16 and fp8) and the
    LoRA engines (`adapters`: name -> peft dir)."""
    pools, outputs = {}, {}
    launches = {name: await serve_engine(name, smi, pools, quantize_ms, outputs)
                for name in SERVE_RUNS}
    launches["spec"] = await serve_spec(smi)
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


async def _profile(engine, smi: str, quant: str, n_req=8, prompt=64,
                   out_len=24):
    """Where a step's time goes: n_req short requests (so mostly decode
    steps) under torch.profiler. Prints the kernels with the most device
    time and the device's busy share of the wall time; the full table goes
    to chiprun_out/profile_<quant>.txt."""
    from torch.profiler import ProfilerActivity, profile
    reqs = [RawRequest("", out_len, prompt_token_ids=[(3 * i + j) % 1000 + 1
                                                       for j in range(prompt)])
            for i in range(n_req)]
    torch.cuda.synchronize()
    steps0 = engine.stats.num_steps
    build.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        await asyncio.gather(*[engine.add_request_and_wait(r) for r in reqs])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    busy = sum(e.self_device_time_total for e in events) / 1e6
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
    if quant == "int4":
        # One device kernel per INT4 projection: the split merge runs inside
        # the launch, no second pass.
        kern = [e for e in events
                if "int4_matmul" in e.key and e.self_device_time_total > 0]
        n_dev = sum(e.count for e in kern)
        launched = build.launch_counts["int4_matmul"]
        t_int4 = sum(e.self_device_time_total for e in kern) / 1e3
        # The profiler is not an exact counter: CUPTI may drop a few activity
        # records of a run this long (one run on the H100 saw 5,145 of 5,152
        # launches). A second pass would show as twice the launches, so the
        # device count may fall short of the launches by at most 1% and never
        # exceed them.
        lost = launched - n_dev
        assert launched > 0 and 0 <= lost and 100 * lost <= launched, (
            launched, [(e.key, e.count) for e in kern])
        assert all("int4_matmul_kernel" in e.key for e in kern), [e.key for e in kern]
        int4_steps = launched // (7 * engine.model_config.num_layers)
        log(f"[profile {quant}] int4_matmul: {launched} launches, {n_dev} INT4 "
            f"kernels on the device ({lost} record(s) lost to the profiler; "
            f"{len(kern)} instance(s), no second pass), "
            f"{t_int4:.3f} ms, {100 * t_int4 / (1e3 * busy):.1f}% of device time; "
            f"{t_int4 / int4_steps:.3f} ms a step in each of the {int4_steps} "
            "steps that ran it")
    return 1e3 * busy, engine.stats.num_steps - steps0


async def _pages_back(mgr, free0, timeout=10.0):
    """The engine frees a finished request's pages at its next scheduling
    round; wait for that, then require the pool back at its initial size."""
    t_end = time.perf_counter() + timeout
    while mgr.num_free_blocks != free0 and time.perf_counter() < t_end:
        await asyncio.sleep(0.01)
    assert mgr.num_free_blocks == free0, (mgr.num_free_blocks, free0)


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1
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
        sweep_swap(smi)
        return 0
    if sys.argv[1:] in (["--compare-int4"], ["--sweep-int4"]):
        build.build_kernels(("int4_matmul",))
        (compare_int4 if sys.argv[1] == "--compare-int4" else sweep_int4)(smi)
        return 0
    t0 = time.perf_counter()
    reports = build.build_kernels()
    log(f"[build] {len(build.KERNELS)} kernels ({len(reports)} sources) built "
        f"in {time.perf_counter() - t0:.1f} s")
    if reports:     # a run that built nothing keeps the last report
        (OUT_DIR / "ptxas.txt").write_text("\n".join(
            f"== {k}\n{v}" for k, v in reports.items()))
    if sys.argv[1:] == ["--compare-multi-step"]:
        asyncio.run(compare_multi_step(smi))
        return 0
    if sys.argv[1:] == ["--compare-splits"]:
        compare_splits(smi)
        return 0
    if sys.argv[1:] == ["--compare-prefill"]:
        compare_prefill(smi)
        return 0
    if sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}", file=sys.stderr)
        return 2
    for k, v in reports.items():
        for line in v.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[ptxas] {k}: {line.strip()}")

    results = phase_kernels("cuda")
    results["paged_decode_attention_pend"] = phase_pend("cuda", smi)
    phase_verify("cuda", smi)
    results["paged_prefill_attention_bf16s"] = phase_bf16s("cuda", smi)
    quantize_ms = time_quantize("cuda", smi)
    time_sampler("cuda", smi)
    torch.cuda.empty_cache()
    results["int4_matmul"] = phase_int4("cuda", smi)
    swap = phase_swap_mover(smi)
    phase_step()
    phase_step("int4")
    phase_step(kv_quant="fp8")
    phase_step("int4", kv_quant="fp8")
    phase_step(mistral=True)
    phase_multi_step()
    phase_verify_step()
    phase_prefix_step()
    tmp = tempfile.TemporaryDirectory()
    adapters = {}
    for name, seed in (("a", 101), ("b", 202)):
        adapters[name] = Path(tmp.name) / name
        write_peft_adapter(adapters[name], LLAMA3_8B, 32, seed)
    phase_lora_step(adapters)
    launches = asyncio.run(phase_serve(smi, quantize_ms, adapters))
    http_cli(smi, Path(tmp.name))
    tmp.cleanup()
    # Launches: the decode kernel's and store_kv's on the bf16 serving run
    # (the path of the slice that brought them), int4_matmul's on the INT4
    # run, the `pend` variant's on the deferred multi-step run, the prefill
    # kernel's and its bf16-score variant's on the speculative-decoding
    # engine's waves; the other runs' counts are asserted and logged by their
    # runs.
    run_of = {"int4_matmul": "int4", "paged_decode_attention_pend": "ms8defer",
              "paged_prefill_attention": "spec",
              "paged_prefill_attention_bf16s": "spec"}
    kernels = [dict(name=n, route="cuda", source=SOURCE_OF[n],
                    replaces=REPLACES[n],
                    launches=launches[run_of.get(n, "none")][n], **results[n])
               for n in REPLACES]
    # The page mover replaces no TPU kernel: its own line.
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
