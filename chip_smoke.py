"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):
  0. the card's name and power limit, torch and CUDA versions;
  1. build the hand-written kernels from swiftllm_tpu_torch/ops/csrc;
  2. each kernel against its plain PyTorch version at Llama-3-8B width
     (and one case at Llama-3.2-1B width), with times and bounds, and one
     planted fault (a decode row short of one page) that must fail;
  3. one whole mixed step, kernels against plain versions, 8B width, 4 layers;
  4. the serving path: the port's Engine at full 8B width (32 layers, dummy
     weights), 8 concurrent requests, launch counts of every kernel;
  5. /generate over HTTP through the port's build_app;
then one {"kernels": [...]} line and, last, {"ok": true, "device": {...}}.

It imports nothing of JAX. Reports too long for the console (the kernels'
ptxas report, the profiler table) go to chiprun_out/.
"""

from __future__ import annotations

import asyncio
import json
import math
import socket
import subprocess
import sys
import time
from pathlib import Path

import torch

from swiftllm_tpu_torch.config import EngineConfig, LlamaModelConfig
from swiftllm_tpu_torch.ops import paged_attention as pa
from swiftllm_tpu_torch.server.api_server import build_app
from swiftllm_tpu_torch.server.engine import Engine
from swiftllm_tpu_torch.server.scheduler import ScheduledSeq
from swiftllm_tpu_torch.server.structs import RawRequest, Request
from swiftllm_tpu_torch.utils import cdiv
from swiftllm_tpu_torch.worker.model import LlamaModel

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 tensor cores
# Kernel against plain version, both f32 inside and rounded once to bf16 at
# the end: they may land one or two bf16 ulps apart (an ulp is 2^-8 to 2^-7
# of the value), which rtol 1e-2 allows; atol 2e-3 covers outputs near 0.
# Outputs of long rows are small (median |out| about 0.03 at 2,048 keys), so
# atol must stay well below them: check_planted_fault shows that a decode
# kernel skipping one page of a long history fails at this tolerance.
ATOL, RTOL = 2e-3, 1e-2
REPS = 20
OUT_DIR = Path("chiprun_out")
DEVICE = "cuda"

SOURCE_OF = {n: f"swiftllm_tpu_torch/ops/csrc/{s}" for n, s in pa.SOURCES.items()}
REPLACES = {
    "paged_decode_attention": "swiftllm_tpu/ops/paged_attention.py:248",
    "store_kv": "swiftllm_tpu/ops/paged_attention.py:942",
    "paged_prefill_attention": "swiftllm_tpu/ops/paged_attention.py:843",
}


def log(*a):
    print(*a, flush=True)


def time_ms(fn, reps=REPS, warmup=3) -> float:
    """Mean time of fn() on the card, from CUDA events around `reps` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
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

def paged_case(gen, device, *, rows, n_q, n_kv, hd, page_size, layers=2,
               q_bucket=1):
    """rows: list of (q_len, seq_len). Decode rows (q_len 1) first, packed so
    flat token b is row b; multi-token spans follow, aligned to 128 tokens as
    the batch builder aligns them. Pages are a random permutation of the pool
    (scattered); the pool's last page is the garbage page, in no row."""
    W = 2 * n_kv * hd
    B = 1 << max(len(rows) - 1, 0).bit_length()
    n_pages_row = [cdiv(s, page_size) for _, s in rows]
    n_pages = sum(n_pages_row) + 4
    S = (n_pages + 1) * page_size
    Pg = max(n_pages_row)
    align = 1 if q_bucket == 1 else min(q_bucket, 128)
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
    return dict(
        q=torch.randn(T, n_q, hd, generator=g, **bf),
        cache=torch.randn(layers, S, W, generator=g, **bf),
        kv_new=torch.randn(T, W, generator=g, **bf),
        page_table=pt.to(device), kv_slots=slots.to(device),
        q_starts=q_st.to(device), q_lens=q_lens.to(device),
        seq_lens=seq_lens.to(device), rows=rows, page_size=page_size,
        sm_scale=1.0 / math.sqrt(hd), layer=layers - 1, q_bucket=q_bucket,
        n_dec=n_dec, dec_lens=torch.where(q_lens == 1, q_lens, 0).to(device),
        pre_lens=torch.where(q_lens > 1, q_lens, 0).to(device),
        scatter=scatter.to(device))


def _decode(case, cache, impl):
    return impl(case["q"], cache, case["kv_new"], case["page_table"],
                case["dec_lens"],
                case["seq_lens"], case["kv_slots"], case["layer"],
                page_size=case["page_size"], sm_scale=case["sm_scale"])


def _store(case, cache, impl):
    impl(cache, case["kv_new"], case["scatter"], case["layer"])


def _prefill(case, cache, impl):
    kw = dict(page_size=case["page_size"], sm_scale=case["sm_scale"])
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


def _compare(got, want):
    """(max |got - want|, median |want|, worst |got - want| over the
    tolerance ATOL + RTOL |want|). They agree when the last is at most 1."""
    g, w = got.float(), want.float()
    d = (g - w).abs()
    ratio = (d / (ATOL + RTOL * w.abs())).max().item()
    if not bool(torch.isfinite(g).all()):
        ratio = math.inf
    return d.max().item(), w.abs().median().item(), ratio


def _cache_equal(a, b, page_size):
    """Bit-identical caches, the garbage page (last page_size slots) excluded."""
    return torch.equal(a[:, :-page_size].view(torch.int16),
                       b[:, :-page_size].view(torch.int16))


def _decode_costs(case):
    hd, n_q = case["q"].shape[2], case["q"].shape[1]
    W = case["kv_new"].shape[1]
    rows = [(ql, sl) for ql, sl in case["rows"] if ql == 1]
    n = len(rows)
    nbytes = 2 * (sum(sl - 1 for _, sl in rows) * W + 2 * n * W
                  + n * n_q * hd + case["q"].shape[0] * n_q * hd)
    flops = 4 * n_q * hd * sum(sl for _, sl in rows)
    return nbytes, flops


def _prefill_costs(case):
    hd, n_q = case["q"].shape[2], case["q"].shape[1]
    W = case["kv_new"].shape[1]
    rows = [(ql, sl) for ql, sl in case["rows"] if ql > 1]
    nbytes = 2 * (sum(sl for _, sl in rows) * W
                  + sum(ql for ql, _ in rows) * n_q * hd
                  + case["q"].shape[0] * n_q * hd)
    flops = 4 * n_q * hd * sum(sum(range(sl - ql + 1, sl + 1)) for ql, sl in rows)
    return nbytes, flops


def _dense_kv(case, cache, kind):
    """The rows' K and V gathered dense ([n, n_kv, K, hd]) with a visibility
    mask [n, 1, Q, K], for the scaled_dot_product_attention yardstick."""
    hd = case["q"].shape[2]
    S, W = cache.shape[1], cache.shape[2]
    n_kv, KH = W // (2 * hd), W // 2
    rows = [(b, ql, sl) for b, (ql, sl) in enumerate(case["rows"])
            if (ql == 1) == (kind == "decode")]
    Kmax = max(sl for _, _, sl in rows)
    Qmax = max(ql for _, ql, _ in rows)
    n = len(rows)
    dev = case["q"].device
    k = torch.zeros(n, n_kv, Kmax, hd, device=dev, dtype=cache.dtype)
    v = torch.zeros_like(k)
    qd = torch.zeros(n, case["q"].shape[1], Qmax, hd, device=dev, dtype=cache.dtype)
    mask = torch.zeros(n, 1, Qmax, Kmax, device=dev, dtype=torch.bool)
    for i, (b, ql, sl) in enumerate(rows):
        slots = pa._row_slots(case["page_table"][b], sl, case["page_size"],
                              S // case["page_size"])
        kv = cache[case["layer"], slots]
        k[i, :, :sl] = kv[:, :KH].reshape(sl, n_kv, hd).transpose(0, 1)
        v[i, :, :sl] = kv[:, KH:].reshape(sl, n_kv, hd).transpose(0, 1)
        s = int(case["q_starts"][b])
        qd[i, :, :ql] = case["q"][s:s + ql].transpose(0, 1)
        qpos = torch.arange(sl - ql, sl, device=dev)
        mask[i, 0, :ql] = torch.arange(Kmax, device=dev)[None, :] <= qpos[:, None]
        mask[i, 0, ql:, 0] = True   # pad queries see key 0: no all-masked rows
    return qd, k, v, mask


def check_kernels(case, *, name, results):
    """Run the case through kernels and plain versions; check outputs and the
    cache; time each kernel, its plain version and a library yardstick."""
    ps = case["page_size"]
    has_dec = case["n_dec"] > 0
    has_pre = any(ql > 1 for ql, _ in case["rows"])
    c_k = case["cache"].clone()
    c_p = case["cache"].clone()
    out = {}
    if has_dec:
        got = _decode(case, c_k, pa.paged_decode_attention)
        want = _decode(case, c_p, pa.paged_decode_attention_plain)
        idx = _valid_tokens(case, "decode")
        out["paged_decode_attention"] = _compare(got[idx], want[idx])
        if has_pre is False:
            assert torch.equal(got[len(idx):], torch.zeros_like(got[len(idx):]))
    if has_pre:
        _store(case, c_k, pa.store_kv)
        _store(case, c_p, pa.store_kv_plain)
        assert _cache_equal(c_k, c_p, ps), f"{name}: store_kv cache differs"
        got = _prefill(case, c_k, pa.paged_prefill_attention)
        want = _prefill(case, c_p, pa.paged_prefill_attention_plain)
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
        nbytes, flops = _decode_costs(case)
        qd, k, v, mask = _dense_kv(case, c_k, "decode")    # gather NOT timed
        results["paged_decode_attention"] = dict(
            max_abs_err=out["paged_decode_attention"][0],
            ms=time_ms(lambda: _decode(case, c_k, pa.paged_decode_attention)),
            plain_ms=time_ms(lambda: _decode(case, c_p, pa.paged_decode_attention_plain), reps=3),
            library_ms=time_ms(lambda: sdpa(qd, k, v, attn_mask=mask, enable_gqa=True)),
            **dict(zip(("bound_ms", "bound_by"), bound(nbytes, flops))))
    if has_pre:
        # The work store_kv must do: one read and one write of the row of
        # each prefill-kind token (decode-kind and pad tokens are dropped).
        n_tok = int(case["pre_lens"].sum())
        W = case["kv_new"].shape[1]
        keep = case["scatter"] >= 0                      # selection NOT timed
        slots_l, rows_l = case["scatter"][keep].long(), case["kv_new"][keep]
        results["store_kv"] = dict(
            max_abs_err=0.0,
            ms=time_ms(lambda: _store(case, c_k, pa.store_kv)),
            plain_ms=time_ms(lambda: _store(case, c_p, pa.store_kv_plain), reps=3),
            library_ms=time_ms(lambda: c_k[case["layer"]].index_copy_(0, slots_l, rows_l)),
            **dict(zip(("bound_ms", "bound_by"), bound(2 * 2 * n_tok * W, 0))))
        nbytes, flops = _prefill_costs(case)
        qd, k, v, mask = _dense_kv(case, c_k, "prefill")   # gather NOT timed
        results["paged_prefill_attention"] = dict(
            max_abs_err=out["paged_prefill_attention"][0],
            ms=time_ms(lambda: _prefill(case, c_k, pa.paged_prefill_attention)),
            plain_ms=time_ms(lambda: _prefill(case, c_p, pa.paged_prefill_attention_plain), reps=3),
            library_ms=time_ms(lambda: sdpa(qd, k, v, attn_mask=mask, enable_gqa=True)),
            **dict(zip(("bound_ms", "bound_by"), bound(nbytes, flops))))
    log("[time] library_ms: scaled_dot_product_attention on K/V gathered "
        "dense beforehand (the gather is outside the timed region); "
        "index_copy_ of the prefill-kind rows for store_kv")
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
    check_kernels(paged_case(gen, device, rows=[(1, 20000), (1, 16385), (1, 1)],
                             **w8b), name="decode 8B long rows", results=None)
    mixed = ([(1, 40 + 97 * i) for i in range(8)]
             + [(512, 512), (512, 1536), (300, 812)])
    mres = {}
    check_kernels(paged_case(gen, device, rows=mixed, q_bucket=512, **w8b),
                  name="mixed 8B", results=mres)
    results["store_kv"] = mres["store_kv"]
    results["paged_prefill_attention"] = mres["paged_prefill_attention"]
    w1b = dict(n_q=32, n_kv=8, hd=64, page_size=16)
    check_kernels(paged_case(gen, device, q_bucket=512, rows=(
        [(1, 1), (1, 333), (1, 1000)] + [(200, 200), (77, 589)]), **w1b),
        name="mixed 1B (hd 64)", results=None)
    for group in (1, 2, 8):      # the other GQA instances, tiny
        check_kernels(paged_case(gen, device, q_bucket=64, rows=(
            [(1, 5), (1, 70), (33, 33), (20, 100)]), n_q=2 * group, n_kv=2,
            hd=128, page_size=16), name=f"group {group}", results=None)
    return results


# ---------------------------------------------------------------------------
# Phases 3-5: the model, the engine, HTTP
# ---------------------------------------------------------------------------

LLAMA3_8B = dict(num_q_heads=32, num_kv_heads=8, hidden_size=4096, head_dim=128,
                 ffn_inter_dim=14336, vocab_size=128256,
                 max_position_embeddings=8192, rms_norm_eps=1e-5,
                 rope_theta=500000.0)


def _requests(specs):
    """(prompt_len, cached, n_tokens) -> port Requests scheduled for one step;
    cached tokens stand for a history already in the cache, with one output
    token to feed next when cached == prompt_len."""
    sched = []
    for i, (plen, cached, n) in enumerate(specs):
        r = Request(RawRequest("", 4))
        r.set_prompt_token_ids([(31 * i + 7 * j) % 120000 + 1 for j in range(plen)])
        if cached == plen:
            r.output_token_ids = [17 + i]
        r.num_cached_tokens = cached
        r.seq_id = i
        sched.append(ScheduledSeq(r, n))
    return sched


def phase_step():
    """One mixed step at 8B width, 4 layers: kernels against plain versions on
    the same weights (std 0.02 from a seeded generator, unit norms) and the
    same random cache. Greedy tokens must agree on every row whose top-2
    margin in the plain run exceeds twice the largest logit difference."""
    mc = LlamaModelConfig(num_layers=4, **LLAMA3_8B)
    ec = dict(model_path="", use_dummy=True, dtype="bfloat16",
              preemption_mode="recompute", num_hbm_blocks=1024,
              max_blocks_per_seq=128, max_batch_size=16)
    specs = ([(40 + 97 * i, 40 + 97 * i, 1) for i in range(8)]
             + [(512, 0, 512), (1600, 1024, 512), (812, 512, 300)])
    logits, models = {}, {}
    for use_kernels in (True, False):
        m = LlamaModel(EngineConfig(**ec, use_pallas=use_kernels), mc,
                       device=DEVICE)
        if use_kernels:
            m.load_weights()
            g = torch.Generator(device=DEVICE).manual_seed(1234)
            for k, t in list(m.params["layers"].items()) + [
                    ("embed", m.params["embed"]), ("lm_head", m.params["lm_head"]),
                    ("final_norm", m.params["final_norm"])]:
                if "norm" in k:
                    t.fill_(1.0)
                else:
                    t.normal_(0.0, 0.02, generator=g)
            m.init_kvcache_and_swap()
            m.kv_cache.normal_(0.0, 1.0, generator=g)
            cache0 = m.kv_cache.clone()
        else:
            m.params = models[True].params
            m.init_kvcache_and_swap()
            m.kv_cache.copy_(cache0)
        for i, (_, cached, _) in enumerate(specs):
            if cached:
                m.hbm_block_mgrs[0].allocate_for_seq(i, cached)
        tokens, rows, lg = m.forward(_requests(specs), return_logits=True)
        live = [i for i, r in enumerate(rows) if r is not None]
        logits[use_kernels] = torch.from_numpy(lg[live])
        models[use_kernels] = m
    a, b = logits[True], logits[False]
    assert torch.isfinite(a).all() and torch.isfinite(b).all()
    diff = (a - b).abs().max().item()
    top2 = b.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    checked = margin > 2 * diff
    agree = a.argmax(-1) == b.argmax(-1)
    assert bool(agree[checked].all()), "greedy tokens differ on a clear-margin row"
    log(f"[step] 8B width, 4 layers, mixed step of {len(specs)} rows: max "
        f"|logit diff| {diff:.4g} (logit std {b.std().item():.4g}); greedy "
        f"tokens agree on {int(agree.sum())}/{len(agree)} rows, "
        f"{int(checked.sum())} rows with margin > 2x diff all agree")
    del models, logits, cache0
    torch.cuda.empty_cache()


async def phase_serve(smi: str):
    """The serving path at full 8B width, then /generate over HTTP."""
    mc = LlamaModelConfig(num_layers=32, **LLAMA3_8B)
    ec = EngineConfig(model_path="", use_dummy=True, dtype="bfloat16",
                      preemption_mode="recompute")
    t0 = time.perf_counter()
    engine = Engine(ec, mc, device=DEVICE)
    await engine.initialize(tokenizer_backend="inline")
    mgr = engine.model.hbm_block_mgrs[0]
    free0 = mgr.num_free_blocks
    log(f"[serve] engine up in {time.perf_counter() - t0:.1f} s: "
        f"{engine.model.num_hbm_blocks} KV pages of {ec.block_size} tokens")
    loops = asyncio.create_task(engine.start_all_event_loops())
    prompt_lens = [17, 100, 250, 400, 600, 900, 1200, 1500]
    out_len = 32

    async def one(i, n):
        ids = [(13 * i + 5 * j) % 128000 + 1 for j in range(n)]
        t_sub = time.perf_counter()
        stamps, toks = [], []
        async for so in engine.add_request_and_stream(
                RawRequest("", out_len, prompt_token_ids=ids)):
            stamps.append(time.perf_counter())
            toks.append(so.token_id)
        return t_sub, stamps, toks

    torch.cuda.synchronize()
    pa.reset_launch_counts()
    t_run = time.perf_counter()
    res = await asyncio.gather(*[one(i, n) for i, n in enumerate(prompt_lens)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    launches = dict(pa.launch_counts)
    for (_, stamps, toks), n in zip(res, prompt_lens):
        assert len(toks) == out_len, f"prompt {n}: {len(toks)} tokens"
        assert all(0 <= t < mc.vocab_size for t in toks)
    for k in pa.KERNELS:
        assert launches[k] > 0, f"{k} never launched on the serving path"
    ttft = sorted(st[0] - t for t, st, _ in res)
    # Decode rate: tokens streamed after the last request's first token, over
    # the time from then to the last token (all 8 rows decoding).
    first = max(st[0] for _, st, _ in res)
    last = max(st[-1] for _, st, _ in res)
    n_after = sum(1 for _, st, _ in res for x in st if x > first)
    log(f"[serve] 8 requests, prompts {prompt_lens}, {out_len} tokens each, "
        f"in {wall:.3f} s ({smi}); launches {launches}")
    log(f"[serve] TTFT p50 {1e3 * ttft[len(ttft) // 2]:.1f} ms, max "
        f"{1e3 * ttft[-1]:.1f} ms; decode {n_after / (last - first):.1f} tok/s "
        f"({n_after} tokens after the last first token); output "
        f"{len(res) * out_len / wall:.1f} tok/s over the run; "
        f"{engine.stats.num_steps} steps ({smi})")
    await _pages_back(mgr, free0)
    await _profile(engine, smi)

    # --- Phase 5: /generate over HTTP on 127.0.0.1 ---------------------------
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
            async with http.post(url, json={"prompt_token_ids": ids,
                                            "output_len": 8}) as r:
                assert r.status == 200, r.status
                body = await r.json()
            assert len(body["output_token_ids"]) == 8 and isinstance(body["output"], str)
            streamed = []
            async with http.post(url, json={"prompt_token_ids": ids, "output_len": 8,
                                            "stream": True, "decode": False}) as r:
                assert r.status == 200, r.status
                async for line in r.content:
                    if line.strip():
                        streamed.append(json.loads(line)["token_id"])
            assert streamed == body["output_token_ids"], (streamed, body)
        log(f"[http] /generate on 127.0.0.1:{port}: non-streaming and streaming "
            f"answers agree ({body['output_token_ids']})")
        await _pages_back(mgr, free0)
    finally:
        await runner.cleanup()
        loops.cancel()
    return launches


async def _profile(engine, smi: str, n_req=8, prompt=64, out_len=24):
    """Where a step's time goes: n_req short requests (so mostly decode
    steps) under torch.profiler. Prints the kernels with the most device
    time and the device's busy share of the wall time; the full table goes
    to chiprun_out/profile.txt."""
    from torch.profiler import ProfilerActivity, profile
    reqs = [RawRequest("", out_len, prompt_token_ids=[(3 * i + j) % 1000 + 1
                                                       for j in range(prompt)])
            for i in range(n_req)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        await asyncio.gather(*[engine.add_request_and_wait(r) for r in reqs])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    busy = sum(e.self_device_time_total for e in events) / 1e6
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)
    (OUT_DIR / "profile.txt").write_text(events.table(
        sort_by="self_device_time_total", row_limit=40))
    log(f"[profile] {n_req} requests, prompt {prompt}, {out_len} tokens each: "
        f"wall {1e3 * wall:.1f} ms, device busy {1e3 * busy:.1f} ms "
        f"({100 * busy / wall:.1f}%) ({smi})")
    for e in top[:8]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms "
            f"{e.count:6d}x  {e.key[:90]}")


async def _pages_back(mgr, free0, timeout=10.0):
    """The engine frees a finished request's pages at its next scheduling
    round; wait for that, then require the pool back at its initial size."""
    t_end = time.perf_counter() + timeout
    while mgr.num_free_blocks != free0 and time.perf_counter() < t_end:
        await asyncio.sleep(0.01)
    assert mgr.num_free_blocks == free0, (mgr.num_free_blocks, free0)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    OUT_DIR.mkdir(exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[card] {smi}")
    log(f"[versions] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    reports = pa.build_kernels()
    log(f"[build] {len(reports)} kernels built in {time.perf_counter() - t0:.1f} s")
    (OUT_DIR / "ptxas.txt").write_text("\n".join(
        f"== {k}\n{v}" for k, v in reports.items()))
    for k, v in reports.items():
        for line in v.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[ptxas] {k}: {line.strip()}")

    results = phase_kernels("cuda")
    torch.cuda.empty_cache()
    phase_step()
    launches = asyncio.run(phase_serve(smi))
    kernels = [dict(name=n, route="cuda", source=SOURCE_OF[n],
                    replaces=REPLACES[n], launches=launches[n], **results[n])
               for n in pa.KERNELS]
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
