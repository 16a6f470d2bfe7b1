"""Split-KV in the port's paged attention, on the CPU.

The decode and prefill kernels cut each attention unit's keys into splits
that separate blocks walk, and merge the splits' softmax states
(``swiftllm_tpu_torch/ops/csrc/splitkv.cuh``). On the CPU the kernels do not
run; what runs is the plan (``split_plan``, ints only) and the plain version
of split-then-merge (``split_kv_attention_plain``), which the card holds the
kernels' split paths against (``chip_smoke.py``). Here:

- ``split_kv_attention_plain`` against the unsplit plain versions, in f32,
  to atol 1e-5 / rtol 1e-5 (the same keys; only the merge's order of sums
  differs), for decode, the deferred-commit variant and prefill, with and
  without a window, for forced split counts whose splits include ones with
  no visible key (past seq_len, or wholly below the window);
- the same split plain versions against the JAX package's
  ``ragged_paged_attention`` as its own tests run it: the jnp gather path
  (``use_pallas=False``) for a bf16 cache, an fp8 cache and windows, and the
  Pallas kernel in interpret mode for ``pend`` with its three key sources
  (pages, pending rows, the new row). f32 inputs: atol 2e-5 / rtol 1e-4, the
  JAX file's interpret tolerance; fp8: atol 1e-4 / rtol 1e-3, its fp8 one.
  The bf16 case runs the port in bf16 on bf16-valued inputs: atol 2e-3 /
  rtol 1e-2 (the output rounded once to bf16, an ulp or two);
- the planner: every key of every row lies in exactly one split, over
  decode and prefill buckets, window starts and page-table widths (Pg) up to
  the largest the kernels take; it takes ints only, and plans over the rows
  below ``live_rows``, which the model path passes down from the batch
  builder;
- the bf16-score variant's plain version (raw scores rounded from their
  exact value) against the one before it (rounded from an f32 sum), both
  against the Pallas kernel in interpret mode.

Inputs come from numpy generators with fixed seeds.
"""

import numpy as np
import pytest

import tests.conftest  # noqa: F401  (forces the JAX CPU backend)

import jax.numpy as jnp
import torch

from swiftllm_tpu.models import llama as jax_llama
from swiftllm_tpu.ops.paged_attention import (decode_group_geometry,
                                              ragged_paged_attention)
from swiftllm_tpu_torch.config import LlamaModelConfig
from swiftllm_tpu_torch.ops import paged_attention as pa
from swiftllm_tpu_torch.utils import cdiv
from tests import test_torch_spec as spec_tests
from tests.test_torch_fp8_kv import fp8_case
from tests.test_torch_paged_attention import (LAYER, _to_torch, make_case,
                                              run_jax)

F32_TOL = dict(atol=1e-5, rtol=1e-5)

# name -> (rows (q_len, seq_len), make_case keywords, window). Decode rows
# first. Pg * page_size is far above most rows, so with 4 or 8 splits the
# later ones start past every short row's seq_len; the windows leave the
# first splits of the long rows with no visible key.
CASES = {
    "decode": ([(1, 1), (1, 9), (1, 61), (1, 120), (1, 23)], dict(Pg=16), 0),
    "decode_window": ([(1, 120), (1, 77), (1, 3)], dict(Pg=16), 10),
    "mixed": ([(1, 33), (1, 7), (16, 16), (5, 29), (9, 300)], dict(Pg=64), 0),
    "mixed_window": ([(1, 100), (1, 5), (32, 32), (21, 377)],
                     dict(Pg=64, q_bucket=32), 70),
    "spans": ([(1, 90), (2, 40), (5, 399), (3, 17), (4, 226)],
              dict(Pg=64, q_bucket=8), 0),
}
SPLITS = (2, 4, 8)


def _tensors(case, dtype=torch.float32):
    t = {k: torch.from_numpy(np.asarray(case[k]).copy())
         for k in ("page_table", "q_starts", "q_lens", "seq_lens", "kv_slots")}
    t["q"] = torch.from_numpy(case["q"]).to(dtype)
    t["cache"] = _to_torch(case["cache"])
    t["kv_new"] = _to_torch(case["kv_new"])
    if t["cache"].dtype != pa.FP8:
        t["cache"], t["kv_new"] = t["cache"].to(dtype), t["kv_new"].to(dtype)
    t["dec_lens"] = torch.where(t["q_lens"] == 1, t["q_lens"], 0)
    t["pre_lens"] = torch.where(t["q_lens"] > 1, t["q_lens"], 0)
    return t


def _plan(case, kind, splits):
    B, Pg = case["page_table"].shape
    ps, n_kv = case["page_size"], case["n_kv"]
    if kind == "decode":
        return pa.decode_split_plan(B, n_kv, Pg, ps, 1, splits)
    group = case["q"].shape[1] // n_kv
    return pa.prefill_split_plan(B, case["q_bucket"], group, n_kv, Pg, ps, 1,
                                 splits, hd=case["q"].shape[2])


def run_port(case, window, splits, dtype=torch.float32):
    """The step through the port's plain versions: the decode rows (fused
    write), then store_kv and the prefill rows; each attention split as the
    kernel splits it under ``splits`` (None: unsplit). Returns (out, cache)."""
    t = _tensors(case, dtype)
    kw = dict(n_kv=case["n_kv"], page_size=case["page_size"],
              sm_scale=float(case["sm_scale"]), window=window)
    cache = t["cache"]
    out = torch.zeros_like(t["q"])
    n_dec = int((t["dec_lens"] > 0).sum())
    dec_args = (t["q"], cache, t["kv_new"], t["page_table"], t["dec_lens"],
                t["seq_lens"], t["kv_slots"], LAYER)
    pre_args = (t["q"], cache, t["page_table"], t["q_starts"], t["pre_lens"],
                t["seq_lens"], LAYER)
    if splits is None:
        dec = pa.paged_decode_attention_plain(*dec_args, **kw)
    else:
        dec = pa.split_kv_attention_plain(
            "paged_decode_attention", *dec_args,
            split=_plan(case, "decode", splits), **kw)
    out[:n_dec] = dec[:n_dec]
    if bool((t["pre_lens"] > 0).any()):
        # Decode-kind and pad tokens scatter to the garbage page.
        pa.store_kv_plain(cache, t["kv_new"],
                          torch.from_numpy(case["kv_slots_scatter"]), LAYER)
        if splits is None:
            pre = pa.paged_prefill_attention_plain(*pre_args, **kw)
        else:
            pre = pa.split_kv_attention_plain(
                "paged_prefill_attention", *pre_args,
                split=_plan(case, "prefill", splits), **kw)
        out[n_dec:] = pre[n_dec:]
    return out, cache


def _valid(case):
    """The flat tokens of every row."""
    toks = []
    for b, ql in enumerate(case["q_lens"]):
        if ql > 0:
            s0 = int(case["q_starts"][b])
            toks += list(range(s0, s0 + int(ql)))
    return toks


def _check(case, got, want, atol, rtol):
    idx = _valid(case)
    np.testing.assert_allclose(np.asarray(got, np.float32)[idx],
                               np.asarray(want, np.float32)[idx],
                               atol=atol, rtol=rtol)


def _has_empty_split(case, window, splits):
    """Whether some row has a split that sees none of its keys: one that
    starts past seq_len, or ends below the window."""
    for kind in ("decode", "prefill"):
        n_split, chunk = _plan(case, kind, splits)
        for ql, sl in zip(case["q_lens"], case["seq_lens"]):
            if ql == 0 or (ql == 1) != (kind == "decode"):
                continue
            lo = max(sl - int(ql) - window + 1, 0) if window else 0
            for s in range(n_split):
                beg, end = pa.split_range(s, n_split, chunk, lo, int(sl))
                if beg == end:
                    return True
    return False


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("name", list(CASES))
def test_split_plain_matches_unsplit_f32(name, splits):
    specs, kw, window = CASES[name]
    case = make_case(np.random.default_rng(60 + list(CASES).index(name)),
                     specs, **kw)
    got, c1 = run_port(case, window, splits)
    want, c2 = run_port(case, window, None)
    _check(case, got.numpy(), want.numpy(), **F32_TOL)
    ps = case["page_size"]
    assert torch.equal(c1[:, :-ps], c2[:, :-ps])    # the garbage page aside
    if splits >= 4:
        assert _has_empty_split(case, window, splits), "no split without a key"


@pytest.mark.parametrize("name", list(CASES))
def test_split_plain_matches_jax(name, monkeypatch):
    """f32 inputs: the split plain versions (8 splits) against the JAX
    gather path, outputs and caches."""
    specs, kw, window = CASES[name]
    case = make_case(np.random.default_rng(70 + list(CASES).index(name)),
                     specs, **kw)
    out, cache = run_port(case, window, 8)
    want_out, want_cache = run_jax(case, False, monkeypatch, window)
    _check(case, out.numpy(), want_out, atol=2e-5, rtol=1e-4)
    ps = case["page_size"]
    np.testing.assert_array_equal(cache.numpy()[:, :-ps], want_cache[:, :-ps])


@pytest.mark.parametrize("name", ["decode", "mixed_window", "spans"])
def test_split_plain_bf16_matches_jax(name, monkeypatch):
    """The port in bf16 (q, cache and kv_new bf16, as the kernels take them)
    on bf16-valued inputs against the JAX gather path in f32 on the same
    values: one rounding of the output apart."""
    specs, kw, window = CASES[name]
    case = make_case(np.random.default_rng(80 + list(CASES).index(name)),
                     specs, **kw)
    for k in ("q", "cache", "kv_new"):
        case[k] = torch.from_numpy(case[k]).bfloat16().float().numpy()
    out, _ = run_port(case, window, 4, dtype=torch.bfloat16)
    want, _ = run_jax(case, False, monkeypatch, window)
    _check(case, out.float().numpy(), want, atol=2e-3, rtol=1e-2)


@pytest.mark.parametrize("name", ["decode", "decode_window", "mixed", "spans"])
def test_split_plain_fp8_matches_jax(name, monkeypatch):
    """An fp8 cache (the same e4m3 bytes on both sides): the split plain
    versions against the JAX gather path, outputs and cache bytes."""
    specs, kw, window = CASES[name]
    case = fp8_case(make_case(np.random.default_rng(90 + list(CASES).index(name)),
                              specs, **kw))
    out, cache = run_port(case, window, 8)
    want_out, want_cache = run_jax(case, False, monkeypatch, window)
    _check(case, out.numpy(), want_out, atol=1e-4, rtol=1e-3)
    ps = case["page_size"]
    np.testing.assert_array_equal(cache.view(torch.uint8).numpy()[:, :-ps],
                                  want_cache.view(np.uint8)[:, :-ps])


@pytest.mark.parametrize("window", [0, 8])
def test_split_pend_matches_pallas_interpret(window):
    """The deferred-commit variant split 4 ways against the Pallas kernel
    (interpret mode): 8 rows (two pad rows), histories of 1 to 33 keys on
    scattered pages, 4 inner steps whose window crosses pages, so a row's
    keys come from its pages, its pending rows and its new row, and some
    splits hold only pending or new keys, or none (under the window of 8 the
    first splits of the longer rows lie wholly below it). Without a window
    the reference is the kernel in deferred mode. With one it is the fused
    kernel on the cache the window's commit leaves: the deferred mode of the
    JAX kernel under a window disagrees with its own fused mode
    (ROADMAP.md queue 3), and the port's plain version agrees with the
    fused one."""
    rng = np.random.default_rng(17)
    B, n_q, n_kv, hd, ps, Pg = 8, 4, 2, 64, 8, 8
    W = 2 * n_kv * hd
    S = 4
    hist0 = np.array([17, 33, 5, 1, 9, 25, 0, 0])
    valid = hist0 > 0
    n_pages = B * Pg + 2
    cache = rng.normal(size=(2, n_pages * ps, W)).astype(np.float32) * 0.5
    pt = np.stack([np.arange(Pg) * B + b + 1 for b in range(B)]).astype(np.int32)
    q_all = rng.normal(size=(S, B, n_q, hd)).astype(np.float32) * 0.5
    kv_all = rng.normal(size=(S, B, W)).astype(np.float32) * 0.5
    R, _, GB = decode_group_geometry(B)
    RW = R * W
    pend_jax = np.zeros((2, GB, S * RW), np.float32)
    pend_port = torch.from_numpy(rng.normal(size=(2, S, B, W)).astype(np.float32) * 3)
    committed = cache.copy()
    split = pa.decode_split_plan(B, n_kv, Pg, ps, 1, 4)
    assert split[0] == 4
    for s in range(S):
        seq = np.where(valid, hist0 + s + 1, 0).astype(np.int32)
        pos = np.where(valid, hist0 + s, 0).astype(np.int32)
        slots = np.where(valid, pt[np.arange(B), pos // ps] * ps + pos % ps,
                         n_pages * ps - ps).astype(np.int32)
        jb = jax_llama.StepBatch(
            token_ids=jnp.zeros(B, jnp.int32), positions=jnp.asarray(pos),
            q_starts=jnp.arange(B, dtype=jnp.int32),
            q_lens=jnp.asarray(valid.astype(np.int32)),
            seq_lens=jnp.asarray(seq), page_table=jnp.asarray(pt),
            kv_slots=jnp.asarray(slots), sample_mask=jnp.asarray(valid))
        kw = dict(n_kv=n_kv, page_size=ps, sm_scale=0.125, q_bucket=1,
                  kv_new=jnp.asarray(kv_all[s]), interpret=True, window=window)
        if window:
            want = np.asarray(ragged_paged_attention(
                jnp.asarray(q_all[s]), jnp.asarray(committed), jnp.int32(1),
                jb, **kw)[0])
        else:
            want = np.asarray(ragged_paged_attention(
                jnp.asarray(q_all[s]), jnp.asarray(cache), jnp.int32(1), jb,
                kv_pend=jnp.asarray(pend_jax), npend=jnp.int32(s + 1), **kw))
        got = pa.split_kv_attention_plain(
            "paged_decode_attention_pend", torch.from_numpy(q_all[s]),
            torch.from_numpy(cache), torch.from_numpy(kv_all[s]), pend_port,
            torch.from_numpy(pt), torch.from_numpy(valid.astype(np.int32)),
            torch.from_numpy(seq), 1, npend=s + 1, n_kv=n_kv, page_size=ps,
            sm_scale=0.125, window=window, split=split).numpy()
        np.testing.assert_allclose(got[valid], want[:B][valid], atol=2e-5,
                                   rtol=1e-4, err_msg=f"inner step {s}")
        assert not got[~valid].any(), "pad rows give zeros"
        pend_jax[1, :, s * RW:(s + 1) * RW] = kv_all[s].reshape(GB, RW)
        pend_port[1, s] = torch.from_numpy(kv_all[s])
        committed[1, slots[valid]] = kv_all[s][valid]


# --- the bf16-score variant's plain version -------------------------------------

def _attend_round_of_f32(real):
    """``pa._attend`` with the bf16-score plain version as it was defined
    before the tensor-core kernel: raw scores summed in f32 and then rounded
    to bf16, K2E formed in f64. Other calls go to ``real``."""
    def attend(q, kv, q_pos, n_kv, sm_scale, window, bf16_scores=False,
               split=None):
        if not bf16_scores:
            return real(q, kv, q_pos, n_kv, sm_scale, window, bf16_scores, split)
        n, n_q, hd = q.shape
        K, KH = kv.shape[0], n_kv * hd
        kvf = pa.dequantize_kv(kv, KH)
        k = kvf[:, :KH].reshape(K, n_kv, hd)
        v = kvf[:, KH:].reshape(K, n_kv, hd)
        qf = q.float().reshape(n, n_kv, n_q // n_kv, hd)
        visible = torch.arange(K)[None, :] <= q_pos[:, None]
        k2e = sm_scale * np.log2(np.e)
        k2e_b = float(torch.tensor(k2e).bfloat16())
        s = pa._round_bf16(torch.einsum("nhgd,khd->hgnk", qf, k))
        m = s.masked_fill(~visible, float("-inf")).amax(-1, keepdim=True) * k2e
        arg = pa._round_bf16(pa._round_bf16(s * k2e_b) - pa._round_bf16(m))
        p = pa._round_bf16(torch.exp2(arg)) * visible
        o = torch.einsum("hgnk,khd->nhgd", p, v) / p.sum(-1).permute(2, 0, 1)[..., None]
        return o.reshape(n, n_q, hd).to(q.dtype)
    return attend


def _bf16s_long_case():
    """Row maxima pinned, as the "pinned" case, at head_dim 128 over 61,440
    query-key pairs a head, on bf16-valued inputs (as the kernels take
    them): enough scores that some f32 sums fall on the other side of a
    bf16 rounding midpoint from their exact value."""
    case = make_case(np.random.default_rng(8), [(64, 512), (64, 448)], n_q=4,
                     n_kv=2, hd=128, page_size=16, Pg=32)
    for k in ("q", "cache"):
        case[k] = torch.from_numpy(case[k]).bfloat16().float().numpy()
    case = spec_tests.pin_row_max(case)
    for k in ("q", "cache"):
        case[k] = torch.from_numpy(case[k]).bfloat16().float().numpy()
    return case


BF16S_CASES = dict(spec_tests.BF16S_PALLAS,
                   pinned_long=(_bf16s_long_case, True, 5e-3, True))


@pytest.mark.parametrize("kind", list(BF16S_CASES))
def test_bf16_score_plain_versions_against_pallas(kind, monkeypatch):
    """The bf16-score plain version rounds each raw score from its exact
    value (the kernel's wgmma sums in another order than any f32 sum); the
    one before rounded an f32 sum. Against the Pallas kernel in that mode
    (interpret mode, on the cases of tests/test_torch_spec.py: the JAX
    test's case, and the row maxima pinned; and a pinned case of head_dim
    128 on bf16 values, large enough for the two to differ), the exact
    rounding is no
    further from JAX than the f32 one, and both stay within that file's
    bounds (3e-2; pinned 5e-3). The worst |port - Pallas| of each is
    printed."""
    make, exp2_once, tol, _ = BF16S_CASES[kind]
    case = make()
    monkeypatch.setenv("SWIFTLLM_TILE_BF16_SCORES", "1")
    exact = spec_tests.port_prefill(case)
    with monkeypatch.context() as mp:
        mp.setattr(pa, "_attend", _attend_round_of_f32(pa._attend))
        of_f32 = spec_tests.port_prefill(case)
    monkeypatch.setenv("SWIFTLLM_PALLAS_INTERPRET", "1")
    if exp2_once:
        monkeypatch.setattr(jnp, "exp2", spec_tests._exp2_rounded_once(jnp.exp2))
    batch = jax_llama.StepBatch(
        token_ids=jnp.zeros(len(case["positions"]), jnp.int32),
        sample_mask=jnp.zeros(len(case["q_lens"]), bool),
        **{f: jnp.asarray(case[f]) for f in spec_tests.BATCH_FIELDS})
    want = np.asarray(ragged_paged_attention(
        jnp.asarray(case["q"]), jnp.asarray(case["cache"]), jnp.int32(LAYER),
        batch, n_kv=case["n_kv"], page_size=case["page_size"],
        sm_scale=float(case["sm_scale"]), q_bucket=case["q_bucket"],
        interpret=True))
    idx = _valid(case)
    worst = {name: float(np.abs(got[idx] - want[idx]).max())
             for name, got in (("round of exact", exact), ("round of f32", of_f32))}
    differ = int((exact[idx] != of_f32[idx]).sum())
    print(f"bf16 scores, {kind}: worst |port - Pallas| {worst}; the two plain "
          f"versions differ in {differ} of {exact[idx].size} outputs")
    assert worst["round of exact"] <= worst["round of f32"], worst
    for got in (exact, of_f32):
        spec_tests.assert_rows_close(case, got, want, tol, tol)


# --- live rows ------------------------------------------------------------------

def test_model_passes_live_rows(monkeypatch):
    """The model path hands the attention wrappers the host's bound on the
    rows with queries (1 + the last such row of the rows bucket): a step of
    3 requests in a bucket of 8 rows gives live_rows 3 to execute_packed,
    forward_shard and each attention call."""
    from swiftllm_tpu_torch.config import EngineConfig, LlamaModelConfig
    from swiftllm_tpu_torch.models import llama
    from swiftllm_tpu_torch.server.scheduler import ScheduledSeq
    from swiftllm_tpu_torch.server.structs import RawRequest, Request
    from swiftllm_tpu_torch.worker.model import LlamaModel
    from tests.test_torch_engine import EC, MC
    m = LlamaModel(EngineConfig(**dict(EC, use_pallas=True)),
                   LlamaModelConfig(**MC), device="cpu")
    m.load_weights()
    m.init_kvcache_and_swap()
    seen, real = [], llama._attention_and_store
    monkeypatch.setattr(llama, "_attention_and_store",
                        lambda *a, **kw: seen.append(kw["live_rows"]) or real(*a, **kw))
    reqs = []
    for i, n in enumerate((5, 9, 3)):
        r = Request(RawRequest("", 2, prompt_token_ids=list(range(1, n + 1))))
        r.set_prompt_token_ids(list(range(1, n + 1)))
        r.seq_id = i
        reqs.append(r)
    m.forward([ScheduledSeq(r, r.num_uncached_tokens()) for r in reqs])
    assert m.last_key.rows == 8
    assert seen == [3] * MC["num_layers"]


def test_split_rows_bound_the_plan():
    """The plan counts the rows below live_rows, not the rows bucket: long
    rows in a bucket of 128 split as in a bucket of their own count."""
    assert pa.split_rows(128, None) == 128
    assert pa.split_rows(128, 3) == 3
    assert pa.split_rows(16, 40) == 16
    assert pa.split_rows(128, 0) == 1
    assert pa.decode_split_plan(128, 8, 1250, 16, 132)[0] == 1
    assert (pa.decode_split_plan(pa.split_rows(128, 3), 8, 1250, 16, 132)
            == pa.decode_split_plan(3, 8, 1250, 16, 132))
    assert pa.decode_split_plan(3, 8, 1250, 16, 132)[0] > 1
    assert pa.prefill_split_plan(128, 8, 4, 8, 128, 16, 132, hd=128)[0] == 1
    assert pa.prefill_split_plan(pa.split_rows(128, 16), 8, 4, 8, 128, 16, 132,
                                 hd=128) == (5, 448)


# --- the planner ------------------------------------------------------------------

def _cover(n_split, chunk, lo, hi):
    """How many splits each key of [lo, hi) falls in."""
    seen = np.zeros(max(hi - lo, 0), np.int64)
    for s in range(n_split):
        beg, end = pa.split_range(s, n_split, chunk, lo, hi)
        seen[beg - lo:end - lo] += 1
    return seen


@pytest.mark.parametrize("Pg", [1, 16, 128, 1250, 2048, 16384])
@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_plan_partitions_every_key_once(kind, Pg):
    """Over decode and prefill buckets, GQA groups, SM counts, forced split
    counts, rows up to Pg * page_size keys (and past it: the last split runs
    to the row's end) and window starts: every visible key of a row is in
    exactly one split; chunk is whole key tiles; at most MAX_SPLITS."""
    ps = 16
    for B in (1, 4, 16, 128):
        for n_sms, splits in ((132, None), (78, None), (132, 1), (132, 7),
                              (132, 64)):
            if kind == "decode":
                plans = [pa.decode_split_plan(B, 8, Pg, ps, n_sms, splits, window)
                         for window in (0, 50, 4096)]
            else:
                plans = [pa.prefill_split_plan(B, qb, g, 8, Pg, ps, n_sms, splits,
                                               window, hd=hd)
                         for qb in (8, 16, 512, 2048) for g in (1, 4, 8)
                         for hd in (64, 128) for window in (0, 50, 4096)]
            for n_split, chunk in set(plans):
                assert 1 <= n_split <= pa.MAX_SPLITS
                assert chunk % (pa.DECODE_KEY_STEP if kind == 'decode' else pa.KEY_TILE) == 0
                assert (n_split - 1) * chunk < max(Pg * ps, 1) <= n_split * chunk
                for hi in (1, 17, Pg * ps // 2 + 3, Pg * ps, Pg * ps + 40):
                    for lo in (0, hi // 3, max(hi - 5, 0)):
                        assert (_cover(n_split, chunk, lo, hi) == 1).all(), (
                            n_split, chunk, lo, hi)


def test_plan_fills_the_card_and_leaves_full_grids_alone():
    """Few units get splits (about SPLIT_BLOCKS_PER_SM blocks per SM, chunks
    of at least the floor); a grid that fills the card already gets one."""
    assert pa.decode_split_plan(16, 8, 128, 16, 132) == (5, 416)
    assert pa.decode_split_plan(4, 8, 1250, 16, 132) == (17, 1184)
    assert pa.prefill_split_plan(16, 8, 4, 8, 128, 16, 132, hd=128) == (5, 448)
    assert pa.prefill_split_plan(16, 512, 4, 8, 128, 16, 132, hd=128)[0] == 1
    # Under a window a unit sees few keys: no split where the window is short.
    assert pa.decode_split_plan(16, 8, 128, 16, 132, window=50)[0] == 1
    assert pa.prefill_split_plan(16, 8, 4, 8, 128, 16, 132, window=50, hd=128)[0] == 1
    assert pa.decode_split_plan(128, 8, 16, 16, 132)[0] == 1
    n, chunk = pa.decode_split_plan(1, 8, 16, 16, 132)   # 256 keys: the floor
    assert n == 1 and chunk >= pa.DECODE_MIN_CHUNK


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("group", range(1, 9))
def test_prefill_tiles_cover_every_query_once(group, hd):
    """Every GQA group from 1 to 8 (paged_prefill.cu runs a group under the
    least of 1, 2, 4, 8 at or above it): the host's tiles are the kernel's.
    A tile holds prefill_rows rows, group_bound bands of prefill_tokens
    tokens (row g * tokens + token); its live rows are bands g < group and
    tokens below the bucket. Over the bucket's tiles every (query token,
    head of the kv head) is one live row of exactly one tile, no tile starts
    past the bucket, prefill_units counts rows x tiles x kv heads, and the
    split plan's partials are sized by those units and rows. The decode
    partials are laid out by the real group."""
    n_kv, B = 2, 3
    gmax = pa.group_bound(group)
    assert gmax in pa.GROUP_BOUNDS and gmax >= group and (gmax == 1 or gmax // 2 < group)
    for qb in (2, 4, 8, 16, 64, 512, 2048, 4096):
        rows = pa.prefill_rows(qb, group, hd)
        tokens = pa.prefill_tokens(qb, group, hd)
        assert rows in (64, 128) and tokens * gmax == rows
        assert rows == (128 if hd == 128 and qb * gmax >= 128 else 64)
        tiles = cdiv(qb, tokens)
        assert (tiles - 1) * tokens < qb <= tiles * tokens
        seen = np.zeros((qb, group), np.int64)
        dead = 0
        for t in range(tiles):
            for r in range(rows):
                g, tok = divmod(r, tokens)
                if g < group and t * tokens + tok < qb:
                    seen[t * tokens + tok, g] += 1
                else:
                    dead += 1
        assert (seen == 1).all(), (qb, group, hd)
        assert dead == tiles * rows - qb * group
        units = pa.prefill_units(B, qb, group, n_kv, hd)
        assert units == B * tiles * n_kv
        n_split, chunk = pa.prefill_split_plan(B, qb, group, n_kv, 512, 16, 132,
                                               hd=hd)
        acc, ml, cnt = pa._split_buffers(torch.device("cpu"), units, n_split,
                                         rows, hd)
        if n_split > 1:
            assert acc.numel() == units * n_split * rows * hd
            assert ml.numel() == units * n_split * rows * 2
        assert cnt.numel() >= units + 2
    # The decode kernel's partials: each unit's splits hold `group` rows.
    acc, ml, _ = pa._split_buffers(torch.device("cpu"), B * n_kv, 4, group, hd)
    assert acc.numel() == B * n_kv * 4 * group * hd and ml.numel() == B * n_kv * 4 * group * 2


@pytest.mark.parametrize("n_q,n_kv,hd,ok", [
    *[(g * 2, 2, hd, True) for g in range(1, 9) for hd in (64, 128)],
    (128, 8, 128, False),          # Llama-3.1-405B: group 16
    (32, 2, 64, False),            # group 16
    (14, 2, 80, False),            # head_dim 80
])
def test_attention_shape_checked_at_start_up(n_q, n_kv, hd, ok):
    """LlamaModel refuses, before it serves on the card, an attention shape
    the kernels cannot take (``worker/model.py:check_attention_shape``,
    called beside ``check_quantized_widths``): a ValueError that names n_q,
    n_kv, head_dim and the group. Groups 1 to 8 at head_dim 64 and 128 pass.
    A tp shard's group is the model's (kv heads replicated up to tp)."""
    from swiftllm_tpu_torch.worker.model import check_attention_shape
    mc = LlamaModelConfig(num_layers=1, num_q_heads=n_q, num_kv_heads=n_kv,
                          hidden_size=64, head_dim=hd, ffn_inter_dim=64,
                          vocab_size=64, max_position_embeddings=64,
                          rms_norm_eps=1e-5)
    if ok:
        check_attention_shape(mc)
        check_attention_shape(mc, tp=2, num_kv_eff=n_kv)
        if n_q % 4 == 0:
            check_attention_shape(mc, tp=4, num_kv_eff=4)
        return
    group = n_q / n_kv
    with pytest.raises(ValueError, match=rf"n_q {n_q}, n_kv {n_kv}, head_dim {hd} "
                                         rf"\(GQA group {group:g}\)"):
        check_attention_shape(mc)


@pytest.mark.parametrize("bad", ["units", "max_keys", "n_sms", "splits"])
def test_plan_takes_ints_only(bad):
    """A tensor (a device value) never reaches the plan: it raises."""
    kw = dict(units=16, max_keys=2048, n_sms=132, tile=64, min_chunk=256,
              splits=None)
    kw[bad] = torch.tensor(4)
    with pytest.raises(TypeError, match="ints"):
        pa.split_plan(**kw)
