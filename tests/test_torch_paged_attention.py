"""The port's paged attention (plain versions of the CUDA kernels, and the
gather-based reference) against the JAX package's, on the same numpy inputs.

On the CPU every wrapper of ``swiftllm_tpu_torch.ops.paged_attention`` runs
its plain version, so these tests hold that plain version, with its cache
writes, to the JAX Pallas kernels (interpret mode) and to the JAX gather
reference. The CUDA kernels themselves are held to the plain versions on the
card by ``chip_smoke.py``.

Tolerance: outputs at valid tokens within f32 atol 2e-5 / rtol 1e-4, the JAX
file's own interpret tolerance (both sides compute in f32; only summation
order differs). Caches after the writes: exactly equal, the garbage page
excluded (pad tokens write there in an unspecified order).
"""

import functools

import numpy as np
import pytest

import tests.conftest  # noqa: F401  (forces the JAX CPU backend)

import jax
import jax.numpy as jnp
import ml_dtypes
import torch

from swiftllm_tpu.models.llama import StepBatch as JaxStepBatch
from swiftllm_tpu.models.llama import _attention_and_store as jax_attention_and_store
from swiftllm_tpu_torch.models.llama import StepBatch
from swiftllm_tpu_torch.models.llama import _attention_and_store
from swiftllm_tpu_torch.ops import paged_attention as pa
from swiftllm_tpu_torch.utils import cdiv, next_power_of_2, tile_q_for

ATOL, RTOL = 2e-5, 1e-4
LAYER = 1


def make_case(rng, seq_specs, *, n_q=4, n_kv=2, hd=32, page_size=8, Pg=8,
              q_bucket=None):
    """seq_specs: (q_len, seq_len) per row, decode rows (q_len 1) first.
    Lays tokens out as the batch builder does: decode rows packed densely
    (flat token b == row b), then tile-aligned prefill spans. Rows get
    non-overlapping pages from a random permutation of the pool; the last
    page of S is the garbage page. Returns numpy arrays."""
    n = len(seq_specs)
    q_bucket = q_bucket or next_power_of_2(max(q for q, _ in seq_specs))
    align = tile_q_for(q_bucket)
    B = next_power_of_2(n)
    W = 2 * n_kv * hd
    num_pages = B * Pg
    S = (num_pages + 1) * page_size
    garbage = S - page_size

    q_starts = np.full(B, 0, np.int32)
    cursor = 0
    for b, (ql, _) in enumerate(seq_specs):
        if ql > 1 and (b == 0 or seq_specs[b - 1][0] == 1):
            cursor = cdiv(cursor, align) * align
        q_starts[b] = cursor
        cursor += ql if ql == 1 else cdiv(ql, align) * align
    T = max(next_power_of_2(cursor), align, B)
    q_starts[n:] = T

    q_lens = np.zeros(B, np.int32)
    seq_lens = np.zeros(B, np.int32)
    page_table = np.zeros((B, Pg), np.int32)
    positions = np.zeros(T, np.int32)
    kv_slots = np.full(T, garbage, np.int32)
    kv_slots_scatter = np.full(T, garbage, np.int32)
    decode_row = np.zeros(B, bool)
    perm = rng.permutation(num_pages)
    used = 0
    for b, (ql, sl) in enumerate(seq_specs):
        npages = cdiv(sl, page_size)
        page_table[b, :npages] = perm[used:used + npages]
        used += npages
        q_lens[b], seq_lens[b] = ql, sl
        decode_row[b] = ql == 1
        for i in range(ql):
            pos = sl - ql + i
            t = q_starts[b] + i
            positions[t] = pos
            kv_slots[t] = page_table[b, pos // page_size] * page_size + pos % page_size
            if ql > 1:
                kv_slots_scatter[t] = kv_slots[t]
    cache_l = rng.normal(size=(S, W)).astype(np.float32)
    # Three layers (zeros, the case, ones): LAYER = 1 exercises the offset.
    cache = np.stack([np.zeros_like(cache_l), cache_l, np.ones_like(cache_l)])
    return dict(
        q=rng.normal(size=(T, n_q, hd)).astype(np.float32), cache=cache,
        kv_new=rng.normal(size=(T, W)).astype(np.float32),
        positions=positions, kv_slots=kv_slots, q_starts=q_starts,
        q_lens=q_lens, seq_lens=seq_lens, page_table=page_table,
        decode_row=decode_row, kv_slots_scatter=kv_slots_scatter,
        q_bucket=q_bucket, page_size=page_size, n_kv=n_kv,
        sm_scale=1.0 / np.sqrt(hd))


BATCH_FIELDS = ("positions", "kv_slots", "q_starts", "q_lens", "seq_lens",
                "page_table", "decode_row", "kv_slots_scatter")


def fp8_to_torch(a) -> torch.Tensor:
    """An fp8 array of the JAX side (a JAX array or an ml_dtypes ndarray) as a
    ``torch.float8_e4m3fn`` tensor with the same bytes. numpy has no e4m3 of
    its own, so the bytes go over as uint8."""
    return torch.from_numpy(
        np.asarray(a).view(np.uint8).copy()).view(torch.float8_e4m3fn)


def fp8_to_numpy(t: torch.Tensor) -> np.ndarray:
    """The way back: the tensor's bytes as an ml_dtypes e4m3 ndarray."""
    return t.view(torch.uint8).numpy().view(ml_dtypes.float8_e4m3fn)


def _to_torch(a):
    return fp8_to_torch(a) if a.dtype == ml_dtypes.float8_e4m3fn else torch.from_numpy(a.copy())


def _to_numpy(t):
    return fp8_to_numpy(t) if t.dtype == torch.float8_e4m3fn else t.numpy()


def run_torch(case, use_kernels, window=0):
    batch = StepBatch(token_ids=torch.zeros(len(case["positions"]), dtype=torch.int32),
                      sample_mask=torch.zeros(len(case["q_lens"]), dtype=torch.bool),
                      **{f: torch.from_numpy(case[f]) for f in BATCH_FIELDS})
    cache = _to_torch(case["cache"])
    out = _attention_and_store(
        torch.from_numpy(case["q"]), _to_torch(case["kv_new"]), cache,
        LAYER, batch, n_kv=case["n_kv"], page_size=case["page_size"],
        sm_scale=case["sm_scale"], use_kernels=use_kernels,
        q_bucket=case["q_bucket"], window=window)
    return out.numpy(), _to_numpy(cache)


def run_jax(case, use_pallas, monkeypatch, window=0):
    monkeypatch.setenv("SWIFTLLM_PALLAS_INTERPRET", "1")
    batch = JaxStepBatch(token_ids=jnp.zeros(len(case["positions"]), jnp.int32),
                         sample_mask=jnp.zeros(len(case["q_lens"]), bool),
                         **{f: jnp.asarray(case[f]) for f in BATCH_FIELDS})
    ps, qb = case["page_size"], case["q_bucket"]
    fn = jax.jit(functools.partial(
        jax_attention_and_store, n_kv=case["n_kv"], page_size=ps,
        sm_scale=float(case["sm_scale"]), use_pallas=use_pallas, q_bucket=qb,
        window=window, fused_tile=use_pallas and qb > 1 and qb % ps == 0))
    out, cache = fn(jnp.asarray(case["q"]), jnp.asarray(case["kv_new"]),
                    jnp.asarray(case["cache"]), jnp.int32(LAYER), batch)
    return np.asarray(out), np.asarray(cache)


def assert_match(case, got, want, atol=ATOL, rtol=RTOL):
    """Outputs at valid tokens within the tolerance; caches equal (byte for
    byte when fp8), the garbage page excluded."""
    (o1, c1), (o2, c2) = got, want
    for b in range(len(case["q_lens"])):
        ql = int(case["q_lens"][b])
        if ql == 0:
            continue
        sl = slice(int(case["q_starts"][b]), int(case["q_starts"][b]) + ql)
        np.testing.assert_allclose(o1[sl], o2[sl], atol=atol, rtol=rtol,
                                   err_msg=f"row {b} (q_len={ql})")
    ps = case["page_size"]
    if c1.dtype == ml_dtypes.float8_e4m3fn:
        c1, c2 = c1.view(np.uint8), c2.view(np.uint8)
    np.testing.assert_array_equal(c1[:, :-ps], c2[:, :-ps])


CASES = {
    "decode_only": ([(1, 1), (1, 9), (1, 17), (1, 64), (1, 23)], {}),
    "single_prefill": ([(12, 12)], {}),
    "chunked_prefill_tail": ([(8, 40), (4, 20)], {}),
    "mixed": ([(1, 33), (1, 7), (1, 64), (1, 1), (16, 16), (5, 29)], {}),
    "gqa": ([(1, 50), (7, 31)], dict(n_q=8, n_kv=2)),
    "mha": ([(1, 26), (3, 11)], dict(n_q=4, n_kv=4)),
    "full_page_write": ([(16, 16), (8, 40)], {}),
    "ragged_tail_write": ([(12, 12), (5, 21), (9, 33)], {}),
}


@pytest.mark.parametrize("name", list(CASES))
def test_matches_jax_reference(name, monkeypatch):
    """Both port paths (the kernels' plain versions, and the gather
    reference) against the JAX gather reference (scatter, then attend)."""
    specs, kw = CASES[name]
    case = make_case(np.random.default_rng(list(CASES).index(name)), specs, **kw)
    want = run_jax(case, False, monkeypatch)
    for use_kernels in (True, False):
        assert_match(case, run_torch(case, use_kernels), want)


def test_matches_pallas_interpret(monkeypatch):
    """The kernels' plain versions against the JAX Pallas kernels themselves
    (interpret mode) in a mixed step: the decode kernel with its fused write,
    then the tile kernel with its fused span write (one full page, one
    ragged tail)."""
    case = make_case(np.random.default_rng(7), [(1, 33), (1, 7), (16, 16), (5, 29)])
    assert_match(case, run_torch(case, True), run_jax(case, True, monkeypatch))


def test_wrappers_write_in_place_and_zero_other_tokens():
    """Direct wrapper calls: the decode wrapper writes only valid rows' slots
    and returns zeros for the other tokens; store_kv drops out-of-range slots."""
    case = make_case(np.random.default_rng(3), [(1, 9), (1, 3)])
    cache = torch.from_numpy(case["cache"].copy())
    t = {k: torch.from_numpy(case[k]) for k in
         ("q", "kv_new", "page_table", "q_lens", "seq_lens", "kv_slots")}
    out = pa.paged_decode_attention(
        t["q"], cache, t["kv_new"], t["page_table"], t["q_lens"],
        t["seq_lens"], t["kv_slots"], LAYER, n_kv=case["n_kv"],
        page_size=case["page_size"], sm_scale=case["sm_scale"])
    assert torch.equal(out[2:], torch.zeros_like(out[2:]))
    for b in range(2):
        assert torch.equal(cache[LAYER, int(t["kv_slots"][b])], t["kv_new"][b])
    before = cache.clone()
    bad = torch.tensor([-1, cache.shape[1]], dtype=torch.int32)
    pa.store_kv(cache, t["kv_new"][:2], bad, LAYER)
    assert torch.equal(cache, before)
