"""Weight-quantized serving in the PyTorch port against the JAX package, on
the CPU: the quantizers, ``proj``, the INT4 kernel's plain version, one
mixed step, a tiny HF checkpoint, and the engine.

Inputs come from numpy with a seed and go through both packages. Tolerances,
and why:
- quantized bytes and scales: equal, byte for byte (the same f32 arithmetic
  and round-half-to-even on both sides);
- ``proj`` in f32: atol/rtol 1e-5 (products of at most 64 terms, only the
  summation order differs); in bf16: rtol 2e-2 and atol 2e-2 of the output's
  std, since each side rounds every half-product to bf16 (2^-8 relative)
  before adding and scaling, and the sum of two rounded int4 halves can
  cancel to a value much smaller than either half;
- ``int4_proj_stacked_plain`` and ``int4_proj_split_plain`` against the JAX
  kernel in interpret mode, f32: rtol 1e-5, atol 1e-4 (sums of up to 1,280
  products of O(10), another order); the split plain version against the
  unsplit one: 1e-6 of the output's scale (the same f32 products, summed in
  another order);
- a step's logits atol/rtol 1e-4, its written cache rows atol 1e-5, greedy
  tokens and the feedback buffer exactly (as in tests/test_torch_llama.py);
- greedy tokens of a checkpoint and of the engine: exactly;
- the perplexity gate of tests/test_quant.py on the port, and the port's
  quantized perplexity against the JAX package's: rtol 1e-5.
"""

import asyncio

import numpy as np
import pytest

import tests.conftest  # noqa: F401  (forces the JAX CPU backend)

import jax
import jax.numpy as jnp
import torch

from swiftllm_tpu.config import EngineConfig as JaxEngineConfig
from swiftllm_tpu.config import LlamaModelConfig as JaxModelConfig
from swiftllm_tpu.ops.int4_matmul import int4_proj_stacked as jax_int4_proj_stacked
from swiftllm_tpu.server.engine import Engine as JaxEngine
from swiftllm_tpu.server.structs import RawRequest as JaxRawRequest
from swiftllm_tpu.worker import quant as jq
from swiftllm_tpu.worker.model import LlamaModel as JaxLlamaModel
from swiftllm_tpu_torch.config import EngineConfig, LlamaModelConfig
from swiftllm_tpu_torch.ops import build
from swiftllm_tpu_torch.ops import int4_matmul as im
from swiftllm_tpu_torch.server.engine import Engine
from swiftllm_tpu_torch.server.scheduler import ScheduledSeq
from swiftllm_tpu_torch.server.structs import RawRequest, Request
from swiftllm_tpu_torch.worker import quant as tq
from swiftllm_tpu_torch.worker.model import LlamaModel
from swiftllm_tpu_torch.worker.weights import GEMM_KEYS, params_from_numpy
from tests import test_torch_engine as te
from tests import test_torch_llama as tl
from tests.test_llama_golden import PROMPTS, make_model, run_ours, tiny_ckpt  # noqa: F401
from tests.test_quant import _perplexity as jax_perplexity
from tests.test_quant import real_tiny_ckpt  # noqa: F401
from tests.test_torch_model import run_port

QUANTS = ["int8", "int4"]
KEY = {"int8": "q", "int4": "q4"}


def weights(rng, *shape):
    w = rng.standard_normal(shape).astype(np.float32)
    w[..., 0, :] = 0.0            # an all-zero row: the 1e-12 scale floor
    w[..., 1, :3] = [3.5, -3.5, 0.5]   # ties that round half to even
    return w


def quantize_tree(tree: dict, quant: str) -> dict:
    """The projections and lm_head of an f32 tree, quantized by the JAX
    package's numpy quantizer."""
    tree = dict(tree, layers=dict(tree["layers"]))
    for k in GEMM_KEYS:
        tree["layers"][k] = jq.quantize_weight(tree["layers"][k], quant)
    tree["lm_head"] = jq.quantize_weight(tree["lm_head"], quant)
    return tree


def scaled_quantized_tree(mc: dict, ec: dict, quant: str, seed: int) -> dict:
    """tests/test_torch_llama.py's scaled dummy tree, quantized."""
    m = JaxLlamaModel(JaxEngineConfig(**ec), JaxModelConfig(**mc))
    m.load_weights()
    return quantize_tree(tl.scaled_params(m.params, np.random.default_rng(seed)),
                         quant)


def put_tree(params, tree):
    return jax.tree.map(lambda old, new: jax.device_put(new, old.sharding),
                        params, tree)


def assert_trees_equal(got: dict, want: dict, path=""):
    assert set(got) == set(want), path
    for k, w in want.items():
        if isinstance(w, dict):
            assert_trees_equal(got[k], w, f"{path}/{k}")
        else:
            g = got[k].numpy()
            w = np.asarray(w)
            assert g.dtype == w.dtype and g.shape == w.shape, f"{path}/{k}"
            assert g.tobytes() == w.tobytes(), f"{path}/{k} differs"


# --- (a) the quantizers -------------------------------------------------------

@pytest.mark.parametrize("quant", QUANTS)
def test_quantizers_byte_equal_jax(quant):
    w = weights(np.random.default_rng(0), 3, 24, 64)
    want = jq.quantize_weight(w, quant)
    want_jax = jax.tree.map(np.asarray, jq.quantize_weight_jax(jnp.asarray(w), quant))
    got_np = {"int8": tq.quantize_int8, "int4": tq.quantize_int4}[quant](w)
    got_t = tq.quantize_weight_torch(torch.from_numpy(w), quant)
    for k in (KEY[quant], "s"):
        assert want[k].tobytes() == want_jax[k].tobytes()
        assert got_np[k].dtype == want[k].dtype
        assert got_np[k].tobytes() == want[k].tobytes(), k
        assert got_t[k].numpy().tobytes() == want[k].tobytes(), k


def test_unpack_int4_matches_jax():
    q4 = jq.quantize_int4(weights(np.random.default_rng(1), 8, 32))["q4"]
    want = np.asarray(jq._unpack_int4(jnp.asarray(q4)))
    np.testing.assert_array_equal(tq._unpack_int4(torch.from_numpy(q4)).numpy(), want)
    assert tq.out_features({"q4": torch.from_numpy(q4)}) == 8
    assert tq.is_quantized({"q4": q4}) and not tq.is_quantized(torch.zeros(2))


# --- (b) proj -----------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quant", QUANTS)
def test_proj_matches_jax(quant, dtype):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((7, 64)).astype(np.float32)
    qw = jq.quantize_weight(weights(rng, 48, 64), quant)
    jd = getattr(jnp, dtype)
    want = np.asarray(jq.proj(jnp.asarray(x, jd), jax.tree.map(jnp.asarray, qw)),
                      np.float32)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = tq.proj(xt, {k: torch.from_numpy(v) for k, v in qw.items()})
    assert got.dtype == xt.dtype
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2 * want.std())


@pytest.mark.parametrize("quant", QUANTS)
def test_proj_chunks_output_rows(quant, monkeypatch):
    """Dequantizing the weight in blocks of output rows changes no value."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((5, 64)).astype(np.float32))
    qw = {k: torch.from_numpy(v) for k, v in
          jq.quantize_weight(weights(rng, 40, 64), quant).items()}
    whole = tq.proj(x, qw)
    monkeypatch.setattr(tq, "PROJ_CHUNK_ELEMS", 64 * 16)   # 16 rows a block
    assert torch.equal(tq.proj(x, qw), whole)


# --- (c) the INT4 kernel's plain version against the Pallas kernel ------------

@pytest.mark.parametrize("T,N,K", [(16, 256, 512), (8, 128, 256), (5, 256, 256),
                                   (64, 384, 768)])
def test_int4_plain_matches_pallas(T, N, K):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((T, K)).astype(np.float32)
    qw = jq.quantize_int4(rng.standard_normal((3, N, K)).astype(np.float32))
    for layer in (0, 2):
        want = np.asarray(jax_int4_proj_stacked(
            jnp.asarray(x), jnp.asarray(qw["q4"]), jnp.asarray(qw["s"]),
            jnp.int32(layer), interpret=True))
        got = im.int4_proj_stacked_plain(torch.from_numpy(x),
                                         torch.from_numpy(qw["q4"]),
                                         torch.from_numpy(qw["s"]), layer)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def test_int4_plain_is_split_half_not_interleaved():
    """The plain version reads the split-half layout: an interleaved unpack
    of the same bytes gives another product (the fault chip_smoke.py plants
    against the kernel)."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((4, 64)).astype(np.float32))
    w = rng.standard_normal((1, 32, 64)).astype(np.float32)
    qw = jq.quantize_int4(w)
    got = im.int4_proj_stacked_plain(x, torch.from_numpy(qw["q4"]),
                                     torch.from_numpy(qw["s"]), 0)
    deq = np.asarray(jq._unpack_int4(jnp.asarray(qw["q4"][0]))) * qw["s"][0][:, None]
    np.testing.assert_allclose(got.numpy(), x.numpy() @ deq.T, rtol=1e-5, atol=1e-4)
    lo, hi = tq.nibbles(torch.from_numpy(qw["q4"][0]))
    inter = torch.stack([lo, hi], dim=-1).reshape(32, 64).float()
    wrong = x @ (inter * torch.from_numpy(qw["s"][0])[:, None]).T
    assert (wrong - got).abs().max() > got.abs().median()


@pytest.mark.parametrize("T", [1, 16, 128, 256, 300, 512, 1024, 2048])
@pytest.mark.parametrize("N,K", [(4096, 4096), (1024, 4096), (14336, 4096),
                                 (4096, 14336)])
def test_split_k_fills_the_card(T, N, K):
    """At the 8B shapes, on cards of 132 and 114 SMs: every K chunk lies in
    exactly one split, no split is empty, the token tiles hold T, and there
    are enough units (tiles x token tiles x splits) for the SM count: 80% of
    it at N >= 4096, half of it at N = 1,024 (whose 8 tiles would need a
    merge of many partials to fill more; the plan weighs that). Above 256
    tokens, the wide configuration (``wide_fill_ok``)."""
    for n_sms in (132, 114):
        p = im.int4_plan(T, N, K, n_sms)
        if T > im.WIDE_ABOVE:
            assert wide_fill_ok(p, T, N, K, n_sms, halves=2)
            continue
        assert p.chunks == -(-(K // 2) // p.kc)
        owner = [c // p.per for c in range(p.chunks)]
        assert owner == sorted(owner) and set(owner) == set(range(p.splits))
        assert (p.splits - 1) * p.per < p.chunks <= p.splits * p.per
        assert p.nt in im.TOKEN_WIDTHS and p.t_tiles * p.nt >= T > (p.t_tiles - 1) * p.nt
        assert p.units == p.tiles * p.t_tiles * p.splits == p.tiles * p.t_tiles * len(set(owner))
        assert p.units >= (0.8 if N >= 4096 else 0.5) * n_sms
        assert p.grid == min(p.units, n_sms)


def test_int4_plan_takes_ints_and_forced_splits():
    """The plan reads no device value (ints only); a forced split count is
    made such that no split is empty; a forced token width is one of the
    kernel's."""
    with pytest.raises(TypeError, match="ints"):
        im.int4_plan(torch.tensor(16), 4096, 4096, 132)
    p = im.int4_plan(16, 4096, 4096, 132, splits=3)   # 16 chunks: 6, 6, 4
    assert (p.splits, p.per, p.chunks) == (3, 6, 16)
    p = im.int4_plan(16, 4096, 4096, 132, splits=100)
    assert (p.splits, p.per) == (p.chunks, 1)
    p = im.int4_plan(128, 4096, 4096, 132, 2, 64)    # token width forced
    assert (p.nt, p.t_tiles, p.kc, p.splits) == (64, 2, 128, 2)
    with pytest.raises(ValueError, match="token width"):
        im.int4_plan(128, 4096, 4096, 132, nt=48)


# (T, N, K, forced splits): token widths 16, 32, 64 and 128 (chunks of 128
# or 64 packed bytes), ragged N, K/2 off the chunk, a last split shorter
# than the others.
SPLIT_CASES = [(3, 200, 300, 2), (16, 256, 1280, 3), (37, 96, 1000, 4),
               (64, 128, 2304, 5), (128, 200, 1280, 4), (200, 64, 640, 3)]


@pytest.mark.parametrize("T,N,K,splits", SPLIT_CASES)
def test_int4_split_plain_matches_unsplit(T, N, K, splits):
    """Split-then-merge in f32 (the partials summed in split order, then the
    scale) against the unsplit plain version: only the order of the f32
    sums differs, so 1e-6 of the output's scale."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((T, K)).astype(np.float32))
    qw = jq.quantize_int4(rng.standard_normal((2, N, K)).astype(np.float32))
    q4, s = torch.from_numpy(qw["q4"]), torch.from_numpy(qw["s"])
    p = im.int4_plan(T, N, K, 132, splits)
    assert p.splits > 1
    parts = im.int4_split_partials(x, q4, 1, p)
    assert len(parts) == p.splits
    got = im.int4_proj_split_plain(x, q4, s, 1, p)
    want = im.int4_proj_stacked_plain(x, q4, s, 1)
    scale = float(want.abs().max())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6 * scale)
    # Leaving one split out moves the product far past that bound (the
    # fault chip_smoke.py plants against the kernel's merge).
    dropped = (sum(parts[1:]) * s[1]).numpy()
    assert np.abs(dropped - want.numpy()).max() > 1e-3 * scale


@pytest.mark.parametrize("T,N,K,splits", [(5, 256, 1280, 3), (40, 128, 1280, 2),
                                          (128, 128, 1280, 4)])
def test_int4_split_plain_matches_pallas(T, N, K, splits):
    """The split plain version against the JAX kernel in interpret mode, f32
    (as test_int4_plain_matches_pallas), where K/2 = 640 does not divide into
    the splits evenly: 5 chunks of 128 bytes as 2 + 2 + 1, or as 3 + 2; 10
    chunks of 64 bytes as 3 + 3 + 3 + 1."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((T, K)).astype(np.float32)
    qw = jq.quantize_int4(rng.standard_normal((3, N, K)).astype(np.float32))
    p = im.int4_plan(T, N, K, 132, splits)
    assert p.chunks % p.per != 0
    for layer in (0, 2):
        want = np.asarray(jax_int4_proj_stacked(
            jnp.asarray(x), jnp.asarray(qw["q4"]), jnp.asarray(qw["s"]),
            jnp.int32(layer), interpret=True))
        got = im.int4_proj_split_plain(torch.from_numpy(x),
                                       torch.from_numpy(qw["q4"]),
                                       torch.from_numpy(qw["s"]), layer, p)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def wide_covers_once(p, halves) -> bool:
    """A wide plan's work (``im.wide_work``, the kernel's walk) covers every
    chunk of every unit exactly once, both nibble halves; every segment of
    a cut unit (``im.wide_cut_units``) lies in one half, a cut unit's
    segments are its pieces cut again at the half boundary, and ``splits``
    is the most segments a cut unit has."""
    C, cph = p.chunks, p.chunks // halves
    seen = [0] * (p.units * C)
    pieces: dict[int, list] = {}
    for pair in im.wide_work(p):
        for u, c0, c1 in pair:
            for c in range(c0, c1):
                seen[u * C + c] += 1
            if c1 - c0 < C:
                pieces.setdefault(u, []).append((c0, c1))
    cut = im.wide_cut_units(p, halves)
    want = {u: sorted(seg for c0, c1 in ps for seg in (
        [(c0, cph), (cph, c1)] if halves == 2 and c0 < cph < c1 else [(c0, c1)]))
        for u, ps in pieces.items()}
    return (seen == [1] * (p.units * C) and cut == want
            and all(b <= cph or a >= cph for segs in cut.values() for a, b in segs)
            and p.splits == max(map(len, cut.values()), default=1))


def wide_plan_ok(p, T, N, K, n_sms, halves) -> bool:
    """The wide configuration's plan: 256-token tiles that hold T, chunks of
    64 bytes of each of ``halves`` passes, units of a pair of weight tiles
    and a token tile, an even grid of at most one block an SM, the whole
    units full waves of the pairs (or every unit), a stream-K part of at
    least WIDE_MIN_RANGE chunks a pair, balanced to a chunk, and every chunk
    covered once (``wide_covers_once``)."""
    cph = -(-(K // halves) // im.WIDE_KC)
    P = p.grid // im.CLUSTER
    starts = im.wide_starts(p)
    ranges = [b - a for a, b in zip(starts, starts[1:])]
    rest = (p.units - p.per) * p.chunks
    return (p.nt == im.WIDE_NT and p.kc == im.WIDE_KC
            and p.t_tiles * p.nt >= T > (p.t_tiles - 1) * p.nt
            and p.chunks == halves * cph and p.tiles == -(-N // im.BM)
            and p.units == -(-p.tiles // im.CLUSTER) * p.t_tiles
            and p.grid % im.CLUSTER == 0 and 1 <= P <= n_sms // im.CLUSTER
            and (p.per == p.units or p.per % P == 0)
            and (rest == 0 or min(ranges) >= im.WIDE_MIN_RANGE)
            and max(ranges) - min(ranges) <= 1
            and wide_covers_once(p, halves))


def wide_fill_ok(p, T, N, K, n_sms, halves) -> bool:
    """A wide plan as ``wide_plan_ok`` says, the least modelled time of the
    schedules its search weighs (``im.wide_plan``), whose pairs fill the
    card: on 132 SMs 80% of it at N >= 2,048 and 40% at N = 1,024 (4 pairs
    of tiles: more would need a merge of many 256-token partials); on 114
    SMs half of it. The plan walks every unit whole only where the model
    finds a stream-K part dearer (PERF.md §6: a partial costs more
    than the last wave's idle pairs at w_gate, T = 512)."""
    fill = (0.8 if N >= 2048 else 0.4) if n_sms == 132 else 0.5
    fit = n_sms // im.CLUSTER
    cands = [im.make_wide_plan(T, N, K, halves, P, w) for P in (fit, p.grid // im.CLUSTER)
             for w in {p.units, p.units // P * P, 0}
             if (p.units - w) * p.chunks >= im.WIDE_MIN_RANGE * P or w == p.units]
    us = im.wide_plan_us(p, n_sms, halves)
    return (wide_plan_ok(p, T, N, K, n_sms, halves)
            and all(us <= im.wide_plan_us(c, n_sms, halves) for c in cands)
            and p.grid >= fill * n_sms)


@pytest.mark.parametrize("T", [300, 512, 1024, 2048])
@pytest.mark.parametrize("N,K", [(4096, 2048), (4096, 7168), (2048, 4096),
                                 (7168, 4096), (128256, 4096)])
def test_wide_plan_fills_the_card_at_tp2_and_the_head(T, N, K):
    """The INT4 wide plans of the tp = 2 shards (in-sharded K of 2,048 and
    7,168, out-sharded N of 2,048 and 7,168) and of the head, as above."""
    for n_sms in (132, 114):
        assert wide_fill_ok(im.int4_plan(T, N, K, n_sms), T, N, K, n_sms, 2)


# --- (c2) the wide configuration's plain versions (T > 256) -------------------

# (T, N, K): a token tile of 256 and part of one, N off the 128-row tile,
# K/2 off the 64-byte chunk (and, at K = 272, off TMA's 16 bytes: the plain
# versions take it, the kernel's wrapper refuses it on the card).
WIDE_CASES = [(300, 200, 272), (512, 130, 1040), (300, 96, 2304)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,N,K", WIDE_CASES)
def test_int4_wide_plain_matches_jax_proj(T, N, K, dtype):
    """Above 256 tokens the INT4 kernel computes ``proj``'s arithmetic (two
    half products, each rounded, added and scaled in x's dtype): its plain
    version against the JAX package's ``quant.proj``, with test_proj_matches
    _jax's bounds (f32 atol/rtol 1e-5 of the largest output, as the sums run
    to 1,152 terms; bf16 rtol 2e-2, atol 2e-2 of the output's std), and
    bit for bit the port's ``proj``; the wrapper on CPU tensors is it."""
    rng = np.random.default_rng(T + N + K)
    x = rng.standard_normal((T, K)).astype(np.float32)
    qw = jq.quantize_int4(weights(rng, 3, N, K))
    q4, s = torch.from_numpy(qw["q4"]), torch.from_numpy(qw["s"])
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    jd = getattr(jnp, dtype)
    for layer in (0, 2):
        want = np.asarray(jq.proj(jnp.asarray(x, jd), {
            "q4": jnp.asarray(qw["q4"][layer]), "s": jnp.asarray(qw["s"][layer])}),
            np.float32)
        got = im.int4_proj_wide_plain(xt, q4, s, layer)
        assert got.dtype == xt.dtype and got.shape == (T, N)
        assert torch.equal(got, tq.proj(xt, {"q4": q4[layer], "s": s[layer]}))
        assert torch.equal(im.int4_proj_stacked(xt, q4, s, layer), got)
        got = got.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-5,
                                       atol=1e-5 * np.abs(want).max())
        else:
            np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2 * want.std())


@pytest.mark.parametrize("T,N,K,splits", [(300, 200, 1040, 2), (512, 96, 640, 4),
                                          (300, 130, 2304, 6), (512, 64, 1280, 1)])
def test_int4_wide_split_plain_matches_unsplit(T, N, K, splits):
    """The wide configuration's split-then-merge (each half's f32 partials
    summed in split order, then the roundings) against its unsplit plain
    version in f32: only the order of the f32 sums differs, so 1e-6 of the
    output's scale. Each split lies in one nibble half."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((T, K)).astype(np.float32))
    qw = jq.quantize_int4(rng.standard_normal((2, N, K)).astype(np.float32))
    q4, s = torch.from_numpy(qw["q4"]), torch.from_numpy(qw["s"])
    p = im.int4_plan(T, N, K, 132, splits)
    assert p.nt == im.WIDE_NT and wide_covers_once(p, 2)
    assert (p.splits == 1) == (splits == 1)
    got = im.int4_wide_split_plain(x, q4, s, 1, p)
    want = im.int4_proj_wide_plain(x, q4, s, 1)
    scale = float(want.abs().max())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6 * scale)
    # Leaving a segment of a cut unit out of the merge moves that unit's
    # outputs far past that bound (the fault chip_smoke.py plants against
    # the kernel's merge).
    if p.splits > 1:
        u = min(im.wide_cut_units(p, 2))
        dropped = im.int4_wide_split_plain(x, q4, s, 1, p, drop=(u, 1))
        assert np.abs(dropped.numpy() - want.numpy()).max() > 1e-3 * scale


# The wide schedule at every 8B shape, the tp = 2 shards and the head, for
# both formats (INT8: one pass; INT4: two nibble halves), on cards of 132
# and 114 SMs, as the plan chooses it and forced (1: every unit whole; 2,
# 3, 4: every unit cut, stream-K).
WORK_SHAPES = [(4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336),
               (4096, 2048), (2048, 4096), (128256, 4096)]


@pytest.mark.parametrize("splits", [None, 1, 2, 3, 4])
@pytest.mark.parametrize("halves", [1, 2])
@pytest.mark.parametrize("N,K", WORK_SHAPES)
def test_wide_work_covers_every_chunk_once(N, K, halves, splits):
    """Every chunk of both halves in exactly one piece, no segment across
    the nibble boundary, the stream-K ranges balanced to a chunk, ints only
    (``wide_covers_once``); a forced count of more than 1 cuts every unit
    into pieces of chunks / splits."""
    for T, n_sms in ((300, 132), (512, 114), (1024, 132), (2048, 114)):
        if N == 128256 and splits not in (None, 1):
            continue          # thousands of pairs: the head is never forced
        p = (im.int4_plan if halves == 2 else
             __import__("swiftllm_tpu_torch.ops.int8_matmul",
                        fromlist=["int8_plan"]).int8_plan)(T, N, K, n_sms, splits)
        assert all(type(v) is int for v in p)
        assert wide_covers_once(p, halves), (T, n_sms, p)
        if splits is None:
            assert wide_fill_ok(p, T, N, K, n_sms, halves), (T, n_sms, p)
        elif splits == 1:
            assert p.per == p.units and p.splits == 1
        else:
            # One more range where pieces of chunks / splits start inside a
            # unit, one more segment where a piece crosses the half boundary.
            assert p.per == 0 and splits <= p.splits <= splits + halves
            if p.chunks % splits == 0 and halves == 1:
                assert p.splits == splits


# The ragged T of chip_smoke.py's wide phase, beside WIDE_CASES.
WIDE_RAGGED = [(257, 200, 1040), (300, 96, 2304), (600, 130, 1040)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("splits", [None, 4])
@pytest.mark.parametrize("T,N,K", WIDE_CASES + WIDE_RAGGED)
def test_int4_wide_split_plain_matches_jax_proj(T, N, K, splits, dtype):
    """The wide configuration's split-then-merge as its plan (or 4 splits
    forced) takes it, against the JAX package's ``quant.proj``, with
    test_int4_wide_plain_matches_jax_proj's bounds."""
    rng = np.random.default_rng(T + N + K + 1)
    x = rng.standard_normal((T, K)).astype(np.float32)
    qw = jq.quantize_int4(weights(rng, 2, N, K))
    q4, s = torch.from_numpy(qw["q4"]), torch.from_numpy(qw["s"])
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    p = im.int4_plan(T, N, K, 132, splits)
    want = np.asarray(jq.proj(jnp.asarray(x, getattr(jnp, dtype)), {
        "q4": jnp.asarray(qw["q4"][1]), "s": jnp.asarray(qw["s"][1])}), np.float32)
    got = im.int4_wide_split_plain(xt, q4, s, 1, p)
    assert got.dtype == xt.dtype and got.shape == (T, N)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2 * want.std())


def test_int4_wide_rounds_each_half():
    """On integer inputs every f32 sum is exact, so the wide configuration's
    plain versions agree bit for bit in bf16, and differ from the narrow
    configuration's single rounding of both halves' sum (the fault
    chip_smoke.py plants against the kernel, where it holds the kernel to
    the same bits)."""
    rng = np.random.default_rng(10)
    T, N, K = 300, 64, 1024
    x = torch.from_numpy(rng.integers(-4, 5, (T, K)).astype(np.float32)
                         ).to(torch.bfloat16)
    q4 = torch.from_numpy(rng.integers(-128, 128, (1, N, K // 2)).astype(np.int8))
    s = torch.full((1, N), 2.0 ** -10)
    want = im.int4_proj_wide_plain(x, q4, s, 0)
    for splits in (1, 2, 4):
        got = im.int4_wide_split_plain(x, q4, s, 0, im.int4_plan(T, N, K, 132, splits))
        assert torch.equal(got, want)
    single = im.int4_proj_stacked_plain(x, q4, s, 0)
    assert (single != want).float().mean() > 0.05


# --- (g) the wrapper ----------------------------------------------------------

def test_int4_wrapper_cpu_plain_and_device_rules():
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((3, 32)).astype(np.float32))
    qw = jq.quantize_int4(rng.standard_normal((2, 16, 32)).astype(np.float32))
    q4, s = torch.from_numpy(qw["q4"]), torch.from_numpy(qw["s"])
    build.reset_launch_counts()
    got = im.int4_proj_stacked(x, q4, s, 1)
    assert torch.equal(got, im.int4_proj_stacked_plain(x, q4, s, 1))
    xw = x.repeat(100, 1)                                         # T = 300
    assert torch.equal(im.int4_proj_stacked(xw, q4, s, 1),
                       im.int4_proj_wide_plain(xw, q4, s, 1))
    assert torch.equal(im.int4_proj_stacked(x, q4, s, 1, nt=im.WIDE_NT),
                       im.int4_proj_wide_plain(x, q4, s, 1))
    assert build.launch_counts["int4_matmul"] == 0
    with pytest.raises(ValueError, match="all-CPU or all-CUDA"):
        im.int4_proj_stacked(x.to("meta"), q4, s, 1)


def test_int4_wrapper_device_rules(monkeypatch):
    """On the card (simulated: the device test and the launch stubbed) the
    wrapper refuses what the kernel does not take (wrong types, T = 0, odd
    K, K/2 off TMA's 16 bytes above 256 tokens) and launches with its
    plan's ints, the wide configuration's above 256 tokens."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32))
    qw = jq.quantize_int4(rng.standard_normal((2, 16, 64)).astype(np.float32))
    q4, s = torch.from_numpy(qw["q4"]), torch.from_numpy(qw["s"])
    launched = []
    monkeypatch.setattr(build, "on_cpu", lambda *a: False)
    monkeypatch.setattr(build, "sm_count", lambda device: 132)
    monkeypatch.setattr(build, "launch", lambda name, dev, *a: launched.append(a))
    xb = x.to(torch.bfloat16)
    with pytest.raises(TypeError, match="bf16 x"):
        im.int4_proj_stacked(x, q4, s, 1)
    with pytest.raises(TypeError, match="int8 q4"):
        im.int4_proj_stacked(xb, q4.to(torch.uint8), s, 1)
    with pytest.raises(TypeError, match="f32 s"):
        im.int4_proj_stacked(xb, q4, s.double(), 1)
    x24 = xb[:, :48].repeat(100, 1)                   # T = 300, K/2 = 24
    for bad in ((xb[:0], q4, s, 1), (xb[:, :63], q4, s, 1), (xb, q4, s, 2),
                (x24, q4[:, :, :24], s, 1)):
        with pytest.raises(ValueError, match="int4_matmul shapes"):
            im.int4_proj_stacked(*bad)
    assert not launched
    im.int4_proj_stacked(xb[:, :48], q4[:, :, :24], s, 1)    # narrow: any even K
    for T in (3, 300, 2048):
        y = im.int4_proj_stacked(xb[:1].repeat(T, 1), q4, s, 1)
        p = im.int4_plan(T, 16, 64, 132)
        assert y.shape == (T, 16) and y.dtype == torch.bfloat16
        assert launched[-1][6:] == (T, 16, 64, 2, 1, p.nt, p.t_tiles, p.splits,
                                    p.per, p.grid)
        assert (p.nt == im.WIDE_NT) == (T > im.WIDE_ABOVE)


# --- (d) one mixed step -------------------------------------------------------

@pytest.fixture(scope="module", params=QUANTS)
def jax_quant_step(request):
    quant = request.param
    tree = scaled_quantized_tree(tl.MC, tl.EC, quant, seed=0)
    rng = np.random.default_rng(1)
    m = JaxLlamaModel(JaxEngineConfig(**dict(tl.EC, quant=quant)),
                      JaxModelConfig(**tl.MC))
    m.load_weights()
    m.init_kvcache_and_swap()
    m.params = put_tree(m.params, tree)
    cache = rng.normal(size=m.kv_cache.shape).astype(np.float32)
    feedback = rng.integers(0, 128, size=m.token_feedback.shape).astype(np.int32)
    m.kv_cache = jax.device_put(cache, m.kv_cache.sharding)
    m.token_feedback = jax.device_put(feedback, m.token_feedback.sharding)
    tl.preallocate(m.hbm_block_mgrs[0])
    tokens, rows, logits = m.forward(tl.schedule("jax"), return_logits=True)
    return dict(quant=quant, tree=tree, cache=cache, feedback=feedback,
                tokens=tokens, logits=logits, rows=[r is not None for r in rows],
                cache_after=np.asarray(m.kv_cache),
                feedback_after=np.asarray(m.token_feedback))


@pytest.mark.parametrize("use_kernels", [True, False],
                         ids=["kernel_plain", "gather_reference"])
def test_quantized_mixed_step_matches_jax(jax_quant_step, use_kernels):
    ref = jax_quant_step
    m = LlamaModel(EngineConfig(**dict(tl.EC, quant=ref["quant"],
                                       use_pallas=use_kernels)),
                   LlamaModelConfig(**tl.MC), device="cpu")
    m.params = params_from_numpy(ref["tree"], "cpu")
    assert m.params["layers"]["wq"][KEY[ref["quant"]]].dtype == torch.int8
    m.init_kvcache_and_swap()
    m.kv_cache.copy_(torch.from_numpy(ref["cache"]))
    m.token_feedback.copy_(torch.from_numpy(ref["feedback"]))
    tl.preallocate(m.hbm_block_mgrs[0])
    tokens, rows, logits = m.forward(tl.schedule("torch"), return_logits=True)

    live = np.asarray(ref["rows"])
    assert [r is not None for r in rows] == ref["rows"]
    np.testing.assert_allclose(logits[live], ref["logits"][live],
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(tokens[live], ref["tokens"][live])
    np.testing.assert_array_equal(m.token_feedback.numpy()[:-1],
                                  ref["feedback_after"][:-1])
    ps = tl.EC["block_size"]
    np.testing.assert_allclose(m.kv_cache.numpy()[:, :-ps],
                               ref["cache_after"][:, :-ps], atol=1e-5, rtol=0)


# --- (e) a tiny HF checkpoint -------------------------------------------------

def port_ckpt_model(path, quant, use_pallas=True):
    ec = EngineConfig(model_path=path, dtype="float32", block_size=4,
                      max_blocks_per_seq=16, max_tokens_in_batch=64,
                      num_hbm_blocks=32, prefill_chunk_size=8, quant=quant,
                      preemption_mode="recompute", use_pallas=use_pallas)
    m = LlamaModel(ec, device="cpu")
    m.load_weights()
    m.init_kvcache_and_swap()
    return m


@pytest.mark.parametrize("quant", QUANTS)
def test_checkpoint_tree_byte_equal_jax(tiny_ckpt, quant):  # noqa: F811
    path, _, cfg = tiny_ckpt
    assert not cfg.tie_word_embeddings     # so lm_head is quantized too
    want = jax.tree.map(np.asarray, jax.device_get(
        make_model(path, quant=quant).params))
    got = port_ckpt_model(path, quant).params
    assert tq.is_quantized(got["lm_head"])
    assert_trees_equal(got, want)


@pytest.fixture(scope="module")
def jax_int4_tokens(tiny_ckpt):  # noqa: F811
    path = tiny_ckpt[0]
    return {"whole": run_ours(make_model(path, quant="int4"), PROMPTS, 6),
            "chunked": run_ours(make_model(path, quant="int4"), PROMPTS, 6,
                                chunked=True, chunk=4)}


@pytest.mark.parametrize("mode", ["whole", "chunked"])
@pytest.mark.parametrize("use_pallas", [True, False],
                         ids=["kernel_plain", "gather_reference"])
def test_checkpoint_int4_greedy_matches_jax(tiny_ckpt, jax_int4_tokens, mode,  # noqa: F811
                                            use_pallas):
    got = run_port(port_ckpt_model(tiny_ckpt[0], "int4", use_pallas), PROMPTS,
                   6, chunked=mode == "chunked", chunk=4)
    assert got == jax_int4_tokens[mode]


# --- (f) the engine -----------------------------------------------------------

def test_engine_int4_tokens_match_jax():
    ec = dict(te.EC, quant="int4")
    tree = scaled_quantized_tree(te.MC, te.EC, "int4", seed=1)

    async def jax_body():
        e = JaxEngine(JaxEngineConfig(**ec), JaxModelConfig(**te.MC))
        await e.initialize(tokenizer_backend="inline")
        e.model.params = put_tree(e.model.params, tree)
        return await te.serve(e, JaxRawRequest)

    async def port_body():
        e = Engine(EngineConfig(**dict(ec, use_pallas=True)),
                   LlamaModelConfig(**te.MC), device="cpu")
        await e.initialize(tokenizer_backend="inline")
        e.model.params = params_from_numpy(tree, "cpu")
        free0 = e.model.hbm_block_mgrs[0].num_free_blocks
        got = await te.serve(e, RawRequest)
        return got, free0, e.model.hbm_block_mgrs[0].num_free_blocks

    want = asyncio.run(jax_body())
    got, free0, free1 = asyncio.run(port_body())
    assert got == want
    assert all(len(t) == te.OUT_LEN for t in got)
    assert free1 == free0 == te.EC["num_hbm_blocks"]


# --- the perplexity gate of tests/test_quant.py -------------------------------

def port_perplexity(path, quant, token_ids):
    """tests/test_quant.py's stepwise next-token perplexity, on the port
    (its kernel path: the INT4 kernel's plain version on the CPU)."""
    ec = EngineConfig(model_path=path, dtype="float32", quant=quant,
                      block_size=4, num_hbm_blocks=64, max_blocks_per_seq=32,
                      max_tokens_in_batch=64, prefill_chunk_size=16,
                      max_seqs_in_block_table=8, preemption_mode="recompute")
    model = LlamaModel(ec, device="cpu")
    model.load_weights()
    model.init_kvcache_and_swap()
    r = Request(RawRequest("", 1))
    r.set_prompt_token_ids(token_ids[:1])
    r.seq_id = 0
    nll = 0.0
    for t in range(1, len(token_ids)):
        _, _, logits = model.forward([ScheduledSeq(r, 1)], return_logits=True)
        lg = logits[0].astype(np.float64)
        nll -= lg[token_ids[t]] - lg.max() - np.log(np.exp(lg - lg.max()).sum())
        r.output_token_ids.append(token_ids[t])
        r.num_cached_tokens += 1
    return float(np.exp(nll / (len(token_ids) - 1)))


@pytest.mark.parametrize("quant,max_rel", [("int8", 0.001), ("int4", 0.01)])
def test_quant_perplexity_gate(real_tiny_ckpt, quant, max_rel):  # noqa: F811
    """The JAX package's gate (quantization costs under 0.1% of perplexity
    in INT8, 1% in INT4, on a random-init tiny checkpoint), on the port; and
    the port's quantized perplexity equals the JAX package's within rtol
    1e-5 (f32 sums in another order)."""
    tokens = np.random.default_rng(0).integers(0, 128, 48).tolist()
    base = port_perplexity(real_tiny_ckpt, "none", tokens)
    q = port_perplexity(real_tiny_ckpt, quant, tokens)
    assert abs(q - base) / base < max_rel, f"{quant}: ppl {base} -> {q}"
    np.testing.assert_allclose(q, jax_perplexity(real_tiny_ckpt, quant, tokens),
                               rtol=1e-5)
