"""The INT8 weight kernel of the PyTorch port (``ops/int8_matmul.py``) and the
quantized heads' route, on the CPU, against the JAX package.

The kernel runs only on the card (``chip_smoke.py`` holds it against its
plain version there); here the wrapper takes its plain version, and these
tests hold that, the plan and the model's dispatch. Inputs come from numpy
with a seed. Tolerances, and why:
- the plain version against the JAX package's ``quant.proj`` (INT8) in
  f32: rtol 1e-5 and atol 1e-5 of the output's largest magnitude (sums of
  up to 4,096 products of O(100) in another order, whose rounding errors
  scale with the sum's terms, not with an output that cancels to near 0);
  in bf16: rtol 1e-2 and atol 1e-2 of the output's std,
  since both round the product and then the scaled product to bf16 (2^-8
  relative each), from f32 sums taken in another order, so a value may
  land one or two bf16 steps away;
- the split plain version against the unsplit one: 1e-6 of the output's
  scale (the same f32 products, summed in another order);
- the INT4 head through the INT4 kernel's plain version against the JAX
  package's ``proj`` head in bf16: rtol 2e-2 and atol 2e-2 of the logits'
  std. ``proj`` rounds each half-product to bf16 and adds them in bf16,
  where the kernel sums both halves in f32 and rounds once; the halves can
  cancel to a logit much smaller than either, so the bound is on the
  logits' scale, not each logit's (the bound of tests/test_torch_quant.py's
  ``proj`` test in bf16, for the same reason). Greedy tokens: equal.
"""

import numpy as np
import pytest

import tests.conftest  # noqa: F401  (forces the JAX CPU backend)

import jax
import jax.numpy as jnp
import torch

from swiftllm_tpu.worker import quant as jq
from swiftllm_tpu_torch.config import EngineConfig, LlamaModelConfig
from swiftllm_tpu_torch.models import llama
from swiftllm_tpu_torch.ops import build
from swiftllm_tpu_torch.ops import int4_matmul as im4
from swiftllm_tpu_torch.ops import int8_matmul as im8
from swiftllm_tpu_torch.server.scheduler import ScheduledSeq
from swiftllm_tpu_torch.server.structs import RawRequest, Request
from swiftllm_tpu_torch.worker.model import LlamaModel
from tests import test_torch_llama as tl


def stack(rng, L, N, K):
    """L layers of N(0, 1) weights quantized by the JAX package's numpy
    quantizer, with an all-zero row (the 1e-12 scale floor) and ties."""
    w = rng.standard_normal((L, N, K)).astype(np.float32)
    w[:, 0, :] = 0.0
    w[:, 1, :3] = [3.5, -3.5, 0.5]
    qw = jq.quantize_int8(w)
    return torch.from_numpy(qw["q"]), torch.from_numpy(qw["s"]), qw


# (T, N, K): token tiles of 16 to 128 and two of 128, N off the 128-row
# tile, K off the 128-byte chunk; above 256 tokens (the wide configuration,
# same rounding points) a token tile of 256 and a part of one, N and K off
# the tile and the 64-byte chunk.
CASES = [(1, 128, 256), (16, 200, 512), (37, 96, 1040), (128, 384, 256),
         (256, 130, 4096), (300, 200, 272), (512, 130, 1040)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,N,K", CASES)
def test_int8_plain_matches_jax_proj(T, N, K, dtype):
    rng = np.random.default_rng(T * 7 + N)
    q, s, qw = stack(rng, 3, N, K)
    x = rng.standard_normal((T, K)).astype(np.float32)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    jd = getattr(jnp, dtype)
    for layer in (0, 2):
        want = np.asarray(jq.proj(jnp.asarray(x, jd), {
            "q": jnp.asarray(qw["q"][layer]), "s": jnp.asarray(qw["s"][layer])}),
            np.float32)
        got = im8.int8_proj_stacked_plain(xt, q, s, layer)
        assert got.dtype == xt.dtype and got.shape == (T, N)
        got = got.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-5,
                                       atol=1e-5 * np.abs(want).max())
        else:
            np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2 * want.std())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_plain_is_port_proj(dtype):
    """For an INT8 weight the plain version computes what the port's
    ``quant.proj`` computes, bit for bit (the same product and roundings)."""
    from swiftllm_tpu_torch.worker import quant as tq
    rng = np.random.default_rng(1)
    q, s, _ = stack(rng, 2, 72, 160)
    x = torch.from_numpy(rng.standard_normal((9, 160)).astype(np.float32)
                         ).to(getattr(torch, dtype))
    got = im8.int8_proj_stacked_plain(x, q, s, 1)
    want = tq.proj(x, {"q": q[1], "s": s[1]})
    if dtype == "float32":
        assert torch.equal(got, want)
    else:    # the product in bf16 on the CPU may round its f32 sum otherwise
        torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                                   atol=1e-2 * want.float().std().item())


# (T, N, K, forced splits): ragged N, K off the chunk, a last split shorter
# than the others, every token width (256: the wide configuration's chunks
# of 64 bytes).
SPLIT_CASES = [(3, 200, 400, 2), (16, 256, 1280, 3), (37, 96, 1040, 4),
               (64, 128, 2304, 5), (128, 200, 1280, 4), (200, 64, 640, 3),
               (300, 200, 1040, 3), (512, 96, 640, 4)]


@pytest.mark.parametrize("T,N,K,splits", SPLIT_CASES)
def test_int8_split_plain_matches_unsplit(T, N, K, splits):
    """Split-then-merge in f32 (the partials summed in split order, then the
    roundings and the scale) against the unsplit plain version, f32."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((T, K)).astype(np.float32))
    q, s, _ = stack(rng, 2, N, K)
    p = im8.int8_plan(T, N, K, 132, splits)
    assert p.splits > 1 and p.kc == (im4.WIDE_KC if T > im4.WIDE_ABOVE else im8.KC)
    got = im8.int8_proj_split_plain(x, q, s, 1, p)
    want = im8.int8_proj_stacked_plain(x, q, s, 1)
    scale = float(want.abs().max())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6 * scale)
    # Leaving one split out (in the wide configuration a segment of a cut
    # unit) moves the product far past that bound (the fault chip_smoke.py
    # plants against the kernel's merge).
    if p.nt == im4.WIDE_NT:
        dropped = im8.int8_proj_split_plain(
            x, q, s, 1, p, drop=(min(im4.wide_cut_units(p, 1)), 1)).numpy()
    else:
        parts = im8.int8_split_partials(x, q, 1, p)
        assert len(parts) == p.splits
        dropped = (sum(parts[1:]) * s[1]).numpy()
    assert np.abs(dropped - want.numpy()).max() > 1e-3 * scale


@pytest.mark.parametrize("T", [1, 16, 128, 256, 300, 512, 1024, 2048])
@pytest.mark.parametrize("N,K", [(4096, 4096), (1024, 4096), (14336, 4096),
                                 (4096, 14336), (128256, 4096), (2048, 4096),
                                 (4096, 7168)])
def test_int8_plan_fills_the_card(T, N, K):
    """At the 8B shapes, the head and the tp = 2 shard widths, on cards of
    132 and 114 SMs: every K chunk lies in exactly one split, no split is
    empty, the token tiles hold T, and there are enough units for the SM
    count: 80% of it at N >= 4096, half of it below (above 256 tokens,
    the wide configuration's schedule, ``test_torch_quant.wide_fill_ok``:
    every chunk in one piece, its pairs filling the card)."""
    for n_sms in (132, 114):
        p = im8.int8_plan(T, N, K, n_sms)
        assert p.t_tiles * p.nt >= T > (p.t_tiles - 1) * p.nt
        if T <= im4.WIDE_ABOVE:
            owner = [c // p.per for c in range(p.chunks)]
            assert owner == sorted(owner) and set(owner) == set(range(p.splits))
            assert p.units == p.tiles * p.t_tiles * p.splits
            assert p.kc == im8.KC and p.chunks == -(-K // im8.KC)
            assert p.nt in im4.TOKEN_WIDTHS
            assert p.units >= (0.8 if N >= 4096 else 0.5) * n_sms
            assert p.grid == min(p.units, n_sms)
        else:
            from tests.test_torch_quant import wide_fill_ok
            assert wide_fill_ok(p, T, N, K, n_sms, halves=1)


# Every narrow plan (T <= 256), "token width/splits" at T = 1, 16, 37, 128,
# 200, 256: INT4's as the kernel chose it before the wide configuration
# existed (decode buckets keep their launches), INT8's as its model fitted to
# the redesigned kernel chooses them (int8_matmul.py's constants, from
# chip_smoke.py --sweep-int8).
NARROW_PLANS = {
    ("int4", 132): {(4096, 4096): "16/4 16/4 64/4 64/2 128/2 128/2",
                    (1024, 4096): "16/16 16/16 32/8 32/4 64/4 64/4",
                    (14336, 4096): "16/1 16/1 64/1 128/1 128/1 128/1",
                    (4096, 14336): "16/4 16/4 64/4 128/4 128/2 128/2",
                    (128256, 4096): "16/1 16/1 64/1 128/1 128/1 128/1",
                    (4096, 2048): "16/4 16/4 32/2 64/2 64/1 64/1",
                    (4096, 7168): "16/4 16/4 64/4 128/4 128/2 128/2"},
    ("int4", 114): {(4096, 4096): "16/3 16/3 64/3 128/3 128/3 128/3",
                    (1024, 4096): "16/8 16/8 16/4 32/3 32/2 64/3",
                    (14336, 4096): "16/1 16/1 64/1 128/1 128/1 128/1",
                    (4096, 14336): "16/7 16/7 64/7 128/3 128/5 128/5",
                    (128256, 4096): "16/1 16/1 64/1 128/1 128/1 128/1",
                    (4096, 2048): "16/3 16/3 64/3 128/3 128/1 128/1",
                    (4096, 7168): "16/3 16/3 64/3 128/3 128/3 128/3"},
    ("int8", 132): {(4096, 4096): "16/4 16/4 64/4 128/4 128/2 128/2",
                    (1024, 4096): "16/16 16/16 32/8 32/4 64/4 64/4",
                    (14336, 4096): "16/1 16/1 64/1 128/1 128/1 128/1",
                    (4096, 14336): "16/4 16/4 64/4 128/4 128/2 128/2",
                    (128256, 4096): "16/1 16/1 64/1 128/1 128/1 128/1",
                    (4096, 2048): "16/4 16/4 64/4 64/2 128/2 128/2",
                    (4096, 7168): "16/4 16/4 64/4 128/4 128/2 128/2"},
    ("int8", 114): {(4096, 4096): "16/3 16/3 64/3 128/3 128/3 128/3",
                    (1024, 4096): "16/11 16/11 32/7 64/7 64/3 64/3",
                    (14336, 4096): "16/1 16/1 64/1 128/1 128/1 128/1",
                    (4096, 14336): "16/7 16/7 64/7 128/7 128/5 128/5",
                    (128256, 4096): "16/1 16/1 64/1 128/1 128/1 128/1",
                    (4096, 2048): "16/3 16/3 64/3 128/3 128/1 128/1",
                    (4096, 7168): "16/3 16/3 64/3 128/3 128/3 128/3"},
}


@pytest.mark.parametrize("fmt,n_sms", list(NARROW_PLANS))
def test_narrow_plans_are_unchanged(fmt, n_sms):
    plan = im4.int4_plan if fmt == "int4" else im8.int8_plan
    for (N, K), want in NARROW_PLANS[(fmt, n_sms)].items():
        got = " ".join(f"{p.nt}/{p.splits}" for p in (
            plan(T, N, K, n_sms) for T in (1, 16, 37, 128, 200, 256)))
        assert got == want, (fmt, n_sms, N, K)


def test_int8_plan_takes_ints_and_forced_splits():
    with pytest.raises(TypeError, match="ints"):
        im8.int8_plan(torch.tensor(16), 4096, 4096, 132)
    p = im8.int8_plan(16, 4096, 4096, 132, splits=3)   # 32 chunks: 11, 11, 10
    assert (p.splits, p.per, p.chunks) == (3, 11, 32)
    p = im8.int8_plan(16, 4096, 4096, 132, splits=100)
    assert (p.splits, p.per) == (p.chunks, 1)
    p = im8.int8_plan(128, 4096, 4096, 132, 2, 64)     # token width forced
    assert (p.nt, p.t_tiles, p.kc, p.splits) == (64, 2, 128, 2)
    with pytest.raises(ValueError, match="token width"):
        im8.int8_plan(128, 4096, 4096, 132, nt=48)
    # The wide configuration: above 256 tokens, or forced at any T (3
    # splits: each of the 128 units' 64 chunks of 64 bytes cut into pieces of
    # 21 or 22, stream-K on 384 pairs, every unit cut, none whole); cached.
    p = im8.int8_plan(2048, 4096, 4096, 132, splits=3)
    assert (p.nt, p.t_tiles, p.kc, p.units, p.per, p.grid) == (256, 8, 64, 128, 0, 768)
    assert p.splits in (3, 4) and len(im4.wide_cut_units(p, 1)) == 128
    p = im8.int8_plan(128, 4096, 4096, 132, nt=256)
    assert (p.nt, p.t_tiles, p.kc) == (256, 1, 64)
    assert im8.int8_plan(1024, 4096, 4096, 132) is im8.int8_plan(1024, 4096, 4096, 132)
    with pytest.raises(TypeError, match="ints"):
        im8.int8_plan(torch.tensor(512), 4096, 4096, 132)


def test_int8_wrapper_cpu_plain_and_device_rules(monkeypatch):
    """On CPU tensors the wrapper is the plain version and launches nothing;
    tensors off the CPU and the card raise; on the card (simulated: the
    device test and the launch stubbed) it refuses what the kernel does not
    take and launches with its plan's ints."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((3, 32)).astype(np.float32))
    q, s, _ = stack(rng, 2, 16, 32)
    build.reset_launch_counts()
    got = im8.int8_proj_stacked(x, q, s, 1)
    assert torch.equal(got, im8.int8_proj_stacked_plain(x, q, s, 1))
    assert build.launch_counts["int8_matmul"] == 0
    with pytest.raises(ValueError, match="all-CPU or all-CUDA"):
        im8.int8_proj_stacked(x.to("meta"), q, s, 1)

    launched = []
    monkeypatch.setattr(build, "on_cpu", lambda *a: False)
    monkeypatch.setattr(build, "sm_count", lambda device: 132)
    monkeypatch.setattr(build, "launch", lambda name, dev, *a: launched.append(a))
    xb = x.to(torch.bfloat16)
    with pytest.raises(TypeError, match="bf16 x"):
        im8.int8_proj_stacked(x, q, s, 1)                       # f32 x
    with pytest.raises(TypeError, match="int8 q"):
        im8.int8_proj_stacked(xb, q.float(), s, 1)
    for bad in ((xb[:, :24], q[:, :, :24], s, 1),               # K off 16
                (xb, q[:, :, :16], s, 1),                        # K differs
                (xb[:0], q, s, 1),                               # T = 0
                (xb, q, s[:, :8], 1),                            # scales' shape
                (xb, q, s, 2)):                                  # layer
        with pytest.raises(ValueError, match="int8_matmul shapes"):
            im8.int8_proj_stacked(*bad)
    assert not launched
    y = im8.int8_proj_stacked(xb, q, s, 1)
    p = im8.int8_plan(3, 16, 32, 132)
    assert y.shape == (3, 16) and y.dtype == torch.bfloat16
    assert launched[0][6:] == (3, 16, 32, 2, 1, p.nt, p.t_tiles, p.splits,
                               p.per, p.grid)
    # More than 256 tokens: the wide configuration's plan, no refusal.
    y = im8.int8_proj_stacked(xb.repeat(100, 1), q, s, 1)        # T = 300
    p = im8.int8_plan(300, 16, 32, 132)
    assert y.shape == (300, 16) and p.nt == im4.WIDE_NT
    assert launched[1][6:] == (300, 16, 32, 2, 1, 256, 2, p.splits, p.per,
                               p.grid)


# The wide configuration's cases of CASES and the ragged T of
# chip_smoke.py's wide phase.
WIDE_SPLIT_CASES = [(300, 200, 272), (512, 130, 1040), (257, 200, 1040),
                    (600, 130, 1040)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("splits", [None, 4])
@pytest.mark.parametrize("T,N,K", WIDE_SPLIT_CASES)
def test_int8_wide_split_plain_matches_jax_proj(T, N, K, splits, dtype):
    """The wide configuration's split-then-merge as its plan (or 4 splits
    forced: every unit cut, stream-K) takes it, against the JAX package's
    ``quant.proj`` (INT8), with test_int8_plain_matches_jax_proj's bounds."""
    rng = np.random.default_rng(T * 7 + N + 1)
    q, s, qw = stack(rng, 2, N, K)
    x = rng.standard_normal((T, K)).astype(np.float32)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    p = im8.int8_plan(T, N, K, 132, splits)
    assert p.nt == im4.WIDE_NT and (splits is None or p.per == 0)
    want = np.asarray(jq.proj(jnp.asarray(x, getattr(jnp, dtype)), {
        "q": jnp.asarray(qw["q"][1]), "s": jnp.asarray(qw["s"][1])}), np.float32)
    got = im8.int8_proj_split_plain(xt, q, s, 1, p)
    assert got.dtype == xt.dtype and got.shape == (T, N)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2 * want.std())


def test_int4_head_through_the_kernel_matches_jax_proj():
    """The INT4 lm_head as the model now computes it (a one-layer stack
    through the INT4 kernel's plain version), in bf16, against the JAX
    package's ``proj`` head: logits within the stated bound, greedy tokens
    equal, on three seeds."""
    for seed in (0, 1, 2):
        rng = np.random.default_rng(seed)
        h = rng.standard_normal((8, 256)).astype(np.float32)
        qw = jq.quantize_int4((rng.standard_normal((512, 256)) * 0.05
                               ).astype(np.float32))
        want = np.asarray(jq.proj(jnp.asarray(h, jnp.bfloat16),
                                  jax.tree.map(jnp.asarray, qw)), np.float32)
        got = llama.quantized_proj(
            torch.from_numpy(h).to(torch.bfloat16),
            {k: torch.from_numpy(v)[None] for k, v in qw.items()}, 0).float().numpy()
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2 * want.std())
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


class Spy:
    """Counts the calls of the quantized kernels' wrappers and of
    ``quant.proj`` in the model, and the rows each was given."""

    def __init__(self, monkeypatch):
        self.calls = {"int8": [], "int4": [], "proj": []}
        for key, mod, name in (("int8", im8, "int8_proj_stacked"),
                               ("int4", im4, "int4_proj_stacked"),
                               ("proj", llama, "proj")):
            real = getattr(mod, name)

            def spy(x, *a, _real=real, _key=key, **kw):
                self.calls[_key].append(x.shape[0])
                return _real(x, *a, **kw)
            monkeypatch.setattr(mod, name, spy)


def _model(quant: str, **ec) -> LlamaModel:
    m = LlamaModel(EngineConfig(**dict(tl.EC, quant=quant, use_pallas=True,
                                       **ec)),
                   LlamaModelConfig(**tl.MC), device="cpu")
    m.load_weights()
    m.init_kvcache_and_swap()
    return m


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_quantized_weights_dispatch(quant, monkeypatch):
    """With kernels on, every projection of every layer and the head go
    through their format's kernel, and none through ``proj``: in a bucket
    of at most 256 tokens, and in a 512-token bucket (the wide
    configuration) too."""
    spy = Spy(monkeypatch)
    other = "int4" if quant == "int8" else "int8"
    L = tl.MC["num_layers"]
    m = _model(quant)
    tl.preallocate(m.hbm_block_mgrs[0])
    m.forward(tl.schedule("torch"))
    assert m.last_key.tokens <= im4.WIDE_ABOVE
    assert len(spy.calls[quant]) == 7 * L + 1 and not spy.calls["proj"]
    assert spy.calls[quant][-1] == m.last_key.rows     # the head's B rows
    assert not spy.calls[other]

    spy.calls = {k: [] for k in spy.calls}
    m = _model(quant, max_tokens_in_batch=512, prefill_chunk_size=512,
               num_hbm_blocks=64, max_blocks_per_seq=64)
    r = Request(RawRequest("", 4))
    r.set_prompt_token_ids([(3 * j) % 120 + 1 for j in range(300)])
    r.seq_id = 1
    m.forward([ScheduledSeq(r, 300)])
    assert m.last_key.tokens == 512
    assert spy.calls[quant] == [512] * (7 * L) + [m.last_key.rows]
    assert not spy.calls["proj"] and not spy.calls[other]


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_verify_head_over_256_rows_through_the_kernel(quant, monkeypatch):
    """A verify step whose head reads more than 256 rows (8 rows x spans of
    64 at spec_k = 63) sends the head through its format's kernel, as it
    does every projection, and nothing through ``proj``."""
    spy = Spy(monkeypatch)
    L = tl.MC["num_layers"]
    m = _model(quant, max_tokens_in_batch=512, prefill_chunk_size=16,
               num_hbm_blocks=64, max_blocks_per_seq=16, max_batch_size=8,
               enable_spec_decode=True, spec_k=63)
    seqs = []
    for i in range(5):
        r = Request(RawRequest("", 80))
        r.set_prompt_token_ids([(5 * i + j) % 120 + 1 for j in range(6 + i)])
        r.output_token_ids = [3 + i]
        r.num_cached_tokens = 6 + i
        r.seq_id = i + 1
        m.hbm_block_mgrs[0].allocate_for_seq(i + 1, 6 + i)
        drafts = tuple((7 * i + j) % 120 + 1 for j in range(40))
        seqs.append(ScheduledSeq(r, 1 + len(drafts), drafts=drafts))
    m.forward(seqs)
    key = m.last_key
    assert key.spec == 64 and key.rows * key.spec > im4.WIDE_ABOVE
    assert spy.calls[quant] == [key.tokens] * (7 * L) + [key.rows * key.spec]
    assert not spy.calls["proj"]


# A 512-token bucket: two decode rows beside a 300-token prefill chunk.
EC512 = dict(tl.EC, max_tokens_in_batch=512, prefill_chunk_size=512,
             num_hbm_blocks=64, max_blocks_per_seq=64)
ROWS512 = [(10, 10, [5], 1), (13, 14, [7, None], 1), (300, 0, [], 300)]


def schedule512(pkg):
    from swiftllm_tpu.server.scheduler import ScheduledSeq as JaxScheduledSeq
    from swiftllm_tpu.server.structs import (RawRequest as JaxRawRequest,
                                             Request as JaxRequest)
    Req, Raw, Sched = ((JaxRequest, JaxRawRequest, JaxScheduledSeq) if pkg == "jax"
                       else (Request, RawRequest, ScheduledSeq))
    out = []
    for i, (plen, cached, outputs, n) in enumerate(ROWS512):
        r = Req(Raw("", 4))
        r.set_prompt_token_ids([(5 * i + j) % 120 + 1 for j in range(plen)])
        r.output_token_ids = list(outputs)
        r.num_cached_tokens = cached
        r.seq_id = i + 1
        out.append(Sched(r, n))
    return out


def preallocate512(mgr):
    for i, (_, cached, _, _) in enumerate(ROWS512):
        if cached:
            mgr.allocate_for_seq(i + 1, cached)


@pytest.fixture(scope="module", params=["int8", "int4"])
def jax_step512(request):
    from swiftllm_tpu.config import EngineConfig as JaxEngineConfig
    from swiftllm_tpu.config import LlamaModelConfig as JaxModelConfig
    from swiftllm_tpu.worker.model import LlamaModel as JaxLlamaModel
    from tests.test_torch_quant import put_tree, scaled_quantized_tree
    quant = request.param
    tree = scaled_quantized_tree(tl.MC, EC512, quant, seed=3)
    rng = np.random.default_rng(4)
    m = JaxLlamaModel(JaxEngineConfig(**dict(EC512, quant=quant)),
                      JaxModelConfig(**tl.MC))
    m.load_weights()
    m.init_kvcache_and_swap()
    m.params = put_tree(m.params, tree)
    cache = rng.normal(size=m.kv_cache.shape).astype(np.float32)
    feedback = rng.integers(0, 128, size=m.token_feedback.shape).astype(np.int32)
    m.kv_cache = jax.device_put(cache, m.kv_cache.sharding)
    m.token_feedback = jax.device_put(feedback, m.token_feedback.sharding)
    preallocate512(m.hbm_block_mgrs[0])
    tokens, rows, logits = m.forward(schedule512("jax"), return_logits=True)
    return dict(quant=quant, tree=tree, cache=cache, feedback=feedback,
                tokens=tokens, logits=logits, rows=[r is not None for r in rows])


def test_quantized_512_bucket_step_matches_jax(jax_step512, monkeypatch):
    """A mixed INT8 or INT4 step in a 512-token bucket with kernels on (the
    wide configuration's plain versions on the CPU) against the JAX model's
    step: logits within test_quantized_mixed_step_matches_jax's bounds
    (atol/rtol 1e-4), greedy tokens equal, every projection through the
    kernel's wrapper."""
    from swiftllm_tpu_torch.worker.weights import params_from_numpy
    ref = jax_step512
    spy = Spy(monkeypatch)
    m = LlamaModel(EngineConfig(**dict(EC512, quant=ref["quant"], use_pallas=True)),
                   LlamaModelConfig(**tl.MC), device="cpu")
    m.params = params_from_numpy(ref["tree"], "cpu")
    m.init_kvcache_and_swap()
    m.kv_cache.copy_(torch.from_numpy(ref["cache"]))
    m.token_feedback.copy_(torch.from_numpy(ref["feedback"]))
    preallocate512(m.hbm_block_mgrs[0])
    tokens, rows, logits = m.forward(schedule512("torch"), return_logits=True)
    assert m.last_key.tokens == 512
    assert len(spy.calls[ref["quant"]]) == 7 * tl.MC["num_layers"] + 1
    assert not spy.calls["proj"]
    live = np.asarray(ref["rows"])
    assert [r is not None for r in rows] == ref["rows"]
    np.testing.assert_allclose(logits[live], ref["logits"][live],
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(tokens[live], ref["tokens"][live])


@pytest.mark.parametrize("fmt,kbytes,t_max,refused", [
    ("q4", 24, 512, True),     # INT4 K/2 off 16 where the wide configuration runs
    ("q4", 24, 256, False),    # the narrow configuration's ragged copy takes it
    ("q4", 32, 2048, False),
    ("q", 24, 16, True),       # INT8 K off 16 at any width
    ("q", 32, 2048, False),
])
def test_quantized_widths_checked_at_start_up(fmt, kbytes, t_max, refused):
    """LlamaModel checks its quantized weights' widths before it serves
    (``check_quantized_widths``, called by ``init_kvcache_and_swap`` on the
    card): a width the weight kernels cannot take at the steps' largest
    rows is refused with the weight's name and shape, not at the first
    prefill bucket."""
    from swiftllm_tpu_torch.worker.model import check_quantized_widths
    stack = {fmt: torch.zeros(2, 16, kbytes, dtype=torch.int8),
             "s": torch.ones(2, 16)}
    params = {"layers": {"w_up": stack, "ln": torch.ones(2, 8)},
              "lm_head": torch.zeros(16, 8, dtype=torch.bfloat16)}
    if refused:
        with pytest.raises(ValueError, match=rf"w_up: quantized weight \(2, 16, {kbytes}\)"):
            check_quantized_widths(params, t_max)
    else:
        check_quantized_widths(params, t_max)
    # The head is held to the same rule.
    head = {"layers": {}, "lm_head": stack}
    if refused:
        with pytest.raises(ValueError, match="lm_head"):
            check_quantized_widths(head, t_max)
    else:
        check_quantized_widths(head, t_max)
