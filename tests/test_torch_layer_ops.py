"""The layer's elementwise kernels of the PyTorch port (``ops/layer_ops.py``:
``add_rms_norm``, ``rope_qkv``, ``rope_qkv_fp8``, ``silu_mul``), on the CPU,
against the JAX package.

The kernels run only on the card (``chip_smoke.py --layer-ops`` holds them
against their plain versions there); here each wrapper takes its plain
version, and these tests hold that version against the JAX package's own
functions (``rms_norm``, ``apply_rope`` with ``rope_tables``, the ``biased``
projections and ``jax.nn.silu`` of ``layer_step``) on the same seeded numpy
inputs, the wrappers' device rules, and the model's dispatch. Tolerances,
and why:
- in f32: atol and rtol 1e-5 (the same f32 operations; the variance's sum
  and the trigonometry may round differently in the last bits);
- in bf16: rtol 2^-7 and atol 2^-7 of the output's largest magnitude, one
  bf16 rounding: both round each operation's output to bf16, but a
  variance or a cos summed or computed in another order may land on the
  other side of a rounding boundary, and then the output moves by one
  bf16 step (2^-8 to 2^-7 of the value), which a difference of two rounded
  products (RoPE) carries to an output near 0 as an absolute error on the
  scale of its inputs.
"""

import numpy as np
import pytest

import tests.conftest  # noqa: F401  (forces the JAX CPU backend)

import jax
import jax.numpy as jnp
import torch

from swiftllm_tpu.models import llama as jl
from swiftllm_tpu_torch.config import EngineConfig, LlamaModelConfig
from swiftllm_tpu_torch.models import llama
from swiftllm_tpu_torch.ops import build
from swiftllm_tpu_torch.ops import layer_ops as lo
from swiftllm_tpu_torch.ops import quantize_kv as qkv
from swiftllm_tpu_torch.ops.paged_attention import FP8
from swiftllm_tpu_torch.worker.model import LlamaModel
from tests import test_torch_llama as tl

EPS = 1e-5
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def close(got: torch.Tensor, want, dtype: str) -> None:
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    else:
        tol = 2.0 ** -7
        np.testing.assert_allclose(got, want, rtol=tol,
                                   atol=tol * np.abs(want).max())


def pair(a: np.ndarray, dtype: str):
    """The same values as a torch and a JAX array of ``dtype``."""
    td, jd = DTYPES[dtype]
    return torch.from_numpy(a).to(td), jnp.asarray(a).astype(jd)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("residual", [True, False])
def test_add_rms_norm_plain_matches_jax(dtype, residual):
    """(h, x') against ``rms_norm(x + r)`` (``rms_norm(x)`` without the
    residual) and x + r, on rows of magnitudes 1 to 1e-3 (where eps
    matters)."""
    rng = np.random.default_rng(1)
    T, D = 7, 96
    mag = 10.0 ** -(np.arange(T) % 4)[:, None]
    x, jx = pair((rng.standard_normal((T, D)) * mag).astype(np.float32), dtype)
    r, jr = pair((rng.standard_normal((T, D)) * mag).astype(np.float32), dtype)
    w, jw = pair((1 + 0.1 * rng.standard_normal(D)).astype(np.float32), dtype)
    h, x2 = lo.add_rms_norm_plain(x, r if residual else None, w, EPS)
    jx2 = jx + jr if residual else jx
    close(h, jl.rms_norm(jx2, jw, EPS), dtype)
    close(x2, jx2, dtype)
    if not residual:
        assert x2 is x


@pytest.mark.parametrize("D", [4096, 896], ids=["8B", "Qwen2-0.5B"])
def test_add_rms_norm_plain_matches_jax_at_model_widths(D):
    """The same in bf16 with the residual at the widths the card holds the
    kernel to (chip_smoke.py --layer-ops): Llama-3-8B's 4,096 lanes, and
    Qwen2-0.5B's 896 (112 vectors of 8, fewer than a block's threads)."""
    rng = np.random.default_rng(2)
    T = 3
    mag = 10.0 ** -(np.arange(T) % 4)[:, None]
    x, jx = pair((rng.standard_normal((T, D)) * mag).astype(np.float32), "bf16")
    r, jr = pair((rng.standard_normal((T, D)) * mag).astype(np.float32), "bf16")
    w, jw = pair((1 + 0.1 * rng.standard_normal(D)).astype(np.float32), "bf16")
    h, x2 = lo.add_rms_norm_plain(x, r, w, EPS)
    close(h, jl.rms_norm(jx + jr, jw, EPS), "bf16")
    close(x2, jx + jr, "bf16")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("bias", [True, False])
def test_rope_qkv_plain_matches_jax(dtype, hd, bias):
    """q_rot and the cache row k_rot ‖ v against the JAX package's biased
    projections, ``apply_rope`` with ``rope_tables`` and the ``kv_new``
    concatenation (the fp8 row's bytes: tests/test_torch_fp8_kv.py)."""
    rng = np.random.default_rng(2)
    T, n_q, n_kv = 5, 4, 2
    positions = np.array([0, 1, 17, 300, 4095], np.int32)
    inv_freq = (1.0 / 500000.0 ** (np.arange(0, hd, 2) / hd)).astype(np.float32)
    q, jq = pair(rng.standard_normal((T, n_q * hd)).astype(np.float32), dtype)
    k, jk = pair(rng.standard_normal((T, n_kv * hd)).astype(np.float32), dtype)
    v, jv = pair(rng.standard_normal((T, n_kv * hd)).astype(np.float32), dtype)
    biases = [pair(rng.standard_normal(n).astype(np.float32), dtype)
              for n in (n_q * hd, n_kv * hd, n_kv * hd)]
    tables = llama.rope_tables(torch.from_numpy(positions),
                               torch.from_numpy(inv_freq), DTYPES[dtype][0])
    got_q, got_kv = lo.rope_qkv_plain(
        q, k, v, tables, tuple(b for b, _ in biases) if bias else None)

    if bias:   # layer_step's ``biased``
        jq, jk, jv = (y + b.astype(y.dtype)[None, :]
                      for y, (_, b) in zip((jq, jk, jv), biases))
    jt = jl.rope_tables(jnp.asarray(positions), jnp.asarray(inv_freq),
                        DTYPES[dtype][1])
    want_q = jl.apply_rope(jq.reshape(T, n_q, hd), None, None, tables=jt)
    want_k = jl.apply_rope(jk.reshape(T, n_kv, hd), None, None, tables=jt)
    want_kv = jnp.concatenate([want_k.reshape(T, -1), jv], axis=1)
    close(got_q, want_q.reshape(T, -1), dtype)
    close(got_kv, want_kv, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_silu_mul_plain_matches_jax(dtype):
    """silu(gate)·up against ``layer_step``'s
    ``jax.nn.silu(gate.astype(f32)).astype(dtype) * up``."""
    rng = np.random.default_rng(3)
    gate, jg = pair((rng.standard_normal((6, 80)) * 4).astype(np.float32), dtype)
    up, ju = pair(rng.standard_normal((6, 80)).astype(np.float32), dtype)
    want = jax.nn.silu(jg.astype(jnp.float32)).astype(jg.dtype) * ju
    close(lo.silu_mul_plain(gate, up), want, dtype)


def _stub_card(monkeypatch) -> list:
    """Every tensor taken as a card's (``build.on_cpu`` False) and every
    launch recorded instead of run, each argument checked against the
    ctypes type ``build.SOURCES`` declares for its place."""
    launched = []

    def launch(name, dev, *args, **kw):
        types = build.SOURCES[name][1]
        assert len(args) == len(types) - 1, (name, len(args))  # + the stream
        for a, t in zip(args, types):
            t.from_param(a)                # raises on a wrong type
        launched.append((name, args))
    monkeypatch.setattr(build, "on_cpu", lambda *a: False)
    monkeypatch.setattr(build, "launch", launch)
    return launched


def _cpu_rules(name, fn, args, plain):
    """On CPU tensors: the plain version, no launch; off the CPU and the
    card (meta): a raise."""
    build.reset_launch_counts()
    got, want = fn(*args), plain(*args)
    for g, w in zip(*(o if isinstance(o, tuple) else (o,) for o in (got, want))):
        assert torch.equal(g, w)
    assert build.launch_counts[name] == 0

    def meta(a):
        if isinstance(a, tuple):
            return tuple(map(meta, a))
        return a.to("meta") if torch.is_tensor(a) else a
    with pytest.raises(ValueError, match="all-CPU or all-CUDA"):
        fn(*map(meta, args))


def test_add_rms_norm_wrapper_rules(monkeypatch):
    rng = np.random.default_rng(4)
    x, r = (torch.from_numpy(rng.standard_normal((3, 32)).astype(np.float32))
            for _ in range(2))
    w = torch.ones(32)
    _cpu_rules("add_rms_norm", lo.add_rms_norm, (x, r, w, EPS), lo.add_rms_norm_plain)
    launched = _stub_card(monkeypatch)
    with pytest.raises(TypeError, match="bf16"):
        lo.add_rms_norm(x, r, w, EPS)
    xb, rb, wb = (t.to(torch.bfloat16) for t in (x, r, w))
    big = torch.zeros(1, lo.MAX_NORM_D + 8, dtype=torch.bfloat16)
    for bad in ((xb[:, :12], rb[:, :12], wb[:12]),      # D off 8
                (xb, rb[:2], wb),                        # r's rows
                (xb, rb, wb[:16]),                       # weight's width
                (xb[0], None, wb),                       # not [T, D]
                (xb[:0], None, wb),                      # no rows
                (big, None, big[0])):                    # D over the cap
        with pytest.raises(ValueError, match="add_rms_norm shapes"):
            lo.add_rms_norm(*bad, EPS)
    assert not launched
    h, x2 = lo.add_rms_norm(xb, rb, wb, EPS)
    assert h.shape == x2.shape == xb.shape and h.dtype == torch.bfloat16
    assert launched[-1] == ("add_rms_norm", (
        xb.data_ptr(), rb.data_ptr(), wb.data_ptr(), x2.data_ptr(), h.data_ptr(),
        3, 32, EPS))
    h, x2 = lo.add_rms_norm(xb, None, wb, EPS)       # layer 0: no residual
    assert x2 is xb
    assert launched[-1][1][1] is None and launched[-1][1][3] is None


def _rope_inputs(rng, T=3, n_q=4, n_kv=2, hd=32):
    q = torch.from_numpy(rng.standard_normal((T, n_q * hd)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((T, n_kv * hd)).astype(np.float32))
            for _ in range(2))
    tables = llama.rope_tables(torch.arange(T), torch.ones(hd // 2) * 0.1,
                               torch.float32)
    bias = (torch.ones(n_q * hd), torch.ones(n_kv * hd), torch.ones(n_kv * hd))
    return q, k, v, tables, bias


@pytest.mark.parametrize("name", ["rope_qkv", "rope_qkv_fp8"])
def test_rope_qkv_wrapper_rules(name, monkeypatch):
    """Both rope wrappers: the plain version on the CPU, a raise off it;
    on the card (stubbed) bf16 only, the shapes checked (a token's units
    capped at MAX_ROPE_UNITS), and one launch whose arguments are the
    inputs, the fresh outputs (the bf16 row k_rot ‖ v, or the fp8 cache
    row with its scale lanes) and the widths."""
    rng = np.random.default_rng(5)
    fn, plain = getattr(lo, name), getattr(lo, name + "_plain")
    q, k, v, tables, bias = _rope_inputs(rng)
    _cpu_rules(name, fn, (q, k, v, tables, bias), plain)
    launched = _stub_card(monkeypatch)
    with pytest.raises(TypeError, match="bf16"):
        fn(q, k, v, tables, bias)
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    tb = tuple(t.to(torch.bfloat16) for t in tables)
    bb = tuple(t.to(torch.bfloat16) for t in bias)
    hd8 = tuple(t[..., :4] for t in tb)                  # head_dim 8
    # 72 q and 72 kv heads of 128: 2,304 units a token
    wide = (*(torch.zeros(3, 72 * 128, dtype=torch.bfloat16) for _ in range(3)),
            tuple(torch.zeros(3, 1, 64, dtype=torch.bfloat16) for _ in range(2)),
            None)
    assert lo.rope_units(72, 72, 128) == 2304 > lo.MAX_ROPE_UNITS
    assert lo.rope_units(64, 64, 128) == lo.MAX_ROPE_UNITS
    for bad in ((qb, kb, vb, hd8, None),                 # head_dim off 16
                (qb[:, :40], kb, vb, tb, None),          # q off the head_dim
                (qb, kb, vb[:, :32], tb, None),          # v's width
                (qb, kb[:2], vb, tb, None),              # k's rows
                (qb, kb, vb, tuple(t[:2] for t in tb), None),   # tables' rows
                (qb, kb, vb, tb, bb[:2] + bb[:1]),       # bv's shape
                wide):                                   # units over the cap
        with pytest.raises(ValueError, match=f"{name} shapes"):
            fn(*bad)
    assert not launched
    q2, kv = fn(qb, kb, vb, tb, bb)
    row = (2 * 64 + 128, FP8) if name == "rope_qkv_fp8" else (2 * 64, torch.bfloat16)
    assert q2.shape == qb.shape and q2.dtype == torch.bfloat16
    assert (kv.shape[1], kv.dtype) == row and kv.shape[0] == 3
    assert launched[-1] == (name, (
        qb.data_ptr(), kb.data_ptr(), vb.data_ptr(), *(b.data_ptr() for b in bb),
        tb[0].data_ptr(), tb[1].data_ptr(), q2.data_ptr(), kv.data_ptr(),
        3, 4, 2, 32))
    q2, kv = fn(qb, kb, vb, tb, None)                    # no biases: null
    assert launched[-1][1][3:6] == (None,) * 3
    assert launched[-1][1][8:] == (q2.data_ptr(), kv.data_ptr(), 3, 4, 2, 32)


def test_silu_mul_wrapper_rules(monkeypatch):
    rng = np.random.default_rng(6)
    gate, up = (torch.from_numpy(rng.standard_normal((3, 48)).astype(np.float32))
                for _ in range(2))
    _cpu_rules("silu_mul", lo.silu_mul, (gate, up), lo.silu_mul_plain)
    launched = _stub_card(monkeypatch)
    with pytest.raises(TypeError, match="bf16"):
        lo.silu_mul(gate, up)
    gb, ub = gate.to(torch.bfloat16), up.to(torch.bfloat16)
    for bad in ((gb[:, :44], ub[:, :44]), (gb, ub[:2]), (gb[0], ub[0])):
        with pytest.raises(ValueError, match="silu_mul shapes"):
            lo.silu_mul(*bad)
    assert not launched
    out = lo.silu_mul(gb, ub)
    assert out.shape == gb.shape
    assert launched[-1] == ("silu_mul", (gb.data_ptr(), ub.data_ptr(),
                                         out.data_ptr(), 3, 48))


class Spy:
    """Counts the calls of the layer kernels' wrappers in the model."""

    def __init__(self, monkeypatch):
        self.calls = dict.fromkeys(lo.KERNELS, 0)
        for mod, name in [(lo, n) for n in lo.KERNELS]:
            real = getattr(mod, name)

            def spy(*a, _real=real, _name=name, **kw):
                self.calls[_name] += 1
                return _real(*a, **kw)
            monkeypatch.setattr(mod, name, spy)


@pytest.mark.parametrize("kind", ["bf16", "fp8_kv", "qkv_bias"])
def test_layer_ops_dispatch(kind, monkeypatch):
    """With kernels on, a step sends the layer's elementwise work through
    the wrappers: add_rms_norm 2L + 1 times (the final norm takes the last
    layer's residual), rope_qkv and silu_mul L times; with an fp8 cache
    rope_qkv_fp8 L times in place of rope_qkv, the row built in its launch
    (the stand-alone row build, quantize_kv, no longer exists). The plain
    path calls none of them, and both give the same logits (the CPU runs
    the plain versions)."""
    L = tl.MC["num_layers"]
    ec = dict(tl.EC, dtype="bfloat16")
    if kind == "fp8_kv":
        ec.update(kv_quant="fp8", block_size=32, max_blocks_per_seq=4)
    mc = LlamaModelConfig(**dict(tl.MC, qkv_bias=kind == "qkv_bias"))
    logits = {}
    for use_kernels in (True, False):
        spy = Spy(monkeypatch)
        m = LlamaModel(EngineConfig(**dict(ec, use_pallas=use_kernels)), mc,
                       device="cpu")
        m.load_weights()
        m.init_kvcache_and_swap()
        if use_kernels:
            params = m.params
        m.params = params
        tl.preallocate(m.hbm_block_mgrs[0])
        _, _, logits[use_kernels] = m.forward(tl.schedule("torch"),
                                              return_logits=True)
        fp8 = kind == "fp8_kv"
        want = {"add_rms_norm": 2 * L + 1, "rope_qkv": 0 if fp8 else L,
                "rope_qkv_fp8": L if fp8 else 0, "silu_mul": L}
        assert spy.calls == (want if use_kernels else dict.fromkeys(want, 0)), \
            (use_kernels, spy.calls)
        monkeypatch.undo()
    assert np.isfinite(logits[True]).all()
    np.testing.assert_array_equal(logits[True], logits[False])
    assert not hasattr(qkv, "quantize_kv") and "quantize_kv" not in build.KERNELS
