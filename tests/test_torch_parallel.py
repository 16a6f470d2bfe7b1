"""Tensor and data parallelism of the PyTorch port against the JAX package,
on the CPU: one process per rank over gloo, at tiny widths.

- ``shard_params``: each (dp, tp) rank's shard equals the addressable shard
  that ``jax.device_put(params, named(mesh, param_specs(...)))`` puts on
  that device of a 2 x 2 mesh of JAX's virtual CPU devices, exactly: bf16
  (with a vocab that tp does not divide), INT8, INT4 with a quantized
  ``lm_head``, Qwen2-style biases, and LoRA on in- and out-sharded targets.
  One exception, on purpose: an INT4 weight split along its contraction
  axis (``wo``, ``w_down``) is repacked per shard (``mesh.shard_int4_in``):
  the JAX package slices the split-half packed bytes, which pairs a rank's
  activations with other columns. That shard is held to the split-half
  packing of the rank's column block of the unpacked weight, and the INT4
  step at tp = 2 to the one at tp = 1.
- ``forward_shard`` at tp = 2 (two ranks) against the JAX step at tp = 2
  (``LlamaModel(tp_size=2)``, ``use_pallas=False``, float32): a SARATHI
  mixed step, the same with an fp8 KV cache (each rank's cache bytes equal
  its JAX shard's lane slice), and a speculative verify step with a sampled
  row (JAX's Gumbel noise injected, exact top-k) and logprobs. Logits within
  atol 1e-4 / rtol 1e-4 (f32 on both sides; the all-reduce sums the shards'
  partials as JAX's psum does, in another order), greedy tokens equal.
- The head's collectives on their own: ``exact_greedy`` with equal maxima
  in two shards picks the first shard's index; ``sample_tokens`` at tp = 2
  picks the same tokens as at tp = 1 and as the JAX package's at tp = 2
  (``shard_map``) under the same injected noise; ``chosen_logprobs`` at
  tp = 2 within 1e-5 of the JAX package's log-softmax.
- The primary/follower round trip (``tests/test_multiprocess.py``'s): the
  packed length from the key, the header from ``BucketKey``'s fields,
  identical tokens on both ranks, a swap out and in replayed, and the
  tokens after it equal to a single-process run's.
- ``LlamaModel`` builds at tp = 2 under a 2-rank group.
- The card of a launch: ranks on one machine each own a card, and the
  current card is per thread. Every kernel launches through
  ``build.launch`` with its tensors' device, which makes that card current
  for the launch and takes that card's stream; the engine's model thread
  and a follower's loop make the model's card theirs.

Every spawned rank has a join timeout and is killed after it.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import socket
import traceback

import numpy as np
import pytest
import torch

from swiftllm_tpu_torch.config import EngineConfig, LlamaModelConfig
from swiftllm_tpu_torch.models import llama, sampling
from swiftllm_tpu_torch.parallel import distributed
from swiftllm_tpu_torch.parallel.mesh import (PARAM_SPECS, Mesh,
                                              shard_int4_in, shard_params)
from swiftllm_tpu_torch.server.scheduler import ScheduledSeq
from swiftllm_tpu_torch.server.structs import RawRequest, Request
from swiftllm_tpu_torch.worker.model import LlamaModel
from swiftllm_tpu_torch.worker.weights import params_from_numpy, specs_of

RANK_TIMEOUT = 150     # seconds a group of ranks may take, start to end


# --- ranks ----------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world, port, out_dir, args):
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    torch.set_num_threads(1)
    try:
        distributed.initialize("gloo")
        result = fn(rank, *args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        distributed.shutdown()


def run_ranks(fn, world: int, *args, tmp_path, timeout=RANK_TIMEOUT):
    """Run ``fn(rank, *args)`` in ``world`` spawned processes joined over
    gloo (``distributed.initialize`` from the torchrun environment); return
    each rank's result. A rank that fails fails the test with its traceback;
    a group still running after ``timeout`` seconds is killed."""
    import time
    out_dir = tmp_path / f"ranks-{fn.__name__}-{_free_port()}"
    out_dir.mkdir()
    ctx = torch.multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, port, str(out_dir), args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errs = {r: (out_dir / f"rank{r}.err").read_text()
            for r in range(world) if (out_dir / f"rank{r}.err").exists()}
    if errs:
        pytest.fail("\n".join(f"rank {r}:\n{e}" for r, e in errs.items()))
    if hung:
        pytest.fail(f"ranks {hung} still running after {timeout} s: killed")
    bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
    assert not bad, f"ranks exited with {bad}"
    return [pickle.loads((out_dir / f"rank{r}.pkl").read_bytes())
            for r in range(world)]


# --- shard_params against jax.device_put -------------------------------------------

SHARD_MC = dict(num_layers=2, num_q_heads=4, num_kv_heads=2, hidden_size=64,
                head_dim=16, ffn_inter_dim=128, vocab_size=128,
                max_position_embeddings=512, rms_norm_eps=1e-5)
SHARD_CASES = {
    "bf16": (dict(dtype="bfloat16"), dict(vocab_size=127)),
    "int8": (dict(quant="int8", dtype="float32"), {}),
    "int4_qlm": (dict(quant="int4", dtype="float32"), {}),
    "qkv_bias": (dict(dtype="float32"), dict(qkv_bias=True)),
    "lora": (dict(dtype="float32", lora_paths="dummy:a,b,r=4"), {}),
}


def _jax_model(ec_kw: dict, mc: dict):
    from swiftllm_tpu.config import EngineConfig as JaxEngineConfig
    from swiftllm_tpu.config import LlamaModelConfig as JaxModelConfig
    from swiftllm_tpu.worker.model import LlamaModel as JaxLlamaModel
    ec = dict(model_path="", use_dummy=True, block_size=8, num_hbm_blocks=16,
              num_cpu_blocks=0, max_blocks_per_seq=8, max_batch_size=4,
              max_tokens_in_batch=64, prefill_chunk_size=16,
              max_seqs_in_block_table=8, use_pallas=False)
    m = JaxLlamaModel(JaxEngineConfig(**dict(ec, **ec_kw)), JaxModelConfig(**mc))
    m.load_weights()
    return m


def _device_shard(arr, device) -> np.ndarray:
    for s in arr.addressable_shards:
        if s.device == device:
            return np.asarray(s.data)
    raise AssertionError(f"no shard on {device}")


def _as_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


@pytest.mark.parametrize("case", list(SHARD_CASES))
def test_shard_params_match_jax_device_put(case):
    import jax
    ec_kw, mc_kw = SHARD_CASES[case]
    m = _jax_model(dict(ec_kw, dp_size=2, tp_size=2), dict(SHARD_MC, **mc_kw))
    tree = jax.tree.map(np.asarray, jax.device_get(m.params))
    specs = specs_of(tree)
    if case == "int4_qlm":
        assert specs["layers"]["wo"]["q4"] == "packed_in"
        assert isinstance(tree["lm_head"], dict)
    if case == "bf16":
        assert tree["embed"].shape[0] == 128        # 127 padded to 2 x 64
    host = jax.tree.map(lambda a: torch.from_numpy(
        np.array(a.view(np.int16) if a.dtype.name == "bfloat16" else a)), tree)
    devices = np.asarray(m.mesh.devices)               # [dp, tp]
    n_leaves = 0
    for (dp_r, tp_r), dev in np.ndenumerate(devices):
        mine = shard_params(host, specs, tp_r, 2)
        got = jax.tree_util.tree_flatten_with_path(mine)[0]
        want = dict(jax.tree_util.tree_flatten_with_path(m.params)[0])
        for path, leaf in got:
            ref = _device_shard(want[path], dev)
            if ref.dtype.name == "bfloat16":
                ref = ref.view(np.int16)
            name = jax.tree_util.keystr(path)
            if case == "int4_qlm" and path[-1].key == "q4" and \
                    path[-2].key in ("wo", "w_down"):
                # Repacked per shard: the split-half packing of the rank's
                # column block of the unpacked weight.
                whole = torch.from_numpy(
                    np.array(tree["layers"][path[-2].key]["q4"]))
                ref = shard_int4_in(whole, tp_r, 2).numpy()
            np.testing.assert_array_equal(_as_numpy(leaf), ref, err_msg=name)
            n_leaves += 1
    assert n_leaves >= 4 * 12


def test_int4_in_shard_is_column_block():
    """The repacked shard unpacks to the rank's contiguous K/tp columns."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.integers(-7, 8, size=(2, 6, 16)).astype(np.int8))
    packed = (q[..., :8] & 0xF) | (q[..., 8:] << 4)
    for r in range(2):
        s = shard_int4_in(packed, r, 2)
        unpacked = torch.cat([(s << 4) >> 4, s >> 4], dim=-1)
        assert torch.equal(unpacked, q[..., 8 * r:8 * (r + 1)])


def test_param_specs_cover_the_tree():
    """Every leaf of a tp = 1 dummy tree has a spec, and the replicated ones
    are exactly the norms and the rotary frequencies."""
    from swiftllm_tpu_torch.worker.weights import _dummy_params
    mc = LlamaModelConfig(**SHARD_MC)
    tree = _dummy_params(mc, torch.float32, torch.device("cpu"))
    specs = specs_of(tree)
    assert specs["layers"] == PARAM_SPECS["layers"]
    replicated = sorted(k for k, v in specs["layers"].items() if v is None)
    assert replicated == ["attn_norm", "ffn_norm"]
    assert specs["inv_freq"] is None and specs["final_norm"] is None


# --- the step at tp = 2 against the JAX step at tp = 2 ---------------------------

STEP_MC = dict(num_layers=3, num_q_heads=4, num_kv_heads=2, hidden_size=64,
               head_dim=16, ffn_inter_dim=128, vocab_size=128,
               max_position_embeddings=512, rms_norm_eps=1e-5)
STEP_EC = dict(model_path="", use_dummy=True, dtype="float32", block_size=8,
               num_hbm_blocks=32, max_blocks_per_seq=8, max_batch_size=8,
               max_tokens_in_batch=64, prefill_chunk_size=16,
               max_seqs_in_block_table=8, preemption_mode="recompute",
               use_pallas=False)
# (prompt_len, cached, outputs, n_tokens, drafts, temperature) per row;
# decode rows first, one reading its token from the feedback buffer.
MIXED_ROWS = [(10, 10, [5], 1, (), 0.0), (13, 14, [7, None], 1, (), 0.0),
              (24, 8, [], 16, (), 0.0), (5, 0, [], 5, (), 0.0)]
VERIFY_ROWS = [(10, 10, [5], 1, (), 0.0), (13, 14, [7, None], 1, (), 0.8),
               (21, 21, [3], 5, (4, 5, 6, 7), 0.0),
               (6, 8, [2, 8, 1], 3, (11, 12), 0.0),
               (30, 31, [9, 9], 4, (1, 2, 3), 0.0)]
STEP_CASES = {
    "mixed": (MIXED_ROWS, {}),
    "fp8": (MIXED_ROWS, dict(kv_quant="fp8", block_size=32)),
    "verify": (VERIFY_ROWS, dict(enable_spec_decode=True, spec_k=4,
                                 enable_logprobs=True)),
}


def step_sched(rows, pkg="port"):
    if pkg == "jax":
        from swiftllm_tpu.server.scheduler import ScheduledSeq as S
        from swiftllm_tpu.server.structs import RawRequest as Raw
        from swiftllm_tpu.server.structs import Request as Req
    else:
        S, Raw, Req = ScheduledSeq, RawRequest, Request
    out = []
    for i, (plen, cached, outputs, n, drafts, temp) in enumerate(rows):
        r = Req(Raw("", 16, temperature=temp, seed=40 + i))
        r.set_prompt_token_ids([(5 * i + j) % 120 + 1 for j in range(plen)])
        r.output_token_ids = list(outputs)
        r.num_cached_tokens = cached
        r.seq_id = i + 1
        out.append(S(r, n, drafts=drafts))
    return out


def preallocate(mgr, rows):
    for i, (_, cached, *_rest) in enumerate(rows):
        if cached:
            mgr.allocate_for_seq(i + 1, cached)


def scaled_tree(jax_params, rng):
    """The JAX dummy tree scaled to O(0.1) weights with unit norms (the
    method of tests/test_torch_llama.py), quantized leaves through their
    scales."""
    import jax
    tree = jax.tree.map(np.asarray, jax.device_get(jax_params))
    for name in ("attn_norm", "ffn_norm"):
        tree["layers"][name] = np.ones_like(tree["layers"][name])
    tree["final_norm"] = np.ones_like(tree["final_norm"])
    for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        w = tree["layers"][k]
        if isinstance(w, dict):
            w["s"] = w["s"] * 100.0
        else:
            tree["layers"][k] = w * 100.0
    tree["embed"] = rng.normal(size=tree["embed"].shape).astype(np.float32)
    if isinstance(tree["lm_head"], dict):
        tree["lm_head"]["s"] = tree["lm_head"]["s"] * 100.0
    else:
        tree["lm_head"] = tree["lm_head"] * 100.0
    return tree


def jax_gumbel(seeds: np.ndarray, n: int) -> np.ndarray:
    import jax
    import jax.numpy as jnp
    return np.array(jax.vmap(lambda s: jax.random.gumbel(
        jax.random.key(s), (n,), jnp.float32))(jnp.asarray(seeds)))


def _step_noise(rows, ec_kw, ref) -> tuple[np.ndarray, np.ndarray]:
    """(seeds, JAX's noise rows for them): the seeds the sampler sees in
    this step, read from a single-process port step on the same inputs."""
    seen = []
    real = llama.sample_tokens

    def spy(logits, *, seeds, **kw):
        seen.append((seeds.long() & 0xFFFFFFFF).numpy())
        return real(logits, seeds=seeds, **kw)
    llama.sample_tokens = spy
    try:
        # In this process at tp = 1; the seeds come from the batch alone,
        # so the cache's lane order does not matter here.
        _port_step_rank(0, rows, ec_kw, ref, 1, None, 1)
    finally:
        llama.sample_tokens = real
    seeds = np.unique(np.concatenate(seen)).astype(np.uint32)
    return seeds, jax_gumbel(seeds, 128)


def _jax_step(rows, ec_kw, tp, rng, tree=None):
    """The JAX model's step at ``tp`` on the scaled tree: the tree, the
    caches before and after, tokens, logits and logprobs."""
    import jax
    from swiftllm_tpu.models import sampling as jax_sampling
    m = _jax_model(dict(STEP_EC, **ec_kw, tp_size=tp), STEP_MC)
    m.init_kvcache_and_swap()
    if tree is None:
        tree = scaled_tree(m.params, rng)
    m.params = jax.tree.map(lambda old, new: jax.device_put(new, old.sharding),
                            m.params, tree)
    L, S, W = m.kv_cache.shape
    if m.kv_cache.dtype.name == "float8_e4m3fn":
        cache = _random_fp8_cache(rng, L, S, W, tp)
    else:
        cache = rng.normal(size=(L, S, W)).astype(np.float32)
    feedback = rng.integers(0, 120, size=m.token_feedback.shape).astype(np.int32)
    m.kv_cache = jax.device_put(cache, m.kv_cache.sharding)
    m.token_feedback = jax.device_put(feedback, m.token_feedback.sharding)
    preallocate(m.hbm_block_mgrs[0], rows)
    saved = jax_sampling.EXACT_TOPK
    jax_sampling.EXACT_TOPK = True
    try:
        tokens, out_rows, logits = m.forward(step_sched(rows, "jax"),
                                             return_logits=True)
    finally:
        jax_sampling.EXACT_TOPK = saved
    lp = m.last_logprobs
    return dict(tree=tree, cache=cache, feedback=feedback, tokens=tokens,
                logits=logits, logprobs=None if lp is None else np.asarray(lp),
                live=[r is not None for r in out_rows], key=m.last_key,
                cache_after=np.asarray(m.kv_cache),
                feedback_after=np.asarray(m.token_feedback))


def _random_fp8_cache(rng, L, S, W, tp):
    """Valid fp8 cache rows (per-token scales in each shard's scale lanes),
    as uint8 bytes, [L, S, W] for tp shards side by side."""
    import ml_dtypes
    from swiftllm_tpu_torch.models.llama import quantize_kv_plain
    Wl = W // tp
    KH = (Wl - llama.FP8_SCALE_LANES) // 2
    parts = []
    for _ in range(tp):
        kv = torch.from_numpy(rng.normal(size=(L * S, 2 * KH)).astype(np.float32))
        parts.append(quantize_kv_plain(kv[:, :KH], kv[:, KH:]).view(torch.uint8)
                     .numpy().reshape(L, S, Wl))
    return np.concatenate(parts, axis=2).view(ml_dtypes.float8_e4m3fn)


def _to_port_cache(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8).copy()).view(torch.float8_e4m3fn)
    return torch.from_numpy(a.copy())


def _cache_numpy(t: torch.Tensor) -> np.ndarray:
    return (t.view(torch.uint8).numpy() if t.dtype == torch.float8_e4m3fn
            else t.numpy())


def _with_noise(noise):
    """``sample_tokens`` with JAX's noise for each seed (``noise`` = (sorted
    seeds, their rows), computed in the parent) injected."""
    real = sampling.sample_tokens
    known, table = noise

    def sample(logits, *, seeds, **kw):
        idx = np.searchsorted(known, (seeds.long() & 0xFFFFFFFF).numpy())
        return real(logits, seeds=seeds, gumbel=torch.from_numpy(table[idx]),
                    **kw)
    return sample


def _rank_lanes(cache: np.ndarray, ref_tp: int, tp: int, r: int,
                n_kv: int, hd: int) -> np.ndarray:
    """Rank r's lanes at ``tp`` of a cache laid out for ``ref_tp`` shards
    (each shard's [K_all ‖ V_all] side by side, as the JAX package's)."""
    if ref_tp == tp:
        Wl = cache.shape[2] // tp
        return cache[:, :, r * Wl:(r + 1) * Wl]
    assert ref_tp == 1
    k, v = np.split(cache, 2, axis=2)
    nl = n_kv // tp
    heads = slice(r * nl * hd, (r + 1) * nl * hd)
    return np.concatenate([k[:, :, heads], v[:, :, heads]], axis=2)


def _port_step_rank(rank, rows, ec_kw, ref, tp, noise, ref_tp):
    """One rank of the port's step at tp on the JAX tree and cache (laid
    out for ``ref_tp`` shards)."""
    if noise is not None:
        llama.sample_tokens = _with_noise(noise)
    ec = EngineConfig(**dict(STEP_EC, **ec_kw, tp_size=tp))
    m = LlamaModel(ec, LlamaModelConfig(**STEP_MC), device="cpu")
    m.params = params_from_numpy(ref["tree"], "cpu", m.mesh.tp_rank, tp)
    m.init_kvcache_and_swap()
    Wl = m.kv_cache.shape[2]
    m.kv_cache.copy_(_to_port_cache(np.ascontiguousarray(_rank_lanes(
        ref["cache"], ref_tp, tp, m.mesh.tp_rank, STEP_MC["num_kv_heads"],
        STEP_MC["head_dim"]))))
    m.token_feedback.copy_(torch.from_numpy(ref["feedback"]))
    preallocate(m.hbm_block_mgrs[0], rows)
    if distributed.is_primary():
        tokens, out_rows, logits = m.forward(step_sched(rows), return_logits=True)
        distributed.stop_followers()
        live = [x is not None for x in out_rows]
    else:
        distributed.follower_loop(m)
        tokens = logits = live = None
    lp = m.last_logprobs
    return dict(tokens=tokens, logits=logits, live=live, key=m.last_key,
                logprobs=None if lp is None else lp.numpy(),
                cache=_cache_numpy(m.kv_cache), lanes=Wl,
                feedback=m.token_feedback.numpy())


def _valid(ref, rows, key):
    """Valid output positions: each live row's, or in a verify step the
    first n_tokens of each row's span."""
    if not key.spec:
        return np.asarray(ref["live"])
    valid = np.zeros((len(ref["live"]), key.spec), bool)
    for i, (_, _, _, n, _, _) in enumerate(rows):
        valid[i, :n] = True
    return valid.reshape(-1)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_step_tp2_matches_jax(case, tmp_path):
    rows, ec_kw = STEP_CASES[case]
    ref = _jax_step(rows, ec_kw, 2, np.random.default_rng(0))
    noise = _step_noise(rows, ec_kw, ref) if case == "verify" else None
    outs = run_ranks(_port_step_rank, 2, rows, ec_kw, ref, 2, noise, 2,
                     tmp_path=tmp_path)
    got = outs[0]
    assert dataclasses.astuple(got["key"]) == dataclasses.astuple(ref["key"])
    valid = _valid(ref, rows, ref["key"])
    assert np.isfinite(ref["logits"][valid]).all()
    np.testing.assert_allclose(got["logits"][valid], ref["logits"][valid],
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(got["tokens"][valid], ref["tokens"][valid])
    if case == "verify":
        np.testing.assert_allclose(got["logprobs"][valid],
                                   ref["logprobs"][valid], atol=1e-5, rtol=0)
    ps = STEP_EC["block_size"] if case != "fp8" else 32
    after = ref["cache_after"]
    if after.dtype.name == "float8_e4m3fn":
        after = after.view(np.uint8)
    for r, out in enumerate(outs):
        # Every rank's feedback buffer and its lane slice of the cache (the
        # garbage slot and page excluded).
        np.testing.assert_array_equal(out["feedback"][:-1],
                                      ref["feedback_after"][:-1])
        Wl = out["lanes"]
        mine = after[:, :-ps, r * Wl:(r + 1) * Wl]
        if case == "fp8":
            np.testing.assert_array_equal(out["cache"][:, :-ps], mine)
        else:
            np.testing.assert_allclose(out["cache"][:, :-ps], mine,
                                       atol=1e-5, rtol=0)


def test_int4_step_tp2_matches_tp1(tmp_path):
    """INT4 weights (a quantized lm_head too): the port's mixed step at
    tp = 2 against the port's and the JAX package's at tp = 1, on the same
    tree, at the same tolerance."""
    ref = _jax_step(MIXED_ROWS, dict(quant="int4"), 1, np.random.default_rng(1))
    one = run_ranks(_port_step_rank, 1, MIXED_ROWS, dict(quant="int4"), ref, 1,
                    None, 1, tmp_path=tmp_path)[0]
    two = run_ranks(_port_step_rank, 2, MIXED_ROWS, dict(quant="int4"), ref, 2,
                    None, 1, tmp_path=tmp_path)[0]
    live = np.asarray(ref["live"])
    for got in (one, two):
        np.testing.assert_allclose(got["logits"][live], ref["logits"][live],
                                   atol=1e-4, rtol=1e-4)
        np.testing.assert_array_equal(got["tokens"][live], ref["tokens"][live])


# --- the head's collectives ------------------------------------------------------

HEAD_B, HEAD_V = 12, 512


def _head_inputs():
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(HEAD_B, HEAD_V)).astype(np.float32)
    # Row 0: equal maxima in both shards (the first shard must win); rows 1
    # and 2: bf16-rounded values, full of ties.
    logits[0, 7] = logits[0, HEAD_V // 2 + 3] = 9.0
    logits[1:3] = np.round(logits[1:3] * 4) / 4
    temp = rng.uniform(0.4, 1.3, HEAD_B).astype(np.float32)
    temp[:2] = 0.0
    top_p = np.where(np.arange(HEAD_B) % 3 == 0, 0.8, 1.0).astype(np.float32)
    top_k = np.where(np.arange(HEAD_B) % 4 == 1, 30, 0).astype(np.int32)
    seeds = np.arange(HEAD_B, dtype=np.uint32) + 7
    return logits, temp, top_p, top_k, seeds


def _head_rank(rank, noise):
    logits, temp, top_p, top_k, seeds = _head_inputs()
    mesh = Mesh(dp=1, tp=2, tp_rank=rank, tp_group=None)
    half = HEAD_V // 2
    local = torch.from_numpy(logits[:, rank * half:(rank + 1) * half].copy())
    tokens = torch.from_numpy(np.arange(HEAD_B, dtype=np.int32) * 41 % HEAD_V)
    knobs = dict(temperature=torch.from_numpy(temp),
                 top_p=torch.from_numpy(top_p), top_k=torch.from_numpy(top_k),
                 seeds=torch.from_numpy(seeds.view(np.int32)))
    return dict(
        greedy=sampling.exact_greedy(local, mesh).numpy(),
        sampled=sampling.sample_tokens(local, mesh=mesh,
                                       gumbel=torch.from_numpy(noise),
                                       **knobs).numpy(),
        logprobs=sampling.chosen_logprobs(local, tokens, mesh).numpy())


@pytest.fixture(scope="module")
def head(tmp_path_factory):
    """The head at tp = 2 (two ranks), at tp = 1, and the JAX package's at
    tp = 2 under shard_map, all on the same logits and noise."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JaxMesh
    from jax.sharding import PartitionSpec as P
    from swiftllm_tpu.models import sampling as jax_sampling
    logits, temp, top_p, top_k, seeds = _head_inputs()
    C = sampling.MAX_CAND
    noise = jax_gumbel(seeds, C)
    ranks = run_ranks(_head_rank, 2, noise,
                      tmp_path=tmp_path_factory.mktemp("head"))
    one = sampling.sample_tokens(
        torch.from_numpy(logits), temperature=torch.from_numpy(temp),
        top_p=torch.from_numpy(top_p), top_k=torch.from_numpy(top_k),
        seeds=torch.from_numpy(seeds.view(np.int32)),
        gumbel=torch.from_numpy(noise)).numpy()

    mesh = JaxMesh(np.asarray(jax.devices()[:2]), ("tp",))
    saved = jax_sampling.EXACT_TOPK
    jax_sampling.EXACT_TOPK = True
    try:
        def body(lg):
            return jax_sampling.sample_tokens(
                lg, temperature=jnp.asarray(temp), top_p=jnp.asarray(top_p),
                top_k=jnp.asarray(top_k), seeds=jnp.asarray(seeds),
                v_local=HEAD_V // 2, tp_axis="tp", tp_size=2,
                tp_rank=jax.lax.axis_index("tp"))
        # The JAX sampler draws its own noise over its C = 256 global
        # candidates: jax_gumbel's rows, which the port's ranks were given.
        f = jax.shard_map(body, mesh=mesh, in_specs=P(None, "tp"),
                          out_specs=P(), check_vma=False)
        jax_tokens = np.asarray(jax.jit(f)(jnp.asarray(logits)))
    finally:
        jax_sampling.EXACT_TOPK = saved
    return dict(ranks=ranks, one=one, jax=jax_tokens, logits=logits,
                temp=temp)


def test_exact_greedy_first_shard_wins_ties(head):
    logits = head["logits"]
    for out in head["ranks"]:
        assert out["greedy"][0] == 7           # not HEAD_V // 2 + 3
        np.testing.assert_array_equal(out["greedy"], np.argmax(logits, axis=1))


def test_sample_tokens_tp2_matches_tp1_and_jax(head):
    for out in head["ranks"]:
        np.testing.assert_array_equal(out["sampled"], head["one"])
        np.testing.assert_array_equal(out["sampled"], head["jax"])
    assert (head["one"] != np.argmax(head["logits"], axis=1))[head["temp"] > 0].any()


def test_chosen_logprobs_tp2_matches_jax(head):
    import jax
    logits = head["logits"]
    tokens = np.arange(HEAD_B) * 41 % HEAD_V
    want = np.asarray(jax.nn.log_softmax(logits, axis=-1))[np.arange(HEAD_B),
                                                           tokens]
    for out in head["ranks"]:
        np.testing.assert_allclose(out["logprobs"], want, atol=1e-5, rtol=0)


# --- the primary/follower round trip ---------------------------------------------

RT_MC = dict(num_layers=2, num_q_heads=4, num_kv_heads=2, hidden_size=64,
             head_dim=16, ffn_inter_dim=128, vocab_size=256,
             max_position_embeddings=512, rms_norm_eps=1e-5)
RT_EC = dict(model_path="", use_dummy=True, dtype="float32", block_size=8,
             max_tokens_in_batch=64, max_blocks_per_seq=8, num_hbm_blocks=16,
             num_cpu_blocks=8, prefill_chunk_size=16, max_batch_size=4,
             max_seqs_in_block_table=16, use_pallas=True,
             lora_paths="dummy:z,r=4")


def _round_trip_rank(rank, dp, tp, tree):
    """tests/test_multiprocess.py's round trip: a prefill step, a decode
    step fed from the device, group 0's sequence swapped out and back in,
    and one more decode step. The follower logs every op it replays."""
    ec = EngineConfig(**dict(RT_EC, dp_size=dp, tp_size=tp))
    m = LlamaModel(ec, LlamaModelConfig(**RT_MC), device="cpu")
    m.load_weights()
    lora = {k: v for k, v in m.params.items() if k == "lora_scale"}
    lora_layers = {k: v for k, v in m.params["layers"].items()
                   if k.startswith("lora_")}
    m.params = params_from_numpy(tree, "cpu", m.mesh.tp_rank, tp)
    m.params.update(lora)
    m.params["layers"].update(lora_layers)
    m.init_kvcache_and_swap()
    if not distributed.is_primary():
        ops = []
        real = distributed.exchange_op

        def logged(*a, **kw):
            op, key, flat = real(*a, **kw)
            ops.append((op, None if key is None else dataclasses.astuple(key),
                        None if flat is None else len(flat)))
            return op, key, flat
        distributed.exchange_op = logged
        tokens = []
        real_exec = m.execute_packed

        def execute(*a, **kw):
            out = real_exec(*a, **kw)
            tokens.append(out.numpy().tolist())
            return out
        m.execute_packed = execute
        distributed.follower_loop(m)
        return dict(ops=ops, tokens=tokens)
    reqs = []
    for g in range(2):
        r = Request(RawRequest("", 4))
        r.set_prompt_token_ids([(17 * g + j) % 256 for j in range(12)])
        r.seq_id, r.dp_group = g if dp == 1 else 0, g if dp > 1 else 0
        r.lora_slot = g
        reqs.append(r)

    def groups_of(n_of):
        groups = [[] for _ in range(dp)]
        for r in reqs:
            groups[r.dp_group].append(ScheduledSeq(r, n_of(r)))
        return groups

    def step(n_of):
        groups = groups_of(n_of)
        tokens, rows = m.forward([s for g in groups for s in g], groups=groups)
        for i, s in enumerate(rows):
            if s is not None:
                s.request.num_cached_tokens += s.n_tokens
                s.request.output_token_ids.append(None)
        return tokens.tolist(), [None if s is None else reqs.index(s.request)
                                 for s in rows]
    out = [step(lambda r: r.prompt_len), step(lambda r: 1)]
    m.swap_out_seqs([reqs[0]])
    swapped = m.cpu_block_mgr.num_free_blocks
    m.swap_in_seqs([reqs[0]])
    out.append(step(lambda r: 1))
    distributed.stop_followers()
    return dict(steps=out, swapped_free=swapped,
                cpu_free=m.cpu_block_mgr.num_free_blocks)


def test_primary_follower_round_trip(tmp_path):
    from swiftllm_tpu.worker.batch_builder import BucketKey as JaxBucketKey
    from swiftllm_tpu_torch.worker.batch_builder import BucketKey, packed_len
    # The header is derived from BucketKey's fields, as in the JAX package.
    assert distributed._header_len() == 1 + len(dataclasses.fields(BucketKey))
    assert [f.name for f in dataclasses.fields(BucketKey)] == \
        [f.name for f in dataclasses.fields(JaxBucketKey)]
    rng = np.random.default_rng(11)
    m = _jax_model(dict(RT_EC, use_pallas=False, lora_paths=""), RT_MC)
    tree = scaled_tree(m.params, rng)
    dp2 = run_ranks(_round_trip_rank, 2, 2, 1, tree, tmp_path=tmp_path)
    primary, follower = dp2
    # Identical tokens on both ranks, step by step.
    assert [t for t, _ in primary["steps"]] == follower["tokens"]
    ops = [op for op, _, _ in follower["ops"]]
    assert ops == [distributed.OP_STEP, distributed.OP_STEP,
                   distributed.OP_SWAP_OUT, distributed.OP_SWAP_IN,
                   distributed.OP_STEP, distributed.OP_STOP]
    for op, key, n in follower["ops"]:
        if op == distributed.OP_STEP:
            assert n == packed_len(BucketKey(*key), 2)
    # The follower's host pool allocator stayed in step: the swap-out took
    # group 0's pages (2 of 8), the swap-in gave them back.
    assert primary["swapped_free"] == 8 - 2 and primary["cpu_free"] == 8
    # The same requests in one process, one group: the same tokens a request.
    one = run_ranks(_round_trip_rank, 1, 1, 1, tree, tmp_path=tmp_path)[0]

    def per_request(steps):
        return [{r: t for t, r in zip(tokens, rows) if r is not None}
                for tokens, rows in steps]
    assert per_request(primary["steps"]) == per_request(one["steps"])


# --- the card of a launch -----------------------------------------------------------

class _FakeCards:
    """torch.cuda's current card, device guard and streams, on the CPU: the
    current card is per thread and starts at cuda:0; card i's current stream
    is the handle 1000 + i."""

    def __init__(self, monkeypatch):
        import threading
        self.local = threading.local()
        self.set_calls = []
        cards = self

        class Guard:
            def __init__(self, device):
                self.device = torch.device(device)

            def __enter__(self):
                self.prev = cards.current()
                cards.local.card = self.device

            def __exit__(self, *exc):
                cards.local.card = self.prev

        class Stream:
            def __init__(self, device):
                self.cuda_stream = 1000 + torch.device(device).index

        def set_device(device):
            cards.set_calls.append((threading.current_thread().name,
                                    torch.device(device)))
            cards.local.card = torch.device(device)
        monkeypatch.setattr(torch.cuda, "device", Guard)
        monkeypatch.setattr(torch.cuda, "set_device", set_device)
        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda device=None: Stream(device or self.current()))

    def current(self):
        return getattr(self.local, "card", torch.device("cuda:0"))


def test_launch_runs_on_the_tensors_card(monkeypatch):
    import ctypes

    from swiftllm_tpu_torch.ops import build
    cards = _FakeCards(monkeypatch)
    seen = []

    def entry_of(name):
        def fn(*args):
            seen.append((cards.current(), args[-1].value, args[:-1]))
            return seen[-1][2][0]           # the first argument: its error code
        return fn
    monkeypatch.setattr(build, "entry", entry_of)
    monkeypatch.setitem(build.launch_counts, "silu_mul", 0)
    build.launch("silu_mul", torch.device("cuda:1"), 0, 7)
    assert seen == [(torch.device("cuda:1"), 1001, (0, 7))]
    assert cards.current() == torch.device("cuda:0")    # the guard is undone
    assert build.launch_counts["silu_mul"] == 1
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        build.launch("silu_mul", torch.device("cuda:2"), 700, hint="")
    assert build.launch_counts["silu_mul"] == 1         # a failure is no launch
    assert isinstance(build.stream(torch.device("cuda:3")), ctypes.c_void_p)
    assert build.stream(torch.device("cuda:3")).value == 1003


def test_every_kernel_launches_through_launch():
    """Each wrapper launches its kernel with build.launch and its tensors'
    device, and nothing in the wrappers takes a stream or calls a kernel's
    C entry any other way."""
    import ast
    import inspect

    from swiftllm_tpu_torch.ops import (build, int4_matmul, int8_matmul,
                                        layer_ops, paged_attention, quantize_kv,
                                        swap_pages)
    launched = {}
    for mod in (paged_attention, int4_matmul, int8_matmul, quantize_kv,
                layer_ops, swap_pages):
        for node in ast.walk(ast.parse(inspect.getsource(mod))):
            if not isinstance(node, ast.Call):
                continue
            fn = ast.unparse(node.func)
            assert "current_stream" not in fn and fn != "build.stream", \
                f"{mod.__name__}: {ast.unparse(node)}"
            if fn == "build.entry":
                assert node.args[0].value in build.HELPERS, ast.unparse(node)
            if fn == "build.launch":
                device = ast.unparse(node.args[1])
                assert device.endswith(".device") or device == "dev", device
                launched[node.args[0].value] = device
    assert set(launched) == set(build.KERNELS), launched
    src = inspect.getsource(swap_pages.swap_pages)
    assert "dev = cuda[0].device" in src


def test_model_threads_take_the_models_card(monkeypatch):
    import threading

    from swiftllm_tpu_torch.server.engine import Engine
    cards = _FakeCards(monkeypatch)
    mc = LlamaModelConfig(num_layers=1, num_q_heads=2, num_kv_heads=1,
                          hidden_size=16, head_dim=8, ffn_inter_dim=32,
                          vocab_size=32, max_position_embeddings=64,
                          rms_norm_eps=1e-5)
    e = Engine(EngineConfig(use_dummy=True), mc, device="cuda:1")
    assert e._model_executor.submit(cards.current).result() == torch.device("cuda:1")
    e._model_executor.shutdown()
    e._resolve_executor.shutdown()

    class Model:
        device, dp = torch.device("cuda:2"), 1
    monkeypatch.setattr(distributed, "exchange_op",
                        lambda **kw: (distributed.OP_STOP, None, None))
    loop_card = []

    def loop():
        distributed.follower_loop(Model())
        loop_card.append(cards.current())
    t = threading.Thread(target=loop, name="follower")
    t.start()
    t.join(10)
    assert loop_card == [torch.device("cuda:2")]
    assert ("follower", torch.device("cuda:2")) in cards.set_calls


# --- LlamaModel under a 2-rank group -----------------------------------------------

def test_backend_must_be_named(monkeypatch):
    """With several ranks nothing chooses a backend for the caller, and a
    model at tp > 1 needs the group up."""
    from swiftllm_tpu_torch.parallel.mesh import make_mesh
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="name the backend"):
        distributed.initialize()
    with pytest.raises(RuntimeError, match="one process per rank"):
        make_mesh(1, 2, "cpu")
    monkeypatch.delenv("WORLD_SIZE")
    assert distributed.initialize("gloo") is False     # one process: no-op
    assert distributed.is_primary() and distributed.world_size() == 1


def build_tp2_rank(rank):
    """The REFUSED case of tests/test_torch_model.py that tp = 2 was: the
    model builds under a 2-rank group, sizes its cache and runs a step. A
    backend that cannot take the device's tensors (NCCL for a CPU model)
    is refused first."""
    import torch.distributed as dist

    from swiftllm_tpu_torch.parallel import mesh
    real = dist.get_backend
    dist.get_backend = lambda *a: "nccl"
    try:
        with pytest.raises(ValueError, match="does not take cpu tensors"):
            mesh.make_mesh(1, 2, "cpu")
    finally:
        dist.get_backend = real
    mc = LlamaModelConfig(num_layers=1, num_q_heads=2, num_kv_heads=1,
                          hidden_size=16, head_dim=8, ffn_inter_dim=32,
                          vocab_size=32, max_position_embeddings=64,
                          rms_norm_eps=1e-5)
    ec = EngineConfig(use_dummy=True, preemption_mode="recompute", tp_size=2)
    m = LlamaModel(ec, mc, device="cpu")
    m.init_kvcache_and_swap(2)
    m.load_weights()
    shape = tuple(m.kv_cache.shape)
    if distributed.is_primary():
        r = Request(RawRequest("", 8))
        r.set_prompt_token_ids([3, 1, 4, 1, 5])
        r.seq_id = 0
        tokens, rows = m.forward([ScheduledSeq(r, r.prompt_len)])
        distributed.stop_followers()
        return dict(shape=shape, token=int(tokens[0]), mesh=(m.dp, m.tp))
    distributed.follower_loop(m)
    return dict(shape=shape, mesh=(m.dp, m.tp), tp_rank=m.mesh.tp_rank)
