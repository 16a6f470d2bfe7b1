"""The port's batch builder against the JAX package's: for the same scheduled
sequences, the packed step buffers must be equal byte for byte, and the two
block managers must hand out the same pages; the fields the step derives from
the buffer must agree too. (Exact: both are integer code over the same
inputs.)"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401  (forces the JAX CPU backend)

from swiftllm_tpu.config import EngineConfig as JaxEngineConfig
from swiftllm_tpu.models.llama import unpack_step_batch as jax_unpack_step_batch
from swiftllm_tpu.server.scheduler import ScheduledSeq as JaxScheduledSeq
from swiftllm_tpu.server.structs import RawRequest as JaxRawRequest
from swiftllm_tpu.server.structs import Request as JaxRequest
from swiftllm_tpu.worker import batch_builder as jax_bb
from swiftllm_tpu.worker.block_manager import BlockManager as JaxBlockManager
from swiftllm_tpu_torch.config import EngineConfig
from swiftllm_tpu_torch.models.llama import unpack_step_batch
from swiftllm_tpu_torch.server.scheduler import ScheduledSeq
from swiftllm_tpu_torch.server.structs import RawRequest, Request
from swiftllm_tpu_torch.worker import batch_builder as bb
from swiftllm_tpu_torch.worker.block_manager import BlockManager

CFG = dict(block_size=8, max_blocks_per_seq=16, max_tokens_in_batch=128,
           max_batch_size=8, prefill_chunk_size=32, max_seqs_in_block_table=16,
           num_hbm_blocks=64, use_pallas=True)


def build(pkg, specs):
    """specs: (prompt_len, cached, outputs, n_tokens) per row. Returns the
    packed buffer, the bucket key and the block table after the build."""
    if pkg == "jax":
        cfg, Req, Raw, Sched, Mgr = (JaxEngineConfig(**CFG), JaxRequest,
                                     JaxRawRequest, JaxScheduledSeq,
                                     JaxBlockManager)
        builder = jax_bb
    else:
        cfg, Req, Raw, Sched, Mgr = (EngineConfig(**CFG), Request, RawRequest,
                                     ScheduledSeq, BlockManager)
        builder = bb
    mgr = Mgr("hbm0", 64, cfg.block_size, cfg.max_seqs_in_block_table,
              cfg.max_blocks_per_seq)
    sched = []
    for i, (plen, cached, outputs, n) in enumerate(specs):
        r = Req(Raw("", 8))
        r.set_prompt_token_ids([(7 * i + j) % 100 + 1 for j in range(plen)])
        r.output_token_ids = list(outputs)
        r.num_cached_tokens = cached
        r.seq_id = 2 * i + 1
        # Pinned: by default each package numbers requests with its own
        # process-wide counter, which other tests advance.
        r.sampling_seed = 1000 + i
        if cached:
            mgr.allocate_for_seq(r.seq_id, cached)
        sched.append(Sched(r, n))
    batch, key, rows = builder.build_step_batch([sched], [mgr], cfg)
    return builder.pack_step_batch(batch, 1), key, mgr.block_table.copy()


SPECS = pytest.mark.parametrize("specs", [
    # decode-only fast path, one token still on the device (None)
    [(5, 5, [3], 1), (9, 10, [4, None], 1), (3, 3, [None], 1)],
    # mixed: decode rows, a fresh prompt, a chunked-prefill tail
    [(12, 12, [2], 1), (20, 0, [], 20), (40, 16, [], 16), (6, 7, [1, 5], 1)],
    # prefill only, whole prompts of odd lengths
    [(3, 0, [], 3), (17, 0, [], 17)],
], ids=["decode_only", "mixed", "prefill_only"])


@SPECS
def test_packed_buffers_equal(specs):
    flat_j, key_j, table_j = build("jax", specs)
    flat_t, key_t, table_t = build("torch", specs)
    assert (key_t.tokens, key_t.rows, key_t.pages, key_t.q_len) == \
        (key_j.tokens, key_j.rows, key_j.pages, key_j.q_len)
    assert bb.packed_len(key_t) == jax_bb.packed_len(key_j) == len(flat_t)
    assert flat_t.dtype == flat_j.dtype == np.int32
    assert flat_t.tobytes() == flat_j.tobytes()
    np.testing.assert_array_equal(table_t, table_j)


@SPECS
def test_unpacked_fields_match_jax(specs):
    """The fields the step derives on the device from the packed buffer equal
    the JAX package's, bit for bit, with one intended difference: tokens that
    the span write must skip (decode-kind and pad) get slot -1 in the port's
    kv_slots_scatter, where the JAX package names the garbage slot."""
    flat, key, _ = build("torch", specs)
    garbage = 64 * CFG["block_size"]
    kw = dict(page_size=CFG["block_size"], garbage_slot=garbage)
    want = jax_unpack_step_batch(jnp.asarray(flat), key.tokens, key.rows,
                                 key.pages, **kw)
    got = unpack_step_batch(torch.from_numpy(flat), key.tokens, key.rows,
                            key.pages, **kw)
    for f in dataclasses.fields(got):
        g, w = getattr(got, f.name).numpy(), np.asarray(getattr(want, f.name))
        if f.name == "kv_slots_scatter":
            w = np.where(w == garbage, -1, w)
        assert g.shape == w.shape and g.tobytes() == w.tobytes(), f.name
