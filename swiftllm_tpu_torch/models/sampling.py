"""Token sampling over vocab-sharded logits, for the PyTorch port.

Port of ``swiftllm_tpu/models/sampling.py``: greedy rows stay exact over the
full vocab (each shard's maximum and argmax, one [tp, 2, B] gather, the
first shard winning a tie); sampling rows draw from the global top
``MAX_CAND`` candidates (each shard's top candidates, one gather, the global
top) with temperature, top-k, top-p and a Gumbel-max draw, redundantly on
every tp rank. All rows share one code path; ``temperature <= 0`` selects
the greedy result. At tp = 1 (``mesh`` SINGLE) nothing is gathered.

Two things differ from the JAX package, both on purpose:

- The candidates are the EXACT top ``MAX_CAND`` (what ``SWIFTLLM_EXACT_TOPK=1``
  selects there; its default ``approx_max_k`` is a TPU mechanism), in
  ``lax.top_k``'s order: descending, the lower index first on ties.
  ``torch.topk`` promises no tie order, and logits that were bf16 tie often,
  so ``top_candidates`` sorts one unique integer key per (value, index).
- The Gumbel noise is this module's own stateless hash of (seed, candidate
  index), not ``jax.random``'s threefry stream: the distribution is the
  same, the draws are not. ``sample_tokens`` takes the noise as an argument,
  so a test can inject the JAX package's. It is drawn over the GLOBAL
  candidates, so a seed draws the same token at any tp.

Everything is tensor operations on the logits' device, with no generator
state and no host synchronisation: the draw of seed ``s0 + s`` is the same
whether the host or ``advance_decode_batch`` added the ``s``.
"""

from __future__ import annotations

import torch

from swiftllm_tpu_torch.parallel.distributed import (all_reduce_tp, gather_tp,
                                                     pmax_tp)
from swiftllm_tpu_torch.parallel.mesh import SINGLE, Mesh

MAX_CAND = 256

_M32 = 0xFFFFFFFF


def exact_greedy(logits: torch.Tensor, mesh: Mesh = SINGLE) -> torch.Tensor:
    """Argmax over the (tp-sharded) vocab, the first index on ties (as
    ``jnp.argmax``; across shards the first shard). logits: f32[B, V_local]
    -> i32[B] global ids."""
    local_arg = torch.argmax(logits, dim=-1).to(torch.int32)
    if mesh.tp == 1:
        return local_arg
    v_local = logits.shape[-1]
    assert mesh.tp * v_local < 1 << 24, "vocab ids must be exact in f32"
    # One gather of (max, argmax) pairs; the ids ride exactly in f32.
    pairs = gather_tp(torch.stack([logits.amax(dim=-1).float(),
                                   local_arg.float()]), mesh)   # [tp, 2, B]
    win = torch.argmax(pairs[:, 0], dim=0)                      # [B]
    arg = pairs[:, 1].gather(0, win[None])[0].to(torch.int32)
    return arg + win.to(torch.int32) * v_local


# Rows whose candidate keys are built at once. A key takes 8 bytes a vocab
# entry, and a verify step's head samples rows x q bucket positions (1,024
# rows of 128,256 at 8B: about 4 GB of keys and their temporaries at once).
TOPK_ROWS = 128


def top_candidates(logits: torch.Tensor, k: int):
    """The k largest logits of each row, descending, the lower index first
    among equal values (``jax.lax.top_k``'s order), as (vals f32[B, k],
    idx i64[B, k]).

    Each (value, index) becomes one int64 key: the float's bits mapped to an
    integer that orders as the float does, in the high word, and V-1-index in
    the low word. The keys are distinct, so ``torch.topk`` has no tie to
    break and the order is the same on every device. ``TOPK_ROWS`` rows at
    a time, which bounds the step's scratch and its graph's pool; the rows
    are independent, so the result is the same."""
    if logits.shape[0] > TOPK_ROWS:
        parts = [top_candidates(block, k)
                 for block in logits.split(TOPK_ROWS)]
        return (torch.cat([v for v, _ in parts]),
                torch.cat([i for _, i in parts]))
    V = logits.shape[-1]
    bits = (logits.float() + 0.0).view(torch.int32)        # -0.0 -> +0.0
    ordered = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF).long()
    col = torch.arange(V - 1, -1, -1, device=logits.device)
    keys = ordered * (1 << 32) + col
    low = torch.topk(keys, k, dim=-1).values & _M32
    idx = V - 1 - low
    return torch.gather(logits.float(), 1, idx), idx


def _mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """x * m mod 2^32 for int64 x in [0, 2^32), through 16-bit halves of m so
    that no product leaves int64's range."""
    return (x * (m & 0xFFFF) + (((x * (m >> 16)) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """The 32-bit finalizer of MurmurHash3 on int64 x in [0, 2^32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def gumbel_noise(seeds: torch.Tensor, n: int) -> torch.Tensor:
    """Standard Gumbel noise f32[B, n], a stateless function of (seeds[b],
    column): two rounds of a 32-bit integer hash, 23 bits of it as a uniform
    in (0, 1), then -log(-log(u)). ``seeds`` holds u32 values in any integer
    dtype (int32 bits as the packed batch carries them, or wider); only the
    low 32 bits count. The hash bits are the same on the CPU and on the
    card; the two logs are each device's own."""
    s = _mix32((seeds.long() & _M32) ^ 0x9E3779B9)
    col = torch.arange(n, device=seeds.device)
    x = _mix32((s[:, None] + _mul32(col, 0x9E3779B1)[None, :]) & _M32)
    u = ((x >> 9).float() + 0.5) * (1.0 / (1 << 23))
    return -torch.log(-torch.log(u))


def sample_tokens(logits: torch.Tensor, *, temperature: torch.Tensor,
                  top_p: torch.Tensor, top_k: torch.Tensor,
                  seeds: torch.Tensor, mesh: Mesh = SINGLE,
                  gumbel: torch.Tensor | None = None) -> torch.Tensor:
    """i32[B] sampled token ids (global vocab ids).

    logits f32[B, V_local] (vocab padding already -inf); temperature f32[B]
    (<= 0: greedy), top_p f32[B] (1.0: off), top_k i32[B] (0: off), seeds
    u32[B] (one per row and step, see ``gumbel_noise``). ``gumbel`` f32[B,
    C] replaces the module's own noise, C = min(MAX_CAND, tp *
    min(MAX_CAND, V_local)) candidates."""
    greedy = exact_greedy(logits, mesh)
    v_local = logits.shape[-1]
    vals, gids = top_candidates(logits, min(MAX_CAND, v_local))
    if mesh.tp > 1:
        # Every shard's candidates, shard-major, ids exact in f32; the global
        # top keeps the lower position, so the lower id, first on ties.
        both = gather_tp(torch.stack([vals, (gids + mesh.tp_rank * v_local)
                                      .float()]), mesh)          # [tp, 2, B, k]
        vals = both[:, 0].permute(1, 0, 2).flatten(1)            # [B, tp*k]
        all_ids = both[:, 1].permute(1, 0, 2).flatten(1)
        vals, pos = top_candidates(vals, min(MAX_CAND, vals.shape[1]))
        gids = torch.gather(all_ids, 1, pos).long()
    C = vals.shape[1]                                      # descending

    scaled = vals / temperature.clamp_min(1e-6)[:, None]

    # top-k: the candidates are sorted, so rank == column.
    ranks = torch.arange(C, device=logits.device)[None, :]
    k_eff = torch.where(top_k > 0, top_k.clamp_max(C), C)[:, None]
    neg_inf = torch.full_like(scaled, float("-inf"))
    masked = torch.where(ranks < k_eff, scaled, neg_inf)

    # top-p: the smallest prefix whose mass reaches top_p (a candidate stays
    # while the mass strictly before it is below top_p).
    probs = torch.softmax(masked, dim=-1)
    cum_prev = torch.cumsum(probs, dim=-1) - probs
    masked = torch.where(cum_prev < top_p[:, None], masked, neg_inf)

    if gumbel is None:
        gumbel = gumbel_noise(seeds, C)
    choice = torch.argmax(masked + gumbel, dim=-1)
    sampled = torch.gather(gids, 1, choice[:, None])[:, 0].to(torch.int32)
    return torch.where(temperature > 0, sampled, greedy)


def chosen_logprobs(logits: torch.Tensor, tokens: torch.Tensor,
                    mesh: Mesh = SINGLE) -> torch.Tensor:
    """Raw log-softmax of the chosen token of each row (whatever the
    temperature): logits f32[B, V_local], tokens i32[B] global ids -> f32[B].
    The logsumexp is written out as the JAX package writes it (max, sum of
    exp, log); over the tp-sharded vocab that is a pmax, then one sum of
    the shards' (sum of exp, the chosen logit where the shard holds it)."""
    gmax = pmax_tp(logits.max(dim=-1).values, mesh)
    sumexp = torch.exp(logits - gmax[:, None]).sum(dim=-1)
    V = logits.shape[-1]
    local = tokens.long()
    if mesh.tp > 1:
        local = local - mesh.tp_rank * V
    picked = torch.gather(logits, 1, local.clamp(0, V - 1)[:, None])[:, 0]
    if mesh.tp > 1:
        sumexp, picked = all_reduce_tp(torch.stack([
            sumexp, torch.where((local >= 0) & (local < V), picked, 0.0)]), mesh)
    return picked - (gmax + torch.log(sumexp))
