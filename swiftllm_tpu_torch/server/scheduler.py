"""Iteration-level scheduler.

Capability parity with the reference's strict-FCFS scheduler with preemptive
swap-out (swiftllm/server/scheduler.py:33-144), with the SARATHI piggybacking
the reference left as a comment (scheduler.py:92-99) actually enabled: every
step builds ONE mixed token batch — one decode token for every running
sequence, plus prefill chunks from in-flight and newly admitted prompts, under
a flat-token budget. This matches the data plane, which consumes a single
flattened token batch per step.

Data parallelism (beyond-reference, SURVEY §2.5 implications): with dp > 1 the
step batch is a [dp, ...] stack and each dp group owns its own KV page pool,
batch rows, and token budget. A request is pinned to a group at admission
(``Request.dp_group``) and stays there for life — its KV pages live in that
group's pool. Admission is still strict global FCFS: the queue head goes to
the group with the most free pages; if it fits nowhere, nothing is admitted.

Set ``enable_chunked_prefill=False`` for the reference's exact policy shape
(whole-prompt prefill-only batches take priority; otherwise pure decode
batches; dp == 1 only).
"""

from __future__ import annotations

import math

import dataclasses
from collections import deque

from swiftllm_tpu_torch.config import EngineConfig, LlamaModelConfig
from swiftllm_tpu_torch.server.structs import Request
from swiftllm_tpu_torch.utils import cdiv, next_power_of_2, tile_q_for


class RequestIdManager:
    """Recycles sequence ids in [0, max_id) — each id doubles as the request's
    row in its dp group's KV block table (reference scheduler.py:8-30)."""

    def __init__(self, max_id: int):
        self.max_id = max_id
        self.available_ids = list(range(max_id - 1, -1, -1))

    def get_id(self) -> int:
        if not self.available_ids:
            raise RuntimeError(
                "No more available request ids; increase `max_seqs_in_block_table`")
        return self.available_ids.pop()

    def free_id(self, req_id: int):
        self.available_ids.append(req_id)

    def free_ids(self, req_ids: list[int]):
        self.available_ids.extend(req_ids)


@dataclasses.dataclass
class ScheduledSeq:
    """One sequence's share of a step: feed `n_tokens` new tokens to the model.

    ``drafts`` (speculative decoding, server/spec.py): host-proposed draft
    tokens verified this step. When set, n_tokens == 1 + len(drafts) — the
    span is [next real token] + drafts — and the engine resolves acceptance
    before the next scheduling round."""
    request: Request
    n_tokens: int
    drafts: tuple[int, ...] = ()

    @property
    def samples_token(self) -> bool:
        """Whether this step's last fed token is the sequence's current end, i.e.
        this step produces a sampled token for the request. (Spec rows are
        handled separately: they always produce 1..n_tokens values.)"""
        r = self.request
        return (not self.drafts
                and r.num_cached_tokens + self.n_tokens == r.total_len)


@dataclasses.dataclass
class ScheduleDecision:
    batch: list[ScheduledSeq]           # flat, group-major
    swap_in: list[Request]
    swap_out: list[Request]
    groups: list[list[ScheduledSeq]] | None = None   # per-dp-group view
    # Preempt-by-recompute victims: pages freed, requeued to the waiting
    # head; their prompt+generated tokens re-prefill on re-admission (cheap
    # when prefix caching still holds their pages).
    recompute: list[Request] = dataclasses.field(default_factory=list)
    # Multi-step decode: run the batch through S chained decode steps in ONE
    # program (config.multi_step_decode; 1 = plain single step). Set only
    # when every row is a 1-token decode with >= S output budget and the
    # group page pools cover S new tokens per row.
    steps: int = 1

    @property
    def total_tokens(self) -> int:
        return sum(s.n_tokens for s in self.batch)


class Scheduler:
    def __init__(self, model_config: LlamaModelConfig, engine_config: EngineConfig,
                 num_hbm_blocks: int, dp_size: int | None = None):
        """``num_hbm_blocks`` is the page budget PER dp group (each group owns
        an equal slice of the pool — worker/model.py allocates one BlockManager
        per group with exactly this many pages)."""
        self.model_config = model_config
        self.engine_config = engine_config
        self.num_hbm_blocks = num_hbm_blocks
        self.dp = dp_size if dp_size is not None else engine_config.dp_size

        self.waiting_q: deque[Request] = deque()
        self.running_qs: list[list[Request]] = [[] for _ in range(self.dp)]
        self.swapped_qs: list[deque[Request]] = [deque() for _ in range(self.dp)]
        self.num_free_cpu_blocks = engine_config.num_cpu_blocks
        # Seq ids are per-group block-table rows (and per-group feedback
        # slots), so each group recycles its own id space.
        self.id_managers = [RequestIdManager(engine_config.max_seqs_in_block_table)
                            for _ in range(self.dp)]
        # Automatic prefix caching: the engine injects model.match_prefix
        # here. Called at admission (seq_id/dp_group just assigned, strictly
        # before the step batch is built) so the first scheduled chunk covers
        # only the uncached prompt tail.
        self.prefix_matcher = None

    # --- dp == 1 compatibility views (reference-shaped API) ---------------------
    @property
    def request_id_manager(self) -> RequestIdManager:
        assert self.dp == 1, "use id_manager_for(request) with dp > 1"
        return self.id_managers[0]

    def id_manager_for(self, req: Request) -> RequestIdManager:
        return self.id_managers[getattr(req, "dp_group", 0)]

    @property
    def running_q(self) -> list[Request]:
        return [r for q in self.running_qs for r in q]

    @running_q.setter
    def running_q(self, value: list[Request]):
        keep = set(id(r) for r in value)
        for g in range(self.dp):
            self.running_qs[g] = [r for r in self.running_qs[g] if id(r) in keep]

    @property
    def swapped_q(self) -> deque[Request]:
        if self.dp == 1:
            return self.swapped_qs[0]
        return deque(r for q in self.swapped_qs for r in q)

    @swapped_q.setter
    def swapped_q(self, value):
        keep = set(id(r) for r in value)
        for g in range(self.dp):
            self.swapped_qs[g] = deque(r for r in self.swapped_qs[g]
                                       if id(r) in keep)

    # --- helpers ---------------------------------------------------------------
    def _blocks_for_len(self, n_tokens: int) -> int:
        return cdiv(n_tokens, self.engine_config.block_size)

    def _blocks_held(self, req: Request) -> int:
        """Pages currently held (in HBM or swap) by a request."""
        return self._blocks_for_len(req.num_cached_tokens)

    def _blocks_after(self, req: Request, n_new: int) -> int:
        return self._blocks_for_len(req.num_cached_tokens + n_new)

    # --- event hooks (reference scheduler.py:62-66,131-144) ---------------------
    def on_requests_arrival(self, requests: list[Request]):
        self.waiting_q.extend(requests)

    def on_batch_finish(self, batch: list[ScheduledSeq], model=None):
        """Retire finished requests after a step (reference scheduler.py:131-144).

        Releases each finished request's seq id (and, when ``model`` is given,
        its KV pages) exactly once — guarded by ``Request.resources_freed``,
        the same flag the Engine's pipelined release path uses, so direct-API
        and engine-driven callers can never double-free ids."""
        for s in batch:
            r = s.request
            if r.is_finished() and not r.resources_freed and r.seq_id >= 0:
                r.resources_freed = True
                if model is not None:
                    model.free_seqs_resources([r])
                self.id_manager_for(r).free_id(r.seq_id)
        for g in range(self.dp):
            self.running_qs[g] = [r for r in self.running_qs[g]
                                  if not r.is_finished()]

    def on_swap_out_done(self, requests: list[Request]):
        for r in requests:
            self.num_free_cpu_blocks -= self._blocks_held(r)
        assert self.num_free_cpu_blocks >= 0, "CPU swap space exhausted"

    def on_swap_in_done(self, requests: list[Request]):
        for r in requests:
            self.num_free_cpu_blocks += self._blocks_held(r)

    def has_pending(self) -> bool:
        return bool(self.waiting_q or any(self.running_qs)
                    or any(self.swapped_qs))

    def reap_terminal(self, release_fn) -> None:
        """Remove finished/aborted requests from every queue, calling
        ``release_fn(request)`` for each removed request that may hold
        resources. Used by the Engine before every scheduling decision (in
        the pipelined loop, finish-by-count is known at dispatch time while
        token VALUES resolve one step later)."""
        def terminal(r: Request) -> bool:
            return r.aborted or r.is_finished()

        for g in range(self.dp):
            for r in self.running_qs[g]:
                if terminal(r):
                    release_fn(r)
                    if r.aborted:
                        r.finished_event.set()
            self.running_qs[g] = [r for r in self.running_qs[g]
                                  if not terminal(r)]
            if any(terminal(r) for r in self.swapped_qs[g]):
                for r in self.swapped_qs[g]:
                    if terminal(r):
                        release_fn(r)
                        r.finished_event.set()
                self.swapped_qs[g] = deque(r for r in self.swapped_qs[g]
                                           if not terminal(r))
        if any(r.aborted for r in self.waiting_q):
            for r in self.waiting_q:
                if r.aborted:
                    r.finished_event.set()
            self.waiting_q = deque(r for r in self.waiting_q if not r.aborted)

    # --- the policy --------------------------------------------------------------
    def get_next_batch(self) -> ScheduleDecision:
        cfg = self.engine_config
        swap_out: list[Request] = []
        swap_in: list[Request] = []
        recompute: list[Request] = []
        # Swap preemption needs host swap space; without it (num_cpu_blocks=0,
        # or preemption_mode="recompute") victims recompute instead: pages
        # freed, requeued at the waiting head, prompt+generated re-prefilled
        # on re-admission. No device↔host copies — and with prefix caching on
        # the victim's full prompt pages are usually still resident.
        by_recompute = (cfg.preemption_mode == "recompute"
                        or cfg.num_cpu_blocks <= 0)
        groups: list[list[ScheduledSeq]] = [[] for _ in range(self.dp)]
        blocks_used = [0] * self.dp
        self._group_state: dict[int, dict] = {}

        for g in range(self.dp):
            # 1. Preempt the FCFS tail while this group's running set cannot
            #    even decode one token each within its page / row budget
            #    (reference scheduler.py:105-114).
            run = self.running_qs[g]

            def running_blocks_needed():
                return sum(self._blocks_after(r, 1) for r in run)

            g_swap_out: list[Request] = []
            while run and (len(run) > cfg.max_batch_size
                           or running_blocks_needed() > self.num_hbm_blocks):
                g_swap_out.append(run.pop())
            if g_swap_out and by_recompute:
                # FCFS order back at the waiting head (oldest first).
                for r in g_swap_out:   # g_swap_out is newest-first
                    self.waiting_q.appendleft(r)
                recompute.extend(reversed(g_swap_out))
            elif g_swap_out:
                self.swapped_qs[g].extendleft(reversed(g_swap_out))
                # Oldest-preempted-first for the engine's copy loop, matching
                # the reference's reversed() return (scheduler.py:129).
                swap_out.extend(reversed(g_swap_out))
            blocks_used[g] = running_blocks_needed()

            # 2. If nothing was just preempted, swap requests back in, FCFS
            #    (reference scheduler.py:116-127).
            if not g_swap_out:
                while self.swapped_qs[g]:
                    cand = self.swapped_qs[g][0]
                    need = self._blocks_after(cand, 1)
                    if (len(run) + 1 <= cfg.max_batch_size
                            and blocks_used[g] + need <= self.num_hbm_blocks):
                        self.swapped_qs[g].popleft()
                        run.append(cand)
                        swap_in.append(cand)
                        blocks_used[g] += need
                    else:
                        break

        # 3. Build the token batch.
        if cfg.enable_chunked_prefill:
            for g in range(self.dp):
                groups[g] = self._build_group_batch(g, blocks_used)
            if not swap_out and not recompute:
                # recompute victims at the waiting head aren't reset (pages
                # freed, seq id released) until the engine executes this
                # decision — admission waits one round.
                self._admit_fcfs(groups, blocks_used)
        else:
            assert self.dp == 1, \
                "reference-style (non-chunked) scheduling supports dp == 1 only"
            allow = (not self.swapped_qs[0] and not swap_out and not swap_in
                     and not recompute)
            groups[0] = self._build_reference_style_batch(
                blocks_used[0], allow_admission=allow)

        batch = [s for g in groups for s in g]
        return ScheduleDecision(batch=batch, swap_in=swap_in,
                                swap_out=swap_out, groups=groups,
                                recompute=recompute,
                                steps=self._multi_step_for(groups, blocks_used))

    def _multi_step_for(self, groups: list[list[ScheduledSeq]],
                        blocks_used: list[int]) -> int:
        """S > 1 when the step qualifies for multi-step decode: every row a
        plain 1-token decode (no prefill chunks, no spec drafts), every
        request with at least S tokens of output budget left (so no row
        finishes mid-span), and every group's page pool covering S new
        tokens per row. Anything else — including an empty batch — is a
        plain single step."""
        S = self.engine_config.multi_step_decode
        if S <= 1 or not any(groups):
            return 1
        for g, group in enumerate(groups):
            extra = 0
            for s in group:
                r = s.request
                if (s.n_tokens != 1 or s.drafts
                        or r.output_len - len(r.output_token_ids) < S):
                    return 1
                extra += self._blocks_after(r, S) - self._blocks_after(r, 1)
            if blocks_used[g] + extra > self.num_hbm_blocks:
                return 1
            blocks_used[g] += extra
        return S

    def _chunk_align(self) -> int:
        """Tile-padding unit for prefill chunks (see _build_group_batch)."""
        cfg = self.engine_config
        return tile_q_for(next_power_of_2(
            min(cfg.prefill_chunk_size, cfg.max_tokens_in_batch)))

    def _build_group_batch(self, g: int, blocks_used: list[int]) -> list[ScheduledSeq]:
        """TRUE SARATHI mixed batch for dp group g: one decode token per
        running decode-stage seq PLUS prefill chunks for in-flight prompts.
        The data plane routes 1-token rows through the fused decode kernel and
        multi-token rows through the prefill kernel within the same step,
        so decodes never stall behind prefill steps (the
        reference left this piggybacking as a comment, scheduler.py:92-99)."""
        cfg = self.engine_config
        batch: list[ScheduledSeq] = []

        # Decode tokens first: TPOT is latency-critical; prefill fills the rest.
        run = self.running_qs[g]
        decode_rows = [r for r in run if not r.is_prefill_stage()]
        # Speculative drafting: pure-decode steady state only — a spec step's
        # q bucket is pinned small (spec_k+1), so prefill chunks never share a
        # step with drafts, and pending admissions take priority (TTFT).
        spec_on = (cfg.enable_spec_decode
                   and len(decode_rows) == len(run)
                   and len(decode_rows) <= cfg.spec_max_rows
                   and not self.waiting_q and not self.swapped_qs[g])
        if spec_on:
            spec_state = {"budget": max(cfg.max_tokens_in_batch,
                                        cfg.max_batch_size),
                          "align": tile_q_for(next_power_of_2(cfg.spec_k + 1)),
                          "n_plain": len(decode_rows), "n_spec": 0}
        for r in decode_rows:
            drafts = (self._propose_drafts(r, g, blocks_used, spec_state)
                      if spec_on else ())
            batch.append(ScheduledSeq(r, 1 + len(drafts), drafts=drafts))

        # Tile-padding-aware token budget: in a mixed step the batch builder
        # pads the decode block and every prefill chunk up to the attention
        # kernel's q tile, so admission must be checked in PADDED tokens or a
        # step could silently need a larger compiled program than planned.
        align = self._chunk_align()
        # A budget smaller than one tile would deadlock admission; the config
        # guarantees the largest token bucket covers at least one tile.
        state = {"n_dec": len(decode_rows), "pre_padded": 0, "align": align,
                 "budget": max(cfg.max_tokens_in_batch, align)}

        # (a) grow in-flight prefill chunks, FCFS.
        for r in run:
            if not r.is_prefill_stage():
                continue
            n = min(r.num_uncached_tokens(), cfg.prefill_chunk_size,
                    self._padded_avail(state))
            n = self._page_align_chunk(r, n)
            if n <= 0:
                continue
            extra = self._blocks_after(r, n) - self._blocks_after(r, 1)
            if blocks_used[g] + extra > self.num_hbm_blocks:
                # Shrink the chunk to what fits in the pages we can actually get.
                avail_pages = (self._blocks_after(r, 1)
                               + max(0, self.num_hbm_blocks - blocks_used[g]))
                n = self._page_align_chunk(
                    r, min(n, avail_pages * cfg.block_size
                           - r.num_cached_tokens))
                if n <= 0:
                    continue
                extra = self._blocks_after(r, n) - self._blocks_after(r, 1)
            batch.append(ScheduledSeq(r, n))
            state["pre_padded"] += cdiv(n, align) * align
            blocks_used[g] += extra
        # Stash the budget state for the admission pass.
        self._group_state[g] = state
        return batch

    def spec_regime(self) -> bool:
        """True when the next step would be eligible for speculative drafts
        (pure decode, small batch, nothing waiting): the engine drains its
        async pipeline first so token values are resolved for drafting."""
        cfg = self.engine_config
        if not cfg.enable_spec_decode or self.waiting_q:
            return False
        any_run = False
        for g in range(self.dp):
            run = self.running_qs[g]
            if self.swapped_qs[g]:
                return False
            if any(r.is_prefill_stage() for r in run):
                return False
            if len(run) > cfg.spec_max_rows:
                return False
            any_run = any_run or bool(run)
        return any_run

    def _adaptive_spec_cap(self, r: Request) -> int:
        """Acceptance-adaptive draft budget for one request.

        A spec step costs a pipeline flush (drafting needs RESOLVED tokens),
        so a request whose drafts keep missing must stop paying for
        verification every step. Policy: start optimistic; once enough
        history exists (2*spec_k drafted), scale the budget to the realized
        acceptance rate, and below spec_min_acceptance draft only every
        spec_probe_interval-th opportunity (a 2-token probe, with the history
        halved at each probe so a regime change — e.g. the text turning
        repetitive — re-enables full drafting within a few probes).
        Capability delta vs the reference (strictly 1 token/step,
        swiftllm/server/engine.py:16-181) and vs static spec_k (r3 verdict
        item 4c)."""
        cfg = self.engine_config
        if r.spec_drafted < 2 * cfg.spec_k:
            return cfg.spec_k                       # optimistic start
        acc = r.spec_accepted / r.spec_drafted
        if acc < cfg.spec_min_acceptance:
            r.spec_tries += 1
            if r.spec_tries % cfg.spec_probe_interval:
                return 0                            # suppressed
            r.spec_drafted //= 2                    # probe: decay history
            r.spec_accepted //= 2
            return 2
        return max(1, math.ceil(acc * cfg.spec_k))

    def _propose_drafts(self, r: Request, g: int, blocks_used: list[int],
                        state: dict) -> tuple[int, ...]:
        """Prompt-lookup drafts for one greedy decode row (server/spec.py),
        bounded by the remaining output budget, the sequence-length cap, the
        step's padded-token budget, and the group's page pool."""
        cfg = self.engine_config
        if r.temperature > 0:     # lossless speculation needs greedy verify
            return ()
        cap = min(cfg.spec_k,
                  r.output_len - len(r.output_token_ids) - 1,
                  cfg.max_seq_len - (r.num_cached_tokens + 1))
        if cfg.spec_adaptive:
            cap = min(cap, self._adaptive_spec_cap(r))
        if cap <= 0:
            return ()
        # Token budget: a spec row leaves the densely packed decode block and
        # becomes an align-padded span in the flat token stream.
        a = state["align"]
        cost = cdiv(state["n_plain"] - 1, a) * a + (state["n_spec"] + 1) * a
        if cost > state["budget"]:
            return ()
        from swiftllm_tpu_torch.server import spec as spec_mod
        st = spec_mod.sync_state(r)
        if st is None:            # a pipelined token value is still on device
            return ()
        drafts = spec_mod.propose(st.view(), cap, cfg.spec_ngram_max,
                                  cfg.spec_ngram_min)
        if not drafts:
            return ()
        extra = (self._blocks_after(r, 1 + len(drafts))
                 - self._blocks_after(r, 1))
        if extra and blocks_used[g] + extra > self.num_hbm_blocks:
            return ()
        blocks_used[g] += extra
        state["n_plain"] -= 1
        state["n_spec"] += 1
        return tuple(drafts)

    def _page_align_chunk(self, r: Request, n: int) -> int:
        """Round a prefill chunk DOWN to a page multiple unless it finishes
        the request's uncached prefill. Keeps every chunk's START page-aligned
        — the contract of the JAX package's tile kernel (its fused span-KV
        write). The port's store_kv kernel writes any slot, but the policy
        is kept so that both packages schedule alike. The final (any-length)
        chunk never misaligns a successor."""
        if n >= r.num_uncached_tokens():
            return min(n, r.num_uncached_tokens())
        bs = self.engine_config.block_size
        return (n // bs) * bs

    @staticmethod
    def _padded_avail(state: dict) -> int:
        """Largest tile-padded prefill chunk that still fits a group's budget."""
        align = state["align"]
        dec_pad = cdiv(state["n_dec"], align) * align
        free = state["budget"] - dec_pad - state["pre_padded"]
        avail = (free // align) * align
        if avail <= 0 and state["pre_padded"] == 0:
            # Liveness: decode-block padding alone must never starve prefill
            # forever (tiny budgets where align ≈ budget). One chunk per step
            # minimum; the config guarantees a token bucket covering a full
            # decode block plus one tile.
            return align
        return avail

    def _admit_fcfs(self, groups: list[list[ScheduledSeq]],
                    blocks_used: list[int]):
        """Admit new requests, strict global FCFS: the queue head is pinned to
        the group with the most free pages; if it fits nowhere, nothing later
        in the queue is considered (reference's no-skip-ahead)."""
        cfg = self.engine_config
        # Admission pauses while anything sits swapped out (the reference's
        # rule: drain the swap backlog before taking new work).
        if any(self.swapped_qs):
            return
        while self.waiting_q:
            cand = self.waiting_q[0]
            # The whole prompt (+1 for the first sampled token) must be able
            # to fit in ONE group's pool alone, else it can never run.
            if self._blocks_for_len(cand.prompt_len + 1) > self.num_hbm_blocks:
                break
            best, best_free = -1, -1
            for g in range(self.dp):
                st = self._group_state[g]
                n = min(cand.prompt_len, cfg.prefill_chunk_size,
                        self._padded_avail(st))
                if n < min(cand.prompt_len, cfg.prefill_chunk_size):
                    continue   # group lacks token budget for a full chunk
                if (len(self.running_qs[g]) + 1 > cfg.max_batch_size
                        or len(groups[g]) + 1 > cfg.max_batch_size):
                    continue
                need = self._blocks_for_len(n)
                free = self.num_hbm_blocks - blocks_used[g]
                if need > free:
                    continue
                if free > best_free:
                    best, best_free = g, free
            if best < 0:
                break   # strict FCFS: don't skip ahead
            g = best
            n = min(cand.prompt_len, cfg.prefill_chunk_size)
            self.waiting_q.popleft()
            cand.dp_group = g
            cand.seq_id = self.id_managers[g].get_id()
            if self.prefix_matcher is not None:
                # Prefix-cache hit: tokens already cached shrink the first
                # chunk (admission checks above used the unmatched length —
                # conservative, still fits).
                self.prefix_matcher(cand)
                n = min(cand.num_uncached_tokens(), cfg.prefill_chunk_size)
            n = self._page_align_chunk(cand, n)
            self.running_qs[g].append(cand)
            groups[g].append(ScheduledSeq(cand, n))
            self._group_state[g]["pre_padded"] += (
                cdiv(n, self._group_state[g]["align"])
                * self._group_state[g]["align"])
            blocks_used[g] += self._blocks_for_len(n)

    def _build_reference_style_batch(self, blocks_used: int,
                                     allow_admission: bool) -> list[ScheduledSeq]:
        """Reference policy shape (scheduler.py:73-129): a batch is either whole-prompt
        prefills for newly admitted requests, or one decode token per running seq."""
        cfg = self.engine_config
        run = self.running_qs[0]
        if allow_admission and self.waiting_q:
            cur: list[ScheduledSeq] = []
            cur_blocks = 0
            cur_tokens = 0
            while self.waiting_q:
                cand = self.waiting_q[0]
                need = self._blocks_for_len(cand.prompt_len)
                if (len(cur) + 1 <= cfg.max_batch_size
                        and len(run) + len(cur) + 1 <= cfg.max_batch_size
                        and blocks_used + cur_blocks + need <= self.num_hbm_blocks
                        and cur_tokens + cand.prompt_len <= cfg.max_tokens_in_batch):
                    self.waiting_q.popleft()
                    cand.dp_group = 0
                    cand.seq_id = self.id_managers[0].get_id()
                    if self.prefix_matcher is not None:
                        self.prefix_matcher(cand)
                    cur.append(ScheduledSeq(cand, cand.num_uncached_tokens()))
                    cur_blocks += need
                    cur_tokens += cand.prompt_len
                else:
                    break
            if cur:
                run.extend(s.request for s in cur)
                return cur
        return [ScheduledSeq(r, 1) for r in run if not r.is_prefill_stage()]
