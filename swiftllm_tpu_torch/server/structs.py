"""Request lifecycle structs.

Capability parity with the reference's ``swiftllm/server/structs.py:4-63``, extended
for chunked prefill (a request tracks how many of its tokens already have KV in the
cache) and optional EOS-stop.
"""

from __future__ import annotations

import asyncio
import dataclasses
import itertools


@dataclasses.dataclass
class StepOutput:
    """The output of one engine step for one request (reference structs.py:4-11)."""
    token_id: int
    request: "Request"
    logprob: float | None = None   # raw log-softmax of token_id (enable_logprobs)


class RawRequest:
    """A request as issued by the user (reference structs.py:14-23)."""

    def __init__(self, prompt: str, output_len: int,
                 temperature: float = 0.0, top_p: float = 1.0, top_k: int = 0,
                 seed: int | None = None,
                 prompt_token_ids: list[int] | None = None,
                 lora: str | None = None):
        self.prompt = prompt
        self.output_len = output_len
        self.temperature = temperature
        self.top_p = top_p
        self.top_k = top_k
        self.seed = seed
        self.prompt_token_ids = prompt_token_ids   # skip tokenization when provided
        self.lora = lora                           # LoRA adapter name (None = base)


_req_counter = itertools.count()


class Request:
    """A queuing / running / swapped / finished request (reference structs.py:26-63).

    Chunked-prefill state machine: ``num_cached_tokens`` counts how many of
    ``all_token_ids`` already have KV in the paged cache. Tokens
    ``all_token_ids[num_cached_tokens:]`` still need to be fed to the model. A step
    that feeds through the current end of ``all_token_ids`` samples one new token.
    """

    def __init__(self, raw_request: RawRequest):
        self.prompt = raw_request.prompt
        self.prompt_token_ids: list[int] = []
        self.prompt_len = 0
        self.output_len = raw_request.output_len
        self.temperature = raw_request.temperature
        self.top_p = raw_request.top_p
        self.top_k = raw_request.top_k
        self.sampling_seed = (raw_request.seed if raw_request.seed is not None
                              else next(_req_counter) + 0x9E3779B9)
        self.output_token_ids: list[int] = []
        self.lora_slot = 0             # stacked-adapter slot (engine resolves
                                       # raw_request.lora at submit; 0 = base)
        self.output_logprobs: list[float | None] = []   # parallel to output_token_ids
        self.num_cached_tokens = 0     # tokens whose KV already lives in the cache
        self.seq_id = -1               # row in its group's block table, assigned on admission
        self.dp_group = 0              # dp group the request is pinned to (sticky:
                                       # its KV pages live in that group's pool)
        self.req_index = next(_req_counter)   # global arrival order (FCFS key)
        self.stopped_on_eos = False
        # Acceptance-adaptive speculative decoding (scheduler policy state):
        # realized draft/accept counts and suppressed-probe counter.
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.spec_tries = 0
        self.aborted = False
        self.swapped = False           # KV currently lives in the CPU swap cache
        self.resources_freed = False   # pages/ids already released (idempotence)
        self.output_q: asyncio.Queue[StepOutput] = asyncio.Queue()
        self.finished_event = asyncio.Event()

    # --- token bookkeeping -------------------------------------------------
    def set_prompt_token_ids(self, token_ids: list[int]):
        self.prompt_token_ids = token_ids
        self.prompt_len = len(token_ids)

    @property
    def all_token_ids(self) -> list[int]:
        return self.prompt_token_ids + self.output_token_ids

    @property
    def total_len(self) -> int:
        return self.prompt_len + len(self.output_token_ids)

    def next_tokens(self, budget: int) -> list[int]:
        """The next ≤budget tokens that must be fed to the model."""
        return self.all_token_ids[self.num_cached_tokens:self.num_cached_tokens + budget]

    def num_uncached_tokens(self) -> int:
        return self.total_len - self.num_cached_tokens

    # --- state predicates (reference structs.py:56-63) ---------------------
    def is_finished(self) -> bool:
        return (self.aborted or self.stopped_on_eos
                or len(self.output_token_ids) == self.output_len)

    def get_cur_output_len(self) -> int:
        return len(self.output_token_ids)

    def is_prefill_stage(self) -> bool:
        return self.num_cached_tokens < self.prompt_len

    def __repr__(self):
        return (f"Request(seq={self.seq_id}, prompt={self.prompt_len}, "
                f"cached={self.num_cached_tokens}, out={len(self.output_token_ids)}/{self.output_len})")
