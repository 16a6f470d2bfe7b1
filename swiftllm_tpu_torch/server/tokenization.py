"""Tokenization engine — HF tokenizer kept OFF the engine's event loop.

Capability parity with the reference's Ray-actor ``TokenizationEngine``
(swiftllm/server/tokenization_engine.py:6-16; the reference's only use of Ray,
SURVEY.md §2.5). Rebuilt without the Ray dependency: a ``ProcessPoolExecutor``
worker process owns the ``AutoTokenizer`` (loaded once via the pool
initializer), and the engine awaits ``run_in_executor`` futures. A "thread"
backend (HF fast tokenizers are Rust-backed and release the GIL) and an
"inline" backend (tests) are also provided.

``use_dummy`` mode works without tokenizer files via a hash-based dummy
tokenizer, mirroring the reference's dummy-weight hermetic-test hook
(engine_config.py:36-40).
"""

from __future__ import annotations

import asyncio
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

_WORKER_TOKENIZER = None


def _load_tokenizer(model_path: str):
    from transformers import AutoTokenizer
    return AutoTokenizer.from_pretrained(model_path)


def _init_worker(model_path: str):
    global _WORKER_TOKENIZER
    _WORKER_TOKENIZER = _load_tokenizer(model_path)


def _worker_batched_tokenize(prompts: list[str]) -> list[list[int]]:
    return _WORKER_TOKENIZER(prompts)["input_ids"]


def _worker_decode(token_ids: list[int], skip_special_tokens: bool) -> str:
    return _WORKER_TOKENIZER.decode(token_ids, skip_special_tokens=skip_special_tokens)


def _incremental_decode(tokenizer, window: list[int], read_rel: int,
                        skip_special_tokens: bool) -> tuple[str, bool]:
    """One incremental-detokenization step over a bounded token window.

    ``window`` is the last few tokens (context + pending); ``read_rel`` marks
    how many of them have already been emitted as text. Returns
    ``(new_text_suffix, committed)``. When the window decodes to an incomplete
    UTF-8 sequence (trailing U+FFFD), nothing is emitted and the caller keeps
    growing the window — the reference handles the same merge problem with a
    two-token re-decode fallback (reference api_server.py:44-65); this is the
    O(1)-per-token version of that idea (cost is bounded by the window size,
    not the output length).
    """
    full = tokenizer.decode(window, skip_special_tokens=skip_special_tokens)
    if full.endswith("�"):
        return "", False
    prev = tokenizer.decode(window[:read_rel],
                            skip_special_tokens=skip_special_tokens)
    return full[len(prev):], True


def _worker_decode_stream(window: list[int], read_rel: int,
                          skip_special_tokens: bool) -> tuple[str, bool]:
    return _incremental_decode(_WORKER_TOKENIZER, window, read_rel,
                               skip_special_tokens)


def _render_chat(tokenizer, messages: list[dict]) -> str:
    """Messages → prompt string via the tokenizer's chat template when it has
    one; otherwise a plain role-tagged transcript with a generation cue."""
    try:
        return tokenizer.apply_chat_template(
            messages, tokenize=False, add_generation_prompt=True)
    except Exception:
        lines = [f"{m.get('role', 'user')}: {m.get('content', '')}"
                 for m in messages]
        return "\n".join(lines) + "\nassistant:"


def _worker_render_chat(messages: list[dict]) -> str:
    return _render_chat(_WORKER_TOKENIZER, messages)


class DummyTokenizer:
    """Deterministic stand-in when no tokenizer files exist (dummy-weight mode)."""

    def __init__(self, vocab_size: int = 32000):
        self.vocab_size = vocab_size

    def __call__(self, prompts: list[str]) -> dict:
        # crc32, not hash(): str hash is randomized per process
        # (PYTHONHASHSEED), which would break cross-process determinism —
        # multi-host serving tokenizes on host 0 only, but tests and A/B
        # benchmarks compare outputs across server processes.
        import zlib
        return {"input_ids": [
            [(zlib.crc32(w.encode()) % (self.vocab_size - 1)) + 1
             for w in p.split()] or [1]
            for p in prompts]}

    def decode(self, token_ids: list[int], skip_special_tokens: bool = True) -> str:
        return " ".join(f"<{t}>" for t in token_ids)


class TokenizationEngine:
    """Async tokenize/decode service.

    backend: "process" (default — tokenizer lives in a separate OS process,
    like the reference's Ray actor), "thread", or "inline" (synchronous,
    for tests and dummy mode).
    """

    def __init__(self, model_path: str, backend: str = "process",
                 use_dummy: bool = False, vocab_size: int = 32000):
        self.backend = backend
        self._pool = None
        self._tokenizer = None
        if use_dummy:
            self.backend = "inline"
            self._tokenizer = DummyTokenizer(vocab_size)
        elif backend == "process":
            self._pool = ProcessPoolExecutor(
                max_workers=1, initializer=_init_worker, initargs=(model_path,))
        elif backend == "thread":
            self._pool = ThreadPoolExecutor(max_workers=1)
            self._tokenizer = _load_tokenizer(model_path)
        elif backend == "inline":
            self._tokenizer = _load_tokenizer(model_path)
        else:
            raise ValueError(f"unknown tokenization backend {backend!r}")

    async def batched_tokenize(self, prompts: list[str]) -> list[list[int]]:
        if self.backend == "inline":
            return self._tokenizer(prompts)["input_ids"]
        loop = asyncio.get_running_loop()
        if self.backend == "process":
            return await loop.run_in_executor(self._pool, _worker_batched_tokenize, prompts)
        return await loop.run_in_executor(
            self._pool, lambda: self._tokenizer(prompts)["input_ids"])

    async def decode(self, token_ids: list[int], skip_special_tokens: bool = True) -> str:
        if self.backend == "inline":
            return self._tokenizer.decode(token_ids, skip_special_tokens=skip_special_tokens)
        loop = asyncio.get_running_loop()
        if self.backend == "process":
            return await loop.run_in_executor(
                self._pool, _worker_decode, token_ids, skip_special_tokens)
        return await loop.run_in_executor(
            self._pool,
            lambda: self._tokenizer.decode(token_ids, skip_special_tokens=skip_special_tokens))

    async def decode_stream_step(self, window: list[int], read_rel: int,
                                 skip_special_tokens: bool = True) -> tuple[str, bool]:
        """One incremental-decode step (see ``_incremental_decode``)."""
        if self.backend == "inline":
            return _incremental_decode(self._tokenizer, window, read_rel,
                                       skip_special_tokens)
        loop = asyncio.get_running_loop()
        if self.backend == "process":
            return await loop.run_in_executor(
                self._pool, _worker_decode_stream, window, read_rel,
                skip_special_tokens)
        return await loop.run_in_executor(
            self._pool, lambda: _incremental_decode(
                self._tokenizer, window, read_rel, skip_special_tokens))

    async def render_chat(self, messages: list[dict]) -> str:
        """Chat messages → prompt string (chat template or plain transcript)."""
        if self.backend == "inline":
            return _render_chat(self._tokenizer, messages)
        loop = asyncio.get_running_loop()
        if self.backend == "process":
            return await loop.run_in_executor(
                self._pool, _worker_render_chat, messages)
        return await loop.run_in_executor(
            self._pool, lambda: _render_chat(self._tokenizer, messages))

    def shutdown(self):
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None


class IncrementalDecoder:
    """Streams text from a growing token-id list in O(1) per token.

    Two offsets into the id list: ``prefix`` (start of the decode window —
    lags a few committed tokens behind so sentencepiece/BPE spacing and byte
    merges decode with context) and ``read`` (tokens already emitted as
    text). Each ``push`` decodes only ``ids[prefix:]`` — bounded by the
    context size plus any still-incomplete UTF-8 tail — instead of the whole
    accumulated output.
    """

    CONTEXT = 5

    def __init__(self, engine: TokenizationEngine,
                 skip_special_tokens: bool = True):
        self._engine = engine
        self._skip_special = skip_special_tokens
        self.ids: list[int] = []
        self._prefix = 0
        self._read = 0

    async def push(self, token_id: int) -> str:
        self.ids.append(token_id)
        delta, committed = await self._engine.decode_stream_step(
            self.ids[self._prefix:], self._read - self._prefix,
            self._skip_special)
        if committed:
            self._read = len(self.ids)
            self._prefix = max(self._prefix, self._read - self.CONTEXT)
        return delta
