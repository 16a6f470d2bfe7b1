"""The port's HTTP surfaces on the CPU: ports of ``tests/test_api_server.py``
(``POST /generate``, JSON and streamed, ``/health``, ``/stats``,
``/metrics``, the profiler endpoints) and ``tests/test_openai_api.py``
(``/v1/completions`` as JSON and SSE, with logprobs, ``/v1/chat/completions``
streamed and not, ``/v1/models``), over real HTTP on localhost, against the
port's ``build_app`` and engine (the tiny engine of ``tests/test_engine.py``
in f32, logprobs on), and the same requests against the JAX package's app
and engine on the same parameters (``params_from_numpy`` of the JAX
engine's dummy tree scaled to O(0.1) weights, as in
``tests/test_torch_swap.py``): the two answers must be the same JSON, token
ids, text, usage, finish reasons and SSE chunking exactly, logprobs within
f32 noise (``LOGPROB_ATOL``).

One server of each package serves the whole module: they live on an event
loop of their own in a background thread, and each test sends its requests
there. Greedy requests (temperature 0) must get the same token ids however
they are asked for.
"""

import asyncio
import json
import re
import threading
import types

import numpy as np
import pytest

aiohttp = pytest.importorskip("aiohttp")
from aiohttp.test_utils import TestClient, TestServer  # noqa: E402

import tests.conftest  # noqa: E402,F401  (forces the JAX CPU backend)

import jax  # noqa: E402

from swiftllm_tpu.config import EngineConfig as JaxEngineConfig  # noqa: E402
from swiftllm_tpu.config import LlamaModelConfig as JaxModelConfig  # noqa: E402
from swiftllm_tpu.server.api_server import build_app as jax_build_app  # noqa: E402
from swiftllm_tpu.server.engine import Engine as JaxEngine  # noqa: E402
from swiftllm_tpu_torch.config import EngineConfig, LlamaModelConfig  # noqa: E402
from swiftllm_tpu_torch.server.api_server import build_app  # noqa: E402
from swiftllm_tpu_torch.server.engine import Engine  # noqa: E402
from swiftllm_tpu_torch.worker.weights import params_from_numpy  # noqa: E402
from tests.test_torch_llama import scaled_params  # noqa: E402

MC = dict(num_layers=2, num_q_heads=4, num_kv_heads=2, hidden_size=64,
          head_dim=16, ffn_inter_dim=128, vocab_size=256,
          max_position_embeddings=2048, rms_norm_eps=1e-5)
EC = dict(model_path="", use_dummy=True, dtype="float32", block_size=16,
          num_hbm_blocks=64, num_cpu_blocks=64, max_blocks_per_seq=16,
          max_batch_size=8, max_tokens_in_batch=128, prefill_chunk_size=32,
          max_seqs_in_block_table=32, enable_logprobs=True)
# The JAX engine on its pure-jnp path: the parity tests hold the HTTP layers,
# whose inputs are the engines' tokens and logprobs.
JAX_EC = dict(EC, use_pallas=False)
# The two packages' f32 forwards differ by rounding only.
LOGPROB_ATOL = 1e-4


@pytest.fixture(scope="module")
def server():
    """The port's engine and a test client of its app, a test client of the
    JAX package's app on the same parameters (``jax``), on a loop in a
    thread; ``run(coro)`` runs a coroutine there and returns its result."""
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()

    def run(coro, timeout=120):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(timeout)

    async def start():
        jax_engine = JaxEngine(JaxEngineConfig(**JAX_EC), JaxModelConfig(**MC))
        await jax_engine.initialize(tokenizer_backend="inline")
        tree = scaled_params(jax_engine.model.params, np.random.default_rng(5))
        jax_engine.model.params = jax.tree.map(
            lambda old, new: jax.device_put(new, old.sharding),
            jax_engine.model.params, tree)
        engine = Engine(EngineConfig(**EC), LlamaModelConfig(**MC), device="cpu")
        await engine.initialize(tokenizer_backend="inline")
        engine.model.params = params_from_numpy(tree, "cpu")
        loops = [asyncio.create_task(e.start_all_event_loops())
                 for e in (engine, jax_engine)]
        clients = [TestClient(TestServer(app))
                   for app in (build_app(engine), jax_build_app(jax_engine))]
        for c in clients:
            await c.start_server()
        return engine, loops, clients

    engine, loops, (client, jax_client) = run(start())
    yield types.SimpleNamespace(engine=engine, client=client, jax=jax_client,
                                run=run)

    async def stop():
        for c in (client, jax_client):
            await c.close()
        for t in loops:
            t.cancel()
    run(stop())
    loop.call_soon_threadsafe(loop.stop)
    thread.join(10)


async def _sse(resp):
    """The JSON chunks of an SSE response up to ``data: [DONE]``, and
    whether it came."""
    chunks = []
    async for line in resp.content:
        line = line.decode().strip()
        if line == "data: [DONE]":
            return chunks, True
        if line.startswith("data: "):
            chunks.append(json.loads(line[len("data: "):]))
    return chunks, False


def _ids(text):
    """The dummy tokenizer decodes token t as "<t>"."""
    return [int(t) for t in re.findall(r"<(\d+)>", text)]


def test_generate_non_streaming(server):
    async def body(client):
        before = server.engine.stats.snapshot()["num_requests_finished"]
        resp = await client.post("/generate", json={
            "prompt": "a b c", "output_len": 6, "decode": True})
        assert resp.status == 200
        data = await resp.json()
        assert len(data["output_token_ids"]) == 6
        assert isinstance(data["output"], str)

        health = await client.get("/health")
        assert health.status == 200
        stats = await (await client.get("/stats")).json()
        assert stats["num_requests_finished"] == before + 1
        prom = await (await client.get("/metrics")).text()
        assert f"swiftllm_num_requests_finished {before + 1}" in prom
        assert "# TYPE swiftllm_running_requests gauge" in prom
        assert "# TYPE swiftllm_swapped_requests gauge" in prom
    server.run(body(server.client))


def test_generate_streaming(server):
    async def body(client):
        resp = await client.post("/generate", json={
            "prompt_token_ids": list(range(8)), "output_len": 5,
            "stream": True, "decode": False})
        assert resp.status == 200
        events = []
        async for line in resp.content:
            if line.strip():
                events.append(json.loads(line))
        assert len(events) == 5
        assert all("token_id" in e for e in events)
    server.run(body(server.client))


@pytest.mark.parametrize("logprobs", [False, True])
def test_streaming_matches_non_streaming(server, logprobs):
    """/generate streamed equals /generate in one answer: token ids, and
    with logprobs each token's logprob."""
    async def body(client):
        ids = list(range(20, 35))
        r1 = await (await client.post("/generate", json={
            "prompt_token_ids": ids, "output_len": 6, "decode": False,
            "logprobs": logprobs})).json()
        resp = await client.post("/generate", json={
            "prompt_token_ids": ids, "output_len": 6, "stream": True,
            "decode": False, "logprobs": logprobs})
        events = []
        async for line in resp.content:
            if line.strip():
                events.append(json.loads(line))
        assert [e["token_id"] for e in events] == r1["output_token_ids"]
        if logprobs:
            lps = [e["logprob"] for e in events]
            assert lps == r1["logprobs"]
            assert all(isinstance(v, float) and v <= 0 for v in lps)
    server.run(body(server.client))


def test_streaming_decode_matches_full(server):
    """Concatenated incremental text == one-shot decode of all output ids."""
    async def body(client):
        ids = list(range(40, 52))
        r1 = await (await client.post("/generate", json={
            "prompt_token_ids": ids, "output_len": 6, "decode": True})).json()
        resp = await client.post("/generate", json={
            "prompt_token_ids": ids, "output_len": 6,
            "stream": True, "decode": True})
        text = ""
        async for line in resp.content:
            if line.strip():
                text += json.loads(line)["text"]
        assert text == r1["output"]
    server.run(body(server.client))


def test_incremental_decoder_utf8_merge():
    """Multi-byte chars split across tokens are held until complete, then
    emitted whole — and the total equals the one-shot decode."""
    from swiftllm_tpu_torch.server.tokenization import _incremental_decode

    class ByteTok:   # each token id is one raw byte
        def decode(self, ids, skip_special_tokens=True):
            return bytes(ids).decode("utf-8", errors="replace")

    tok = ByteTok()
    ids = list("héllo →".encode())   # é and → are multi-byte
    out, prefix, read = "", 0, 0
    for i, b in enumerate(ids):
        delta, committed = _incremental_decode(
            tok, ids[prefix:i + 1], read - prefix, True)
        out += delta
        if committed:
            read = i + 1
            prefix = max(prefix, read - 5)
    assert out == "héllo →"


def test_profile_endpoints(server, tmp_path):
    async def body(client):
        r = await client.post("/profile/start", json={"dir": str(tmp_path)})
        assert r.status == 200
        await client.post("/generate", json={"prompt_token_ids": [1, 2, 3],
                                             "output_len": 2, "decode": False})
        r = await client.post("/profile/stop")
        assert r.status == 200
    server.run(body(server.client))
    assert (tmp_path / "trace.json").stat().st_size > 0


def test_completions_non_streaming(server):
    async def body(client):
        resp = await client.post("/v1/completions", json={
            "model": "m", "prompt": "one two three", "max_tokens": 5,
            "temperature": 0})
        assert resp.status == 200
        data = await resp.json()
        assert data["object"] == "text_completion"
        choice = data["choices"][0]
        assert choice["finish_reason"] in ("stop", "length")
        assert isinstance(choice["text"], str)
        assert data["usage"]["completion_tokens"] == 5
        assert (data["usage"]["total_tokens"]
                == data["usage"]["prompt_tokens"] + 5)

        ms = await (await client.get("/v1/models")).json()
        assert ms["object"] == "list" and ms["data"]
    server.run(body(server.client))


def test_completions_token_id_prompt_and_logprobs(server):
    """Logprobs of a token-id prompt, equal to /generate's for the same
    greedy request, and the same tokens."""
    async def body(client):
        resp = await client.post("/v1/completions", json={
            "prompt": list(range(10)), "max_tokens": 4, "temperature": 0,
            "logprobs": 1})
        data = await resp.json()
        lp = data["choices"][0]["logprobs"]
        assert len(lp["token_logprobs"]) == 4
        assert all(v is not None and v <= 1e-6 for v in lp["token_logprobs"])
        gen = await (await client.post("/generate", json={
            "prompt_token_ids": list(range(10)), "output_len": 4,
            "decode": False, "logprobs": True})).json()
        assert lp["token_logprobs"] == gen["logprobs"]
        assert _ids(data["choices"][0]["text"]) == gen["output_token_ids"]
    server.run(body(server.client))


def test_chat_completions(server):
    async def body(client):
        resp = await client.post("/v1/chat/completions", json={
            "messages": [{"role": "system", "content": "be brief"},
                         {"role": "user", "content": "hi there"}],
            "max_tokens": 4, "temperature": 0})
        assert resp.status == 200
        data = await resp.json()
        assert data["object"] == "chat.completion"
        msg = data["choices"][0]["message"]
        assert msg["role"] == "assistant" and isinstance(msg["content"], str)
        assert data["usage"]["completion_tokens"] == 4
    server.run(body(server.client))


def test_chat_completions_streaming(server):
    """Streamed chat: a role chunk first, a finish reason last, and the same
    greedy tokens as the chat answered in one piece."""
    async def body(client):
        req = {"messages": [{"role": "user", "content": "a b c"}],
               "max_tokens": 3, "temperature": 0}
        whole = await (await client.post("/v1/chat/completions",
                                         json=req)).json()
        resp = await client.post("/v1/chat/completions",
                                 json=dict(req, stream=True))
        chunks, done = await _sse(resp)
        assert done
        assert chunks[0]["choices"][0]["delta"].get("role") == "assistant"
        assert chunks[-1]["choices"][0]["finish_reason"] in ("stop", "length")
        text = "".join(c["choices"][0]["delta"].get("content", "")
                       for c in chunks)
        want = _ids(whole["choices"][0]["message"]["content"])
        assert _ids(text) == want and len(want) == 3
    server.run(body(server.client))


def test_completions_streaming_sse(server):
    async def body(client):
        resp = await client.post("/v1/completions", json={
            "prompt": "a b c d", "max_tokens": 4, "stream": True})
        assert resp.status == 200
        assert resp.headers["Content-Type"].startswith("text/event-stream")
        chunks, done = await _sse(resp)
        assert done
        # 4 token chunks + 1 finish chunk
        assert len(chunks) == 5
        assert chunks[-1]["choices"][0]["finish_reason"] in ("stop", "length")
    server.run(body(server.client))


# The same requests to both packages' servers: (path, JSON body).
PARITY = {
    "generate": ("/generate", {
        "prompt_token_ids": list(range(60, 75)), "output_len": 6,
        "decode": True, "logprobs": True}),
    "generate_stream": ("/generate", {
        "prompt_token_ids": list(range(60, 75)), "output_len": 6,
        "decode": True, "logprobs": True, "stream": True}),
    "completions": ("/v1/completions", {
        "model": "m", "prompt": "one two three four", "max_tokens": 5,
        "temperature": 0, "logprobs": 1}),
    "completions_ids_stream": ("/v1/completions", {
        "prompt": list(range(90, 102)), "max_tokens": 4, "temperature": 0,
        "logprobs": 1, "stream": True}),
    "chat": ("/v1/chat/completions", {
        "messages": [{"role": "system", "content": "be brief"},
                     {"role": "user", "content": "hi there"}],
        "max_tokens": 4, "temperature": 0, "logprobs": True}),
    "chat_stream": ("/v1/chat/completions", {
        "messages": [{"role": "user", "content": "a b c d"}],
        "max_tokens": 5, "temperature": 0, "stream": True}),
}
# Fields that name one answer rather than compute it.
VOLATILE = ("id", "created")


async def _answer(client, path, body):
    """The status, content type and body of one request: JSON, the lines of
    NDJSON, or the SSE chunks followed by whether [DONE] came."""
    resp = await client.post(path, json=body)
    kind = resp.headers["Content-Type"].split(";")[0]
    if kind == "text/event-stream":
        chunks, done = await _sse(resp)
        data = chunks + [done]
    elif kind == "application/x-ndjson":
        data = [json.loads(line) async for line in resp.content if line.strip()]
    else:
        data = await resp.json()
    return resp.status, kind, data


def _same(port, ref, where="answer"):
    """Assert two JSON values equal, floats within LOGPROB_ATOL, the
    VOLATILE fields' presence but not their values."""
    if isinstance(ref, dict):
        assert isinstance(port, dict) and port.keys() == ref.keys(), (
            where, sorted(port), sorted(ref))
        for k in ref:
            if k not in VOLATILE:
                _same(port[k], ref[k], f"{where}.{k}")
    elif isinstance(ref, list):
        assert isinstance(port, list) and len(port) == len(ref), (where, port, ref)
        for i, (a, b) in enumerate(zip(port, ref)):
            _same(a, b, f"{where}[{i}]")
    elif isinstance(ref, float) and not isinstance(ref, bool):
        assert isinstance(port, (int, float)), (where, port, ref)
        assert abs(port - ref) <= LOGPROB_ATOL, (where, port, ref)
    else:
        assert port == ref, (where, port, ref)


@pytest.mark.parametrize("case", list(PARITY))
def test_answers_match_jax_server(server, case):
    """One request to the port's app and to the JAX package's app on the
    same parameters: the same status, content type and answer (token ids,
    text, logprobs within LOGPROB_ATOL, usage, finish reason, and for a
    stream every chunk and the closing [DONE])."""
    path, body = PARITY[case]

    async def body_():
        return (await _answer(server.client, path, body),
                await _answer(server.jax, path, body))
    (st, kind, got), (jst, jkind, want) = server.run(body_())
    assert (st, kind) == (jst, jkind) == (200, kind)
    _same(got, want)
    # The answers carry generated tokens (a check that both are not empty
    # in the same way).
    flat = json.dumps(want)
    assert re.search(r"<\d+>", flat) or "output_token_ids" in flat, flat
