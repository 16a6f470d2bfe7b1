"""OpenAI-compatible completion routes (beyond the reference, whose only API
is its own POST /generate — swiftllm/server/api_server.py:16-121).

A thin adapter over the Engine: ``POST /v1/completions`` and
``POST /v1/chat/completions`` (non-streaming JSON or SSE streaming with
``data: ...`` / ``data: [DONE]`` framing; chat prompts render through the
tokenizer's chat template when it has one) and ``GET /v1/models``.
Supported request fields: model (echoed), prompt (string
or token-id list), max_tokens, temperature, top_p, seed, stream, echo,
logprobs (chosen-token logprobs; requires the engine to run with
--enable-logprobs true). Unsupported OpenAI fields are ignored.
"""

from __future__ import annotations

import json
import time

from aiohttp import web

from swiftllm_tpu_torch.server.structs import RawRequest

_COUNTER = iter(range(1, 1 << 62))


def _make_raw(engine, payload: dict) -> RawRequest:
    prompt = payload.get("prompt", "")
    ids = None
    if isinstance(prompt, list):   # OpenAI allows pre-tokenized prompts
        ids, prompt = [int(t) for t in prompt], ""
    # A "model" naming a registered LoRA adapter routes to it (vLLM's
    # multi-LoRA convention); anything else serves the base model.
    model = payload.get("model")
    lora = model if model in engine.model.lora_slots else None
    return RawRequest(
        prompt=prompt,
        output_len=int(payload.get("max_tokens", 16)),
        temperature=float(payload.get("temperature", 1.0)),
        top_p=float(payload.get("top_p", 1.0)),
        seed=payload.get("seed"),
        prompt_token_ids=ids,
        lora=lora,
    )


def _finish_reason(req) -> str:
    return "stop" if req.stopped_on_eos else "length"


def _logprobs_block(req, token_texts):
    return {
        "tokens": token_texts,
        "token_logprobs": req.output_logprobs,
        "top_logprobs": None,
        "text_offset": None,
    }


async def completions(request: web.Request) -> web.StreamResponse:
    engine = request.app["engine"]
    payload = await request.json()
    raw = _make_raw(engine, payload)
    model_name = payload.get("model", "swiftllm-tpu")
    want_lp = bool(payload.get("logprobs"))
    rid = f"cmpl-{next(_COUNTER)}"
    created = int(time.time())

    def chunk(text, *, finish=None, lp=None, tok=None):
        c = {"id": rid, "object": "text_completion", "created": created,
             "model": model_name,
             "choices": [{"index": 0, "text": text,
                          "finish_reason": finish,
                          "logprobs": ({"tokens": [tok],
                                        "token_logprobs": [lp],
                                        "top_logprobs": None,
                                        "text_offset": None}
                                       if want_lp else None)}]}
        return f"data: {json.dumps(c)}\n\n".encode()

    if payload.get("stream", False):
        response = web.StreamResponse(
            headers={"Content-Type": "text/event-stream",
                     "Cache-Control": "no-cache"})
        await response.prepare(request)
        from swiftllm_tpu_torch.server.tokenization import IncrementalDecoder
        decoder = IncrementalDecoder(engine.tokenizer)
        req = engine.submit(raw)
        try:
            async for step in engine.stream_outputs(req):
                text = await decoder.push(step.token_id)
                await response.write(chunk(text, lp=step.logprob, tok=text))
            await response.write(chunk("", finish=_finish_reason(req)))
            await response.write(b"data: [DONE]\n\n")
        finally:
            if not req.is_finished():
                engine.abort_request(req)
        await response.write_eof()
        return response

    req, token_ids = await engine.add_request_and_wait(raw)
    text = await engine.tokenizer.decode(token_ids)
    if payload.get("echo"):
        text = (payload.get("prompt", "") if isinstance(
            payload.get("prompt"), str) else "") + text
    token_texts = [await engine.tokenizer.decode([t]) for t in token_ids] \
        if want_lp else None
    body = {
        "id": rid, "object": "text_completion", "created": created,
        "model": model_name,
        "choices": [{
            "index": 0,
            "text": text,
            "finish_reason": _finish_reason(req),
            "logprobs": (_logprobs_block(req, token_texts)
                         if want_lp else None),
        }],
        "usage": {
            "prompt_tokens": req.prompt_len,
            "completion_tokens": len(token_ids),
            "total_tokens": req.prompt_len + len(token_ids),
        },
    }
    return web.json_response(body)


async def chat_completions(request: web.Request) -> web.StreamResponse:
    engine = request.app["engine"]
    payload = await request.json()
    messages = payload.get("messages", [])
    prompt = await engine.tokenizer.render_chat(messages)
    raw = RawRequest(
        prompt=prompt,
        output_len=int(payload.get("max_tokens",
                                   payload.get("max_completion_tokens", 256))),
        temperature=float(payload.get("temperature", 1.0)),
        top_p=float(payload.get("top_p", 1.0)),
        seed=payload.get("seed"),
    )
    model_name = payload.get("model", "swiftllm-tpu")
    rid = f"chatcmpl-{next(_COUNTER)}"
    created = int(time.time())

    if payload.get("stream", False):
        response = web.StreamResponse(
            headers={"Content-Type": "text/event-stream",
                     "Cache-Control": "no-cache"})
        await response.prepare(request)
        from swiftllm_tpu_torch.server.tokenization import IncrementalDecoder
        decoder = IncrementalDecoder(engine.tokenizer)

        def chunk(delta, finish=None):
            c = {"id": rid, "object": "chat.completion.chunk",
                 "created": created, "model": model_name,
                 "choices": [{"index": 0, "delta": delta,
                              "finish_reason": finish}]}
            return f"data: {json.dumps(c)}\n\n".encode()

        req = engine.submit(raw)
        try:
            await response.write(chunk({"role": "assistant", "content": ""}))
            async for step in engine.stream_outputs(req):
                text = await decoder.push(step.token_id)
                if text:
                    await response.write(chunk({"content": text}))
            await response.write(chunk({}, finish=_finish_reason(req)))
            await response.write(b"data: [DONE]\n\n")
        finally:
            if not req.is_finished():
                engine.abort_request(req)
        await response.write_eof()
        return response

    req, token_ids = await engine.add_request_and_wait(raw)
    text = await engine.tokenizer.decode(token_ids)
    return web.json_response({
        "id": rid, "object": "chat.completion", "created": created,
        "model": model_name,
        "choices": [{
            "index": 0,
            "message": {"role": "assistant", "content": text},
            "finish_reason": _finish_reason(req),
        }],
        "usage": {
            "prompt_tokens": req.prompt_len,
            "completion_tokens": len(token_ids),
            "total_tokens": req.prompt_len + len(token_ids),
        },
    })


async def models(request: web.Request) -> web.Response:
    engine = request.app["engine"]
    name = engine.engine_config.model_path or "swiftllm-tpu-dummy"
    data = [{"id": name, "object": "model", "created": 0,
             "owned_by": "swiftllm-tpu"}]
    data += [{"id": lora_name, "object": "model", "created": 0,
              "owned_by": "swiftllm-tpu", "parent": name}
             for lora_name in engine.model.lora_slots]
    return web.json_response({"object": "list", "data": data})


def add_routes(app: web.Application) -> None:
    app.router.add_post("/v1/completions", completions)
    app.router.add_post("/v1/chat/completions", chat_completions)
    app.router.add_get("/v1/models", models)
