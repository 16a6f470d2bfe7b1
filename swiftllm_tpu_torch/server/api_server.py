"""HTTP serving front-end.

Capability parity with the reference's FastAPI server
(``swiftllm/server/api_server.py:16-121``): ``POST /generate`` with
``{prompt, output_len, stream?, decode?}``; streaming responses decode
incrementally and emit only the new text suffix, since tokenizers can merge
trailing tokens (reference api_server.py:44-65). Additions over the reference:
client-disconnect aborts the request (its api_server.py:75 TODO), ``GET
/stats`` and ``GET /health``.

Built on aiohttp (the route surface and payloads are identical to the
reference's). A copy of ``swiftllm_tpu/server/api_server.py`` serving the
PyTorch port's engine.

With ``--tp-size`` / ``--dp-size`` it runs as one process per rank, launched
with the standard ``torch.distributed`` environment (``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``, as torchrun
sets it) and ``--dist-backend`` naming the backend of the step's
collectives. Rank 0 serves HTTP; every other rank builds its shard of the
model, sizes its cache with rank 0 and replays rank 0's steps
(``distributed.follower_loop``) until rank 0 stops it, on exit, on SIGTERM
and on a crash. The device is ``cuda:{LOCAL_RANK}`` unless ``--device``
names one.

Run:  python -m swiftllm_tpu_torch.server.api_server --model-path /path/to/llama ...
      torchrun --nproc-per-node 2 -m swiftllm_tpu_torch.server.api_server \
          --dist-backend nccl --tp-size 2 --model-path /path/to/llama ...
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import signal
import sys
import traceback

try:
    from aiohttp import web
except ImportError as e:   # pragma: no cover
    raise ImportError("the API server requires aiohttp") from e

from swiftllm_tpu_torch.config import EngineConfig, LlamaModelConfig
from swiftllm_tpu_torch.server.engine import Engine
from swiftllm_tpu_torch.server.structs import RawRequest


async def health(request: web.Request) -> web.Response:
    return web.Response(status=200)


async def stats(request: web.Request) -> web.Response:
    engine: Engine = request.app["engine"]
    return web.json_response(engine.stats.snapshot())


async def metrics(request: web.Request) -> web.Response:
    """Prometheus text exposition of the engine counters + queue gauges."""
    engine: Engine = request.app["engine"]
    snap = engine.stats.snapshot()
    sched = engine.scheduler
    gauges = {
        "swiftllm_waiting_requests": len(sched.waiting_q),
        "swiftllm_running_requests": sum(len(q) for q in sched.running_qs),
        "swiftllm_swapped_requests": sum(len(q) for q in sched.swapped_qs),
    }
    lines = []
    for k, v in snap.items():
        name = f"swiftllm_{k}"
        kind = "gauge" if k.startswith("avg_") else "counter"
        lines += [f"# TYPE {name} {kind}", f"{name} {v}"]
    for k, v in gauges.items():
        lines += [f"# TYPE {k} gauge", f"{k} {v}"]
    return web.Response(text="\n".join(lines) + "\n",
                        content_type="text/plain")


async def generate(request: web.Request) -> web.StreamResponse:
    engine: Engine = request.app["engine"]
    payload = await request.json()
    raw = RawRequest(
        prompt=payload.get("prompt", ""),
        output_len=int(payload.get("output_len",
                                   engine.engine_config.max_output_len)),
        temperature=float(payload.get("temperature", 0.0)),
        top_p=float(payload.get("top_p", 1.0)),
        top_k=int(payload.get("top_k", 0)),
        seed=payload.get("seed"),
        prompt_token_ids=payload.get("prompt_token_ids"),
        lora=payload.get("lora"),
    )
    do_decode = bool(payload.get("decode", True))
    want_logprobs = bool(payload.get("logprobs", False))

    if payload.get("stream", False):
        response = web.StreamResponse(
            headers={"Content-Type": "application/x-ndjson"})
        await response.prepare(request)
        # Incremental detokenization: O(1) decode work per streamed token
        # (lagging-window algorithm, tokenization.IncrementalDecoder) — the
        # reference re-decodes with a two-token fallback (api_server.py:44-65);
        # re-decoding the WHOLE output per token would be O(n²).
        from swiftllm_tpu_torch.server.tokenization import IncrementalDecoder
        decoder = IncrementalDecoder(engine.tokenizer) if do_decode else None
        # Submit first so a disconnect BEFORE the first token (request still
        # queued or prefilling) also aborts — the handle exists from the start.
        req = engine.submit(raw)
        try:
            async for step_output in engine.stream_outputs(req):
                event = {"token_id": step_output.token_id}
                if want_logprobs:
                    event["logprob"] = step_output.logprob
                if decoder is not None:
                    event["text"] = await decoder.push(step_output.token_id)
                await response.write((json.dumps(event) + "\n").encode())
        finally:
            # Client disconnect (write raises) or generator exit: free the seq.
            if not req.is_finished():
                engine.abort_request(req)
        await response.write_eof()
        return response

    req, output_token_ids = await engine.add_request_and_wait(raw)
    result = {"output_token_ids": output_token_ids}
    if want_logprobs:
        # Raw log-softmax per generated token; null unless the engine runs
        # with --enable-logprobs true.
        result["logprobs"] = req.output_logprobs
    if do_decode:
        result["output"] = await engine.tokenizer.decode(output_token_ids)
    return web.json_response(result)


async def profile_start(request: web.Request) -> web.Response:
    engine: Engine = request.app["engine"]
    payload = await request.json() if request.can_read_body else {}
    engine.start_profile(payload.get("dir", "swiftllm_tpu_torch_trace"))
    return web.Response(status=200)


async def profile_stop(request: web.Request) -> web.Response:
    engine: Engine = request.app["engine"]
    engine.stop_profile()
    return web.Response(status=200)


def build_app(engine: Engine) -> web.Application:
    app = web.Application()
    app["engine"] = engine
    app.router.add_get("/health", health)
    app.router.add_get("/stats", stats)
    app.router.add_get("/metrics", metrics)
    app.router.add_post("/generate", generate)
    app.router.add_post("/profile/start", profile_start)
    app.router.add_post("/profile/stop", profile_stop)
    from swiftllm_tpu_torch.server.openai_api import add_routes
    add_routes(app)   # OpenAI-compatible /v1/completions, /v1/models
    return app


async def main_coroutine(args: argparse.Namespace,
                         engine_config: EngineConfig | None = None,
                         model_config: LlamaModelConfig | None = None):
    engine_config = engine_config or EngineConfig.from_cli_args(args)
    from swiftllm_tpu_torch.parallel import distributed
    if distributed.initialize(args.dist_backend):
        print(f"swiftllm-tpu-torch rank {os.environ['RANK']} of "
              f"{os.environ['WORLD_SIZE']}: backend {args.dist_backend}, "
              f"device {args.device}", flush=True)
    if not distributed.is_primary():
        from swiftllm_tpu_torch.worker.model import LlamaModel
        model = LlamaModel(engine_config, model_config, device=args.device)
        model.load_weights()
        model.init_kvcache_and_swap()
        print(f"swiftllm-tpu-torch follower rank {os.environ['RANK']} ready; "
              "replaying the primary's steps", flush=True)
        await asyncio.get_running_loop().run_in_executor(
            None, distributed.follower_loop, model)
        distributed.shutdown()
        return

    engine = Engine(engine_config, model_config, device=args.device)
    await engine.initialize()
    app = build_app(engine)

    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, args.host, args.port)
    await site.start()
    print(f"swiftllm-tpu-torch API server listening on http://{args.host}:{args.port}")

    # SIGTERM ends the serving loop as SIGINT does, so the followers are
    # stopped on the way out.
    serving = asyncio.ensure_future(engine.start_all_event_loops())
    asyncio.get_running_loop().add_signal_handler(signal.SIGTERM,
                                                  serving.cancel)
    try:
        await serving
    except asyncio.CancelledError:
        if asyncio.current_task().cancelling():
            raise       # this coroutine is cancelled itself (SIGINT)
    except Exception:
        traceback.print_exc()
        engine.stop_followers()
        os._exit(1)   # crash-and-die, as the reference (api_server.py:114-119)
    finally:
        await runner.cleanup()
        distributed.shutdown()


def main():
    parser = argparse.ArgumentParser(
        description="swiftllm-tpu-torch API server (the PyTorch port)")
    parser.add_argument("--host", type=str, default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--device", type=str, default=None,
                        help="cuda:{LOCAL_RANK} (default) or another device "
                             "(cpu, cuda:N)")
    parser.add_argument("--dist-backend", type=str, default=None,
                        help="backend of the step's collectives when run as "
                             "several ranks (nccl or gloo); required then")
    EngineConfig.add_cli_args(parser)
    args = parser.parse_args()
    if args.device is None:
        args.device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
    try:
        asyncio.run(main_coroutine(args))
    except KeyboardInterrupt:
        sys.exit(0)


if __name__ == "__main__":
    main()
