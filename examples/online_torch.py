"""Online serving with the PyTorch/CUDA port: the control and data planes.

    python examples/online_torch.py --use-dummy true               # the card
    python examples/online_torch.py --use-dummy true --device cpu  # the CPU

Submits requests at staggered arrival times to an in-process Engine and
prints each one's time to first token and time per output token from its
stream. With --use-dummy and no --model-path it runs examples/
offline_torch.py's tiny model on random weights, with no checkpoint and no
tokenizer.
"""

import argparse
import asyncio
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from swiftllm_tpu_torch.config import EngineConfig, LlamaModelConfig
from swiftllm_tpu_torch.server.engine import Engine
from swiftllm_tpu_torch.server.structs import RawRequest

from offline_torch import DUMMY_MODEL, small_engine_config  # beside this file


async def send_request_and_stream(engine: Engine, prompt: str, output_len: int,
                                  delay_s: float, tag: str) -> list:
    await asyncio.sleep(delay_s)
    t_submit = time.perf_counter()
    latencies = []
    last = t_submit
    token_ids = []
    async for step_output in engine.add_request_and_stream(
            RawRequest(prompt, output_len)):
        now = time.perf_counter()
        latencies.append(now - last)
        last = now
        token_ids.append(step_output.token_id)
    ttft = latencies[0] if latencies else 0.0
    tpot = sum(latencies[1:]) / max(len(latencies) - 1, 1)
    print(f"[{tag}] {len(token_ids)} tokens; TTFT {ttft * 1e3:.1f} ms, "
          f"TPOT {tpot * 1e3:.1f} ms")
    if engine.tokenizer is not None and not engine.engine_config.use_dummy:
        text = await engine.tokenizer.decode(token_ids)
        print(f"[{tag}] output: {text!r}")
    return token_ids


async def main_async(parser: argparse.ArgumentParser, args: argparse.Namespace):
    engine_config = EngineConfig.from_cli_args(args)
    if engine_config.use_dummy and not engine_config.model_path:
        model_config = LlamaModelConfig(**DUMMY_MODEL)
        small_engine_config(parser, engine_config)
    else:
        model_config = None

    engine = Engine(engine_config, model_config, device=args.device)
    await engine.initialize(tokenizer_backend="inline" if engine_config.use_dummy
                            else "thread")
    loops_task = asyncio.create_task(engine.start_all_event_loops())

    prompts = [
        ("Life blooms like a flower. Far away or by the road. Waiting", 0.0),
        ("A quick brown fox", 0.5),
        ("Artificial intelligence is", 1.0),
        ("To be or not to be,", 1.5),
    ]
    clients = [send_request_and_stream(engine, p, args.output_len, d, f"req{i}")
               for i, (p, d) in enumerate(prompts)]
    await asyncio.gather(*clients)
    print("engine stats:", engine.stats.snapshot())
    loops_task.cancel()
    await asyncio.gather(loops_task, return_exceptions=True)


def main():
    parser = argparse.ArgumentParser()
    EngineConfig.add_cli_args(parser)
    parser.add_argument("--output-len", type=int, default=20)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    asyncio.run(main_async(parser, parser.parse_args()))


if __name__ == "__main__":
    main()
