"""Offline inference with the PyTorch/CUDA port: the data plane only.

    python examples/offline_torch.py --use-dummy true               # the card
    python examples/offline_torch.py --use-dummy true --device cpu  # the CPU

Drives the port's LlamaModel directly: one prefill step over a batch of
prompts, then a greedy decode loop. With --use-dummy and no --model-path it
runs a tiny model on random weights (examples/offline.py's size: 4 layers,
hidden 256, MLP 512, vocab 1,000, GQA group 2; its 8 query heads of 32
lanes as 4 of 64, since the CUDA attention kernels take head_dim 64 and
128), with no checkpoint and no tokenizer. On the card every step runs the
hand-written CUDA kernels (built with nvcc at first use); on the CPU the
kernel wrappers run their plain PyTorch versions.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from swiftllm_tpu_torch.config import EngineConfig, LlamaModelConfig
from swiftllm_tpu_torch.server.scheduler import ScheduledSeq
from swiftllm_tpu_torch.server.structs import RawRequest, Request

# The toy model of --use-dummy without a checkpoint, and the serving knobs
# it is run with where the user left them at their production defaults.
DUMMY_MODEL = dict(num_layers=4, num_q_heads=4, num_kv_heads=2, hidden_size=256,
                   head_dim=64, ffn_inter_dim=512, vocab_size=1000,
                   max_position_embeddings=2048, rms_norm_eps=1e-5)
SMALL_KNOBS = dict(max_batch_size=8, max_tokens_in_batch=256, max_blocks_per_seq=64,
                   max_seqs_in_block_table=16, prefill_chunk_size=64,
                   num_cpu_blocks=64)


def small_engine_config(parser: argparse.ArgumentParser,
                        config: EngineConfig) -> EngineConfig:
    """``config`` with every knob of SMALL_KNOBS that the command line left
    at its default shrunk to the toy model, and the bucket ladders derived
    again."""
    for name, small in SMALL_KNOBS.items():
        if getattr(config, name) == parser.get_default(name):
            setattr(config, name, small)
    config.token_buckets = ()
    config.page_buckets = ()
    config.__post_init__()
    return config


def main():
    parser = argparse.ArgumentParser()
    EngineConfig.add_cli_args(parser)
    parser.add_argument("--num-decode-steps", type=int, default=20)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args()
    engine_config = EngineConfig.from_cli_args(args)

    from swiftllm_tpu_torch.worker.model import LlamaModel

    if engine_config.use_dummy and not engine_config.model_path:
        model_config = LlamaModelConfig(**DUMMY_MODEL)
        tokenizer = None
        small_engine_config(parser, engine_config)
    else:
        model_config = LlamaModelConfig.load_from_model_path(engine_config.model_path)
        from transformers import AutoTokenizer
        tokenizer = AutoTokenizer.from_pretrained(engine_config.model_path)

    t0 = time.perf_counter()
    model = LlamaModel(engine_config, model_config, device=args.device)
    model.load_weights()
    model.init_kvcache_and_swap()
    print(f"model ready on {args.device} in {time.perf_counter() - t0:.1f}s; "
          f"KV pages/shard: {model.num_hbm_blocks}")

    prompts = [
        "Life blooms like a flower. Far away or by the road. Waiting",
        "A quick brown fox",
        "Artificial intelligence is",
        "To be or not to be,",
    ]
    requests = []
    for i, p in enumerate(prompts):
        r = Request(RawRequest(p, args.num_decode_steps))
        if tokenizer is not None:
            r.set_prompt_token_ids(tokenizer(p)["input_ids"])
        else:
            r.set_prompt_token_ids([(7 * (i + 1) + j) % model_config.vocab_size
                                    for j in range(8 + i)])
        r.seq_id = i
        requests.append(r)

    def step(scheduled):
        tokens, rows = model.forward(scheduled)
        for i, s in enumerate(rows):
            if s is not None and s.samples_token:
                s.request.output_token_ids.append(int(tokens[i]))
                s.request.num_cached_tokens += s.n_tokens

    # prefill
    t0 = time.perf_counter()
    step([ScheduledSeq(r, r.prompt_len) for r in requests])
    print(f"prefill ({sum(r.prompt_len for r in requests)} tokens): "
          f"{time.perf_counter() - t0:.3f}s (incl. the kernels' first use)")

    # decode loop
    t0 = time.perf_counter()
    n_steps = args.num_decode_steps - 1
    for _ in range(n_steps):
        step([ScheduledSeq(r, 1) for r in requests])
    dt = time.perf_counter() - t0
    if n_steps:
        print(f"decode: {n_steps} steps x {len(requests)} seqs in {dt:.3f}s "
              f"({len(requests) * n_steps / dt:.1f} tok/s, incl. each step shape's "
              "first use)")

    for r in requests:
        if tokenizer is not None:
            print(f"  prompt: {r.prompt!r}")
            print(f"  output: {tokenizer.decode(r.output_token_ids)!r}")
        else:
            print(f"  seq {r.seq_id}: {r.output_token_ids}")


if __name__ == "__main__":
    main()
