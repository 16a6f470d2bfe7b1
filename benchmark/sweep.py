"""The knee of an open-loop cell: one engine set up once, then one window at
each rate, each drained before the next.

    python3 benchmark/sweep.py --workload qwen2-7b.chat-poisson --seed 5 \\
        --seconds 20 --rates 8,12,16,20,24

For each rate it prints the requests, the output tokens a second, the
tails of TTFT (from the due time) and of TPOT, and the backlog's growth:
the median TTFT of the requests due in the window's last quarter over that
of its first quarter (about 1 where the engine keeps up; growing with the
queue above the knee). The knee is the highest rate whose backlog does not
grow; a cell's rate is written into its traffic file as a number. Not part
of a measured run.
"""

import argparse
import asyncio
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

from harness import costs, serve, spec, stats  # noqa: E402
from harness.traffic import Traffic  # noqa: E402


async def sweep(args) -> list:
    bench = spec.load_benchmark()
    cell = spec.cell(bench, args.workload)
    cfg = spec.config(bench, cell["config"])
    params = spec.traffic(cell["traffic"])
    widths = costs.model_widths(cfg)
    phases: dict = {}
    engine = await serve.set_up(cfg, widths, args.seed, "cuda", phases)
    print(f"setup: {phases}", flush=True)
    loops = asyncio.create_task(engine.start_all_event_loops())
    rows = []
    for rate in (float(r) for r in args.rates.split(",")):
        traffic = Traffic(dict(params, rate_per_s=rate), args.seed, widths["V"])
        reqs = traffic.open_schedule(args.seconds)
        t0 = await serve.open_loop(engine, reqs, args.seconds)
        done = [r for r in reqs if r.done]
        by_due = sorted(done, key=lambda r: r.due)
        q = max(1, len(by_due) // 4)
        first = stats.percentile(stats.ttft_ms(by_due[:q]), 50)
        last = stats.percentile(stats.ttft_ms(by_due[-q:]), 50)
        ttft, tpot = stats.ttft_ms(reqs), stats.tpot_ms(reqs)
        row = dict(rate=rate, requests=len(reqs), failed=len(reqs) - len(done),
                   out_tok_s=stats.tokens_in(reqs, t0, t0 + args.seconds) / args.seconds,
                   ttft_p50_ms=stats.percentile(ttft, 50),
                   ttft_p95_ms=stats.percentile(ttft, 95),
                   tpot_p50_ms=stats.percentile(tpot, 50),
                   tpot_p95_ms=stats.percentile(tpot, 95),
                   backlog_growth=last / first,
                   drained_s=max(r.stamps[-1] for r in done) - (t0 + args.seconds))
        rows.append(row)
        print(json.dumps(row), flush=True)
        await asyncio.sleep(1.0)
    loops.cancel()
    try:
        await loops
    except asyncio.CancelledError:
        pass
    serve.free(engine)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--rates", required=True)
    asyncio.run(sweep(ap.parse_args()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
