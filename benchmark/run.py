"""One run of one cell of the benchmark of ``swiftllm_tpu_torch``.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout. Set-up (from this process's start to the
end of the warm-up) is ``setup_s``; then the cell's traffic is served for
``--seconds``; then the program's state is freed and a sample of what it
served is compared with the plain reference. The last line of standard
output is the result as one JSON object: with ``--trace 0`` the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, read from a
profile of the same window. Without a CUDA card (or with fewer cards than
the cell asks for) it exits with 2 and prints no result; if JAX or the JAX
package was loaded, with 3; if a traced run's profile lost an edge mark of
its window, with 4.

``--control <precision>`` also reads the comparison's control (the
reference in that lower precision) for the runs that set a limit; it is
not part of a measured run.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import asyncio  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

from harness import guard  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", default=None)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    guard.keep_out(os.environ)
    import torch
    from harness.runner import process_age_s
    age = process_age_s() - (time.perf_counter() - T_START)
    from harness import runner, spec, trace
    bench = spec.load_benchmark()
    cell = spec.cell(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"run.py: the cell {args.workload} needs {cell['chips']} CUDA "
              f"card(s), found {found}", file=sys.stderr)
        return 2
    import swiftllm_tpu_torch.server.engine  # noqa: F401
    phases = {"imports": time.perf_counter() - T_START}
    try:
        result = asyncio.run(runner.run_cell(
            bench, args.workload, args.seed, args.seconds, bool(args.trace),
            t_start=T_START, age_at_start=max(0.0, age), phases=phases,
            control=args.control))
    except trace.MarksLost as e:
        print(f"run.py: {e}; no metric is read over another window",
              file=sys.stderr)
        return 4
    bad = guard.forbidden_loaded()
    if bad:
        print(f"run.py: the run loaded {bad}, which the benchmark may not "
              "load", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
