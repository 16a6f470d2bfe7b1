"""The port's examples, ``examples/offline_torch.py`` and
``examples/online_torch.py``, on the CPU.

Each runs in a fresh interpreter with ``--use-dummy true --device cpu`` at
the JAX examples' tiny dummy size (``examples/offline.py:35-40``: 4 layers,
hidden 256, MLP 512, vocab 1,000, GQA group 2; its heads as 4 query and 2
kv heads of 64, a head_dim the CUDA attention kernels take), where the
kernel wrappers run their plain versions. Afterwards the interpreter must have loaded neither
``jax`` nor anything of the JAX package: the examples import only the port.
The offline example's greedy tokens on the kernel path (``use_pallas``, the
default) must equal its tokens on the plain path (``--use-pallas false``);
on the CPU the two give the same logits
(``tests/test_torch_layer_ops.py::test_layer_ops_dispatch``).
"""

import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# Runs an example as a script, then prints the JAX modules it loaded.
RUNNER = (
    "import runpy, sys\n"
    "path, *argv = sys.argv[1:]\n"
    "sys.argv = [path, *argv]\n"
    "sys.path.insert(0, str(__import__('pathlib').Path(path).parent))\n"
    "runpy.run_path(path, run_name='__main__')\n"
    "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
    "             or m == 'jaxlib' or m == 'swiftllm_tpu'\n"
    "             or m.startswith('swiftllm_tpu.'))\n"
    "print('JAX modules:', ','.join(bad))\n")


def run_example(name: str, *args: str) -> str:
    out = subprocess.run(
        [sys.executable, "-c", RUNNER, str(ROOT / "examples" / name),
         "--use-dummy", "true", "--device", "cpu", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    assert out.stdout.rstrip().endswith("JAX modules:"), out.stdout[-500:]
    return out.stdout


def offline_tokens(*args: str) -> dict:
    """seq id -> its output tokens, from the offline example's last lines."""
    out = run_example("offline_torch.py", "--num-decode-steps", "12", *args)
    assert "model ready on cpu" in out and "decode: 11 steps x 4 seqs" in out
    return {int(m.group(1)): [int(t) for t in m.group(2).split(", ")]
            for m in re.finditer(r"seq (\d+): \[([\d, ]+)\]", out)}


def test_offline_example_runs_on_the_cpu():
    got = offline_tokens()
    assert sorted(got) == [0, 1, 2, 3]
    assert all(len(t) == 12 and all(0 <= x < 1000 for x in t) for t in got.values())
    assert got == offline_tokens("--use-pallas", "false")


def test_online_example_runs_on_the_cpu():
    out = run_example("online_torch.py", "--output-len", "6")
    lines = re.findall(r"\[req(\d)\] (\d+) tokens; TTFT [\d.]+ ms, TPOT [\d.]+ ms", out)
    assert sorted(lines) == [(str(i), "6") for i in range(4)], out
    assert "'num_requests_finished': 4" in out
