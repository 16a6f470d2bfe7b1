"""Import hygiene of the PyTorch port: importing every module of
``swiftllm_tpu_torch`` loads neither ``jax`` nor anything of the JAX package
``swiftllm_tpu``, so the port runs on a GPU host without JAX. Checked in a
fresh interpreter, since this test process has JAX loaded already."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import swiftllm_tpu_torch

ROOT = Path(__file__).resolve().parents[1]


def test_port_imports_no_jax():
    names = sorted(m.name for m in pkgutil.walk_packages(
        swiftllm_tpu_torch.__path__, prefix="swiftllm_tpu_torch."))
    assert "swiftllm_tpu_torch.server.api_server" in names
    assert "swiftllm_tpu_torch.ops.paged_attention" in names
    assert {"swiftllm_tpu_torch.parallel.mesh",
            "swiftllm_tpu_torch.parallel.distributed"} <= set(names)
    code = (
        "import importlib, sys\n"
        f"for n in {names!r}:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'jaxlib' or m == 'swiftllm_tpu'\n"
        "             or m.startswith('swiftllm_tpu.'))\n"
        "print(','.join(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "", f"the port loaded: {out.stdout.strip()}"
