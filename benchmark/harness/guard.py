"""The modules a run may not load: JAX, its libraries, and the JAX package
that the program under test was ported from. Compared by the whole
top-level name, since the program's own name (``swiftllm_tpu_torch``)
begins with the JAX package's."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "swiftllm_tpu"})


def forbidden_loaded(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (``sys.modules``)."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None
                                          else modules)}
    return sorted(names & FORBIDDEN)


def keep_out(environ) -> None:
    """Keep libraries that load JAX of their own accord from doing so."""
    environ.setdefault("USE_FLAX", "0")
    environ.setdefault("USE_JAX", "0")
    environ.setdefault("USE_TF", "0")
