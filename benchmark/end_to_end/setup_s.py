"""Set-up: from the process's start to the end of the warm-up (kernels
loaded or built, weights drawn and loaded, KV cache sized, graphs
captured)."""


def read(run):
    return run.setup_s
