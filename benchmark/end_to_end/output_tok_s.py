"""Output tokens delivered inside the window, over the window's seconds."""

from harness.stats import tokens_in


def read(run):
    return tokens_in(run.reqs, run.t0, run.t0 + run.seconds) / run.seconds
