"""95th percentile over every request of the window of (last token - first
token) / (tokens - 1); a request that never finished counts as missing."""

from harness.stats import percentile, tpot_ms


def read(run):
    return percentile(tpot_ms(run.reqs), 95)
