"""Median over every request sent in the window of the time from its
sending to its first token; a request that never finished counts as
missing."""

from harness.stats import percentile, ttft_ms


def read(run):
    return percentile(ttft_ms(run.reqs), 50)
