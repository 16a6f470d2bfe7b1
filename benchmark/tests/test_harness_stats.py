"""Percentiles and rates over every request of a window, failures counted
as missing."""

import math

import numpy as np
import pytest

from harness import stats
from harness.traffic import Req


@pytest.mark.parametrize("q", [0, 5, 50, 95, 99, 100])
def test_percentile_is_numpys_linear(q):
    xs = list(np.random.default_rng(1).lognormal(size=37))
    assert stats.percentile(xs, q) == pytest.approx(np.percentile(xs, q))


def test_missing_requests_push_the_tail():
    xs = [1.0] * 96 + [stats.MISSING] * 4
    assert stats.percentile(xs, 50) == 1.0
    assert stats.percentile(xs, 95) == 1.0
    assert stats.percentile(xs + [stats.MISSING] * 2, 95) == math.inf


def req(due, stamps, done=True):
    r = Req(k=0, prompt_len=1, output_len=len(stamps))
    r.due, r.stamps, r.done = due, list(stamps), done
    return r


def test_ttft_from_the_due_time_and_tpot_after_the_first_token():
    rs = [req(10.0, [10.5, 10.6, 10.8]), req(11.0, [11.2, 11.3], done=False)]
    assert stats.ttft_ms(rs) == [pytest.approx(500.0), stats.MISSING]
    assert stats.tpot_ms(rs) == [pytest.approx(150.0), stats.MISSING]


def test_tokens_in_counts_only_the_window():
    rs = [req(0, [0.5, 1.0, 1.5, 2.5]), req(0, [1.9, 2.0])]
    assert stats.tokens_in(rs, 1.0, 2.0) == 3


def test_spread_is_the_quartiles_over_the_median():
    assert stats.spread([1, 2, 3, 4, 5, 6, 7]) == pytest.approx((6 - 2) / 4)
