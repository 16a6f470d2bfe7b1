"""The traffic generator: a seed gives the same requests every time, every
seed the same work in another order, and due times are honoured."""

import asyncio
import time

import pytest

from harness import serve
from harness.traffic import BLOCK, Traffic, quantile, van_der_corput

OPEN = {"loop": "open", "arrivals": "poisson", "rate_per_s": 40.0,
        "prompt_len": {"dist": "lognormal", "median": 256, "sigma": 0.6,
                       "min": 16, "max": 2048},
        "output_len": {"dist": "lognormal", "median": 128, "sigma": 0.6,
                       "min": 8, "max": 512}}
UNIFORM = {"dist": "uniform", "min": 8192, "max": 16384}


def test_same_seed_same_requests():
    a = Traffic(OPEN, 2**31 + 11, 152064).open_schedule(10)
    b = Traffic(OPEN, 2**31 + 11, 152064).open_schedule(10)
    assert [(r.prompt, r.output_len, r.due_s) for r in a] == \
        [(r.prompt, r.output_len, r.due_s) for r in b]
    c = Traffic(OPEN, 2**31 + 12, 152064).open_schedule(10)
    assert [r.prompt for r in a] != [r.prompt for r in c]


def test_every_seed_the_same_arrivals_in_another_order():
    a = Traffic(OPEN, 5, 1000).open_schedule(10)
    b = Traffic(OPEN, 6, 1000).open_schedule(10)
    assert len(a) == len(b) == 400
    gaps = lambda rs: sorted(round(y.due_s - x.due_s, 9) for x, y in zip(rs, rs[1:]))
    # Each seed's gaps are the same quantiles but one (its last gap,
    # after the last arrival, is not a gap of the schedule).
    assert a[-1].due_s < 10 and b[-1].due_s < 10
    common = set(gaps(a)) & set(gaps(b))
    assert len(common) >= len(a) - 3
    assert [r.due_s for r in a] != [r.due_s for r in b]


@pytest.mark.parametrize("blocks", [1, 3, 20])
def test_every_seed_has_the_same_lengths_in_each_block(blocks):
    n = blocks * BLOCK
    for which in (0, 1):
        lengths = [sorted(Traffic(OPEN, seed, 1000).lengths(k)[which]
                          for k in range(n)) for seed in (1, 2**31 + 5, 77)]
        assert lengths[0] == lengths[1] == lengths[2]
    orders = [[Traffic(OPEN, seed, 1000).lengths(k) for k in range(n)]
              for seed in (1, 2)]
    assert blocks == 1 or orders[0] != orders[1]


@pytest.mark.parametrize("n", [16, 64, 256])
def test_every_prefix_spreads_over_the_distribution(n):
    """The first n requests' prompt lengths sit within a quantile step or
    two of the distribution's own n quantiles."""
    want = sorted(quantile(OPEN["prompt_len"], (i + 0.5) / n) for i in range(n))
    got = sorted(Traffic(OPEN, 3, 1000).lengths(k)[0] for k in range(n))
    assert abs(sum(got) - sum(want)) / sum(want) < 2.0 / n ** 0.5


def test_lengths_within_their_bounds_and_prompt_ids_in_vocab():
    p = dict(OPEN, prompt_len=UNIFORM)
    t = Traffic(p, 99, 32000)
    for k in range(50):
        r = t.request(k)
        assert 8192 <= r.prompt_len <= 16384 and 8 <= r.output_len <= 512
        assert len(r.prompt) == r.prompt_len
        assert min(r.prompt) >= 1 and max(r.prompt) < 32000


def test_van_der_corput_fills_the_unit_interval():
    xs = sorted(van_der_corput(k, 2) for k in range(15))
    assert xs == [i / 16 for i in range(1, 16)]


class FakeEngine:
    """Streams each request's tokens at once, as fast as it is asked."""

    async def add_request_and_stream(self, raw):
        class Out:
            token_id = 0
        for _ in range(raw.output_len):
            await asyncio.sleep(0)
            yield Out()


def test_due_times_are_honoured():
    reqs = Traffic(OPEN, 3, 1000).open_schedule(1.0)
    t0 = asyncio.run(serve.open_loop(FakeEngine(), reqs, 1.0))
    for r in reqs:
        assert r.due == pytest.approx(t0 + r.due_s)
        assert 0 <= r.sent - r.due < 0.05
        assert r.done and r.stamps[0] >= r.sent
    assert time.perf_counter() - t0 >= reqs[-1].due_s


def test_closed_loop_keeps_its_clients_busy_until_the_close():
    p = {"loop": "closed", "clients": 3, "pool": 10000,
         "prompt_len": {"dist": "uniform", "min": 4, "max": 8},
         "output_len": {"dist": "uniform", "min": 2, "max": 4}}
    reqs = []
    t0 = asyncio.run(serve.closed_loop(FakeEngine(), Traffic(p, 1, 100), 0.2, reqs))
    assert len(reqs) > 3 and all(r.done for r in reqs)
    assert [r.k for r in reqs] == list(range(len(reqs)))
    assert all(r.sent < t0 + 0.2 for r in reqs)


def test_a_pool_that_runs_out_fails_the_run():
    p = {"loop": "closed", "clients": 2, "pool": 5,
         "prompt_len": {"dist": "uniform", "min": 4, "max": 8},
         "output_len": {"dist": "uniform", "min": 2, "max": 4}}
    with pytest.raises(RuntimeError, match="pool"):
        asyncio.run(serve.closed_loop(FakeEngine(), Traffic(p, 1, 100), 0.5, []))
