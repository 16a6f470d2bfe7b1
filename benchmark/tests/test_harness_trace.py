"""What is read from a traced window's device records, on made-up records:
the body between the edge marks, the busy union, the idle gaps, the
kernels' shares of their rooflines and the step's share of the peak."""

import pytest

from harness import costs, readings, spec, trace
from harness.runner import Run
from harness.serve import Step

R = trace.Record
MARK = "void at::native::spin_kernel(long)"


def records():
    # The first int8_matmul_kernel starts by programmatic dependent launch
    # while paged_decode_kernel runs on its stream (7) and waits for it.
    return [R("void k0()", 0, 10, 7),
            R(MARK, 100, 200_100, 7),
            R("Memcpy HtoD (Pinned -> Device)", 300_000, 301_000, 7),
            R("void paged_decode_kernel<8>(float*)", 301_000, 311_000, 7),
            R("void int8_matmul_kernel(x)", 305_000, 315_000, 7),
            R("Memcpy HtoD (Pinned -> Device)", 415_000, 416_000, 7),
            R("void int8_matmul_kernel(x)", 416_000, 426_000, 7),
            R(MARK, 500_000, 700_000, 7),
            R("void k1()", 800_000, 800_010, 7)]


def test_the_body_lies_between_the_marks():
    b = trace.body(records())
    assert [r.start for r in b.records] == [300_000, 301_000, 305_000, 415_000, 416_000]
    assert b.window_s == pytest.approx((500_000 - 200_100) / 1e9)
    assert b.busy_s == pytest.approx((15_000 + 11_000) / 1e9)
    # The early launch's wait (305,000-311,000) is the decode kernel's time.
    assert b.seconds(("int8_matmul_kernel",)) == pytest.approx(14_000 / 1e9)
    assert b.seconds(("paged_decode_kernel",)) == pytest.approx(10_000 / 1e9)
    top = b.top_ops()
    assert top[0] == ["int8_matmul_kernel", pytest.approx(14e-6)]
    assert top[1] == ["paged_decode_kernel<8>", pytest.approx(10e-6)]
    gaps = b.idle_gaps()
    assert len(gaps) == 1 and gaps[0][1] == pytest.approx(100e-6)
    assert gaps[0][0].startswith("host dispatching the next step")


def test_a_lost_mark_is_said():
    with pytest.raises(trace.MarksLost, match="kept 1 of the 2 edge marks"):
        trace.body(records()[2:])


@pytest.mark.parametrize("streams, decode_ns, int8_ns", [
    ((1, 1, 1), 10_000, 12_000),     # one stream: both overlaps clipped
    ((1, 2, 2), 10_000, 18_000),     # int8 on its own stream: its overlap only
    ((1, 1, 2), 10_000, 14_000),     # the second int8 on another stream
])
def test_exclusive_time_is_clipped_on_its_stream_only(streams, decode_ns, int8_ns):
    d, a, c = streams
    recs = [R(MARK, 0, 30_000, 1),
            R("paged_decode_kernel", 100_000, 110_000, d),
            R("int8_matmul_kernel", 104_000, 114_000, a),
            R("int8_matmul_kernel", 112_000, 122_000, c),
            R(MARK, 200_000, 230_000, 1)]
    b = trace.body(recs)
    assert b.seconds(("paged_decode_kernel",)) == pytest.approx(decode_ns / 1e9)
    assert b.seconds(("int8_matmul_kernel",)) == pytest.approx(int8_ns / 1e9)
    one_stream = len(set(streams)) == 1
    assert (sum(b.exclusive_ns) / 1e9 == pytest.approx(b.busy_s)) == one_stream


def run_of(body, steps):
    bench = spec.load_benchmark()
    cfg = spec.config(bench, "mistral-7b-int8")
    return Run(cfg=cfg, widths=costs.model_widths(cfg), seconds=1.0, reqs=[], t0=0.0, phases={"warmup": 3.0}, setup_s=9.0,
               stats={"num_steps": 4, "num_tokens_generated": 200},
               steps=steps, body=body)


def test_the_readers_on_a_made_up_window():
    b = trace.body(records())
    steps = [Step(128, [(1, 300, True)] * 64)]
    run = run_of(b, steps)
    w = run.widths
    least = w["L"] * costs.bound_s(*costs.decode_attn(w, steps[0].rows))
    got = spec.reader("metrics", "decode_attn_roofline")(run)
    assert got == pytest.approx(100 * least / 10e-6)
    assert spec.reader("metrics", "mfu.tok_s")(run) == pytest.approx(
        100 * costs.model_flops(w, steps[0].rows) / (b.window_s * 989e12))
    assert spec.reader("metrics", "device_idle_pct.tok_s")(run) == pytest.approx(
        100 * (1 - b.busy_s / b.window_s))
    assert spec.reader("metrics", "tokens_per_step.tok_s")(run) == 50
    assert spec.reader("metrics", "warmup_s")(run) == 3.0
    # No wide step: the wide kernel's reader finds nothing to read.
    assert spec.reader("metrics", "int8_wide_roofline")(run) is None
    assert spec.reader("metrics", "prefill_attn_roofline")(run) is None


def test_every_reader_finds_nothing_in_an_untraced_run():
    run = run_of(None, None)
    for name in ("decode_attn_roofline", "int8_narrow_roofline",
                 "prefill_attn_roofline", "int8_wide_roofline", "mfu.tpot",
                 "device_idle_pct.ttft"):
        assert spec.reader("metrics", name)(run) is None
