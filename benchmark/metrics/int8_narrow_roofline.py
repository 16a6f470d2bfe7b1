"""``ops/int8_matmul.py`` at T <= 256 (``csrc/int8_matmul.cu``): the bound
of the seven INT8 projections of each step whose token bucket is at most
256, and of every step's INT8 head over its sampling rows, over the narrow
kernel's device time."""

from harness import costs
from harness.readings import roofline

NARROW_MAX = 256     # a step's token bucket at most this: the narrow kernel


def launch(w, s):
    head = costs.bound_s(*costs.head_call(w, s.rows)) / w["L"]
    if s.tokens > NARROW_MAX:
        return head
    T = costs.tokens(s.rows)
    return head + sum(costs.bound_s(*costs.proj_call(w, T, N, K))
                      for N, K in costs.projections(w))


def read(run):
    if run.widths["quant"] != "int8":
        return None
    return roofline(run, ("int8_matmul_kernel",), launch)
