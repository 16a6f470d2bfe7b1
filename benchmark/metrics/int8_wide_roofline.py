"""``ops/csrc/wide_matmul.cuh`` through ``int8_matmul`` (T > 256): the
bound of the seven INT8 projections of each step whose token bucket is
above 256 over the wide kernel's device time."""

from harness import costs
from harness.readings import roofline

NARROW_MAX = 256


def launch(w, s):
    if s.tokens <= NARROW_MAX:
        return 0.0
    T = costs.tokens(s.rows)
    return sum(costs.bound_s(*costs.proj_call(w, T, N, K))
               for N, K in costs.projections(w))


def read(run):
    if run.widths["quant"] != "int8":
        return None
    return roofline(run, ("wide_matmul_kernel<false",), launch)
