"""``ops/paged_attention.py:paged_decode_attention`` (and its ``_pend``
variant; ``csrc/paged_decode.cu``): the bound of each step's decode-kind
rows (visible keys only) over the decode kernel's device time."""

from harness import costs
from harness.readings import roofline


def read(run):
    return roofline(run, ("paged_decode_kernel",),
                    lambda w, s: costs.bound_s(*costs.decode_attn(w, s.rows)))
