"""``ops/paged_attention.py:paged_prefill_attention`` (and its ``_bf16s``
variant; ``csrc/paged_prefill.cu``): the bound of each step's prefill-kind
rows (the pairs a query sees under the window) over the prefill kernel's
device time."""

from harness import costs
from harness.readings import roofline


def read(run):
    return roofline(run, ("paged_prefill_kernel",),
                    lambda w, s: costs.bound_s(*costs.prefill_attn(w, s.rows)))
