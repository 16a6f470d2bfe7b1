"""The yardstick: the card's peaks, and the operations and bytes that a
step's useful tokens ask of each kernel and of the whole model.

The work is that of the traffic, not of the implementation: useful tokens
and rows, not padded buckets; only the keys a token can see under the
window; every input byte read once and every output byte written once. A
later change that fuses, splits or replaces a kernel is read against the
same work. A kernel's least time is the larger of its bytes over the HBM
rate and its operations over the bf16 tensor-core peak (``bound_s``), one
launch at a time, as ``chip_smoke.py:bound`` reckons it. The time it is
held against is the kernel's exclusive time in the trace: its records less
what they overlap of the records before them on their stream
(``trace.Body``), so that a programmatic launch's wait at its grid barrier
counts for the kernel it waits on.

A step is a list of rows ``(n_tokens, cached, samples)``: the tokens it
feeds, the tokens of the row already in the cache, and whether it samples.
A row of one token is decode-kind (the decode kernel's), a longer one
prefill-kind (the prefill kernel's).
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at its 700 W limit.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
ACT_BYTES = 2                  # bf16 activations


def bound_s(nbytes: float, flops: float) -> float:
    """Least seconds for the work of one launch."""
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S)


def model_widths(cfg: dict) -> dict:
    """The sizes of a configuration file's model, with the bytes a weight
    and a cache row take as it is served."""
    from reference.llama import widths
    w = widths(cfg["published"])
    quant = cfg["engine"].get("quant", "none")
    w["w_bytes"] = {"none": ACT_BYTES, "int8": 1, "int4": 0.5}[quant]
    w["quant"] = quant
    w["row_bytes"] = 2 * w["n_kv"] * w["hd"] * ACT_BYTES   # a bf16 K‖V row
    return w


def visible_sum(first: int, last: int, window: int) -> int:
    """Sum over positions p in [first, last] of the keys p sees: p + 1, at
    most ``window``."""
    if last < first:
        return 0
    if not window:
        return (first + last + 2) * (last - first + 1) // 2
    cut = min(last, window - 1)          # positions below it see p + 1
    low = (first + cut + 2) * (cut - first + 1) // 2 if cut >= first else 0
    return low + window * (last - max(cut + 1, first) + 1)


def decode_attn(w: dict, rows: list) -> tuple[float, float]:
    """(bytes, operations) of one layer's decode-kind rows: the visible
    history rows read, the new row read and written, q read and out
    written; 4·hd operations a query head and key."""
    nbytes = flops = 0
    for n, cached, _ in rows:
        if n != 1:
            continue
        keys = visible_sum(cached, cached, w["window"])
        nbytes += ((keys - 1) + 2) * w["row_bytes"] + 2 * w["n_q"] * w["hd"] * ACT_BYTES
        flops += 4 * w["n_q"] * w["hd"] * keys
    return nbytes, flops


def prefill_attn(w: dict, rows: list) -> tuple[float, float]:
    """(bytes, operations) of one layer's prefill-kind rows: every key any
    of the row's queries sees read once, q read and out written (the rows'
    own K‖V is stored by the launch before); operations a visible pair."""
    nbytes = flops = 0
    for n, cached, _ in rows:
        if n <= 1:
            continue
        end = cached + n
        keys = min(end, n + w["window"] - 1) if w["window"] else end
        nbytes += keys * w["row_bytes"] + 2 * n * w["n_q"] * w["hd"] * ACT_BYTES
        flops += 4 * w["n_q"] * w["hd"] * visible_sum(cached, end - 1, w["window"])
    return nbytes, flops


def projections(w: dict) -> list:
    """A layer's projections as (N, K): the rows and the contraction of each
    weight."""
    D, qd, kd, F = w["D"], w["n_q"] * w["hd"], w["n_kv"] * w["hd"], w["F"]
    return [(qd, D), (kd, D), (kd, D), (D, qd), (F, D), (F, D), (D, F)]


def proj_call(w: dict, T: int, N: int, K: int) -> tuple[float, float]:
    """(bytes, operations) of one product of T tokens by an [N, K] weight as
    stored: the weight (and a quantized weight's f32 scale a row) read
    once, x read, y written."""
    nbytes = N * K * w["w_bytes"] + T * (K + N) * ACT_BYTES
    if w["quant"] != "none":
        nbytes += 4 * N
    return nbytes, 2 * T * N * K


def tokens(rows: list) -> int:
    return sum(n for n, _, _ in rows)


def sampled(rows: list) -> int:
    return sum(1 for _, _, s in rows if s)


def head_call(w: dict, rows: list) -> tuple[float, float]:
    """The head over the rows that sample."""
    return proj_call(w, sampled(rows), w["V"], w["D"])


def model_flops(w: dict, rows: list) -> float:
    """Operations of the whole model for one step's useful work: every
    projection of every layer on the fed tokens, attention over the visible
    keys, and the head on the rows that sample."""
    T = tokens(rows)
    per_layer = sum(2 * T * N * K for N, K in projections(w))
    per_layer += decode_attn(w, rows)[1] + prefill_attn(w, rows)[1]
    return w["L"] * per_layer + 2 * sampled(rows) * w["V"] * w["D"]
