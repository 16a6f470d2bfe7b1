"""What the per-layer metrics read from a traced run (``runner.Run``): a
kernel's share of its roofline, the whole step's share of the peak, the
device's idle share. Each metric's file under ``metrics/`` names what it
reads here.

A roofline share is the least time of the work the window's steps asked of
a kernel (``costs``: one bound a launch, a launch a layer and step) over the
exclusive time of its records in the trace (``trace.Body.seconds``: a
record less what it overlaps of the records before it on its stream).
Nothing to read (no such record, or no such work) is None, never 0.
"""

from __future__ import annotations

from harness import costs


def roofline(run, names: tuple, launch_work) -> float | None:
    """100 x (sum over steps of L x ``launch_work(widths, step)``, the least
    seconds of the work of one layer's launch in that step) / (seconds of
    the records named ``names``)."""
    if run.body is None or run.steps is None:
        return None
    spent = run.body.seconds(names)
    least = sum(launch_work(run.widths, s) for s in run.steps) * run.widths["L"]
    if spent <= 0 or least <= 0:
        return None
    return 100.0 * least / spent


def mfu(run) -> float | None:
    """100 x the model operations of every useful token of the traced
    window's steps / (the window's seconds x the bf16 peak)."""
    if run.body is None or run.steps is None or run.body.window_s <= 0:
        return None
    flops = sum(costs.model_flops(run.widths, s.rows) for s in run.steps)
    if flops <= 0:
        return None
    return 100.0 * flops / (run.body.window_s * costs.BF16_FLOPS_PER_S)


def idle_pct(run) -> float | None:
    """100 x the share of the traced window with nothing on the device."""
    if run.body is None or run.body.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.body.busy_s / run.body.window_s)
