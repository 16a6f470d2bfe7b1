"""The device: the share of the traced window with no kernel, copy or set
running on it."""

from harness.readings import idle_pct as read  # noqa: F401
