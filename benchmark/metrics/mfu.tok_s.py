"""The whole step (``models/llama.py``): the model operations of every
useful token of the traced window over its seconds times the bf16 peak."""

from harness.readings import mfu as read  # noqa: F401
