"""The port's host-side guard on the decode kernel's row contract
(``swiftllm_tpu_torch/worker/model.py:_assert_decode_prefix``) against the
JAX package's (``swiftllm_tpu/worker/model.py:_assert_decode_prefix``).

Valid decode rows must form a contiguous prefix of each dp group's row
axis; a batch that breaks it would give wrong attention on the card, and
the guard turns it into a ValueError before dispatch. Each case runs the
same batch through both guards: both pass, or both raise, naming the same
dp group and valid rows (the text after them says what each package's
kernel would do).
"""

import re
import types

import numpy as np

from swiftllm_tpu.worker.batch_builder import BucketKey as JaxBucketKey
from swiftllm_tpu.worker.model import _assert_decode_prefix as jax_guard
from swiftllm_tpu_torch.worker.batch_builder import BucketKey
from swiftllm_tpu_torch.worker.model import _assert_decode_prefix


def _batch(q_lens, decode_row=None):
    q = np.asarray(q_lens, np.int32)
    d = (np.asarray(decode_row, bool) if decode_row is not None
         else np.ones_like(q, bool))
    return types.SimpleNamespace(q_lens=q, decode_row=d)


def _outcome(guard, key_cls, q_lens, decode_row, q_len, rows, dp):
    key = key_cls(tokens=max(rows, 8), rows=rows, pages=4, q_len=q_len)
    try:
        guard(_batch(q_lens, decode_row), key, dp=dp)
    except ValueError as e:
        return str(e).split(" — ")[0]
    return None


def check(q_lens, decode_row=None, *, q_len=1, rows=8, dp=1, match=None):
    """The port's guard on this batch: passes (``match`` None) or raises a
    message that ``match`` finds; the JAX guard does the same, for the same
    group and rows."""
    got = _outcome(_assert_decode_prefix, BucketKey, q_lens, decode_row,
                   q_len, rows, dp)
    want = _outcome(jax_guard, JaxBucketKey, q_lens, decode_row, q_len,
                    rows, dp)
    assert got == want
    if match is None:
        assert got is None
    else:
        assert got is not None and re.search(match, got), got


def test_valid_prefix_passes():
    check([1, 1, 1, 0, 0, 0, 0, 0])
    check([0] * 8)                                    # empty ok
    check([1] * 8)                                    # full ok


def test_gap_raises():
    check([1, 0, 1, 0, 0, 0, 0, 0], match="contiguous prefix")


def test_valid_row_after_invalid_raises():
    check([0, 0, 0, 0, 0, 0, 0, 1], match="contiguous prefix")


def test_per_dp_group_checked_independently():
    # group 0 a valid prefix, group 1 not.
    check([1, 1, 0, 0] + [0, 1, 0, 0], rows=4, dp=2, match="dp group 1")
    # both groups valid prefixes.
    check([1, 0, 0, 0] + [1, 1, 0, 0], rows=4, dp=2)


def test_mixed_step_checks_decode_rows_only():
    # q_len > 1: prefill rows (decode_row False) may follow decode rows with
    # q_lens > 0; only the decode-kind rows must form the prefix.
    check([1, 1, 4, 4, 0, 0, 0, 0],
          [True, True, False, False, False, False, False, False], q_len=4)
    # a decode row after a prefill row breaks it.
    check([1, 4, 1, 0, 0, 0, 0, 0],
          [True, False, True, False, False, False, False, False], q_len=4,
          match="contiguous prefix")
