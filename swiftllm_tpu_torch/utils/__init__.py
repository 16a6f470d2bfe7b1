"""Small shared helpers (reference: swiftllm/utils.py:1-7)."""

KB = 1 << 10
MB = 1 << 20
GB = 1 << 30
TB = 1 << 40


def cdiv(a: int, b: int) -> int:
    """Ceiling division."""
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    """Round x up to the next multiple of m."""
    return cdiv(x, m) * m


def next_power_of_2(x: int) -> int:
    """Smallest power of two >= x (>=1)."""
    if x <= 1:
        return 1
    return 1 << (x - 1).bit_length()


def tile_q_for(q_bucket: int) -> int:
    """Q-tile of the JAX package's attention kernel for a given Q bucket. The
    batch builder aligns every sequence's flat token span to this tile and
    the scheduler budgets tokens in tile-padded units; the port keeps both
    so that the two packages pack the same batches. Minimum 16 rows."""
    if q_bucket == 1:
        return 1
    return min(max(next_power_of_2(q_bucket), 16), 128)
