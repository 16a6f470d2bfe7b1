"""The page mover of swap preemption: whole KV pages between the device cache
and the pinned host swap pool, every layer, in either direction.

The JAX package moves a swapped sequence's pages with a jitted gather and
``device_get`` (out) and ``device_put`` and a scatter (in), staged through
its native host page copy (``swiftllm_tpu/worker/model.py``,
``_swap_gather_fn`` / ``_swap_scatter_fn``, ``apply_swap_out`` /
``apply_swap_in``); none of that is a Pallas kernel. In PyTorch that form
would need device scratch of the whole sequence's pages just when the card
is full, and a copy into a strided pinned slice goes through an unpinned
temporary and synchronises. So the port moves pages with one hand-written
CUDA kernel (``csrc/swap_pages.cu``) that reads the source pages and writes
the destination pages in place, the pinned pool reached by its device
address, on the current stream: a swap-out is ordered after the steps that
wrote its pages, a swap-in before the step that reads them, and the host
never waits.

``swap_pages`` launches it when a tensor lies on the card (the other side a
pinned host tensor, or the same card), and counts the launch; on CPU tensors
it runs ``swap_pages_plain`` (``index_select`` then ``index_copy_``), which
the tests use and ``chip_smoke.py`` holds the kernel against.
"""

from __future__ import annotations

import ctypes
import math
import weakref

import numpy as np
import torch

from swiftllm_tpu_torch.ops import build


def pinned_pool(shape: tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    """An uninitialised host tensor in page-locked, mapped memory of exactly
    its size (``cudaHostAlloc`` in ``csrc/swap_pages.cu``), freed when the
    last view of it goes. PyTorch's pinned allocator would round the request
    up to a power of two, and memory locked with ``cudaHostRegister`` reads
    slower from a kernel."""
    nbytes = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
    addr = ctypes.c_void_p()
    err = build.entry("swap_pool_alloc")(nbytes, ctypes.byref(addr))
    if err != 0:
        raise RuntimeError(f"cudaHostAlloc of {nbytes} B failed with CUDA "
                           f"error {err}")
    buf = (ctypes.c_uint8 * nbytes).from_address(addr.value)
    weakref.finalize(buf, build.entry("swap_pool_free"), addr.value).atexit = False
    return torch.frombuffer(buf, dtype=torch.uint8).view(dtype).view(shape)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A [L, rows, W] tensor as its bytes, [L, rows, W * itemsize]."""
    return t.view(torch.uint8)


def page_slots(pages, page_size: int) -> torch.Tensor:
    """The rows of ``pages``, page after page: i64[len(pages) * page_size]."""
    pages = torch.as_tensor(np.asarray(pages, np.int64))
    return (pages[:, None] * page_size + torch.arange(page_size)).reshape(-1)


def swap_pages_plain(src: torch.Tensor, dst: torch.Tensor, src_pages,
                     dst_pages, page_size: int) -> None:
    """Plain version of ``swap_pages``: the source pages' rows of every layer
    gathered with ``index_select``, moved to ``dst``'s device and put in place
    with ``index_copy_``, as bytes. Runs on any devices; it materialises the
    moved pages once on each side."""
    data = _bytes(src).index_select(
        1, page_slots(src_pages, page_size).to(src.device))
    _bytes(dst).index_copy_(1, page_slots(dst_pages, page_size).to(dst.device),
                            data.to(dst.device))


def _check(src, dst, src_pages, dst_pages, page_size):
    """Shapes, types and page ranges; returns the pages as i32[2, n]."""
    if src.dim() != 3 or dst.dim() != 3 or src.shape[0] != dst.shape[0]:
        raise ValueError(f"swap_pages takes two [L, rows, W] tensors, got "
                         f"{tuple(src.shape)} and {tuple(dst.shape)}")
    if src.dtype != dst.dtype or src.shape[2] != dst.shape[2]:
        raise TypeError(f"swap_pages moves rows of one type and width, got "
                        f"{src.dtype} {tuple(src.shape)} and {dst.dtype} "
                        f"{tuple(dst.shape)}")
    if src.shape[1] % page_size or dst.shape[1] % page_size:
        raise ValueError(f"rows ({src.shape[1]}, {dst.shape[1]}) are not whole "
                         f"pages of {page_size}")
    pages = np.stack([np.asarray(src_pages, np.int64).reshape(-1),
                      np.asarray(dst_pages, np.int64).reshape(-1)])
    for side, t, p in (("source", src, pages[0]), ("destination", dst, pages[1])):
        n = t.shape[1] // page_size
        if p.size and (p.min() < 0 or p.max() >= n):
            raise IndexError(f"swap_pages: a {side} page lies outside [0, {n})")
    if np.unique(pages[1]).size != pages.shape[1]:
        raise ValueError("swap_pages: a destination page is named twice")
    return pages.astype(np.int32)


# The mover's grid: 8 persistent blocks move pages each way as fast as a
# block a page and layer does (the host link, or the host's cap on the SMs'
# reads of pinned memory, sets the rate; 4 blocks read slower), and leave
# the other SMs to a step that runs beside a swap (chip_smoke.py
# --sweep-swap, --compare-swap-norm; PERF.md).
MOVER_BLOCKS = 8


def swap_pages(src: torch.Tensor, dst: torch.Tensor, src_pages, dst_pages,
               page_size: int, blocks: int | None = None) -> None:
    """Page ``dst_pages[i]`` of ``dst`` = page ``src_pages[i]`` of ``src``, in
    every layer, in place. ``src`` and ``dst`` are [L, rows, W] of one type
    (a page is ``page_size`` rows); the page lists are host integer
    sequences (numpy or lists), checked here and uploaded as one int32
    device array. On CPU tensors: the plain version. Otherwise one tensor
    lies on the card and the other on the same card or in pinned host
    memory; the kernel moves the pages on the current stream, without
    synchronising, with a grid of ``blocks`` (``MOVER_BLOCKS`` when None; 0
    is a block a page and layer): a measurement knob."""
    pages = _check(src, dst, src_pages, dst_pages, page_size)
    if src.device.type == "cpu" and dst.device.type == "cpu":
        swap_pages_plain(src, dst, pages[0], pages[1], page_size)
        return
    cuda = [t for t in (src, dst) if t.device.type == "cuda"]
    host = [t for t in (src, dst) if t.device.type != "cuda"]
    if len({t.device for t in cuda}) != 1 or any(
            t.device.type != "cpu" or not t.is_pinned() for t in host):
        raise ValueError(f"swap_pages takes CPU tensors, or tensors on one "
                         f"card with any host side pinned, got {src.device} "
                         f"and {dst.device}")
    row_bytes = src.shape[2] * src.element_size()
    page_bytes = page_size * row_bytes
    for t in (src, dst):
        if not t.is_contiguous() or t.data_ptr() % 16 or page_bytes % 16:
            raise ValueError("the page mover takes contiguous, 16-byte-aligned "
                             "tensors whose pages are a multiple of 16 bytes")
    n = pages.shape[1]
    if n == 0:
        return
    dev = cuda[0].device
    pages_dev = torch.from_numpy(pages).pin_memory().to(dev, non_blocking=True)
    build.launch(
        "swap_pages", dev, src.data_ptr(), dst.data_ptr(), pages_dev.data_ptr(),
        n, src.shape[0], src.shape[1] * row_bytes, dst.shape[1] * row_bytes,
        page_bytes, MOVER_BLOCKS if blocks is None else blocks,
        hint=" (is the host side pinned and mapped?)")
