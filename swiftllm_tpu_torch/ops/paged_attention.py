"""Ragged paged attention for the PyTorch port: three CUDA kernels written by
hand for Hopper (sm_90a), their plain PyTorch versions, and launch counters.

Contract (the same as ``swiftllm_tpu/ops/paged_attention.py``): batch row b
has q_lens[b] query tokens, contiguous in the flat token stream starting at
q_starts[b]; they are the LAST q_lens[b] positions of a sequence whose total
KV length (after this step's cache writes) is seq_lens[b], with KV living in
pages page_table[b]. Causal within the tail: query i of row b has position
seq_lens[b] - q_lens[b] + i.

The cache is ``[L, S, W]``: slot s of layer l is ``cache[l, s]``, page p holds
slots ``p*page_size .. p*page_size+page_size-1``, and the W = 2*n_kv*hd lanes
are laid out ``[K_all ‖ V_all]`` (the n_kv K heads, then the n_kv V heads).

- ``paged_decode_attention`` (TPU: ``_decode_kernel_grouped``): rows with one
  query, packed so flat token b is row b; valid rows must form a prefix of
  the row axis. It writes ``kv_new[b]`` to slot ``kv_slots[b]`` itself.
- ``store_kv`` + ``paged_prefill_attention`` (TPU: ``_tiles_kernel`` with its
  fused span write): the write is a launch of its own, before the attention,
  because the blocks of one GPU grid run at once (see ``csrc/store_kv.cu``).

Each wrapper takes its plain version for tensors on the CPU, and only then.
On a CUDA tensor it launches its kernel or raises; it never falls back. The
kernels are compiled with ``nvcc`` at first use (``build_kernels``) into
``_build/`` beside this file, loaded with ``ctypes``, launched on
``torch.cuda.current_stream()``, and never synchronise. Every launch adds one
to ``launch_counts[name]``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import torch

_HERE = Path(__file__).resolve().parent
CSRC_DIR = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"

# kernel (C entry) name -> its source in csrc/
SOURCES = {
    "paged_decode_attention": "paged_decode.cu",
    "store_kv": "store_kv.cu",
    "paged_prefill_attention": "paged_prefill.cu",
}
KERNELS = tuple(SOURCES)

# Launches of each kernel since the last reset_launch_counts(). Only a
# wrapper that launches its kernel adds to its count.
launch_counts: dict[str, int] = dict.fromkeys(KERNELS, 0)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = {
    # q, cache, kv_new, page_table, q_lens, seq_lens, kv_slots, out,
    # T, B, Pg, n_q, n_kv, hd, S, layer, page_size, sm_scale, stream
    "paged_decode_attention": [_P] * 8 + [_I] * 9 + [_F, _P],
    # kv_new, cache, slots, T, row_bytes, S, layer, stream
    "store_kv": [_P] * 3 + [_I] * 4 + [_P],
    # q, cache, page_table, q_starts, q_lens, seq_lens, out,
    # B, q_bucket, Pg, n_q, n_kv, hd, S, layer, page_size, sm_scale, stream
    "paged_prefill_attention": [_P] * 7 + [_I] * 9 + [_F, _P],
}

_libs: dict[str, ctypes.CDLL] = {}
_build_lock = threading.Lock()


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def max_pages_cap(page_size: int) -> int:
    """Largest pages-per-seq bucket the kernels take. They read the page table
    from device memory, so nothing caps it but the int32 token positions they
    index with (the JAX kernels' scalar-memory caps have no counterpart). It
    lies far above any pool a card holds, so in practice the pool binds."""
    return (2**31 - 1) // page_size


# ---------------------------------------------------------------------------
# Build and bind
# ---------------------------------------------------------------------------

def _lib_path(name: str) -> Path:
    """Build output of one kernel, keyed by the hash of its sources."""
    h = hashlib.sha256()
    for f in (SOURCES[name], "common.cuh"):
        h.update((CSRC_DIR / f).read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): the "
                           "paged-attention kernels are built with nvcc")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build_kernels(names=KERNELS) -> dict[str, str]:
    """Compile every missing kernel library, one ``nvcc`` per source, all
    started together, and load them. Returns each newly built kernel's
    ``-Xptxas -v`` report (registers, shared memory, spills)."""
    reports = {}
    with _build_lock:
        todo = [n for n in names if n not in _libs]
        procs = {}
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        for n in todo:
            out = _lib_path(n)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                   "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                   "-Xptxas", "-v", "-o", str(tmp), str(CSRC_DIR / SOURCES[n])]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True),
                        tmp, out)
        for n, (p, tmp, out) in procs.items():
            log, _ = p.communicate()
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed for {SOURCES[n]}:\n{log}")
            os.replace(tmp, out)
            reports[n] = log
        for n in todo:
            lib = ctypes.CDLL(str(_lib_path(n)))
            fn = getattr(lib, n)
            fn.argtypes = _ARGTYPES[n]
            fn.restype = ctypes.c_int
            _libs[n] = lib
    return reports


def _entry(name: str):
    if name not in _libs:
        build_kernels((name,))
    return getattr(_libs[name], name)


def _check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: launch failed with CUDA error {err} "
                           "(an unsupported head_dim / GQA group returns 1)")
    launch_counts[name] += 1


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the plain version's case).
    Otherwise every tensor must be a contiguous, 16-byte-aligned CUDA tensor
    on one device, or this raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError(f"paged attention takes all-CPU or all-CUDA tensors "
                         f"on one device, got {[str(t.device) for t in tensors]}")
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("paged attention kernels take contiguous, "
                             "16-byte-aligned tensors")
    return False


def _check_types(floats, ints) -> None:
    for t in floats:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the CUDA kernels take bfloat16, got {t.dtype}")
    for t in ints:
        if t.dtype != torch.int32:
            raise TypeError(f"index tensors must be int32, got {t.dtype}")


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


# ---------------------------------------------------------------------------
# Plain versions (the CPU path; the card holds each kernel against these)
# ---------------------------------------------------------------------------

def _row_slots(page_table_row, n_keys: int, page_size: int,
               n_pages: int) -> torch.Tensor:
    """Cache slots of positions 0 .. n_keys-1 of one row, with the page column
    and the page id clamped as the kernels clamp them."""
    pos = torch.arange(n_keys, device=page_table_row.device)
    col = (pos // page_size).clamp(max=page_table_row.shape[0] - 1)
    page = page_table_row[col].long().clamp(0, n_pages - 1)
    return page * page_size + pos % page_size


def _attend(q: torch.Tensor, kv: torch.Tensor, q_pos: torch.Tensor,
            n_kv: int, sm_scale: float) -> torch.Tensor:
    """q [n, n_q, hd] over one row's keys kv [K, W] (key k at position k),
    causal by q_pos [n]; f32 scores and softmax, output in q's dtype."""
    n, n_q, hd = q.shape
    K = kv.shape[0]
    KH = n_kv * hd
    k = kv[:, :KH].float().reshape(K, n_kv, hd)
    v = kv[:, KH:2 * KH].float().reshape(K, n_kv, hd)
    qf = q.float().reshape(n, n_kv, n_q // n_kv, hd)
    s = torch.einsum("nhgd,khd->hgnk", qf, k) * sm_scale
    visible = (torch.arange(K, device=q.device)[None, :]
               <= q_pos.to(q.device)[:, None])                        # [n, K]
    p = torch.softmax(s.masked_fill(~visible, float("-inf")), dim=-1)
    return torch.einsum("hgnk,khd->nhgd", p, v).reshape(n, n_q, hd).to(q.dtype)


def paged_decode_attention_plain(q, cache, kv_new, page_table, q_lens,
                                 seq_lens, kv_slots, layer: int, *,
                                 page_size: int, sm_scale: float):
    """Plain version of ``paged_decode_attention``: the same writes to
    ``cache`` (in place) and the same output."""
    T, n_q, hd = q.shape
    B = page_table.shape[0]
    S, W = cache.shape[1], cache.shape[2]
    n_kv = W // (2 * hd)
    out = torch.zeros_like(q)
    ql, sl, slots = q_lens.tolist(), seq_lens.tolist(), kv_slots.tolist()
    for b in range(min(B, T)):
        if ql[b] <= 0 or sl[b] <= 0:
            continue
        if 0 <= slots[b] < S:
            cache[layer, slots[b]] = kv_new[b]
        hist = _row_slots(page_table[b], sl[b] - 1, page_size, S // page_size)
        kv = torch.cat([cache[layer, hist], kv_new[b:b + 1]])
        out[b:b + 1] = _attend(q[b:b + 1], kv,
                               torch.tensor([sl[b] - 1]), n_kv, sm_scale)
    return out


def store_kv_plain(cache, kv_new, kv_slots, layer: int) -> None:
    """Plain version of ``store_kv``: cache[layer, kv_slots[t]] = kv_new[t]
    for every in-range slot (in place)."""
    keep = (kv_slots >= 0) & (kv_slots < cache.shape[1])
    cache[layer, kv_slots[keep].long()] = kv_new[keep]


def paged_prefill_attention_plain(q, cache, page_table, q_starts, q_lens,
                                  seq_lens, layer: int, *, page_size: int,
                                  sm_scale: float):
    """Plain version of ``paged_prefill_attention``. Tokens of no row are 0."""
    n_q, hd = q.shape[1], q.shape[2]
    S, W = cache.shape[1], cache.shape[2]
    n_kv = W // (2 * hd)
    out = torch.zeros_like(q)
    st, ql, sl = q_starts.tolist(), q_lens.tolist(), seq_lens.tolist()
    for b in range(len(ql)):
        if ql[b] <= 0 or sl[b] <= 0:
            continue
        slots = _row_slots(page_table[b], sl[b], page_size, S // page_size)
        q_pos = torch.arange(sl[b] - ql[b], sl[b])
        out[st[b]:st[b] + ql[b]] = _attend(q[st[b]:st[b] + ql[b]],
                                           cache[layer, slots], q_pos, n_kv,
                                           sm_scale)
    return out


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def paged_decode_attention(q, cache, kv_new, page_table, q_lens, seq_lens,
                           kv_slots, layer: int, *, page_size: int,
                           sm_scale: float):
    """Decode attention with the KV write fused in.

    q [T, n_q, hd], cache [L, S, W] (updated in place), kv_new [T, W],
    page_table i32[B, Pg], q_lens/seq_lens i32[B], kv_slots i32[T>=B].
    Returns out [T, n_q, hd]: row b's attention for every valid row
    (q_lens[b] > 0, flat token b), zeros elsewhere."""
    args = (q, cache, kv_new, page_table, q_lens, seq_lens, kv_slots)
    if _on_cpu(*args):
        return paged_decode_attention_plain(
            *args, layer, page_size=page_size, sm_scale=sm_scale)
    _check_types((q, cache, kv_new), (page_table, q_lens, seq_lens, kv_slots))
    T, n_q, hd = q.shape
    B, Pg = page_table.shape
    _, S, W = cache.shape
    n_kv = W // (2 * hd)
    if T < B or kv_new.shape != (T, W) or 2 * n_kv * hd != W:
        raise ValueError(f"decode shapes: q {tuple(q.shape)}, cache "
                         f"{tuple(cache.shape)}, kv_new {tuple(kv_new.shape)}, "
                         f"page_table {tuple(page_table.shape)}")
    out = torch.empty_like(q)
    err = _entry("paged_decode_attention")(
        q.data_ptr(), cache.data_ptr(), kv_new.data_ptr(),
        page_table.data_ptr(), q_lens.data_ptr(), seq_lens.data_ptr(),
        kv_slots.data_ptr(), out.data_ptr(), T, B, Pg, n_q, n_kv, hd, S,
        int(layer), page_size, float(sm_scale), _stream())
    _check_launch("paged_decode_attention", err)
    return out


def store_kv(cache, kv_new, kv_slots, layer: int) -> None:
    """cache[layer, kv_slots[t]] = kv_new[t] for every in-range slot, in
    place. cache [L, S, W], kv_new [T, W], kv_slots i32[T]."""
    if _on_cpu(cache, kv_new, kv_slots):
        store_kv_plain(cache, kv_new, kv_slots, layer)
        return
    _check_types((cache, kv_new), (kv_slots,))
    T, W = kv_new.shape
    row_bytes = W * kv_new.element_size()
    if cache.shape[2] != W or row_bytes % 16 or kv_slots.shape != (T,):
        raise ValueError(f"store_kv shapes: cache {tuple(cache.shape)}, "
                         f"kv_new {tuple(kv_new.shape)}, "
                         f"kv_slots {tuple(kv_slots.shape)}")
    if T == 0:
        return
    err = _entry("store_kv")(kv_new.data_ptr(), cache.data_ptr(),
                             kv_slots.data_ptr(), T, row_bytes,
                             cache.shape[1], int(layer), _stream())
    _check_launch("store_kv", err)


def paged_prefill_attention(q, cache, page_table, q_starts, q_lens, seq_lens,
                            layer: int, *, page_size: int, sm_scale: float,
                            q_bucket: int):
    """Causal attention of multi-token rows over the cache (their new KV is
    already stored). q [T, n_q, hd]; q_bucket bounds every q_lens[b].
    Returns out [T, n_q, hd], zeros at tokens of no row."""
    args = (q, cache, page_table, q_starts, q_lens, seq_lens)
    if _on_cpu(*args):
        return paged_prefill_attention_plain(
            *args, layer, page_size=page_size, sm_scale=sm_scale)
    _check_types((q, cache), (page_table, q_starts, q_lens, seq_lens))
    T, n_q, hd = q.shape
    B, Pg = page_table.shape
    _, S, W = cache.shape
    n_kv = W // (2 * hd)
    if 2 * n_kv * hd != W:
        raise ValueError(f"cache lanes {W} != 2*n_kv*hd")
    out = torch.zeros_like(q)
    err = _entry("paged_prefill_attention")(
        q.data_ptr(), cache.data_ptr(), page_table.data_ptr(),
        q_starts.data_ptr(), q_lens.data_ptr(), seq_lens.data_ptr(),
        out.data_ptr(), B, int(q_bucket), Pg, n_q, n_kv, hd, S, int(layer),
        page_size, float(sm_scale), _stream())
    _check_launch("paged_prefill_attention", err)
    return out
