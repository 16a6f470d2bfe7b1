"""Build and bind the port's hand-written CUDA kernels, and count launches.

Every kernel has a plain C entry of its own name in a source in ``csrc/``
(a source may hold several: the decode kernel and its deferred-commit
variant share one, the prefill kernel and its bf16-score variant another).
``build_kernels`` compiles each missing source with ``nvcc`` for ``sm_90a``
into ``_build/`` beside this file (one process per source, all started
together, under a file lock, so that ranks started together build once),
names the library by the hash of its source and the headers, and loads it
with ``ctypes``. Nothing is built when a module is imported: the first
launch builds its kernel, or a caller builds them all up front. The
wrappers in ``paged_attention.py``, ``int4_matmul.py``, ``int8_matmul.py``,
``layer_ops.py`` and ``swap_pages.py`` launch through ``launch``, which
runs the C entry on the tensors' card and its current stream and adds one
to ``launch_counts[name]``. Under CUDA graph capture that count is what the
capture queued; ``worker/graphs.py`` takes it back and adds it again at
every replay, so ``launch_counts`` always counts launches queued to run.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import functools
import hashlib
import os
import subprocess
import threading
import weakref
from pathlib import Path

import torch

_HERE = Path(__file__).resolve().parent
CSRC_DIR = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong
# The split-KV arguments of the attention entries: n_split, chunk,
# split_rows, and the partial-state and arrival-counter buffers
# (ops/csrc/splitkv.cuh).
_SPLIT = [_I, _I, _I, _P, _P, _P]

# kernel (C entry) name -> (its source in csrc/, the entry's argument types)
SOURCES = {
    # q, cache, kv_new, page_table, q_lens, seq_lens, kv_slots, out,
    # T, B, Pg, n_q, n_kv, hd, S, layer, page_size, window, kv_fp8, sm_scale,
    # n_split, chunk, split_rows, part_acc, part_ml, counters, stream
    "paged_decode_attention": ("paged_decode.cu",
                               [_P] * 8 + [_I] * 11 + [_F] + _SPLIT + [_P]),
    # q, cache, kv_new, kv_pend, page_table, q_lens, seq_lens, out,
    # T, B, Pg, n_q, n_kv, hd, S, layer, page_size, window, npend, P,
    # sm_scale, n_split, chunk, split_rows, part_acc, part_ml, counters, stream
    "paged_decode_attention_pend": ("paged_decode.cu",
                                    [_P] * 8 + [_I] * 12 + [_F] + _SPLIT + [_P]),
    # q, cache, page_table, q_starts, q_lens, seq_lens, out,
    # B, q_bucket, Pg, n_q, n_kv, hd, S, layer, page_size, window, kv_fp8,
    # sm_scale, n_split, chunk, split_rows, part_acc, part_ml, counters, T,
    # stream
    "paged_prefill_attention": ("paged_prefill.cu",
                                [_P] * 7 + [_I] * 11 + [_F] + _SPLIT + [_I, _P]),
    # q, cache, page_table, q_starts, q_lens, seq_lens, out,
    # B, q_bucket, Pg, n_q, n_kv, hd, S, layer, page_size, sm_scale, stream
    "paged_prefill_attention_bf16s": ("paged_prefill.cu",
                                      [_P] * 7 + [_I] * 9 + [_F, _P]),
    # x, q4, s, y, partials, counters, T, N, K, L, layer, NT, t_tiles,
    # splits, per, grid, stream
    "int4_matmul": ("int4_matmul.cu", [_P] * 6 + [_I] * 10 + [_P]),
    # x, q, s, y, partials, counters, T, N, K, L, layer, NT, t_tiles,
    # splits, per, grid, stream
    "int8_matmul": ("int8_matmul.cu", [_P] * 6 + [_I] * 10 + [_P]),
    # x, r, w, x_out, h, T, D, eps, stream
    "add_rms_norm": ("layer_ops.cu", [_P] * 5 + [_I] * 2 + [_F, _P]),
    # q, k, v, bq, bk, bv, cos, sin, q_out, kv_new, cache, slots,
    # T, n_q, n_kv, hd, S, layer, row_bytes, stream
    "rope_qkv": ("layer_ops.cu", [_P] * 12 + [_I] * 7 + [_P]),
    # the same, kv_new and the cache's rows the fp8 cache row
    "rope_qkv_fp8": ("layer_ops.cu", [_P] * 12 + [_I] * 7 + [_P]),
    # gate, up, out, T, F, stream
    "silu_mul": ("layer_ops.cu", [_P] * 3 + [_I] * 2 + [_P]),
    # src, dst, pages, n_pages, L, src_layer_bytes, dst_layer_bytes,
    # page_bytes, blocks, stream
    "swap_pages": ("swap_pages.cu", [_P] * 3 + [_I] * 2 + [_LL] * 2 + [_I, _I, _P]),
}
KERNELS = tuple(SOURCES)
# C entries that launch no kernel (built from the same sources, never
# counted): the swap pool's allocator, and the yardstick chip_smoke.py times
# the page mover against.
HELPERS = {
    # bytes, &address
    "swap_pool_alloc": ("swap_pages.cu", [_LL, ctypes.POINTER(_P)]),
    # address
    "swap_pool_free": ("swap_pages.cu", [_P]),
    # src, dst, runs (host), n_runs, L, src_layer_bytes, dst_layer_bytes,
    # page_bytes, stream
    "copy_page_runs": ("swap_pages.cu",
                       [_P] * 3 + [_I] * 2 + [_LL] * 2 + [_I, _P]),
}
_ENTRIES = {**SOURCES, **HELPERS}

# Launches of each kernel queued since the last reset_launch_counts(): a
# wrapper adds one where it launches its kernel, and a CUDA graph's replay
# adds the launches its capture recorded (``worker/graphs.py``).
launch_counts: dict[str, int] = dict.fromkeys(KERNELS, 0)

_libs: dict[str, ctypes.CDLL] = {}
_build_lock = threading.Lock()


@contextlib.contextmanager
def _locked():
    """The build lock of this process's threads and of every process that
    builds into ``_build/`` (ranks started together): one builds a missing
    library, the others wait for it and load it."""
    with _build_lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(BUILD_DIR / ".lock", "w") as f:
            fcntl.flock(f, fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(f, fcntl.LOCK_UN)


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _lib_path(src: str) -> Path:
    """Build output of one source, keyed by the hash of the source and of
    every header in csrc/ (what it may include)."""
    h = hashlib.sha256()
    for f in [CSRC_DIR / src] + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(f.read_bytes())
    return BUILD_DIR / f"{Path(src).stem}-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): the "
                           "port's kernels are built with nvcc")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build_kernels(names=KERNELS) -> dict[str, str]:
    """Compile every missing kernel library, one ``nvcc`` per source, all
    started together, and load them. Returns the ``-Xptxas -v`` report
    (registers, shared memory, spills, warnings) of every source that holds
    a kernel asked for, under the name of the first such kernel: the
    report is kept beside its library, so a source built by an earlier run
    gives the report of that build."""
    reports = {}
    with _locked():
        todo = [n for n in names if n not in _libs]
        procs = {}
        for n in todo:
            src = _ENTRIES[n][0]
            out = _lib_path(src)
            if out.exists() or src in procs:
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                   "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                   "-Xptxas", "-v", "-o", str(tmp), str(CSRC_DIR / src)]
            procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True),
                          tmp, out)
        for src, (p, tmp, out) in procs.items():
            log, _ = p.communicate()
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed for {src}:\n{log}")
            out.with_suffix(".ptxas.txt").write_text(log)
            os.replace(tmp, out)
        for n in todo:
            lib = ctypes.CDLL(str(_lib_path(_ENTRIES[n][0])))
            fn = getattr(lib, n)
            fn.argtypes = _ENTRIES[n][1]
            fn.restype = ctypes.c_int
            _libs[n] = lib
        seen = set()
        for n in names:
            src = _ENTRIES[n][0]
            report = _lib_path(src).with_suffix(".ptxas.txt")
            if src not in seen and report.exists():
                seen.add(src)
                reports[n] = report.read_text()
    return reports


def entry(name: str):
    """The C entry ``name`` (a kernel's, or one of HELPERS), built and
    loaded at first use."""
    if name not in _libs:
        build_kernels((name,))
    return getattr(_libs[name], name)


def launch(name: str, device: torch.device, *args, hint: str = "") -> None:
    """Launch kernel ``name``'s C entry with ``args`` on ``device``'s current
    stream, with ``device`` the calling thread's current card meanwhile (the
    current card is per thread, and a thread that never set it is on card 0,
    whatever card the tensors lie on). Raise if the entry reported a CUDA
    error; else count the launch."""
    fn = entry(name)
    with torch.cuda.device(device):
        err = fn(*args, stream(device))
    if err != 0:
        raise RuntimeError(f"{name}: launch failed with CUDA error {err}{hint}")
    launch_counts[name] += 1


def on_cpu(what: str, *tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the plain version's case).
    Otherwise every tensor must be a contiguous, 16-byte-aligned CUDA tensor
    on one device, or this raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError(f"{what} takes all-CPU or all-CUDA tensors on one "
                         f"device, got {[str(t.device) for t in tensors]}")
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what} kernels take contiguous, "
                             "16-byte-aligned tensors")
    return False


# Arrival counters of the kernels' split merges, per (owner, device), and
# the live holders (captured CUDA graphs) that pin each device's buffers.
_counters: dict[tuple[str, torch.device], torch.Tensor] = {}
_holders: dict[torch.device, weakref.WeakSet] = {}


def card(device: torch.device) -> torch.device:
    """``device`` with its index: "cuda" names the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def device_counters(owner: str, device: torch.device, n: int) -> torch.Tensor:
    """``owner``'s int32 counters on ``device``, at least ``n`` of them:
    zeroed when made or grown, and left zero by every launch (the kernels
    reset what they count). A captured CUDA graph writes the buffer it saw
    at every replay, so the buffer never moves while a holder lives
    (``hold_counters``) or a capture runs: a request for more then raises,
    and the caller must size the counters before it captures."""
    device = card(device)
    cnt = _counters.get((owner, device))
    if cnt is None or cnt.numel() < n:
        if _holders.get(device) or (device.type == "cuda"
                                    and torch.cuda.is_current_stream_capturing()):
            raise RuntimeError(
                f"{owner}: {n} split counters asked on {device}, "
                f"{0 if cnt is None else cnt.numel()} held by captured CUDA "
                "graphs; size them before the first capture")
        cnt = torch.zeros(max(n, 2 * (0 if cnt is None else cnt.numel())),
                          dtype=torch.int32, device=device)
        _counters[(owner, device)] = cnt
    return cnt


def hold_counters(device: torch.device, holder: object) -> None:
    """Pin every counter buffer of ``device`` while ``holder`` (an object
    whose graphs write them) lives: ``device_counters`` then raises instead
    of reallocating one."""
    _holders.setdefault(card(device), weakref.WeakSet()).add(holder)


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of the card ``device`` (the split plans
    size their grids by it)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def stream(device: torch.device) -> ctypes.c_void_p:
    """The current stream of the card ``device``."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
