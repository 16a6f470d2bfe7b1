"""The ("dp", "tp") layout of the PyTorch port: one process per rank.

A port of ``swiftllm_tpu/parallel/mesh.py``. Where the JAX package runs one
SPMD program over a device mesh, this port runs one process per rank, laid
out as JAX lays out the mesh's devices: rank = dp_rank * tp + tp_rank.

- axis "tp" shards attention heads, FFN channels and the vocab; a step's
  cross-rank traffic is two all-reduces a layer (after ``wo`` and after
  ``w_down``), the embedding's all-reduce and the sampling head's small
  gathers (``parallel/distributed.py``).
- axis "dp" shards sequences: each dp group owns its page pool, its
  feedback buffer and its slice of the step's packed batch.

``PARAM_SPECS`` / ``param_specs`` say which axis of each parameter is split
over tp (None: replicated); ``shard_params`` cuts a whole tree to one rank's
shard. A rank's KV cache is its own ``[L, S_local, lanes_local]``: the
``[K_all ‖ V_all]`` layout of a tp = 1 cache at ``n_kv_eff / tp`` heads, and
under fp8 its own ``FP8_SCALE_LANES`` (the JAX package's ``KV_CACHE_SPEC``
slices the global lane axis into exactly these per-shard blocks).

A single process is the degenerate 1 x 1 mesh (``SINGLE``): every collective
is the identity.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

# An INT4 weight split along its contraction axis: the packed K/2 axis is
# repacked per shard (``shard_int4_in``), not sliced.
PACKED_IN = "packed_in"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the (dp, tp) layout and its process groups
    (``torch.distributed`` groups of its tp peers and of its dp peers; None
    where the axis has size 1)."""

    dp: int = 1
    tp: int = 1
    dp_rank: int = 0
    tp_rank: int = 0
    tp_group: Any = None
    dp_group: Any = None


SINGLE = Mesh()

# (dp, tp) -> (tp groups by dp rank, dp groups by tp rank). new_group is a
# collective call: every rank makes every group, in the same order, once.
_groups: dict[tuple[int, int], tuple[list, list]] = {}

# Backends and the device types whose tensors they take.
_BACKEND_DEVICES = {"gloo": {"cpu", "cuda"}, "nccl": {"cuda"}}


def make_mesh(dp: int, tp: int, device: torch.device | str = "cpu") -> Mesh:
    """This rank's Mesh. With dp * tp > 1 the default process group must be
    up (``distributed.initialize``) with world size dp * tp; its backend
    carries the step's collectives and must take ``device``'s tensors."""
    if dp * tp == 1:
        return SINGLE
    import torch.distributed as dist
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            f"dp_size * tp_size = {dp * tp} runs one process per rank: call "
            "swiftllm_tpu_torch.parallel.distributed.initialize(backend) in "
            "each rank first (torchrun sets the environment it reads)")
    world = dist.get_world_size()
    if world != dp * tp:
        raise ValueError(f"dp_size {dp} x tp_size {tp} needs {dp * tp} ranks, "
                         f"the process group has {world}")
    backend = str(dist.get_backend())
    dev_type = torch.device(device).type
    if dev_type not in _BACKEND_DEVICES.get(backend, ()):
        raise ValueError(f"the {backend!r} backend does not take {dev_type} "
                         "tensors: initialize with a backend that does")
    if (dp, tp) not in _groups:
        tp_groups = ([dist.new_group([d * tp + t for t in range(tp)])
                      for d in range(dp)] if tp > 1 else [None] * dp)
        dp_groups = ([dist.new_group([d * tp + t for d in range(dp)])
                      for t in range(tp)] if dp > 1 else [None] * tp)
        _groups[(dp, tp)] = (tp_groups, dp_groups)
    tp_groups, dp_groups = _groups[(dp, tp)]
    dp_rank, tp_rank = divmod(dist.get_rank(), tp)
    return Mesh(dp, tp, dp_rank, tp_rank, tp_groups[dp_rank],
                dp_groups[tp_rank])


def forget_groups() -> None:
    """Drop the groups made for every (dp, tp): they die with the default
    process group."""
    _groups.clear()


def effective_num_kv_heads(num_kv_heads: int, tp: int) -> int:
    """KV heads actually materialized: replicated up to tp when tp >
    num_kv_heads (each replica serves its q-head group; replicas of head h
    sit next to each other, so q head i still reads kv head i // group)."""
    if tp <= num_kv_heads:
        assert num_kv_heads % tp == 0, \
            f"num_kv_heads={num_kv_heads} not divisible by tp={tp}"
        return num_kv_heads
    assert tp % num_kv_heads == 0, \
        f"tp={tp} not a multiple of num_kv_heads={num_kv_heads}"
    return tp


# --- which axis of each parameter is split over tp ----------------------------
# Weights are replicated over dp. GEMM weights are [L, out, in]: out-sharded
# (column) projections split axis 1, in-sharded (row) ones axis 2.
PARAM_SPECS = {
    "embed": 0,                 # [V, D] vocab-sharded
    "lm_head": 0,               # [V, D] vocab-sharded
    "final_norm": None,
    "inv_freq": None,
    "layers": {
        "attn_norm": None,
        "wq": 1, "wk": 1, "wv": 1,          # [L, n*hd, D]
        "wo": 2,                            # [L, D, n_q*hd]
        "ffn_norm": None,
        "w_gate": 1, "w_up": 1,             # [L, F, D]
        "w_down": 2,                        # [L, D, F]
    },
}

GEMM_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _quantized_spec(axis: int, quant: str) -> dict:
    """The spec of a quantized [L, out, in] projection: the int8 bytes split
    like the weight, the per-row scales with the out axis. An in-sharded
    INT4 weight is repacked per shard (PACKED_IN)."""
    q_key = "q" if quant == "int8" else "q4"
    out_sharded = axis == 1
    q_axis = axis if out_sharded or quant == "int8" else PACKED_IN
    return {q_key: q_axis, "s": 1 if out_sharded else None}


def param_specs(quant: str = "none", quantized_lm_head: bool = False,
                qkv_bias: bool = False,
                lora_targets: tuple[str, ...] = ()) -> dict:
    """PARAM_SPECS for a quantization, a quantized untied ``lm_head`` (split
    on its vocab axis), Qwen2-style biases (split with their projections'
    out axes) and LoRA targets (``lora_<key>`` = {"A": [L, n, r, in], "B":
    [L, n, out, r]}: an out-sharded target splits B's out axis; an
    in-sharded one, ``wo`` or ``w_down``, splits A's contraction axis, so
    the adapter's partial sum joins the projection's all-reduce)."""
    layers = dict(PARAM_SPECS["layers"])
    if quant != "none":
        layers = {k: (_quantized_spec(v, quant) if k in GEMM_KEYS else v)
                  for k, v in layers.items()}
    if qkv_bias:
        layers.update(bq=1, bk=1, bv=1)
    for key in lora_targets:
        layers["lora_" + key] = ({"A": 3, "B": None} if key in ("wo", "w_down")
                                 else {"A": None, "B": 2})
    specs = dict(PARAM_SPECS, layers=layers)
    if lora_targets:
        specs["lora_scale"] = None
    if quantized_lm_head:
        specs["lm_head"] = {("q" if quant == "int8" else "q4"): 0, "s": 0}
    return specs


def shard_int4_in(q4: torch.Tensor, tp_rank: int, tp: int) -> torch.Tensor:
    """Shard ``tp_rank`` of an INT4 weight [..., N, K/2] split along K.

    The packing is split-half (byte j holds column j and column K/2 + j), so
    a contiguous slice of the packed axis would hold two column blocks that
    are not the rank's (the JAX package slices it so, and its in-sharded
    INT4 products pair each rank's activations with other columns). This
    unpacks, takes the rank's K/tp columns and packs them split-half
    again: the shard is ``quantize_int4`` of the rank's column block, with
    the full rows' scales."""
    lo, hi = (q4 << 4) >> 4, q4 >> 4
    full = torch.cat([lo, hi], dim=-1)                       # [..., N, K]
    k = full.shape[-1] // tp
    part = full[..., tp_rank * k:(tp_rank + 1) * k]
    assert k % 2 == 0, "int4 packing needs an even contraction dim per shard"
    return ((part[..., :k // 2] & 0xF) | (part[..., k // 2:] << 4)).contiguous()


def shard_leaf(t: torch.Tensor, axis, tp_rank: int, tp: int) -> torch.Tensor:
    """One tensor's shard: ``axis`` None (replicated), an axis index, or
    PACKED_IN."""
    if axis is None or tp == 1:
        return t
    if axis == PACKED_IN:
        return shard_int4_in(t, tp_rank, tp)
    n = t.shape[axis]
    assert n % tp == 0, f"axis {axis} of {tuple(t.shape)} not divisible by tp={tp}"
    k = n // tp
    # A copy, so that the shard never keeps the whole tensor's storage alive.
    return t.narrow(axis, tp_rank * k, k).clone(
        memory_format=torch.contiguous_format)


def shard_params(tree: dict, specs: dict, tp_rank: int, tp: int) -> dict:
    """Cut a whole parameter tree to tp rank ``tp_rank``'s shard. A leaf
    shared by two keys (a tied ``lm_head`` is ``embed``) stays shared."""
    done: dict[tuple[int, str], torch.Tensor] = {}

    def cut(t, spec):
        if isinstance(t, dict):
            return {k: cut(v, spec[k] if isinstance(spec, dict) else spec)
                    for k, v in t.items()}
        key = (id(t), str(spec))
        if key not in done:
            done[key] = shard_leaf(t, spec, tp_rank, tp)
        return done[key]
    return {k: cut(v, specs.get(k)) for k, v in tree.items()}
