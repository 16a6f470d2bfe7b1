"""Process groups, the primary/follower control channel, and the step's
collectives, over ``torch.distributed``.

A port of ``swiftllm_tpu/parallel/distributed.py``. The JAX package runs one
SPMD program per host and needs this channel only across hosts; the port
runs one process per rank, so it needs it for any tp or dp > 1:

- rank 0 (the primary) runs the scheduler and the HTTP front end; every
  other rank (a follower) builds its shard of the model and replays, in
  program order, each op the primary announces: a step (its bucket key and
  packed batch), a swap op (its payload), or stop.
- the channel is a gloo group over CPU tensors (headers, packed batches,
  swap payloads, ``agree_num_blocks``), apart from the group that carries
  the step's collectives, whose backend the caller names.
- the step's collectives: ``all_reduce_tp`` (JAX's ``psum``), ``pmax_tp``,
  ``gather_tp`` and ``gather_dp``. The gathers are sums into the rank's
  slot of a zeroed buffer, which is exact, so every collective is an
  all-reduce of a sum: gloo takes those on CUDA tensors as NCCL does, and
  one code path serves both.

A single process is the degenerate case: ``initialize`` is a no-op without
``WORLD_SIZE``, the channel's calls return their inputs, and every
collective is the identity.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from swiftllm_tpu_torch.parallel.mesh import Mesh, forget_groups


def initialize(backend: str | None = None) -> bool:
    """Join the process group that the standard environment describes
    (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``, as torchrun
    sets them). A no-op without ``WORLD_SIZE`` (or with 1). ``backend``
    ("nccl" or "gloo") carries the step's collectives and must be named:
    none is chosen for the caller. Returns whether a group is up."""
    if dist.is_initialized():
        return True
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return False
    if backend is None:
        raise ValueError(f"WORLD_SIZE={world}: name the backend of the step's "
                         "collectives (nccl or gloo)")
    dist.init_process_group(backend, init_method="env://", world_size=world,
                            rank=int(os.environ["RANK"]))
    _control_group()
    return True


def shutdown() -> None:
    """Leave the process group (before the process exits: a gloo group torn
    down by the interpreter's exit may abort it), and forget every group
    made in it."""
    global _ctrl, _stopped
    if dist.is_initialized():
        dist.destroy_process_group()
    _ctrl, _stopped = None, False
    forget_groups()


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on the process that runs the control plane (scheduler, API)."""
    return not dist.is_initialized() or dist.get_rank() == 0


_ctrl = None


def _control_group():
    """The control channel's gloo group over every rank (made once; a
    collective call, which every rank makes at its first use)."""
    global _ctrl
    if _ctrl is None:
        _ctrl = dist.new_group(backend="gloo")
    return _ctrl


# --- the control channel ---------------------------------------------------------
# Every rank must run the same step, with the same shapes, in the same order
# (the step's collectives pair up across ranks). The primary announces each
# device-touching op here in program order; followers replay it in
# ``follower_loop``.

OP_STEP = 0          # one serving step (the header carries the bucket key)
OP_STEP_LOGITS = 1   # a step with return_logits=True
OP_STOP = 2          # shut the followers down
OP_SWAP_OUT = 3      # KV host offload out (header[1] = payload length)
OP_SWAP_IN = 4       # KV host offload in  (header[1] = payload length)
OP_SWAP_FREE = 5     # free the host pages of dead swapped-out sequences

_SWAP_OPS = (OP_SWAP_OUT, OP_SWAP_IN, OP_SWAP_FREE)


def _header_len() -> int:
    """[op] + every BucketKey field (derived, so a new bucket-variant field
    can never silently truncate the broadcast)."""
    from swiftllm_tpu_torch.worker.batch_builder import BucketKey
    return 1 + len(dataclasses.fields(BucketKey))


def _broadcast(a: np.ndarray) -> np.ndarray:
    t = torch.from_numpy(np.ascontiguousarray(a, np.int32))
    dist.broadcast(t, src=0, group=_control_group())
    return t.numpy()


def exchange_op(op: int = OP_STEP, bucket_key=None,
                flat_batch: np.ndarray | None = None, dp: int = 1):
    """One control-channel round: the primary passes (op, key, flat);
    followers pass nothing (or a buffer of the right length) and receive the
    primary's values. Returns (op, key, flat)."""
    header = np.zeros(_header_len(), np.int32)
    if is_primary():
        header[0] = op
        if op in _SWAP_OPS:
            header[1] = 0 if flat_batch is None else flat_batch.shape[0]
        elif bucket_key is not None:
            header[1:] = dataclasses.astuple(bucket_key)
    header = _broadcast(header)
    op = int(header[0])
    if op == OP_STOP:
        return op, None, None
    if op in _SWAP_OPS:
        # A swap op carries a flat i32 payload instead of a step batch
        # (worker/model.py _encode_swap_payload): every rank replays it so
        # its host pool and its shard of the pages stay in step with rank 0.
        n = int(header[1])
        if flat_batch is None:
            flat_batch = np.zeros(n, np.int32)
        assert flat_batch.shape[0] == n
        return op, None, _broadcast(flat_batch)
    from swiftllm_tpu_torch.worker.batch_builder import BucketKey, packed_len
    bkey = BucketKey(*[int(x) for x in header[1:]])
    # The buffer's length comes from the key through the packer's own
    # formula on every rank.
    n = packed_len(bkey, dp)
    if flat_batch is None:
        flat_batch = np.zeros(n, np.int32)
    assert flat_batch.shape[0] == n, \
        f"primary packed batch is {flat_batch.shape[0]} i32s, key implies {n}"
    return op, bkey, _broadcast(flat_batch)


def broadcast_step(flat_batch: np.ndarray | None, bucket_key=None, dp: int = 1,
                   return_logits: bool = False):
    """Announce rank 0's packed step batch and bucket key to every rank.
    A single process gets its inputs back."""
    if world_size() == 1:
        return flat_batch, bucket_key
    op = OP_STEP_LOGITS if return_logits else OP_STEP
    _, bkey, flat = exchange_op(op, bucket_key, flat_batch, dp)
    return flat, bkey


def broadcast_swap(op: int, payload: np.ndarray) -> None:
    """Primary: announce a swap op and its flat i32 payload to every rank.
    A single process: no-op (the caller applies the payload either way)."""
    if world_size() > 1 and is_primary():
        exchange_op(op, flat_batch=np.ascontiguousarray(payload, np.int32))


_stopped = False


def stop_followers() -> None:
    """Primary: release every follower from its loop. Once: a follower leaves
    at the first stop it sees, so a second one would have no receiver."""
    global _stopped
    if world_size() > 1 and is_primary() and not _stopped:
        _stopped = True
        exchange_op(OP_STOP)


def follower_loop(model) -> None:
    """A follower's serving loop: replay the primary's steps and swap ops on
    this rank's shard until OP_STOP. It may run on any thread: it makes the
    model's card that thread's current one first."""
    from swiftllm_tpu_torch.worker.model import bind_device
    bind_device(model.device)
    while True:
        op, key, flat = exchange_op(dp=model.dp)
        if op == OP_STOP:
            return
        if op == OP_SWAP_OUT:
            model.apply_swap_out(flat)
        elif op == OP_SWAP_IN:
            model.apply_swap_in(flat)
        elif op == OP_SWAP_FREE:
            model.apply_swap_free(flat)
        else:
            model.execute_packed(flat, key, return_logits=(op == OP_STEP_LOGITS))


def agree_num_blocks(num_blocks: int) -> int:
    """Every rank sizes its KV cache as rank 0 does (profiles may differ a
    little between ranks)."""
    if world_size() == 1:
        return num_blocks
    return int(_broadcast(np.asarray([num_blocks], np.int32))[0])


# --- the step's collectives ------------------------------------------------------
# Each takes the rank's Mesh and is the identity where its axis has size 1.

def all_reduce_tp(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum over the tp group, in place (JAX's ``psum``): every rank gets the
    same values."""
    if mesh.tp > 1:
        dist.all_reduce(x, group=mesh.tp_group)
    return x


def _gather(x: torch.Tensor, n: int, rank: int, group) -> torch.Tensor:
    """[n, *x.shape]: every rank's x in its slot, as the sum of buffers that
    are zero outside each rank's own slot (exact)."""
    buf = x.new_zeros((n,) + tuple(x.shape))
    buf[rank] = x
    dist.all_reduce(buf, group=group)
    return buf


def gather_tp(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """[tp, *x.shape], ordered by tp rank (a leading axis of 1 at tp = 1)."""
    if mesh.tp == 1:
        return x[None]
    return _gather(x, mesh.tp, mesh.tp_rank, mesh.tp_group)


def gather_dp(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The dp groups' x concatenated along axis 0, in dp order (JAX's tiled
    ``all_gather`` over "dp")."""
    if mesh.dp == 1:
        return x
    return _gather(x, mesh.dp, mesh.dp_rank, mesh.dp_group).flatten(0, 1)


def pmax_tp(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Elementwise maximum over the tp group (JAX's ``pmax``)."""
    return gather_tp(x, mesh).amax(dim=0) if mesh.tp > 1 else x
