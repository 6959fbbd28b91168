"""Process groups and collectives of data parallelism (counterpart of the JAX
package's ``dp`` mesh axis: ``jax.sharding.Mesh``, ``shard_batch`` and
``jax.lax.pmean`` in meshrcnn_tpu/parallel/train_step.py).

One process a rank, each with a full replica of the model on its own device:
``cuda:<local rank>`` under NCCL, the CPU under gloo. A rank takes the rows
``[r*b, (r+1)*b)`` of every global batch of B = world * b rows, as
``shard_map``'s ``P("dp")`` does. The collectives take the group from their
caller (None: the default group):
  * ``all_reduce_mean``: JAX's ``pmean`` of a list of tensors, coalesced into
    one flat buffer a dtype, so a step reduces once, not once a tensor;
  * ``gather_batch``: every rank's output concatenated along the batch, the
    merge of JAX's batch-sharded ``out_specs=P("dp")``. It is one sum
    ``all_reduce`` of a zero-filled [world * b, ...] buffer in which each
    rank wrote its rows, since gloo reduces CUDA tensors but does not gather
    them; the sum is exact, every other slot adds zeros.
"""
from __future__ import annotations

import dataclasses
import os
import types
from typing import Any, List, Optional

import torch
import torch.distributed as dist


def backend_of(device: torch.device | str) -> str:
    """NCCL on the card, gloo on the CPU; nothing falls back to the other."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_from_env(backend: str) -> None:
    """Join the group ``torchrun`` describes in ``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR`` and ``MASTER_PORT``."""
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        if var not in os.environ:
            raise RuntimeError(f"--multihost needs {var} in the environment: start the "
                               "processes with torchrun")
    dist.init_process_group(backend, init_method="env://")


def destroy() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def active() -> bool:
    """Whether this process is a rank of a group (even a group of one)."""
    return dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_rank() -> int:
    """The rank among this host's processes: ``LOCAL_RANK`` under torchrun, else the rank."""
    return int(os.environ.get("LOCAL_RANK", rank()))


def rank_generator(seed: int, rank_: int, device: torch.device | str) -> torch.Generator:
    """The generator of rank ``rank_``'s uniform draws (JAX: ``fold_in(key,
    axis_index)``): seeded from the run's seed and the rank; rank 0's is a
    one-process run's."""
    return torch.Generator(device=device).manual_seed(seed + (rank_ << 32))


def shard_batch(batch, rank_: int, world_: int):
    """The rank's rows ``[r*b, (r+1)*b)`` of every array field of a host batch
    (a dataclass, or an object of array attributes) of B = world * b rows;
    None fields stay None. Raises on a batch that does not split, as
    ``shard_map`` does; nothing is padded or dropped."""
    is_dc = dataclasses.is_dataclass(batch)
    fields = ({f.name: getattr(batch, f.name) for f in dataclasses.fields(batch)} if is_dc
              else dict(vars(batch)))
    B = len(fields["images"])
    if B % world_:
        raise ValueError(f"a batch of {B} does not split over {world_} ranks")
    b = B // world_
    rows = {k: None if v is None else v[rank_ * b:(rank_ + 1) * b] for k, v in fields.items()}
    return dataclasses.replace(batch, **rows) if is_dc else types.SimpleNamespace(**rows)


def all_reduce_mean(tensors: List[torch.Tensor], group=None) -> None:
    """Replace each tensor by its mean over the ranks, in place: one flat
    buffer a dtype, one sum ``all_reduce`` each, then a division by the world
    size (JAX's ``pmean``: ``psum / n``). Every rank ends with the same bits."""
    n = dist.get_world_size(group)
    groups: dict = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    for idx in groups.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        flat.div_(n)
        offset = 0
        for i in idx:
            t = tensors[i]
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def _transport(dtype: torch.dtype) -> torch.dtype:
    """What a leaf travels as: float64 as itself, other floats as float32 and
    integers and booleans as int64, each exactly."""
    if dtype == torch.float64:
        return dtype
    return torch.float32 if dtype.is_floating_point else torch.int64


def tensor_leaves(tree, out: list) -> list:
    """The tensors of ``tree`` (dataclasses, lists, tuples, dicts), in a fixed order."""
    if torch.is_tensor(tree):
        out.append(tree)
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            tensor_leaves(getattr(tree, f.name), out)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            tensor_leaves(x, out)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            tensor_leaves(tree[k], out)
    return out


def _rebuild(tree, it):
    if torch.is_tensor(tree):
        return next(it)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{f.name: _rebuild(getattr(tree, f.name), it)
                                            for f in dataclasses.fields(tree)})
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(x, it) for x in tree)
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    return tree


def gather_batch(tree: Any, group=None) -> Any:
    """Every tensor of ``tree`` (dataclasses, lists, tuples, dicts of tensors;
    each leading with the rank's rows) concatenated along its leading axis
    over the ranks, in rank order, on every rank: one sum ``all_reduce`` a
    transport dtype of a buffer [world, rank's elements] zero but in the
    rank's row."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    leaves = tensor_leaves(tree, [])
    gathered: List[Optional[torch.Tensor]] = [None] * len(leaves)
    groups: dict = {}
    for i, t in enumerate(leaves):
        groups.setdefault(_transport(t.dtype), []).append(i)
    for dtype, idx in groups.items():
        sizes = [leaves[i].numel() for i in idx]
        buf = torch.zeros((n, sum(sizes)), dtype=dtype, device=leaves[idx[0]].device)
        buf[r] = torch.cat([leaves[i].reshape(-1).to(dtype) for i in idx])
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        offset = 0
        for i, size in zip(idx, sizes):
            t = leaves[i]
            gathered[i] = buf[:, offset:offset + size].reshape(
                n * t.shape[0], *t.shape[1:]).to(t.dtype)
            offset += size
    return _rebuild(tree, iter(gathered))
