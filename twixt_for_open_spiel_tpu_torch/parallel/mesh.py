"""The env mesh of a distributed run (``twixt_for_open_spiel_tpu/parallel/
mesh.py``, ported to ``torch.distributed``).

One axis, ``ENV_AXIS``: data parallelism over the env batch (and the
training batch).  JAX's single controller holds a global array laid out
over a ``Mesh`` with a trailing-axis ``NamedSharding``; here every rank
holds its own shard, in memory it owns: rank r of N holds columns
``[r*B/N, (r+1)*B/N)`` of a global batch of B envs.  That is the column
order of JAX's mesh over ``jax.devices()[:N]``, so a rank's shard and
JAX's ``addressable_shards[r]`` compare directly.

:class:`EnvMesh` is the rank's record (rank, size, device, group) that
the sharded functions take.  JAX's layout objects (``env_sharding``,
``replicated``, ``trailing_env_spec(s)``, ``jnp_ndim``) have no torch
counterpart: a shard is a plain tensor, and "replicated" parameters are
copies that :func:`broadcast_params` makes equal to rank 0's, and that
:func:`replicas_differ` checks bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist

from twixt_for_open_spiel_tpu_torch.models.selfplay import Sample

ENV_AXIS = "env"


def hosts_major_order(devices: Sequence) -> list:
    """Order devices hosts-major: each host's chips contiguous, hosts in
    process order, chips in id order within a host.

    A pure function of the records' ``(process_index, id)`` attributes,
    kept from the JAX package so that a layout of many hosts can be tested
    without them.  Under torchrun the ranks of one node are contiguous
    already (``RANK = node_rank * nproc_per_node + LOCAL_RANK``), which is
    this order."""
    return sorted(devices, key=lambda d: (d.process_index, d.id))


def fold_seed(seed: int, i: int) -> int:
    """A generator seed from (seed, i), the role of JAX's ``fold_in``."""
    return (seed * 0x9E3779B97F4A7C15 + i) % (1 << 63)


@dataclass(frozen=True)
class EnvMesh:
    """This rank's place in the env mesh: its ``rank`` of ``size``, the
    ``device`` its shard lives on, and the process ``group`` its
    collectives run over (None: the default group, or no group at all in
    a world of one that never made one)."""

    rank: int
    size: int
    device: torch.device
    group: Any = None

    def columns(self, batch: int) -> slice:
        """This rank's columns of a global batch of ``batch`` envs."""
        if batch % self.size:
            raise ValueError(f"{self.size} ranks do not divide a batch of {batch} envs")
        per = batch // self.size
        return slice(self.rank * per, (self.rank + 1) * per)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks, in place (``psum``)."""
        if self.group is not None or dist.is_initialized():
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` set to rank 0's, in place."""
        if self.group is not None or dist.is_initialized():
            src = 0 if self.group is None else dist.get_global_rank(self.group, 0)
            dist.broadcast(t, src=src, group=self.group)
        return t


def make_env_mesh(device=None, group=None) -> EnvMesh:
    """This rank's :class:`EnvMesh` over ``group`` (default: the default
    group, or a world of one when no group exists).  ``device`` defaults to
    the current card, which :func:`launch.initialize_distributed` set to
    ``cuda:LOCAL_RANK``; the CPU and a card shared by several ranks (over
    a gloo ``group``) are the caller's to ask for."""
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if group is not None or dist.is_initialized():
        rank, size = dist.get_rank(group), dist.get_world_size(group)
    else:
        rank, size = 0, 1
    return EnvMesh(rank, size, torch.device(device), group)


def rank_generator(seed: int, mesh: EnvMesh) -> torch.Generator:
    """The rank's ``torch.Generator`` on its device, seeded with
    ``fold_seed(seed, rank)``: JAX's ``fold_in(key, axis_index)``, so that
    the ranks draw different streams."""
    return torch.Generator(device=mesh.device).manual_seed(fold_seed(seed, mesh.rank))


def shard_env_pytree(tree, mesh: EnvMesh):
    """This rank's columns of a global batch, on its device: a ``BitState``
    or ``State`` (env axis trailing on every leaf), or a time-major
    ``Sample`` (env axis 1)."""
    if isinstance(tree, Sample):
        cols = mesh.columns(tree.weight.shape[1])
        return Sample(*(x[:, cols].to(mesh.device).contiguous() for x in tree))
    cols = mesh.columns(tree.current_player.shape[-1])
    return _map_tensors(lambda x: x[..., cols].to(mesh.device).contiguous(), tree)


def _map_tensors(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    parts = [_map_tensors(fn, x) for x in tree]
    return type(tree)(*parts) if hasattr(tree, "_fields") else type(tree)(parts)


def _broadcast_flat(tensors: Sequence[torch.Tensor], mesh: EnvMesh) -> None:
    """Set every tensor of ``tensors`` to rank 0's, in place: one broadcast
    a dtype, over a flat buffer on the mesh's device."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1).to(mesh.device) for t in same])
        mesh.broadcast(flat)
        offset = 0
        with torch.no_grad():
            for t in same:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()


def broadcast_params(module: torch.nn.Module, mesh: EnvMesh,
                     optimizer: Optional[torch.optim.Optimizer] = None) -> None:
    """Make ``module``'s parameters and buffers, and ``optimizer``'s state,
    rank 0's on every rank: JAX's replicated layout.  A rank whose
    optimizer has no state yet for a parameter (a fresh rank beside a
    restored rank 0) gets zeros of rank 0's layout first, so ``optimizer``
    must be an Adam-family optimizer (``step``, ``exp_avg``,
    ``exp_avg_sq``) once any rank has stepped it."""
    tensors = list(module.parameters()) + list(module.buffers())
    if optimizer is not None:
        flags = torch.tensor([len(optimizer.state)], dtype=torch.int64, device=mesh.device)
        mesh.broadcast(flags)
        if int(flags) and not optimizer.state:
            for group in optimizer.param_groups:
                for p in group["params"]:
                    optimizer.state[p] = {
                        "step": torch.zeros((), dtype=torch.float32),
                        "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
                        "exp_avg_sq": torch.zeros_like(p, memory_format=torch.preserve_format),
                    }
        for group in optimizer.param_groups:
            for p in group["params"]:
                tensors += [optimizer.state[p][k] for k in sorted(optimizer.state.get(p, {}))]
    _broadcast_flat(tensors, mesh)


def param_checksums(module: torch.nn.Module) -> torch.Tensor:
    """One int64 a parameter and buffer of ``module`` (in ``state_dict``
    order), on their device: the sum of the tensor's bytes, byte i
    weighted by ``1 + i % 251``.  A flipped bit moves a byte by a power of
    two below 256, and its weight is below 256 too, so the sum moves."""
    sums = []
    for t in module.state_dict().values():
        raw = t.detach().contiguous().reshape(-1).view(torch.uint8).to(torch.int64)
        weight = torch.arange(raw.numel(), device=raw.device) % 251 + 1
        sums.append((raw * weight).sum())
    return torch.stack(sums)


def replicas_differ(module: torch.nn.Module, mesh: EnvMesh) -> list:
    """Per rank, how many of ``module``'s tensors differ from rank 0's copy
    (by :func:`param_checksums`), the same list on every rank: rank 0's
    checksums go out by one broadcast, and each rank's count comes back in
    one all-reduce of a vector with a slot a rank (the collectives that
    gloo also runs on CUDA tensors)."""
    mine = param_checksums(module).to(mesh.device)
    theirs = mesh.broadcast(mine.clone())
    counts = torch.zeros(mesh.size, dtype=torch.int64, device=mesh.device)
    counts[mesh.rank] = (mine != theirs).sum()
    return mesh.all_reduce(counts).tolist()
