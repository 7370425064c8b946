"""The mesh's collectives: the node axis's two of the epoch paths (the
`shard_map` collectives of the JAX package's `ops/kernels.py` :1230 and
:1246, :2012 and :2047), the gather of per-rank rows of the wave's
per-round path (`all_gather_rows`, the exchange XLA's per-round GSPMD form
makes of the selection's candidates), and the scenario axis's one, the
gather of the lanes at a fan-out's fetch (what JAX's fetch of a
lane-sharded array does).

This module is the only place in the port that calls a `torch.distributed`
collective. Each call adds to the mesh's counters (`NodeMesh.counts`: calls
and bytes of each collective, the bytes of the result on this rank), which
the tests and `chip_smoke.py` read.

Transport (`NodeMesh.transport`): "direct" hands the tensor to the backend
as it is (CPU tensors on gloo, CUDA tensors on NCCL); "host" stages a CUDA
tensor on gloo through a pinned host buffer, explicitly: one copy to the
host, the collective on the host, one copy back (counted in
`NodeMesh.staged_bytes`). The second is how ranks that share one card talk,
since NCCL refuses two ranks on one device.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _count(mesh, name: str, out: torch.Tensor) -> None:
    c = mesh.counts[name]
    c["calls"] += 1
    c["bytes"] += out.numel() * out.element_size()


def _staged(mesh, t: torch.Tensor) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    mesh.staged_bytes += host.numel() * host.element_size()
    return host


def _back(mesh, host: torch.Tensor, device) -> torch.Tensor:
    mesh.staged_bytes += host.numel() * host.element_size()
    return host.to(device)


def pmax(t: torch.Tensor, mesh) -> torch.Tensor:
    """The element-wise maximum of `t` over the mesh's ranks (JAX
    `lax.pmax`), on every rank; `t` is not changed."""
    x = _staged(mesh, t) if mesh.transport == "host" else t.clone()
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=mesh.group)
    out = _back(mesh, x, t.device) if mesh.transport == "host" else x
    _count(mesh, "pmax", out)
    return out


def _all_gather(x: torch.Tensor, mesh, ranks: int) -> torch.Tensor:
    """The rank-order concatenation along axis 0 of every rank's `x`
    (contiguous, equal shapes), staged through the host on the "host"
    transport; on x's device."""
    host = mesh.transport == "host"
    src = _staged(mesh, x) if host else x
    out = torch.empty((ranks * src.shape[0],) + tuple(src.shape[1:]), dtype=src.dtype,
                      device=src.device, pin_memory=host)
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, src, group=mesh.group)
    return _back(mesh, out, x.device) if host else out


def all_gather_tiled(t: torch.Tensor, mesh, axis: int = 1) -> torch.Tensor:
    """Every rank's `t` concatenated along `axis` in rank order (JAX
    `lax.all_gather(..., axis=axis, tiled=True)`), on every rank."""
    out = _all_gather(t.movedim(axis, 0).contiguous(), mesh, mesh.shards).movedim(0, axis)
    _count(mesh, "all_gather_tiled", out)
    return out


def all_gather_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's rows of `t` ([rows, ...], the same shape on every rank)
    concatenated along axis 0 in rank order, on every rank."""
    out = _all_gather(t.contiguous(), mesh, mesh.shards)
    _count(mesh, "all_gather_rows", out)
    return out


def gather_lanes(t: torch.Tensor, mesh) -> torch.Tensor:
    """A fan-out output's lanes from every scenario group, on every rank: the
    [S/k, ...] blocks of a ScenarioMesh's k groups concatenated in lane
    order into [S, ...]. The ranks of one group hold the same block (the
    node axis is replicated), so the first rank's is kept. With one rank
    the block is all S lanes and no collective runs; the call counts
    either way."""
    if mesh.world == 1:
        out = t
    else:
        out = _all_gather(t.contiguous(), mesh, mesh.world)
        if mesh.shards > 1:
            out = out.view(mesh.scenarios, mesh.shards, *t.shape)[:, 0].reshape(
                -1, *t.shape[1:])
    _count(mesh, "gather_lanes", out)
    return out
