"""The node mesh's two collectives (the `shard_map` collectives of the JAX
package's epoch paths, `ops/kernels.py` :1230 and :1246, :2012 and :2047).

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


def all_gather_tiled(t: torch.Tensor, mesh, axis: int = 1) -> torch.Tensor:
    """Every rank's `t` concatenated along `axis` in rank order (JAX
    `lax.all_gather(..., axis=axis, tiled=True)`), on every rank."""
    x = t.movedim(axis, 0).contiguous()
    if mesh.transport == "host":
        x = _staged(mesh, x)
    out = torch.empty((mesh.shards * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device, pin_memory=mesh.transport == "host")
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, x, group=mesh.group)
    if mesh.transport == "host":
        out = _back(mesh, out, t.device)
    out = out.movedim(0, axis)
    _count(mesh, "all_gather_tiled", out)
    return out
