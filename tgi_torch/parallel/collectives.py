"""What a data-parallel step exchanges between ranks (``tgi``'s GSPMD
inserts the same collectives in its global program).

Each function takes the :class:`~tgi_torch.parallel.mesh.Mesh` (or None)
and does nothing without a process group, so the unsharded path runs the
same code. :func:`gather_rows` is differentiable twice: its backward
sums the gradient of every rank's rows (a reduce-scatter written as an
all-reduce, which gloo and NCCL both have), whose own backward gathers
again, so R1's double backward crosses ranks too.

``CALLS`` counts the collectives run (a phase of ``chip_smoke.py``
reads it); the autograd functions count theirs when they run.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

CALLS = 0


def _active(mesh) -> bool:
    return mesh is not None and mesh.group is not None


def _all_reduce(mesh, t):
    global CALLS
    CALLS += 1
    dist.all_reduce(t, group=mesh.group)
    return t


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        global CALLS
        ctx.mesh = mesh
        CALLS += 1
        parts = [torch.empty_like(x) for _ in range(mesh.data)]
        dist.all_gather(parts, x.contiguous(), group=mesh.group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        return _SumRows.apply(g, ctx.mesh), None


class _SumRows(torch.autograd.Function):
    """This rank's rows of the sum over ranks of a [N, ...] tensor."""

    @staticmethod
    def forward(ctx, g, mesh):
        ctx.mesh = mesh
        n = g.shape[0] // mesh.data
        total = _all_reduce(mesh, g.contiguous().clone())
        return total[mesh.rank * n:(mesh.rank + 1) * n].contiguous()

    @staticmethod
    def backward(ctx, h):
        return _GatherRows.apply(h, ctx.mesh), None


def gather_rows(mesh, x):
    """The global batch [N, ...] from every rank's rows [N / ranks, ...],
    in rank order; differentiable (the gradient of each rank's rows is
    the sum over ranks). ``x`` itself without a process group."""
    return _GatherRows.apply(x, mesh) if _active(mesh) else x


def own_rows(mesh, x):
    """This rank's rows of a global-batch tensor; ``x`` without a process
    group."""
    if not _active(mesh):
        return x
    n = x.shape[0] // mesh.data
    return x[mesh.rank * n:(mesh.rank + 1) * n]


def mean_over_ranks(mesh, values: dict) -> dict:
    """Each 0-d tensor of ``values`` averaged over the ranks, in one
    all-reduce (the per-rank means of equal shards average to the global
    mean)."""
    if not _active(mesh) or not values:
        return values
    flat = torch.stack([v.detach().float().reshape(()) for v in
                        values.values()])
    flat = _all_reduce(mesh, flat) / mesh.data
    return dict(zip(values, flat.unbind()))


def mean_grads(mesh, grads: list) -> list:
    """The gradients averaged over the ranks through one flat all-reduce
    per dtype (the reference's training_loop.py:291-296), before they
    are sanitized."""
    if not _active(mesh):
        return grads
    out = list(grads)
    for dtype in dict.fromkeys(g.dtype for g in grads):
        idx = [i for i, g in enumerate(grads) if g.dtype == dtype]
        flat = torch.cat([grads[i].reshape(-1) for i in idx])
        flat = _all_reduce(mesh, flat) / mesh.data
        for i, part in zip(idx, flat.split([grads[i].numel() for i in idx])):
            out[i] = part.view_as(grads[i])
    return out


def from_rank0(mesh, t):
    """Rank 0's tensor ``t`` on every rank (a copy; ``t`` itself without
    a process group)."""
    if not _active(mesh):
        return t
    global CALLS
    CALLS += 1
    t = t.detach().clone()
    dist.broadcast(t, src=0, group=mesh.group)
    return t


def rank0_flag(mesh, flag: bool) -> bool:
    """Rank 0's ``flag`` on every rank (so every rank stops together)."""
    if not _active(mesh):
        return bool(flag)
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend(mesh.group) == "nccl"
              else torch.device("cpu"))
    return bool(from_rank0(mesh, torch.tensor([float(flag)],
                                              device=device)).item())
