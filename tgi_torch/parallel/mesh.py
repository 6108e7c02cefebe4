"""Device meshes: data-parallel training and ray-split rendering (twin of
``tgi/parallel/mesh.py``).

``tgi``'s mesh is a ``jax.sharding.Mesh`` with the axes ``data`` and
``rays``, and GSPMD partitions one global program over it. The port
keeps the names and maps the axes onto PyTorch's own means:

* ``data`` is the ranks of a ``torch.distributed`` process group, one
  process per device (NCCL on the card, gloo on the CPU), launched with
  ``python -m torch.distributed.run``. Each rank holds its contiguous
  rows of the global batch (:func:`shard_batch`, ``P("data")``) and a
  copy of the weights (:func:`replicate` broadcasts rank 0's). Each rank
  sees only its own rows, so whatever reads across the batch (the
  conditioning swap, minibatch-std, the means that drive ADA, the
  gradients) goes through ``parallel/collectives.py``: the sharded step
  computes ``tgi``'s unsharded one.
* ``rays`` is the devices inside one process. Under
  :func:`ray_constrained`, ``render/renderer.py::importance_render`` cuts
  the ray axis M into contiguous chunks, renders each on its device from
  copies of the planes and the decoder, and concatenates them on the
  first; autograd crosses the devices. A device may repeat in the list:
  that runs the split on one device (the CPU tests, one card).

Without a process group and with one device, :func:`make_mesh` is the
(1, 1) mesh, and every path is the unsharded one.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from tgi_torch import default_device


@dataclass(frozen=True, eq=False)
class Mesh:
    """A (data, rays) mesh as this process sees it: its rank on the data
    axis, its devices along the rays axis, and the process group (None
    without one)."""
    data: int
    rays: int
    rank: int
    devices: tuple
    group: object = None

    @property
    def shape(self) -> dict:
        return {"data": self.data, "rays": self.rays}


def _world():
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _own_devices(rays: int, world: int):
    """This process's devices when the caller names none: its own device,
    or the first ``rays`` cards for a ray split in a one-process run."""
    if rays == 1:
        if torch.cuda.is_available():
            return [torch.device("cuda", torch.cuda.current_device())]
        return [torch.device(default_device())]
    if world > 1 or torch.cuda.device_count() < rays:
        raise ValueError(f"rays={rays}: name this process's devices "
                         f"(devices=[...]); {torch.cuda.device_count()} "
                         f"cards, world size {world}")
    return [torch.device("cuda", i) for i in range(rays)]


def make_mesh(n_devices: int | None = None, data: int | None = None,
              rays: int = 1, devices=None) -> Mesh:
    """Build a (data, rays) mesh over the process group's ranks (data)
    and ``devices``, this process's devices (rays; one may repeat).

    As in ``tgi``, ``n_devices`` takes the first devices (counted over
    all ranks), ``data`` defaults to ``n // rays`` and ``data * rays``
    must be the device count. The data axis is the ranks, so ``data``
    must also be the world size (1 without a process group)."""
    world, rank = _world()
    devices = [torch.device(d) for d in (
        devices if devices is not None else _own_devices(rays, world))]
    if n_devices is not None:
        if n_devices % world:
            raise ValueError(f"n_devices={n_devices} over {world} ranks")
        devices = devices[:n_devices // world]
    n = world * len(devices)
    if data is None:
        data = n // rays
    if data != world:
        raise ValueError(f"data={data}: the data axis is the process "
                         f"group's ranks, and the world size is {world}; "
                         f"{len(devices)} devices of this process go on "
                         f"the rays axis (rays={len(devices)})")
    assert data * rays == n, (data, rays, n)
    joined = dist.is_available() and dist.is_initialized()
    return Mesh(data=data, rays=rays, rank=rank, devices=tuple(devices),
                group=dist.group.WORLD if joined else None)


def init_from_env(device):
    """Join the process group that ``python -m torch.distributed.run``
    describes (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``): NCCL with this rank's card ``cuda:LOCAL_RANK`` when
    ``device`` is a card, else gloo. Returns (this rank's device, whether
    a group was joined here); without ``WORLD_SIZE`` > 1, or in a group
    already, it joins nothing."""
    device = torch.device(device)
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1 or dist.is_initialized():
        return device, False
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method="env://")
    return device, True


@dataclass(frozen=True)
class Sharding:
    """Which axes of a tensor go on which mesh axis (``tgi``'s
    ``NamedSharding``); ``spec`` holds "data", "rays" or None per axis."""
    mesh: Mesh
    spec: tuple

    def split(self, x):
        """The pieces of ``x`` this process holds: the rank's rows along a
        "data" axis, and one contiguous chunk per device along a "rays"
        axis, each on its device (one piece where no axis is "rays")."""
        m = self.mesh
        for axis, name in enumerate(self.spec):
            if name == "data":
                if x.shape[axis] % m.data:
                    raise ValueError(f"axis {axis} of {x.shape[axis]} does "
                                     f"not divide over {m.data} ranks")
                n = x.shape[axis] // m.data
                x = x[(slice(None),) * axis
                      + (slice(m.rank * n, (m.rank + 1) * n),)]
        if "rays" not in self.spec:
            return [x]
        axis = self.spec.index("rays")
        return [c.to(d) for c, d in zip(x.chunk(m.rays, dim=axis),
                                        m.devices)]


def data_sharding(mesh: Mesh, ndim: int = 1) -> Sharding:
    """Shard axis 0 over 'data', replicate the rest."""
    return Sharding(mesh, ("data",) + (None,) * (ndim - 1))


def ray_sharding(mesh: Mesh, axis: int = 1, ndim: int = 3) -> Sharding:
    """Shard the ray axis over 'rays' (default: [N, M, ...] layout)."""
    spec = [None] * ndim
    spec[axis] = "rays"
    return Sharding(mesh, tuple(spec))


_RAY_MESH: contextvars.ContextVar = contextvars.ContextVar("ray_mesh",
                                                          default=None)


@contextlib.contextmanager
def ray_constrained(mesh: Mesh):
    """While active, ``importance_render`` splits its rays over the
    mesh's 'rays' devices (:func:`constrain_ray_axis`), so a whole
    synthesis, step or video render called inside renders its volume in
    chunks although its inputs are whole."""
    token = _RAY_MESH.set(mesh)
    try:
        yield
    finally:
        _RAY_MESH.reset(token)


def constrain_ray_axis(x, axis: int = 1):
    """The pieces of ``x`` along ``axis`` under the active ray mesh: one
    contiguous chunk per 'rays' device, on that device. ``[x]`` outside a
    :func:`ray_constrained` context, or where the axis does not divide
    over the mesh (``tgi``'s no-op cases)."""
    mesh = _RAY_MESH.get()
    if mesh is None or mesh.rays <= 1 or x.shape[axis] % mesh.rays != 0:
        return [x]
    return ray_sharding(mesh, axis, x.ndim).split(x)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def replicate(mesh: Mesh, tree):
    """Rank 0's values in every rank's copy of ``tree``: each tensor leaf
    broadcast from rank 0, in place. Nothing moves without a process
    group."""
    if mesh.group is None:
        return tree

    def bcast(t):
        if isinstance(t, torch.Tensor):
            with torch.no_grad():
                dist.broadcast(t.data, src=0, group=mesh.group)
        return t
    return _tree_map(bcast, tree)


def shard_batch(mesh: Mesh, tree):
    """Every leaf's (a tensor's or an array's) rows of this rank along
    axis 0, as ``P("data")`` gives them, on the leaf's own device (the
    caller places the batch). The batch must divide over the data
    axis."""
    return _tree_map(lambda x: data_sharding(mesh, x.ndim).split(x)[0], tree)
