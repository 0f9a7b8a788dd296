"""The client mesh across GPUs: one process (rank) per GPU.

Counterpart of `hefl_tpu.parallel.mesh`. The JAX package drives its mesh
from one controller; the port runs one rank per card under
`torch.distributed` (NCCL on CUDA, gloo on the CPU), so each card has a
host thread of its own to launch from: a round is host-bound (the
device busy for well under half of its wall time), and one Python thread
launching onto several cards would launch serially.

A :class:`Mesh` is a small value: the world size and this rank, the axis
names and sizes (``"clients"``, ``("hosts", "clients")`` or
``("clients", "ct")``), laid out row-major over ranks ``0 .. size - 1``
as the JAX package lays devices out, one process group per reduction axis
(this rank's host row and client column), and this rank's device. The
constructors follow the JAX arithmetic and errors: `make_mesh` takes
min(num_clients, world) ranks, `make_mesh_2d` clamps, `make_host_mesh`
lays hosts out in rows. Ranks past the mesh's size are not members
(`Mesh.member` False) and take part in none of its collectives.

Constructors called with no process group, or with a `world` other than the
group's, return a layout-only mesh (no groups): the arithmetic, which a
one-rank run and the tests use. Every rank of a group must call a constructor
with the same arguments, in the same order: `dist.new_group` is collective.

`init_mesh(device)` joins the group `torchrun` describes (`RANK`,
`WORLD_SIZE`, `LOCAL_RANK`), or one given explicitly. The JAX package's
`HEFL_MESH_CT` switch, which re-runs its CI suites on the 2-D mesh, has no
counterpart.
"""

from __future__ import annotations

import dataclasses
import math
import os
from datetime import timedelta

import torch
import torch.distributed as dist

from hefl_tpu_torch import resolve_device

CLIENT_AXIS = "clients"
HOST_AXIS = "hosts"
CT_AXIS = "ct"

# Every rendezvous and collective of a world gives up after this long, so a
# rank that dies fails its peers instead of hanging them.
DEFAULT_TIMEOUT_S = 60


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Axis names and sizes over ranks 0 .. size - 1 (row-major), this
    rank's place on them, and the process group of each axis of size > 1
    this rank reduces over (none on a layout-only mesh)."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]
    world: int
    rank: int
    device: torch.device
    backend: str | None = None
    groups: dict = dataclasses.field(default_factory=dict)   # axis -> group
    group: object = None          # every member rank (all axes jointly)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    @property
    def member(self) -> bool:
        return self.rank < self.size

    @property
    def coords(self) -> dict:
        """This rank's index along each axis (row-major)."""
        if not self.member:
            raise ValueError(f"rank {self.rank} is outside the {self.size}-rank mesh")
        return dict(zip(self.axis_names, _coords(self.rank, self.sizes)))

    def axes_group(self, axes: tuple[str, ...]):
        """The process group of a reduction over `axes` jointly: the axis's
        own group for one axis, the mesh's group for all of them."""
        axes = tuple(axes)
        if set(axes) == set(self.axis_names):
            return self.group
        if len(axes) == 1:
            return self.groups.get(axes[0])
        raise ValueError(f"no process group for axes {axes} of a {self.axis_names} mesh")

    def axes_size(self, axes: tuple[str, ...]) -> int:
        return math.prod(self.shape[a] for a in axes)

    def record(self) -> dict:
        """The run record's `mesh` entry: the axes, each axis's size (ct 1
        off the ("clients", "ct") mesh), the world and the backend."""
        return {"axes": list(self.axis_names), **self.shape, "ct": self.shape.get(CT_AXIS, 1),
                "world": self.world, "backend": self.backend}


def _world(world: int | None) -> tuple[int, int, bool]:
    """-> (world, rank, bound): the process group's world and rank when
    `world` is None or equals it, else a layout-only world of `world`."""
    live = dist.is_available() and dist.is_initialized()
    if world is None:
        world = dist.get_world_size() if live else 1
        return world, (dist.get_rank() if live else 0), live and world > 1
    if live and int(world) == dist.get_world_size():
        return int(world), dist.get_rank(), int(world) > 1
    return int(world), 0, False


def _build(axis_names: tuple[str, ...], sizes: tuple[int, ...], world: int | None,
           device) -> Mesh:
    world, rank, bound = _world(world)
    device = torch.device(device) if device is not None else _default_device()
    backend = dist.get_backend() if dist.is_available() and dist.is_initialized() else None
    need = math.prod(sizes)
    groups: dict = {}
    group = None
    if bound and need > 1:
        # dist.new_group is collective over the world: every rank creates
        # every row and column group, in the same order, and keeps its own.
        members = list(range(need))
        group = dist.group.WORLD if need == world else dist.new_group(members)
        for ax, n in enumerate(sizes):
            if n == 1:
                continue
            lines: dict[tuple, list[int]] = {}
            for r in members:
                pos = list(_coords(r, sizes))
                pos[ax] = -1
                lines.setdefault(tuple(pos), []).append(r)
            for ranks in lines.values():
                g = group if len(ranks) == need else dist.new_group(ranks)
                if rank in ranks:
                    groups[axis_names[ax]] = g
    return Mesh(axis_names=axis_names, sizes=tuple(int(s) for s in sizes), world=world,
                rank=rank, device=device, backend=backend, groups=groups, group=group)


def _coords(rank: int, sizes: tuple[int, ...]) -> tuple[int, ...]:
    """A rank's row-major index along each axis."""
    out = []
    for n in reversed(sizes):
        out.append(rank % n)
        rank //= n
    return tuple(reversed(out))


def _default_device() -> torch.device:
    """This rank's card under NCCL (the one `init_mesh` set), else the CPU."""
    if dist.is_available() and dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def client_axes(mesh: Mesh) -> tuple[str, ...]:
    """Mesh axes the federated client dimension shards over (outer-first:
    hosts, then clients on a 2-D mesh)."""
    if HOST_AXIS in mesh.axis_names:
        return (HOST_AXIS, CLIENT_AXIS)
    return (CLIENT_AXIS,)


def client_mesh_size(mesh: Mesh) -> int:
    """Total ranks the client dimension spans."""
    return mesh.axes_size(client_axes(mesh))


def client_index(mesh: Mesh) -> int:
    """This rank's block along the client axes (row-major): its clients are
    block * cpd .. (block + 1) * cpd - 1 of the padded registry."""
    coords = mesh.coords
    idx = 0
    for a in client_axes(mesh):
        idx = idx * mesh.shape[a] + coords[a]
    return idx


def make_mesh(num_clients: int, world: int | None = None, device=None) -> Mesh:
    """1-D mesh over min(num_clients, world) ranks, axis "clients". A count
    that does not divide the mesh is padded by the rounds with masked-out
    slots (`fl.fedavg.pad_index`)."""
    w, _, _ = _world(world)
    return _build((CLIENT_AXIS,), (min(int(num_clients), w),), world, device)


def make_mesh_2d(num_clients: int, ct_shards: int, world: int | None = None,
                 device=None) -> Mesh:
    """2-D ("clients", "ct") mesh: min(num_clients, world // ct) client rows
    of `ct_shards` ranks each (clamped to the world; at least one row).
    Every ct rank of a row trains the row's block."""
    if ct_shards < 1:
        raise ValueError(f"make_mesh_2d: ct_shards={ct_shards} must be >= 1")
    w, _, _ = _world(world)
    ct = min(int(ct_shards), w)
    rows = max(1, min(int(num_clients), w // ct))
    return _build((CLIENT_AXIS, CT_AXIS), (rows, ct), world, device)


def ct_shard_count(mesh: Mesh) -> int:
    """Ciphertext shards this mesh provides (1 off the ("clients", "ct")
    mesh)."""
    return int(mesh.shape.get(CT_AXIS, 1))


def make_host_mesh(num_hosts: int, clients_per_host: int, world: int | None = None,
                   device=None) -> Mesh:
    """2-D ("hosts", "clients") mesh: `num_hosts` rows of `clients_per_host`
    ranks (row-major: host 0 takes the first ranks). The secure round
    reduces within a host first, then across hosts."""
    w, _, _ = _world(world)
    need = int(num_hosts) * int(clients_per_host)
    if w < need:
        raise ValueError(
            f"need {need} devices for a {num_hosts}x{clients_per_host} mesh, have {w}")
    return _build((HOST_AXIS, CLIENT_AXIS), (int(num_hosts), int(clients_per_host)),
                  world, device)


def make_ct_mesh(world: int | None = None, max_devices: int | None = None,
                 device=None) -> Mesh:
    """1-D mesh over the ciphertext-batch axis "ct": every rank of the world
    (or the first `max_devices`). `fl.secure.encrypt_params_sharded` and
    `decrypt_average(..., mesh=)` split the [n_ct] rows over it."""
    w, _, _ = _world(world)
    n = w if max_devices is None else min(w, int(max_devices))
    return _build((CT_AXIS,), (n,), world, device)


def local_client_count(mesh: Mesh, num_clients: int) -> int:
    """Clients trained per rank (>= 1 on a mesh the rounds pad to)."""
    return num_clients // client_mesh_size(mesh)


def host_count(mesh: Mesh) -> int:
    """Host rows this mesh models (1 off the ("hosts", "clients") mesh)."""
    return int(mesh.shape.get(HOST_AXIS, 1))


def init_mesh(device=None, *, backend: str | None = None, init_method: str | None = None,
              rank: int | None = None, world_size: int | None = None,
              timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the process group of this rank and return its device.

    The world comes from the arguments, else from `torchrun`'s environment
    (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`; rendezvous `env://`). Without
    either, no group is joined and this is `resolve_device(device)`.
    `device` "cuda" (or None) means this rank's card, cuda:LOCAL_RANK; the
    backend is NCCL on CUDA and gloo on the CPU unless `backend` says
    otherwise (gloo ranks may share a card). NCCL refuses a world larger
    than the cards present. Every rendezvous and collective times out
    after `timeout_s`."""
    env = os.environ
    world_size = int(world_size if world_size is not None else env.get("WORLD_SIZE", 0) or 0)
    dev = resolve_device(device)
    if world_size < 1:
        return dev
    rank = int(rank if rank is not None else env.get("RANK", 0))
    local = int(env.get("LOCAL_RANK", rank))
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and world_size > torch.cuda.device_count():
        raise ValueError(
            f"init_mesh: a world of {world_size} NCCL ranks needs {world_size} cards, "
            f"have {torch.cuda.device_count()} (NCCL refuses two ranks on one card; "
            "use backend='gloo' to share one)")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=init_method or "env://", rank=rank, world_size=world_size,
            timeout=timedelta(seconds=timeout_s),
            **({"device_id": dev} if backend == "nccl" else {}))
    return dev


__all__ = [
    "CLIENT_AXIS", "CT_AXIS", "HOST_AXIS", "Mesh", "client_axes", "client_index",
    "client_mesh_size", "ct_shard_count", "host_count", "init_mesh", "local_client_count",
    "make_ct_mesh", "make_host_mesh", "make_mesh", "make_mesh_2d",
]
