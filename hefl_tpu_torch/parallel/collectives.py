"""Cross-client collectives over the client mesh: the wire layer of a round.

Counterpart of `hefl_tpu.parallel.collectives`. `psum_mod` is the
homomorphic aggregation: an all-reduce of the ranks' ciphertext partials
(int32 residues < p) widened to the int64 carrier `fl.secure.lazy_sum_mod`
uses, then one canonical reduction mod p. The all-reduce is the process
group's (NCCL on the card, gloo on the CPU), as the JAX package's `psum` is
an XLA collective; the reduction after it is plain tensor arithmetic.

Each function takes the mesh and the axis names it reduces over, where the
JAX ones take an axis name inside `shard_map`. An axis of size 1 (and so a
one-rank world) reduces nothing: no collective is issued.
"""

from __future__ import annotations

import contextlib
import os
import tempfile

import torch
import torch.distributed as dist
from torch.distributed import _functional_collectives as funcol

from hefl_tpu_torch.ckks.modular import add_mod
from hefl_tpu_torch.parallel.mesh import CLIENT_AXIS, Mesh, client_axes

# The JAX package's rule, kept though the int64 carrier would hold far more:
# the lazy all-reduce serves up to this many ranks on an axis, the ring
# beyond, so the aggregation certificate and the parity shapes carry over.
MAX_PSUM_CLIENTS = 32


def _axes(axis_names) -> tuple[str, ...]:
    return (axis_names,) if isinstance(axis_names, str) else tuple(axis_names)


def _canonical(total: torch.Tensor, p: torch.Tensor, n: int) -> torch.Tensor:
    """Reduce a sum of n canonical residues (< n * p) to [0, p): conditional
    subtractions of p * 2**k, largest first, division-free."""
    p = p.to(total.dtype)
    for k in reversed(range(max(n - 1, 0).bit_length())):
        step = p << k
        total = torch.where(total >= step, total - step, total)
    return total


def psum_mod(residues: torch.Tensor, p: torch.Tensor, mesh: Mesh, axis_names) -> torch.Tensor:
    """(sum over the ranks of `axis_names` of residues) mod p, residues
    int32[..., L, N] canonical, p broadcastable (int32/int64 [L, 1]).

    Widened to int64, one all-reduce (SUM) over the axis group, the
    canonical reduction, narrowed back to int32."""
    axes = _axes(axis_names)
    group = mesh.axes_group(axes)
    if group is None:
        return residues
    total = funcol.all_reduce(residues.to(torch.int64), "sum", group)
    return _canonical(total, p, mesh.axes_size(axes)).to(torch.int32)


def ring_psum_mod(residues: torch.Tensor, p: torch.Tensor, mesh: Mesh,
                  axis_names) -> torch.Tensor:
    """The modular all-reduce as a ring with no participant cap: n - 1 hops,
    each passing the running buffer one neighbour on (rank i to i + 1) and
    folding it in with a canonical `add_mod`, so every step stays below p.

    gloo's send and recv take only host tensors (a CUDA tensor fails with
    "Bad address" on the H100 host), so under gloo a CUDA buffer makes
    each hop through a host copy; NCCL sends device memory directly."""
    axes = _axes(axis_names)
    group = mesh.axes_group(axes)
    if group is None:
        return residues
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    nxt, prv = (dist.get_global_rank(group, (me + d) % n) for d in (1, -1))
    staged = dist.get_backend(group) == "gloo" and residues.is_cuda
    p = p.to(device=residues.device, dtype=residues.dtype)
    acc = residues
    buf = residues.cpu() if staged else residues.contiguous()
    for _ in range(n - 1):
        incoming = torch.empty_like(buf)
        works = dist.batch_isend_irecv([dist.P2POp(dist.isend, buf, nxt, group),
                                        dist.P2POp(dist.irecv, incoming, prv, group)])
        for w in works:
            w.wait()
        buf = incoming
        acc = add_mod(acc, buf.to(acc.device, non_blocking=True) if staged else buf, p)
    return acc


def reduce_mod(residues: torch.Tensor, p: torch.Tensor, mesh: Mesh, axis_names) -> torch.Tensor:
    """The modular all-reduce over one axis: the lazy all-reduce up to
    MAX_PSUM_CLIENTS ranks, the ring beyond."""
    n = mesh.axes_size(_axes(axis_names))
    return (psum_mod if n <= MAX_PSUM_CLIENTS else ring_psum_mod)(
        residues, p, mesh, axis_names)


def hierarchical_psum_mod(residues: torch.Tensor, p: torch.Tensor, mesh: Mesh,
                          axis_names) -> torch.Tensor:
    """The modular all-reduce over several axes, innermost first: on a
    ("hosts", "clients") mesh each host row sums its clients, then the
    host partials are summed once. Each stage is canonical, so the
    MAX_PSUM_CLIENTS rule holds per axis."""
    for axis in reversed(_axes(axis_names)):
        residues = reduce_mod(residues, p, mesh, axis)
    return residues


def _tree_axes(mesh: Mesh | None, axis_names) -> tuple[str, ...]:
    return client_axes(mesh) if axis_names is None else _axes(axis_names)


def psum_tree(tree: dict, mesh: Mesh | None, axis_names=None) -> dict:
    """The sum of a parameter dict over the ranks of `axis_names` (default:
    the client axes) jointly, added in rank order (an all-gather of the
    leaves laid end to end, one a dtype, then a sequential sum): the same
    bits whatever the backend's all-reduce algorithm, and the JAX package's
    CPU psum's. Off a mesh (None) the dict itself."""
    group = None if mesh is None else mesh.axes_group(_tree_axes(mesh, axis_names))
    if group is None:
        return dict(tree)
    out = {}
    # Keys and dtypes in sorted order: every rank lays the leaves out alike,
    # whatever order its dict was built in.
    for dtype in sorted({t.dtype for t in tree.values()}, key=str):
        keys = sorted(k for k, t in tree.items() if t.dtype == dtype)
        flat = torch.cat([tree[k].reshape(-1) for k in keys])
        parts = [torch.empty_like(flat) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, flat, group=group)
        total = parts[0]
        for part in parts[1:]:
            total = total + part
        for k, part in zip(keys, torch.split(total, [tree[k].numel() for k in keys])):
            out[k] = part.reshape(tree[k].shape)
    return {k: out[k] for k in tree}


def pmean_tree(tree: dict, mesh: Mesh | None, axis_names=None) -> dict:
    """Plaintext FedAvg: the mean of a parameter dict over the ranks of
    `axis_names` (default: the client axes) jointly (`psum_tree`, then
    / n). Off a mesh (None) the dict itself."""
    if mesh is None or mesh.axes_group(_tree_axes(mesh, axis_names)) is None:
        return dict(tree)
    n = mesh.axes_size(_tree_axes(mesh, axis_names))
    return {k: v / n for k, v in psum_tree(tree, mesh, axis_names).items()}


@contextlib.contextmanager
def tracing_group():
    """A process group to trace the functional collectives under: the
    world's when one exists, else a one-rank gloo group on a `file://`
    store in a temporary directory, destroyed on exit. -> the group."""
    if dist.is_initialized():
        yield dist.group.WORLD
        return
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method=f"file://{os.path.join(tmp, 'store')}",
                                rank=0, world_size=1)
        try:
            yield dist.group.WORLD
        finally:
            dist.destroy_process_group()


def _probe_mesh(group, axis_names: tuple[str, ...]) -> Mesh:
    """A one-rank mesh whose "clients" axis reduces over `group` (the group
    of `tracing_group`), so the probes' graphs hold the all-reduce a
    one-rank layout would skip."""
    return Mesh(axis_names=axis_names, sizes=tuple(1 for _ in axis_names), world=1, rank=0,
                device=torch.device("cpu"), groups={CLIENT_AXIS: group}, group=group)


def exact_int_probes(device="cpu") -> dict:
    """The modular all-reduce as declared exact-integer regions (the JAX
    region names): `psum_mod` on the 1-D client mesh and on the 2-D
    ("clients", "ct") mesh, whose ct axis partitions rows and is never
    reduced over. Each runs on a one-rank group (`tracing_group`)."""
    p = torch.full((1, 1), 2**27 - 39, dtype=torch.int64, device=device)
    x = torch.zeros((1, 8), dtype=torch.int32, device=device)

    def region(axis_names):
        def run(v):
            with tracing_group() as group:
                return psum_mod(v, p, _probe_mesh(group, axis_names), CLIENT_AXIS)
        return run

    return {
        "parallel.collectives.psum_mod": (region((CLIENT_AXIS,)), (x,)),
        "parallel.collectives.psum_mod_2d": (region((CLIENT_AXIS, "ct")), (x,)),
    }


def psum_range_probe(prime: int, device="cpu"):
    """Range probe (`analysis.ranges.certify_aggregation`): the lazy
    all-reduce inside `psum_mod`, the int64 sum of canonical residues
    across the client axis before its reduction. Traced under
    `tracing_group`; the interpreter takes the axis's worst-case size
    (MAX_PSUM_CLIENTS) for the group. -> (fn, example_args)."""

    def probe(x):
        return funcol.all_reduce(x.to(torch.int64), "sum", dist.group.WORLD)

    return probe, (torch.zeros((1, 8), dtype=torch.int32, device=device),)


def psum_range_probe_2d(prime: int, device="cpu"):
    """Range probe of the 2-D round's all-reduce: the same lazy sum over
    the "clients" axis of a ("clients", "ct") mesh, on a ct-sharded row
    block. The ct axis partitions rows and adds no summand, so the graph
    reduces over the client group only, which the certifier declares at
    its worst case: the bound holds at any ct shard count.
    -> (fn, example_args)."""

    def probe(x):
        return funcol.all_reduce(x.to(torch.int64), "sum", dist.group.WORLD)

    return probe, (torch.zeros((1, 1, 8), dtype=torch.int32, device=device),)


__all__ = [
    "MAX_PSUM_CLIENTS", "exact_int_probes", "hierarchical_psum_mod",
    "pmean_tree", "psum_mod", "psum_tree", "psum_range_probe", "psum_range_probe_2d", "reduce_mod",
    "ring_psum_mod", "tracing_group",
]
