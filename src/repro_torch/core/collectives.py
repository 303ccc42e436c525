"""Cross-device continuation of the reduction hierarchy.

Port of ``repro/core/collectives.py``. Eq. 13's recurrence does not care
whether a group is an MMA tile or a mesh axis: after the local launch
collapses a shard to its partials, the same recurrence runs across the
mesh's axes. The reference binds axis names through ``shard_map``; here a
rank is one process under ``torch.distributed``, and axis names resolve
against the ``Mesh`` the caller binds (``with bound_mesh(mesh):``, the
counterpart of the enclosing ``shard_map``). Every helper takes axis names,
as the reference's do.

  mesh_world_size, axis_size_of  -- the bound sizes of axes
  fixed_order_combine            -- the deterministic cross-rank sum: an
                                    all-gather, then a left fold in rank
                                    order, bitwise the same on every rank
  replica_bits_agree,
  census_agreement               -- bit equality across ranks (NaN-safe)
  hierarchical_psum,
  local_mma_then_psum            -- an all-reduce per axis
  ring_all_reduce                -- reduce-scatter and gather passes of
                                    point-to-point sends
  compressed_psum,
  hierarchical_grad_reduce       -- int8 with error feedback, summed in
                                    int32 (exact)
  make_sharded_global_norm_sq    -- the clipping statistic of a sharded
                                    tree
  gather_rows                    -- every rank's tensor, in rank order (an
                                    all-gather for a merge that is no sum)
  gather_blocks,
  reduce_scatter_blocks          -- the blocks of a tensor cut along one dim
                                    over mesh axes gathered whole (unequal
                                    blocks padded to the largest), and the
                                    fixed-order sum of whole tensors cut back
                                    into the rank's block (an all-gather and
                                    a rank-order fold of the rank's block:
                                    gloo has no reduce-scatter)
  gather_scatter, sum_forward,
  sum_backward, sum_both         -- the autograd pairs of the sharded step:
                                    all-gather / reduce-scatter (FSDP, and
                                    kv heads gathered over "model"); a
                                    fixed-order all-reduce forward with an
                                    identity backward and its transpose
                                    (Megatron's g and f); the all-reduce
                                    both ways (a statistic summed over the
                                    batch axes)
  traffic                        -- every collective above noted with its
                                    kind, its axes and the bytes it brought
                                    in (the dry run's figures, per kind)

The transport is the process group's (``Mesh.backend``): NCCL where each
rank has a card of its own, gloo for CPU ranks and for several ranks that
share one card (``launch.mesh`` chooses and prints it). gloo takes CUDA
tensors for its all-gather and all-reduce (it copies them through the host
itself, faster than copies made here: PERF.md's data-mesh section) but not
for point-to-point sends, which abort the process. So where the mesh says
so (``Mesh.p2p_through_host``: gloo ranks on a card) the ring's sends and
receives pass host copies, and the result comes back to the rank's device;
every fold and every comparison runs on the rank's own device.

``shard_map_unchecked`` has no counterpart: there is no replication
checker to switch off when every rank is its own process.

Every helper resolves its axes against the bound mesh, or against the
``mesh=`` it is given. The autograd pairs keep the mesh they were called
with for their backward, which may run on another thread (the autograd
engine's, on a card) where no mesh is bound.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Optional, Sequence

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes over the ranks of the process group, ranks laid out in
    row-major order of ``shape`` (the last axis varies fastest).
    ``groups[name]`` is this rank's process group along that axis (None
    for a mesh of one rank); ``backend`` the transport; ``device`` the
    rank's device."""

    shape: tuple
    axis_names: tuple
    rank: int
    groups: dict
    backend: str
    device: torch.device

    @property
    def p2p_through_host(self) -> bool:
        """Point-to-point sends and receives pass host copies of their
        tensors: gloo takes CUDA tensors for all-gather and all-reduce, not
        for sends (see the module doc)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def axis_size(self, name: str) -> int:
        return int(self.shape[self.axis_names.index(name)])

    def axis_index(self, name: str) -> int:
        """This rank's coordinate along ``name``."""
        i = self.axis_names.index(name)
        stride = math.prod(self.shape[i + 1:])
        return (self.rank // stride) % int(self.shape[i])


_BOUND = threading.local()


@contextlib.contextmanager
def bound_mesh(mesh: Mesh):
    """Bind ``mesh`` for the block: axis names in the collectives (and in
    ``mesh_axes=`` of the reduction engine and the optimizer) resolve
    against it."""
    prev = getattr(_BOUND, "mesh", None)
    _BOUND.mesh = mesh
    try:
        yield mesh
    finally:
        _BOUND.mesh = prev


def current_mesh() -> Mesh:
    mesh = getattr(_BOUND, "mesh", None)
    if mesh is None:
        raise RuntimeError("no mesh is bound: call inside `with collectives.bound_mesh(mesh):`")
    return mesh


def _axis(name: str):
    mesh = current_mesh()
    if name not in mesh.axis_names:
        raise ValueError(f"unbound axis name {name!r}; the bound mesh has {mesh.axis_names}")
    return mesh, mesh.groups.get(name)


def axis_size_of(axis_name: str) -> int:
    """Size of a bound mesh axis."""
    mesh, _ = _axis(axis_name)
    return mesh.axis_size(axis_name)


def mesh_world_size(axis_names: Sequence[str]) -> int:
    """Product of the bound sizes of the given mesh axes."""
    world = 1
    for ax in axis_names:
        world *= axis_size_of(ax)
    return world


def _axis_of(ax: str, mesh: Optional[Mesh]):
    if mesh is None:
        return _axis(ax)
    if ax not in mesh.axis_names:
        raise ValueError(f"unbound axis name {ax!r}; the mesh has {mesh.axis_names}")
    return mesh, mesh.groups.get(ax)


# The open traffic records (``traffic``): a plain list, not a thread's own,
# so the collectives of a backward pass on the autograd engine's thread are
# noted too.
_TRAFFIC: list = []


@contextlib.contextmanager
def traffic():
    """Note every collective of this module run inside the block as
    ``(kind, axis, bytes brought into this rank)``: kind "all-gather",
    "reduce-scatter" or "all-reduce" (a fixed-order combine), its bytes the
    gathered rows less the rank's own, which is what the launch meter
    (``reduce.inspect.collective_recv_bytes``) counts of the c10d
    all-gather underneath."""
    records: list = []
    _TRAFFIC.append(records)
    try:
        yield records
    finally:
        _TRAFFIC.remove(records)


def _note(kind: str, ax: str, x: torch.Tensor, size: int) -> None:
    for records in _TRAFFIC:
        records.append((kind, ax, (size - 1) * x.numel() * x.element_size()))


def _all_gather(x: torch.Tensor, ax: str, mesh: Optional[Mesh] = None,
                kind: str = "all-reduce") -> list:
    """The P rows of ``x`` along axis ``ax``, in rank order, on x's device.
    A one-rank mesh has no group and gathers its own row."""
    mesh, group = _axis_of(ax, mesh)
    if group is None:
        return [x]
    size = mesh.axis_size(ax)
    rows = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(rows, x.contiguous(), group=group)
    _note(kind, ax, x, size)
    return rows


def _all_reduce(x: torch.Tensor, ax: str, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A new tensor: ``op`` of ``x`` over axis ``ax`` (x is untouched)."""
    _, group = _axis(ax)
    out = x.clone()
    if group is not None:
        dist.all_reduce(out, op=op, group=group)
    return out


def hierarchical_psum(x: torch.Tensor, axis_names: Sequence[str]) -> torch.Tensor:
    """An all-reduce per mesh axis, in the given order (innermost, thickest
    link first): each collective stays on its own ring."""
    for ax in axis_names:
        x = _all_reduce(x, ax)
    return x


def local_mma_then_psum(x: torch.Tensor, axis_names: Sequence[str], *,
                        backend: Optional[str] = None) -> torch.Tensor:
    """Full sum of a sharded array: the reduction engine on the local shard,
    then the mesh-axis rungs (eq. 13 across the machine). ``backend=None``
    defers to the engine's process default."""
    from repro_torch import reduce as R  # deferred: the engine imports this module

    return hierarchical_psum(R.reduce(x, kind="sum", backend=backend), axis_names)


# ------------------- deterministic fixed-order combine ----------------------


def _fold(rows: list) -> torch.Tensor:
    """``rows[0] + rows[1] + ...`` left to right (a fresh tensor)."""
    acc = rows[0].clone() if len(rows) == 1 else rows[0] + rows[1]
    for row in rows[2:]:
        acc = acc + row
    return acc


def fixed_order_combine(x: torch.Tensor, axis_names: Sequence[str],
                        mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Deterministic cross-rank sum: all-gather the per-rank partials, then
    fold them in rank order (``acc = g[0]; acc = acc + g[i]``), one axis at
    a time. Every rank runs the same fold over the same gathered rows, so
    the result is BITWISE the same on every rank at any rank count (an
    all-reduce's order belongs to the transport)."""
    for ax in axis_names:
        x = _fold(_all_gather(x, ax, mesh))
    return x


# ------------------------- blocks along one dimension -------------------------


def _block_axes(axes) -> tuple:
    """A spec entry's mesh axes as a tuple: "data" -> ("data",)."""
    return (axes,) if isinstance(axes, str) else tuple(axes)


def gather_blocks(x: torch.Tensor, axes, dim: int, mesh: Optional[Mesh] = None,
                  sizes=None) -> torch.Tensor:
    """The whole tensor from the rank blocks of a dim cut over ``axes`` (a
    name or a spec entry's tuple of names, the first the major one): an
    all-gather per axis, the last axis first, the blocks concatenated along
    ``dim`` in rank order. ``sizes``: over one axis, each rank's length
    along ``dim`` where the blocks differ (a rank's block of query heads
    that the ranks do not divide evenly): each block travels padded with
    zeros to the largest, and the padding is stripped in rank order."""
    if sizes is not None and len(set(sizes)) > 1:
        (ax,) = _block_axes(axes)
        pad = list(x.shape)
        pad[dim] = max(sizes) - x.shape[dim]
        rows = _all_gather(torch.cat([x, x.new_zeros(pad)], dim), ax, mesh, kind="all-gather")
        return torch.cat([r.narrow(dim, 0, n) for r, n in zip(rows, sizes)], dim)
    for ax in reversed(_block_axes(axes)):
        rows = _all_gather(x, ax, mesh, kind="all-gather")
        x = rows[0] if len(rows) == 1 else torch.cat(rows, dim)
    return x


def gather_rows(x: torch.Tensor, ax: str, mesh: Optional[Mesh] = None) -> list:
    """Every rank's ``x`` along axis ``ax``, in rank order (an all-gather):
    what a merge that is not a sum folds (the serving steps' partial
    softmaxes and greedy tokens)."""
    return _all_gather(x, ax, mesh, kind="all-gather")


def reduce_scatter_blocks(x: torch.Tensor, axes, dim: int,
                          mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The rank's block along ``dim`` of the sum over ``axes`` of every
    rank's whole ``x``, folded in rank order (the first axis first): the
    transpose of ``gather_blocks``. gloo has no reduce-scatter, so each
    axis is an all-gather of the whole tensors and a fold of the rank's
    block of each: bitwise the same block as folding the whole tensors and
    cutting, on every rank."""
    for ax in _block_axes(axes):
        m, _ = _axis_of(ax, mesh)
        size = m.axis_size(ax)
        if x.shape[dim] % size:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {size} ranks "
                             f"of {ax!r}")
        rows = _all_gather(x, ax, mesh, kind="reduce-scatter")
        n, i = x.shape[dim] // size, m.axis_index(ax)
        x = _fold([r.narrow(dim, i * n, n) for r in rows]).contiguous()
    return x


class _GatherScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, dim, mesh):
        ctx.axes, ctx.dim, ctx.mesh = axes, dim, mesh
        return gather_blocks(x, axes, dim, mesh)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_blocks(g, ctx.axes, ctx.dim, ctx.mesh), None, None, None


class _SumForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        return fixed_order_combine(x, axes, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _SumBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.axes, ctx.mesh = axes, mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return fixed_order_combine(g, ctx.axes, ctx.mesh), None, None


class _SumBoth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.axes, ctx.mesh = axes, mesh
        return fixed_order_combine(x, axes, mesh)

    @staticmethod
    def backward(ctx, g):
        return fixed_order_combine(g, ctx.axes, ctx.mesh), None, None


def gather_scatter(x: torch.Tensor, axes, dim: int, mesh: Mesh) -> torch.Tensor:
    """``gather_blocks`` whose backward is ``reduce_scatter_blocks``: a
    weight stored cut over ``axes`` (FSDP over the batch axes, or kv heads
    over "model") gathered for the ranks to use in different ways, its
    gradient the rank-order sum of theirs, cut back to the rank's block."""
    axes = _block_axes(axes)
    return _GatherScatter.apply(x, axes, dim, mesh) if axes else x


def sum_forward(x: torch.Tensor, axes, mesh: Mesh) -> torch.Tensor:
    """The fixed-order all-reduce forward, the identity backward
    (Megatron's g): the partial sums of a row-parallel product, whose sum
    every rank of ``axes`` then uses alike."""
    axes = _block_axes(axes)
    return _SumForward.apply(x, axes, mesh) if axes else x


def sum_backward(x: torch.Tensor, axes, mesh: Mesh) -> torch.Tensor:
    """The identity forward, the fixed-order all-reduce backward
    (Megatron's f): a tensor every rank of ``axes`` holds alike, feeding
    work that differs by rank, whose gradients add up."""
    axes = _block_axes(axes)
    return _SumBackward.apply(x, axes, mesh) if axes else x


def sum_both(x: torch.Tensor, axes, mesh: Mesh) -> torch.Tensor:
    """The fixed-order all-reduce both ways: the sum over the batch axes of
    a statistic each rank took over its own rows, where each rank's loss
    is its own term of a sum over those ranks."""
    axes = _block_axes(axes)
    return _SumBoth.apply(x, axes, mesh) if axes else x


_INT_OF_WIDTH = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _bits(x: torch.Tensor) -> torch.Tensor:
    """Floats as integers of the same width: equality compares bit patterns
    (NaN-safe, and a last-ulp difference is a difference). Signed views
    stand for the reference's unsigned ones: equality of the bits is the
    same, and torch's unsigned 32- and 64-bit types lack most operations."""
    if x.is_floating_point():
        return x.contiguous().view(_INT_OF_WIDTH[x.element_size()])
    return x


def replica_bits_agree(x: torch.Tensor, axis_names: Sequence[str],
                       mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Bool scalar, the same on every rank: True iff ``x``'s bits are the
    same on every rank along the axes (2-byte floats travel as bytes: gloo
    gathers no 16-bit integers; a 0-d one, a bf16 gate, as a 1-d row)."""
    bits = _bits(x)
    if bits.dtype == torch.int16:
        bits = bits.reshape(-1).view(torch.uint8)
    agree = torch.ones((), dtype=torch.bool, device=x.device)
    for ax in axis_names:
        g = _all_gather(bits, ax, mesh, kind="all-gather")
        for row in g[1:]:
            agree = agree & torch.equal(row, g[0])
    return agree


def census_agreement(row: torch.Tensor, axis_names: Sequence[str]):
    """``(fixed_order_combine(row), replica_bits_agree(combined))``: an
    additive census row combined deterministically, and whether every rank
    arrived at the same bits (False on every rank if one fold desynced)."""
    combined = fixed_order_combine(row, axis_names)
    return combined, replica_bits_agree(combined, axis_names)


# ----------------------------- ring all-reduce ------------------------------


def _global_rank(group, r: int) -> int:
    return r if group is None or group is dist.group.WORLD else dist.get_global_rank(group, r)


def _exchange(mesh: Mesh, group, send: torch.Tensor, to: int, frm: int) -> torch.Tensor:
    """Send ``send`` to group rank ``to`` while receiving as much from
    ``frm``: one batch of point-to-point ops (through host copies where
    ``mesh.p2p_through_host``)."""
    wire = send.contiguous()
    if mesh.p2p_through_host:
        wire = wire.cpu()
    out = torch.empty_like(wire)
    ops = [dist.P2POp(dist.isend, wire, _global_rank(group, to), group),
           dist.P2POp(dist.irecv, out, _global_rank(group, frm), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out.to(send.device)


def ring_all_reduce(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """Ring all-reduce: a reduce-scatter pass and a gather pass, 2(P - 1)
    hops, each moving |x| / P elements to the next rank."""
    mesh, group = _axis(axis_name)
    p = mesh.axis_size(axis_name)
    if p == 1:
        return x
    idx = mesh.axis_index(axis_name)
    flat = x.reshape(-1)
    pad = (-flat.numel()) % p
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    chunks = flat.reshape(p, -1).clone()
    nxt, prv = (idx + 1) % p, (idx - 1) % p
    for t in range(p - 1):
        # each rank adds into the chunk it just received
        got = _exchange(mesh, group, chunks[(idx - t) % p], nxt, prv)
        chunks[(idx - t - 1) % p] += got
    for t in range(p - 1):
        chunks[(idx - t) % p] = _exchange(mesh, group, chunks[(idx - t + 1) % p], nxt, prv)
    out = chunks.reshape(-1)
    if pad:
        out = out[: out.numel() - pad]
    return out.reshape(x.shape)


# ----------------------- compressed (int8 EF) psum ---------------------------


def compressed_psum(x: torch.Tensor, axis_name: str, err: Optional[torch.Tensor] = None):
    """int8 error-feedback all-reduce: add the carried error, agree on one
    scale by a max all-reduce, quantize to int8, sum in int32 (exact),
    dequantize. Returns ``(summed f32, the next step's error carry)``."""
    xf = x.to(torch.float32)
    if err is not None:
        xf = xf + err
    amax = _all_reduce(torch.max(torch.abs(xf)), axis_name, dist.ReduceOp.MAX)
    scale = torch.clamp_min(amax / 127.0, 1e-30)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    new_err = xf - q.to(torch.float32) * scale
    qsum = _all_reduce(q.to(torch.int32), axis_name)
    return qsum.to(torch.float32) * scale, new_err


def hierarchical_grad_reduce(grad: torch.Tensor, *, dense_axes: Sequence[str] = ("data",),
                             compressed_axis: Optional[str] = "pod",
                             err: Optional[torch.Tensor] = None):
    """Gradient all-reduce: exact sums over the dense axes, then int8 with
    error feedback over ``compressed_axis``. The mean is the caller's."""
    g = grad
    for ax in dense_axes:
        g = _all_reduce(g, ax)
    if compressed_axis is not None:
        g, err = compressed_psum(g, compressed_axis, err)
    return g, err


def make_sharded_global_norm_sq(mesh: Mesh, *, backend: Optional[str] = None,
                                deterministic: bool = False):
    """``fn(local_leaves) -> global sum of squares`` over a tree sharded
    across ``mesh``: the engine on the rank's shards, then the mesh rungs,
    with ``mesh`` bound. ``deterministic=True`` takes the engine's
    ``mesh_axes=`` path (the fixed-order combine, bitwise the same on every
    rank) instead of the all-reduce."""
    axis_names = tuple(mesh.axis_names)

    def body(tree):
        from repro_torch import reduce as R  # deferred: see local_mma_then_psum

        with bound_mesh(mesh):
            if deterministic:
                return R.reduce_tree(tree, kind="sumsq", backend=backend, mesh_axes=axis_names)
            return hierarchical_psum(R.reduce_tree(tree, kind="sumsq", backend=backend),
                                     axis_names)

    return body
