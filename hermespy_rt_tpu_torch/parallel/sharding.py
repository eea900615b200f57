"""Multi-device tracing over ``torch.distributed``: ray- and triangle-sharded.

The counterpart of :mod:`hermespy_rt_tpu.parallel.sharding`, whose
``shard_map`` program becomes one process per rank (SPMD): every rank calls
:func:`trace_paths_sharded` with the same full inputs and gets back the same
full :class:`~hermespy_rt_tpu_torch.tracer.PathsResult`, as the JAX package
returns one global array.

* **Ray sharding.**  The flattened ``(tx, path)`` launch-ray axis is cut
  into contiguous slices over the ``rays`` mesh dimension.  A bounce touches
  only its ray's state, so the forward needs no collective until the
  per-bounce outputs are gathered, and with one triangle shard the shard
  body is the whole bounce-loop choice (:func:`~..tracer.run_bounce_loop`):
  the fused kernels run per shard.
* **Gradients.**  Every rank computes the loss on the gathered outputs, so
  the loss is replicated.  :class:`_GatherRays` therefore hands back only
  this rank's slice of the incoming gradient (no sum), and every replicated
  tensor that enters the shard body passes through :class:`_Replicated`,
  whose backward sums over ``rays``: material, position, velocity, frequency
  and geometry gradients then equal the single-process ones, once and not
  once per rank.  (``torch.distributed.nn.functional``'s collectives would
  sum the replicated loss's gradient once per rank.)  The LoS pass runs on
  every rank on the raw inputs, outside the body, and its gradient is never
  summed.
* **Triangle sharding** (:class:`TriShardedSceneAccess`).  Each ``tris``
  rank holds a contiguous slab of the triangle axis and answers queries on
  it (a slab of 4096 padded triangles or more walks, a smaller one scans);
  the nearest hit is the lexicographic ``(t, idx)`` minimum over the slabs,
  ties to the lower global index as in the single-device scan.  The payload
  table is replicated (every fetch a local row gather) or, with
  ``tri_shard_table=True``, fetched from the owning slab by an owner-masked
  sum over ``tris``.
* **Transport.**  NCCL when each rank has its own card.  Ranks that share a
  card (NCCL refuses two ranks on one device) use gloo, which takes CUDA
  tensors for ``all_gather`` and ``all_reduce`` and copies them through the
  host itself (:func:`collective_route`); the kernels still run on the
  card.  :data:`COLLECTIVES` counts the calls, bytes and host seconds spent
  in the collectives (under NCCL the seconds are the enqueue alone), and
  each is a span ``hrt.collective`` of the recorder.
"""
from __future__ import annotations

import os
import time
from functools import partial
from typing import Optional

import torch
import torch.distributed as dist

from ..config import TracerConfig
from ..ops.fresnel import ETA_FIELDS, EtaPrecomputed
from ..ops.walk import CULL_BLOCK_TRIS, WALK_BLOCK_TRIS
from ..scene.model import TriangleSoA
from ..tracer import (LocalSceneAccess, PathsResult, payload_table,
                      run_bounce_loop, trace_with)
from ..utils.profiling import CounterView, count, span

__all__ = ["default_mesh", "trace_paths_sharded", "TriShardedSceneAccess",
           "initialize_distributed", "collective_route", "COLLECTIVES",
           "reset_collectives"]

_I32_MAX = 2 ** 31 - 1
# the slabs are whole fine tiles of the largest triangle tile of the
# port's queries (the walk's), as the JAX package pads to 128
TRI_TILE = max(WALK_BLOCK_TRIS, CULL_BLOCK_TRIS)
# tri_shard_table="auto" replicates the payload table up to this many
# padded triangles (108 bytes a triangle), as the JAX package
REPLICATE_TABLE_MAX = 1 << 22

COLLECTIVES = CounterView("collective", calls=0, bytes=0, seconds=0.0)
"""The collectives' calls, bytes and seconds, a view of the recorder's
counters ``collective.*``.  ``seconds`` is host time: under gloo the whole
exchange, under NCCL only its enqueue (the device work runs on after)."""


def reset_collectives():
    """Set the counts of :data:`COLLECTIVES` to zero."""
    COLLECTIVES.update(calls=0, bytes=0, seconds=0.0)


def initialize_distributed(**kwargs):
    """Bring up the process group: ``torch.distributed.init_process_group``
    with ``kwargs`` (``init_method``, ``world_size``, ``rank``) or, without
    them, the ``env://`` variables a launcher such as ``torchrun`` sets.
    Without a ``backend``: NCCL when each rank can have a card of its own
    (this rank's card is then set from ``LOCAL_RANK`` or the rank), gloo
    otherwise.  Call once per process before :func:`default_mesh`."""
    if "backend" not in kwargs:
        world = int(kwargs.get("world_size", os.environ.get("WORLD_SIZE", 1)))
        own_card = (torch.cuda.is_available()
                    and torch.cuda.device_count() >= world)
        kwargs["backend"] = "nccl" if own_card else "gloo"
    if kwargs["backend"] == "nccl":
        rank = int(os.environ.get("LOCAL_RANK",
                                  kwargs.get("rank",
                                             os.environ.get("RANK", 0))))
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(**kwargs)


def default_mesh(num_ray_shards: Optional[int] = None,
                 num_tri_shards: int = 1, device_type: str = "cuda"):
    """A ``(rays, tris)`` :class:`~torch.distributed.device_mesh.DeviceMesh`
    over every rank.  With ``num_tri_shards == 1`` the scene is replicated
    and only rays shard.  Raises ``ValueError`` when the mesh needs more
    ranks than there are, or leaves a rank out."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if num_ray_shards is None:
        num_ray_shards = world // num_tri_shards
    n = num_ray_shards * num_tri_shards
    if n > world or n < 1:
        raise ValueError(f"mesh {num_ray_shards}x{num_tri_shards} needs {n} "
                         f"ranks, have {world}")
    if n < world:
        raise ValueError(f"mesh {num_ray_shards}x{num_tri_shards} leaves "
                         f"{world - n} of {world} ranks out; every rank "
                         "runs the same program")
    return init_device_mesh(device_type, (num_ray_shards, num_tri_shards),
                            mesh_dim_names=("rays", "tris"))


# --- collectives -----------------------------------------------------------


def collective_route(group, x: torch.Tensor) -> str:
    """How a collective over ``group`` moves ``x``: "host-staged" where gloo
    takes a CUDA tensor (it copies it through the host itself), else
    "device"."""
    if x.is_cuda and dist.get_backend(group) == "gloo":
        return "host-staged"
    return "device"


def _counted(fn, x, group):
    """``fn(x)`` on ``x`` detached and contiguous, counted in
    :data:`COLLECTIVES` (the bytes each rank's tensor carries, times the
    group's size)."""
    with span("hrt.collective"):
        t0 = time.perf_counter()
        y = x.detach().contiguous()
        out = fn(y)
        count("collective.calls")
        count("collective.bytes", y.numel() * y.element_size() * group.size())
        count("collective.seconds", time.perf_counter() - t0)
    return out


def _all_gather(x, group):
    """Every rank's ``x`` in ``group``'s rank order."""
    def fn(y):
        parts = [torch.empty_like(y) for _ in range(group.size())]
        dist.all_gather(parts, y, group=group)
        return parts
    return _counted(fn, x, group)


def _all_reduce_sum(x, group):
    def fn(y):
        y = y.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y
    return _counted(fn, x, group)


class _GatherRays(torch.autograd.Function):
    """``x [rows, n]`` of every ``rays`` rank, concatenated along the ray
    axis (the last) in rank order.  The loss on the gathered tensor is
    replicated, so the backward is this rank's own slice of the incoming
    gradient, with no sum."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.n = group, x.shape[-1]
        return torch.cat(_all_gather(x, group), dim=-1)

    @staticmethod
    def backward(ctx, g):
        r = ctx.group.rank()
        return g[..., r * ctx.n:(r + 1) * ctx.n].contiguous(), None


class _Replicated(torch.autograd.Function):
    """The identity on a tensor every rank of ``group`` holds alike, whose
    gradient each rank has only in part: the backward sums it over the
    group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_sum(g, ctx.group), None


class _SumShards(torch.autograd.Function):
    """The sum over ``group`` of owner-masked rows that every rank of it
    needs whole.  Every rank computes the same rays downstream, so the
    gradient of the sum is the incoming one, unchanged: with the owner mask
    in front, the masked identity."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _replicate(x, group):
    """``x`` through :class:`_Replicated` where a gradient can reach it."""
    if (group is None or x is None or not torch.is_grad_enabled()
            or not x.requires_grad):
        return x
    return _Replicated.apply(x, group)


# --- triangle sharding ------------------------------------------------------


def _lex_min(t, i_glob, group):
    """The lexicographic ``(t, idx)`` minimum over ``group``: one all-gather
    of each ray's packed pair, folded here in rank order (ties to the lower
    global index, as the single-device scan)."""
    pair = torch.stack([t.contiguous().view(torch.int32),
                        i_glob.to(torch.int32)])
    parts = _all_gather(pair, group)
    t_min, i_min = parts[0][0].view(torch.float32), parts[0][1]
    for p in parts[1:]:
        t_o, i_o = p[0].view(torch.float32), p[1]
        better = (t_o < t_min) | ((t_o == t_min) & (i_o < i_min))
        t_min = torch.where(better, t_o, t_min)
        i_min = torch.where(better, i_o, i_min)
    return t_min, i_min


class TriShardedSceneAccess(LocalSceneAccess):
    """The scene access of one ``tris`` rank: queries on its contiguous slab
    ``tris_local`` (global ids ``local + rank * slab size``), combined over
    ``group`` by the lexicographic ``(t, idx)`` minimum.

    With ``tris_full`` (the whole padded scene) the payload table is the
    whole scene's, replicated: a hit fetch is a local row gather by global
    id, with no collective.  Without, the table holds the slab's rows and a
    fetch sums the owner-masked rows over ``group``; every rank's table then
    holds a different slab, so gradients of the parameters behind it are
    whole only once summed over ``group`` (:func:`trace_paths_sharded` sums
    them)."""

    tri_sharded = True

    def __init__(self, tris_local: TriangleSoA, group, cfg: TracerConfig,
                 eta: EtaPrecomputed,
                 tris_full: Optional[TriangleSoA] = None):
        super().__init__(tris_local, cfg, eta=None)
        self.group = group
        self.shard_size = tris_local.pad_triangles
        self.offset = group.rank() * self.shard_size
        self.full = tris_full is not None
        self._eta_tab, self._material, self._table = payload_table(
            tris_full if self.full else tris_local, eta)

    def intersect(self, o, d, t_max=None, exclude=None, live=None,
                  any_hit=False):
        if exclude is not None:
            # global -> slab-local id: an id outside the slab falls outside
            # [0, slab size) and matches nothing (the queries compare it)
            exclude = (exclude - self.offset).to(torch.int32)
        # counted once a rank by LocalSceneAccess.intersect (``queries``)
        t, i = super().intersect(o, d, t_max=t_max, exclude=exclude,
                                 live=live, any_hit=any_hit)
        i_glob = torch.where(i >= 0, i + self.offset, _I32_MAX)
        t_min, i_min = _lex_min(t, i_glob, self.group)
        idx = torch.where(torch.isfinite(t_min) & (i_min < _I32_MAX), i_min,
                          -1)
        return t_min, idx.to(torch.int32)

    def _owned(self, idx_safe):
        li = idx_safe - self.offset
        mine = (li >= 0) & (li < self.shard_size)
        return (torch.clamp(li, 0, self.shard_size - 1),
                mine.to(torch.float32)[..., None])

    def fetch_row(self, idx_safe):
        if self.full:
            return super().fetch_row(idx_safe)
        li, mine = self._owned(idx_safe)
        return _SumShards.apply(super().fetch_row(li) * mine, self.group)

    def normal_at(self, idx_safe):
        if self.full:
            return super().normal_at(idx_safe)
        li, mine = self._owned(idx_safe)
        return _SumShards.apply(super().normal_at(li) * mine, self.group)


def _round_up(x, m):
    return -(-x // m) * m


_TRI_FIELDS = ("v0", "e1", "e2", "normal", "velocity", "material",
               "mesh_id")


def _map_tris(tris: TriangleSoA, fn, num_triangles=None) -> TriangleSoA:
    return TriangleSoA(
        **{f: fn(f, getattr(tris, f)) for f in _TRI_FIELDS},
        num_triangles=(tris.num_triangles if num_triangles is None
                       else num_triangles))


def _slab(tris: TriangleSoA, k: int, size: int) -> TriangleSoA:
    return _map_tris(tris, lambda f, x: x[k * size:(k + 1) * size],
                     min(max(tris.num_triangles - k * size, 0), size))


def _tri_sharded_access(tris, eta, cfg, group):
    """This rank's :class:`TriShardedSceneAccess`: the scene padded with
    zero triangles to whole slabs of whole tiles, the payload table placed
    by ``cfg.tri_shard_table``."""
    n = group.size()
    t_pad = tris.pad_triangles
    need = _round_up(t_pad, n * TRI_TILE)
    if need > t_pad:
        def pad(f, x):
            fill = -1 if f == "mesh_id" else 0
            return torch.cat([x, x.new_full((need - t_pad,) + x.shape[1:],
                                            fill)])
        tris = _map_tris(tris, pad)
    size = need // n
    tst = cfg.tri_shard_table
    if tst is False or (tst == "auto" and need <= REPLICATE_TABLE_MAX):
        return TriShardedSceneAccess(_slab(tris, group.rank(), size), group,
                                     cfg, eta, tris_full=tris)
    # each rank's table holds its slab's rows: the gradients of the whole
    # scene and of the eta rows behind it are summed over the slabs
    rep = partial(_replicate, group=group)
    tris = _map_tris(tris, lambda f, x: rep(x))
    eta = EtaPrecomputed(**{f: rep(getattr(eta, f)) for f in ETA_FIELDS})
    return TriShardedSceneAccess(_slab(tris, group.rank(), size), group, cfg,
                                 eta)


# --- the sharded trace -------------------------------------------------------


def _rows(x, dim):
    """``x`` with its ray axis ``dim`` last, as ``[rows, n]`` f32, and what
    undoes it."""
    moved = x.movedim(dim, -1)
    return moved.reshape(-1, moved.shape[-1]).to(torch.float32), (
        moved.shape, dim, x.dtype)


def _gather_ys(ys, group, keep_rays):
    """The per-bounce outputs of every ray shard, concatenated along the
    ray axis: one all-gather of all of them packed as ``[rows, n]``.  A
    bounce's outputs (:func:`~..tracer.assemble_scatter`) hold the rays on
    axis 1 (the six per-RX rows ``[nrx, n]`` and ``dir_rx [nrx, n, 3]``),
    then, when rays are kept, on axis 0 (``o``, ``d [n, 3]``, ``live
    [n]``)."""
    k = 10 if keep_rays else 7
    rows, undo = zip(*(_rows(x, 1 if i < 7 else 0)
                       for y in ys for i, x in enumerate(y[:k])))
    whole = _GatherRays.apply(torch.cat(rows), group)
    out, at = [], 0
    for r, (shape, dim, dtype) in zip(rows, undo):
        x = whole[at:at + r.shape[0]]
        at += r.shape[0]
        x = x.reshape(*shape[:-1], x.shape[-1]).movedim(-1, dim)
        out.append(x > 0.5 if dtype == torch.bool else x)
    return [tuple(out[b * k:(b + 1) * k]) for b in range(len(ys))]


def trace_paths_sharded(tris: TriangleSoA, materials, rx_pos, tx_pos, rx_vel,
                        tx_vel, carrier_frequency_ghz, cfg: TracerConfig,
                        mesh=None, launch_dirs=None) -> PathsResult:
    """The trace of :func:`~..tracer.trace_paths` over a ``(rays, tris)``
    mesh (:func:`default_mesh`).  Every rank passes the same full inputs
    and gets the same full result: with one triangle shard, the
    single-process outputs bit for bit (every operation is per ray).
    Differentiable as ``trace_paths``, with the gradients of the replicated
    inputs summed over the ray shards once.  Raises ``ValueError`` when the
    ``ntx * num_paths`` launch rays do not divide over the ray shards."""
    if mesh is None:
        mesh = default_mesh()
    dims = dict(zip(mesh.mesh_dim_names, mesh.shape))
    n_rays, n_tris = dims["rays"], dims.get("tris", 1)
    rays_g = mesh.get_group("rays") if n_rays > 1 else None
    tris_g = mesh.get_group("tris") if n_tris > 1 else None
    R = torch.as_tensor(tx_pos).numel() // 3 * cfg.num_paths
    if R % n_rays:
        raise ValueError(f"ntx*num_paths = {R} must divide over the rays "
                         f"axis ({n_rays}); pad num_paths")

    make_access = None if tris_g is None else (
        lambda t, eta: _tri_sharded_access(t, eta, cfg, tris_g))
    if rays_g is None:
        return trace_with(tris, materials, rx_pos, tx_pos, rx_vel, tx_vel,
                          carrier_frequency_ghz, cfg, launch_dirs,
                          make_access=make_access)
    n = R // n_rays
    mine = slice(rays_g.rank() * n, (rays_g.rank() + 1) * n)

    def shard_body(access, rx_pos, fslm, k_dop, state0, relaunch, cfg):
        # this rank's rays, launched from the replicated TX inputs; the
        # launch state of the whole trace (``state0``) feeds the assembly
        rep = partial(_replicate, group=rays_g)
        state, k_dop_r = relaunch(rep)
        state = tuple(None if x is None else x[mine] for x in state)
        ys = run_bounce_loop(access.replicated(rep), rep(rx_pos), state,
                             rep(fslm), k_dop_r, cfg)
        return _gather_ys(ys, rays_g, cfg.keep_rays)

    return trace_with(tris, materials, rx_pos, tx_pos, rx_vel, tx_vel,
                      carrier_frequency_ghz, cfg, launch_dirs,
                      make_access=make_access, body=shard_body)
