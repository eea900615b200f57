"""The visit-list walk for large scenes: shared helpers and plain versions.

The counterpart of the JAX package's walk
(``hermespy_rt_tpu/ops/intersect_pallas.py``: ``_tile_aabbs``,
``_walk_prepass`` with ``_prepass_kernel``, ``_kernel_walk_res`` /
``_kernel_walk`` with ``_tile_body_walk``).  The triangles are cut into fine
tiles of ``block_tris``, each with its exact AABB; ``group`` consecutive fine
tiles make one coarse box.  Rays are cut into tiles of ``block_rays``.

1. The *prepass* slab-tests every ray against every coarse box: a ray tile
   reaches a box if any of its rays does, keyed by the nearest entry
   distance of those rays.  :func:`visit_rows` sorts each tile's reached
   boxes near to far (stable) into its visit row, ``int32[nRT, 1 + C]``:
   column 0 the count, then the box ids, padded with the last one.
2. The *walk* evaluates, per ray tile, the member fine tiles of its listed
   boxes in that order.  Each ray slab-tests a fine tile's AABB within
   ``min(best t, lim)``; when any ray of the tile reaches it, the whole tile
   is evaluated for every ray of the tile (as the TPU kernel's
   ``pl.when(any(reach))``), by the Möller–Trumbore step of
   :func:`~.intersect.mt_hit` with ``t <= lim`` inside the test.  The update
   is the ``(t, idx)`` lexicographic minimum, so ties go to the lower index
   whatever the visit order.  In any-hit mode a ray with a hit stops
   searching (its limit becomes -1).

``lim`` per ray is ``T_MAX``, or ``t_max`` where given, and -1 for dead rays
and the padding rays of the last tile, which are then never reached.  The
boxes are exact: a Möller–Trumbore hit accepted a hair outside its triangle
(``u, v >= -eps``) can lie outside its tile's box, so on such an edge the
walk may miss what the brute scan finds, as the JAX walk may.  A fine tile
holding only padding triangles gets the inverted box (+inf, -inf), which the
slab test's infinities make reach every live ray at key 0; evaluating it
finds nothing (padding triangles have a zero determinant).

:func:`visit_rows` of :func:`prepass_plain`, and :func:`walk_plain`, are the
plain versions of the CUDA kernels of ``csrc/walk.cu`` (the prepass kernel
writes the visit rows itself); they run for CPU tensors and in the checks
(``ops/walk_cuda.py`` launches the kernels).  No running-best pruning beyond
the kernel's own reach test is added: pruning never changes ``(t, idx)``.

The culled brute scan (``csrc/intersect.cu::nearest_hit_culled_kernel``)
is the walk with every fine tile of :data:`CULL_BLOCK_TRIS` triangles listed
for every ray tile in ascending order: :func:`culled_reach_plain` runs it so
and returns which tiles each ray tile reached, the kernel's skip decisions.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .intersect import T_MAX, mt_hit

__all__ = ["WALK_BLOCK_RAYS", "WALK_BLOCK_TRIS", "MAX_BOXES",
           "CULL_BLOCK_RAYS", "CULL_BLOCK_TRIS", "SceneWalk", "prepare_walk",
           "walk_group", "tile_aabbs", "coarse_boxes", "cull_boxes",
           "triangle_records",
           "query_limits", "prepass_plain", "prepass_kept_plain",
           "visit_rows", "walk_plain",
           "culled_reach_plain"]

# Hopper tile sizes: 256 rays a block (one thread per ray, the prepass's
# 256 boxes a block over the same 256 staged rays) and fine tiles of 128
# triangles (4.6 KB of (v0, e1, e2) in shared memory), config-5's
# block_tris.  The plain versions take any sizes, so the tests can match the
# JAX package's.
WALK_BLOCK_RAYS = 256
WALK_BLOCK_TRIS = 128
MAX_BOXES = 512        # coarse boxes per prepass row: group grows until this
# the culled brute kernel: blocks of 256 rays, tiles of 64 triangles (the
# 256-triangle canyon stand-in has 4 tiles)
CULL_BLOCK_RAYS = 256
CULL_BLOCK_TRIS = 64
_NO_HIT = 2 ** 31 - 1  # running index before the first hit
_INV_ZERO = 1e-30      # stands in for d == 0 in 1 / d, as the TPU kernels


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def walk_group(n_tiles: int, max_boxes: int = MAX_BOXES) -> int:
    """The smallest power of two ``g`` with ``n_tiles <= max_boxes * g``."""
    g = 1
    while n_tiles > g * max_boxes:
        g *= 2
    return g


@dataclasses.dataclass(frozen=True)
class SceneWalk:
    """A scene cut for the walk, on one device: the triangles padded with
    zeros to whole groups of fine tiles, as ``v0``, ``e1``, ``e2``
    ``f32[T, 3]`` (the plain version's) and as the kernel's 48-byte records
    ``f32[T, 12]`` (:func:`triangle_records`), the fine tiles' AABBs
    ``f32[nT, 6]`` (lo xyz, hi xyz) and the coarse boxes ``f32[C, 6]``."""

    v0: torch.Tensor
    e1: torch.Tensor
    e2: torch.Tensor
    records: torch.Tensor
    aabbs: torch.Tensor
    boxes: torch.Tensor
    block_rays: int
    block_tris: int
    group: int

    @property
    def n_tiles(self) -> int:
        return self.aabbs.shape[0]

    @property
    def n_boxes(self) -> int:
        return self.boxes.shape[0]


def tile_aabbs(tris, block_tris: int, t_pad: int) -> torch.Tensor:
    """Exact AABB per fine tile of ``block_tris`` triangles, ``f32[nT, 6]``,
    over the real triangles only (padding rows, and rows up to ``t_pad``,
    count as empty): the JAX package's ``_tile_aabbs``."""
    v0, e1, e2 = (getattr(tris, f).detach() for f in ("v0", "e1", "e2"))
    T = v0.shape[0]
    real = (torch.arange(T, device=v0.device) < tris.num_triangles)
    pts = torch.stack([v0, v0 + e1, v0 + e2], dim=1)            # [T, 3, 3]
    lo = torch.where(real[:, None, None], pts, torch.inf).amin(dim=1)
    hi = torch.where(real[:, None, None], pts, -torch.inf).amax(dim=1)
    if t_pad > T:
        lo = torch.cat([lo, lo.new_full((t_pad - T, 3), torch.inf)])
        hi = torch.cat([hi, hi.new_full((t_pad - T, 3), -torch.inf)])
    n = t_pad // block_tris
    return torch.cat([lo.reshape(n, block_tris, 3).amin(dim=1),
                      hi.reshape(n, block_tris, 3).amax(dim=1)], dim=-1)


def coarse_boxes(aabbs: torch.Tensor, group: int) -> torch.Tensor:
    """Union boxes of ``group`` consecutive fine tiles,
    ``f32[nT / group, 6]``."""
    if group == 1:
        return aabbs
    a = aabbs.reshape(-1, group, 6)
    return torch.cat([a[..., 0:3].amin(dim=1), a[..., 3:6].amax(dim=1)],
                     dim=-1)


def cull_boxes(tris) -> torch.Tensor:
    """The culled kernel's tile boxes, ``f32[ceil(T / CULL_BLOCK_TRIS), 6]``
    (:func:`tile_aabbs`)."""
    t_pad = _round_up(tris.pad_triangles, CULL_BLOCK_TRIS)
    return tile_aabbs(tris, CULL_BLOCK_TRIS, t_pad).contiguous()


def triangle_records(v0: torch.Tensor, e1: torch.Tensor,
                     e2: torch.Tensor) -> torch.Tensor:
    """One 48-byte record per triangle, ``f32[T, 12]``: ``(v0, 0, e1, 0,
    e2, 0)``, so that the walk kernel stages a fine tile as one contiguous
    run and reads a triangle as three 16-byte loads."""
    pad = v0.new_zeros((v0.shape[0], 1))
    return torch.cat([v0, pad, e1, pad, e2, pad], dim=1).contiguous()


def prepare_walk(tris, block_rays: int = WALK_BLOCK_RAYS,
                 block_tris: int = WALK_BLOCK_TRIS,
                 group: Optional[int] = None) -> SceneWalk:
    """Cut ``tris`` for the walk, once per scene, as the JAX package sizes
    it: ``block_tris`` at most the triangle count rounded up to 128, ``group``
    (unless given) the smallest power of two that keeps the coarse boxes at
    most :data:`MAX_BOXES`, the triangles padded to ``block_tris * group``."""
    T = tris.pad_triangles
    block_tris = min(block_tris, _round_up(T, 128))
    if group is None:
        group = walk_group(_round_up(T, block_tris) // block_tris)
    t_pad = _round_up(T, block_tris * group)

    def pad(x):
        x = x.detach()
        return (x if t_pad == T else
                torch.cat([x, x.new_zeros((t_pad - T, 3))])).contiguous()

    aabbs = tile_aabbs(tris, block_tris, t_pad).contiguous()
    v0, e1, e2 = pad(tris.v0), pad(tris.e1), pad(tris.e2)
    return SceneWalk(v0=v0, e1=e1, e2=e2,
                     records=triangle_records(v0, e1, e2), aabbs=aabbs,
                     boxes=coarse_boxes(aabbs, group).contiguous(),
                     block_rays=block_rays, block_tris=block_tris,
                     group=group)


def query_limits(R: int, block_rays: int, t_max=None,
                 live: Optional[torch.Tensor] = None,
                 device=None) -> torch.Tensor:
    """Per-ray limit ``f32[nRT * block_rays]``: ``T_MAX``, ``t_max`` (scalar
    or ``f32[R]``) where given, -1 for dead rays and the padding rays."""
    n_pad = max(_round_up(R, block_rays), block_rays)
    lim = torch.full((n_pad,), T_MAX, dtype=torch.float32, device=device)
    lim[R:] = -1.0
    if t_max is not None:
        lim[:R] = (t_max.detach() if isinstance(t_max, torch.Tensor)
                   else float(t_max))
    if live is not None:
        lim[:R] = torch.where(live, lim[:R], -1.0)
    return lim


def _pad_rays(x: torch.Tensor, n_pad: int, fill=0.0) -> torch.Tensor:
    R = x.shape[0]
    if n_pad == R:
        return x
    return torch.cat([x, x.new_full((n_pad - R,) + x.shape[1:], fill)])


def _inverse(d: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.where(d == 0, _INV_ZERO, d)


def _slab(o, inv, lo, hi):
    """``(t_near, t_far)`` of rays against boxes, broadcasting over leading
    axes; ``o``, ``inv`` ``[..., 3]``, ``lo``, ``hi`` ``[..., 3]``.  The TPU
    kernels' arithmetic: ``(plane - o) * inv``, min/max per axis, NaN
    propagating."""
    t_near = t_far = None
    for a in range(3):
        p = (lo[..., a] - o[..., a]) * inv[..., a]
        q = (hi[..., a] - o[..., a]) * inv[..., a]
        na, fa = torch.minimum(p, q), torch.maximum(p, q)
        t_near = na if a == 0 else torch.maximum(t_near, na)
        t_far = fa if a == 0 else torch.minimum(t_far, fa)
    return t_near, t_far


def _reach(t_near, t_far, limit):
    return ((t_far >= 0.0) & (t_near <= t_far) & (t_near <= limit)
            & (limit >= 0.0))


def prepass_plain(o: torch.Tensor, d: torch.Tensor, lim: torch.Tensor,
                  boxes: torch.Tensor, block_rays: int,
                  max_elements: int = 1 << 24
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The slab-test prepass: ``reach bool[nRT, C]`` (any ray of the tile
    reaches the box) and ``key f32[nRT, C]`` (the least ``max(t_near, 0)``
    over the rays that reach it, +inf if none).  ``o``, ``d`` ``f32[R, 3]``,
    ``lim`` ``f32[nRT * block_rays]`` (:func:`query_limits`).  Chunked over
    ray tiles so that no temporary exceeds ``max_elements``."""
    n_pad = lim.shape[0]
    n_rt, C = n_pad // block_rays, boxes.shape[0]
    o = _pad_rays(o.detach().float(), n_pad).reshape(n_rt, block_rays, 1, 3)
    inv = _inverse(_pad_rays(d.detach().float(), n_pad)).reshape(
        n_rt, block_rays, 1, 3)
    lim = lim.reshape(n_rt, block_rays, 1)
    lo, hi = boxes[:, 0:3], boxes[:, 3:6]
    step = max(1, max_elements // (block_rays * max(C, 1)))
    reach, key = [], []
    for a in range(0, n_rt, step):
        b = min(a + step, n_rt)
        t_near, t_far = _slab(o[a:b], inv[a:b], lo, hi)   # [n, br, C]
        r = _reach(t_near, t_far, lim[a:b])
        # max(t_near, 0) as +0.0 where t_near <= 0 (never -0.0), as the
        # kernel packs it
        k = torch.where(r, torch.where(t_near > 0, t_near, 0.0), torch.inf)
        reach.append(r.any(dim=1))
        key.append(k.amin(dim=1))
    return torch.cat(reach), torch.cat(key)


def prepass_kept_plain(o: torch.Tensor, d: torch.Tensor, lim: torch.Tensor,
                       boxes: torch.Tensor, block_rays: int) -> torch.Tensor:
    """The prepass kernel's prune (``csrc/walk.cu::box_pruned``) as torch
    ops: ``bool[nRT, C]``, the boxes each ray tile keeps for exact tests.
    From the least and greatest ``o`` and ``inv`` of the tile's live rays,
    the rounded corner products bound every ray's ``(plane - o) inv``, so a
    tile's ``t_near`` from below (``NL``) and ``t_far`` from above
    (``FU``); a box is pruned where ``FU < 0``, ``NL > FU`` or ``NL`` is
    above the tile's greatest limit (NaN bounds keep it), and a tile without
    live rays keeps none.  Every box a ray of the tile reaches is kept."""
    n_pad = lim.shape[0]
    n_rt = n_pad // block_rays
    o = _pad_rays(o.detach().float(), n_pad).reshape(n_rt, block_rays, 3)
    inv = _inverse(_pad_rays(d.detach().float(), n_pad)).reshape(
        n_rt, block_rays, 3)
    lim = lim.reshape(n_rt, block_rays)
    live = (lim >= 0)[..., None]
    o_lo = torch.where(live, o, torch.inf).amin(dim=1)[:, None, :]
    o_hi = torch.where(live, o, -torch.inf).amax(dim=1)[:, None, :]
    i_lo = torch.where(live, inv, torch.inf).amin(dim=1)[:, None, :]
    i_hi = torch.where(live, inv, -torch.inf).amax(dim=1)[:, None, :]
    lim_max = torch.where(live[..., 0], lim, -1.0).amax(dim=1)[:, None]
    nl = fu = None
    for a in range(3):
        lb, ub = [], []
        for plane in (boxes[None, :, a], boxes[None, :, 3 + a]):
            d_lo, d_hi = plane - o_hi[..., a], plane - o_lo[..., a]
            c = (d_lo * i_lo[..., a], d_lo * i_hi[..., a],
                 d_hi * i_lo[..., a], d_hi * i_hi[..., a])
            lb.append(torch.minimum(torch.minimum(c[0], c[1]),
                                    torch.minimum(c[2], c[3])))
            ub.append(torch.maximum(torch.maximum(c[0], c[1]),
                                    torch.maximum(c[2], c[3])))
        n_a, f_a = torch.minimum(*lb), torch.maximum(*ub)
        nl = n_a if a == 0 else torch.maximum(nl, n_a)
        fu = f_a if a == 0 else torch.minimum(fu, f_a)
    pruned = (fu < 0) | (nl > fu) | (nl > lim_max)
    return ~pruned & live.any(dim=1)


def visit_rows(reach: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Packed visit rows ``int32[nRT, 1 + C]`` from the prepass: column 0
    the count, then the reached boxes near to far by key (a stable sort, so
    equal keys keep box order), padded with the last reached box (box 0 when
    none), as the JAX package's ``_walk_prepass`` packs them."""
    n_rt, C = reach.shape
    count = reach.sum(dim=1, dtype=torch.int32)
    order = torch.sort(torch.where(reach, key, torch.inf), dim=1,
                       stable=True).indices
    kk = torch.minimum(torch.arange(C, device=reach.device)[None, :],
                       torch.clamp_min(count.long() - 1, 0)[:, None])
    visit = torch.gather(order, 1, kk).to(torch.int32)
    return torch.cat([count[:, None], visit], dim=1).contiguous()


def walk_plain(o: torch.Tensor, d: torch.Tensor, scene: SceneWalk,
               visits: torch.Tensor, lim: torch.Tensor,
               exclude: Optional[torch.Tensor] = None,
               any_hit: bool = False, tile_chunk: int = 256,
               reach_out: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The walk: ``(t f32[R] (+inf miss), idx i32[R] (-1 miss))`` of rays
    ``o``, ``d`` ``f32[R, 3]`` over the fine tiles their tile's visit row
    names, in its order (see the module docstring).  ``lim`` is the padded
    limit of :func:`query_limits`; ``exclude`` (``i32[R]``, -1 none) one
    triangle per ray.  Evaluated tile by tile of the walk as torch ops, at
    most ``tile_chunk`` ray tiles at once.  ``reach_out`` (``bool[nRT,
    nT]``), when given, gets whether each ray tile reached each fine tile
    it listed."""
    R = o.shape[0]
    br, bt, group = scene.block_rays, scene.block_tris, scene.group
    n_pad = lim.shape[0]
    n_rt = n_pad // br
    dev = o.device
    o = _pad_rays(o.detach().float(), n_pad).reshape(n_rt, br, 3)
    d = _pad_rays(d.detach().float(), n_pad).reshape(n_rt, br, 3)
    inv = _inverse(d)
    ex = (torch.full((n_pad,), -1, dtype=torch.int64, device=dev)
          if exclude is None else _pad_rays(exclude.long(), n_pad, -1))
    ex = ex.reshape(n_rt, br)
    lim = lim.reshape(n_rt, br)
    best_t = torch.full((n_rt, br), torch.inf, device=dev)
    best_i = torch.full((n_rt, br), _NO_HIT, dtype=torch.int64, device=dev)
    counts = visits[:, 0].long()
    n_steps = int(counts.max()) * group if n_rt else 0
    rows = torch.arange(bt, device=dev)
    for s in range(n_steps):
        e, m = divmod(s, group)
        act = torch.nonzero(counts > e).flatten()
        j = visits[act, 1 + e].long() * group + m                # fine tiles
        limit = torch.minimum(best_t[act], lim[act])
        if any_hit:
            limit = torch.where(best_t[act] < torch.inf, -1.0, limit)
        box = scene.aabbs[j][:, None, :]                          # [A, 1, 6]
        reach = _reach(*_slab(o[act], inv[act], box[..., 0:3],
                              box[..., 3:6]), limit)
        hot = reach.any(dim=1)
        if reach_out is not None:
            reach_out[act, j] = hot
        act, j = act[hot], j[hot]
        for a in range(0, act.shape[0], tile_chunk):
            tiles, jt = act[a:a + tile_chunk], j[a:a + tile_chunk]
            k = jt[:, None] * bt + rows[None, :]                 # [n, bt]
            tri = [tuple(x[k][:, None, :, c] for c in range(3))
                   for x in (scene.v0, scene.e1, scene.e2)]
            t, valid = mt_hit(tuple(o[tiles][..., c:c + 1] for c in range(3)),
                              tuple(d[tiles][..., c:c + 1] for c in range(3)),
                              *tri)                              # [n, br, bt]
            valid &= ((k[:, None, :] != ex[tiles][..., None])
                      & (t <= lim[tiles][..., None]))
            t_m = torch.where(valid, t, torch.inf)
            tile_min, arg = torch.min(t_m, dim=2)   # first index of the min
            hit = tile_min < torch.inf
            tile_idx = torch.where(hit, arg + jt[:, None] * bt, _NO_HIT)
            bt_, bi_ = best_t[tiles], best_i[tiles]
            better = (tile_min < bt_) | (hit & (tile_min == bt_)
                                         & (tile_idx < bi_))
            best_t[tiles] = torch.where(better, tile_min, bt_)
            best_i[tiles] = torch.where(better, tile_idx, bi_)
    t = best_t.reshape(-1)[:R]
    idx = torch.where(torch.isfinite(t), best_i.reshape(-1)[:R],
                      -1).to(torch.int32)
    return t, idx


def culled_reach_plain(o: torch.Tensor, d: torch.Tensor, tris, lim,
                       exclude: Optional[torch.Tensor] = None,
                       block_rays: int = CULL_BLOCK_RAYS,
                       block_tris: int = CULL_BLOCK_TRIS
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The culled brute scan's decisions as torch ops: ``(reach bool[nRT,
    nT], t, idx)``.  ``reach`` says which tiles of ``block_tris`` triangles
    each tile of ``block_rays`` rays reached, tiles in ascending order, each
    ray's slab test against the tile's box (:func:`tile_aabbs`) within
    ``min(running best t, lim)``, as ``_kernel_culled``'s
    (``intersect_pallas.py:444-461``); ``(t, idx)`` is the query's answer.
    ``lim`` is the padded limit of :func:`query_limits` at ``block_rays``.
    The running best needs the triangles: the walk over every tile
    (:func:`walk_plain`) computes it."""
    scene = prepare_walk(tris, block_rays, block_tris, group=1)
    n_rt, n_t = lim.shape[0] // block_rays, scene.n_tiles
    tiles = torch.arange(n_t, dtype=torch.int32, device=o.device)
    visits = torch.cat([torch.full((n_rt, 1), n_t, dtype=torch.int32,
                                   device=o.device),
                        tiles.expand(n_rt, n_t)], dim=1)
    reach = torch.zeros((n_rt, n_t), dtype=torch.bool, device=o.device)
    t, idx = walk_plain(o, d, scene, visits, lim, exclude=exclude,
                        reach_out=reach)
    return reach, t, idx
