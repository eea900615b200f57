"""Tracer configuration for the PyTorch port.

Keeps only the knobs of :class:`hermespy_rt_tpu.config.TracerConfig` that
this package honours, under the same names and with the same validation.
Every other knob of the JAX package is absent, so passing one raises a
``TypeError`` instead of being silently ignored.
"""
from __future__ import annotations

import dataclasses

__all__ = ["TracerConfig"]


@dataclasses.dataclass(frozen=True)
class TracerConfig:
    """Static tracer parameters.

    Attributes:
      num_paths:   rays launched per transmitter (Fibonacci sphere).
      num_bounces: specular bounce depth.
      parity:      "reference" keeps the C reference's observable quirks (the
                   1-metre scatter-occlusion window, the shadow-ray
                   theta-clobber, LoS Doppler from velocity row 0);
                   "physical" uses distance-correct occlusion.
      occlusion_offset: self-hit epsilon for "physical" occlusion.
      keep_rays:   also return per-bounce ray segments (RaysInfo).
      compact_rays: pass the per-ray activity mask into every bounce and
                   shadow query, so dead rays cost nothing there.  True by
                   default, unlike the JAX package: the outputs and
                   gradients are the same bits either way (a dead ray's
                   answer is masked away), the card's kernels pack live
                   rays, and a dead ray walked is pure waste.  False
                   queries every ray, as the JAX package's default does.
      launch_order: "fibonacci" (reference path order), "coherent"
                   (the same directions in direction-Morton order) or "auto"
                   ("fibonacci" under reference parity, else "coherent").
      ray_chunk:   rays per chunk of the plain torch nearest-hit query (on
                   every backend, whenever the rays are on the CPU); bounds
                   its ``[chunk, T]`` temporaries.
      rx_query_rays: most rays in one shadow query; larger all-RX batches
                   are split into equal RX groups run one after another.
      grad_geometry: keep fetched triangle geometry differentiable; False
                   detaches it (material gradients are unchanged).
      shade:       bounce shading: "auto" (the default) picks one of the
                   next three from what the trace can observe
                   (``tracer.plan_bounce_loop``): the fused forward kernels
                   where no gradient can be asked for (grad mode off, or no
                   tensor the bounce loop reads requires grad), the
                   refraction is straight (the forward kernels take both
                   transmission modes), the scene access is the whole
                   scene's and the rays are on a card whose fused kernels
                   take their shapes; the op path ("xla") everywhere else,
                   with no warning.  "xla" (the JAX package's name and
                   default) runs the shading as torch ops, whose autograd
                   gives every gradient; "pallas" (the JAX package's name
                   for its reflection-half kernel) runs each bounce's
                   reflection half as one kernel (``ops/shade_cuda.py``)
                   whose backward is autograd of the torch ops at the saved
                   inputs, the rest of the bounce as "xla"; "fused" runs
                   each bounce as two fused kernels around the shadow query
                   (``ops/bounce_fused_cuda.py``), each an autograd node
                   whose backward is a kernel too (with ``grad_positions``
                   the full backward, which gives every gradient the op
                   path gives; past 340 RX, which it does not take, the
                   trace warns and runs the op path), or, with
                   ``grad_positions=False`` and ``unroll_bounces``, the
                   whole loop as one node whose material backward is one
                   kernel.  Under ``transmission`` or ``spawn_transmission``
                   "fused" warns and runs the op path (its backwards
                   reflect only), and "pallas" under
                   ``spawn_transmission`` runs the shading as torch ops (the
                   kernel reflects only), as in the JAX package.
      grad_positions: False declares positions, launch geometry and the
                   carrier scalars constants of the backward: only the
                   material table (and the launch state) get gradients.
                   Requires ``grad_geometry=False``.  The "xla" path
                   ignores it, as in the JAX package.
      unroll_bounces: under ``shade="fused", grad_positions=False``, True
                   runs the whole bounce loop as one autograd node with one
                   backward kernel (``FusedLoopSlim``), False as two nodes
                   per bounce with the slim per-stage backward kernels; a
                   material table of more than 4842 rows, more than that
                   kernel holds, takes the per-stage nodes either way.
                   That is its only meaning here: the port has no scan to
                   unroll, and the op path, the full-gradient fused path
                   and the fused forward of "auto" (no backward) ignore it.
      backend:     nearest-hit implementation: "torch" (plain tensor ops),
                   "cuda" (the hand-written kernel) or "auto".  "cuda" and
                   "auto" both call the kernel's wrapper, which runs the
                   plain version for CPU tensors and launches the kernel, or
                   raises, for CUDA tensors.
      walk:        nearest-hit strategy of the "cuda"/"auto" backends: the
                   visit-list walk (a slab-test prepass lists, per tile of
                   rays, the triangle tiles it can reach, near to far; the
                   walk evaluates only those, ``ops/walk_cuda.py``) or the
                   brute scan.  "auto" (the default) walks from 4096 padded
                   triangles up, True always, False never.  The "torch"
                   backend always scans every triangle.
      cull:        brute-scan queries skip, per block of rays, the triangle
                   tiles whose box no ray of the block reaches within its
                   running nearest hit or its limit (``t_max``; dead rays
                   reach none): the culled kernel of
                   ``ops/intersect_cuda.py``.  Exact: the same decisions as
                   the brute scan.  Ignored when the queries walk and on the
                   "torch" backend.
      shadow_any_hit: physical-parity shadow queries consume only whether a
                   blocker lies within range, so the walk may stop each
                   shadow ray at its first such hit.  Trace outputs are
                   unchanged; reference parity never uses it (it reads the
                   nearest occluder's normal), nor does ``transmission``
                   (it reads the nearest blocker's material row).
      transmission: occlusion with penetration loss (physical parity only):
                   a blocked LoS path or scatter shadow ray is attenuated
                   by its nearest blocker's ITU transmission coefficients
                   (eqs. 31c/31d) instead of zeroed.
      spawn_transmission: transmission-path spawning (physical parity
                   only): ray ``i`` follows the reflect/transmit pattern
                   ``i mod 2**num_bounces`` (bit ``b`` set: pass through the
                   surface hit at bounce ``b`` with the transmission
                   coefficients instead of reflecting).
      refraction:  continuation of a transmitted ray: "straight" (the ITU
                   slab model) or "snell" (bent by Snell's law into a
                   medium of index Re(sqrt(eta)); needs
                   ``spawn_transmission``).
      tri_shard_table: where the ``[T, 27]`` payload table lives when
                   ``parallel.trace_paths_sharded`` shards the triangles:
                   False replicates it, so every hit fetch is a local row
                   gather with no collective; True fetches from each
                   rank's slab, owner-masked and summed over the triangle
                   shards; "auto" replicates up to 2^22 padded triangles.

    The op path (``shade`` "xla" or "pallas") fetches each hit's payload
    row with the row-gather kernel on a card (``ops/fetch_cuda.py``, whose
    backward is the scatter-add kernel) and with its plain version,
    ``table[idx]``, on the CPU; the JAX package's ``gather`` and
    ``fetch_bwd`` choices between TPU forms have no counterpart.
    """

    num_paths: int = 10_000
    num_bounces: int = 3
    parity: str = "reference"
    backend: str = "auto"
    ray_chunk: int = 4096
    keep_rays: bool = True
    occlusion_offset: float = 1e-4
    rx_query_rays: int = 1 << 22
    launch_order: str = "auto"
    compact_rays: bool = True
    grad_geometry: bool = True
    shade: str = "auto"
    grad_positions: bool = True
    walk: "bool | str" = "auto"
    shadow_any_hit: bool = True
    unroll_bounces: bool = True
    cull: bool = False
    transmission: bool = False
    spawn_transmission: bool = False
    refraction: str = "straight"
    tri_shard_table: "bool | str" = "auto"

    @property
    def resolved_launch_order(self) -> str:
        if self.launch_order != "auto":
            return self.launch_order
        return "fibonacci" if self.parity == "reference" else "coherent"

    def __post_init__(self):
        if self.parity not in ("reference", "physical"):
            raise ValueError(f"parity must be 'reference' or 'physical', got {self.parity!r}")
        if self.backend not in ("torch", "cuda", "auto"):
            raise ValueError(f"backend must be 'torch', 'cuda' or 'auto', got {self.backend!r}")
        if self.num_paths <= 0 or self.num_bounces <= 0:
            raise ValueError("num_paths and num_bounces must be > 0")
        if self.launch_order not in ("auto", "fibonacci", "coherent"):
            raise ValueError("launch_order must be 'auto', 'fibonacci' or "
                             f"'coherent', got {self.launch_order!r}")
        if self.launch_order == "coherent" and self.parity == "reference":
            import warnings
            warnings.warn(
                "launch_order='coherent' relabels path <-> direction "
                "assignments: outputs stay self-consistent but path-indexed "
                "comparisons against the C reference will mismatch; parity "
                "suites should use launch_order='fibonacci'.", stacklevel=2)
        if self.rx_query_rays <= 0:
            raise ValueError("rx_query_rays must be > 0, got "
                             f"{self.rx_query_rays}")
        if self.ray_chunk <= 0:
            raise ValueError(f"ray_chunk must be > 0, got {self.ray_chunk}")
        if self.shade not in ("auto", "xla", "pallas", "fused"):
            raise ValueError("shade must be 'auto', 'xla', 'pallas' or "
                             f"'fused', got {self.shade!r}")
        if self.walk in ("resident", "dma"):
            raise ValueError(
                f"walk={self.walk!r} places the triangles in TPU memory "
                "(VMEM-resident or streamed by DMA); on the GPU they come "
                "from device memory through L2 either way: use True")
        if self.walk not in (True, False, "auto"):
            raise ValueError("walk must be True, False or 'auto', got "
                             f"{self.walk!r}")
        if not self.grad_positions and self.grad_geometry:
            raise ValueError("grad_positions=False requires grad_geometry="
                             "False (the cross-bounce vertex chain rides the "
                             "ray operand it stops)")
        if not isinstance(self.unroll_bounces, bool):
            raise ValueError("unroll_bounces must be a bool, got "
                             f"{self.unroll_bounces!r}")
        if not isinstance(self.cull, bool):
            raise ValueError(f"cull must be a bool, got {self.cull!r}")
        if self.transmission and self.parity != "physical":
            raise ValueError("transmission=True requires parity='physical' "
                             "(the reference semantics zero blocked paths)")
        if self.spawn_transmission and self.parity != "physical":
            raise ValueError("spawn_transmission=True requires "
                             "parity='physical' (the reference has no "
                             "refraction branch to be parity-faithful to)")
        if self.refraction not in ("straight", "snell"):
            raise ValueError("refraction must be 'straight' or 'snell', "
                             f"got {self.refraction!r}")
        if self.refraction == "snell" and not self.spawn_transmission:
            raise ValueError("refraction='snell' only affects transmitted "
                             "continuations; enable spawn_transmission=True")
        if self.tri_shard_table not in (False, True, "auto"):
            raise ValueError("tri_shard_table must be False, True or "
                             f"'auto', got {self.tri_shard_table!r}")
