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
      compact_rays: pass the per-ray activity mask into the nearest-hit
                   query, so dead rays cost nothing there.
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
      shade:       bounce shading: "xla" (the default; the name is the JAX
                   package's) runs it as torch ops, whose autograd gives
                   every gradient; "fused" runs each bounce as two fused
                   kernels around the shadow query
                   (``ops/bounce_fused_cuda.py``), each an autograd node
                   whose backward is a kernel too (with ``grad_positions``
                   the full backward, which gives every gradient the op
                   path gives), or, with ``grad_positions=False`` and
                   ``unroll_bounces``, the whole loop as one node whose
                   material backward is one kernel.
      grad_positions: False declares positions, launch geometry and the
                   carrier scalars constants of the backward: only the
                   material table (and the launch state) get gradients.
                   Requires ``grad_geometry=False``.  The "xla" path
                   ignores it, as in the JAX package.
      unroll_bounces: under ``shade="fused", grad_positions=False``, True
                   runs the whole bounce loop as one autograd node with one
                   backward kernel (``FusedLoopSlim``), False as two nodes
                   per bounce with the slim per-stage backward kernels.
                   That is its only meaning here: the port has no scan to
                   unroll, and the op path and the full-gradient fused
                   path ignore it.
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
      shadow_any_hit: physical-parity shadow queries consume only whether a
                   blocker lies within range, so the walk may stop each
                   shadow ray at its first such hit.  Trace outputs are
                   unchanged; reference parity never uses it (it reads the
                   nearest occluder's normal).
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
    compact_rays: bool = False
    grad_geometry: bool = True
    shade: str = "xla"
    grad_positions: bool = True
    walk: "bool | str" = "auto"
    shadow_any_hit: bool = True
    unroll_bounces: bool = True

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
        if self.shade == "pallas":
            raise ValueError("shade='pallas' (the TPU reflection-half shading "
                             "kernel) is not ported yet; use 'xla' or 'fused'")
        if self.shade not in ("xla", "fused"):
            raise ValueError(f"shade must be 'xla' or 'fused', got {self.shade!r}")
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
