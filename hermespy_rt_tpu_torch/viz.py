"""Ray and scene visualisation with matplotlib.

The counterpart of :mod:`hermespy_rt_tpu.viz`, which renders the reference's
OpenGL/GLUT viewer (its ``viz/vizrays.c``) headless-first: the scene's
triangles coloured by mesh, the ray segments of each bounce slot coloured by
depth and masked by activity.  :class:`RayViewer` / :func:`vizrays` keep the
reference's controls: mouse drag orbits and scroll dollies (matplotlib's
own), ``x`` / ``z`` step the bounce slot, ``w`` / ``a`` / ``s`` / ``d`` pan
and ``q`` / ``e`` roll.  A :class:`~.tracer.RaysInfo` of tensors on any
device is read to numpy once.  matplotlib is imported only when a function
here draws, so importing this module needs none.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .scene.model import HostScene
from .tracer import RaysInfo
from .utils.profiling import device_to_numpy

__all__ = ["plot_scene", "plot_rays", "save_rays_figure", "RayViewer",
           "vizrays"]

_BOUNCE_COLORS = ["#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd",
                  "#8c564b", "#e377c2"]


def _require_mpl():
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt  # noqa: F401
    return matplotlib


def _host_rays(rays: RaysInfo, tx: int):
    """``(origins [B+1, P, 3], directions, active [B+1, P])`` of TX ``tx``
    as numpy arrays."""
    return (device_to_numpy(rays.origins[tx]),
            device_to_numpy(rays.directions[tx]),
            device_to_numpy(rays.active[tx]))


def plot_scene(scene: HostScene, ax=None, alpha: float = 0.35):
    """The triangles, coloured per mesh."""
    _require_mpl()
    import matplotlib.pyplot as plt
    from matplotlib import colormaps
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    if ax is None:
        fig = plt.figure(figsize=(9, 8))
        ax = fig.add_subplot(111, projection="3d")
    cmap = colormaps["tab20"]
    for mi, mesh in enumerate(scene.meshes):
        tri = mesh.vertices[mesh.indices.astype(np.int64)]
        ax.add_collection3d(Poly3DCollection(
            tri, alpha=alpha, facecolor=cmap(mi % 20), edgecolor="k",
            linewidths=0.2))
    lo, hi = scene.bounding_box()
    c = (lo + hi) / 2
    r = float(np.max(hi - lo)) / 2 or 1.0
    ax.set_xlim(c[0] - r, c[0] + r)
    ax.set_ylim(c[1] - r, c[1] + r)
    ax.set_zlim(c[2] - r, c[2] + r)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_zlabel("z [m]")
    return ax


def _ray_segments(o, d, act, bounces: Optional[Sequence[int]] = None,
                 max_rays: int = 256, seg_len: float = 2.0):
    """The segments :func:`plot_rays` draws, ``[(bounce, start, end)]``,
    from one TX's host arrays: every ``P / max_rays``-th ray of each slot
    while active, to the next slot's origin where that ray is still active,
    else a stub of ``seg_len`` along its direction."""
    nslots, P = act.shape
    sel = np.linspace(0, P - 1, min(max_rays, P)).astype(int)
    segs = []
    for b in (range(nslots) if bounces is None else bounces):
        for p in sel:
            if not act[b, p]:
                continue
            start = o[b, p]
            if b + 1 < nslots and act[b + 1, p]:
                end = o[b + 1, p]
            else:
                end = start + seg_len * d[b, p]
            segs.append((b, start, end))
    return segs


def plot_rays(rays: RaysInfo, ax, bounces: Optional[Sequence[int]] = None,
              tx: int = 0, max_rays: int = 256, seg_len: float = 2.0):
    """Ray segments per bounce slot, coloured by depth, masked by activity
    (:func:`_ray_segments`)."""
    for b, start, end in _ray_segments(*_host_rays(rays, tx), bounces=bounces,
                                      max_rays=max_rays, seg_len=seg_len):
        ax.plot([start[0], end[0]], [start[1], end[1]], [start[2], end[2]],
                color=_BOUNCE_COLORS[b % len(_BOUNCE_COLORS)], linewidth=0.5,
                alpha=0.7)
    return ax


class RayViewer:
    """Interactive scene and rays viewer with the reference's key bindings:

    * mouse drag: orbit (yaw, pitch); scroll: dolly (matplotlib's own);
    * ``x`` / ``z``: the displayed bounce slot up / down;
    * ``w`` / ``a`` / ``s`` / ``d``: pan the view in the screen plane;
    * ``q`` / ``e``: roll the camera.

    Every handler is a plain method, so it runs without a display;
    :meth:`show` blocks in the UI loop."""

    def __init__(self, scene: HostScene, rays: RaysInfo, tx: int = 0,
                 max_rays: int = 512):
        _require_mpl()
        self.scene = scene
        o, d, act = _host_rays(rays, tx)               # numpy, read once
        self.rays = RaysInfo(o[None], d[None], act[None])
        self.tx = tx
        self.max_rays = max_rays
        self.bounce = 0
        self.num_slots = int(act.shape[0])
        self.ax = plot_scene(scene)
        self.fig = self.ax.figure
        self._ray_artists = []
        self.fig.canvas.mpl_connect("key_press_event", self.on_key)
        self._draw_rays()

    def _draw_rays(self):
        for art in self._ray_artists:
            art.remove()
        before = set(self.ax.lines)
        plot_rays(self.rays, self.ax, bounces=[self.bounce],
                  max_rays=self.max_rays)
        self._ray_artists = [ln for ln in self.ax.lines if ln not in before]
        self.ax.set_title(f"bounce {self.bounce}/{self.num_slots - 1} "
                          f"(x/z step, wasd pan, q/e roll)")
        self.fig.canvas.draw_idle()

    def step_bounce(self, delta: int):
        self.bounce = int(np.clip(self.bounce + delta, 0,
                                  self.num_slots - 1))
        self._draw_rays()

    def pan(self, dx: float, dy: float):
        """Pan in the screen plane by fractions of the current span."""
        for get_lim, set_lim, frac in (
                (self.ax.get_xlim, self.ax.set_xlim, dx),
                (self.ax.get_ylim, self.ax.set_ylim, dy)):
            lo, hi = get_lim()
            shift = (hi - lo) * frac
            set_lim(lo + shift, hi + shift)
        self.fig.canvas.draw_idle()

    def roll(self, degrees: float):
        elev = getattr(self.ax, "elev", 30.0)
        azim = getattr(self.ax, "azim", -60.0)
        roll = getattr(self.ax, "roll", 0.0) + degrees
        self.ax.view_init(elev=elev, azim=azim, roll=roll)
        self.fig.canvas.draw_idle()

    _KEYS = {"x": ("step_bounce", (+1,)), "z": ("step_bounce", (-1,)),
             "w": ("pan", (0.0, +0.1)), "s": ("pan", (0.0, -0.1)),
             "a": ("pan", (-0.1, 0.0)), "d": ("pan", (+0.1, 0.0)),
             "q": ("roll", (-10.0,)), "e": ("roll", (+10.0,))}

    def on_key(self, event):
        action = self._KEYS.get((event.key or "").lower())
        if action is not None:
            getattr(self, action[0])(*action[1])

    def show(self):
        """Block in the interactive loop (the reference's glutMainLoop)."""
        import matplotlib.pyplot as plt
        plt.show()


def vizrays(scene: HostScene, rays: RaysInfo, tx: int = 0,
            show: bool = True, max_rays: int = 512) -> RayViewer:
    """Open the interactive ray viewer (the reference's ``vizrays``).
    Returns the viewer; blocks in the UI loop when ``show``, which needs a
    display (without one use :func:`save_rays_figure` or ``show=False``)."""
    viewer = RayViewer(scene, rays, tx=tx, max_rays=max_rays)
    if show:
        viewer.show()
    return viewer


def save_rays_figure(scene: HostScene, rays: RaysInfo, path: str,
                     bounces: Optional[Sequence[int]] = None,
                     max_rays: int = 256, dpi: int = 130):
    """Render the scene and rays into an image file: the headless form of
    the reference's viewer window."""
    _require_mpl()
    import matplotlib.pyplot as plt

    ax = plot_scene(scene)
    plot_rays(rays, ax, bounces=bounces, max_rays=max_rays)
    ax.figure.savefig(path, dpi=dpi, bbox_inches="tight")
    plt.close(ax.figure)
    return path
