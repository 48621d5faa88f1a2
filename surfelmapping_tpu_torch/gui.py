"""Interactive mapping viewer (counterpart of surfelmapping_tpu/gui.py,
reference gui/GUI.{h,cpp}).

The reference drives a Pangolin window with panel buttons (pause / step /
save / reset / clean / path mode / acquire) and picture-in-picture views of
the input RGB, normalized depth, semantic palette and the rendered model
(gui/GUI.cpp:56-135,199-273; button loop build_map.cpp:25-271).  This
analogue uses matplotlib's event loop — no GL context — with the same
control surface:

  keys:  space pause/resume . step (while paused) m cycle model view
         s save map         c backward clean      r reset map
         v render a novel view offset from the current pose   q quit
         l the frame's local surfel model in the model panel
         f follow-pose map camera on/off (build_map.cpp:47-75 follow math)
         arrows orbit the free map camera, +/- zoom (gui/GUI.cpp s_cam)

The fifth panel is the reference's 3D map view: a free/follow camera render
of the model with the current camera frustum drawn over it
(gui/GUI.cpp:335-357 drawFrustum, yellow) and the capacity bar
(gui/GUI.cpp:275-300 drawCapacity: half view height, 2% width, fill =
surfels/capacity).  The frustum is drawn only with a fresh map render, so it
always sits in the camera that rendered the panel.

Both panels are renders of the map on the card (:func:`panel_renders`:
``ops/splat.render_view``, the z-buffer kernel).  matplotlib is imported
when a :class:`MappingGUI` is made; the rest of the module needs only numpy.
Headless environments (no DISPLAY) write the figure to PNG every
``snapshot_every`` frames instead of opening a window.

Usage:  python -m surfelmapping_tpu_torch.build_map DIR --gui   (or --gui-snapshots DIR)
"""

from __future__ import annotations

import os
import time

import numpy as np

from .ops.colors import SEMANTIC_PALETTE as _PALETTE

# cityscapes-style 19-class palette (src/GlobalModel.cpp:718-736), index =
# trainId, RGB
SEMANTIC_PALETTE = _PALETTE.numpy().astype(np.uint8)


def normalize_depth(depth_m: np.ndarray, far: float = 30.0) -> np.ndarray:
    """GUI depth panel: metric depth -> u8 grey, 0 = hole
    (gui/GUI.cpp normalizeDepth semantics)."""
    d = np.clip(np.asarray(depth_m, np.float32) / far, 0.0, 1.0)
    img = (d * 255).astype(np.uint8)
    img[np.asarray(depth_m) <= 0] = 0
    return img


def colorize_semantic(sem: np.ndarray) -> np.ndarray:
    """GUI semantic panel: class image -> palette RGB (show_semantic.frag)."""
    s = np.clip(np.asarray(sem, np.int64), 0, len(SEMANTIC_PALETTE) - 1)
    out = SEMANTIC_PALETTE[s]
    out[np.asarray(sem) < 0] = 0
    return out


def map_view_pose(pose, follow: bool = True, orbit_az: float = 0.0,
                  orbit_el: float = 0.45, orbit_dist: float = 18.0) -> np.ndarray:
    """Camera-to-world matrix of the map-view panel.

    Follow mode reproduces the reference follow math (build_map.cpp:47-75):
    eye behind the current pose along its forward axis, looking at it with
    the pose's up — distance scaled by the +/- zoom.  Free mode orbits the
    pose position (azimuth/elevation) at the zoom distance, like dragging
    the reference's Pangolin s_cam."""
    T = np.asarray(pose, np.float32)
    R = T[:3, :3]
    center = T[:3, 3]
    f = R @ np.array([0, 0, 1], np.float32)
    up = R @ np.array([0, -1, 0], np.float32)
    r = R @ np.array([1, 0, 0], np.float32)
    if follow:
        eye = center - f * (orbit_dist / 6.0) + up * (orbit_dist / 9.0)
    else:
        ca, sa = np.cos(orbit_az), np.sin(orbit_az)
        ce, se = np.cos(orbit_el), np.sin(orbit_el)
        d = -f * ca * ce + r * sa * ce + up * se
        eye = center + orbit_dist * d
    z = center - eye
    z = z / max(np.linalg.norm(z), 1e-9)
    x = np.cross(z, up)
    x = x / max(np.linalg.norm(x), 1e-9)
    y = np.cross(z, x)
    V = np.eye(4, dtype=np.float32)
    V[:3, 0], V[:3, 1], V[:3, 2], V[:3, 3] = x, y, z, eye
    return V


def panel_renders(mapper, smap, rgb, depth, semantic, pose, view_pose,
                  local: bool = False) -> tuple[dict, dict]:
    """The viewer's two model renders (``ops/splat.render_view``): the model
    panel at the frame's ``pose`` — of the map ``smap``, or with ``local``
    of the frame's unfused local surfel model (``mapper.local_model``) —
    and the map panel at ``view_pose``."""
    from .ops.splat import render_view

    dev = mapper.device
    src = mapper.local_model(rgb, depth, semantic, pose) if local else smap
    render = render_view(src, np.asarray(pose, np.float32), mapper.cam, device=dev)
    map_render = render_view(smap, view_pose, mapper.cam, device=dev)
    return render, map_render


def _host(img) -> np.ndarray:
    return img.cpu().numpy() if hasattr(img, "cpu") else np.asarray(img)


class MappingGUI:
    """Six-panel supervision view + keyboard control state.

    The engine loop (build_map.py) calls :meth:`update` once per frame and
    honours the flags the key handler sets — the same split as the
    reference's ``rungui`` (GUI owns widgets, the loop owns the engine)."""

    MODEL_VIEWS = ("rgb", "semantic", "depth")

    def __init__(self, cam, snapshot_dir: str | None = None,
                 snapshot_every: int = 20):
        self.cam = cam
        self.paused = False
        self.step_once = False
        self.want_save = False
        self.want_clean = False
        self.want_reset = False
        self.want_novel = False
        self.quit = False
        self.model_view = 0
        self.snapshot_every = snapshot_every
        self._frame_no = 0
        self._last_draw = 0.0
        self._last_view = None
        self.show_local = False  # 'l': render the frame's unfused local model
        # map-view camera state (reference followPose + free s_cam orbit)
        self.follow = True
        self.orbit_az = 0.0       # radians around the camera's up axis
        self.orbit_el = 0.45      # elevation above the horizon
        self.orbit_dist = 18.0    # metres from the followed pose

        self.interactive = bool(os.environ.get("DISPLAY")) and snapshot_dir is None
        self.snapshot_dir = snapshot_dir
        if not self.interactive and snapshot_dir is None:
            self.snapshot_dir = "gui_snapshots"
        if self.snapshot_dir:
            os.makedirs(self.snapshot_dir, exist_ok=True)

        import matplotlib

        if not self.interactive:
            matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from matplotlib.patches import Rectangle

        self._plt = plt
        self.fig, axes = plt.subplots(2, 3, figsize=(16, 5))
        if self.interactive:
            self.fig.canvas.manager.set_window_title("surfelmapping_tpu_torch")
        self.axes = axes.ravel()
        for ax, title in zip(self.axes, ("input rgb", "depth (metric)", "semantic",
                                         "model render", "map view (follow)",
                                         "trajectory")):
            ax.set_title(title, fontsize=9)
            ax.axis("off")
        H, W = cam.height, cam.width
        blank = np.zeros((H, W, 3), np.uint8)
        self.ims = [self.axes[i].imshow(blank) for i in range(5)]
        # frustum wires over the map view (drawFrustum, yellow): 8 segments
        self._frustum_lines = [self.axes[4].plot([], [], color="yellow", lw=1.0)[0]
                               for _ in range(8)]
        # capacity bar (drawCapacity: half view height, 2% width): outline
        # and fill in axes-fraction coordinates
        self._cap_outline = Rectangle((0.955, 0.25), 0.02, 0.5,
                                      transform=self.axes[4].transAxes, fill=False,
                                      edgecolor="white", lw=0.8)
        self._cap_fill = Rectangle((0.955, 0.25), 0.02, 0.0,
                                   transform=self.axes[4].transAxes, facecolor="lime",
                                   edgecolor="none")
        self.axes[4].add_patch(self._cap_outline)
        self.axes[4].add_patch(self._cap_fill)
        self.axes[4].set_xlim(0, W)
        self.axes[4].set_ylim(H, 0)
        # top-down trajectory track (reference path view)
        self._traj_xy: list[tuple[float, float]] = []
        self._traj_line = self.axes[5].plot([], [], color="tab:blue", lw=1.0)[0]
        self._traj_dot = self.axes[5].plot([], [], "o", color="red", ms=3)[0]
        self.axes[5].set_aspect("equal")
        self._status = self.fig.text(0.01, 0.01, "", fontsize=8)
        if self.interactive:
            self.fig.canvas.mpl_connect("key_press_event", self._on_key)
            plt.ion()
            plt.show(block=False)

    # -- control -----------------------------------------------------------

    def _on_key(self, event) -> None:
        k = event.key
        if k == " ":
            self.paused = not self.paused
        elif k == ".":
            self.step_once = True
        elif k == "s":
            self.want_save = True
        elif k == "c":
            self.want_clean = True
        elif k == "r":
            self.want_reset = True
        elif k == "v":
            self.want_novel = True
        elif k == "m":
            self.model_view = (self.model_view + 1) % len(self.MODEL_VIEWS)
        elif k == "l":
            self.show_local = not self.show_local
        elif k == "f":
            self.follow = not self.follow
            self.axes[4].set_title(f"map view ({'follow' if self.follow else 'free'})",
                                   fontsize=9)
        elif k == "left":
            self.orbit_az -= 0.15
        elif k == "right":
            self.orbit_az += 0.15
        elif k == "up":
            self.orbit_el = min(self.orbit_el + 0.1, 1.5)
        elif k == "down":
            self.orbit_el = max(self.orbit_el - 0.1, -0.2)
        elif k in ("+", "="):
            self.orbit_dist = max(self.orbit_dist / 1.25, 2.0)
        elif k == "-":
            self.orbit_dist = min(self.orbit_dist * 1.25, 200.0)
        elif k == "q":
            self.quit = True

    def wait_if_paused(self) -> None:
        """Block the engine loop while paused (reference pause button),
        still pumping the event loop so keys keep working."""
        while self.interactive and self.paused and not self.quit:
            if self.step_once:
                self.step_once = False
                return
            self._plt.pause(0.05)

    # -- map-view camera ---------------------------------------------------

    def map_view_pose(self, pose) -> np.ndarray:
        """:func:`map_view_pose` at the viewer's camera state; remembered as
        the camera of the next map panel."""
        self._last_view = map_view_pose(pose, self.follow, self.orbit_az,
                                        self.orbit_el, self.orbit_dist)
        return self._last_view

    def _draw_frustum(self, pose: np.ndarray, depth: float = 2.0) -> None:
        """Project the camera frustum into the map view's camera and update
        the 8 wire segments (drawFrustum: yellow, apex + 4 edges + far-plane
        quad; scale = ``depth`` metres)."""
        cam = self.cam
        T = np.asarray(pose, np.float32)
        corners = np.array([
            [(u - cam.cx) / cam.fx * depth, (v - cam.cy) / cam.fy * depth, depth, 1.0]
            for u, v in ((0, 0), (cam.width, 0), (cam.width, cam.height), (0, cam.height))
        ], np.float32)
        world = corners @ T.T  # rows = world-frame corners
        pts = np.concatenate([world, T[:, 3][None]], axis=0) @ np.linalg.inv(self._last_view).T
        z = pts[:, 2]
        uv = np.stack([cam.fx * pts[:, 0] / np.maximum(z, 1e-6) + cam.cx,
                       cam.fy * pts[:, 1] / np.maximum(z, 1e-6) + cam.cy], axis=1)
        ok = z > 0.05
        segs = [(4, 0), (4, 1), (4, 2), (4, 3), (0, 1), (1, 2), (2, 3), (3, 0)]
        for line, (a, b) in zip(self._frustum_lines, segs):
            if ok[a] and ok[b]:
                line.set_data([uv[a, 0], uv[b, 0]], [uv[a, 1], uv[b, 1]])
            else:
                line.set_data([], [])

    # -- drawing -----------------------------------------------------------

    def update(self, rgb, depth_m, semantic, render: dict | None,
               status: str = "", pose=None, map_render: dict | None = None,
               capacity_used: int | None = None,
               capacity_total: int | None = None) -> None:
        """Refresh the panels.  ``render`` is a render_view output at the
        CURRENT camera (or None to keep the previous model panel);
        ``map_render`` one at :meth:`map_view_pose` for the map panel, over
        which ``pose``'s frustum is drawn; ``pose`` also extends the
        trajectory; capacity_used/total drive the bar."""
        self._frame_no += 1
        draw = self.interactive or (
            self.snapshot_dir and self._frame_no % self.snapshot_every == 0
        )
        if not draw:
            return
        now = time.time()
        if self.interactive and now - self._last_draw < 0.1:
            return  # cap redraw rate; engine throughput wins
        self._last_draw = now

        self.ims[0].set_data(np.asarray(rgb, np.uint8))
        self.ims[1].set_data(np.repeat(normalize_depth(depth_m)[..., None], 3, axis=-1))
        self.ims[2].set_data(colorize_semantic(semantic))
        if render is not None:
            mode = self.MODEL_VIEWS[self.model_view]
            if mode == "rgb":
                img = np.clip(_host(render["rgb"]) * 255, 0, 255).astype(np.uint8)
            elif mode == "semantic":
                img = colorize_semantic(_host(render["semantic"]) - 1)
            else:
                img = np.repeat(normalize_depth(_host(render["depth"]))[..., None], 3,
                                axis=-1)
            self.ims[3].set_data(img)
            self.axes[3].set_title(f"model render ({mode})", fontsize=9)
        if map_render is not None:
            self.ims[4].set_data(
                np.clip(_host(map_render["rgb"]) * 255, 0, 255).astype(np.uint8))
            if pose is not None and self._last_view is not None:
                self._draw_frustum(pose)
        if pose is not None:
            T = np.asarray(pose, np.float32)
            self._traj_xy.append((float(T[0, 3]), float(T[2, 3])))
            xs = [p[0] for p in self._traj_xy]
            ys = [p[1] for p in self._traj_xy]
            self._traj_line.set_data(xs, ys)
            self._traj_dot.set_data([xs[-1]], [ys[-1]])
            self.axes[5].relim()
            self.axes[5].autoscale_view()
        if capacity_used is not None and capacity_total:
            frac = min(max(capacity_used / capacity_total, 0.0), 1.0)
            self._cap_fill.set_height(0.5 * frac)
            self._cap_fill.set_facecolor(
                "red" if frac > 0.9 else "orange" if frac > 0.75 else "lime")
        self._status.set_text(status)

        if self.interactive:
            self.fig.canvas.draw_idle()
            self._plt.pause(0.001)
        else:
            self.fig.savefig(
                os.path.join(self.snapshot_dir, f"frame_{self._frame_no:06d}.png"), dpi=80)

    def close(self) -> None:
        self._plt.close(self.fig)
