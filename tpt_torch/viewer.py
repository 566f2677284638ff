"""Progressive preview, the counterpart of `tpt/viewer.py` (the
reference's GLFW/ImGui viewer): progressive rendering with FPS-style
camera controls, display-channel switching, a denoiser toggle and an
analytics readout. Headless (no DISPLAY, or interactive=False) it writes
periodic PNG snapshots; a window needs matplotlib, and asking for one
where matplotlib is not installed raises instead of pretending to show
it. Frames come back to the host once each, as display-ready uint8 on
the low-resolution navigation engine.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np

from .config import DisplayMode
from .engine import Renderer
from .io.image import save_png, tonemap


def make_preview_renderer(renderer: Renderer, scale: int = 4,
                          mode=None, nav_depth: int = 0) -> Renderer:
    """A second engine at 1/scale resolution sharing the scene, for fast
    feedback while the camera moves: the viewer drops the resolution by
    scale^2 during navigation and lets the full-resolution engine
    re-accumulate once the camera rests. `mode` overrides the preview
    engine's RenderMode (the viewers pass MEGAKERNEL: one pass over the
    pixels instead of the wavefront's per-bounce stages), `nav_depth` > 0
    caps its trace depth."""
    cam = renderer.cam
    w, h = cam.resolution
    from .core.camera import Camera

    small = Camera.build((max(16, w // scale), max(16, h // scale)),
                         cam.position, cam.look_at, cam.up, cam.fovy_deg)
    kw = {}
    if mode is not None:
        kw["mode"] = mode
    if nav_depth > 0:
        kw["trace_depth"] = min(nav_depth, renderer.cfg.trace_depth)
    cfg = renderer.cfg.with_(**kw) if kw else renderer.cfg
    preview = Renderer(renderer.scene, small, cfg)
    # nav frames come back display-ready u8 (a quarter of the bytes, no
    # host pow): the preview is display-only
    preview.display_u8 = True
    return preview


def yaw_pitch_from_view(view) -> tuple:
    """Decompose a unit view direction into (yaw, pitch) degrees using the
    reference's FPS-camera convention (main.cpp:updateCameraVectors):
    front = (cos(yaw)cos(pitch), sin(pitch), sin(yaw)cos(pitch))."""
    import math

    pitch = math.degrees(math.asin(max(-1.0, min(1.0, float(view[1])))))
    yaw = math.degrees(math.atan2(float(view[2]), float(view[0])))
    return yaw, pitch


def view_from_yaw_pitch(yaw: float, pitch: float) -> tuple:
    import math

    cy, sy = math.cos(math.radians(yaw)), math.sin(math.radians(yaw))
    cp, sp = math.cos(math.radians(pitch)), math.sin(math.radians(pitch))
    return (cy * cp, sp, sy * cp)


def _upscale(img: np.ndarray, shape) -> np.ndarray:
    """Nearest-neighbour upscale of [h,w,3] to `shape` (no deps)."""
    h, w = shape
    sh, sw = img.shape[:2]
    yi = (np.arange(h) * sh) // h
    xi = (np.arange(w) * sw) // w
    return img[yi][:, xi]


class CameraRig:
    """FPS camera controls shared by the matplotlib and terminal viewers
    (the reference's translation and mouse-look). Drives the full-res
    engine and an optional low-res preview engine; every move re-targets
    both and resets accumulation like the reference's camera edits."""

    def __init__(self, renderer: Renderer, preview: Optional[Renderer],
                 nav_hold_s: float = 0.75):
        self.renderer = renderer
        self.preview = preview
        self.nav_hold_s = nav_hold_s
        self.moving_until = 0.0

    @property
    def navigating(self) -> bool:
        return self.preview is not None and time.time() < self.moving_until

    def _retarget(self, moved) -> None:
        self.renderer.move_camera(moved)
        if self.preview is not None:
            self.preview.move_camera(self.preview.cam.moved(
                position=moved.position, look_at=moved.look_at))
            self.moving_until = time.time() + self.nav_hold_s

    def move(self, forward: float = 0.0, right: float = 0.0,
             up: float = 0.0) -> None:
        cam = self.renderer.cam
        speed = 0.02 * np.linalg.norm(
            np.asarray(cam.look_at) - np.asarray(cam.position)) + 1.0
        delta = (np.asarray(cam.view) * forward
                 + np.asarray(cam.right) * right
                 + np.asarray(cam.true_up) * up) * speed
        self._retarget(cam.moved(
            position=tuple(np.asarray(cam.position) + delta),
            look_at=tuple(np.asarray(cam.look_at) + delta)))

    def look(self, dx_px: float, dy_px: float,
             sensitivity: float = 0.2) -> None:
        cam = self.renderer.cam
        yaw, pitch = yaw_pitch_from_view(cam.view)
        yaw -= dx_px * sensitivity
        pitch = max(-89.0, min(89.0, pitch + dy_px * sensitivity))
        dist = float(np.linalg.norm(np.asarray(cam.look_at)
                                    - np.asarray(cam.position)))
        front = np.asarray(view_from_yaw_pitch(yaw, pitch))
        self._retarget(cam.moved(look_at=tuple(
            np.asarray(cam.position) + front * max(dist, 1e-3))))


def run_viewer(renderer: Renderer, max_frames: int = 0,
               out_dir: str = ".", snapshot_every: int = 10,
               interactive: Optional[bool] = None,
               preview_scale: int = 8) -> None:
    """Progressive render loop. Keyboard (interactive matplotlib):
    1-6 display channels, d toggles denoiser, s saves, q quits, as the
    reference's key bindings. While the camera moves, frames come from a
    1/preview_scale-resolution depth-2 MEGAKERNEL engine, pipelined, for
    responsive navigation; set preview_scale=1 to disable. Headless it
    writes preview.png every `snapshot_every` frames."""
    if interactive is None:
        interactive = bool(os.environ.get("DISPLAY"))

    if not interactive:
        frame_count = 0
        while max_frames <= 0 or frame_count < max_frames:
            img = renderer.frame()
            frame_count += 1
            if frame_count % snapshot_every == 0:
                save_png(os.path.join(out_dir, "preview.png"), img[:, ::-1])
                g = renderer.gui
                print(f"[viewer] frame {frame_count}  {g.frame_ms:.1f} ms  "
                      f"{g.mrays_per_sec:.2f} MRays/s")
            if max_frames <= 0 and frame_count >= 1000:
                break
        return

    try:
        import matplotlib
    except ImportError as exc:
        raise RuntimeError(
            "an interactive viewer window needs matplotlib, which is not "
            "installed here; run headless (interactive=False, or unset "
            "DISPLAY: PNG snapshots) or use the terminal viewer (-tui)"
        ) from exc

    matplotlib.use("TkAgg" if os.environ.get("DISPLAY") else "Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 8))
    fig.canvas.manager.set_window_title("tpt_torch viewer")
    state = {"quit": False}
    from .config import RenderMode

    preview = (make_preview_renderer(renderer, preview_scale,
                                     mode=RenderMode.MEGAKERNEL,
                                     nav_depth=2)
               if preview_scale > 1 else None)
    if preview is not None:
        # pipelined nav frames: the device renders frame N while the host
        # displays N-1, at one frame of display latency
        preview.pipeline = True
    rig = CameraRig(renderer, preview)
    move_camera = rig.move
    look_camera = rig.look

    def on_key(event):
        k = event.key
        if k == "q":
            state["quit"] = True
        elif k == "d":
            renderer.gui.denoiser_on = not renderer.gui.denoiser_on
            renderer.reset()
        elif k == "s":
            save_png(os.path.join(out_dir, "viewer_save.png"),
                     renderer.frame()[:, ::-1])
        elif k in "123456":
            renderer.gui.display_mode = DisplayMode(int(k) - 1)
        elif k == "w":
            move_camera(forward=1.0)
        elif k == "x":
            move_camera(forward=-1.0)
        elif k == "a":
            move_camera(right=-1.0)
        elif k == "e":
            move_camera(right=1.0)
        elif k == "r":
            move_camera(up=1.0)
        elif k == "f":
            move_camera(up=-1.0)
        elif k == " ":
            # camera parameter dump for scene authoring
            cam = renderer.cam
            print(f'"EYE": {list(cam.position)},')
            print(f'"LOOKAT": {list(cam.look_at)},')
            print(f'"UP": {list(cam.up)},')

    fig.canvas.mpl_connect("key_press_event", on_key)

    drag = {"on": False, "x": 0.0, "y": 0.0}

    def on_press(event):
        if event.button == 1:
            drag.update(on=True, x=event.x, y=event.y)

    def on_release(event):
        if event.button == 1:
            drag["on"] = False

    def on_motion(event):
        if drag["on"] and event.x is not None:
            dx, dy = event.x - drag["x"], event.y - drag["y"]
            drag.update(x=event.x, y=event.y)
            if dx or dy:
                look_camera(dx, dy)

    fig.canvas.mpl_connect("button_press_event", on_press)
    fig.canvas.mpl_connect("button_release_event", on_release)
    fig.canvas.mpl_connect("motion_notify_event", on_motion)
    handle = ax.imshow(np.zeros((8, 8, 3), np.uint8))
    ax.axis("off")
    plt.ion()
    plt.show()

    frame_count = 0
    full_shape = renderer._shape
    while not state["quit"] and (max_frames <= 0 or frame_count < max_frames):
        navigating = rig.navigating
        if navigating:
            img = _upscale(preview.frame(), full_shape)
            g = preview.gui
        else:
            img = renderer.frame()
            g = renderer.gui
        frame_count += 1
        handle.set_data(tonemap(img[:, ::-1]))
        ax.set_title(f"iter {frame_count} | {g.frame_ms:.1f} ms | "
                     f"{g.mrays_per_sec:.2f} MRays/s | "
                     f"{'preview' if navigating else ('SVGF on' if g.denoiser_on else 'accumulating')}")
        fig.canvas.draw_idle()
        plt.pause(0.001)
