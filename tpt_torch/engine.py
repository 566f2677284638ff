"""Renderer facade: the reference's engine contract (init, frame, free) as a
stateful host object over the port's two integrators and SVGF.
Counterpart of `tpt/engine.py`: the same accumulators, SVGF history,
camera moves that keep the previous view-projection for motion vectors,
display channels, frame pipelining, device-side tonemap and checkpoint
layout, so a checkpoint written by tpt's Renderer resumes here.

In RenderMode.WAVEFRONT with `denoiser_on` a frame is the engine's
real-time mode: one wavefront frame from zeroed accumulators, then
`svgf.run_svgf` (K6 reprojection and 5 K5 a-trous passes on the card).
In RenderMode.MEGAKERNEL a frame adds one megakernel sample of every
pixel to `acc_mega` and shows its mean, as tpt's engine does (which
neither denoises nor selects a display channel in that mode).
DisplayMode.BVH_HEATMAP shows `bvh_heatmap`, the traversal cost of the
camera rays on the scene's binary BVH (BVH_XLA's `traversal_cost`),
computed on the device and colored on the host, as tpt's. The options
`wavefront._unsupported` refuses raise NotImplementedError in either
mode.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from .config import DisplayMode, RenderConfig, RenderMode
from .core.camera import Camera
from .core.vec import Vec3
from .denoise import svgf
from .integrators import common, megakernel, wavefront
from .scene.structs import SceneData

@dataclass
class GuiData:
    """Analytics mirror of the reference GuiDataContainer."""

    traced_depth: int = 0
    mrays_per_sec: float = 0.0
    frame_ms: float = 0.0
    denoiser_on: bool = False
    display_mode: DisplayMode = DisplayMode.RESULT


def _vec_leaves(v: Vec3):
    return [v.x, v.y, v.z]


class Renderer:
    """Stateful wrapper (host side): owns the accumulators and the SVGF
    history on the scene's device.

    frame() -> [H, W, 3] numpy image (float32, or uint8 with display_u8).
    """

    def __init__(self, scene: SceneData, cam: Camera, cfg: RenderConfig):
        self.mega = cfg.mode == RenderMode.MEGAKERNEL
        reason = wavefront._unsupported(cfg)
        if reason:
            raise NotImplementedError(f"{reason} is not ported yet (ROADMAP "
                                      "queue 1 item 6)")
        self.scene = scene
        self.cam = cam
        self.cfg = cfg
        self.device = scene.device
        self.gui = GuiData(denoiser_on=cfg.denoiser_on, display_mode=cfg.display)
        w, h = cam.resolution
        self._shape = (h, w)
        # opt-in frame pipelining: frame() enqueues frame N but returns
        # frame N-1, so the device renders while the host displays
        self.pipeline = False
        # opt-in device-side tonemap: frame() returns display-ready uint8
        self.display_u8 = False
        self.raycaster = common.make_raycaster(scene, cfg)
        if self.mega:
            self._mega_step = megakernel.make_sample_fn(
                scene, cam, cfg, raycaster=self.raycaster)
        self._vp = wavefront.camera_view_proj(cam)
        self._prev_vp = self._vp
        self.reset()

    # -- state ---------------------------------------------------------------
    def reset(self):
        """Camera moved / first frame: clear accumulation. Allocation is
        lazy (`_ensure_state`): viewers move the camera every navigation
        frame, and a reset allocates nothing until the next frame."""
        self.iteration = 0
        self._state_alloc = False
        # a pending pipelined frame predates the reset — drop it
        self._pending = None

    def _ensure_state(self):
        if self._state_alloc:
            return
        n = self.cam.num_pixels
        h, w = self._shape
        self.acc_direct = Vec3.zeros((n,), self.device)
        self.acc_indirect = Vec3.zeros((n,), self.device)
        self.acc_mega = Vec3.zeros((n,), self.device)
        self.svgf_state = svgf.SVGFState.zeros(h, w, self.device)
        self._state_alloc = True

    def move_camera(self, cam: Camera):
        """Re-target the camera. The previous view-projection is kept for
        the next frame's motion vectors, but, as in tpt, the reset also
        clears the SVGF history (the next frame allocates a zeroed
        SVGFState), so the denoiser restarts after every move. The
        megakernel's next sample simply follows the new camera."""
        same_res = cam.resolution == self.cam.resolution
        self.cam = cam
        if not self.mega:
            prev = self._vp
            self._vp = wavefront.camera_view_proj(cam)
            self._prev_vp = prev
        if not same_res:
            w, h = cam.resolution
            self._shape = (h, w)
        # a pipelined frame in flight survives a same-resolution move
        pending = self._pending if same_res else None
        self.reset()
        self._pending = pending

    # -- svgf glue -------------------------------------------------------------
    def _svgf_impl(self, st: svgf.SVGFState, out: wavefront.FrameOutput):
        h, w = self._shape
        plane = lambda a: a.reshape(h, w)
        p3 = lambda v: Vec3(plane(v.x), plane(v.y), plane(v.z))
        return svgf.run_svgf(
            self.cfg.svgf, st,
            p3(out.direct), p3(out.indirect),
            p3(out.gbuf.albedo), plane(out.gbuf.depth), p3(out.gbuf.normal),
            plane(out.gbuf.mat_id), plane(out.gbuf.motion_u),
            plane(out.gbuf.motion_v))

    def _u8(self, x: torch.Tensor) -> torch.Tensor:
        """clip + 1/gamma + quantize, on the device."""
        return (torch.clamp(torch.nan_to_num(x), 0.0, 1.0)
                ** (1.0 / self.cfg.gamma) * 255.0 + 0.5).to(torch.uint8)

    # -- frame -----------------------------------------------------------------
    def frame(self) -> np.ndarray:
        # a wavefront frame consumes spp_batch consecutive iteration numbers
        # (one per sample in the pool), a megakernel frame one; iteration
        # counts samples, so seeds never overlap across frames and the
        # accumulator normalization is exact
        step = 1 if self.mega else max(1, self.cfg.spp_batch)
        self._ensure_state()
        it = self.iteration + 1
        self.iteration += step
        h, w = self._shape
        t0 = time.perf_counter()

        if self.mega:
            self.acc_mega = self._mega_step(it, self.acc_mega, cam=self.cam)
            img_dev = (self.acc_mega * (1.0 / self.iteration)).stacked()
            rays = self.cam.num_pixels * self.cfg.trace_depth
        else:
            img_dev, rays = self._wavefront_frame(it)
        # the heatmap comes back as host numpy and stays float
        if (self.display_u8 and isinstance(img_dev, torch.Tensor)
                and img_dev.dtype != torch.uint8):
            img_dev = self._u8(img_dev)

        if self.pipeline:
            # return the previous frame; this one stays in flight until
            # the next call fetches it
            prev = self._pending
            self._pending = (img_dev, rays, (h, w))
            if prev is not None:
                img_dev, rays, (h, w) = prev
        img = (img_dev if isinstance(img_dev, np.ndarray)
               else img_dev.cpu().numpy())
        if not self.pipeline and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

        dt = time.perf_counter() - t0
        self.gui.frame_ms = dt * 1000.0
        self.gui.mrays_per_sec = int(rays) / dt / 1e6
        self.gui.traced_depth = self.cfg.trace_depth
        return img.reshape(h, w, 3)

    def _wavefront_frame(self, it: int):
        """One wavefront frame at iteration `it` (accumulated, or denoised
        in the real-time mode): (image on the device, rays traced)."""
        if self.gui.denoiser_on:
            # real-time mode: 1 spp per frame, no accumulation
            n = self.cam.num_pixels
            self.acc_direct = Vec3.zeros((n,), self.device)
            self.acc_indirect = Vec3.zeros((n,), self.device)
        out = wavefront.trace_frame(self.scene, self.raycaster, self.cam,
                                    self.cfg, it, view_proj=self._vp,
                                    prev_view_proj=self._prev_vp)
        self.acc_direct = self.acc_direct + out.direct
        self.acc_indirect = self.acc_indirect + out.indirect
        self._prev_vp = self._vp
        rays = out.rays_traced

        if self.gui.denoiser_on:
            rgb, self.svgf_state = self._svgf_impl(self.svgf_state, out)
            return rgb.stacked(), rays
        return self._display_device(out), rays

    def bvh_heatmap(self) -> np.ndarray:
        """Traversal-cost temperature map of the camera rays (the
        reference's BVH debug view): each pixel's escape-link walk steps
        on the scene's BVH, scaled by the 98th percentile and put on a
        blue-green-red ramp, [H, W, 3] float32. Needs a scene built with
        a BVH."""
        from .bvh.traverse import traversal_cost
        from .core.camera import generate_camera_rays

        if self.scene.bvh is None:
            raise ValueError("bvh_heatmap requires a scene built with_bvh=True")
        h, w = self._shape
        ori, d, _ = generate_camera_rays(self.cam, 1, jitter=False,
                                         device=self.device)
        cost = traversal_cost(self.scene.mesh, self.scene.bvh, ori, d)
        cost = cost.cpu().numpy().reshape(h, w)
        t = np.clip(cost / max(1.0, float(np.percentile(cost, 98))), 0.0, 1.0)
        r = np.clip(2.0 * t - 1.0, 0, 1)
        g = 1.0 - np.abs(2.0 * t - 1.0)
        b = np.clip(1.0 - 2.0 * t, 0, 1)
        return np.stack([r, g, b], axis=-1).astype(np.float32)

    def save_checkpoint(self, path: str):
        """Snapshot the render state (accumulators, SVGF history,
        iteration) in tpt's layout: acc_direct_{0..2}, acc_indirect_{0..2},
        acc_mega_{0..2}, svgf_{0..17} in tpt's leaf order, iteration."""
        self._ensure_state()
        flat = {}
        for name, leaves in (("acc_direct", _vec_leaves(self.acc_direct)),
                             ("acc_indirect", _vec_leaves(self.acc_indirect)),
                             ("acc_mega", _vec_leaves(self.acc_mega)),
                             ("svgf", self.svgf_state.leaves())):
            for i, leaf in enumerate(leaves):
                flat[f"{name}_{i}"] = leaf.cpu().numpy()
        flat["iteration"] = np.int64(self.iteration)
        np.savez_compressed(path, **flat)

    def load_checkpoint(self, path: str):
        """Resume from a checkpoint of this Renderer or of tpt's."""
        self._ensure_state()
        with np.load(path) as data:
            self.iteration = int(data["iteration"])

            def vec(name, like: Vec3) -> Vec3:
                comps = [torch.from_numpy(np.ascontiguousarray(
                    data[f"{name}_{i}"], np.float32)).to(self.device)
                    for i in range(3)]
                if any(c.shape != like.x.shape for c in comps):
                    raise ValueError(f"checkpoint {name} has shape "
                                     f"{tuple(comps[0].shape)}, the renderer "
                                     f"{tuple(like.x.shape)}")
                return Vec3(*comps)

            self.acc_direct = vec("acc_direct", self.acc_direct)
            self.acc_indirect = vec("acc_indirect", self.acc_indirect)
            self.acc_mega = vec("acc_mega", self.acc_mega)
            state = svgf.svgf_state_from_numpy(
                [data[f"svgf_{i}"] for i in range(18)], self.device)
        if tuple(state.history_len.shape) != self._shape:
            raise ValueError(f"checkpoint SVGF history is "
                             f"{tuple(state.history_len.shape)}, the "
                             f"renderer {self._shape}")
        self.svgf_state = state

    def _display_device(self, out: wavefront.FrameOutput) -> torch.Tensor:
        """Display-channel selection (the reference's
        pathtrace_wavefront.cu:82-109), on the device; the heatmap is
        colored on the host and comes back as numpy."""
        mode = self.gui.display_mode
        if mode == DisplayMode.BVH_HEATMAP:
            return self.bvh_heatmap()
        g = out.gbuf
        if mode == DisplayMode.NORMAL:
            return (g.normal * 0.5 + 0.5).stacked()
        if mode == DisplayMode.DEPTH:
            d = torch.clamp(g.depth / 1000.0, 0.0, 1.0)
            return torch.stack([d, d, d], dim=-1)
        if mode == DisplayMode.ALBEDO:
            return g.albedo.stacked()
        if mode == DisplayMode.MOTION_VECTOR:
            mu = torch.abs(g.motion_u) / 8.0
            mv = torch.abs(g.motion_v) / 8.0
            return torch.stack([mu, mv, torch.zeros_like(mu)], dim=-1)
        acc = (self.acc_direct + self.acc_indirect) * (1.0 / self.iteration)
        return acc.stacked()
