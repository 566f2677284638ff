"""What decides `correct`: which of the window's answers are compared,
the plain reference's answer to each, and the comparison, by numbers each
held to a limit the configuration states. The run and the precision
control (control.py) both call `numbers`, the control with the reference
one precision down in the program's place.

What a frame's answer is follows from the configuration alone: with
`denoiser_on` the whole denoised image, which the reference recomputes
from the frames since the last camera move (SVGF's history); without it
the progressive image, which the reference recomputes at pixels drawn
from the seed over every sample since the last move. The traffic mix
gives how many frames and pixels are compared, and its camera path gives
each compared frame's view and history."""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

# a pixel is off where a channel differs by more than this share of the
# reference's value plus this floor (radiance units)
PX_REL = 1e-3
PX_ABS = 1e-4

# RenderConfig settings the reference does not model, and the values it
# does
MODELLED = {"mode": "WAVEFRONT", "display": "RESULT", "jitter": True,
            "russian_roulette": False}


def compare(prog: np.ndarray, ref: np.ndarray) -> Dict[str, float]:
    """prog, ref: [P, 3] float arrays of the same pixels."""
    prog = np.asarray(prog, np.float64).reshape(-1, 3)
    ref = np.asarray(ref, np.float64).reshape(-1, 3)
    if prog.shape != ref.shape:
        raise ValueError(f"compared {prog.shape} with {ref.shape}")
    finite = np.isfinite(prog).all(1)
    diff = np.abs(np.where(np.isfinite(prog), prog, 0.0) - ref)
    off = ((diff > PX_REL * np.abs(ref) + PX_ABS).any(1)) | ~finite
    return {
        "nonfinite_px": float((~finite).sum()),
        "off_px_share": float(off.mean()),
        "rel_l1": float(diff.sum() / max(np.abs(ref).sum(), 1e-30)),
    }


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every compared number at or under its limit."""
    return all(numbers[k] <= limits[k] for k in limits)


class Sampler:
    """Which of a window's frames are compared: its last, and n - 1 more
    drawn from the seed by reservoir sampling (Algorithm R) over the
    others. `offer` each frame in turn; `kept` then holds (index, item)
    pairs. Which indices it keeps depends only on the seed and the count
    of frames offered (`indices`)."""

    def __init__(self, seed: int, n: int):
        self.draw = np.random.default_rng([seed, 2])
        self.n = max(0, n - 1)
        self.pool: List[Tuple[int, object]] = []
        self.last: Optional[Tuple[int, object]] = None
        self.count = 0

    def offer(self, index: int, item) -> None:
        if self.last is not None and self.n:
            j = self.count - 1  # the frames already in the reservoir's run
            if len(self.pool) < self.n:
                self.pool.append(self.last)
            else:
                k = int(self.draw.integers(0, j + 1))
                if k < self.n:
                    self.pool[k] = self.last
        self.last = (index, item)
        self.count += 1

    @property
    def kept(self) -> List[Tuple[int, object]]:
        return sorted(self.pool + ([self.last] if self.last else []),
                      key=lambda p: p[0])

    @staticmethod
    def indices(seed: int, n: int, first: int, count: int) -> List[int]:
        s = Sampler(seed, n)
        for k in range(first, first + count):
            s.offer(k, None)
        return [k for k, _ in s.kept]


def pixels(config: dict, traffic: dict, seed: int, resolution) -> \
        Optional[np.ndarray]:
    """The sorted pixel indices compared in each frame, drawn from the
    seed; None where whole frames are compared (denoised)."""
    if config["render"].get("denoiser_on", False):
        return None
    w, h = resolution
    n = min(int(traffic["check"]["pixels"]), w * h)
    return np.sort(np.random.default_rng([seed, 1]).choice(
        w * h, size=n, replace=False))


def modelled(config: dict) -> None:
    """Raise where the configuration asks for what the reference does not
    compute."""
    render = config["render"]
    for key, value in MODELLED.items():
        if key in render and render[key] != value:
            raise ValueError(f"the reference renders {key}={value!r} only, "
                             f"the configuration asks for {render[key]!r}")


def numbers(config: dict, traffic: dict, seed: int, raw_scene: dict, cam0,
            frames: List[Tuple[float, int]], answers: Optional[list],
            device, quantize: Optional[Callable] = None) -> Dict[str, float]:
    """The compared numbers, the worst over the compared frames. `frames`
    holds each frame's (yaw, frames from its view since the last move);
    `answers` the program's images ([H, W, 3]) of those frames, or None
    for the precision control: the reference with `quantize` applied to
    its scene and its paths."""
    import torch

    from .camera_path import yawed_position
    from .reference import pathtrace, scene as rscene

    modelled(config)
    render = config["render"]
    depth = int(render["trace_depth"])
    spp = max(1, int(render.get("spp_batch", 1)))
    svgf_cfg = SVGFSettings(config.get("svgf", {}))
    pix = pixels(config, traffic, seed, cam0.resolution)
    ref_scene = rscene.build(raw_scene, device)
    low_scene = (None if answers is not None
                 else rscene.build(raw_scene, device, quantize=quantize))
    pix_t = None if pix is None else torch.as_tensor(pix, device=device)

    def image(scn, cam, history, q):
        if pix_t is None:
            return pathtrace.denoised(scn, cam, svgf_cfg, history, spp, depth,
                                      q).cpu().numpy()
        return pathtrace.accumulated(scn, cam, pix_t, spp, history, depth,
                                     q).cpu().numpy()

    worst: Dict[str, float] = {}
    for k, (yaw, history) in enumerate(frames):
        cam = pathtrace.Cam.build(
            cam0.resolution,
            yawed_position(cam0.position, cam0.look_at, cam0.up, yaw),
            cam0.look_at, cam0.up, cam0.fovy_deg)
        ref = image(ref_scene, cam, history, None)
        if answers is None:
            other = image(low_scene, cam, history, quantize)
        else:
            other = np.asarray(answers[k]).reshape(-1, 3)
            if pix is not None:
                other = other[pix]
        nums = compare(other, ref)
        worst = {n: max(v, worst.get(n, v)) for n, v in nums.items()}
    return worst


class SVGFSettings:
    """The configuration's "svgf" settings as attributes, over the
    defaults of tpt_torch.config.SVGFConfig (copied, so the reference
    reads nothing of the program)."""

    DEFAULTS = {"sigma_z": 1.0, "sigma_n": 128.0, "sigma_l": 4.0,
                "atrous_iterations": 5, "history_threshold": 4,
                "temporal_alpha_min": 0.1, "demodulate_threshold": 0.01}
    def __init__(self, given: dict):
        unknown = set(given) - set(self.DEFAULTS)
        if unknown:
            raise ValueError(f"the reference's SVGF has no {sorted(unknown)}")
        for k, v in {**self.DEFAULTS, **given}.items():
            setattr(self, k, v)
