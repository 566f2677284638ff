"""Multi-device rendering over torch.distributed: pixels sharded over the
ranks of a process group, the scene replicated on every rank.

Counterpart of `tpt/parallel/sharding.py`. Path tracing is parallel over
pixels, so rank r of a world of N renders the contiguous rows
[r * H/N, (r + 1) * H/N): it generates only those camera rays (the RNG
streams are the frame's, keyed by the global pixel index) and runs the
one-process frame, `wavefront.trace_frame(..., pix=)`, on its own pool,
with the coherence or bin sort and the unsort local to it as in tpt's
`shard_map` loop, and sums the ray counter with one all_reduce. SVGF
runs on row windows fetched from the neighbours (`halo.py`). The image
is the one-process image bit for bit: every lane's arithmetic is the
same, whatever pool it sits in.

This is the torchrun idiom: the caller runs
`torch.distributed.init_process_group` (and, with one card a rank,
`torch.cuda.set_device`) and hands the group to `make_pixel_mesh`:

    torchrun --nproc-per-node=N script.py      # script.py:
    dist.init_process_group("nccl")
    torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    scene = host.build(with_bvh=True)           # on every rank
    img = render_sharded(scene, host.camera, cfg, make_pixel_mesh())

The backend is the caller's; nothing retries with another. Under NCCL
the collectives take the card's tensors; under any other backend (gloo)
they go through the host, since gloo's point-to-point calls take CPU
tensors only.

Not ported, since the image is the same without them: tpt's
`split_bounces` (one program a bounce, for the TPU's watchdog and compile
cliffs), `use_shard_map=False` and the early stop at zero live lanes.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, fields, is_dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import RenderConfig
from ..core.camera import Camera
from ..core.vec import Vec3
from ..denoise.svgf import SVGFState
from ..device import DeviceLike, resolve_device
from ..integrators import wavefront
from ..integrators.common import make_raycaster
from ..scene.structs import SceneData
from . import halo


@dataclass(frozen=True)
class PixelMesh:
    """The caller's process group as the render sees it: this rank, the
    world size, the backend's name and the device the rank renders on."""

    rank: int
    world: int
    backend: str
    device: torch.device
    group: Optional[dist.ProcessGroup] = None

    @property
    def comm_device(self) -> torch.device:
        """Where the collectives' tensors live: the card under NCCL, the
        host under any other backend."""
        return self.device if self.backend == "nccl" else torch.device("cpu")

    def to_comm(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.comm_device)

    def peer(self, q: int) -> int:
        """Global rank of the group's rank q (point-to-point peers)."""
        return q if self.group is None else dist.get_global_rank(self.group, q)

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """t reduced over the ranks (a new tensor on the comm device)."""
        c = self.to_comm(t).clone()
        dist.all_reduce(c, op=op, group=self.group)
        return c

    def all_gather(self, t: torch.Tensor) -> list:
        """Every rank's t (equal shapes), in rank order, on the comm device."""
        c = self.to_comm(t).contiguous()
        out = [torch.empty_like(c) for _ in range(self.world)]
        dist.all_gather(out, c, group=self.group)
        return out


def make_pixel_mesh(group: Optional[dist.ProcessGroup] = None,
                    device: DeviceLike = None) -> PixelMesh:
    """Describe the caller's initialized process group (the default group
    when None). The device is the current CUDA card unless the caller asks
    for another (`device="cpu"`); without a GPU and without that request
    this raises. NCCL needs the card."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("call torch.distributed.init_process_group first "
                           "(torchrun idiom); make_pixel_mesh describes it")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    backend = str(dist.get_backend(group))
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"the nccl backend needs a CUDA device, not {dev}")
    return PixelMesh(rank=dist.get_rank(group),
                     world=dist.get_world_size(group), backend=backend,
                     device=dev, group=group)


def _table_digest(obj, h) -> None:
    """Feed every tensor (dtype, shape, bytes) and scalar of a scene tree
    into the hash h, in field order."""
    if isinstance(obj, torch.Tensor):
        a = obj.detach().cpu().contiguous()
        h.update(f"{a.dtype}{tuple(a.shape)}".encode())
        h.update(a.reshape(-1).view(torch.uint8).numpy().tobytes())
    elif is_dataclass(obj):
        for f in fields(obj):
            h.update(f.name.encode())
            _table_digest(getattr(obj, f.name), h)
    else:
        h.update(repr(obj).encode())


def replicate(mesh: PixelMesh, scene: SceneData) -> SceneData:
    """Check that every rank holds the same scene tables: each rank builds
    its own (the prep cache makes that quick for big scenes), and one
    all_gather of a digest of every table tensor must agree, or this
    raises on every rank."""
    h = hashlib.sha256()
    _table_digest(scene, h)
    mine = torch.from_numpy(
        np.frombuffer(h.digest(), dtype=np.int64).copy())
    digests = mesh.all_gather(mine)
    differ = [q for q, d in enumerate(digests) if not torch.equal(d.cpu(), mine)]
    if differ:
        raise ValueError(f"rank {mesh.rank}: the scene tables of ranks "
                         f"{differ} differ from this rank's; build the same "
                         f"scene on every rank")
    return scene


class ShardedStep:
    """step(iteration, prev_vp, carry, cam=None) -> (rgb, carry'): one
    1-spp frame of this rank's rows, accumulated, and denoised when built
    with SVGF. rgb is a Vec3 of [rows, W] planes; carry is (acc_d, acc_i,
    SVGFState of the rows). `cam` (same resolution) moves the camera for
    this frame. After a call, `rays` holds the frame's rays summed over
    the ranks, `window` the SVGF window's rows, R and M, and
    `raycaster.capped` this rank's capped rays."""

    def __init__(self, scene: SceneData, cam: Camera, cfg: RenderConfig,
                 mesh: PixelMesh, with_svgf: bool):
        w, h = cam.resolution
        self.scene, self.cam, self.cfg, self.mesh = scene, cam, cfg, mesh
        self.with_svgf = with_svgf
        self.rows = h // mesh.world
        r0 = mesh.rank * self.rows
        self.pix = torch.arange(r0 * w, (r0 + self.rows) * w,
                                dtype=torch.int64, device=scene.device)
        self.raycaster = make_raycaster(scene, cfg)
        self.rays = None
        self.window = None

    def init_state(self):
        w = self.cam.resolution[0]
        dev = self.scene.device
        n = self.rows * w
        return (Vec3.zeros((n,), dev), Vec3.zeros((n,), dev),
                SVGFState.zeros(self.rows, w, dev))

    def __call__(self, iteration: int, prev_vp, carry,
                 cam: Optional[Camera] = None):
        cam = self.cam if cam is None else cam
        if cam.resolution != self.cam.resolution:
            raise ValueError(f"camera resolution {cam.resolution} is not the "
                             f"step's {self.cam.resolution}")
        cfg, w = self.cfg, cam.resolution[0]
        acc_d, acc_i, state = carry
        out = wavefront.trace_frame(self.scene, self.raycaster, cam, cfg,
                                    iteration, wavefront.camera_view_proj(cam),
                                    prev_vp, pix=self.pix)
        self.rays = self.mesh.all_reduce(out.rays_traced.reshape(1))[0]
        acc_d = acc_d + out.direct
        acc_i = acc_i + out.indirect
        plane = lambda a: a.reshape(self.rows, w)
        if self.with_svgf:
            p3 = lambda v: v.map(plane)
            g = out.gbuf
            rgb, state, self.window = halo.svgf_rows(
                self.mesh, cfg.svgf, state, p3(out.direct), p3(out.indirect),
                p3(g.albedo), plane(g.depth), p3(g.normal), plane(g.mat_id),
                plane(g.motion_u), plane(g.motion_v))
        else:
            rgb = (acc_d + acc_i).map(plane)
        return rgb, (acc_d, acc_i, state)


def make_sharded_step(scene: SceneData, cam: Camera, cfg: RenderConfig,
                      mesh: PixelMesh, with_svgf: bool = True):
    """(step, init_state, view_proj), as tpt's: step(iteration, prev_vp,
    carry) renders this rank's rows (`ShardedStep`). Refuses what tpt's
    sharded step cannot run: spp_batch other than 1 (tpt sizes its
    G-buffers for a 1-spp pool), image rows the world size does not
    divide, and every option the wavefront refuses."""
    reason = wavefront._unsupported(cfg)
    if reason:
        raise NotImplementedError(f"{reason} is not ported yet")
    if cfg.spp_batch != 1:
        raise ValueError(f"the sharded step renders 1 spp a frame, not "
                         f"spp_batch={cfg.spp_batch}")
    w, h = cam.resolution
    if h % mesh.world:
        raise ValueError(f"the image's {h} rows must divide over the "
                         f"{mesh.world} ranks")
    if scene.device != mesh.device:
        raise ValueError(f"the scene is on {scene.device}, the mesh renders "
                         f"on {mesh.device}")
    replicate(mesh, scene)
    step = ShardedStep(scene, cam, cfg, mesh, with_svgf)
    return step, step.init_state, wavefront.camera_view_proj(cam)


def gather_rows(mesh: PixelMesh, t: torch.Tensor) -> torch.Tensor:
    """Every rank's equal row slab [rows, ...] -> the whole [H, ...] on
    every rank (one all_gather), on the comm device."""
    return torch.cat(mesh.all_gather(t), dim=0)


def render_sharded(scene: SceneData, cam: Camera, cfg: RenderConfig,
                   mesh: Optional[PixelMesh] = None, iterations: int = 1,
                   with_svgf: bool = False) -> np.ndarray:
    """Accumulate `iterations` sharded frames and return the whole
    [H, W, 3] float32 image on every rank: the average without SVGF, the
    last denoised frame with it."""
    mesh = mesh or make_pixel_mesh(device=scene.device)
    w, h = cam.resolution
    step, init_state, vp = make_sharded_step(scene, cam, cfg, mesh,
                                             with_svgf=with_svgf)
    if iterations <= 0:
        return np.zeros((h, w, 3), np.float32)
    carry = init_state()
    for it in range(1, iterations + 1):
        rgb, carry = step(it, vp, carry)
    if not with_svgf:
        rgb = rgb * (1.0 / iterations)
    return gather_rows(mesh, rgb.stacked()).cpu().numpy()
