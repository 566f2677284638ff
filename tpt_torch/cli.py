"""Command-line renderer, the counterpart of `tpt/cli.py` with its flags
and defaults:

    python -m tpt_torch.cli SCENE.json [-mega|-wave] [-vis] [-tui]
        [--backend brute|bvh|pallas|treelet|sweep|auto] [--denoise] ...

Headless it renders the scene's ITERATIONS, mirrors x as the reference's
saveImage does, gamma-corrects at 2.2 and writes a timestamped PNG.
`-vis` writes a preview PNG every --preview-every frames, `-tui` runs the
terminal viewer. The port runs on the CUDA card; `--device cpu` runs
the plain PyTorch versions on the CPU instead (there is no silent
fallback).
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpt_torch", description="path tracer (tpt's PyTorch/CUDA port)")
    p.add_argument("scene", help="scene JSON file (reference schema)")
    p.add_argument("-mega", action="store_true", help="megakernel engine")
    p.add_argument("-wave", action="store_true", help="wavefront engine (default)")
    p.add_argument("-vis", action="store_true",
                   help="progressive preview: write preview PNG every --preview-every frames")
    p.add_argument("-tui", action="store_true",
                   help="live terminal viewer (ANSI truecolor, FPS keys; "
                        "see tpt_torch/term_viewer.py)")
    p.add_argument("--iterations", type=int, default=None,
                   help="override scene ITERATIONS")
    p.add_argument("--depth", type=int, default=None, help="override trace depth")
    p.add_argument("--backend",
                   choices=["brute", "bvh", "pallas", "treelet", "sweep",
                            "auto"],
                   default="auto", help="ray-cast backend")
    p.add_argument("--denoise", action="store_true", help="SVGF real-time mode")
    p.add_argument("--env-nee", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="direct environment sampling via the alias table "
                        "(skipped when the scene has no env map)")
    p.add_argument("--warmup", action="store_true",
                   help="build the CUDA kernels and the scene's tables "
                        "(prep cache) for this scene/config, run two "
                        "frames and exit without writing an image")
    p.add_argument("--out-dir", default=".", help="output directory")
    p.add_argument("--preview-every", type=int, default=10)
    p.add_argument("--display", choices=["result", "normal", "depth", "albedo", "motion"],
                   default="result")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs "
                        "the plain PyTorch versions)")
    return p


def build_kernels() -> None:
    """Compile every CUDA library of the port (nvcc, side by side)."""
    from concurrent.futures import ThreadPoolExecutor

    from .bvh import packet_traverse, sweep, treelet_traverse
    from .denoise import stencil

    mods = (packet_traverse, sweep, treelet_traverse, stencil)
    with ThreadPoolExecutor(len(mods)) as pool:
        for f in [pool.submit(m.build_kernels) for m in mods]:
            f.result()


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)

    from .config import DisplayMode, RayCastBackend, RenderConfig, RenderMode
    from .device import resolve_device
    from .engine import Renderer
    from .io.image import save_png, timestamped_name
    from .scene.loader import load_scene

    dev = resolve_device(args.device)
    print(f"[tpt] loading scene {args.scene}")
    t0 = time.time()
    host = load_scene(args.scene)
    mode = RenderMode.MEGAKERNEL if args.mega else RenderMode.WAVEFRONT

    if args.backend == "auto":
        backend = (RayCastBackend.BRUTE_FORCE if host.mesh.num_triangles < 4096
                   else RayCastBackend.BVH_PALLAS)
    else:
        backend = {"brute": RayCastBackend.BRUTE_FORCE,
                   "bvh": RayCastBackend.BVH_XLA,
                   "pallas": RayCastBackend.BVH_PALLAS,
                   "treelet": RayCastBackend.BVH_TREELET,
                   "sweep": RayCastBackend.BVH_SWEEP}[args.backend]

    cfg = RenderConfig(
        mode=mode,
        backend=backend,
        trace_depth=args.depth if args.depth else host.trace_depth,
        iterations=args.iterations if args.iterations else host.iterations,
        denoiser_on=args.denoise,
        env_nee=args.env_nee,
        display={"result": DisplayMode.RESULT, "normal": DisplayMode.NORMAL,
                 "depth": DisplayMode.DEPTH, "albedo": DisplayMode.ALBEDO,
                 "motion": DisplayMode.MOTION_VECTOR}[args.display],
    )
    with_bvh = backend != RayCastBackend.BRUTE_FORCE
    data = host.build(with_bvh=with_bvh, device=dev)
    print(f"[tpt] scene ready: {host.mesh.num_triangles} tris, "
          f"{len(host.materials)} materials, engine={mode.name}, "
          f"backend={backend.name}, device={dev} ({time.time() - t0:.1f}s)")
    if with_bvh:
        from .bvh.validate import validate_lbvh

        rep = validate_lbvh(data.bvh)
        status = "Pass" if rep.ok else f"FAIL: {rep.errors[:3]}"
        print(f"[tpt] LBVH: {rep.num_leaves} leaves, depth {rep.max_depth} [{status}]")

    renderer = Renderer(data, host.camera, cfg)
    os.makedirs(args.out_dir, exist_ok=True)

    if args.warmup:
        # the CUDA libraries are built on first use; build them all now,
        # then run a frame and a second, steady one
        t0 = time.time()
        if dev.type == "cuda":
            build_kernels()
        renderer.frame()
        print(f"[tpt] warmup: kernel build+first-frame {time.time() - t0:.1f}s")
        t0 = time.time()
        renderer.frame()
        print(f"[tpt] warmup: steady frame {time.time() - t0:.1f}s — "
              f"cache populated; production runs start warm")
        return 0

    if args.tui:
        from .term_viewer import run_term_viewer

        run_term_viewer(renderer, max_frames=cfg.iterations,
                        out_dir=args.out_dir)
        name = timestamped_name(host.image_name, cfg.iterations)
        out_path = os.path.join(args.out_dir, name)
        save_png(out_path, renderer.frame()[:, ::-1], gamma=cfg.gamma)
        print(f"[tpt] saved {out_path}")
        return 0

    img = None
    t0 = time.time()
    for it in range(1, cfg.iterations + 1):
        img = renderer.frame()
        if it == 1 or it % 10 == 0 or it == cfg.iterations:
            elapsed = time.time() - t0
            print(f"[tpt] iter {it}/{cfg.iterations}  "
                  f"{renderer.gui.frame_ms:.1f} ms/frame  "
                  f"{renderer.gui.mrays_per_sec:.2f} MRays/s  "
                  f"({elapsed:.1f}s total)")
        if args.vis and it % args.preview_every == 0:
            save_png(os.path.join(args.out_dir, f"{host.image_name}.preview.png"),
                     img[:, ::-1], gamma=cfg.gamma)

    # final save: mirror x like the reference saveImage
    name = timestamped_name(host.image_name, cfg.iterations)
    out_path = os.path.join(args.out_dir, name)
    save_png(out_path, img[:, ::-1], gamma=cfg.gamma)
    print(f"[tpt] saved {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
