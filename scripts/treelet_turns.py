"""Times the kernels and frames of several checkouts of this repository
in turns on one card, so that two versions of a kernel source are
compared on the same card in one sitting. Each run is a fresh process,
started in the checkout, that imports that checkout's `tpt_torch`
(building its kernels) and runs this checkout's `chip_smoke.py` phases
on the 1080p fireplace:

- `--phases treelet` (the default): `treelet_kernels` and
  `treelet_render` (`treelet_agreement`, a plain render of a minute or
  more, is skipped); their lines hold the times (K9 on the unsorted
  bounce-1 pool; K10 on the whole sorted bounce-1 pool, on 128 of its
  packets and on the camera rays; the frame);
- `--phases binary`: `binary_kernels`, `binary_render` and
  `mega_render` (`mega_agreement` is skipped); their lines hold K8a on
  the primaries and the bounce-1 pool, K8b on the shadow rays of bounces
  0 and 1 (back to back and one launch between events), K2/K1 on the
  same primaries and shadow rays, the binary wavefront frame and the
  megakernel frames. A checkout whose library reports no arity-2
  attributes (one older than the shared walk) prints no K8a/K8b
  registers;
- `--phases scanmulti`: K11 as `sweepvar_kernels` checks and times it
  (`scanmulti_check`) on the first 2,073,600 lanes of the unsorted
  bounce-1 pool of one bench frame (`sweep_bounce1`): bit-equal to its
  plain version, its slots equal to K3's, its sweep cast equal to K2's,
  its time back to back, its bounds, registers and lane state;
- `--phases svgf`: `svgf_kernels` (`svgf_kernel_check`: K5 at steps
  1..16 one pass a call and, where the tree has it, the frame's passes
  in one call; K6) and `svgf_render` (the denoised frame and its split
  into the trace, K6, K5 x5 and the rest by CUDA events);
  `svgf_agreement` is skipped.

Phases may be joined with commas (`--phases scanmulti,svgf`): each run
then builds its scene once and runs them in that order.

No wide BVH_PALLAS frame is rendered, so no frame is set beside one.

Parent, change, change, parent:

    mkdir -p _archive_check/parent
    git archive PARENT | tar -x -C _archive_check/parent \\
        --exclude=benchmarks/prebuilt
    python scripts/treelet_turns.py --phases binary _archive_check/parent \\
        . . _archive_check/parent
"""

import argparse
import os
import subprocess
import sys

SMOKE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r'''
import importlib.util
import os
import sys
sys.path.insert(0, ".")
import torch
# this checkout's chip_smoke.py, whatever the tree holds
spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(SMOKE_DIR, "chip_smoke.py"))
cs = importlib.util.module_from_spec(spec)
sys.modules["chip_smoke"] = cs
spec.loader.exec_module(cs)
from tpt_torch.bvh import packet_traverse as pt
from tpt_torch.bvh import treelet_traverse as tlt
from tpt_torch.scene import procedural

dev = torch.device("cuda")
pt.build_kernels()
host = procedural.fireplace_like(resolution=cs.RES)
scene = host.build(with_bvh=True, sweep_chunk_align=cs.SWEEP_ALIGN,
                   device=dev)


def run_phases(name):
    if name == "treelet":
        cs.TREELET_PLAIN_RENDER_S = float("inf")   # treelet_agreement refuses
        tlt.build_kernels()
        try:
            cs.treelet_phases(scene, host.camera, dev, None)
        except RuntimeError as e:
            if "treelet_agreement" not in str(e):
                raise
    elif name == "binary":
        try:
            pt.kernel_attributes(False, 2)
        except RuntimeError:
            walk_registers = cs.walk_registers
            cs.walk_registers = lambda arity: (
                "K8a/K8b registers not reported by this tree" if arity == 2
                else walk_registers(arity))
        bscene = host.build(with_bvh=True, packet_arity=2, device=dev)
        _, binary_ms = cs.binary_phases(scene, bscene, host.camera, dev, None)
        cs.mega_phases(scene, bscene, host.camera, dev, None, binary_ms,
                       agreement=False)
    elif name == "scanmulti":
        from tpt_torch.bvh import sweep as sw
        from tpt_torch.config import RayCastBackend, RenderConfig
        sw.build_kernels()
        tlt.build_kernels()
        cfg = RenderConfig(backend=RayCastBackend.BVH_SWEEP, **cs.SWEEP_KNOBS)
        pools = cs.sweep_bounce1(scene, host.camera, cfg, dev)
        cs.scanmulti_check(scene, pools.pop("unsorted"), cfg.sweep_slots,
                           cfg.sweep_unroll, dev)
        del pools
    elif name == "svgf":
        from tpt_torch.denoise import stencil
        stencil.build_kernels()
        cs.svgf_phases(scene, host.camera, dev, agreement=False)
    else:
        raise ValueError(f"no phases {name!r}")


for name in PHASES.split(","):
    run_phases(name)
'''


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="treelet",
                    help="treelet, binary, scanmulti or svgf, or several "
                    "joined by commas")
    ap.add_argument("trees", nargs="+", help="checkouts, run in this order")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    child = (f"SMOKE_DIR = {SMOKE_DIR!r}\nPHASES = {args.phases!r}\n"
             + CHILD)
    for k, tree in enumerate(args.trees):
        print(f"=== run {k + 1}: {tree}", flush=True)
        rc = subprocess.run([sys.executable, "-c", child],
                            cwd=tree).returncode
        if rc:
            print(f"=== run {k + 1} failed: rc {rc}", flush=True)
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
