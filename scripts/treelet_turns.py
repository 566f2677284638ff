"""Times the BVH_TREELET kernels (K9, K10) and frame of several checkouts
of this repository in turns on one card, so that two versions of
`tpt_torch/csrc/treelet.cu` are compared within one machine session.
Each run is a fresh process, started in the checkout, that builds that
checkout's K2 and treelet kernels and runs its own `chip_smoke.py`'s
`treelet_kernels` and `treelet_render` phases on the 1080p fireplace
(`treelet_agreement`, a plain render of a minute or more, is skipped);
their lines hold the times (K9 on the unsorted bounce-1 pool; K10 on the
whole sorted bounce-1 pool, on 128 of its packets and on the camera rays;
the frame). Parent, change, change, parent:

    mkdir -p _archive_check/parent
    git archive PARENT | tar -x -C _archive_check/parent \\
        --exclude=benchmarks/prebuilt
    python scripts/treelet_turns.py _archive_check/parent . . \\
        _archive_check/parent
"""

import subprocess
import sys

CHILD = r'''
import sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from tpt_torch.bvh import packet_traverse as pt
from tpt_torch.bvh import treelet_traverse as tlt
from tpt_torch.scene import procedural

cs.TREELET_PLAIN_RENDER_S = float("inf")   # treelet_agreement refuses
dev = torch.device("cuda")
pt.build_kernels()
tlt.build_kernels()
host = procedural.fireplace_like(resolution=cs.RES)
scene = host.build(with_bvh=True, sweep_chunk_align=cs.SWEEP_ALIGN,
                   device=dev)
try:
    cs.treelet_phases(scene, host.camera, dev, 1.0)
except RuntimeError as e:
    if "treelet_agreement" not in str(e):
        raise
'''


def main() -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    for k, tree in enumerate(sys.argv[1:]):
        print(f"=== run {k + 1}: {tree}", flush=True)
        rc = subprocess.run([sys.executable, "-c", CHILD], cwd=tree).returncode
        if rc:
            print(f"=== run {k + 1} failed: rc {rc}", flush=True)
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
