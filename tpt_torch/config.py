"""One dataclass holding every knob the reference scatters across CLI flags,
JSON fields, and compile-time #defines (SURVEY.md §5 'Config / flag system').

The PyTorch port keeps its own copy of `tpt/config.py` so that it imports
nothing of the JAX package: the same enums and the same `RenderConfig`
fields and defaults. Knobs that tune the TPU kernels (packet groups, pops,
sweep and treelet shapes, pool donation) are accepted and ignored by the
port's CUDA kernels; the port's integrators raise on options their slice
does not implement yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from enum import IntEnum


class RenderMode(IntEnum):
    MEGAKERNEL = 0
    WAVEFRONT = 1


class DisplayMode(IntEnum):
    RESULT = 0
    NORMAL = 1
    DEPTH = 2
    ALBEDO = 3
    MOTION_VECTOR = 4
    BVH_HEATMAP = 5  # traversal-cost temperature map (reference bvh.cu:518-641)


class RayCastBackend(IntEnum):
    """Pluggable ray-cast backend seam (the reference swaps software LBVH for
    OptiX behind one stage interface — SURVEY.md C9/C13). On TPU the seam is
    XLA-while-loop traversal vs. the Pallas traversal kernel, plus brute
    force for tiny scenes/tests."""

    BRUTE_FORCE = 0
    BVH_XLA = 1
    BVH_PALLAS = 2
    # self-rebinning treelet kernel (bvh/pallas_treelet.py): packet-level
    # MIMD over subtrees — per-lane candidate-treelet slots + one shared
    # subtree traversal per round; closest-hit only (any-hit stays on the
    # wide kernel: shadow rays inherit the hit points' coherence)
    BVH_TREELET = 3
    # sweep-cast pipeline (bvh/sweepcast.py): dense AABB scan -> bin sort
    # -> demand-driven dense treelet sweep -> wide-kernel tail on the
    # unresolved minority. Closest-hit only (any-hit stays on the wide
    # kernel: shadow rays inherit the hit points' coherence).
    BVH_SWEEP = 4

    @property
    def is_packet(self) -> bool:
        """Backends built on the Pallas packet kernels (want coherence
        sorting, split-bounce dispatch, and the adaptive pool)."""
        return self in (RayCastBackend.BVH_PALLAS, RayCastBackend.BVH_TREELET,
                        RayCastBackend.BVH_SWEEP)


@dataclass(frozen=True)
class SVGFConfig:
    sigma_z: float = 1.0
    sigma_n: float = 128.0
    sigma_l: float = 4.0
    atrous_iterations: int = 5
    history_threshold: int = 4  # frames of history before temporal variance
    temporal_alpha_min: float = 0.1
    demodulate_threshold: float = 0.01
    # tpt's switches between its Pallas TPU kernels and its XLA
    # formulations of SVGF. They select nothing in the port: the port has
    # one a-trous pass (K5, denoise/stencil.py) and one reprojection (K6,
    # denoise/reproject.py), a CUDA kernel on the card and the plain
    # version on the CPU, and both compute tpt's XLA functions
    # (_atrous_once, _reproject_taps). tpt's Pallas reprojection shifts
    # rows and columns separately and drops history beyond
    # reproject_radius px, because a TPU lane cannot gather; a CUDA thread
    # can, so the port is exact for any motion, and reproject_radius
    # bounds nothing.
    use_pallas_atrous: bool = True
    use_pallas_reproject: bool = True
    reproject_radius: int = 24


@dataclass(frozen=True)
class RenderConfig:
    mode: RenderMode = RenderMode.WAVEFRONT
    backend: RayCastBackend = RayCastBackend.BVH_XLA
    trace_depth: int = 8
    iterations: int = 120  # headless default matches reference main.cpp:213
    denoiser_on: bool = False
    display: DisplayMode = DisplayMode.RESULT
    jitter: bool = True
    gamma: float = 2.2
    epsilon: float = 1e-3
    max_materials: int = 512
    max_textures: int = 512
    svgf: SVGFConfig = field(default_factory=SVGFConfig)
    # TPU knobs
    use_bfloat16_shading: bool = False
    bvh_stack_depth: int = 64
    russian_roulette: bool = False  # reference stub is empty (pathtrace.cu:437)
    rr_start_bounce: int = 3
    # Direct env sampling via the live alias table: ON by default for
    # library AND CLI users (one estimator everywhere — measured 46x
    # variance cut for 1.68x frame cost on the env-lit headline scene,
    # BENCHMARKS §8; a compile-time no-op when the scene has no env
    # map). The reference's sampleEnvironmentMap is dead code, so
    # reference behavior = off — use RenderConfig.reference_parity()
    # for bit-parity studies/tests.
    env_nee: bool = True
    # samples per pixel traced per wavefront dispatch: the path pool holds
    # spp_batch jittered samples of every pixel, so the per-bounce
    # coherence sort sees an spp_batch-x richer pool and packets bin
    # tighter (smaller node-visit unions) at the SAME per-path sort cost.
    # The frame fn consumes spp_batch iteration numbers per call and
    # returns per-pixel SUMS over the batch.
    spp_batch: int = 1
    # sort bounce rays by (origin cell, direction octant) before traversal:
    # restores packet coherence for the Pallas backend (incoherent packets
    # measured ~20x slower than coherent on v5e)
    sort_bounce_rays: bool = True
    # coherence-key layout: "dir_major" (direction cone on top — packets
    # traverse beams) or "cell_major" (origin locale on top)
    sort_key: str = "dir_major"
    # pool-sort cadence (BVH_PALLAS split mode): sort bounces 1, 1+k,
    # 1+2k, ...; skipped bounces reuse the stale order (lanes never move
    # without a sort, so the adaptive-pool dense-prefix invariant holds
    # with the last sorted bound). The multi-operand sort is a fixed
    # ~220 ms/2M-lane per-bounce cost (BENCHMARKS §6) — this trades it
    # against packet-coherence decay; per-pixel radiance unchanged to
    # 1 ulp (different XLA programs fuse different FMA chains).
    # Seeding backends (BVH_SWEEP/BVH_TREELET) need fresh bins and
    # ignore it.
    sort_every: int = 1
    # shrink the dispatched path pool as paths die (split mode): the
    # compacting sort leaves live paths in a dense prefix; the host reads
    # one alive-count scalar per bounce and picks a static prefix variant
    adaptive_pool: bool = True
    # wide-kernel traversal shape (swept on v5e, benchmarks/traversal.py):
    # group = 1024-ray packets sharing one stack (bounce rays want small
    # groups — the visit-union of an 8x group is barely smaller than 8
    # separate unions, so dense work per visit dominates; coherent
    # primaries want large groups). pops = stack entries drained per loop
    # iteration (latency hiding).
    trav_group: int = 2
    trav_group_primary: int = 4
    trav_node_pops: int = 4
    trav_cluster_pops: int = 4
    # treelet kernel knobs (BVH_TREELET): candidate slots per lane, and a
    # round-count safety cap (hits = missing intersections; the
    # brute-force agreement tests guard it)
    treelet_slots: int = 4
    treelet_max_rounds: int = 4096
    # hybrid cast: rays whose phase-1 candidate count reaches
    # treelet_hard_count (grazing/multi-treelet rays) are partitioned to
    # the tail by the sort and traced by the wide whole-tree kernel in
    # their own dense packets (whole-tree union cost is per-packet, so
    # shrinking the hard pool shrinks it linearly); easy rays resolve in
    # 1-2 shared treelet drains
    treelet_hybrid: bool = True
    treelet_hard_count: int = 3
    # sweep-cast knobs (BVH_SWEEP): candidate slots per lane and the
    # sweep kernel flavor — "sublane" (8 tris x 128 rays per VPU op) or
    # "lane" (1 tri x 1024 rays); results are identical (tests)
    sweep_slots: int = 4
    sweep_kernel: str = "sublane"
    # bin-sort key width: 2 = one int32 key (slot1, slot0, octant);
    # 3 = two keys ((slot1, slot0), (slot2, octant)) — blocks agree on
    # their third candidate too, shrinking the demand sweep's ordinal
    # union for one extra sort operand (results identical; perf A/B)
    sweep_key_slots: int = 2
    # chunks Möller–Trumbore'd per fori iteration in the sublane sweep
    # kernel (must divide the scene's sweep-table chunk_align —
    # host.build(sweep_chunk_align=...)); >= the table's max_chunks takes
    # a static one-trip path with no inner loop
    sweep_unroll: int = 4
    # tail-prefix compaction: "scatter" (cumsum + one int32 scatter +
    # P-row gathers) or "sort" (9-operand full-pool lax.sort; A/B knob)
    sweep_tail_compact: str = "scatter"
    # group-window culling in the sublane sweep kernel: slab-test each
    # treelet's 8 group sub-AABBs (SweepTables.group_boxes) per 128-ray
    # block and trim the dense MT range to the [first, last] hit groups.
    # Results identical (tests); default off until the TPU A/B lands.
    # The port's K4 runs tpt's window where tpt does; without it K4 and
    # K7 test every row of the union, as tpt's kernels do
    sweep_groups: bool = False
    # split-mode seed-sort shape (the TPU backend compiler has an operand
    # cliff: 20-operand pool sorts compile in ~6 min, 31-operand never
    # finish at 1080p pool sizes — BENCHMARKS §4d):
    #   "packed" — ONE sort carrying the candidate planes compressed to 4
    #     extra operands (slots 0/1 re-derived from the bin key, the rest
    #     packed small-int / truncated-bf16 — sweepcast.pack_seed); one
    #     dense scan per bounce. Exact (the bf16 truncation only widens
    #     the kernel's demand mask).
    #   "lean" — the 20-operand sort with NO slot planes; the planes are
    #     regenerated by re-running the dense scan on the sorted pool
    #     (two scans per bounce; the round-3 headline shape).
    #   "wide" — all 9 slot planes ride the sort (31 operands; CPU/tests
    #     only — never finishes the TPU compile at benchmark scale).
    sweep_seed_mode: str = "packed"
    # two-phase cascade sweep (sweepcast.cascade_phase1/2): phase 1
    # sweeps only the key-coherent slots 0-1, the unresolved minority is
    # compacted + re-sorted by (slot3, slot2, octant) in its OWN
    # dispatch, and phase 2 sweeps the rest slots block-coherently —
    # the union-width attack on the 14-19-treelet block unions the
    # one-shot demand sweep pays (BENCHMARKS §4d). Results identical
    # (tests); split-dispatch mode only (the fused shape would hit the
    # sort-fusion compile cliff).
    sweep_cascade: bool = False
    # phase-2 prefix as a fraction of the pool (static shape; overflow
    # lanes fall to the wide tail's full-pool fallback — keep comfortably
    # above the measured phase-1 unresolved fraction)
    sweep_cascade_frac: float = 0.5
    # route shadow (any-hit) rays through the sweep pipeline too
    # (sweepcast.sweep_any_hit: scan + demand sweep in pool order + wide
    # any-hit tail) instead of the wide packet any-hit kernel. Default
    # off until the TPU A/B lands (shadow casts are ~15% of frame casts)
    sweep_shadow: bool = False
    # split the seeded rest-bounce program into TWO dispatches — the
    # extension cast (sweep + wide tail -> HitRecord) and the
    # logic/shade/shadow program — instead of one fused 2.3-2.4 s
    # program. ~4 ms of extra dispatch; gives the frame a per-stage
    # timing seam (VERDICT r4 item 2: "split logic/shade/shadow out of
    # the bounce dispatch and time the pieces"). Bit-identical to the
    # fused program (tests/test_wavefront.py pins it); packed seed mode
    # only — other seed modes ignore it.
    split_shade: bool = False
    # route bounce-0 (primary) rays through the dense-sweep path: a
    # dense scan on the RASTER-ORDER pool (no sort — G-buffers need
    # pixel order, and raster rays are already the sweep's best case:
    # 128 consecutive pixels agree on their treelets) + the seeded
    # sweep cast, instead of the wide packet kernel that costs
    # 1.6 s/frame at the headline shape (CEILING §4 move (c)).
    sweep_primary: bool = False
    # TIMING DIAGNOSTIC ONLY: skip the NEE shadow any-hit dispatch (treat
    # every light sample as visible). Biases the direct channel bright —
    # never a production mode; exists so sweep_breakdown can isolate the
    # shadow cast's share of the fused bounce program (RNG consumption is
    # unchanged, so paths/extension casts stay identical)
    debug_no_shadow: bool = False
    # two-pass extension cast: first cast with t_max = frac * world
    # diagonal (a bounded per-lane limit collapses the packet's node-visit
    # union — far subtrees fail the slab test for every lane), then
    # re-cast only the misses unbounded. 0 disables. Interiors hit mostly
    # nearby geometry, so pass 2 runs with most lanes dead.
    nearfield_frac: float = 0.0
    # donate the path-pool carry (and seed keys/planes) into the split
    # per-bounce dispatches: XLA aliases the input buffers into the
    # outputs, cutting the frame's HBM peak by roughly one pool copy per
    # live dispatch (~1-2 GB at 1080p spp 4-6) — the capacity lever for
    # spp_batch > 4. The pool is threaded linearly through the frame
    # loop so donation is sound there; OFF by default because tools that
    # re-dispatch a saved carry (benchmarks/sweep_breakdown.py's timing
    # reps) would hit invalidated buffers.
    donate_pool: bool = False
    # synthetic shading cost for the megakernel-vs-wavefront stress study
    # (reference keeps it as commented code — interactions.cu:255-321)
    heavy_shading_iters: int = 0
    # megakernel pixel-tile size per dispatch: one fused whole-path program
    # per tile keeps each TPU program under the device watchdog at
    # benchmark scale (one 2M-path program was killed — BENCHMARKS.md §2).
    # The port runs a frame in one pass, which gives the same image (a
    # pixel's path does not depend on the other lanes), so the tile
    # selects nothing: on the H100 tpt's 8 tiles of a 1080p frame made it
    # 7.8x slower, each tile launching a whole frame's small kernels
    # (PERF.md §6, PR 8).
    megakernel_tile: int = 1 << 18

    def with_(self, **kw) -> "RenderConfig":
        return replace(self, **kw)

    @classmethod
    def tpu_native(cls, **kw) -> "RenderConfig":
        """Best-throughput TPU preset: the measured-fastest backend and
        pool shape (BENCHMARKS §1) plus Russian roulette — the one
        estimator-level lever the ceiling analysis names
        (docs/CEILING_v5e.md §2b); the reference's RR stub is empty
        (pathtrace.cu:437-438) so this is beyond-parity, published as
        its own BENCHMARKS row next to the parity headline."""
        kw.setdefault("backend", RayCastBackend.BVH_SWEEP)
        kw.setdefault("spp_batch", 4)
        kw.setdefault("russian_roulette", True)
        kw.setdefault("rr_start_bounce", 3)
        # RR kills lanes, so the adaptive-pool ladder ENGAGES — and every
        # rung is its own cold-compile of the full bounce-program set
        # (five bench timeouts across rounds 3-5 before this was pinned).
        # Measured row (BENCHMARKS §1: 0.6232 Mpaths/s, 1.37x parity) is
        # ladder-off; flip it back on only with pre-warmed rung programs.
        kw.setdefault("adaptive_pool", False)
        return cls(**kw)

    @classmethod
    def reference_parity(cls, **kw) -> "RenderConfig":
        """Estimator-parity preset: every knob that changes the MONTE
        CARLO ESTIMATOR (not just its schedule) pinned to the reference's
        effective behavior — env NEE off (their sampleEnvironmentMap is
        dead code, logic.cu:76-103), Russian roulette off (their RR stub
        is empty, pathtrace.cu:437-438). Parity/golden tests build on
        this; production defaults keep the better estimator."""
        kw.setdefault("env_nee", False)
        kw.setdefault("russian_roulette", False)
        return cls(**kw)
