"""tpt_torch's CUDA kernels (K2 closest hit and K1 any hit, K3 dense
scan, K4 demand sweep with its any-hit and group modes, K7 lane sweep,
both on flat groups at coordinate 0, K5 a-trous stencil, K6 temporal
reprojection, K9 treelet scan, K10 treelet closest hit, K11 multi-slot
scan, K8a/K8b binary closest and any hit, K8b with lane refill) on the
card, each against its plain PyTorch version, and the
megakernel and the sweep variants on the card against the CPU; the hero
scene's textured, env-lit casts and renders through the kernels against
the plain versions and against the CPU.

Every test here needs a CUDA device and skips without one. The file
imports neither JAX nor tpt, so it also runs on a GPU machine without
them — there, skip the repository's JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

from tpt_torch.bvh import packet_traverse as pt
from tpt_torch.bvh import sweep as sw
from tpt_torch.bvh import sweepcast as tsc
from tpt_torch.bvh import treelet_traverse as tlt
from tpt_torch.bvh.treelet import SweepTables
from tpt_torch import Renderer
from tpt_torch.config import RayCastBackend, RenderConfig, RenderMode
from tpt_torch.core.vec import Vec3
from tpt_torch.denoise import reproject, stencil, svgf
from tpt_torch.integrators import common, intersect, megakernel, wavefront
from tpt_torch.scene import procedural
from torch_treelet_pools import tie_pool

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def cornell(cuda):
    host = procedural.cornell_box(resolution=(32, 32))
    return host, host.build(with_bvh=True, device=cuda)


def _rays(n, lo, hi, seed, device):
    rs = np.random.default_rng(seed)
    ori = rs.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    v = lambda a: Vec3.from_stacked(torch.from_numpy(a).to(device))
    return v(ori), v(d)


def test_closest_hit_kernel_equals_plain(cornell, cuda):
    _, data = cornell
    o, d = _rays(8192, [0, 0, 0], [556, 548, 560], 11, cuda)
    t_max = torch.full((8192,), intersect.FLT_MAX, device=cuda)
    t_max[::9] = -1.0
    before = pt.LAUNCHES["packet_closest_hit_wide"]
    got, cap_k = pt.packet_closest_hit_wide(data.pack, o, d, t_max)
    assert pt.LAUNCHES["packet_closest_hit_wide"] == before + 1
    want, cap_p = pt.closest_hit_wide_plain(data.pack, o, d, t_max)
    for a, b in ((got.t, want.t), (got.tri, want.tri), (got.u, want.u),
                 (got.v, want.v)):
        assert torch.equal(a, b)
    assert int(cap_k) == 0 and int(cap_p) == 0
    assert bool((got.tri[::9] == -1).all())


def test_any_hit_kernel_equals_plain(cornell, cuda):
    _, data = cornell
    o, d = _rays(8192, [0, 0, 0], [556, 548, 560], 12, cuda)
    t_max = torch.rand(8192, generator=torch.Generator().manual_seed(1)).to(cuda) * 600
    t_max[::7] = -1.0
    before = pt.LAUNCHES["packet_any_hit_wide"]
    got, cap_k = pt.packet_any_hit_wide(data.pack, o, d, t_max)
    assert pt.LAUNCHES["packet_any_hit_wide"] == before + 1
    want, cap_p = pt.any_hit_wide_plain(data.pack, o, d, t_max)
    assert torch.equal(got, want)
    assert bool(got[::7].all())
    assert int(cap_k) == 0 and int(cap_p) == 0


def test_kernel_matches_brute_force(cornell, cuda):
    _, data = cornell
    o, d = _rays(4096, [0, 0, 0], [556, 548, 560], 13, cuda)
    got, _ = pt.packet_closest_hit_wide(
        data.pack, o, d, torch.full((4096,), intersect.FLT_MAX, device=cuda))
    want = intersect.brute_force_closest_hit(data.mesh, o, d)
    hit = want.tri >= 0
    assert torch.equal(got.tri >= 0, hit)
    assert torch.equal(got.tri[hit], want.tri[hit])
    torch.testing.assert_close(got.t[hit], want.t[hit], rtol=1e-4, atol=0)


def test_nan_rays_miss_in_kernel(cornell, cuda):
    _, data = cornell
    o, d = _rays(4, [200, 200, 200], [300, 300, 300], 14, cuda)
    d.y[0] = float("nan")
    o.z[1] = float("nan")
    t_max = torch.tensor([1e4, 1e4, float("nan"), 1e4], device=cuda)
    hit, cap = pt.packet_closest_hit_wide(data.pack, o, d, t_max)
    assert hit.tri.tolist()[:3] == [-1, -1, -1] and int(hit.tri[3]) >= 0
    occ, _ = pt.packet_any_hit_wide(data.pack, o, d, t_max)
    assert occ.tolist()[:3] == [False, False, False]
    assert int(cap) == 0


@pytest.mark.parametrize("kind", ["closest", "any"])
def test_cyclic_table_is_capped_not_hung(cornell, cuda, kind):
    """A root that lists itself as its children overflows the stack and
    never empties it; the kernel's step cap ends every ray and counts it."""
    _, data = cornell
    child = data.pack.node_child.clone()
    child[0, :4] = 0
    bad = replace(data.pack, node_child=child)
    o, d = _rays(256, [270, 270, 270], [280, 280, 280], 15, cuda)
    t_max = torch.full((256,), 1e4, device=cuda)
    fn = pt.packet_closest_hit_wide if kind == "closest" else pt.packet_any_hit_wide
    _, cap = fn(bad, o, d, t_max)
    torch.cuda.synchronize()
    assert int(cap) == 256


def test_wrapper_rejects_mixed_devices(cornell, cuda):
    host, data = cornell
    o, d = _rays(8, [0, 0, 0], [1, 1, 1], 16, cuda)
    cpu_pack = data.pack.to("cpu")
    with pytest.raises(ValueError, match="pack tables"):
        pt.packet_closest_hit_wide(cpu_pack, o, d, torch.ones(8, device=cuda))


def test_render_on_card_matches_cpu(cornell, cuda):
    """The whole wavefront on the card (kernels) against the CPU (plain
    versions): PyTorch's CUDA and CPU math differ in the last bits, so
    the images are held to the golden-image tolerance."""
    host, data = cornell
    cfg = RenderConfig(backend=RayCastBackend.BVH_PALLAS, trace_depth=3)
    rc = common.make_raycaster(data, cfg)
    gpu = wavefront.render(data, host.camera, cfg, iterations=2, raycaster=rc)
    cpu = wavefront.render(host.build(with_bvh=True, device="cpu"),
                           host.camera, cfg, iterations=2)
    assert int(rc.capped) == 0
    assert np.isclose(gpu, cpu, atol=5e-3, rtol=1e-3).mean() > 0.97
    np.testing.assert_allclose(gpu.mean(), cpu.mean(), rtol=0.02)


# ---------------------------------------------------------------------------
# K2/K1's while-while walk on harder sets
# ---------------------------------------------------------------------------

def _walk_cases(data, cuda):
    """(label, o, d, t_max) sets on Cornell: random rays with dead lanes
    (n not a multiple of a block or a warp), short segments, NaN and
    infinite rays and t_max."""
    o, d = _rays(8191, [0, 0, 0], [556, 548, 560], 51, cuda)
    t_max = torch.full((8191,), intersect.FLT_MAX, device=cuda)
    t_max[::9] = -1.0
    t_max[100:400] = torch.linspace(1.0, 300.0, 300, device=cuda)
    o.x[3], d.y[4], o.z[5], d.x[6] = (float("nan"), float("nan"),
                                      float("inf"), float("inf"))
    t_max[7], t_max[8] = float("nan"), float("inf")
    o2, d2 = _rays(4097, [200, 200, 200], [300, 300, 300], 52, cuda)
    t2 = torch.rand(4097, generator=torch.Generator().manual_seed(53)).to(
        cuda) * 600
    return [("random", o, d, t_max), ("short", o2, d2, t2)]


def _wide_walks_equal_plain(pack, cases):
    for label, o, d, t_max in cases:
        want, cap_p = pt.closest_hit_wide_plain(pack, o, d, t_max)
        occ_p, cap_pa = pt.any_hit_wide_plain(pack, o, d, t_max)
        assert int(cap_p) == 0 and int(cap_pa) == 0
        got, cap = pt.packet_closest_hit_wide(pack, o, d, t_max)
        _bits_equal_hits(got, want)
        occ, cap_a = pt.packet_any_hit_wide(pack, o, d, t_max)
        assert torch.equal(occ, occ_p), label
        assert int(cap) == 0 and int(cap_a) == 0, label
        assert bool((want.tri >= 0).any()) and bool(occ_p.any())


@pytest.mark.parametrize("arity", [4, 8])
def test_wide_walks_equal_plain(cuda, arity):
    """K2 and K1, bit for bit, on Cornell's wide pack of arity 4 and 8,
    whose clusters hold up to 16 triangles."""
    host = procedural.cornell_box(resolution=(32, 32))
    data = host.build(with_bvh=True, packet_arity=arity, device=cuda)
    v = -(data.pack.node_child[:, :arity].long() + 1)
    assert int((v & 255)[data.pack.node_child[:, :arity] < -1].max()) > arity
    _wide_walks_equal_plain(data.pack, _walk_cases(data, cuda))


def test_wide_walks_on_equal_t_ties(cuda):
    """The two flat triangles of torch_flatgroup as one cluster of a wide
    pack, with rays at their shared edge: many hit both at the same t, and
    K2 names the first, as the serial strict-< scan."""
    import torch_flatgroup as fg

    for arity in (4, 8):
        pack = fg.flat_pack(cuda, arity)
        o, d, t_max, _, _ = fg.edge_pool(4096, 3, cuda)
        want, _ = pt.closest_hit_wide_plain(pack, o, d, t_max)
        got, cap = pt.packet_closest_hit_wide(pack, o, d, t_max)
        _bits_equal_hits(got, want)
        assert int(cap) == 0
        assert bool((want.tri == 0).any()) and bool((want.tri == 1).any())


def test_wide_walk_registers(cuda):
    """K2 and K1 are built for both arities; neither spills its registers
    to local memory beyond the per-thread stack."""
    for any_hit in (False, True):
        for arity in (4, 8):
            a = pt.kernel_attributes(any_hit, arity)
            assert 0 < a["regs"] <= 255 and a["max_threads"] >= 128
            assert a["local_bytes"] <= 4 * (pt.STACK_DEPTH - 1) + 16, (
                arity, a)


# ---------------------------------------------------------------------------
# K3 dense scan and K4 demand sweep
# ---------------------------------------------------------------------------

def _synthetic_tables(T, seed, device, max_chunks=40):
    """T treelets of 1..max_chunks 8-row chunks of random triangles around
    random centres (chunk_align 1, so unroll 1), a zero pad row at each
    treelet's end, ids = row + 1000. T = 1100 spans two of K3's
    1024-box tiles and treelets of up to 320 rows span two of K4's
    256-row tiles."""
    rs = np.random.default_rng(seed)
    chunks = rs.integers(1, max_chunks + 1, T)
    chunks[0] = max_chunks
    start = np.concatenate([[0], np.cumsum(chunks * 8)[:-1]])
    tri = np.zeros((int(chunks.sum()) * 8, 16), np.float32)
    boxes = np.zeros((T, 8), np.float32)
    for t in range(T):
        r0, r1 = int(start[t]), int(start[t] + chunks[t] * 8) - 1
        c = rs.uniform(-10, 10, 3)
        v0 = c + rs.normal(scale=1.0, size=(r1 - r0, 3))
        e1 = rs.normal(scale=0.7, size=(r1 - r0, 3))
        e2 = rs.normal(scale=0.7, size=(r1 - r0, 3))
        tri[r0:r1, 0:3], tri[r0:r1, 3:6], tri[r0:r1, 6:9] = v0, e1, e2
        tri[r0:r1, 9] = np.arange(r0, r1) + 1000
        verts = np.concatenate([v0, v0 + e1, v0 + e2])
        boxes[t, 0:3], boxes[t, 3:6] = verts.min(0), verts.max(0)
    dev = lambda a: torch.from_numpy(a).to(device)
    return SweepTables(tri_f32=dev(tri),
                       ranges=dev(np.stack([start, chunks], 1).astype(np.int32)),
                       boxes=dev(boxes), num_treelets=T,
                       max_chunks=int(chunks.max()), unroll=8, chunk_align=1)


def _adversarial_pool(n, device, seed):
    """Random rays in and around the tables' volume, with NaN and infinite
    origins, directions and t_max, +-0 direction components, short and
    dead t_max, and one whole dead 128-lane block."""
    o, d = _rays(n, [-12, -12, -12], [12, 12, 12], seed, device)
    t_max = torch.full((n,), 3.4e38, device=device)
    o.x[3], d.y[4], o.z[5] = float("nan"), float("nan"), float("inf")
    d.x[6], d.y[6], d.z[6] = 0.0, -0.0, 1.0
    d.x[7], d.y[7], d.z[7] = -0.0, -0.0, -1.0
    d.x[8] = float("inf")
    t_max[9], t_max[10], t_max[11] = float("nan"), 0.0, float("inf")
    t_max[12:20] = 2.0
    t_max[::11] = -1.0
    t_max[256:384] = -1.0
    return o, d, t_max


@pytest.fixture(scope="module")
def tables(cuda):
    return _synthetic_tables(1100, 21, cuda)


@pytest.mark.parametrize("S", [2, 4])
def test_dense_scan_kernel_equals_plain(tables, cuda, S):
    o, d, t_max = _adversarial_pool(4000, cuda, 22)
    before = sw.LAUNCHES["dense_scan"]
    stats = torch.zeros(1, dtype=torch.int64, device=cuda)
    got = sw.dense_scan(tables, o, d, t_max, slots=S, stats=stats)
    assert sw.LAUNCHES["dense_scan"] == before + 1
    want = sw.dense_scan_plain(tables, o, d, t_max, slots=S)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    live = int((t_max > 0).sum())
    assert int(stats[0]) == live * tables.num_treelets
    assert bool((got[1][:, 256:384] == sw.NONE_ORD).all())
    assert bool((got[1][0] != sw.NONE_ORD).any() and (got[2] < 3e38).any())


@pytest.mark.parametrize("S", [2, 4])
def test_sweep8_kernel_equals_plain(tables, cuda, S):
    """K4 on the bin-sorted pool of the scan's planes, with block 0's 128
    lanes demanding 128 different treelets first."""
    o, d, t_max = _adversarial_pool(4000, cuda, 23)
    s_t, s_o, thr = sw.dense_scan(tables, o, d, t_max, slots=S)
    key = tsc.bin_key(s_o, d, tables.num_treelets, S)
    perm = tsc.bin_sort_perm([torch.where(t_max > 0, key, 1 << 30)])
    g = lambda a: a[perm].contiguous()
    o, d = Vec3(g(o.x), g(o.y), g(o.z)), Vec3(g(d.x), g(d.y), g(d.z))
    t_max, s_o, s_t = g(t_max), s_o[:, perm].contiguous(), s_t[:, perm].contiguous()
    t_max[:128] = 3.4e38
    s_o[0, :128] = torch.arange(128, device=cuda, dtype=torch.int32) * 8
    s_t[0, :128] = 0.0
    stats = torch.zeros(3, dtype=torch.int64, device=cuda)
    before = sw.LAUNCHES["sweep8_closest_hit"]
    got = sw.sweep8_closest_hit(tables, o, d, t_max, s_o, s_t, unroll=1,
                                stats=stats)
    assert sw.LAUNCHES["sweep8_closest_hit"] == before + 1
    want = sw.sweep8_closest_hit_plain(tables, o, d, t_max, s_o, s_t, unroll=1)
    for f in ("t", "tri", "u", "v"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert int(stats[0]) >= 128 and int(stats[2]) == int((t_max > 0).sum())
    assert bool((got.tri[~(t_max > 0)] == -1).all())
    assert float((got.tri[:128] >= 0).float().mean()) > 0.2


def _plain_kernels(monkeypatch):
    """Route every cast of the BVH_SWEEP path to the plain versions (they
    are looked up through their modules at call time)."""
    monkeypatch.setattr(sw, "dense_scan", sw.dense_scan_plain)
    monkeypatch.setattr(sw, "sweep8_closest_hit", sw.sweep8_closest_hit_plain)
    monkeypatch.setattr(sw, "sweep_closest_hit", sw.sweep_closest_hit_plain)
    monkeypatch.setattr(pt, "packet_closest_hit_wide", pt.closest_hit_wide_plain)
    monkeypatch.setattr(pt, "packet_any_hit_wide", pt.any_hit_wide_plain)


def test_sweep_render_kernels_equal_plain(cornell, cuda, monkeypatch):
    """A BVH_SWEEP render through K1-K4 equals the same render through
    their plain versions on the card, bit for bit."""
    host, data = cornell
    cfg = RenderConfig(backend=RayCastBackend.BVH_SWEEP, trace_depth=3)
    rc = common.make_raycaster(data, cfg)
    before = dict(sw.LAUNCHES)
    img_k = wavefront.render(data, host.camera, cfg, iterations=2, raycaster=rc)
    main = ("dense_scan", "sweep8_closest_hit")
    want = {k: before[k] + 4 * (k in main) for k in before}
    assert sw.LAUNCHES == want
    _plain_kernels(monkeypatch)
    rc_p = common.make_raycaster(data, cfg)
    img_p = wavefront.render(data, host.camera, cfg, iterations=2,
                             raycaster=rc_p)
    assert sw.LAUNCHES == want
    assert int(rc.capped) == 0 and int(rc_p.capped) == 0
    np.testing.assert_array_equal(img_k, img_p)


def _sorted_pool(tables, n, seed, S, device):
    """The adversarial pool sorted by the bin key of its scan planes, as
    the wavefront sorts a bounce pool."""
    o, d, t_max = _adversarial_pool(n, device, seed)
    s_t, s_o, thr = sw.dense_scan(tables, o, d, t_max, slots=S)
    key = tsc.bin_key(s_o, d, tables.num_treelets, S)
    perm = tsc.bin_sort_perm([torch.where(t_max > 0, key, 1 << 30)])
    g = lambda a: a[..., perm].contiguous()
    return (Vec3(g(o.x), g(o.y), g(o.z)), Vec3(g(d.x), g(d.y), g(d.z)),
            g(t_max), g(s_o), g(s_t))


def _hits_equal(got, want):
    for f in ("t", "tri", "u", "v"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("S,mode", [(1, "demand"), (2, "demand"),
                                    (4, "demand"), (8, "demand"), (2, "all"),
                                    (8, "all"), (4, "any")])
def test_sweep_lane_kernel_equals_plain(tables, cuda, S, mode):
    """K7 (1024-lane blocks) with and without entry planes and in any-hit
    mode, on the bin-sorted adversarial pool (the any-hit case on short
    segments), bit for bit."""
    o, d, t_max, s_o, s_t = _sorted_pool(tables, 5000, 24 + S, S, cuda)
    if mode == "any":
        t_max = torch.where(t_max > 0, torch.clamp_max(t_max, 6.0), t_max)
    entry = None if mode == "all" else s_t
    key = "sweep_closest_hit" + ("/any_hit" if mode == "any" else "")
    before = sw.LAUNCHES[key]
    stats = torch.zeros(3, dtype=torch.int64, device=cuda)
    got = sw.sweep_closest_hit(tables, o, d, t_max, s_o, entry,
                               any_hit=mode == "any", stats=stats)
    assert sw.LAUNCHES[key] == before + 1
    want = sw.sweep_closest_hit_plain(tables, o, d, t_max, s_o, entry,
                                      any_hit=mode == "any")
    _hits_equal(got, want)
    assert int(stats[2]) == int((t_max > 0).sum())
    assert bool((got.tri[~(t_max > 0)] == -1).all())
    assert bool((got.tri >= 0).any())


def _grouped_tables(device):
    """Synthetic tables at chunk_align 4 (treelets of 4..32 8-row chunks,
    so 8 groups cover each) with their group boxes."""
    from tpt_torch.bvh.treelet import group_boxes

    base = _synthetic_tables(300, 27, "cpu", max_chunks=8)
    chunks = base.ranges[:, 1].numpy() * 4
    start = np.concatenate([[0], np.cumsum(chunks * 8)[:-1]])
    tri = np.zeros((int(chunks.sum()) * 8, 16), np.float32)
    count = np.zeros(len(chunks), np.int64)
    old = base.tri_f32.numpy()
    for t, (s0, c0) in enumerate(base.ranges.numpy()):
        rows = old[s0:s0 + c0 * 8]
        rows = np.concatenate([rows] * 4)                 # 4x the triangles
        rows[len(rows) // 4:, 0:3] += np.random.default_rng(t).normal(
            scale=0.5, size=(len(rows) - len(rows) // 4, 3))
        tri[start[t]:start[t] + len(rows)] = rows
        count[t] = len(rows)
    gbox = group_boxes(tri, start, count, chunks, 4, 8)
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return SweepTables(tri_f32=dev(tri),
                       ranges=dev(np.stack([start, chunks], 1).astype(np.int32)),
                       boxes=base.boxes.to(device), group_boxes=dev(gbox),
                       num_treelets=base.num_treelets,
                       max_chunks=int(chunks.max()), unroll=8, chunk_align=4)


@pytest.mark.parametrize("unroll,any_hit,groups", [
    (1, True, False), (4, True, False), (1, False, True), (2, False, True),
    (4, True, True)])
def test_sweep8_modes_equal_plain(cuda, unroll, any_hit, groups):
    """K4's any-hit and group modes, bit for bit; group mode's raw hits
    are also the ungrouped kernel's."""
    tables = _grouped_tables(cuda)
    assert tables.max_chunks <= 8 * tables.chunk_align
    o, d, t_max, s_o, s_t = _sorted_pool(tables, 4000, 28, 4, cuda)
    if any_hit:
        t_max = torch.where(t_max > 0, torch.clamp_max(t_max, 6.0), t_max)
    key = "sweep8_closest_hit" + ("/any_hit" if any_hit else "/groups")
    before = sw.LAUNCHES[key]
    kw = dict(unroll=unroll, any_hit=any_hit, use_groups=groups)
    got = sw.sweep8_closest_hit(tables, o, d, t_max, s_o, s_t, **kw)
    assert sw.LAUNCHES[key] == before + 1
    _hits_equal(got, sw.sweep8_closest_hit_plain(tables, o, d, t_max, s_o,
                                                 s_t, **kw))
    if groups:
        flat = sw.sweep8_closest_hit(tables, o, d, t_max, s_o, s_t,
                                     unroll=unroll, any_hit=any_hit)
        _hits_equal(got, flat)
    assert bool((got.tri >= 0).any())


def test_sweep_variant_render_on_card_matches_cpu(cornell, cuda):
    """The "lane" and "cascade" variants on the card (K3, K7, K4's modes,
    K1, K2) against the same renders on the CPU (plain versions), at the
    golden-image tolerance."""
    host, data = cornell
    cpu = host.build(with_bvh=True, device="cpu")
    for knobs in (dict(sweep_kernel="lane", sweep_shadow=True),
                  dict(sweep_groups=True, sweep_shadow=True,
                       sweep_cascade=True, sweep_primary=True)):
        cfg = RenderConfig(backend=RayCastBackend.BVH_SWEEP, trace_depth=3,
                           **knobs)
        rc = common.make_raycaster(data, cfg)
        gpu = wavefront.render(data, host.camera, cfg, iterations=2,
                               raycaster=rc)
        ref = wavefront.render(cpu, host.camera, cfg, iterations=2)
        assert int(rc.capped) == 0
        assert np.isclose(gpu, ref, atol=5e-3, rtol=1e-3).mean() > 0.97
        np.testing.assert_allclose(gpu.mean(), ref.mean(), rtol=0.02)


# ---------------------------------------------------------------------------
# K3 and K4/K7 as redesigned for the card: floats held as bit patterns;
# K4/K7 test every row of the union (tpt's window in K4's group mode)
# ---------------------------------------------------------------------------

def _bits(a):
    return a.view(torch.int32) if a.dtype == torch.float32 else a


def _bits_equal_hits(got, want):
    for f in ("t", "tri", "u", "v"):
        assert torch.equal(_bits(getattr(got, f)), _bits(getattr(want, f))), f


def _edge_pool(tables, n, seed, device):
    """The adversarial pool, with origins on box planes (each face of 40
    treelet boxes, the ray inside the face), zero and negative-zero
    direction components and NaN origins."""
    o, d, t_max = _adversarial_pool(n, device, seed)
    ox, oy, oz = o.x.cpu(), o.y.cpu(), o.z.cpu()
    dx, dy, dz = d.x.cpu(), d.y.cpu(), d.z.cpu()
    boxes = tables.boxes.cpu()
    for k in range(40):
        b = boxes[(7 * k) % tables.num_treelets]
        c = (b[:3] + b[3:6]) / 2
        c[k % 3] = b[k % 3 + 3 * ((k // 3) % 2)]
        ox[40 + k], oy[40 + k], oz[40 + k] = c
    dx[100:120] = 0.0
    dy[110:130] = -0.0
    dz[125:135] = 0.0
    ox[140], oy[141], oz[142] = float("nan"), float("nan"), float("nan")
    t_max[40:143] = 3.4e38
    dev = lambda a: a.to(device)
    return (Vec3(dev(ox), dev(oy), dev(oz)), Vec3(dev(dx), dev(dy), dev(dz)),
            t_max)


@pytest.mark.parametrize("S", [1, 4, 8])
def test_dense_scan_bits_equal_plain(tables, cuda, S):
    """K3 on 1100 treelets (two tiles, the second part full) bit for bit,
    the sign of zero included: no entry t is -0."""
    o, d, t_max = _edge_pool(tables, 4001, 31, cuda)
    stats = torch.zeros(1, dtype=torch.int64, device=cuda)
    got = sw.dense_scan(tables, o, d, t_max, slots=S, stats=stats)
    want = sw.dense_scan_plain(tables, o, d, t_max, slots=S)
    for a, b in zip(got, want):
        assert torch.equal(_bits(a), _bits(b))
    assert int(stats[0]) == int((t_max > 0).sum()) * tables.num_treelets
    assert not bool((_bits(got[0]) == torch.iinfo(torch.int32).min).any())
    assert bool((got[0][0, 40:100] == 0.0).any())     # origins in boxes
    assert bool((got[1][:, 140:143] == sw.NONE_ORD).all())


def _tail_tables(device):
    """The synthetic tables (chunk_align 1, up to 40 8-row chunks a
    treelet) with group boxes of one chunk each: the rows past the 8th
    group of a treelet are swept by every warp with a live lane."""
    from tpt_torch.bvh.treelet import group_boxes

    base = _synthetic_tables(300, 33, "cpu")
    start, chunks = base.ranges[:, 0].numpy(), base.ranges[:, 1].numpy()
    gbox = group_boxes(base.tri_f32.numpy(), start, chunks * 8 - 1, chunks,
                       1, 8)
    return replace(base, group_boxes=torch.from_numpy(gbox)).to(device)


@pytest.fixture(scope="module")
def culled_tables(cuda):
    return {"grouped": _grouped_tables(cuda), "tail": _tail_tables(cuda)}


def _shuffled(pool, seed):
    o, d, t_max, s_o, s_t = pool
    perm = torch.randperm(t_max.numel(), generator=torch.Generator().manual_seed(
        seed)).to(t_max.device)
    g = lambda a: a[..., perm].contiguous()
    return (Vec3(g(o.x), g(o.y), g(o.z)), Vec3(g(d.x), g(d.y), g(d.z)),
            g(t_max), g(s_o), g(s_t))


@pytest.mark.parametrize("order", ["sorted", "shuffled"])
@pytest.mark.parametrize("kind,mode", [("grouped", "closest"),
                                       ("grouped", "any"),
                                       ("grouped", "groups"),
                                       ("tail", "closest"), ("tail", "any")])
def test_sweep8_culled_bits_equal_plain(culled_tables, cuda, kind, mode,
                                        order):
    """K4 on tables with group boxes, closest hit, any-hit and group
    modes, on the bin-sorted pool and on the same pool shuffled (warps of
    unrelated lanes), bit for bit; here group mode's raw hits also equal
    the plain mode's."""
    tables = culled_tables[kind]
    pool = _sorted_pool(tables, 4000, 34, 4, cuda)
    if order == "shuffled":
        pool = _shuffled(pool, 35)
    o, d, t_max, s_o, s_t = pool
    if mode == "any":
        t_max = torch.where(t_max > 0, torch.clamp_max(t_max, 6.0), t_max)
    kw = dict(unroll=tables.chunk_align, any_hit=mode == "any",
              use_groups=mode == "groups")
    stats = torch.zeros(3, dtype=torch.int64, device=cuda)
    got = sw.sweep8_closest_hit(tables, o, d, t_max, s_o, s_t, stats=stats,
                                **kw)
    _bits_equal_hits(got, sw.sweep8_closest_hit_plain(tables, o, d, t_max,
                                                      s_o, s_t, **kw))
    if mode == "groups":
        _bits_equal_hits(got, sw.sweep8_closest_hit(
            tables, o, d, t_max, s_o, s_t, unroll=tables.chunk_align))
    assert int(stats[2]) == int((t_max > 0).sum())
    assert bool((got.tri >= 0).any())


def test_sweep8_culled_tests_at_most_the_union(culled_tables, cuda):
    """The triangle tests K4 makes (stats[1]) are those of a sweep of
    each block's whole walked union, at least the need."""
    from torch_sweep_walk import union_tests

    tables = culled_tables["grouped"]
    o, d, t_max, s_o, s_t = _sorted_pool(tables, 2048, 36, 4, cuda)
    stats = torch.zeros(3, dtype=torch.int64, device=cuda)
    hits = sw.sweep8_closest_hit(tables, o, d, t_max, s_o, s_t, unroll=4,
                                 stats=stats)
    union = union_tests(tables, o, d, t_max, s_o, s_t, sw.LANES,
                        tables.unroll)
    need = sw.sweep_need(tables, o, d, t_max, s_o, s_t, hits)
    assert need[0] <= int(stats[1]) == union


def test_sweep8_warps_on_disjoint_treelets(culled_tables, cuda):
    """One 128-lane block whose four warps each demand their own 8
    treelets from origins inside them: the block walks all 32, every lane
    tests every row of the 32, and the hits are the plain sweep's, bit for
    bit."""
    tables = culled_tables["grouped"]
    boxes = tables.boxes.cpu()
    rs = np.random.default_rng(37)
    ords = rs.permutation(tables.num_treelets)[:32].reshape(4, 8)
    lane_ord = np.repeat(ords, 4, axis=1).reshape(-1)        # [128]
    b = boxes[torch.from_numpy(lane_ord).long()]
    o = (b[:, :3] + (b[:, 3:6] - b[:, :3])
         * torch.from_numpy(rs.uniform(0.2, 0.8, (128, 3))).float())
    dd = torch.from_numpy(rs.normal(size=(128, 3))).float()
    dd /= dd.norm(dim=1, keepdim=True)
    v = lambda a: Vec3(a[:, 0].contiguous().to(cuda),
                       a[:, 1].contiguous().to(cuda),
                       a[:, 2].contiguous().to(cuda))
    o, dd = v(o), v(dd)
    t_max = torch.full((128,), 3.4e38, device=cuda)
    s_o = torch.full((4, 128), sw.NONE_ORD, dtype=torch.int32)
    s_o[0] = torch.from_numpy(lane_ord)
    s_o = s_o.to(cuda)
    s_t = torch.where(s_o == sw.NONE_ORD, 3.0e38, 0.0).float()
    stats = torch.zeros(3, dtype=torch.int64, device=cuda)
    got = sw.sweep8_closest_hit(tables, o, dd, t_max, s_o, s_t, unroll=4,
                                stats=stats)
    _bits_equal_hits(got, sw.sweep8_closest_hit_plain(tables, o, dd, t_max,
                                                      s_o, s_t, unroll=4))
    assert int(stats[0]) == 32
    rows = int(tables.ranges[torch.from_numpy(ords.reshape(-1)).long().to(
        cuda), 1].sum()) * tables.unroll
    assert int(stats[1]) == rows * 128
    assert bool((got.tri >= 0).any())


@pytest.mark.parametrize("kind", ["grouped", "tail"])
@pytest.mark.parametrize("mode", ["demand", "all", "any"])
def test_sweep_lane_culled_bits_equal_plain(culled_tables, cuda, kind, mode):
    """K7 (1024-lane blocks) on tables with group boxes, with and without
    entry planes and in any-hit mode, bit for bit."""
    tables = culled_tables[kind]
    o, d, t_max, s_o, s_t = _sorted_pool(tables, 5000, 38, 4, cuda)
    if mode == "any":
        t_max = torch.where(t_max > 0, torch.clamp_max(t_max, 6.0), t_max)
    entry = None if mode == "all" else s_t
    got = sw.sweep_closest_hit(tables, o, d, t_max, s_o, entry,
                               any_hit=mode == "any")
    _bits_equal_hits(got, sw.sweep_closest_hit_plain(
        tables, o, d, t_max, s_o, entry, any_hit=mode == "any"))
    assert bool((got.tri >= 0).any())


# ---------------------------------------------------------------------------
# Flat groups at coordinate 0 (torch_flatgroup): a slab test of a group
# box at a lane's best t is no bound on Moller-Trumbore's t there, and K4
# and K7 must still return the plain sweep's hits
# ---------------------------------------------------------------------------

def _sweep_modes(tables, pool, unroll):
    """Each mode of K4 and K7 on `pool`, kernel against plain, bit for
    bit; returns K4's default hits."""
    o, d, t_max, s_o, s_t = pool
    out = None
    for mode in ("K4", "K4 groups", "K4 any-hit", "K7", "K7 any-hit"):
        any_hit = "any-hit" in mode
        if mode.startswith("K4"):
            kw = dict(unroll=unroll, any_hit=any_hit,
                      use_groups=mode == "K4 groups")
            got = sw.sweep8_closest_hit(tables, o, d, t_max, s_o, s_t, **kw)
            want = sw.sweep8_closest_hit_plain(tables, o, d, t_max, s_o, s_t,
                                               **kw)
        else:
            got = sw.sweep_closest_hit(tables, o, d, t_max, s_o, s_t,
                                       any_hit=any_hit)
            want = sw.sweep_closest_hit_plain(tables, o, d, t_max, s_o, s_t,
                                              any_hit=any_hit)
        _bits_equal_hits(got, want)
        if mode == "K4":
            out = got
    return out


def test_sweeps_on_the_flat_group_warp(cuda):
    """The two-triangle warp: every mode equals plain, and the closest
    hit is B's (a sweep that culled B's group at A's t kept A's)."""
    import torch_flatgroup as fg

    tables = fg.flat_tables(cuda)
    hits = _sweep_modes(tables, fg.flat_warp(cuda), 1)
    assert int(hits.tri[0]) == fg.PLAIN_TRI
    assert float(hits.t[0]) == float(torch.tensor(fg.PLAIN_T))
    pool = fg.edge_pool(4096, 3, cuda)
    hits = _sweep_modes(tables, pool, 1)
    assert float((hits.tri >= 0).float().mean()) > 0.6


@pytest.mark.parametrize("lone", [False, True])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_sweeps_on_flat_grids(cuda, axis, lone):
    """A seeded grid of triangles in the plane `axis` = 0 (group mode
    active: 5 chunks a treelet), rays at its shared edges, each ray in a
    mixed warp or alone in its warp: every mode of K4 and K7 equals
    plain, bit for bit."""
    import torch_flatgroup as fg

    tables, p, q = fg.stress_tables(axis, 60 + axis, cuda)
    assert 1 < tables.max_chunks <= 8 * tables.chunk_align
    pool = fg.stress_pool(axis, (p, q), 1024 if lone else 4096, 70 + axis,
                          cuda, lone=lone)
    hits = _sweep_modes(tables, pool, 1)
    live = pool[2] > 0
    assert float((hits.tri[live] >= 0).float().mean()) > 0.8


# ---------------------------------------------------------------------------
# K5 a-trous stencil and K6 temporal reprojection
# ---------------------------------------------------------------------------

def _exact(a, b):
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def _atrous_planes(h, w, kind, seed, device):
    """The 12 input planes of K5: illumination, variance, a depth edge with
    a patch of sky, unit normals; `kind` makes them adversarial."""
    rs = np.random.default_rng(seed)
    f = lambda *s: rs.random(s).astype(np.float32)
    depth = f(h, w) * 3 + 10
    depth[:, w // 2:] += 40.0
    depth[h // 3:h // 2, w // 4:w // 2] = -1000.0
    n = rs.normal(size=(3, h, w))
    n = (n / np.linalg.norm(n, axis=0, keepdims=True)).astype(np.float32)
    n[:, :h // 2, :w // 2] = np.array([0.0, 0.6, 0.8], np.float32)[:, None, None]
    ill_d, var_d, ill_i, var_i = f(3, h, w), f(h, w), f(3, h, w) * 2, f(h, w)
    if kind == "all_sky":
        depth[:] = -1000.0
    elif kind == "signed_zero_normals":
        n[:, ::2] = 0.0
        n[:, 1::4] = -0.0
        n[2, ::3] = -0.0
    elif kind == "nonfinite":
        var_d.flat[::7] = np.nan
        ill_i[1].flat[::5] = np.inf
        depth.flat[::11] = np.inf
        n[0].flat[::13] = np.nan
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    v = lambda a: Vec3(t(a[0]), t(a[1]), t(a[2]))
    return (v(ill_d), t(var_d), v(ill_i), t(var_i), t(depth), v(n))


@pytest.mark.parametrize("h,w,step,kind", [
    (1, 1, 1, "plain"), (17, 33, 1, "plain"), (17, 33, 2, "all_sky"),
    (17, 33, 4, "signed_zero_normals"), (17, 33, 2, "nonfinite"),
    (9, 9, 16, "plain"), (70, 37, 33, "nonfinite"), (1080, 1920, 1, "plain"),
    (1080, 1920, 2, "plain"), (1080, 1920, 4, "plain"),
    (1080, 1920, 8, "plain"), (1080, 1920, 16, "nonfinite")])
def test_atrous_kernel_equals_plain(cuda, h, w, step, kind):
    planes = _atrous_planes(h, w, kind, 31, cuda)
    sig = (1.0, 128.0, 4.0)
    before = stencil.LAUNCHES["atrous"]
    got = stencil.atrous(*planes, step, *sig)
    assert stencil.LAUNCHES["atrous"] == before + 1
    want = stencil.atrous_plain(*planes, step, *sig)
    flat = lambda o: [o[0].x, o[0].y, o[0].z, o[1], o[2].x, o[2].y, o[2].z, o[3]]
    for a, b in zip(flat(got), flat(want)):
        _exact(a, b)
    if kind == "all_sky":
        _exact(got[0].x, planes[0].x)


@pytest.mark.parametrize("h,w,kind,iterations", [
    (1, 1, "plain", 5), (17, 33, "nonfinite", 5), (23, 37, "plain", 2),
    (23, 37, "all_sky", 1), (1080, 1920, "plain", 5),
    (1080, 1920, "nonfinite", 5)])
def test_atrous_passes_equal_plain(cuda, h, w, kind, iterations):
    """The frame's passes in one call (packed records between them): the
    last pass and the history pass (iterations - 2) bit-equal to the plain
    passes, one K5 launch a pass."""
    planes = _atrous_planes(h, w, kind, 37, cuda)
    sig = (1.0, 128.0, 4.0)
    before = stencil.LAUNCHES["atrous"]
    fin, hist = stencil.atrous_passes(*planes, iterations, *sig)
    assert stencil.LAUNCHES["atrous"] == before + iterations
    want_fin, want_hist = stencil.atrous_passes_plain(*planes, iterations,
                                                      *sig)
    flat = lambda o: [o[0].x, o[0].y, o[0].z, o[1], o[2].x, o[2].y, o[2].z, o[3]]
    for a, b in zip(flat(fin) + flat(hist), flat(want_fin) + flat(want_hist)):
        _exact(a, b)


def _reproject_inputs(h, w, motion, seed, device):
    """A history in 6x6 blocks of one normal and material on a depth ramp,
    and a current frame that is that geometry moved by the motion, with
    some normals, depths and materials changed."""
    rs = np.random.default_rng(seed)
    f = lambda: rs.random((h, w)).astype(np.float32)
    bh, bw = -(-h // 6), -(-w // 6)
    blocks = lambda a: np.ascontiguousarray(
        np.repeat(np.repeat(a, 6, -2), 6, -1)[..., :h, :w])
    n = rs.normal(size=(3, bh, bw))
    nrm = blocks((n / np.linalg.norm(n, axis=0, keepdims=True)).astype(np.float32))
    depth_h = (20.0 + 0.2 * np.arange(w)[None, :]
               + 0.1 * np.arange(h)[:, None]).astype(np.float32)
    mat_h = blocks(rs.integers(0, 3, (bh, bw))).astype(np.int32)
    leaves = [f() for _ in range(12)] + [
        rs.integers(0, 9, (h, w)).astype(np.int32), depth_h,
        nrm[0], nrm[1], nrm[2], mat_h]
    if motion == "pan":
        mu = np.full((h, w), 2.25, np.float32)
        mv = np.full((h, w), -1.5, np.float32)
    else:
        mu = rs.uniform(-3, 3, (h, w)).astype(np.float32)
        mv = rs.uniform(-3, 3, (h, w)).astype(np.float32)
    if motion == "far":
        mu.flat[::3] = 1e9
        mv.flat[1::3] = -5000.0
        mu.flat[2::7] = -float(w) - 0.5
    elif motion == "nonfinite":
        mu.flat[::5] = np.nan
        mv.flat[1::6] = np.inf
        mu.flat[2::7] = -np.inf
        mv.flat[3::9] = np.nan
    sy = np.clip(np.round(np.arange(h)[:, None] - np.nan_to_num(mv)), 0, h - 1)
    sx = np.clip(np.round(np.arange(w)[None, :] - np.nan_to_num(mu)), 0, w - 1)
    moved = lambda a: np.ascontiguousarray(a[sy.astype(int), sx.astype(int)])
    normal = np.stack([moved(c) for c in nrm])
    normal[:, ::5] = -normal[:, ::5]
    depth = moved(depth_h) + rs.uniform(-0.5, 2.5, (h, w)).astype(np.float32)
    matid = np.where(rs.random((h, w)) < 0.9, moved(mat_h), 7).astype(np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    state = svgf.svgf_state_from_numpy(leaves, device)
    return state, t(mu), t(mv), Vec3(*(t(c) for c in normal)), t(depth), t(matid)


@pytest.mark.parametrize("h,w,motion", [
    (1, 1, "random"), (17, 33, "random"), (17, 33, "pan"), (17, 33, "far"),
    (17, 33, "nonfinite"), (1080, 1920, "pan"), (1080, 1920, "nonfinite")])
def test_reproject_kernel_equals_plain(cuda, h, w, motion):
    args = _reproject_inputs(h, w, motion, 41, cuda)
    before = reproject.LAUNCHES["reproject"]
    sums, wsum = reproject.reproject(*args)
    assert reproject.LAUNCHES["reproject"] == before + 1
    want_sums, want_w = svgf._reproject_taps(*args)
    _exact(wsum, want_w)
    for k in svgf.DATA_KEYS:
        _exact(sums[k], want_sums[k])
    if motion == "pan":
        assert float((wsum > 0).float().mean()) > 0.4


def test_denoised_renderer_kernels_equal_plain(cornell, cuda, monkeypatch):
    """A denoised Renderer run (3 frames, a camera move, 2 frames) through
    K5/K6 against the same run through their plain versions: 5 K5 and 1
    K6 launches a frame, and the images agree bit for bit."""
    host, data = cornell
    cfg = RenderConfig(backend=RayCastBackend.BVH_PALLAS, trace_depth=3,
                       denoiser_on=True)

    def run():
        r = Renderer(data, host.camera, cfg)
        frames = [r.frame() for _ in range(3)]
        r.move_camera(host.camera.moved(position=(280.0, 273.0, -790.0)))
        return frames + [r.frame() for _ in range(2)]

    before = (stencil.LAUNCHES["atrous"], reproject.LAUNCHES["reproject"])
    img_k = run()
    assert (stencil.LAUNCHES["atrous"], reproject.LAUNCHES["reproject"]) == \
        (before[0] + 25, before[1] + 5)
    monkeypatch.setattr(stencil, "atrous", stencil.atrous_plain)
    monkeypatch.setattr(stencil, "atrous_passes", stencil.atrous_passes_plain)
    monkeypatch.setattr(reproject, "reproject", svgf._reproject_taps)
    img_p = run()
    assert stencil.LAUNCHES["atrous"] == before[0] + 25
    for a, b in zip(img_k, img_p):
        assert np.isfinite(a).all() and a.mean() > 0.01
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# K9 treelet scan and K10 treelet closest hit
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def treelet_scenes(cuda):
    """Cornell (4428 triangles) cut into treelets of <= 64 triangles, and
    of <= 16, where every treelet root is a single cluster (a negative
    treelet code, drained from the cluster stack)."""
    host = procedural.cornell_box(resolution=(32, 32))
    return {mt: host.build(with_bvh=True, treelet_max_tris=mt, device=cuda)
            for mt in (16, 64)}


def _treelet_rays(data, n, seed, cuda):
    """n rays inside the box, every 7th lane dead, and NaN, +-0
    directions and a NaN origin among the first lanes."""
    pos = data.mesh.positions
    lo = [float(c.min()) for c in (pos.x, pos.y, pos.z)]
    hi = [float(c.max()) for c in (pos.x, pos.y, pos.z)]
    rs = np.random.default_rng(seed)
    o = rs.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    special = [(0.0, -0.0, 1.0), (-0.0, 1.0, 0.0), (np.nan, 0.5, 0.5),
               (0.0, 0.0, -1.0)]
    for k, v in enumerate(special[:max(0, n - 1)]):
        d[1 + k] = v
    if n > 6:
        o[6] = (np.nan, 0.0, 0.0)
    tm = np.full(n, 3.4e38, np.float32)
    tm[7::7] = -1.0
    v = lambda a: Vec3.from_stacked(torch.from_numpy(a).to(cuda))
    return v(o), v(d), torch.from_numpy(tm).to(cuda)


def _bits_equal(a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    assert torch.equal(a, b), int((a != b).sum())


@pytest.mark.parametrize("n,group", [(1, 2), (2049, 2), (6000, 4)])
def test_treelet_scan_kernel_equals_plain(treelet_scenes, cuda, n, group):
    data = treelet_scenes[64]
    o, d, tm = _treelet_rays(data, n, 31, cuda)
    before = tlt.LAUNCHES["treelet_scan"]
    stats = torch.zeros(2, dtype=torch.int64, device=cuda)
    got = tlt.treelet_scan(data.pack, o, d, tm, group=group, stats=stats)
    assert tlt.LAUNCHES["treelet_scan"] == before + 1
    want = tlt.treelet_scan_plain(data.pack, o, d, tm, group=group)
    for a, b in zip(got, want):
        _bits_equal(a, b)
    assert int(got[5]) == 0 and int(stats[0]) > 0


def test_treelet_scan_dead_pool(treelet_scenes, cuda):
    data = treelet_scenes[64]
    o, d, _ = _treelet_rays(data, 3000, 32, cuda)
    tm = torch.full((3000,), -1.0, device=cuda)
    st, sc, so, ovf, cnt, capped = tlt.treelet_scan(data.pack, o, d, tm)
    assert bool((sc == tlt.NONE_CODE).all()) and not bool(ovf.any())
    assert not bool(cnt.any()) and int(capped) == 0
    hit, capped = tlt.treelet_closest_hit(data.pack, o, d, tm)
    assert bool((hit.tri == -1).all()) and int(capped) == 0


@pytest.mark.parametrize("mt", [16, 64])
@pytest.mark.parametrize("n,group,seeded", [
    (1, 2, False), (2049, 2, False), (2049, 2, True), (6000, 4, False),
    (6000, 2, True)])
def test_treelet_closest_hit_kernel_equals_plain(treelet_scenes, cuda, mt, n,
                                                 group, seeded):
    """Unseeded and seeded from K9 (pool sorted by the seed's ordinal, as
    the wavefront does), bit for bit; the hits are brute force's."""
    data = treelet_scenes[mt]
    pack = data.pack
    if mt == 16:
        assert bool((pack.top_tref < -1).any())
    o, d, tm = _treelet_rays(data, n, 33 + n, cuda)
    seed = None
    if seeded:
        st, sc, so, ovf, _, _ = tlt.treelet_scan(pack, o, d, tm)
        key = torch.where(sc != tlt.NONE_CODE, so.long(), 1 << 30)
        perm = torch.sort(key, stable=True).indices
        g = lambda a: a[perm].contiguous()
        o, d = Vec3(g(o.x), g(o.y), g(o.z)), Vec3(g(d.x), g(d.y), g(d.z))
        tm, seed = g(tm), (g(st), g(sc), g(ovf))
    before = tlt.LAUNCHES["treelet_closest_hit"]
    stats = torch.zeros(6, dtype=torch.int64, device=cuda)
    got, cap_k = tlt.treelet_closest_hit(pack, o, d, tm, group=group,
                                         seed=seed, stats=stats)
    assert tlt.LAUNCHES["treelet_closest_hit"] == before + 1
    want, cap_p = tlt.treelet_closest_hit_plain(pack, o, d, tm, group=group,
                                                seed=seed)
    for f in ("t", "tri", "u", "v"):
        _bits_equal(getattr(got, f), getattr(want, f))
    assert int(cap_k) == 0 and int(cap_p) == 0
    ref = intersect.brute_force_closest_hit(data.mesh, o, d, tm)
    assert torch.equal(got.tri, ref.tri)
    assert int(stats[3]) > 0 and int(stats[5]) <= int(stats[3])


@pytest.mark.parametrize("n,group,S", [(1, 2, 4), (2049, 2, 4), (2049, 1, 8),
                                       (6000, 2, 1), (6000, 1, 2),
                                       (2049, 2, 8), (6000, 4, 4),
                                       (6000, 4, 8), (9000, 8, 1),
                                       (9000, 8, 5)])
def test_treelet_scan_multi_kernel_equals_plain(treelet_scenes, cuda, n, group,
                                                S):
    """Every plane bit for bit, with the lanes' slots in registers, in
    shared memory and in the global scratch (tlt.multi_place)."""
    data = treelet_scenes[64]
    o, d, tm = _treelet_rays(data, n, 41 + n, cuda)
    before = tlt.LAUNCHES["treelet_scan_multi"]
    stats = torch.zeros(2, dtype=torch.int64, device=cuda)
    got = tlt.treelet_scan_multi(data.pack, o, d, tm, slots=S, group=group,
                                 stats=stats)
    assert tlt.LAUNCHES["treelet_scan_multi"] == before + 1
    want = tlt.treelet_scan_multi_plain(data.pack, o, d, tm, slots=S,
                                        group=group)
    for a, b in zip(got, want):
        _bits_equal(a, b)
    assert int(got[3]) == 0 and int(stats[0]) > 0


def test_treelet_scan_multi_dead_pool_and_cycle(treelet_scenes, cuda):
    """A dead pool walks nothing; a top root that lists itself as its
    children is capped, not hung."""
    data = treelet_scenes[64]
    o, d, _ = _treelet_rays(data, 3000, 42, cuda)
    s_t, s_o, thr, capped = tlt.treelet_scan_multi(
        data.pack, o, d, torch.full((3000,), -1.0, device=cuda))
    assert bool((s_o == sw.NONE_ORD).all()) and bool((thr == 3.0e38).all())
    assert int(capped) == 0
    child = data.pack.top_child.clone()
    child[0, :data.pack.arity] = 0
    bad = replace(data.pack, top_child=child)
    tm = torch.full((3000,), 3.4e38, device=cuda)
    _, _, _, capped = tlt.treelet_scan_multi(bad, o, d, tm, node_pops=1)
    torch.cuda.synchronize()
    assert int(capped) == 3000


def test_treelet_max_rounds_is_capped(treelet_scenes, cuda):
    """One round cannot finish: every live lane of every packet counts."""
    data = treelet_scenes[64]
    o, d, tm = _treelet_rays(data, 5000, 40, cuda)
    got, cap_k = tlt.treelet_closest_hit(data.pack, o, d, tm, max_rounds=1)
    want, cap_p = tlt.treelet_closest_hit_plain(data.pack, o, d, tm,
                                                max_rounds=1)
    for f in ("t", "tri", "u", "v"):
        _bits_equal(getattr(got, f), getattr(want, f))
    assert int(cap_k) == int(cap_p) == int((tm > 0).sum()) > 0


@pytest.mark.parametrize("seeded", [False, True])
def test_treelet_equal_t_ties_across_treelets(treelet_scenes, cuda, seeded):
    """Rays at edges that two triangles of different treelets share: where
    both hit at the same t, the packet's first-drained treelet wins, bit
    for bit as the plain walk; some lanes' triangle differs from brute
    force's first minimum."""
    data = treelet_scenes[16]
    pack = data.pack
    o, d, tm, ties = tie_pool(data, 6000, 5, cuda)
    assert ties > 50
    seed = None
    if seeded:
        st, sc, so, ovf, _, _ = tlt.treelet_scan(pack, o, d, tm)
        key = torch.where(sc != tlt.NONE_CODE, so.long(), 1 << 30)
        perm = torch.sort(key, stable=True).indices
        g = lambda a: a[perm].contiguous()
        o, d = Vec3(g(o.x), g(o.y), g(o.z)), Vec3(g(d.x), g(d.y), g(d.z))
        tm, seed = g(tm), (g(st), g(sc), g(ovf))
    got, cap_k = tlt.treelet_closest_hit(pack, o, d, tm, seed=seed)
    want, cap_p = tlt.treelet_closest_hit_plain(pack, o, d, tm, seed=seed)
    for f in ("t", "tri", "u", "v"):
        _bits_equal(getattr(got, f), getattr(want, f))
    assert int(cap_k) == 0 and int(cap_p) == 0
    ref = intersect.brute_force_closest_hit(data.mesh, o, d, tm)
    assert torch.equal(got.t, ref.t)
    assert int((got.tri != ref.tri).sum()) > 0


@pytest.mark.parametrize("mt", [16, 64])
def test_treelet_4096_lane_packets_at_8_slots(treelet_scenes, cuda, mt):
    """The largest lane layout the port takes: 4096-lane packets (the hot
    planes fill the block's shared memory) with 8 slots a lane (in the
    global scratch), unseeded and seeded."""
    data = treelet_scenes[mt]
    pack = data.pack
    o, d, tm = _treelet_rays(data, 9000, 61, cuda)
    attrs = tlt.kernel_attributes(10, 4, 8)
    assert attrs["dynamic_shared_bytes"] == 13 * 4 * 4096
    assert attrs["threads"] == tlt.THREADS
    st, sc, so, ovf, _, _ = tlt.treelet_scan(pack, o, d, tm, group=4)
    for seed in (None, (st, sc, ovf)):
        got, cap_k = tlt.treelet_closest_hit(pack, o, d, tm, group=4,
                                             slots=8, seed=seed)
        want, cap_p = tlt.treelet_closest_hit_plain(pack, o, d, tm, group=4,
                                                    slots=8, seed=seed)
        for f in ("t", "tri", "u", "v"):
            _bits_equal(getattr(got, f), getattr(want, f))
        assert int(cap_k) == 0 and int(cap_p) == 0


def test_treelet_short_packets_beside_a_long_one(treelet_scenes, cuda):
    """Four packets of a few short segments (a few drains each) and one
    of whole rays (many): bit for bit as plain, and the long packet's
    lanes equal the same packet launched alone."""
    data = treelet_scenes[16]
    pack = data.pack
    L = 2048
    o, d, tm = _treelet_rays(data, 5 * L, 71, cuda)
    short = torch.arange(4 * L, device=cuda)
    tm[:4 * L] = torch.where((short % 512 == 3) & (tm[:4 * L] > 0), 5.0,
                             -1.0)
    stats = torch.zeros(6, dtype=torch.int64, device=cuda)
    got, cap_k = tlt.treelet_closest_hit(pack, o, d, tm, stats=stats)
    want, cap_p = tlt.treelet_closest_hit_plain(pack, o, d, tm)
    for f in ("t", "tri", "u", "v"):
        _bits_equal(getattr(got, f), getattr(want, f))
    assert int(cap_k) == 0 and int(cap_p) == 0
    sl = slice(4 * L, 5 * L)
    one = lambda v: Vec3(v.x[sl].contiguous(), v.y[sl].contiguous(),
                         v.z[sl].contiguous())
    st1 = torch.zeros(6, dtype=torch.int64, device=cuda)
    alone, _ = tlt.treelet_closest_hit(pack, one(o), one(d),
                                       tm[sl].contiguous(), stats=st1)
    for f in ("t", "tri", "u", "v"):
        _bits_equal(getattr(alone, f), getattr(got, f)[sl])
    # the long packet has the most drain rounds, more than the four short
    # ones together
    assert int(stats[5]) == int(st1[5]) > int(stats[3]) - int(st1[3]) > 0


def test_treelet_large_clusters_stage_in_chunks(cuda):
    """Clusters of up to 64 triangles: a drain step's rows can exceed one
    staging chunk of 64, seeded and not, bit for bit as plain."""
    host = procedural.cornell_box(resolution=(32, 32))
    data = host.build(with_bvh=True, max_cluster=64, treelet_max_tris=256,
                      device=cuda)
    pack = data.pack
    o, d, tm = _treelet_rays(data, 6000, 81, cuda)
    st, sc, so, ovf, _, _ = tlt.treelet_scan(pack, o, d, tm)
    for seed in (None, (st, sc, ovf)):
        got, cap_k = tlt.treelet_closest_hit(pack, o, d, tm, seed=seed)
        want, cap_p = tlt.treelet_closest_hit_plain(pack, o, d, tm, seed=seed)
        for f in ("t", "tri", "u", "v"):
            _bits_equal(getattr(got, f), getattr(want, f))
        assert int(cap_k) == 0 and int(cap_p) == 0


def test_treelet_kernel_attributes(cuda):
    """K9/K10/K11 run THREADS threads a packet; K10's lane planes fit in
    shared memory as the layout says."""
    for k in (9, 10, 11):
        assert tlt.kernel_attributes(k, 2)["threads"] == tlt.THREADS
    assert tlt.kernel_attributes(10, 2, 4)["dynamic_shared_bytes"] == \
        (13 + 3 + 2 * 4) * 4 * 2048
    assert tlt.kernel_attributes(10, 8, 4)["dynamic_shared_bytes"] == 0


def test_treelet_scan_multi_registers(cuda):
    """K11's instantiations: where each keeps its lanes' slots, and no
    spill where they live in registers (at 1 and 2 lanes a thread, the
    packets the port launches); the planes in shared memory take their
    bytes as dynamic shared memory."""
    for group in (1, 2, 4, 8):
        for S in range(1, tlt.MAX_SLOTS + 1):
            a = tlt.kernel_attributes(11, group, S)
            place = tlt.multi_place(group, S)
            print(f"K11 group {group} S {S}: {place}, {a}")
            assert a["threads"] == tlt.THREADS
            if place == "shared":
                assert a["dynamic_shared_bytes"] == 4 * (2 * S + 1) * 1024 \
                    * group
            else:
                assert a["dynamic_shared_bytes"] == 0
            if group <= 2:
                assert a["local_bytes"] == 0, (group, S, a)
    assert tlt.multi_place(2, 4) == "registers"
    assert tlt.multi_place(4, 4) == "shared"
    assert tlt.multi_place(4, 8) == "scratch"


def test_treelet_render_kernels_equal_plain(cuda, monkeypatch):
    """A BVH_TREELET render (hybrid on) launches K10 at every bounce and
    K9 at every bounce after the first, and equals the same render
    through the plain versions."""
    host = procedural.cornell_box(resolution=(32, 32), spheres=True)
    data = host.build(with_bvh=True, device=cuda)
    cfg = RenderConfig(backend=RayCastBackend.BVH_TREELET, trace_depth=3,
                       treelet_hard_count=2)
    before = dict(tlt.LAUNCHES)
    rc = common.make_raycaster(data, cfg)
    img_k = wavefront.render(data, host.camera, cfg, iterations=2,
                             raycaster=rc)
    assert tlt.LAUNCHES["treelet_closest_hit"] == \
        before["treelet_closest_hit"] + 6
    assert tlt.LAUNCHES["treelet_scan"] == before["treelet_scan"] + 4
    monkeypatch.setattr(tlt, "treelet_scan", tlt.treelet_scan_plain)
    monkeypatch.setattr(tlt, "treelet_closest_hit",
                        tlt.treelet_closest_hit_plain)
    monkeypatch.setattr(pt, "packet_closest_hit_wide",
                        pt.closest_hit_wide_plain)
    monkeypatch.setattr(pt, "packet_any_hit_wide", pt.any_hit_wide_plain)
    rp = common.make_raycaster(data, cfg)
    img_p = wavefront.render(data, host.camera, cfg, iterations=2,
                             raycaster=rp)
    assert int(rc.capped) == 0 and int(rp.capped) == 0
    assert np.isfinite(img_k).all() and img_k.mean() > 0.01
    np.testing.assert_array_equal(img_k, img_p)


# ---------------------------------------------------------------------------
# K8a/K8b on the binary pack, and the megakernel
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def binary_scenes(cuda):
    c = procedural.cornell_box(resolution=(32, 32), spheres=True)
    f = procedural.fireplace_like(num_triangles=10_000, resolution=(8, 8))
    return {"cornell": (c, c.build(with_bvh=True, packet_arity=2,
                                   device=cuda)),
            "fireplace": (f, f.build(with_bvh=True, packet_arity=2,
                                     device=cuda))}


def _binary_rays(kind, host, cuda):
    """The Cornell's jittered camera rays, or 8192 random rays in the
    scene's box; dead, NaN and short-t_max lanes in both."""
    if kind == "camera":
        from tpt_torch.core.camera import generate_camera_rays

        o, d, _ = generate_camera_rays(host.camera, 1, device=cuda)
        lo, hi = [0, 0, 0], [556, 548, 560]
    else:
        lo, hi = (([0, 0, 0], [556, 548, 560]) if kind == "cornell_random"
                  else ([0, 0, 0], [1200, 400, 900]))
        o, d = _rays(8192, lo, hi, 31, cuda)
    n = o.x.shape[0]
    gen = torch.Generator().manual_seed(3)
    t_max = torch.where(torch.rand(n, generator=gen) < 0.5,
                        torch.rand(n, generator=gen) * 700.0,
                        torch.full((n,), intersect.FLT_MAX)).to(cuda)
    t_max[::9] = -1.0
    t_max[4::101] = float("nan")
    o.x[5::97] = float("nan")
    d.z[6::89] = float("nan")
    return o, d, t_max


@pytest.mark.parametrize("kind", ["camera", "cornell_random", "fireplace"])
def test_binary_kernels_equal_plain(binary_scenes, cuda, kind):
    host, data = binary_scenes["fireplace" if kind == "fireplace"
                               else "cornell"]
    o, d, t_max = _binary_rays(kind, host, cuda)
    before = dict(pt.LAUNCHES)
    got, cap_k = pt.packet_closest_hit(data.pack, o, d, t_max)
    want, cap_p = pt.closest_hit_plain(data.pack, o, d, t_max)
    for f in ("t", "tri", "u", "v"):
        _bits_equal(getattr(got, f), getattr(want, f))
    assert int((got.tri >= 0).sum()) > o.x.shape[0] // 4
    occ_k, cap_ka = pt.packet_any_hit(data.pack, o, d, t_max)
    occ_p, cap_pa = pt.any_hit_plain(data.pack, o, d, t_max)
    assert torch.equal(occ_k, occ_p)
    assert int(cap_k) == int(cap_p) == int(cap_ka) == int(cap_pa) == 0
    assert pt.LAUNCHES == dict(before, packet_closest_hit=before[
        "packet_closest_hit"] + 1, packet_any_hit=before["packet_any_hit"] + 1)


def test_binary_kernel_matches_brute_force(binary_scenes, cuda):
    _, data = binary_scenes["cornell"]
    o, d = _rays(4096, [0, 0, 0], [556, 548, 560], 32, cuda)
    got, _ = pt.packet_closest_hit(
        data.pack, o, d, torch.full((4096,), intersect.FLT_MAX, device=cuda))
    want = intersect.brute_force_closest_hit(data.mesh, o, d)
    hit = want.tri >= 0
    assert torch.equal(got.tri >= 0, hit)
    torch.testing.assert_close(got.t[hit], want.t[hit], rtol=1e-4, atol=0)


@pytest.mark.parametrize("kind", ["closest", "any"])
def test_binary_cyclic_table_is_capped_not_hung(binary_scenes, cuda, kind):
    """A root that lists itself as both children overflows the 64-entry
    stack and never empties it; the step cap (8 * num_nodes + 4096) ends
    every ray and counts it once."""
    _, data = binary_scenes["cornell"]
    child = data.pack.node_child.clone()
    child[0, :] = 0
    bad = replace(data.pack, node_child=child)
    o, d = _rays(256, [270, 270, 270], [280, 280, 280], 33, cuda)
    t_max = torch.full((256,), 1e4, device=cuda)
    fn = pt.packet_closest_hit if kind == "closest" else pt.packet_any_hit
    _, cap = fn(bad, o, d, t_max)
    torch.cuda.synchronize()
    assert int(cap) == 256


@pytest.mark.parametrize("n", [1, 31, 4097, 300_000])
def test_binary_kernels_on_pool_sizes(binary_scenes, cuda, n):
    """K8a and K8b bit-equal to the plain walk on pools of 1 to 300,000
    random rays in the fireplace (dead, NaN and short lanes); K8b with
    lane refill (300,000 rays outnumber one wave of resident blocks), K8a
    one thread a ray (a ragged last block)."""
    _, data = binary_scenes["fireplace"]
    o, d = _rays(n, [0, 0, 0], [1200, 400, 900], 34, cuda)
    gen = torch.Generator().manual_seed(5)
    t_max = torch.where(torch.rand(n, generator=gen) < 0.5,
                        torch.rand(n, generator=gen) * 900.0,
                        torch.full((n,), intersect.FLT_MAX)).to(cuda)
    t_max[1::9] = -1.0
    o.x[2::97] = float("nan")
    want, cap_p = pt.closest_hit_plain(data.pack, o, d, t_max)
    occ_p, cap_pa = pt.any_hit_plain(data.pack, o, d, t_max)
    assert int(cap_p) == 0 and int(cap_pa) == 0
    got, cap = pt.packet_closest_hit(data.pack, o, d, t_max)
    for f in ("t", "tri", "u", "v"):
        _bits_equal(getattr(got, f), getattr(want, f))
    occ, cap_a = pt.packet_any_hit(data.pack, o, d, t_max)
    assert torch.equal(occ, occ_p)
    assert int(cap) == 0 and int(cap_a) == 0
    if n > 1:
        assert bool((want.tri >= 0).any()) and bool(occ_p.any())


def test_binary_any_hit_on_two_streams_at_once(binary_scenes, cuda):
    """K8b launched on two streams at once, each over 300,000 rays: each
    launch takes its rays from a refill counter of its own, so both
    results are the plain walk's."""
    _, data = binary_scenes["fireplace"]
    n = 300_000
    o, d = _rays(n, [0, 0, 0], [1200, 400, 900], 36, cuda)
    t_max = torch.full((n,), 500.0, device=cuda)
    occ_p, cap_p = pt.any_hit_plain(data.pack, o, d, t_max)
    assert int(cap_p) == 0
    streams = [torch.cuda.Stream(cuda), torch.cuda.Stream(cuda)]
    torch.cuda.synchronize()
    got = []
    for s in streams:
        with torch.cuda.stream(s):
            got.append(pt.packet_any_hit(data.pack, o, d, t_max))
    torch.cuda.synchronize()
    for occ, cap in got:
        assert torch.equal(occ, occ_p) and int(cap) == 0
    assert bool(occ_p.any())


def test_binary_walk_registers(cuda):
    """K8a and K8b spill nothing to local memory beyond the per-thread
    stack (its 63 entries, 252 bytes, take a 256-byte frame)."""
    for any_hit in (False, True):
        a = pt.kernel_attributes(any_hit, 2)
        assert 0 < a["regs"] <= 255 and a["max_threads"] >= 128
        assert a["local_bytes"] <= 4 * pt.STACK_DEPTH, (any_hit, a)


def test_binary_launch_refuses_misaligned_tables(binary_scenes, cuda):
    """K8a/K8b read nodes and triangle rows as float4 and child codes as
    int2: a table off its alignment raises before any launch."""
    _, data = binary_scenes["cornell"]
    o, d = _rays(64, [0, 0, 0], [556, 548, 560], 35, cuda)
    t_max = torch.full((64,), intersect.FLT_MAX, device=cuda)

    def shifted(a, by):
        buf = torch.empty(a.numel() + by, dtype=a.dtype, device=cuda)
        out = buf[by:].view(a.shape)
        out.copy_(a)
        return out

    pack = data.pack
    for bad in (replace(pack, node_f32=shifted(pack.node_f32, 1)),
                replace(pack, tri_f32=shifted(pack.tri_f32, 2)),
                replace(pack, node_child=shifted(pack.node_child, 1))):
        before = dict(pt.LAUNCHES)
        for fn in (pt.packet_closest_hit, pt.packet_any_hit):
            with pytest.raises(ValueError, match="aligned"):
                fn(bad, o, d, t_max)
        assert pt.LAUNCHES == before


@pytest.mark.parametrize("arity", [2, 4])
def test_megakernel_on_card_matches_cpu(cuda, arity):
    """The megakernel through K8a/K8b (binary pack) or K2/K1 (wide) on
    the card against the plain versions on the CPU, at the golden-image
    tolerance; the Renderer's first MEGAKERNEL frame is the same sample."""
    host = procedural.cornell_box(resolution=(32, 32), spheres=True)
    data = host.build(with_bvh=True, packet_arity=arity, device=cuda)
    cfg = RenderConfig(backend=RayCastBackend.BVH_PALLAS, trace_depth=3)
    names = (("packet_closest_hit", "packet_any_hit") if arity == 2 else
             ("packet_closest_hit_wide", "packet_any_hit_wide"))
    before = dict(pt.LAUNCHES)
    rc = common.make_raycaster(data, cfg)
    gpu = megakernel.render(data, host.camera, cfg, iterations=2,
                            raycaster=rc)
    assert all(pt.LAUNCHES[k] == before[k] + 6 for k in names)
    cpu = megakernel.render(
        host.build(with_bvh=True, packet_arity=arity, device="cpu"),
        host.camera, cfg, iterations=2)
    assert int(rc.capped) == 0
    assert np.isfinite(gpu).all() and gpu.mean() > 0.01
    assert np.isclose(gpu, cpu, atol=5e-3, rtol=1e-3).mean() > 0.97
    np.testing.assert_allclose(gpu.mean(), cpu.mean(), rtol=0.02)
    r = Renderer(data, host.camera, cfg.with_(mode=RenderMode.MEGAKERNEL))
    np.testing.assert_array_equal(
        r.frame(), megakernel.render(data, host.camera, cfg, iterations=1))


# ---------------------------------------------------------------------------
# The hero scene: textured, normal-mapped, env-lit shading on the card
# ---------------------------------------------------------------------------

HERO_RES = (48, 27)


@pytest.fixture(scope="module")
def hero(cuda, tmp_path_factory):
    """scenes/hero.json with its textures written by the port, loaded by
    the port's loader, at 48x27 on the card."""
    from tpt_torch.core.camera import Camera
    from tpt_torch.scene import hero_assets, loader

    d = tmp_path_factory.mktemp("hero")
    host = loader.load_scene(hero_assets.write_hero_assets(str(d)))
    c = host.camera
    host.camera = Camera.build(HERO_RES, c.position, c.look_at, c.up,
                               c.fovy_deg)
    return host, host.build(with_bvh=True, device=cuda)


def _hero_cfg(**kw):
    return RenderConfig(backend=RayCastBackend.BVH_PALLAS, trace_depth=4,
                        env_nee=True).with_(**kw)


def test_hero_casts_equal_plain(hero, cuda):
    """K2 and K1 on every cast of the hero's bounces 0-2 (extension rays,
    light and env NEE shadow rays) against their plain versions, bit for
    bit, with no capped ray."""
    host, data = hero
    cfg = _hero_cfg()
    ext, shadow = [], []
    inner = common.make_raycaster(data, cfg)
    rc = replace(inner,
                 closest_hit=lambda o, d, t=None: (ext.append((o, d, t)),
                                                   inner.closest_hit(o, d, t))[1],
                 any_hit=lambda o, d, t: (shadow.append((o, d, t)),
                                          inner.any_hit(o, d, t))[1])
    vp = wavefront.camera_view_proj(host.camera)
    carry = wavefront.batched_raygen(host.camera, cfg, 1, cuda)
    for depth in range(3):
        carry = wavefront._bounce_body(data, rc, host.camera, cfg, vp, vp,
                                       depth, carry)
    assert len(ext) == 3 and len(shadow) == 6
    for rays in ext:
        got, cap_k = pt.packet_closest_hit_wide(data.pack, *rays)
        want, cap_p = pt.closest_hit_wide_plain(data.pack, *rays)
        for f in ("t", "tri", "u", "v"):
            assert torch.equal(getattr(got, f), getattr(want, f)), f
        assert int(cap_k) == int(cap_p) == 0
    for rays in shadow:
        got, cap_k = pt.packet_any_hit_wide(data.pack, *rays)
        want, cap_p = pt.any_hit_wide_plain(data.pack, *rays)
        assert torch.equal(got, want) and int(cap_k) == int(cap_p) == 0
    assert int(inner.capped) == 0


@pytest.mark.parametrize("integrator", ["wavefront", "megakernel",
                                        "denoised"])
def test_hero_render_kernels_equal_plain(hero, cuda, monkeypatch, integrator):
    """The hero through the kernels (K2/K1, and K6/K5 denoised) and
    through their plain versions on the card: bit-equal images."""
    host, data = hero
    cfg = _hero_cfg(denoiser_on=integrator == "denoised")

    def run():
        if integrator == "denoised":
            r = Renderer(data, host.camera, cfg)
            return [r.frame() for _ in range(3)]
        engine = wavefront if integrator == "wavefront" else megakernel
        return [engine.render(data, host.camera, cfg, iterations=2)]

    before = dict(pt.LAUNCHES)
    img_k = run()
    assert pt.LAUNCHES["packet_closest_hit_wide"] > \
        before["packet_closest_hit_wide"]
    assert pt.LAUNCHES["packet_any_hit_wide"] > before["packet_any_hit_wide"]
    monkeypatch.setattr(pt, "packet_closest_hit_wide",
                        pt.closest_hit_wide_plain)
    monkeypatch.setattr(pt, "packet_any_hit_wide", pt.any_hit_wide_plain)
    monkeypatch.setattr(stencil, "atrous", stencil.atrous_plain)
    monkeypatch.setattr(stencil, "atrous_passes", stencil.atrous_passes_plain)
    monkeypatch.setattr(reproject, "reproject", svgf._reproject_taps)
    img_p = run()
    for a, b in zip(img_k, img_p):
        assert np.isfinite(a).all() and a.mean() > 0.01
        np.testing.assert_array_equal(a, b)


def test_hero_on_card_matches_cpu(hero, cuda):
    """The textured, env-lit hero render on the card against the same
    render on the CPU, at the golden-image tolerance (texture and env
    lookups go through the card's pow, acos and atan2)."""
    host, data = hero
    cfg = _hero_cfg()
    gpu = wavefront.render(data, host.camera, cfg, iterations=2)
    cpu = wavefront.render(host.build(with_bvh=True, device="cpu"),
                           host.camera, cfg, iterations=2)
    assert np.isclose(gpu, cpu, atol=5e-3, rtol=1e-3).mean() > 0.97
    np.testing.assert_allclose(gpu.mean(), cpu.mean(), rtol=0.02)


def test_hero_sweep_frame_on_card(hero, cuda):
    """BVH_SWEEP on the hero (its floor is a flat group at y = 0): K3, K4
    and the K2 tail launched, no capped ray, and the image of the
    BVH_PALLAS render of the same iteration at the golden tolerance."""
    host, data = hero
    cfg = _hero_cfg(backend=RayCastBackend.BVH_SWEEP)
    before = dict(sw.LAUNCHES)
    rc = common.make_raycaster(data, cfg)
    img = wavefront.render(data, host.camera, cfg, iterations=1, raycaster=rc)
    assert sw.LAUNCHES["dense_scan"] == before["dense_scan"] + 3
    assert sw.LAUNCHES["sweep8_closest_hit"] == \
        before["sweep8_closest_hit"] + 3
    assert int(rc.capped) == 0
    ref = wavefront.render(data, host.camera, _hero_cfg(), iterations=1)
    assert np.isclose(img, ref, atol=5e-3, rtol=1e-3).mean() > 0.97
    np.testing.assert_allclose(img.mean(), ref.mean(), rtol=0.02)


# ---- the LBVH builder, BVH_XLA and the CLI on the card -----------------

def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint32) if a.dtype == np.float32 else a


def test_lbvh_on_card_equals_cpu_build(cuda):
    """The LBVH built on the card equals the CPU build of the same mesh,
    every array bit for bit, and validates."""
    from tpt_torch.bvh.build import build_lbvh
    from tpt_torch.bvh.validate import validate_lbvh

    host = procedural.fireplace_like(num_triangles=20_000, resolution=(16, 16))
    got = build_lbvh(host.build(device=cuda).mesh)
    want = build_lbvh(host.build(device="cpu").mesh)
    assert got.device.type == "cuda"
    g, w = got.numpy(), want.numpy()
    assert g.pop("num_triangles") == w.pop("num_triangles") == \
        host.mesh.num_triangles
    for k in w:
        np.testing.assert_array_equal(_bits(g[k]), _bits(w[k]), err_msg=k)
    assert validate_lbvh(got).ok


@pytest.mark.parametrize("builder", ["sah", "lbvh"])
def test_bvh_xla_on_card_equals_cpu(cuda, builder):
    """BVH_XLA's closest hit, any hit and traversal cost on the card
    against the port's CPU walk on the same rays and tree, bit for bit:
    the walk is separate float32 operations, each exactly rounded."""
    from tpt_torch.bvh import traverse

    host = procedural.cornell_box(resolution=(16, 16))
    gpu = host.build(with_bvh=True, bvh_builder=builder, device=cuda)
    cpu = host.build(with_bvh=True, bvh_builder=builder, device="cpu")
    rays = [_rays(8192, [0, 0, 0], [556, 548, 560], 21, dev)
            for dev in (cuda, "cpu")]
    t_max = torch.rand(8192, generator=torch.Generator().manual_seed(3)) * 600
    out = []
    for data, (o, d) in zip((gpu, cpu), rays):
        hit, cap = traverse.bvh_closest_hit(data.mesh, data.bvh, o, d)
        occ, _ = traverse.bvh_any_hit(data.mesh, data.bvh, o, d,
                                      t_max.to(o.device))
        cost = traverse.traversal_cost(data.mesh, data.bvh, o, d)
        out.append([x.cpu().numpy() for x in (hit.t, hit.tri, hit.u, hit.v,
                                             occ, cost)] + [int(cap)])
    for a, b in zip(*out):
        np.testing.assert_array_equal(_bits(np.asarray(a)),
                                      _bits(np.asarray(b)))
    assert out[0][-1] == 0


def test_cli_hero_on_card_matches_golden(cuda, tmp_path):
    """tpt_torch.cli on the card at tests/test_hero.py's settings against
    tests/golden_hero_120x68.npz, at that test's tolerance."""
    import json
    import os

    from tpt_torch.cli import main
    from tpt_torch.io.image import read_png
    from tpt_torch.scene import hero_assets

    path = hero_assets.write_hero_assets(str(tmp_path))
    with open(path) as f:
        doc = json.load(f)
    doc["Camera"].update(RES=[120, 68], ITERATIONS=3, DEPTH=4)
    small = tmp_path / "hero_small.json"
    small.write_text(json.dumps(doc))
    before = dict(stencil.LAUNCHES)
    rc = main([str(small), "-wave", "--backend", "bvh", "--denoise",
               "--env-nee", "--out-dir", str(tmp_path / "out")])
    assert rc == 0
    assert stencil.LAUNCHES["atrous"] == before["atrous"] + 15
    (png,) = [f for f in os.listdir(tmp_path / "out") if f.endswith(".png")]
    img = read_png(str(tmp_path / "out" / png))[..., :3] / np.float32(255.0)
    golden = np.load(os.path.join(os.path.dirname(__file__),
                                  "golden_hero_120x68.npz"))["image"]
    assert np.isclose(img, golden, atol=2 / 255.0).mean() > 0.97
    np.testing.assert_allclose(img.mean(), golden.mean(), rtol=0.02)
