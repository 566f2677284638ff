"""tpt_torch's CUDA kernels (K2 closest hit, K1 any hit) on the card.

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
from tpt_torch.config import RayCastBackend, RenderConfig
from tpt_torch.core.vec import Vec3
from tpt_torch.integrators import common, intersect, wavefront
from tpt_torch.scene import procedural

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
