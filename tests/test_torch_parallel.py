"""tpt_torch.parallel on the CPU: the sharded render in 2 and 4 gloo
processes against the port's one-process render, bit for bit (floats as
bit patterns), including SVGF over row windows with the history carried;
the sharded images against tpt's `render_sharded` on the conftest's
virtual CPU mesh at tests/test_torch_render.py's tolerance; the
refusals; and the dry run.

The ranks run in `tests/torch_parallel_workers.py` (numpy, torch and
tpt_torch only), spawned once per world size for all of its cases.
tpt's sharded images are stored in tests/golden_parallel_tpt.npz
(its SVGF render compiles for ~40 s on this CPU); regenerate with
`JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/test_torch_parallel.py`.
"""

import os

import numpy as np
import pytest
import torch

import torch_parallel_workers as W
from tpt_torch.config import SVGFConfig
from tpt_torch.parallel import halo, sharding
from tpt_torch.parallel.dryrun import dryrun_multichip

from torch_port_helpers import torch_threads  # noqa: F401  (autouse)

HERE = os.path.dirname(__file__)
GOLDEN = os.path.join(HERE, "golden_parallel_tpt.npz")

WORLD4 = ("brute_force", "brute_force_svgf", "sweep", "svgf_sequence",
          "svgf_sequence_short_reach", "svgf_sequence_subgroup",
          "refuse_rows")
WORLD2 = ("pallas_sorted", "sweep", "cascade", "treelet", "refuse_spp_batch",
          "refuse_tables")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case's rank-0 result by (world, name): one spawn per world."""
    out = {}
    for world, names in ((4, WORLD4), (2, WORLD2)):
        d = str(tmp_path_factory.mktemp(f"world{world}"))
        for name, res in W.run_ranks(world, names, d).items():
            out[world, name] = res
    return out


def _result(ranks, world, name):
    res = ranks[world, name]
    assert "crash" not in res, res["crash"]
    return res


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


@pytest.mark.parametrize("world,name", [
    (4, "brute_force"),      # tests/test_parallel.py:25-33
    (2, "pallas_sorted"),    # :46-66, the sorted pool
    (2, "sweep"),            # :68-95, sweep_unroll 8, chunk_align 8
    (4, "sweep"),
    (2, "cascade"),          # :97-115
])
def test_sharded_render_equals_one_process(ranks, world, name):
    """Each rank renders its rows on its own pool (sort and unsort local
    to it); the gathered image is the one-process render bit for bit."""
    res = _result(ranks, world, name)
    ref = W.reference(name)
    _bits_equal(res["image"], ref["image"])
    assert res["capped"] == ref["capped"] == 0


def test_render_sharded_entry_point(ranks):
    res = _result(ranks, 4, "brute_force")
    _bits_equal(res["image_render_sharded"], res["image"])


@pytest.mark.parametrize("name", ["svgf_sequence", "svgf_sequence_short_reach",
                                  "svgf_sequence_subgroup"])
def test_svgf_row_windows_equal_one_process(ranks, name):
    """Four denoised frames with the history carried: three turning 3 px,
    then a 24-px tilt. Every frame's rgb and all 18 state leaves equal
    the one-process run_svgf sequence, and the summed rays its count. At
    4 ranks of 16 (15) rows, windows span several ranks, and the tilt's
    motion exceeds a rank's rows. The subgroup case renders on global
    ranks 1-3 of the 4 (a process group that is not the default one, its
    peers' global ranks not their group ranks), 16 rows each."""
    res = _result(ranks, 4, name)
    cfg, (w, h) = W.SEQUENCES[name]
    ref = W.reference(name)
    for k in range(len(W.SEQ_TURNS)):
        _bits_equal(res["images"][k], ref["images"][k])
        for leaf, want in zip(res["leaves"][k], ref["leaves"][k]):
            _bits_equal(leaf, want)
    assert res["rays"] == ref["rays"]
    nranks = len(W.SUBGROUP) if name.endswith("_subgroup") else 4
    assert len(res["windows"][0]) == nranks
    rows = h // nranks
    R = halo.svgf_reach(cfg.svgf)
    for wins in res["windows"]:
        assert all(r == R for (_, _, _, r) in wins)
    last = res["windows"][-1]
    assert last[0][2] > rows                    # M, the tilt's motion
    # windows reaching past a neighbour, and windows not at the top edge
    assert any(a < (q - 1) * rows or b > (q + 2) * rows
               for q, (a, b, _, _) in enumerate(last))
    assert any(a > 0 for wins in res["windows"] for (a, _, _, _) in wins)


def test_treelet_sharded_equals_one_process(ranks):
    """BVH_TREELET packs each rank's rays into its own packets, so K10's
    equal-t ties may differ from the one-process packets in general (not
    part of the bitwise claim); on this scene and shape the image is the
    same bit for bit, which this pins."""
    res = _result(ranks, 2, "treelet")
    ref = W.reference("treelet")
    _bits_equal(res["image"], ref["image"])
    assert res["capped"] == ref["capped"] == 0


@pytest.mark.parametrize("world,name,error,words", [
    (2, "refuse_spp_batch", "ValueError", "spp_batch=2"),
    (4, "refuse_rows", "ValueError", "66 rows"),
    (2, "refuse_tables", "ValueError", "differ"),
])
def test_refusals(ranks, world, name, error, words):
    res = _result(ranks, world, name)
    assert res["error"] == error and words in res["message"], res


def _agree(img, golden, atol=5e-3):
    """tests/test_torch_render.py:_agree."""
    assert img.shape == golden.shape
    close = np.isclose(img, golden, atol=atol, rtol=1e-3).mean()
    assert close > 0.97, (close, float(np.abs(img - golden).max()))
    np.testing.assert_allclose(img.mean(), golden.mean(), rtol=0.02)


@pytest.mark.parametrize("name", ["brute_force", "brute_force_svgf"])
def test_sharded_matches_tpt(ranks, name):
    """The sharded image against tpt's render_sharded of the same scene
    and configuration (BRUTE_FORCE, 64x64, depth 3, 2 iterations; the
    denoised one its last frame) on 8 virtual CPU devices."""
    img = _result(ranks, 4, name)["image"]
    assert np.isfinite(img).all()
    _agree(img, np.load(GOLDEN)[name])


def test_rebase_motion_v_is_exact():
    """y - rebased mv equals fl(Y - mv) - a bit for bit wherever the taps
    lie in the window (Y >= a + M), for motion up to M px at a
    non-power-of-two scale."""
    rs = np.random.default_rng(3)
    for a, M in ((1, 1), (7, 3), (500, 40), (1037, 700)):
        hw = 2 * M + 64
        mv = torch.from_numpy(
            (rs.uniform(-M, M, (hw, 8)) * rs.choice([1.0, 1 / 1080.0, 1e-6],
                                                    (hw, 8))
             ).astype(np.float32))
        mv[0, 0], mv[-1, -1] = float(M), -float(M)
        Y = torch.arange(a, a + hw, dtype=torch.float32)[:, None]
        y = torch.arange(hw, dtype=torch.float32)[:, None]
        got = y - halo.rebase_motion_v(mv, a)
        want = (Y - mv) - a
        ok = (Y >= a + M).expand_as(mv)
        assert torch.equal(got[ok].view(torch.int32), want[ok].view(torch.int32))
        assert not torch.equal(y - mv, want)     # the local rounding differs


def test_reach_and_windows():
    assert halo.svgf_reach(SVGFConfig()) == 35
    assert halo.svgf_reach(SVGFConfig(atrous_iterations=2)) == 7
    assert halo.windows(64, 4, 10) == [(0, 26), (6, 42), (22, 58), (38, 64)]
    assert halo.windows(1080, 2, 40) == [(0, 580), (500, 1080)]


def test_make_pixel_mesh_needs_a_group():
    with pytest.raises(RuntimeError, match="init_process_group"):
        sharding.make_pixel_mesh(device="cpu")


def test_dryrun_multichip(capfd):
    dryrun_multichip(4, device="cpu")
    assert "[dryrun_multichip] ok: 4 gloo ranks on cpu, image (64, 64, 3)" \
        in capfd.readouterr().out


def tpt_references() -> dict:
    """tpt's render_sharded images of the WORLD4 renders' configuration."""
    import jax
    import tpt
    from tpt.parallel.sharding import make_pixel_mesh, render_sharded
    from tpt.scene import procedural as jproc

    out = {}
    mesh = make_pixel_mesh(jax.devices()[:8])
    for name in ("brute_force", "brute_force_svgf"):
        (res, spheres, _), cfg, iters, with_svgf = W.RENDERS[name]
        host = jproc.cornell_box(resolution=res, spheres=spheres)
        jcfg = tpt.RenderConfig(backend=tpt.RayCastBackend.BRUTE_FORCE,
                                trace_depth=cfg.trace_depth,
                                denoiser_on=cfg.denoiser_on)
        out[name] = np.asarray(render_sharded(
            host.build(), host.camera, jcfg, mesh=mesh, iterations=iters,
            with_svgf=with_svgf), np.float32)
    return out


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/test_torch_parallel.py
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")
    np.savez_compressed(GOLDEN, **tpt_references())
