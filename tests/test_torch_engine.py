"""The port's engine (tpt_torch.engine.Renderer) against tpt's on the CPU:
the real-time denoised frame (a 1-spp wavefront frame, then SVGF) with a
camera move, the display channels, and a tpt checkpoint resumed in the
port.

Both renderers run Cornell 24x24 without spheres, BRUTE_FORCE, depth 2.
tpt's SVGF runs its XLA formulation (use_pallas_* off), the function the
port computes (tests/test_torch_svgf.py). Frames are held at
tests/test_golden.py:33-39's tolerance (the port's camera rays differ from
tpt's by up to 2 ulp, and its exp/pow by about 1 ulp; measured max abs
3.2e-5 on such a sequence); the resumed SVGF history exactly.

tpt's renderer compiles its frame and SVGF programs twice here (~17 s),
more than the suite can spend, so its frames are stored in
tests/golden_engine_tpt_24.npz and the checkpoint it wrote after frame 3
in tests/golden_engine_checkpoint_24.npz, both written by
`JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_engine.py`.
"""

import os

import numpy as np
import pytest
import torch
from tpt_torch import Renderer
from tpt_torch.config import (DisplayMode, RayCastBackend, RenderConfig,
                              RenderMode)
from tpt_torch.denoise import svgf
from tpt_torch.integrators import common, wavefront
from tpt_torch.scene import procedural as tproc

from torch_port_helpers import torch_threads  # noqa: F401  (autouse)

HERE = os.path.dirname(__file__)
GOLDEN = os.path.join(HERE, "golden_engine_tpt_24.npz")
CHECKPOINT = os.path.join(HERE, "golden_engine_checkpoint_24.npz")
RES = (24, 24)
MOVED = (280.0, 273.0, -790.0)      # a small step of the camera
MOVED2 = (283.0, 271.0, -785.0)
MODES = (DisplayMode.MOTION_VECTOR, DisplayMode.RESULT, DisplayMode.NORMAL,
         DisplayMode.DEPTH, DisplayMode.ALBEDO)
CFG = RenderConfig(backend=RayCastBackend.BRUTE_FORCE, trace_depth=2,
                   denoiser_on=True)


def _agree(img, ref):
    """tests/test_golden.py:_compare_or_write's tolerance."""
    assert img.shape == ref.shape and np.isfinite(img).all()
    close = np.isclose(img, ref, atol=5e-3, rtol=1e-3).mean()
    assert close > 0.97, (close, float(np.abs(img - ref).max()))
    np.testing.assert_allclose(img.mean(), ref.mean(), rtol=0.02)


def sequence(r, cam, save=None):
    """3 denoised frames, a checkpoint, a 4th frame on that history, a
    camera move (which, in tpt's engine, also clears the SVGF history),
    2 more frames; then another move and one frame of each display
    channel, denoiser off."""
    frames = [r.frame() for _ in range(3)]
    if save is not None:
        r.save_checkpoint(str(save))
    frames.append(r.frame())
    r.move_camera(cam.moved(position=MOVED))
    frames += [r.frame() for _ in range(2)]
    r.move_camera(cam.moved(position=MOVED2))
    r.gui.denoiser_on = False
    modes = {}
    for mode in MODES:
        r.gui.display_mode = mode
        modes[mode] = r.frame()
    return frames, modes


def tpt_sequence():
    """tpt's renderer through `sequence`, writing its checkpoint to
    CHECKPOINT: returns (frames, display modes)."""
    import tpt
    from tpt.config import SVGFConfig as JSVGFConfig
    from tpt.engine import Renderer as JRenderer
    from tpt.scene import procedural as jproc

    host = jproc.cornell_box(resolution=RES, spheres=False)
    cfg = tpt.RenderConfig(backend=tpt.RayCastBackend.BRUTE_FORCE,
                           trace_depth=2, denoiser_on=True,
                           svgf=JSVGFConfig(use_pallas_atrous=False,
                                            use_pallas_reproject=False))
    return sequence(JRenderer(host.build(), host.camera, cfg), host.camera,
                    save=CHECKPOINT)


@pytest.fixture(scope="module")
def tpt_run():
    """tpt's stored frames, display modes and checkpoint path."""
    with np.load(GOLDEN) as g:
        return (list(g["frames"]), {m: g[f"mode_{m.name}"] for m in MODES},
                CHECKPOINT)


@pytest.fixture(scope="module")
def cornell():
    host = tproc.cornell_box(resolution=RES, spheres=False)
    return host, host.build(device="cpu")


@pytest.fixture(scope="module")
def port_run(cornell):
    host, data = cornell
    return sequence(Renderer(data, host.camera, CFG), host.camera)


def test_denoised_frames_match_tpt(tpt_run, port_run):
    assert len(port_run[0]) == len(tpt_run[0]) == 6
    for got, want in zip(port_run[0], tpt_run[0]):
        _agree(got, want)
    # the move changed the view: frames differ
    assert np.abs(port_run[0][4] - port_run[0][3]).max() > 1e-3


@pytest.mark.parametrize("mode", MODES, ids=lambda m: m.name)
def test_display_modes_match_tpt(tpt_run, port_run, mode):
    got, want = port_run[1][mode], tpt_run[1][mode]
    assert got.shape == (RES[1], RES[0], 3) and got.dtype == np.float32
    _agree(got, want)
    if mode == DisplayMode.MOTION_VECTOR:
        assert got.max() > 0.01       # the move gave motion vectors


def test_tpt_checkpoint_resumes(tpt_run, cornell):
    """A checkpoint written by tpt's Renderer after 3 frames loads into the
    port with the same SVGF history; the next frame, on that history,
    and the two after the same camera move agree with tpt's."""
    host, data = cornell
    r = Renderer(data, host.camera, CFG)
    r.load_checkpoint(str(tpt_run[2]))
    assert r.iteration == 3
    with np.load(tpt_run[2]) as ck:
        for i, leaf in enumerate(r.svgf_state.leaves()):
            np.testing.assert_array_equal(leaf.numpy(), ck[f"svgf_{i}"])
        np.testing.assert_array_equal(r.acc_direct.y.numpy(), ck["acc_direct_1"])
    assert int(r.svgf_state.history_len.max()) == 2   # frames 2 and 3
    _agree(r.frame(), tpt_run[0][3])
    assert int(r.svgf_state.history_len.max()) == 3   # the history went on
    r.move_camera(host.camera.moved(position=MOVED))
    for want in tpt_run[0][4:6]:
        _agree(r.frame(), want)
    assert int(r.svgf_state.history_len.max()) == 1   # the move cleared it


def test_own_checkpoint_round_trip(cornell, tmp_path):
    host, data = cornell
    a = Renderer(data, host.camera, CFG)
    a.frame()
    a.frame()
    a.save_checkpoint(str(tmp_path / "ck.npz"))
    b = Renderer(data, host.camera, CFG)
    b.load_checkpoint(str(tmp_path / "ck.npz"))
    assert b.iteration == a.iteration == 2
    np.testing.assert_array_equal(b.frame(), a.frame())
    small = tproc.cornell_box(resolution=(16, 16), spheres=False)
    c = Renderer(small.build(device="cpu"), small.camera, CFG)
    with pytest.raises(ValueError):
        c.load_checkpoint(str(tmp_path / "ck.npz"))


def test_u8_pipeline_and_gui(cornell):
    host, data = cornell
    plain = Renderer(data, host.camera, CFG)
    f = [plain.frame() for _ in range(3)]
    assert plain.gui.traced_depth == 2 and plain.gui.frame_ms > 0 \
        and plain.gui.mrays_per_sec > 0
    u8 = Renderer(data, host.camera, CFG)
    u8.display_u8 = True
    img = u8.frame()
    want = (torch.clamp(torch.from_numpy(f[0]), 0, 1) ** (1 / 2.2) * 255.0
            + 0.5).to(torch.uint8).numpy()
    assert img.dtype == np.uint8
    np.testing.assert_array_equal(img, want)
    piped = Renderer(data, host.camera, CFG)
    piped.pipeline = True
    got = [piped.frame() for _ in range(3)]
    for g, w_ in zip(got, (f[0], f[0], f[1])):
        np.testing.assert_array_equal(g, w_)


def test_unported_modes_raise(cornell):
    host, data = cornell
    # the megakernel mode renders now (tests/test_torch_megakernel.py);
    # options it lacks still raise
    mega = CFG.with_(mode=RenderMode.MEGAKERNEL)
    with pytest.raises(NotImplementedError, match="item 6"):
        Renderer(data, host.camera, mega.with_(backend=RayCastBackend.BVH_SWEEP))
    with pytest.raises(NotImplementedError, match="heavy_shading_iters"):
        Renderer(data, host.camera, mega.with_(heavy_shading_iters=4))
    with pytest.raises(NotImplementedError, match="item 6"):
        Renderer(data, host.camera, CFG.with_(backend=RayCastBackend.BVH_XLA))
    r = Renderer(data, host.camera,
                 CFG.with_(denoiser_on=False, display=DisplayMode.BVH_HEATMAP))
    with pytest.raises(NotImplementedError, match="traversal_cost"):
        r.frame()
    with pytest.raises(NotImplementedError):
        r.bvh_heatmap()


def test_denoiser_sees_the_spp_batch_sum(cornell, monkeypatch):
    """A behaviour of tpt that the port keeps: with denoiser_on and
    spp_batch S, the frame hands SVGF the per-pixel sum of its S samples
    (tpt/integrators/wavefront.py:614-623, tpt/engine.py:194-195), so the
    denoised image scales with S."""
    host, data = cornell
    seen = []
    run = svgf.run_svgf

    def spy(cfg, state, raw_direct, *rest):
        seen.append(raw_direct.x.reshape(-1).clone())
        return run(cfg, state, raw_direct, *rest)

    monkeypatch.setattr(svgf, "run_svgf", spy)
    Renderer(data, host.camera, CFG.with_(spp_batch=2)).frame()
    rc = common.make_raycaster(data, CFG)
    one = [wavefront.trace_frame(data, rc, host.camera, CFG, it).direct.x
           for it in (1, 2)]
    np.testing.assert_array_equal(seen[0].numpy(), (one[0] + one[1]).numpy())


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_engine.py
    frames, modes = tpt_sequence()
    np.savez_compressed(GOLDEN, frames=np.stack(frames),
                        **{f"mode_{m.name}": modes[m] for m in MODES})
