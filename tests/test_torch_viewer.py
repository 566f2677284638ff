"""tpt_torch's viewers (`viewer.py`, `term_viewer.py`), as
tests/test_term_viewer.py holds tpt's: the ANSI half-block frame and the
key decoder equal tpt's, a scripted terminal session drives the port's
Renderer headless (frames, quit, a move through the preview engine, a
look, a save and a channel key), the camera rig's yaw/pitch round trip
equals tpt's, the headless viewer writes PNG snapshots, and asking for a
window where matplotlib is missing raises instead of pretending to show
one (the GPU machine has no matplotlib)."""

import io
import sys

import numpy as np
import pytest

from tpt_torch import Renderer
from tpt_torch.config import RayCastBackend, RenderConfig
from tpt_torch.scene import procedural
from tpt_torch.term_viewer import (_KeyReader, _downsample, ansi_frame,
                                   run_term_viewer)
from tpt_torch.viewer import (make_preview_renderer, run_viewer,
                              view_from_yaw_pitch, yaw_pitch_from_view)

from torch_port_helpers import torch_threads  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def cornell():
    scene = procedural.cornell_box(resolution=(32, 32), spheres=False)
    return scene, scene.build(device="cpu")


def _renderer(cornell, depth=2):
    scene, data = cornell
    cfg = RenderConfig(backend=RayCastBackend.BRUTE_FORCE, trace_depth=depth)
    return Renderer(data, scene.camera, cfg)


@pytest.mark.parametrize("shape, cells", [((2, 2), (2, 1)), ((64, 48), (24, 10)),
                                          ((8, 8), (20, 12))])
def test_ansi_frame_equals_tpt(shape, cells):
    from tpt.term_viewer import ansi_frame as jansi

    img = np.random.default_rng(1).random(shape + (3,)).astype(np.float32)
    assert ansi_frame(img, *cells) == jansi(img, *cells)
    u8 = (img * 255).astype(np.uint8)
    assert ansi_frame(u8, *cells) == jansi(u8, *cells)


def test_ansi_frame_colors_and_runs():
    img = np.array([[[1.0, 0, 0], [0, 1.0, 0]],
                    [[0, 0, 1.0], [1.0, 1.0, 1.0]]], np.float32)
    s = ansi_frame(img, cols=2, rows=1, gamma=1.0)
    assert s.count("▀") == 2
    assert "\x1b[38;2;255;0;0m" in s and "\x1b[48;2;0;0;255m" in s
    white = ansi_frame(np.ones((2, 8, 3), np.float32), cols=8, rows=1, gamma=1.0)
    assert white.count("\x1b[38;2;") == 1 and white.count("\x1b[48;2;") == 1


def test_downsample_equals_tpt():
    from tpt.term_viewer import _downsample as jdown

    img = np.random.default_rng(0).random((64, 48, 3)).astype(np.float32)
    for h, w in ((16, 12), (128, 96)):
        np.testing.assert_array_equal(_downsample(img, h, w), jdown(img, h, w))


@pytest.mark.parametrize("chunks", [[b"wq"], [b"\x1b[A\x1b[D"],
                                    [b"\x1b", b"[", b"C"], [b"\x1bzw"]])
def test_key_reader_equals_tpt(chunks):
    from tpt.term_viewer import _KeyReader as JReader

    mine, theirs = _KeyReader(), JReader()
    for c in chunks:
        assert mine.feed(c) == theirs.feed(c)


def test_yaw_pitch_equal_tpt():
    from tpt import viewer as jviewer

    for view in [(0.0, 0.0, 1.0), (0.6, 0.0, -0.8), (0.0, 0.6, 0.8),
                 (-0.48, -0.6, 0.64)]:
        assert yaw_pitch_from_view(view) == jviewer.yaw_pitch_from_view(view)
    assert view_from_yaw_pitch(30.0, -10.0) == \
        jviewer.view_from_yaw_pitch(30.0, -10.0)


def test_session_renders_max_frames(cornell, tmp_path):
    r = _renderer(cornell)
    out = io.StringIO()
    n = run_term_viewer(r, max_frames=2, out_dir=str(tmp_path),
                        preview_scale=1, in_stream=io.BytesIO(b""),
                        out_stream=out, size=(64, 8))
    assert n == 2
    s = out.getvalue()
    assert s.count("\x1b[H") == 2 and "▀" in s and "MRays/s" in s


def test_quit_key_stops_immediately(cornell, tmp_path):
    n = run_term_viewer(_renderer(cornell), max_frames=5,
                        out_dir=str(tmp_path), preview_scale=1,
                        in_stream=io.BytesIO(b"q"), out_stream=io.StringIO(),
                        size=(16, 8))
    assert n == 0


def test_move_key_moves_camera_and_uses_preview(cornell, tmp_path):
    r = _renderer(cornell)
    pos0 = np.asarray(r.cam.position)
    out = io.StringIO()
    n = run_term_viewer(r, max_frames=2, out_dir=str(tmp_path),
                        preview_scale=2, in_stream=io.BytesIO(b"w"),
                        out_stream=out, size=(64, 8))
    assert n == 2
    assert not np.allclose(np.asarray(r.cam.position), pos0)
    assert "preview" in out.getvalue()


def test_look_key_rotates_view(cornell, tmp_path):
    r = _renderer(cornell)
    view0 = np.asarray(r.cam.view)
    run_term_viewer(r, max_frames=1, out_dir=str(tmp_path), preview_scale=1,
                    in_stream=io.BytesIO(b"\x1b[C"), out_stream=io.StringIO(),
                    size=(16, 8))
    assert not np.allclose(np.asarray(r.cam.view), view0)


def test_save_and_channel_keys(cornell, tmp_path):
    r = _renderer(cornell)
    run_term_viewer(r, max_frames=1, out_dir=str(tmp_path), preview_scale=1,
                    in_stream=io.BytesIO(b"2s"), out_stream=io.StringIO(),
                    size=(16, 8))
    assert (tmp_path / "viewer_save.png").exists()
    assert int(r.gui.display_mode) == 1


def test_preview_renderer(cornell):
    from tpt_torch.config import RenderMode

    r = _renderer(cornell, depth=4)
    p = make_preview_renderer(r, 4, mode=RenderMode.MEGAKERNEL, nav_depth=2)
    assert p.cam.resolution == (16, 16) and p.display_u8
    assert p.cfg.mode == RenderMode.MEGAKERNEL and p.cfg.trace_depth == 2
    img = p.frame()
    assert img.dtype == np.uint8 and img.shape == (16, 16, 3)


def test_headless_viewer_writes_snapshots(cornell, tmp_path, capsys):
    r = _renderer(cornell)
    run_viewer(r, max_frames=2, out_dir=str(tmp_path), snapshot_every=1,
               interactive=False)
    assert (tmp_path / "preview.png").exists()
    assert capsys.readouterr().out.count("[viewer] frame") == 2


def test_window_without_matplotlib_raises(cornell, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(RuntimeError, match="matplotlib"):
        run_viewer(_renderer(cornell), max_frames=1, out_dir=str(tmp_path),
                   interactive=True)
