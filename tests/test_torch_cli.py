"""tpt_torch's command line (`cli.py`), its OBJ writer (`io/objwriter.py`)
and its stage spans (`trace.py`, the counterpart of tpt's profiling
helpers), as tests/test_cli.py, tests/test_hero.py and
tests/test_profiling.py hold tpt's. Every run passes `--device cpu`
(without it the port asks for the CUDA card and raises here: there is
no silent fallback).

- The CLI on a tiny Cornell scene written by the port's OBJ writer:
  wavefront, `-mega`, `--backend bvh --depth 1`, `--warmup`, `-vis`;
  its argparser's flags, choices and defaults equal tpt's; `--backend
  auto` picks brute force under 4096 triangles and BVH_PALLAS above;
  the LBVH report prints for every BVH backend; the saved PNG is the
  Renderer's frame mirrored in x.
- tests/test_hero.py's render through `tpt_torch.cli.main` (120x68, 3
  iterations, depth 4, `--backend bvh --denoise --env-nee`) against
  tests/golden_hero_120x68.npz at that test's tolerance (> 97% of values
  within 2/255, means within 2%).
- The OBJ writer writes tpt's text, and the port's loader reads it back
  to the same triangles and materials.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

from tpt_torch.cli import build_argparser, main
from tpt_torch.io.image import read_png, tonemap
from tpt_torch.io.objwriter import write_obj
from tpt_torch.scene import hero_assets, procedural

from torch_port_helpers import torch_threads  # noqa: F401  (autouse)

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN_HERO = os.path.join(HERE, "golden_hero_120x68.npz")
CPU = ["--device", "cpu"]


def _doc(obj_file: str) -> dict:
    return {
        "Camera": {
            "RES": [24, 24], "FOVY": 39.3, "ITERATIONS": 2, "DEPTH": 2,
            "FILE": "out",
            "EYE": [278.0, 273.0, -800.0], "LOOKAT": [278.0, 273.0, 0.0],
            "UP": [0.0, 1.0, 0.0],
        },
        "Objects": [{"TRANS": [0, 0, 0], "ROTAT": [0, 0, 0],
                     "SCALE": [1, 1, 1], "FILE": obj_file}],
    }


@pytest.fixture(scope="module")
def tiny_scene(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    scene = procedural.cornell_box(resolution=(24, 24), spheres=False)
    write_obj(str(tmp / "box.obj"), scene.mesh, scene.materials)
    p = tmp / "scene.json"
    p.write_text(json.dumps(_doc("box.obj")))
    return str(p), tmp


def _pngs(d) -> list:
    return [f for f in os.listdir(d) if f.endswith(".png")]


def test_headless_wavefront(tiny_scene):
    path, tmp = tiny_scene
    rc = main([path, "-wave", "--backend", "brute",
               "--out-dir", str(tmp / "out")] + CPU)
    assert rc == 0
    pngs = _pngs(tmp / "out")
    assert len(pngs) == 1
    assert pngs[0].startswith("out.") and "2samp" in pngs[0]


def test_megakernel_flag(tiny_scene):
    path, tmp = tiny_scene
    rc = main([path, "-mega", "--backend", "brute", "--iterations", "1",
               "--out-dir", str(tmp / "mega")] + CPU)
    assert rc == 0 and len(_pngs(tmp / "mega")) == 1


def test_bvh_backend_and_depth_override(tiny_scene, capsys):
    path, tmp = tiny_scene
    rc = main([path, "--backend", "bvh", "--depth", "1", "--iterations", "1",
               "--out-dir", str(tmp / "bvh")] + CPU)
    assert rc == 0
    out = capsys.readouterr().out
    assert "backend=BVH_XLA" in out and "[Pass]" in out


def test_warmup_mode(tiny_scene, capsys):
    """--warmup runs two frames and exits without writing an image."""
    path, tmp = tiny_scene
    rc = main([path, "--warmup", "--backend", "brute",
               "--out-dir", str(tmp / "warm")] + CPU)
    assert rc == 0
    assert "cache populated" in capsys.readouterr().out
    assert not _pngs(tmp / "warm")


def test_vis_preview(tiny_scene):
    path, tmp = tiny_scene
    rc = main([path, "-vis", "--backend", "brute", "--iterations", "2",
               "--preview-every", "1", "--out-dir", str(tmp / "vis")] + CPU)
    assert rc == 0
    assert os.path.exists(tmp / "vis" / "out.preview.png")


def test_argparser_defaults_equal_tpt():
    from tpt.cli import build_argparser as jparser

    mine = build_argparser()
    theirs = jparser()
    assert vars(mine.parse_args(["scene.json"])) == dict(
        vars(theirs.parse_args(["scene.json"])), device=None)
    flags = lambda p: {a.dest: (a.option_strings, a.choices, a.default,
                                type(a).__name__) for a in p._actions
                       if a.dest not in ("help", "device")}
    assert flags(mine) == flags(theirs)
    args = mine.parse_args(["scene.json"])
    assert not args.mega and not args.vis and args.backend == "auto"


def test_no_device_means_the_card(tiny_scene):
    path, tmp = tiny_scene
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main([path, "--out-dir", str(tmp / "nodev")])


@pytest.mark.parametrize("tris, want", [(1000, "BRUTE_FORCE"),
                                        (5000, "BVH_PALLAS")])
def test_auto_backend_by_triangle_count(tmp_path, capsys, tris, want):
    host = procedural.fireplace_like(num_triangles=tris, resolution=(8, 8))
    write_obj(str(tmp_path / "room.obj"), host.mesh, host.materials)
    doc = _doc("room.obj")
    doc["Camera"].update(RES=[8, 8], ITERATIONS=1, DEPTH=1)
    p = tmp_path / "room.json"
    p.write_text(json.dumps(doc))
    assert main([str(p), "--out-dir", str(tmp_path / "o")] + CPU) == 0
    out = capsys.readouterr().out
    assert f"backend={want}" in out
    assert ("[tpt] LBVH:" in out) == (want != "BRUTE_FORCE")


@pytest.mark.parametrize("backend", ["pallas", "treelet", "sweep"])
def test_lbvh_report_for_every_bvh_backend(tiny_scene, capsys, backend):
    path, tmp = tiny_scene
    rc = main([path, "--backend", backend, "--iterations", "1", "--depth", "1",
               "--out-dir", str(tmp / backend)] + CPU)
    assert rc == 0
    assert "[tpt] LBVH:" in capsys.readouterr().out


def test_saved_image_is_the_frame_mirrored(tiny_scene):
    """The PNG is the Renderer's last frame mirrored in x and tonemapped,
    as tpt/cli.py saves it."""
    from tpt_torch import Renderer
    from tpt_torch.config import RayCastBackend, RenderConfig
    from tpt_torch.scene.loader import load_scene

    path, tmp = tiny_scene
    main([path, "--backend", "brute", "--iterations", "1",
          "--out-dir", str(tmp / "mirror")] + CPU)
    (png,) = _pngs(tmp / "mirror")
    saved = read_png(str(tmp / "mirror" / png))[..., :3]
    host = load_scene(path)
    cfg = RenderConfig(backend=RayCastBackend.BRUTE_FORCE, trace_depth=2,
                       iterations=1)
    img = Renderer(host.build(device="cpu"), host.camera, cfg).frame()
    np.testing.assert_array_equal(saved, tonemap(img[:, ::-1], cfg.gamma))
    assert not np.array_equal(saved, saved[:, ::-1])


def test_hero_through_cli_matches_golden(tmp_path):
    """tests/test_hero.py's render, through the port's CLI."""
    full = hero_assets.write_hero_assets(str(tmp_path))
    with open(full) as f:
        doc = json.load(f)
    doc["Camera"].update(RES=[120, 68], ITERATIONS=3, DEPTH=4)
    p = tmp_path / "hero_small.json"
    p.write_text(json.dumps(doc))
    out_dir = tmp_path / "out"
    rc = main([str(p), "-wave", "--backend", "bvh", "--denoise", "--env-nee",
               "--out-dir", str(out_dir)] + CPU)
    assert rc == 0
    (png,) = _pngs(out_dir)
    assert png.startswith("hero.")
    img = read_png(str(out_dir / png))[..., :3].astype(np.float32) / 255.0
    assert img.shape == (68, 120, 3)
    assert 0.03 < img.mean() < 0.9 and img.std() > 0.05
    golden = np.load(GOLDEN_HERO)["image"]
    close = np.isclose(img, golden, atol=2 / 255.0).mean()
    assert close > 0.97, (close, float(np.abs(img - golden).max()))
    np.testing.assert_allclose(img.mean(), golden.mean(), rtol=0.02)


def test_objwriter_writes_tpt_text(tmp_path):
    from tpt.io.objwriter import write_obj as jwrite
    from tpt.scene import procedural as jproc

    mine = procedural.cornell_box(resolution=(8, 8))
    theirs = jproc.cornell_box(resolution=(8, 8))
    write_obj(str(tmp_path / "a.obj"), mine.mesh, mine.materials)
    jwrite(str(tmp_path / "b.obj"), theirs.mesh, theirs.materials)
    for ext in (".obj", ".mtl"):
        a = (tmp_path / ("a" + ext)).read_text()
        b = (tmp_path / ("b" + ext)).read_text()
        assert a.replace("a.mtl", "b.mtl") == b


def test_objwriter_round_trip(tmp_path):
    """write_obj then the port's loader: the same triangles (to the
    writer's 6 decimals), each with its material's colour and emission."""
    from tpt_torch.scene.host import HostScene
    from tpt_torch.scene.obj import load_obj

    src = procedural.cornell_box(resolution=(8, 8))
    write_obj(str(tmp_path / "box.obj"), src.mesh, src.materials)
    scene = HostScene()
    mesh = load_obj(str(tmp_path / "box.obj"), scene)
    assert mesh.num_triangles == src.mesh.num_triangles
    corners = lambda m: m.positions[m.indices].reshape(m.num_triangles, 9)
    key = lambda c: np.lexsort(np.round(c, 3).T[::-1])
    a, b = corners(src.mesh), corners(mesh)
    np.testing.assert_allclose(a[key(a)], b[key(b)], atol=1e-5)
    color = lambda s, m: np.array([s.materials[i].basecolor
                                   for i in m.material_ids], np.float32)
    ca, cb = color(src, src.mesh), color(scene, mesh)
    np.testing.assert_allclose(ca[key(a)], cb[key(b)], atol=1e-5)
    emits = lambda s, m: np.array([s.materials[i].emittance > 0
                                   for i in m.material_ids])
    np.testing.assert_array_equal(emits(src, src.mesh)[key(a)],
                                  emits(scene, mesh)[key(b)])


def test_stage_timer(tmp_path):
    """The port's stage spans (`trace.span`, `trace.wait`) land in the
    profiler's Chrome trace, nested and timed on its clock; a wait also
    counts a sync. With no profiler recording they are one no-op."""
    from tpt_torch import trace

    assert trace.span("a") is trace.wait("b")
    trace.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.span("a"):
            time.sleep(0.01)
            with trace.wait("b"):
                torch.ones(4).sum()
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    with open(tmp_path / "t.json") as f:
        ev = {e["name"]: e for e in json.load(f)["traceEvents"]
              if e.get("cat") == "user_annotation"}
    a, b = ev["tpt_torch.a"], ev["tpt_torch.wait.b"]
    assert a["dur"] > 10_000 and a["ts"] <= b["ts"]
    assert b["ts"] + b["dur"] <= a["ts"] + a["dur"]
    assert trace.frame_counters() == {"syncs": 1}


def test_device_trace_and_throughput(tmp_path):
    """A frame profiled as the trace module's docstring says gives a Chrome
    trace with the frame's spans, and the Renderer's Mrays/s is the
    frame's counted rays over its time."""
    from tpt_torch import Renderer, trace
    from tpt_torch.config import RayCastBackend, RenderConfig

    scene = procedural.cornell_box(resolution=(24, 24), spheres=False)
    r = Renderer(scene.build(device="cpu"), scene.camera,
                 RenderConfig(backend=RayCastBackend.BRUTE_FORCE,
                              trace_depth=2))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        r.frame()
    path = str(tmp_path / "frame.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        names = [e["name"] for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "user_annotation"]
    assert names.count("tpt_torch.frame") == 1
    assert names.count("tpt_torch.bounce") == 2
    c = trace.frame_counters()
    rays = c["live"] + c["shadow"]
    assert rays > 0
    assert abs(r.gui.mrays_per_sec * r.gui.frame_ms * 1e3 - rays) < 1e-6 * rays
