"""The harness's arithmetic on synthetic frame times, device intervals
and spans, and the orbit's camera path."""

import numpy as np
import pytest

from tptbench import camera_path, run
from tptbench import check as check_mod
from tptbench.metrics import cast_roofline, device_idle_pct, eager_ms
from tptbench.metrics import frame_ms, frame_ms_p90, launches_per_frame
from tptbench.metrics import mpaths_s, peak_mem_gib, setup_s, svgf_ms
from tptbench.trace import FRAME_SPAN, Op, Span, Trace, gaps, union


def window():
    return run.Window(frame_s=(0.2, 0.3, 0.25, 0.5, 0.25), seconds=1.5,
                      paths_per_frame=1000, peak_bytes=3 << 30, setup_s=12.0)


def test_end_to_end_rates():
    w = window()
    assert mpaths_s.window(w) == pytest.approx(5 * 1000 / 1.5 / 1e6)
    assert frame_ms.window(w) == pytest.approx(300.0)
    assert peak_mem_gib.window(w) == 3.0 and setup_s.window(w) == 12.0
    # p90 by statistics.quantiles, inclusive: between 300 and 500
    assert frame_ms_p90.window(w) == pytest.approx(
        float(np.percentile([t * 1e3 for t in w.frame_s], 90)))


def test_union_and_gaps():
    u = union([(0, 2), (1, 3), (5, 6), (6, 7)])
    assert u == [(0, 3), (5, 7)]
    assert gaps(u, -1, 10) == [(-1, 0), (3, 5), (7, 10)]


def synthetic():
    spans = [Span(FRAME_SPAN, 0, 100), Span(FRAME_SPAN, 100, 200),
             Span("tptbench.cast.scan", 10, 20),
             Span("tptbench.cast.sweep", 110, 130),
             Span("tptbench.svgf", 150, 190)]
    ops = [Op("void walk_kernel<4, false>(float*)", "kernel", 12, 40, 11),
           Op("void at::native::vectorized_elementwise_kernel<4>()",
              "kernel", 40, 60, 30),
           Op("sweep_kernel", "kernel", 120, 150, 115),
           Op("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 190, 200,
              None),
           Op("outside", "kernel", 300, 310, 250)]
    return Trace(ops, spans, {"cast_least_s": [10e-6, 20e-6],
                              "events:svgf": [3.0, 5.0],
                              "window": window()})


def test_readers():
    tr = synthetic()
    assert tr.window == (0, 200)
    # busy 12-60, 120-150, 190-200: 88 of 200
    assert device_idle_pct.read(tr) == pytest.approx(56.0)
    assert launches_per_frame.read(tr) == 1.5
    assert eager_ms.is_port_kernel("void walk_kernel<4, false>(float*)")
    assert not eager_ms.is_port_kernel(
        "void at::native::vectorized_elementwise_kernel<4>()")
    assert eager_ms.read(tr) == pytest.approx(20 / 1e3 / 2)
    # kernels launched in the cast spans: walk (28 us) and sweep (30 us)
    assert cast_roofline.read(tr) == pytest.approx(100 * 30e-6 / 29e-6)
    assert svgf_ms.read(tr) == 4.0
    # the traced run's timed frames, by the end-to-end definitions
    assert frame_ms.read(tr) == frame_ms.window(window())
    assert frame_ms_p90.read(tr) == frame_ms_p90.window(window())
    assert tr.open_span(150) == "svgf" and tr.open_span(50) == "frame"
    assert run.breakdown(tr)["idle_gaps"][0][0] == "frame"


def test_readers_find_nothing():
    tr = Trace([], [Span(FRAME_SPAN, 0, 10)])
    for mod in (launches_per_frame, eager_ms, cast_roofline, svgf_ms,
                device_idle_pct, frame_ms, frame_ms_p90):
        assert mod.read(tr) is None


ORBIT = {"yaw_step_deg": 0.3, "yaw_amplitude_deg": 15.0, "moves": 1,
         "rests": 0}


def test_orbit_repeats_from_its_seed():
    yaws = lambda seed: [camera_path.camera_path(ORBIT, seed).yaw(k)
                         for k in range(300)]
    a, b, c = yaws(2**31 + 17), yaws(2**31 + 17), yaws(5)
    assert a == b and a != c
    assert max(map(abs, a)) <= 15.0
    steps = np.abs(np.diff(a))
    assert np.all(steps <= 0.3 + 1e-9) and np.median(steps) == pytest.approx(0.3)
    p = camera_path.camera_path(ORBIT, 5)
    assert all(p.moved(k) and p.history(k)[1] == 1 for k in range(50))


def test_fixed_camera_takes_its_yaw_from_the_seed():
    spec = {"yaw_step_deg": 0.0, "yaw_amplitude_deg": 0.5, "moves": 0,
            "rests": 1}
    p = camera_path.camera_path(spec, 2**31 + 1)
    assert p.moved(0) and not any(p.moved(k) for k in range(1, 100))
    assert len({p.yaw(k) for k in range(100)}) == 1
    assert abs(p.yaw(0)) <= 0.5
    assert p.history(41) == (p.yaw(0), 42)
    assert camera_path.camera_path(spec, 7).yaw(0) != p.yaw(0)


def test_bursts_of_moves_and_rests():
    spec = {"yaw_step_deg": 0.3, "yaw_amplitude_deg": 15.0, "moves": 2,
            "rests": 3}
    p = camera_path.camera_path(spec, 11)
    moved = [p.moved(k) for k in range(1, 41)]
    assert sum(moved) == 16  # 2 of every 5
    # the yaw steps at each move and only then
    for k in range(1, 40):
        assert (p.yaw(k) != p.yaw(k - 1)) == p.moved(k)
        yaw, frames = p.history(k)
        assert yaw == p.yaw(k) and frames >= 1
        assert p.moved(k - frames + 1)
        assert not any(p.moved(j) for j in range(k - frames + 2, k + 1))


def test_camera_path_refuses_nonsense():
    for bad in ({"yaw_step_deg": -1.0, "yaw_amplitude_deg": 1.0, "moves": 1,
                 "rests": 0},
                {"yaw_step_deg": 0.3, "yaw_amplitude_deg": 0.0, "moves": 1,
                 "rests": 0},
                {"yaw_step_deg": 0.3, "yaw_amplitude_deg": 1.0, "moves": 0,
                 "rests": 0}):
        with pytest.raises(ValueError):
            camera_path.camera_path(bad, 1)


def test_sampler_keeps_the_last_and_a_seeded_draw():
    s = check_mod.Sampler(2**31 + 3, 3)
    for k in range(10, 60):
        s.offer(k, str(k))
    kept = s.kept
    assert len(kept) == 3 and kept[-1] == (59, "59")
    assert all(item == str(k) for k, item in kept)
    assert [k for k, _ in kept] == check_mod.Sampler.indices(2**31 + 3, 3,
                                                             10, 50)
    assert check_mod.Sampler.indices(2**31 + 4, 3, 10, 50) != \
        [k for k, _ in kept]
    assert check_mod.Sampler.indices(1, 1, 0, 5) == [4]
    assert check_mod.Sampler.indices(1, 3, 0, 2) == [0, 1]


def test_yaw_keeps_the_distance_to_the_pivot():
    p = camera_path.yawed_position((600.0, 180.0, 54.0), (600.0, 128.0, 630.0),
                                   (0.0, 1.0, 0.0), 15.0)
    d0 = np.linalg.norm(np.subtract((600.0, 180.0, 54.0), (600, 128, 630)))
    assert np.linalg.norm(np.subtract(p, (600, 128, 630))) == pytest.approx(d0)
    assert p[1] == pytest.approx(180.0)
