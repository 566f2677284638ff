"""The plain reference and the comparison that decides `correct`, at a
size the CPU runs: the harness's whole run on the program (the card's
look skipped) comes out correct; the bfloat16 control and each fault a
cell can have (a frame that leaves the image's state unchanged, half of
the paths left out with the rest doubled, an answer altered where it is
produced) come out not correct."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from tptbench import check, control
from tptbench.check import compare, judge
from tptbench.tests import tiny

CELLS = ["fireplace_sweep.static", "fireplace_svgf.orbit"]
# every configuration under every mix, the cells' and those MIXES holds:
# which reference a frame gets follows from the configuration and the
# mix's camera path alone
PAIRS = [(c, m) for c in ("fireplace_sweep", "fireplace_svgf")
         for m in ("static", "orbit", "still", "bursts", "pipelined")]


def correct(out, spec):
    return judge(out["checks"]["numbers"], spec["config"]["limits"])


@pytest.mark.parametrize("cell", CELLS)
def test_program_agrees_with_reference(cell):
    out = tiny.run_tiny(cell)
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert correct(out, tiny.spec(cell)), out["checks"]


@pytest.mark.parametrize("config,mix", PAIRS)
def test_any_mix_agrees_with_reference(config, mix):
    spec = tiny.spec_of(config, mix)
    out = tiny.run_tiny(spec, seed=2**31 + 7, seconds=1.0)
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert correct(out, spec), out["checks"]


def test_still_denoised_check_replays_the_history():
    """A camera at rest under SVGF: the compared frames carry history
    beyond the threshold, so the temporal variance path is compared."""
    spec = tiny.spec_of("fireplace_svgf", "still")
    threshold = spec["config"]["svgf"]["history_threshold"]
    # the warm-up alone builds the history, however few frames the window
    # holds on a loaded host
    spec["traffic"]["warmup_frames"] = threshold + 1
    out = tiny.run_tiny(spec, seed=5, seconds=0.5)
    hist = [h for _, h in out["checks"]["history"]]
    assert min(hist) > threshold, hist
    assert correct(out, spec), out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell):
    spec = tiny.spec(cell)
    nums = control.readings(spec, 11, 2, "cpu")
    assert not judge(nums, spec["config"]["limits"]), nums


def test_control_compares_what_the_run_compares():
    """The control's frames are the run's: same seed, same count."""
    spec = tiny.spec("fireplace_svgf.orbit")
    out = tiny.run_tiny(spec, seed=9, seconds=0.5)
    warm = spec["traffic"]["warmup_frames"]
    kept = check.Sampler.indices(9, spec["traffic"]["check"]["frames"],
                                 warm, out["attempted"])
    assert kept == out["checks"]["frames"]


def _zero_radiance(out):
    z = out.direct.map(torch.zeros_like)
    return type(out)(direct=z, indirect=z, gbuf=out.gbuf,
                     rays_traced=out.rays_traced)


def _half_doubled(out):
    keep = (torch.arange(out.direct.x.shape[0]) % 2 == 0).to(
        out.direct.x.dtype) * 2.0
    f = lambda v: v.map(lambda c: c * keep)
    return type(out)(direct=f(out.direct), indirect=f(out.indirect),
                     gbuf=out.gbuf, rays_traced=out.rays_traced)


def _altered(out):
    f = lambda v: v.map(lambda c: c * 1.01)
    return type(out)(direct=f(out.direct), indirect=out.indirect,
                     gbuf=out.gbuf, rays_traced=out.rays_traced)


@pytest.mark.parametrize("cell", CELLS + ["fireplace_svgf.still"])
@pytest.mark.parametrize("fault", [_zero_radiance, _half_doubled, _altered],
                         ids=["state_unchanged", "half_left_out", "altered"])
def test_fault_is_not_correct(monkeypatch, cell, fault):
    from tpt_torch.integrators import wavefront

    inner = wavefront.trace_frame
    monkeypatch.setattr(wavefront, "trace_frame",
                        lambda *a, **k: fault(inner(*a, **k)))
    spec = (tiny.spec_of("fireplace_svgf", "still") if cell.endswith("still")
            else tiny.spec(cell))
    out = tiny.run_tiny(spec)
    assert not correct(out, spec), out["checks"]


def test_compare_counts():
    ref = np.ones((4, 3))
    prog = ref.copy()
    prog[0, 1] = 1.5
    prog[1, 0] = np.nan
    nums = compare(prog, ref)
    assert nums["nonfinite_px"] == 1 and nums["off_px_share"] == 0.5
    assert nums["rel_l1"] == pytest.approx(1.5 / 12)


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; import tptbench.reference.pathtrace, "
            "tptbench.reference.svgf, tptbench.reference.scene, "
            "tptbench.check; print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    mods = json.loads(subprocess.run(
        [sys.executable, "-c", "import json; " + code], capture_output=True,
        text=True, check=True, cwd=tiny.run.ROOT).stdout)
    assert not set(mods) & {"jax", "jaxlib", "flax", "tpt", "tpt_torch"}


def test_a_run_imports_no_jax():
    code = ("import json, sys; from tptbench.tests import tiny; "
            "tiny.run_tiny('fireplace_svgf.orbit', seconds=0.1); "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=tiny.run.ROOT).stdout
    mods = set(json.loads(out.strip().splitlines()[-1]))
    assert "tpt_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "tpt"}
