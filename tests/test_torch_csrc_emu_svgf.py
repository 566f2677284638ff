"""The SVGF kernels' CUDA source runs on the CPU: `csrc/svgf.cu` (K5
`tpt_atrous` and the frame's passes `tpt_atrous_passes`, K6
`tpt_reproject`) compiled with g++ against the stand-in
`tests/cuda_emu/cuda_runtime.h` with -ffp-contract=off, on 37x23 planes
with a patch of sky, NaN variances, infinite illumination and depths and
NaN normals (`test_torch_gpu._atrous_planes`), and held against the plain
PyTorch versions.

K5 calls expf and powf, which here are the host's libm, not PyTorch's
CPU exp and pow (SLEEF, within 1 ulp): the weights may differ in their
last bit, so K5 is held against `_atrous_once` at rtol 1e-5 / atol 1e-6
with NaN where the plain version has NaN (on the card, where the kernel's
expf and powf are the ones PyTorch's CUDA exp and pow call, the two agree
bit for bit: tests/test_torch_gpu.py). Between themselves the emulated
kernels share that libm, so the frame's passes equal five single passes
bit for bit (a NaN as any NaN: the host may swap a commutative
operation's operands, and x86 keeps the first one's NaN). K6 has no libm
call and equals its plain version the same way.
This checks the kernels' control flow (the warps' strips, the shared edge
weights and the lists of edges whose other end lies in another warp, the
packed records) before a card runs them; it says nothing of their speed.

Skips where no g++ is found.
"""

import ctypes
import os
import shutil
import subprocess

import pytest
import torch

from test_torch_csrc_emu import CSRC, FLAGS, STUB, rewrite_launches
from test_torch_gpu import _atrous_planes, _reproject_inputs
from tpt_torch.denoise import stencil, svgf

from torch_port_helpers import torch_threads  # noqa: F401  (autouse)

H, W = 23, 37
SIG = (1.0, 128.0, 4.0)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("csrc_emu_svgf")
    with open(os.path.join(CSRC, "svgf.cu")) as f:
        src = rewrite_launches(f.read())
    cpp = out / "svgf.cpp"
    cpp.write_text(src)
    so = out / "libsvgf.so"
    proc = subprocess.run(
        [cxx] + FLAGS + ["-I", STUB, "-I", CSRC, str(cpp), "-o", str(so)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError("g++ svgf.cu failed:\n"
                           + proc.stdout.decode()[-4000:])
    lib = ctypes.CDLL(str(so))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tpt_atrous.argtypes = [p, p, i, i, i, f, f, f, p]
    lib.tpt_atrous_passes.argtypes = [p, p, p, p, i, i, i, f, f, f, p]
    lib.tpt_reproject.argtypes = [p, p, p, p, p, i, i, p]
    return lib


@pytest.fixture(scope="module")
def planes():
    return _atrous_planes(H, W, "nonfinite", 31, "cpu")


def _flat(o):
    return [o[0].x, o[0].y, o[0].z, o[1], o[2].x, o[2].y, o[2].z, o[3]]


def _out(h, w):
    return [torch.zeros(h, w) for _ in range(8)]


def _pass(lib, args, step):
    ins, (h, w) = stencil._planes(*args)
    out = _out(h, w)
    rc = lib.tpt_atrous(stencil.plane_array(ins), stencil.plane_array(out),
                        h, w, step, *SIG, None)
    assert rc == 0
    return stencil._filtered(out)


def _bits(a):
    return a.view(torch.int32)


def _same(a, b):
    """Bit for bit, any NaN equal to any NaN: the host compiler may swap
    the operands of a commutative operation, and x86 then gives the other
    operand's NaN (the card gives one canonical NaN)."""
    assert torch.equal(torch.isnan(a), torch.isnan(b))
    nan = torch.isnan(a)
    assert torch.equal(_bits(a)[~nan], _bits(b)[~nan])


@pytest.mark.parametrize("kind,step,hw", [
    ("nonfinite", 1, (H, W)), ("nonfinite", 2, (H, W)),
    ("nonfinite", 4, (H, W)), ("nonfinite", 8, (H, W)),
    ("nonfinite", 16, (H, W)), ("signed_zero_normals", 3, (H, W)),
    ("plain", 33, (70, W))])
def test_k5_equals_plain(lib, kind, step, hw):
    """One pass at each of the frame's steps (an odd step and one past a
    warp's width too): within the libm tolerance, NaN where plain has NaN,
    and sky pixels passed through bit for bit."""
    args = _atrous_planes(*hw, kind, 31 + step, "cpu")
    got = _flat(_pass(lib, args, step))
    want = _flat(stencil.atrous_plain(*args, step, *SIG))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6, equal_nan=True)
    sky = args[4] < 0
    assert bool(sky.any())
    for a, b in zip(got, _flat(args[:4])):
        _same(a[sky], b[sky])


@pytest.mark.parametrize("iterations", [1, 2, 5])
def test_k5_passes_equal_single_passes(lib, planes, iterations):
    """The frame's passes in one call (packed records after the first)
    equal single passes at steps 1, 2, 4, ... bit for bit: the last pass
    and the history pass (iterations - 2)."""
    ins, _ = stencil._planes(*planes)
    out, hist = _out(H, W), _out(H, W)
    packed = torch.zeros(5, H * W, 4)
    rc = lib.tpt_atrous_passes(stencil.plane_array(ins),
                               stencil.plane_array(out),
                               stencil.plane_array(hist), packed.data_ptr(),
                               H, W, iterations, *SIG, None)
    assert rc == 0
    cur, want_hist = planes[:4], None
    for it in range(iterations):
        cur = _pass(lib, tuple(cur) + planes[4:], 1 << it)
        if it == iterations - 2:
            want_hist = cur
    for a, b in zip(out, _flat(cur)):
        _same(a, b)
    if want_hist is not None:
        for a, b in zip(hist, _flat(want_hist)):
            _same(a, b)


@pytest.mark.parametrize("motion", ["random", "nonfinite"])
def test_k6_equals_plain(lib, motion):
    """K6 (unchanged) bit for bit: 10 sums and the weight sum."""
    state, mu, mv, normal, depth, matid = _reproject_inputs(H, W, motion, 7,
                                                            "cpu")
    hist = [state.hist_direct.x, state.hist_direct.y, state.hist_direct.z,
            state.hist_indirect.x, state.hist_indirect.y,
            state.hist_indirect.z, state.m1_dir, state.m1_ind, state.m2_dir,
            state.m2_ind, state.prev_normal.x, state.prev_normal.y,
            state.prev_normal.z, state.prev_depth]
    cur = [mu, mv, depth, normal.x, normal.y, normal.z]
    out = [torch.zeros(H, W) for _ in range(11)]
    rc = lib.tpt_reproject(stencil.plane_array(hist),
                           state.prev_matid.data_ptr(),
                           stencil.plane_array(cur), matid.data_ptr(),
                           stencil.plane_array(out), H, W, None)
    assert rc == 0
    sums, wsum = svgf._reproject_taps(state, mu, mv, normal, depth, matid)
    for a, b in zip(out, [sums[k] for k in svgf.DATA_KEYS] + [wsum]):
        _same(a, b)
    assert float(wsum.max()) > 0
