"""tpt_torch core against tpt.core: the RNG bit for bit, camera rays, the
device rule of the entry points, and the port's isolation from JAX."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpt.core import camera as jcam
from tpt.core import rng as jrng
from tpt_torch.core import camera as tcam
from tpt_torch.core import rng as trng

from torch_port_helpers import torch_threads  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _u32(a) -> np.ndarray:
    return np.asarray(a).astype(np.uint32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.int64))


@pytest.fixture(scope="module")
def words():
    rs = np.random.default_rng(5)
    w = rs.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    w[:4] = [0, 1, 2**31, 2**32 - 1]
    return w


class TestRng:
    @pytest.mark.parametrize("fn", ["wang_hash", "xorshift32"])
    def test_hash_steps_bit_exact(self, words, fn):
        want = _u32(getattr(jrng, fn)(jnp.asarray(words)))
        got = getattr(trng, fn)(_t(words)).numpy()
        np.testing.assert_array_equal(got, want.astype(np.int64))

    @pytest.mark.parametrize("iteration", [0, 1, 7, 2**31 + 5])
    def test_path_seed_bit_exact(self, iteration):
        pix = np.arange(0, 3_000_000, 97, dtype=np.uint32)
        want = _u32(jrng.path_seed(jnp.asarray(pix), jnp.uint32(iteration)))
        got = trng.path_seed(_t(pix), iteration).numpy()
        np.testing.assert_array_equal(got, want.astype(np.int64))

    def test_rand_float_streams_bit_exact(self, words):
        js = jnp.asarray(np.maximum(words, 1))
        ts = _t(np.maximum(words, 1))
        for _ in range(3):
            js, ju1, ju2, ju3 = jrng.rand_float3(js)
            ts, tu1, tu2, tu3 = trng.rand_float3(ts)
            for a, b in ((ju1, tu1), (ju2, tu2), (ju3, tu3)):
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        np.testing.assert_array_equal(ts.numpy(), _u32(js).astype(np.int64))
        np.testing.assert_array_equal(
            trng.hash_to_unit_float(ts).numpy(),
            np.asarray(jrng.hash_to_unit_float(js)))


class TestCamera:
    @pytest.mark.parametrize("res,iteration", [((64, 48), 1), ((37, 21), 9)])
    def test_camera_rays_match(self, res, iteration):
        """Seeds and origins bit for bit. Directions to 2 ulp: XLA's
        rsqrt is not correctly rounded (on this CPU it differs from the
        exactly rounded value on ~13% of inputs), torch.rsqrt is, so the
        normalisation may differ in the last bit."""
        args = (res, (278.0, 273.0, -800.0), (278.0, 273.0, 0.0),
                (0.0, 1.0, 0.0), 39.3)
        jo, jd, js = jcam.generate_camera_rays(jcam.Camera.build(*args),
                                                jnp.uint32(iteration))
        to, td, ts = tcam.generate_camera_rays(tcam.Camera.build(*args),
                                                iteration, device="cpu")
        np.testing.assert_array_equal(ts.numpy(), _u32(js).astype(np.int64))
        for a, b in ((jo.x, to.x), (jo.y, to.y), (jo.z, to.z)):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        for a, b in ((jd.x, td.x), (jd.y, td.y), (jd.z, td.z)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                       atol=2.4e-7)

    def test_pixel_subset(self):
        cam = tcam.Camera.build((16, 8), (0, 0, 0), (0, 0, 1), (0, 1, 0), 45)
        _, d_all, s_all = tcam.generate_camera_rays(cam, 3, device="cpu")
        pix = torch.tensor([5, 77, 127])
        _, d_sub, s_sub = tcam.generate_camera_rays(cam, 3, pix=pix)
        assert torch.equal(s_sub, s_all[pix])
        assert torch.equal(d_sub.x, d_all.x[pix])


class TestDeviceRule:
    """Entry points run on CUDA unless asked for the CPU; with no GPU they
    raise instead of falling back."""

    @pytest.fixture
    def no_gpu(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def _calls(self):
        from tpt_torch.device import resolve_device
        from tpt_torch.scene import convert, procedural

        host = procedural.cornell_box(resolution=(8, 8), spheres=False)
        cam = host.camera
        return {
            "resolve_device": lambda **kw: resolve_device(**kw),
            "generate_camera_rays":
                lambda **kw: tcam.generate_camera_rays(cam, 1, **kw),
            "HostScene.build": lambda **kw: host.build(**kw),
            "from_numpy_scene": lambda **kw: convert.from_numpy_scene(
                {}, np.zeros((1, 16), np.float32), {}, **kw),
        }

    @pytest.mark.parametrize("entry", ["resolve_device", "generate_camera_rays",
                                       "HostScene.build", "from_numpy_scene"])
    def test_raises_without_gpu(self, no_gpu, entry):
        with pytest.raises(RuntimeError, match="CUDA"):
            self._calls()[entry]()

    def test_cpu_on_request(self, no_gpu):
        _, d, _ = self._calls()["generate_camera_rays"](device="cpu")
        assert d.x.device.type == "cpu"


def test_port_imports_without_jax_or_tpt():
    """Every tpt_torch module and chip_smoke import in a process where
    `jax` and `tpt` cannot be imported."""
    code = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "tpt"):
    sys.modules[name] = None          # any import of them now fails
import tpt_torch
mods = ["tpt_torch"]
for info in pkgutil.walk_packages(tpt_torch.__path__, "tpt_torch."):
    importlib.import_module(info.name)
    mods.append(info.name)
import chip_smoke
leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "tpt")
          and sys.modules[m] is not None]
assert not leaked, leaked
print(len(mods))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 38
