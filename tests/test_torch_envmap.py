"""The port's environment map (`tpt_torch.scene.envmap`) against tpt's.

Exact: `read_hdr` (flat and RLE scanlines, native and numpy decoders),
the Vose alias tables and the pdf planes of `build_envmap`. Floats
within 1e-6 relative (atol 1e-6): `sample_env` (its lookups are at
texel centres; its directions), and the bilinear lookup of
`env_radiance` and `env_pdf` at the same (u, v). Their direction ->
(u, v) step goes through acos and atan2, which XLA and PyTorch round
differently (XLA's acos is off by up to 2 ulp, PyTorch's vectorized
atan2 by 1): u and v are held to 4 ulp, and end to end the lookups to
1e-6 relative on the lanes whose (u, v) agree bit for bit and to 1e-4
of the plane's largest value elsewhere (a few ulp of u times the
plane's steepest texel step, the sun's edge)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpt.scene import envmap as jenv
from tpt_torch.io.image import save_hdr
from tpt_torch.scene import envmap as tenv
from tpt_torch.scene import native as tnative

from torch_port_helpers import np3, to_jax3, to_torch3
from torch_port_helpers import torch_threads  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERO_HDR = os.path.join(REPO, "scenes", "hero_env.hdr")


def _rle_hdr(path, rgbe):
    """A Radiance file with adaptive-RLE scanlines: runs of 3+ equal
    bytes as run records, the rest as literal records."""
    h, w = rgbe.shape[:2]
    out = bytearray(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
    out += f"-Y {h} +X {w}\n".encode()
    for y in range(h):
        out += bytes([2, 2, w >> 8, w & 255])
        for c in range(4):
            row = rgbe[y, :, c]
            x = 0
            while x < w:
                run = 1
                while x + run < w and run < 127 and row[x + run] == row[x]:
                    run += 1
                if run >= 3:
                    out += bytes([128 + run, row[x]])
                    x += run
                    continue
                lit = 1
                while x + lit < w and lit < 128 and not (
                        x + lit + 2 < w and row[x + lit] == row[x + lit + 1]
                        == row[x + lit + 2]):
                    lit += 1
                out += bytes([lit]) + bytes(row[x:x + lit])
                x += lit
    with open(path, "wb") as f:
        f.write(bytes(out))


@pytest.fixture(scope="module")
def hero_rgb():
    return tenv.read_hdr(HERO_HDR)


def test_read_hdr_flat_matches_tpt(hero_rgb):
    np.testing.assert_array_equal(hero_rgb, jenv.read_hdr(HERO_HDR))
    assert hero_rgb.shape == (128, 256, 3) and hero_rgb.dtype == np.float32


def test_read_hdr_rle_both_decoders_match_tpt(tmp_path, monkeypatch):
    rs = np.random.default_rng(2)
    rgbe = rs.integers(0, 256, (13, 40, 4), dtype=np.uint8)
    rgbe[:, 5:30] = rgbe[:, 5:6]               # long runs
    rgbe[2:4] = 0                              # zero exponent rows
    path = str(tmp_path / "rle.hdr")
    _rle_hdr(path, rgbe)
    native = tenv.read_hdr(path)
    np.testing.assert_array_equal(native, jenv.read_hdr(path))
    monkeypatch.setattr(tnative, "decode_hdr_rle_native",
                        lambda *a: None)
    np.testing.assert_array_equal(tenv.read_hdr(path), native)
    monkeypatch.undo()
    flat = str(tmp_path / "flat.hdr")
    save_hdr(flat, native)
    np.testing.assert_array_equal(tenv.read_hdr(flat), jenv.read_hdr(flat))


def test_read_hdr_refuses_other_formats(tmp_path):
    path = tmp_path / "sky.exr"
    path.write_bytes(b"v/1\x01")
    with pytest.raises(ValueError, match=r"\.exr"):
        tenv.read_hdr(str(path))


@pytest.mark.parametrize("case", ["random", "sparse", "zero", "one",
                                  "hero flux"])
def test_vose_alias_matches_tpt(hero_rgb, case):
    rs = np.random.default_rng(7)
    if case == "random":
        w = rs.exponential(1.0, 5000)
    elif case == "sparse":
        w = np.where(rs.uniform(size=3000) < 0.05, rs.uniform(0, 9, 3000), 0)
    elif case == "zero":
        w = np.zeros(64)
    elif case == "one":
        w = np.array([3.5])
    else:
        lum = (0.2126 * hero_rgb[..., 0] + 0.7152 * hero_rgb[..., 1]
               + 0.0722 * hero_rgb[..., 2])
        theta = (np.arange(128) + 0.5) / 128 * np.pi
        w = (lum.astype(np.float64) * np.sin(theta)[:, None]).ravel()
    ta, tp = tenv.build_vose_alias(w)
    ja, jp = jenv.build_vose_alias(w)
    assert ta.dtype == ja.dtype and tp.dtype == jp.dtype
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(tp, jp)


@pytest.fixture(scope="module")
def envs(hero_rgb):
    return jenv.build_envmap(hero_rgb), tenv.build_envmap(hero_rgb,
                                                          device="cpu")


def test_build_envmap_matches_tpt(envs):
    je, te = envs
    assert te.enabled and je.enabled and te.shape == je.shape
    for f in ("r", "g", "b", "pdf", "alias", "prob"):
        np.testing.assert_array_equal(getattr(te, f).numpy(),
                                      np.asarray(getattr(je, f)))


@pytest.fixture(scope="module")
def dirs():
    rs = np.random.default_rng(9)
    d = rs.normal(size=(4096, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:6] = [[0, 1, 0], [0, -1, 0], [1, 0, 0], [-1, 0, 0], [0, 0, 1],
             [0, 0, -1]]
    return d


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def test_env_radiance_and_pdf_match_tpt(envs, dirs):
    je, te = envs
    ju, jv = (np.asarray(c) for c in jenv._dir_to_uv(to_jax3(dirs)))
    tu, tv = (c.numpy() for c in tenv._dir_to_uv(to_torch3(dirs)))
    assert _ulps(tu, ju).max() <= 4 and _ulps(tv, jv).max() <= 4
    same_uv = (tu == ju) & (tv == jv)
    assert same_uv.mean() > 0.5
    for plane in ("r", "pdf"):
        np.testing.assert_allclose(
            tenv._bilinear(getattr(te, plane), torch.from_numpy(ju),
                           torch.from_numpy(jv)).numpy(),
            np.asarray(jenv._bilinear(getattr(je, plane), jnp.asarray(ju),
                                      jnp.asarray(jv))),
            rtol=1e-6, atol=1e-6)
    jr = np3(jenv.env_radiance(je, to_jax3(dirs)))
    tr = np3(tenv.env_radiance(te, to_torch3(dirs)))
    jp = np.asarray(jenv.env_pdf(je, to_jax3(dirs)))
    tp = tenv.env_pdf(te, to_torch3(dirs)).numpy()
    for t, j, peak in ((tr, jr, float(te.r.max())),
                       (tp, jp, float(te.pdf.max()))):
        np.testing.assert_allclose(t[same_uv], j[same_uv], rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-4 * peak)


def test_sample_env_matches_tpt(envs):
    je, te = envs
    rs = np.random.default_rng(10)
    u1 = rs.uniform(0, 1, 8192).astype(np.float32)
    u1[:3] = [0.0, 0.99999994, 0.5]
    u2 = rs.uniform(0, 1, 8192).astype(np.float32)
    jd, jr, jp = jenv.sample_env(je, jnp.asarray(u1), jnp.asarray(u2))
    td, tr, tp = tenv.sample_env(te, torch.from_numpy(u1), torch.from_numpy(u2))
    np.testing.assert_allclose(np3(td), np3(jd), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np3(tr), np3(jr), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-6)
    # the alias table puts samples where the flux is: the mean sampled
    # pdf (0.46 here) is well above a uniform direction's, 1 / (4 pi)
    assert float(tp.mean()) > 4 / (4 * np.pi)


def test_env_map_device_rule(hero_rgb, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tenv.build_envmap(hero_rgb)
    assert tenv.load_envmap(HERO_HDR, device="cpu").r.device.type == "cpu"
