"""The port's PNG codec (`tpt_torch.io.image`), texture atlas
(`tpt_torch.scene.texture`) and hero texture writer
(`tpt_torch.scene.hero_assets`) against PIL and tpt.

Exact: the RGBA bytes of every PNG kind the reader takes, against PIL's
`convert("RGBA")`; the atlas sheet and placements against tpt's
AtlasBuilder; the hero textures against scenes/make_scenes.py's
generators. Floats: `sample_atlas` within 1e-6 relative (atol 1e-7)."""

import importlib.util
import os
import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpt.scene import obj as jobj
from tpt.scene import texture as jtex
from tpt_torch.io import image as timage
from tpt_torch.scene import hero_assets
from tpt_torch.scene import obj as tobj
from tpt_torch.scene import texture as ttex

from torch_port_helpers import torch_threads  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
Image = pytest.importorskip("PIL.Image")


@pytest.fixture(scope="module")
def pixels():
    rs = np.random.default_rng(3)
    smooth = (np.add.outer(np.arange(37), np.arange(53)) * 3 % 256
              ).astype(np.uint8)
    return dict(noise=rs.integers(0, 256, (37, 53, 4), dtype=np.uint8),
                smooth=smooth)


def _pil_cases(px):
    noise, smooth = px["noise"], px["smooth"]
    grey3 = np.stack([smooth] * 3, -1)
    quant = lambda n: Image.fromarray(noise[..., :3]).quantize(n)
    return {
        "L": (Image.fromarray(smooth), {}),
        "LA": (Image.fromarray(noise[..., :2], "LA"), {}),
        "RGB": (Image.fromarray(noise[..., :3]), {}),
        "RGB smooth": (Image.fromarray(grey3), {}),
        "RGBA": (Image.fromarray(noise), {}),
        "RGBA stored": (Image.fromarray(noise), dict(compress_level=0)),
        "1-bit": (Image.fromarray(smooth > 100), {}),
        "P 2 colours": (quant(2), {}),
        "P 4 colours": (quant(4), {}),
        "P 16 colours": (quant(16), {}),
        "P 200 colours": (quant(200), {}),
        "P tRNS": (quant(16), dict(transparency=bytes([0, 80, 255, 3]))),
        "L tRNS": (Image.fromarray(smooth), dict(transparency=9)),
        "RGB tRNS": (Image.fromarray(grey3), dict(transparency=(9, 9, 9))),
    }


CASES = ("L", "LA", "RGB", "RGB smooth", "RGBA", "RGBA stored", "1-bit",
         "P 2 colours", "P 4 colours", "P 16 colours", "P 200 colours",
         "P tRNS", "L tRNS", "RGB tRNS")


@pytest.mark.parametrize("case", CASES)
def test_png_reader_matches_pil(pixels, tmp_path, case):
    img, kw = _pil_cases(pixels)[case]
    path = str(tmp_path / "t.png")
    img.save(path, **kw)
    want = np.asarray(Image.open(path).convert("RGBA"))
    np.testing.assert_array_equal(timage.read_png(path), want)


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _encode(rows, ftypes, bpp):
    """PNG filter encoder: each row of `rows` [h, stride] uint8 filtered
    by its entry of `ftypes` (0-4)."""
    h, stride = rows.shape
    r = rows.astype(np.int32)
    out = []
    for y in range(h):
        cur = r[y]
        prev = r[y - 1] if y else np.zeros(stride, np.int32)
        a = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        p = a + prev - c
        pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, prev, c))
        pred = [0, a, prev, (a + prev) >> 1, paeth][ftypes[y]]
        out.append(np.concatenate([[ftypes[y]], (cur - pred) & 0xFF]))
    return np.array(out, np.uint8).tobytes()


@pytest.mark.parametrize("ctype,chans", [(2, 3), (6, 4), (0, 1)])
def test_png_reader_every_filter(pixels, tmp_path, ctype, chans):
    """Rows under filters 0-4 in turn (PIL's writer picks among them by
    itself and never wrote filter 3 here), read by both readers."""
    h, w = 37, 53
    raw = pixels["noise"][..., :chans].reshape(h, w * chans)
    raw = (raw // 2 + pixels["smooth"].repeat(chans, axis=1) // 2)
    data = (timage.PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(_encode(raw, [y % 5 for y in
                                                          range(h)], chans)))
            + _chunk(b"IEND", b""))
    path = tmp_path / "f.png"
    path.write_bytes(data)
    want = np.asarray(Image.open(path).convert("RGBA"))
    np.testing.assert_array_equal(timage.read_png(str(path)), want)


@pytest.mark.parametrize("shape", [(37, 53), (37, 53, 2), (37, 53, 3),
                                   (37, 53, 4)])
def test_png_writer_round_trip(pixels, tmp_path, shape):
    img = pixels["noise"].reshape(-1)[:int(np.prod(shape))].reshape(shape)
    path = timage.write_png(str(tmp_path / "w.png"), img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    want = np.asarray(Image.open(path).convert("RGBA"))
    np.testing.assert_array_equal(timage.read_png(path), want)


def test_valid_images_the_reader_lacks_raise(pixels, tmp_path):
    """16-bit and interlaced PNGs and other formats PIL reads raise
    UnsupportedImage, in the reader and in load_texture_into_atlas: the
    port never drops a texture tpt would have read."""
    p16 = str(tmp_path / "16.png")
    Image.fromarray(pixels["smooth"].astype(np.uint16) * 257).save(p16)
    interlaced = tmp_path / "i.png"
    interlaced.write_bytes(
        timage.PNG_SIGNATURE
        + _chunk(b"IHDR", struct.pack(">IIBBBBB", 4, 4, 8, 2, 0, 0, 1))
        + _chunk(b"IDAT", zlib.compress(bytes(200))) + _chunk(b"IEND", b""))
    jpg = str(tmp_path / "t.jpg")
    Image.fromarray(pixels["noise"][..., :3]).save(jpg)
    for path, what in ((p16, "16-bit"), (str(interlaced), "interlaced"),
                       (jpg, "JPEG")):
        with pytest.raises(timage.UnsupportedImage, match=what):
            timage.read_png(path)
        with pytest.raises(timage.UnsupportedImage):
            tobj.load_texture_into_atlas(ttex.AtlasBuilder(), path)
        assert jobj.load_texture_into_atlas(jtex.AtlasBuilder(), path) >= 0


def test_missing_or_corrupt_texture_is_minus_one(pixels, tmp_path):
    good = str(tmp_path / "good.png")
    timage.write_png(good, pixels["noise"])
    data = open(good, "rb").read()
    broken = {"missing": None, "truncated": data[:len(data) // 2],
              "bad crc": data[:40] + bytes([data[40] ^ 1]) + data[41:],
              "not an image": b"hello, world\n" * 10}
    for name, content in broken.items():
        path = str(tmp_path / f"{name}.png")
        if content is not None:
            open(path, "wb").write(content)
        assert tobj.load_texture_into_atlas(ttex.AtlasBuilder(), path) == -1
        assert jobj.load_texture_into_atlas(jtex.AtlasBuilder(), path) == -1


@pytest.fixture(scope="module")
def builders():
    """The same textures (sizes that force several shelves, a grey and an
    RGB image, a repeated path) into tpt's and the port's builders."""
    rs = np.random.default_rng(11)
    jb, tb = jtex.AtlasBuilder(), ttex.AtlasBuilder()
    shapes = [(16, 40, 4), (64, 200, 4), (8, 8), (33, 17, 3), (64, 64, 4),
              (5, 130, 4)]
    for k, shp in enumerate(shapes):
        img = rs.uniform(0, 1, shp).astype(np.float32)
        for b in (jb, tb):
            assert b.add(img, path=f"tex{k}") == k
    for b in (jb, tb):
        assert b.add(np.zeros((2, 2, 4), np.float32), path="tex1") == 1
    return jb.build(), tb.build(device="cpu")


def test_atlas_layout_and_texels_match_tpt(builders):
    ja, ta = builders
    for f in ("r", "g", "b", "a", "x0", "y0", "width", "height"):
        np.testing.assert_array_equal(getattr(ta, f).numpy(),
                                      np.asarray(getattr(ja, f)))
    assert ta.num_textures == ja.num_textures == 6
    empty = ttex.AtlasBuilder().build(device="cpu")
    je = jtex.AtlasBuilder().build()
    assert empty.r.shape == je.r.shape and empty.num_textures == 1


def test_sample_atlas_matches_tpt(builders):
    ja, ta = builders
    rs = np.random.default_rng(12)
    n = 4096
    tid = rs.integers(-1, 6, n).astype(np.int32)
    u = rs.uniform(-3, 3, n).astype(np.float32)
    v = rs.uniform(-3, 3, n).astype(np.float32)
    u[:6] = [0.0, 1.0, -1.0, 0.5, 1e-7, 0.9999999]
    jrgb, ja_ = jtex.sample_atlas(ja, jnp.asarray(tid), jnp.asarray(u),
                                  jnp.asarray(v))
    trgb, ta_ = ttex.sample_atlas(ta, torch.from_numpy(tid),
                                  torch.from_numpy(u), torch.from_numpy(v))
    for j, t in ((jrgb.x, trgb.x), (jrgb.y, trgb.y), (jrgb.z, trgb.z),
                 (ja_, ta_)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                   atol=1e-7)
    assert (trgb.x.numpy()[tid < 0] == 1).all()


@pytest.fixture(scope="module")
def make_scenes():
    spec = importlib.util.spec_from_file_location(
        "make_scenes", os.path.join(REPO, "scenes", "make_scenes.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_hero_texture_generators_match_make_scenes(make_scenes):
    np.testing.assert_array_equal(hero_assets.checker(), make_scenes._checker())
    np.testing.assert_array_equal(hero_assets.bricks(), make_scenes._bricks())
    np.testing.assert_array_equal(hero_assets.ripple_normal_map(),
                                  make_scenes._ripple_normal_map())


def test_write_hero_assets(make_scenes, tmp_path, monkeypatch):
    """The port's hero directory against the one scenes/make_scenes.py's
    hero() writes (into a temporary directory): the same texture pixels
    and byte-equal OBJ, MTL, HDR and JSON; scenes/ itself is refused."""
    ref = tmp_path / "ref"
    ref.mkdir()
    monkeypatch.setattr(make_scenes, "HERE", str(ref))
    make_scenes.hero()
    out = tmp_path / "port"
    assert hero_assets.write_hero_assets(str(out)) == str(out / "hero.json")
    for name in hero_assets.TEXTURES:
        want = np.asarray(Image.open(ref / name))
        np.testing.assert_array_equal(np.asarray(Image.open(out / name)),
                                      want)
        np.testing.assert_array_equal(
            timage.read_png(str(out / name)),
            np.asarray(Image.open(ref / name).convert("RGBA")))
    for name in hero_assets.TRACKED:
        assert (out / name).read_bytes() == (ref / name).read_bytes(), name
    with pytest.raises(ValueError, match="scenes"):
        hero_assets.write_hero_assets(os.path.join(REPO, "scenes"))


def test_tonemap_and_save_png_match_tpt(pixels, tmp_path):
    from tpt.io import image as jimage

    rs = np.random.default_rng(4)
    img = rs.uniform(-0.2, 1.5, (9, 11, 3)).astype(np.float32)
    img[0, 0] = np.nan
    np.testing.assert_array_equal(timage.tonemap(img), jimage.tonemap(img))
    a = timage.save_png(str(tmp_path / "a.png"), img)
    b = jimage.save_png(str(tmp_path / "b.png"), img)
    np.testing.assert_array_equal(np.asarray(Image.open(a)),
                                  np.asarray(Image.open(b)))
    hdr = np.abs(np.nan_to_num(img)) * 40
    ha = timage.save_hdr(str(tmp_path / "a.hdr"), hdr)
    hb = jimage.save_hdr(str(tmp_path / "b.hdr"), hdr)
    assert open(ha, "rb").read() == open(hb, "rb").read()
