"""Image input and output: tonemapping, 8-bit PNG and Radiance RGBE.

Counterpart of `tpt/io/image.py`, which writes PNGs with PIL. The port
keeps no PIL: PNGs are written and read here with numpy and the standard
library's `zlib`.

`read_png` decodes non-interlaced PNGs of 1-8 bits a sample (grey,
grey + alpha, RGB, RGBA, palette; filters 0-4, tRNS transparency) into
the RGBA bytes PIL's `Image.open(path).convert("RGBA")` gives. A valid
file it does not decode (16 bits a sample, interlaced, or another image
format than PNG) raises `UnsupportedImage`, never a silent miss; a file
that is not an image or is corrupt raises `ValueError`.
"""

from __future__ import annotations

import datetime
import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# signatures of the other formats tpt's texture loader (PIL) reads
_OTHER_FORMATS = ((b"\xff\xd8\xff", "JPEG"), (b"GIF8", "GIF"), (b"BM", "BMP"),
                  (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"))
# channels of each PNG colour type
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


class UnsupportedImage(ValueError):
    """A valid image this reader does not decode."""


def tonemap(img: np.ndarray, gamma: float = 2.2) -> np.ndarray:
    """Linear radiance [H,W,3] float -> uint8 with pow(1/gamma); uint8
    input passes through (it is already display-ready)."""
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img
    img = np.clip(np.nan_to_num(img.astype(np.float32)), 0.0, 1.0)
    img = np.power(img, 1.0 / gamma)
    return (img * 255.0 + 0.5).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, pixels: np.ndarray) -> str:
    """Write uint8 pixels [H, W] (grey) or [H, W, 1|2|3|4] (grey, grey +
    alpha, RGB, RGBA) as a non-interlaced 8-bit PNG, every row filter 0."""
    a = np.asarray(pixels)
    if a.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8 pixels, got {a.dtype}")
    if a.ndim == 2:
        a = a[..., None]
    h, w, c = a.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), a.reshape(h, w * c)],
                          axis=1)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0,
                                            0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))
    return path


def _chunks(data: bytes):
    """(type, payload) of every chunk after the signature, CRCs checked."""
    pos = len(PNG_SIGNATURE)
    while pos < len(data):
        if pos + 12 > len(data):
            raise ValueError("truncated PNG chunk")
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        end = pos + 8 + length
        if end + 4 > len(data):
            raise ValueError(f"truncated PNG chunk {kind!r}")
        (crc,) = struct.unpack(">I", data[end:end + 4])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos = end + 4
    raise ValueError("PNG without IEND")


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters (0 none, 1 sub, 2 up, 3 average, 4 Paeth)
    of `raw` (h rows of a filter byte and `stride` bytes); bpp is the
    bytes of one pixel, at least 1."""
    if raw.size != h * (stride + 1):
        raise ValueError(f"PNG data holds {raw.size} bytes, expected "
                         f"{h * (stride + 1)}")
    rows = raw.reshape(h, stride + 1)
    ftype = rows[:, 0].astype(np.int32)
    if (ftype > 4).any():
        raise ValueError(f"PNG filter type {int(ftype.max())}")
    npx = stride // bpp                  # stride is a multiple of bpp
    data = rows[:, 1:].astype(np.int32).reshape(h, npx, bpp)
    # a pixel's bytes depend on the reconstructed pixels to its left (a),
    # above (b) and above-left (c): every pixel of one anti-diagonal
    # y + x = d is independent of the others, so the diagonals run in
    # order, each vectorized. `out` has a zero row above and a zero
    # column left of the image.
    out = np.zeros((h + 1, npx + 1, bpp), np.int32)
    for d in range(h + npx - 1):
        y = np.arange(max(0, d - npx + 1), min(h, d + 1))
        x = d - y
        a, b, c = out[y + 1, x], out[y, x + 1], out[y, x]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        f = ftype[y][:, None]
        pred = np.select([f == 1, f == 2, f == 3, f == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        out[y + 1, x + 1] = (data[y, x] + pred) & 0xFF
    return out[1:, 1:].reshape(h, stride).astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """The RGBA uint8 pixels [H, W, 4] of the PNG at `path`, as PIL's
    `convert("RGBA")` gives them (see the module docstring)."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(PNG_SIGNATURE):
        for magic, name in _OTHER_FORMATS:
            if data.startswith(magic):
                raise UnsupportedImage(f"{path}: a {name} image; the port "
                                       "reads PNG textures only")
        if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
            raise UnsupportedImage(f"{path}: a WebP image; the port reads "
                                   "PNG textures only")
        raise ValueError(f"{path}: not a PNG file")
    header = palette = trns = None
    idat = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            if len(body) != 13:
                raise ValueError("bad IHDR")
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, ctype, comp, filt, interlace = header
    if ctype not in _CHANNELS or comp != 0 or filt != 0 or w == 0 or h == 0:
        raise ValueError(f"{path}: bad PNG header {header}")
    if depth == 16:
        raise UnsupportedImage(f"{path}: 16-bit PNG; the port reads 8-bit "
                               "samples only")
    if interlace:
        raise UnsupportedImage(f"{path}: interlaced PNG; the port reads "
                               "non-interlaced PNGs only")
    if depth not in (1, 2, 4, 8) or (depth != 8 and ctype not in (0, 3)):
        raise ValueError(f"{path}: bad PNG bit depth {depth} for colour "
                         f"type {ctype}")
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as exc:
        raise ValueError(f"{path}: corrupt PNG data ({exc})") from exc
    chans = _CHANNELS[ctype]
    stride = (w * chans * depth + 7) // 8
    rows = _unfilter(raw, h, stride, max(1, chans * depth // 8))
    if depth < 8:
        bits = np.unpackbits(rows, axis=1).reshape(h, stride * 8 // depth,
                                                   depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        samples = (bits * weights).sum(axis=-1, dtype=np.uint8)[:, :w]
    else:
        samples = rows.reshape(h, w, chans)
    rgba = np.empty((h, w, 4), np.uint8)
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{path}: palette PNG without PLTE")
        lut = np.zeros((256, 4), np.uint8)
        lut[:, 3] = 255
        lut[:len(palette), :3] = palette
        if trns is not None:
            alpha = np.frombuffer(trns, np.uint8)[:256]
            lut[:len(alpha), 3] = alpha
        return lut[samples.reshape(h, w)]
    if ctype in (0, 4):
        grey = samples.reshape(h, w, chans)[..., 0]
        if depth < 8:
            if trns is not None:
                raise UnsupportedImage(f"{path}: {depth}-bit grey PNG with "
                                       "tRNS")
            grey = (grey.astype(np.uint16) * (255 // ((1 << depth) - 1))
                    ).astype(np.uint8)
        rgba[..., :3] = grey[..., None]
        rgba[..., 3] = samples[..., 1] if ctype == 4 else 255
        if ctype == 0 and trns is not None:
            (key,) = struct.unpack(">H", trns[:2])
            rgba[..., 3] = np.where(grey == key, 0, 255)
        return rgba
    rgba[..., :chans] = samples
    if ctype == 2:
        rgba[..., 3] = 255
        if trns is not None:
            key = np.array(struct.unpack(">HHH", trns[:6]))
            rgba[..., 3] = np.where((samples == key).all(axis=-1), 0, 255)
    return rgba


def save_png(path: str, img: np.ndarray, gamma: float = 2.2) -> str:
    """Tonemap `img` and write it as an 8-bit PNG."""
    return write_png(path, tonemap(img, gamma))


def save_hdr(path: str, img: np.ndarray) -> str:
    """Radiance RGBE writer (flat scanlines)."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    maxc = img.max(axis=-1)
    frac, e = np.frexp(np.maximum(maxc, 1e-32))
    scale = np.where(maxc > 1e-32, frac * 256.0 / np.maximum(maxc, 1e-32), 0.0)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., 0] = np.clip(img[..., 0] * scale, 0, 255).astype(np.uint8)
    rgbe[..., 1] = np.clip(img[..., 1] * scale, 0, 255).astype(np.uint8)
    rgbe[..., 2] = np.clip(img[..., 2] * scale, 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(maxc > 1e-32, e + 128, 0).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode("ascii"))
        f.write(rgbe.tobytes())
    return path


def timestamped_name(base: str, samples: int, ext: str = "png") -> str:
    """<FILE>.<UTCtime>.<N>samp.png, the reference's output name."""
    ts = datetime.datetime.now(datetime.timezone.utc).strftime(
        "%Y-%m-%d_%H-%M-%Sz")
    return f"{base}.{ts}.{samples}samp.{ext}"
