"""Live terminal preview, the counterpart of `tpt/term_viewer.py`: an
interactive viewer that needs no display server. Frames render as ANSI
truecolor half-blocks (each character cell is two vertical pixels via
U+2580 with independent fg/bg colors), and a raw-mode keyboard loop
drives the same FPS camera rig as the matplotlib viewer, so a GPU host
reached over SSH gets a progressive view.

Bindings mirror the reference's: w/x forward/back, a/e strafe, r/f
up/down, arrow keys = mouse-look (yaw/pitch, pitch clamped +-89deg), 1-6
display channels, d denoiser toggle, s save PNG, space prints the camera
JSON for scene authoring, q quits. While navigating, frames come from
the 1/scale-resolution preview engine (viewer.make_preview_renderer).

Testable headless: pass `in_stream` (scripted key bytes) and
`out_stream` (any text sink); the loop never touches termios unless
stdin is a real tty.
"""

from __future__ import annotations

import io
import os
import sys
from typing import IO, Optional

import numpy as np

from .config import DisplayMode
from .engine import Renderer
from .io.image import save_png, tonemap
from .viewer import CameraRig, make_preview_renderer

_HALF = "▀"  # upper half block: fg = top pixel, bg = bottom pixel
_HOME = "\x1b[H"
_CLEAR = "\x1b[2J"
_RESET = "\x1b[0m"
_HIDE_CUR = "\x1b[?25l"
_SHOW_CUR = "\x1b[?25h"


def _downsample(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Box-ish downsample of [H,W,3] to [h,w,3]: mean over the nearest
    source block per target cell (pure numpy; preview-grade)."""
    sh, sw = img.shape[:2]
    yi = np.minimum((np.arange(h + 1) * sh) // h, sh)
    xi = np.minimum((np.arange(w + 1) * sw) // w, sw)
    # reduceat needs strictly valid starts; rows/cols collapse when the
    # terminal grid exceeds the image — fall back to nearest sampling
    if h >= sh or w >= sw:
        yn = (np.arange(h) * sh) // h
        xn = (np.arange(w) * sw) // w
        return img[yn][:, xn]
    rows = np.add.reduceat(img, yi[:-1], axis=0)
    cnt_y = np.maximum(np.diff(yi), 1)[:, None, None]
    cols = np.add.reduceat(rows / cnt_y, xi[:-1], axis=1)
    cnt_x = np.maximum(np.diff(xi), 1)[None, :, None]
    return cols / cnt_x


def ansi_frame(img: np.ndarray, cols: int, rows: int,
               gamma: float = 2.2) -> str:
    """Render linear-radiance [H,W,3] as `rows` terminal lines of `cols`
    half-block cells (2 pixels per cell vertically). Emits truecolor SGR
    codes, re-issuing fg/bg only when they change along a line."""
    img = np.asarray(img)
    if img.dtype == np.uint8:
        # device-tonemapped u8 frame (engine.Renderer.display_u8):
        # gamma is already applied — only downsample + quantize remain
        img, gamma = img.astype(np.float32) / 255.0, 1.0
    px = tonemap(_downsample(img.astype(np.float32), 2 * rows, cols),
                 gamma)
    out = []
    for r in range(rows):
        top, bot = px[2 * r], px[2 * r + 1]
        line = []
        last_fg = last_bg = None
        for c in range(cols):
            fg = (int(top[c, 0]), int(top[c, 1]), int(top[c, 2]))
            bg = (int(bot[c, 0]), int(bot[c, 1]), int(bot[c, 2]))
            if fg != last_fg:
                line.append(f"\x1b[38;2;{fg[0]};{fg[1]};{fg[2]}m")
                last_fg = fg
            if bg != last_bg:
                line.append(f"\x1b[48;2;{bg[0]};{bg[1]};{bg[2]}m")
                last_bg = bg
            line.append(_HALF)
        line.append(_RESET)
        out.append("".join(line))
    return "\r\n".join(out)


class _KeyReader:
    """Incremental key decoder: single bytes plus 3-byte arrow escapes
    (\\x1b[A..D). Keeps a small carry buffer across reads so an escape
    split between reads still decodes."""

    ARROWS = {b"A": "up", b"B": "down", b"C": "right", b"D": "left"}

    def __init__(self) -> None:
        self.buf = b""

    def feed(self, data: bytes) -> list:
        self.buf += data
        keys = []
        while self.buf:
            b0 = self.buf[:1]
            if b0 == b"\x1b":
                if len(self.buf) < 3:
                    break  # partial escape: wait for more bytes
                if self.buf[1:2] == b"[" and self.buf[2:3] in self.ARROWS:
                    keys.append(self.ARROWS[self.buf[2:3]])
                    self.buf = self.buf[3:]
                    continue
                self.buf = self.buf[1:]  # lone ESC: drop
                continue
            keys.append(b0.decode("latin-1"))
            self.buf = self.buf[1:]
        return keys


def _read_available(stream, tty: bool) -> bytes:
    """Non-blocking drain of pending input. Anything with a real fd
    (tty, pipe) goes through select() + os.read so a quiet pipe never
    blocks the render loop; in-memory test streams read a bounded chunk
    directly."""
    try:
        fd = stream.fileno()
    except (OSError, AttributeError, io.UnsupportedOperation):
        fd = None
    if fd is not None:
        import select

        data = b""
        while select.select([fd], [], [], 0)[0]:
            chunk = os.read(fd, 64)
            if not chunk:
                break
            data += chunk
        return data
    chunk = stream.read(8)
    return chunk or b""


def run_term_viewer(renderer: Renderer, max_frames: int = 0,
                    out_dir: str = ".", preview_scale: int = 8,
                    in_stream: Optional[IO] = None,
                    out_stream: Optional[IO] = None,
                    size: Optional[tuple] = None,
                    look_step_px: float = 40.0) -> int:
    """Progressive render loop on a terminal. Returns the number of
    frames displayed. `size` = (cols, rows) of the image area; defaults
    to the live terminal size minus one status row."""
    in_stream = in_stream if in_stream is not None else sys.stdin
    out = out_stream if out_stream is not None else sys.stdout
    is_tty = hasattr(in_stream, "fileno") and os.isatty(
        in_stream.fileno()) if in_stream is sys.stdin else False

    if size is None:
        try:
            ts = os.get_terminal_size()
            size = (max(16, ts.columns - 1), max(8, ts.lines - 2))
        except OSError:
            size = (100, 40)
    cols, rows = size

    from .config import RenderMode

    # the GUI viewer's navigation engine: megakernel preview at depth 2
    preview = (make_preview_renderer(renderer, preview_scale,
                                     mode=RenderMode.MEGAKERNEL,
                                     nav_depth=2)
               if preview_scale > 1 else None)
    if preview is not None:
        preview.pipeline = True  # overlap device render with host display
    rig = CameraRig(renderer, preview)
    reader = _KeyReader()
    frame_count = 0
    quit_ = False

    old_attrs = None
    if is_tty:
        import termios
        import tty as ttymod

        old_attrs = termios.tcgetattr(in_stream.fileno())
        ttymod.setraw(in_stream.fileno(), termios.TCSANOW)
        out.write(_CLEAR + _HIDE_CUR)

    try:
        while not quit_ and (max_frames <= 0 or frame_count < max_frames):
            for k in reader.feed(_read_available(in_stream, is_tty)):
                if k == "q":
                    quit_ = True
                elif k == "w":
                    rig.move(forward=1.0)
                elif k == "x":
                    rig.move(forward=-1.0)
                elif k == "a":
                    rig.move(right=-1.0)
                elif k == "e":
                    rig.move(right=1.0)
                elif k == "r":
                    rig.move(up=1.0)
                elif k == "f":
                    rig.move(up=-1.0)
                elif k == "left":
                    rig.look(-look_step_px, 0.0)
                elif k == "right":
                    rig.look(look_step_px, 0.0)
                elif k == "up":
                    rig.look(0.0, look_step_px)
                elif k == "down":
                    rig.look(0.0, -look_step_px)
                elif k == "d":
                    renderer.gui.denoiser_on = not renderer.gui.denoiser_on
                    renderer.reset()
                elif k in "123456":
                    renderer.gui.display_mode = DisplayMode(int(k) - 1)
                elif k == "s":
                    save_png(os.path.join(out_dir, "viewer_save.png"),
                             renderer.frame()[:, ::-1])
                elif k == " ":
                    cam = renderer.cam
                    print(f'"EYE": {list(cam.position)},', file=sys.stderr)
                    print(f'"LOOKAT": {list(cam.look_at)},', file=sys.stderr)
                    print(f'"UP": {list(cam.up)},', file=sys.stderr)
            if quit_:
                break

            eng = preview if (rig.navigating and preview is not None) \
                else renderer
            img = eng.frame()
            g = eng.gui
            frame_count += 1
            status = (f"iter {frame_count} | {g.frame_ms:.1f} ms | "
                      f"{g.mrays_per_sec:.2f} MRays/s | "
                      f"{'preview' if eng is preview else ('SVGF' if g.denoiser_on else 'accum')}"
                      f" | wxaerf move, arrows look, 1-6 chan, d, s, q")
            out.write(_HOME + ansi_frame(img[:, ::-1], cols, rows)
                      + "\r\n" + _RESET + status[:cols].ljust(cols))
            out.flush()
    finally:
        if old_attrs is not None:
            import termios

            termios.tcsetattr(in_stream.fileno(), termios.TCSANOW, old_attrs)
            out.write(_SHOW_CUR + _RESET + "\r\n")
            out.flush()
    return frame_count
