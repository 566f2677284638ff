"""Millions of paths completed a second: every path of the window's
frames (pixels x spp_batch x frames) over the window's seconds."""


def window(w):
    return w.paths_per_frame * len(w.frame_s) / w.seconds / 1e6
