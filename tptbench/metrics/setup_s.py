"""Process start to the first timed frame, in seconds: imports, the
scene and its tables, the renderer, the warm-up frames, and in a
checkout's first run the port's nvcc build."""


def window(w):
    return w.setup_s
