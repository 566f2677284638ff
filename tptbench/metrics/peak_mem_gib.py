"""torch.cuda.max_memory_allocated() over the window (reset after
set-up), in GiB."""


def window(w):
    return w.peak_bytes / float(1 << 30)
