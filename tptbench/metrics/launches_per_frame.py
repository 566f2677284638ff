"""Kernels the device ran per frame of the traced stretch, every library
counted (the port's CUDA kernels and PyTorch's eager ones)."""


def read(trace):
    k = trace.kernels()
    return len(k) / len(trace.frames) if k else None
