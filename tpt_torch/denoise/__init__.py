"""SVGF denoising: the plain PyTorch pipeline (`svgf`) and the wrappers of
its two CUDA kernels, the a-trous stencil (`stencil`, K5) and temporal
reprojection (`reproject`, K6)."""
