"""tpt_torch — the PyTorch/CUDA port of tpt for NVIDIA Hopper.

A second package beside the JAX reference `tpt/`: the same module and
function names, the same table layouts and RNG streams, with plain
PyTorch for the tensor code and hand-written CUDA kernels (`csrc/`) in
place of the Pallas TPU kernels. It imports `torch` and `numpy`, never
`jax` and nothing of `tpt`.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; without a GPU and without that request they raise.
"""

__version__ = "0.1.0"

from .config import DisplayMode, RayCastBackend, RenderConfig, RenderMode  # noqa: F401
from .engine import Renderer  # noqa: F401,E402
