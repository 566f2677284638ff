"""Multi-device rendering over torch.distributed (`sharding.py`), SVGF over
row windows (`halo.py`) and the CPU dry run (`dryrun.py`)."""

from .sharding import (PixelMesh, make_pixel_mesh, make_sharded_step,  # noqa: F401
                       render_sharded, replicate)
