"""Multi-device and multi-process rendering: pixel-split frames
(``mesh``) and the process group, frame stride and scene broadcast
(``distributed``)."""

from ndt_tpu_torch.parallel.mesh import (  # noqa: F401
    make_pixel_mesh,
    render_grid_sharded,
    render_rays_sharded,
    replicate,
    shard_rays,
)
