"""Multi-device execution over torch.distributed (port of
`rt_depth_map_tpu/parallel/`): the rank mesh, width-tile sharding and the
halo and carry exchange.

Frame and stream data parallelism over the mesh's "data" axis, and
image-tile spatial parallelism over its "space" axis, one rank a device:
`tiled_bm` (width-tiled StereoBM), `tiled_sgbm` (SGM with overlap
margins), `exact_sgbm` (SGM bit-exact across tiles, a wavefront of
boundary-L exchanges), `pipeline_sharded` (the frame step over the mesh)
and `launch` (the processes' bootstrap).
"""

from rt_depth_map_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from rt_depth_map_tpu_torch.parallel.tiled_bm import tiled_stereo_bm  # noqa: F401
