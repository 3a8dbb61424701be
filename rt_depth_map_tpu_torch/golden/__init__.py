# Copy of rt_depth_map_tpu/golden/__init__.py (BM and post-processing
# goldens only); the port imports nothing of the JAX package.
"""Golden (slow, numpy) reference implementations of the matcher semantics.

These pin down the exact OpenCV behaviors the reference delegates to in
readable numpy; `chip_smoke.py` holds the port's BM matcher on the card
against `golden_stereo_bm`.
"""

from rt_depth_map_tpu_torch.golden.bm import golden_stereo_bm  # noqa: F401
from rt_depth_map_tpu_torch.golden.postproc import (  # noqa: F401
    golden_filter_speckles,
    golden_validate_disparity,
)
