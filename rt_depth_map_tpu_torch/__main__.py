# Copy of rt_depth_map_tpu/__main__.py; the port imports nothing of the JAX package.
from rt_depth_map_tpu_torch.cli import main

raise SystemExit(main())
