# Copy of rt_depth_map_tpu/utils/__init__.py; the port imports nothing of the JAX package.
"""Cross-cutting utilities (reference include/debug.h, misc headers)."""
