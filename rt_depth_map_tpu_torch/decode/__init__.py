# Copy of rt_depth_map_tpu/decode/__init__.py; the port imports nothing of the JAX package.
"""Frame decoders (L1b of the reference layer map).

Re-creates the `DecoderDevice` abstraction (include/decoder/decoder.h:9-15)
and the MJPEG->RGB decoder (decoder/mjpeg-decoder-sw.cpp), including its two
load-bearing behaviors: injecting the ISO/IEC 10918-1 K.3.3 default Huffman
tables when a UVC frame omits them (mjpeg-decoder-sw.cpp:15-93,116-119), and
swallowing corrupt frames so the pipeline keeps the previous image
(mjpeg-decoder-sw.cpp:108-110,139-141).
"""

from rt_depth_map_tpu_torch.decode.mjpeg import (  # noqa: F401
    MJPEGDecoder,
    has_huffman_tables,
    inject_default_huffman_tables,
)
