"""myyuv-tpu: a JAX batched image codec engine for NVIDIA GPUs.

A from-scratch JAX/XLA/Pallas re-design with the capabilities of the
reference C++ project ``mahbhlddnhakkh/yuv-manipulations-2`` (the "myyuv"
library/CLI/viewers): BMP XRGB8888 -> IYUV 4:2:0 conversion, an 8x8 DCT-II +
quality-scaled quantization + per-block canonical Huffman codec over the
byte-compatible ``.myyuv`` container, batched over frames and sharded over
device meshes.

Layering (bottom-up, SURVEY.md §8):
  formats/  — byte-exact BMP / .myyuv / compressed-stream containers (host)
  kernels/  — colorspace + DCT/quant compute kernels (scalar oracle + JAX)
  entropy/  — canonical Huffman encode/decode (scalar oracle + vectorized JAX)
  engine/   — batched jit pipelines, host fallback codec, registry wiring
  parallel/ — meshes, shardings, multi-host collectives
  runtime/  — native C++ helpers, timing/metrics, structured errors
  viewer/   — RGB export (the GPU-shader math of the reference viewers)
"""

from .formats.bmp import BMPImage
from .formats.yuv import (Compressions, FourccFormats, YUVImage, fourcc,
                          is_implemented)
from .engine.host_codec import register_host_codecs

register_host_codecs()

# The JAX engine upgrades the registry entries to the batched device
# pipelines when imported; importing it here keeps `import myyuv_tpu`
# one-stop. Only a missing jax leaves the host paths in charge: any other
# failure of the device engine propagates instead of hiding the device.
try:
    from .engine import pipeline as _pipeline
except ImportError as e:
    if e.name is None or not e.name.startswith("jax"):
        raise
    _HAVE_JAX_ENGINE = False
else:
    _pipeline.register_engine_codecs()
    _HAVE_JAX_ENGINE = True

__all__ = [
    "BMPImage", "YUVImage", "FourccFormats", "Compressions", "fourcc",
    "is_implemented",
]

__version__ = "0.1.0"
