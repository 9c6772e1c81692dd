#!/bin/bash
# Build the native libraries ahead of first use (both also build themselves
# on first use): the host codec (myyuv_tpu/native/entropy.cpp) and the
# word-frame codec kernels (myyuv_tpu/native/codec_kernels.cu) for the CPU
# and, where nvcc is found, for Hopper GPUs. Outputs go to
# myyuv_tpu/native/ and <checkout>/build/.
set -e
cd "$(dirname "$0")/.."
python - <<'EOF'
from pathlib import Path

from myyuv_tpu import native

assert native.build(force=True), "host codec build failed"
print("built", native._LIB_PATH)
print("built", native.build_codec_kernels("cpu"))
if Path(native.nvcc()).exists():
    print("built", native.build_codec_kernels("gpu"))
EOF
