// Word-frame codec kernels as XLA FFI handlers: fused DCT + quantize +
// Huffman encode, and fused Huffman decode + dequantize + IDCT, one thread
// per 8x8 block (kernels/codec.py calls them through jax.ffi).
//
// nvcc builds the GPU kernels (-fmad=false: no contraction of the
// transform's multiply-adds). The same file compiled as C++ by g++
// (-ffp-contract=off) gives a CPU build of the same handlers, which runs
// the identical per-block arithmetic of block_codec.h in the CPU tests.
//
// Thread (c, r) owns block 8c + r of a [*, cols] region, so the 32
// threads of a warp walk 32 consecutive columns of one sublane row: every
// word the kernel reads or writes is a coalesced 128-byte row segment.

#include <cstdint>
#include <string>

#include "block_codec.h"
#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

// Lane columns per thread block; kernels/codec.py COLS mirrors it.
constexpr int kCols = 32;

struct Frame {
  int64_t cols;
  int cont;
};

ffi::Error check_shapes(ffi::AnyBuffer::Dimensions xw_dims,
                        ffi::AnyBuffer::Dimensions a_dims,
                        ffi::AnyBuffer::Dimensions c_dims, int64_t n_pids,
                        int64_t n_qts) {
  if (xw_dims.size() != 2 || xw_dims[0] != 128 || a_dims.size() != 2 ||
      a_dims[0] != 64 || c_dims.size() != 2 || c_dims[0] % 8 != 0 ||
      a_dims[1] != xw_dims[1] || c_dims[1] != xw_dims[1] ||
      n_pids != xw_dims[1] || n_qts != 3 * 64)
    return ffi::Error::InvalidArgument("myyuv codec: inconsistent shapes");
  return ffi::Error::Success();
}

}  // namespace

#ifdef __CUDACC__

__constant__ float kDctDev[64] = {MYYUV_DCT_MATRIX};

__global__ void encode_kernel(const uint32_t* xw, const float* qts,
                              const int32_t* pids, Frame f, uint32_t* a,
                              uint32_t* cr, int32_t* sizes, int32_t* ok) {
  int64_t c = int64_t(blockIdx.x) * kCols + threadIdx.x;
  int r = threadIdx.y;
  if (c >= f.cols) return;
  int size = myyuv::encode_word_block(xw, qts, pids, kDctDev, f.cols, r, c,
                                      f.cont, a, cr);
  sizes[8 * c + r] = size;
  ok[8 * c + r] = size >= 3 && size <= myyuv::kMaxChunk &&
                  size <= 4 * (8 + f.cont);
}

__global__ void decode_kernel(const uint32_t* a, const uint32_t* cr,
                              const float* qts, const int32_t* pids, Frame f,
                              uint32_t* xw, int32_t* ok) {
  int64_t c = int64_t(blockIdx.x) * kCols + threadIdx.x;
  int r = threadIdx.y;
  if (c >= f.cols) return;
  int err = myyuv::decode_word_block(a, cr, qts, pids, kDctDev, f.cols, r, c,
                                     f.cont, xw);
  ok[8 * c + r] = err == 0;
}

static ffi::Error launch_status() {
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess)
    return ffi::Error::Internal(std::string("myyuv codec kernel: ") +
                                cudaGetErrorString(e));
  return ffi::Error::Success();
}

static ffi::Error EncodeWords(cudaStream_t stream, ffi::Buffer<ffi::S32> xw,
                              ffi::Buffer<ffi::F32> qts,
                              ffi::Buffer<ffi::S32> pids,
                              ffi::ResultBuffer<ffi::S32> a,
                              ffi::ResultBuffer<ffi::S32> cr,
                              ffi::ResultBuffer<ffi::S32> sizes,
                              ffi::ResultBuffer<ffi::S32> ok) {
  ffi::Error e = check_shapes(xw.dimensions(), a->dimensions(),
                              cr->dimensions(), pids.element_count(),
                              qts.element_count());
  if (e.failure()) return e;
  Frame f{xw.dimensions()[1], int(cr->dimensions()[0] / 8)};
  if (f.cols == 0) return ffi::Error::Success();
  dim3 grid(unsigned((f.cols + kCols - 1) / kCols)), block(kCols, 8);
  encode_kernel<<<grid, block, 0, stream>>>(
      reinterpret_cast<const uint32_t*>(xw.typed_data()), qts.typed_data(),
      pids.typed_data(), f, reinterpret_cast<uint32_t*>(a->typed_data()),
      reinterpret_cast<uint32_t*>(cr->typed_data()), sizes->typed_data(),
      ok->typed_data());
  return launch_status();
}

static ffi::Error DecodeWords(cudaStream_t stream, ffi::Buffer<ffi::S32> a,
                              ffi::Buffer<ffi::S32> cr,
                              ffi::Buffer<ffi::F32> qts,
                              ffi::Buffer<ffi::S32> pids,
                              ffi::ResultBuffer<ffi::S32> xw,
                              ffi::ResultBuffer<ffi::S32> ok) {
  ffi::Error e = check_shapes(xw->dimensions(), a.dimensions(),
                              cr.dimensions(), pids.element_count(),
                              qts.element_count());
  if (e.failure()) return e;
  Frame f{a.dimensions()[1], int(cr.dimensions()[0] / 8)};
  if (f.cols == 0) return ffi::Error::Success();
  dim3 grid(unsigned((f.cols + kCols - 1) / kCols)), block(kCols, 8);
  decode_kernel<<<grid, block, 0, stream>>>(
      reinterpret_cast<const uint32_t*>(a.typed_data()),
      reinterpret_cast<const uint32_t*>(cr.typed_data()), qts.typed_data(),
      pids.typed_data(), f, reinterpret_cast<uint32_t*>(xw->typed_data()),
      ok->typed_data());
  return launch_status();
}

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    MyyuvEncodeWords, EncodeWords,
    ffi::Ffi::Bind()
        .Ctx<ffi::PlatformStream<cudaStream_t>>()
        .Arg<ffi::Buffer<ffi::S32>>()
        .Arg<ffi::Buffer<ffi::F32>>()
        .Arg<ffi::Buffer<ffi::S32>>()
        .Ret<ffi::Buffer<ffi::S32>>()
        .Ret<ffi::Buffer<ffi::S32>>()
        .Ret<ffi::Buffer<ffi::S32>>()
        .Ret<ffi::Buffer<ffi::S32>>());

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    MyyuvDecodeWords, DecodeWords,
    ffi::Ffi::Bind()
        .Ctx<ffi::PlatformStream<cudaStream_t>>()
        .Arg<ffi::Buffer<ffi::S32>>()
        .Arg<ffi::Buffer<ffi::S32>>()
        .Arg<ffi::Buffer<ffi::F32>>()
        .Arg<ffi::Buffer<ffi::S32>>()
        .Ret<ffi::Buffer<ffi::S32>>()
        .Ret<ffi::Buffer<ffi::S32>>());

#else  // CPU build: the same per-block bodies in a loop over blocks

static const float kDctHost[64] = {MYYUV_DCT_MATRIX};

static ffi::Error EncodeWords(ffi::Buffer<ffi::S32> xw,
                              ffi::Buffer<ffi::F32> qts,
                              ffi::Buffer<ffi::S32> pids,
                              ffi::ResultBuffer<ffi::S32> a,
                              ffi::ResultBuffer<ffi::S32> cr,
                              ffi::ResultBuffer<ffi::S32> sizes,
                              ffi::ResultBuffer<ffi::S32> ok) {
  ffi::Error e = check_shapes(xw.dimensions(), a->dimensions(),
                              cr->dimensions(), pids.element_count(),
                              qts.element_count());
  if (e.failure()) return e;
  Frame f{xw.dimensions()[1], int(cr->dimensions()[0] / 8)};
  for (int64_t c = 0; c < f.cols; ++c)
    for (int r = 0; r < 8; ++r) {
      int size = myyuv::encode_word_block(
          reinterpret_cast<const uint32_t*>(xw.typed_data()),
          qts.typed_data(), pids.typed_data(), kDctHost, f.cols, r, c, f.cont,
          reinterpret_cast<uint32_t*>(a->typed_data()),
          reinterpret_cast<uint32_t*>(cr->typed_data()));
      sizes->typed_data()[8 * c + r] = size;
      ok->typed_data()[8 * c + r] = size >= 3 && size <= myyuv::kMaxChunk &&
                                    size <= 4 * (8 + f.cont);
    }
  return ffi::Error::Success();
}

static ffi::Error DecodeWords(ffi::Buffer<ffi::S32> a,
                              ffi::Buffer<ffi::S32> cr,
                              ffi::Buffer<ffi::F32> qts,
                              ffi::Buffer<ffi::S32> pids,
                              ffi::ResultBuffer<ffi::S32> xw,
                              ffi::ResultBuffer<ffi::S32> ok) {
  ffi::Error e = check_shapes(xw->dimensions(), a.dimensions(),
                              cr.dimensions(), pids.element_count(),
                              qts.element_count());
  if (e.failure()) return e;
  Frame f{a.dimensions()[1], int(cr.dimensions()[0] / 8)};
  for (int64_t c = 0; c < f.cols; ++c)
    for (int r = 0; r < 8; ++r) {
      int err = myyuv::decode_word_block(
          reinterpret_cast<const uint32_t*>(a.typed_data()),
          reinterpret_cast<const uint32_t*>(cr.typed_data()),
          qts.typed_data(), pids.typed_data(), kDctHost, f.cols, r, c, f.cont,
          reinterpret_cast<uint32_t*>(xw->typed_data()));
      ok->typed_data()[8 * c + r] = err == 0;
    }
  return ffi::Error::Success();
}

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    MyyuvEncodeWords, EncodeWords,
    ffi::Ffi::Bind()
        .Arg<ffi::Buffer<ffi::S32>>()
        .Arg<ffi::Buffer<ffi::F32>>()
        .Arg<ffi::Buffer<ffi::S32>>()
        .Ret<ffi::Buffer<ffi::S32>>()
        .Ret<ffi::Buffer<ffi::S32>>()
        .Ret<ffi::Buffer<ffi::S32>>()
        .Ret<ffi::Buffer<ffi::S32>>());

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    MyyuvDecodeWords, DecodeWords,
    ffi::Ffi::Bind()
        .Arg<ffi::Buffer<ffi::S32>>()
        .Arg<ffi::Buffer<ffi::S32>>()
        .Arg<ffi::Buffer<ffi::F32>>()
        .Arg<ffi::Buffer<ffi::S32>>()
        .Ret<ffi::Buffer<ffi::S32>>()
        .Ret<ffi::Buffer<ffi::S32>>());

#endif
