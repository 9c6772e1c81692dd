// Native multithreaded per-block canonical Huffman codec (host runtime).
//
// The host-side codec of the package: the ragged, data-dependent entropy
// stage (and, for the fused CPU path, the transform) runs here, parallel
// over 8x8 blocks with std::thread. The per-block arithmetic lives in
// block_codec.h, which the GPU kernels (codec_kernels.cu) compile too.
//
// Reference semantics: myyuv_lib/myyuv_DCT/Huffman.cpp (SURVEY.md §7) -
// zigzag scan, trailing-zero trim, optimal Huffman lengths, canonical code
// assignment with symbols ascending within a length, 11-bit symbol packing
// LSB-first, MSB-first code emission packed LSB-first within bytes.
// Produces streams the reference CLI decodes and decodes streams the
// reference CLI produces; byte-level tie-breaking of the Huffman tree is
// not part of the contract (any optimal canonical code round-trips).
//
// C ABI (ctypes-friendly); lanes layout = [n_blocks, 256] fixed-width rows
// matching formats/dct_stream.py MAX_CHUNK.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <array>
#include <atomic>
#include <thread>
#include <vector>

#include "block_codec.h"

namespace {

constexpr int kLane = 256;  // fixed lane width (chunks are 3..255 bytes)

inline uint8_t bitrev8_tbl(uint8_t v) {
  static const auto tbl = [] {
    std::array<uint8_t, 256> t{};
    for (int i = 0; i < 256; ++i) {
      uint8_t x = uint8_t(i);
      x = uint8_t(((x & 0xF0) >> 4) | ((x & 0x0F) << 4));
      x = uint8_t(((x & 0xCC) >> 2) | ((x & 0x33) << 2));
      x = uint8_t(((x & 0xAA) >> 1) | ((x & 0x55) << 1));
      t[size_t(i)] = x;
    }
    return t;
  }();
  return tbl[v];
}

// Encode one block into a zero-filled 256-byte lane. Returns the chunk
// size in bytes (3..255) or 0 on error. The shared per-block encoder
// (block_codec.h) writes stream-space words; the lane holds their bytes.
int encode_block(const int16_t* coef, uint8_t* out_lane) {
  uint32_t words[kLane / 4] = {0};
  auto sink = [&](int w, uint32_t word) { words[w] = word; };
  int size = myyuv::encode_block(coef, sink);
  if (size > myyuv::kMaxChunk) return 0;  // must fit the u8 size field
  for (int j = 0; j < kLane; ++j)
    out_lane[j] = bitrev8_tbl(uint8_t(words[j >> 2] >> (24 - 8 * (j & 3))));
  return size;
}

// Decode one chunk into a row-major int16[64] block. Returns 0 on success.
int decode_block(const uint8_t* chunk, int chunk_size, int16_t* coef) {
  if (chunk_size < 3) return 1;
  int enc_bits = chunk[0] | (chunk[1] << 8);
  int tree_size = chunk[2];
  if (3 + tree_size + (enc_bits + 7) / 8 > chunk_size) return 2;
  auto src = [&](int w) {
    uint32_t word = 0;
    for (int j = 4 * w; j < 4 * w + 4; ++j)
      word = (word << 8) | (j < chunk_size ? bitrev8_tbl(chunk[j]) : 0u);
    return word;
  };
  return myyuv::decode_block(src, coef);
}

template <typename F>
void run_parallel(int64_t n, int n_threads, F&& fn) {
  if (n_threads <= 1 || n < 2) {
    fn(0, n);
    return;
  }
  n_threads = int(std::min<int64_t>(n_threads, n));
  std::vector<std::thread> threads;
  int64_t per = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t lo = t * per, hi = std::min<int64_t>(n, lo + per);
    if (lo >= hi) break;
    threads.emplace_back([&fn, lo, hi] { fn(lo, hi); });
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// Encode n_blocks of int16[64] coefficients into fixed-width lanes
// [n_blocks, 256] + per-block sizes. Returns 0 on success, else the 1-based
// index of the first failed block (impossible-range coefficients).
int64_t myyuv_encode_blocks(const int16_t* coeffs, int64_t n_blocks,
                            uint8_t* lanes_out, uint8_t* sizes_out,
                            int32_t n_threads) {
  std::atomic<int64_t> failed{0};
  run_parallel(n_blocks, n_threads, [&](int64_t lo, int64_t hi) {
    for (int64_t k = lo; k < hi; ++k) {
      int sz = encode_block(coeffs + k * 64, lanes_out + k * kLane);
      sizes_out[k] = uint8_t(sz);
      if (sz == 0) {
        int64_t expect = 0;
        failed.compare_exchange_strong(expect, k + 1);
      }
    }
  });
  return failed.load();
}

// Compact lanes into a contiguous content buffer (exclusive-prefix-sum
// offsets, the DCTYUVPlane::getContentPos analog). Returns content length.
int64_t myyuv_compact_lanes(const uint8_t* lanes, const uint8_t* sizes,
                            int64_t n_blocks, uint8_t* content_out,
                            int32_t n_threads) {
  std::vector<int64_t> offs(size_t(n_blocks) + 1);
  offs[0] = 0;
  for (int64_t k = 0; k < n_blocks; ++k) offs[k + 1] = offs[k] + sizes[k];
  run_parallel(n_blocks, n_threads, [&](int64_t lo, int64_t hi) {
    for (int64_t k = lo; k < hi; ++k)
      std::memcpy(content_out + offs[k], lanes + k * kLane, sizes[k]);
  });
  return offs[size_t(n_blocks)];
}

// Decode a ragged stream (sizes + packed content) into int16[64] blocks.
// Returns 0 on success, else (block_index + 1) * 16 + error_code of the
// first failing block.
int64_t myyuv_decode_blocks(const uint8_t* sizes, const uint8_t* content,
                            int64_t content_len, int64_t n_blocks,
                            int16_t* coeffs_out, int32_t n_threads) {
  std::vector<int64_t> offs(size_t(n_blocks) + 1);
  offs[0] = 0;
  for (int64_t k = 0; k < n_blocks; ++k) offs[k + 1] = offs[k] + sizes[k];
  if (offs[size_t(n_blocks)] > content_len) return 15;
  std::atomic<int64_t> failed{0};
  run_parallel(n_blocks, n_threads, [&](int64_t lo, int64_t hi) {
    for (int64_t k = lo; k < hi; ++k) {
      int err = decode_block(content + offs[k], int(sizes[k]),
                             coeffs_out + k * 64);
      if (err != 0) {
        int64_t expect = 0;
        failed.compare_exchange_strong(expect, (k + 1) * 16 + err);
      }
    }
  });
  return failed.load();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Full native CPU codec path: fused per-block DCT + quantize + Huffman.
//
// Bit-exact with the reference's scalar float32 arithmetic (SURVEY.md §7.2):
// sequential ascending-k f32 accumulation in the two 8x8 matmuls, f32
// division by the quality-scaled table, std::round half-away-from-zero.
// MUST be compiled with -ffp-contract=off: -march=native enables FMA3 and
// GCC would otherwise contract mul+add into single-rounded FMAs, breaking
// bit-exactness (kernels/device.py guards the XLA path the same way).
// ---------------------------------------------------------------------------

namespace {

const float kDct[64] = {MYYUV_DCT_MATRIX};

void dct_quantize_block(const uint8_t* px, int stride, const float* qtab,
                        int16_t* coef) {
  float x[64];
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 8; ++j)
      x[i * 8 + j] = float(px[i * stride + j]) - 128.0f;
  myyuv::dct_quantize(x, qtab, kDct, coef);
}

void dequantize_idct_block(const int16_t* coef, const float* qtab,
                           uint8_t* px, int stride) {
  uint8_t out[64];
  myyuv::dequantize_idct(coef, qtab, kDct, out);
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 8; ++j) px[i * stride + j] = out[i * 8 + j];
}

}  // namespace

extern "C" {

// Fused plane compress: [H, W] u8 plane -> per-block chunks in lanes +
// sizes. Returns 0 on success or 1-based failing block index.
int64_t myyuv_compress_plane(const uint8_t* plane, int64_t width,
                             int64_t height, const float* qtab,
                             uint8_t* lanes_out, uint8_t* sizes_out,
                             int32_t n_threads) {
  int64_t bw = width / 8, bh = height / 8;
  std::atomic<int64_t> failed{0};
  run_parallel(bw * bh, n_threads, [&](int64_t lo, int64_t hi) {
    int16_t coef[64];
    for (int64_t k = lo; k < hi; ++k) {
      int64_t by = k / bw, bx = k % bw;
      const uint8_t* px = plane + (by * 8) * width + bx * 8;
      dct_quantize_block(px, int(width), qtab, coef);
      int sz = encode_block(coef, lanes_out + k * kLane);
      sizes_out[k] = uint8_t(sz);
      if (sz == 0) {
        int64_t expect = 0;
        failed.compare_exchange_strong(expect, k + 1);
      }
    }
  });
  return failed.load();
}

// Fused plane decompress: ragged chunk stream -> [H, W] u8 plane.
// Returns 0 on success, else (block+1)*16 + error code.
int64_t myyuv_decompress_plane(const uint8_t* sizes, const uint8_t* content,
                               int64_t content_len, int64_t width,
                               int64_t height, const float* qtab,
                               uint8_t* plane_out, int32_t n_threads) {
  int64_t bw = width / 8, bh = height / 8, nb = bw * bh;
  std::vector<int64_t> offs(size_t(nb) + 1);
  offs[0] = 0;
  for (int64_t k = 0; k < nb; ++k) offs[k + 1] = offs[k] + sizes[k];
  if (offs[size_t(nb)] > content_len) return 15;
  std::atomic<int64_t> failed{0};
  run_parallel(nb, n_threads, [&](int64_t lo, int64_t hi) {
    int16_t coef[64];
    for (int64_t k = lo; k < hi; ++k) {
      int err = decode_block(content + offs[k], int(sizes[k]), coef);
      if (err != 0) {
        int64_t expect = 0;
        failed.compare_exchange_strong(expect, (k + 1) * 16 + err);
        continue;
      }
      int64_t by = k / bw, bx = k % bw;
      dequantize_idct_block(coef, qtab, plane_out + (by * 8) * width + bx * 8,
                            int(width));
    }
  });
  return failed.load();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Word-aligned device interchange <-> exact byte stream conversion.
//
// The device codec kernels produce/consume per-block chunks packed into
// big-endian u32 words of BIT-REVERSED bytes, with each chunk padded to a
// 4-byte boundary (the "aligned word stream"). These converters translate
// between that interchange and the reference's exact packed byte stream
// (DCTYUVPlane content, DCT.cpp:16-110) in one linear pass.
// ---------------------------------------------------------------------------


extern "C" {

// words: aligned word stream — each chunk occupies ceil(size/(4*align))
// groups of `align` u32s (align=1 is plain 4-byte alignment; the device
// interchange uses align=4 = 16-byte rows so stream (de)compaction on chip
// runs as vectorized row gathers). out must hold sum(sizes) bytes.
// Returns bytes written.
int64_t myyuv_repack_words(const uint32_t* words, const int32_t* sizes,
                           int64_t n_blocks, int32_t align, uint8_t* out) {
  int64_t w = 0, o = 0;
  const int chunk_bytes = 4 * align;
  for (int64_t b = 0; b < n_blocks; ++b) {
    const int s = sizes[b];
    const uint32_t* src = words + w;
    for (int j = 0; j < s; ++j) {
      const uint8_t byte = uint8_t(src[j >> 2] >> (24 - 8 * (j & 3)));
      out[o++] = bitrev8_tbl(byte);
    }
    w += int64_t((s + chunk_bytes - 1) / chunk_bytes) * align;
  }
  return o;
}

// Split-stream interchange -> exact packed byte stream. a is
// [64, a_cols] PACKED-8 (the decoder's W0 window layout: word w of
// block i at a[(8*w + (i&7))*a_cols + (i>>3)]) holding each chunk's
// first 32 bytes; b holds the live continuation rows (8 u32 = 32 bytes
// each) GLOBALLY STREAM-COMPACTED back to back in block order
// (capb rows total). out must hold sum(sizes) bytes.
int64_t myyuv_repack_split(const uint32_t* a, const uint32_t* b,
                           const int32_t* sizes, int64_t n_blocks,
                           int64_t a_cols, int64_t capb, uint8_t* out) {
  int64_t o = 0, brow = 0;
  for (int64_t i = 0; i < n_blocks; ++i) {
    const int s = sizes[i];
    const int sa = s < 32 ? s : 32;
    const uint32_t* acol = a + int64_t(i & 7) * a_cols + (i >> 3);
    for (int j = 0; j < sa; ++j) {
      const uint32_t w = acol[int64_t(8 * (j >> 2)) * a_cols];
      out[o++] = bitrev8_tbl(uint8_t(w >> (24 - 8 * (j & 3))));
    }
    for (int j = 32; j < s; ++j) {
      const int64_t r = brow + ((j - 32) >> 5);
      const uint32_t w =
          r < capb ? b[r * 8 + (((j - 32) >> 2) & 7)] : 0;
      out[o++] = bitrev8_tbl(uint8_t(w >> (24 - 8 * (j & 3))));
    }
    if (s > 32) brow += int64_t((s - 32 + 31) / 32);
  }
  return o;
}

// Inverse: exact packed byte stream -> split-stream interchange. a must
// hold 64*a_cols u32s (a_cols >= ceil(n/8); packed-8 W0 layout), b
// capb rows of 8 u32s (globally stream-compacted, zero-padded).
// Returns the live B row count (<= capb when valid).
int64_t myyuv_expand_split(const uint8_t* content, const int32_t* sizes,
                           int64_t n_blocks, int64_t a_cols, int64_t capb,
                           uint32_t* a, uint32_t* b) {
  for (int64_t k = 0; k < 64 * a_cols; ++k) a[k] = 0;
  for (int64_t k = 0; k < capb * 8; ++k) b[k] = 0;
  // pad blocks (n..8*a_cols) carry the minimal valid all-zero-block
  // chunk header word (kernels/words.FILLER_W0: enc_bits=1, tree=3 B)
  // so the decode kernels' loop bounds stay sane
  for (int64_t i = n_blocks; i < 8 * a_cols; ++i)
    a[int64_t(i & 7) * a_cols + (i >> 3)] = 0x8000c000u;
  int64_t o = 0, brow = 0;
  for (int64_t i = 0; i < n_blocks; ++i) {
    const int s = sizes[i];
    const int sa = s < 32 ? s : 32;
    uint32_t* acol = a + int64_t(i & 7) * a_cols + (i >> 3);
    for (int j = 0; j < sa; ++j)
      acol[int64_t(8 * (j >> 2)) * a_cols] |=
          uint32_t(bitrev8_tbl(content[o + j])) << (24 - 8 * (j & 3));
    for (int j = 32; j < s; ++j) {
      const int64_t r = brow + ((j - 32) >> 5);
      if (r < capb)
        b[r * 8 + (((j - 32) >> 2) & 7)] |=
            uint32_t(bitrev8_tbl(content[o + j])) << (24 - 8 * (j & 3));
    }
    if (s > 32) brow += int64_t((s - 32 + 31) / 32);
    o += s;
  }
  return brow;
}

// Inverse: exact packed byte stream -> aligned word stream. words_out must
// hold sum(align * ceil(sizes/(4*align))) u32s (zero-padding within each
// block's tail). Returns words written.
int64_t myyuv_expand_words(const uint8_t* content, const int32_t* sizes,
                           int64_t n_blocks, int32_t align,
                           uint32_t* words_out) {
  int64_t w = 0, o = 0;
  const int chunk_bytes = 4 * align;
  for (int64_t b = 0; b < n_blocks; ++b) {
    const int s = sizes[b];
    const int64_t nw = int64_t((s + chunk_bytes - 1) / chunk_bytes) * align;
    for (int64_t k = 0; k < nw; ++k) words_out[w + k] = 0;
    for (int j = 0; j < s; ++j) {
      words_out[w + (j >> 2)] |=
          uint32_t(bitrev8_tbl(content[o + j])) << (24 - 8 * (j & 3));
    }
    o += s;
    w += nw;
  }
  return w;
}

}  // extern "C"
