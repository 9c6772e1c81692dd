// Per-block codec arithmetic shared by the host library and the GPU kernels.
//
// Every function here is compiled twice: by g++ into the host library
// (entropy.cpp, with -ffp-contract=off) and by nvcc into the GPU kernels
// (codec_kernels.cu, with -fmad=false). One source therefore defines the
// arithmetic that the CPU tests check and the card runs.
//
// Bitstream contract (reference semantics: myyuv_lib/myyuv_DCT/Huffman.cpp,
// SURVEY.md §7): per-block chunk = u16 enc_bits LE, u8 tree_size, tree
// groups (header byte (len-1)<<5 | (cnt-1), then cnt 11-bit symbols packed
// LSB-first, padded to a byte), then the payload codes MSB-first packed
// LSB-first in bytes.
//
// Chunks are produced and consumed in STREAM SPACE: 32-bit words holding
// the chunk's bytes bit-reversed and packed big-endian, so stream bit p is
// bit 31 - p % 32 of word p / 32 and the whole chunk reads MSB-first. That
// is the device interchange's word format; native.repack_split turns it
// into the on-disk bytes.
//
// The transform follows the reference's scalar float32 arithmetic
// (DCT.cpp:232-277,325-365): ascending-k accumulation rounded after every
// multiply and add, IEEE division by the quality-scaled table, round half
// away from zero.

#pragma once

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#define MYYUV_HD __host__ __device__ __forceinline__
#else
#define MYYUV_HD inline
#endif

// float32 orthonormal DCT-II matrix (row-major); the 64 constants are part
// of the format contract (kernels/constants.py DCT_MATRIX8).
#define MYYUV_DCT_MATRIX                                                     \
  0.3535533845424652f, 0.3535533845424652f, 0.3535533845424652f,            \
      0.3535533845424652f, 0.3535533845424652f, 0.3535533845424652f,        \
      0.3535533845424652f, 0.3535533845424652f, 0.4903925955295563f,        \
      0.4157347679138184f, 0.277785062789917f, 0.09754510968923569f,        \
      -0.09754515439271927f, -0.2777851521968842f, -0.4157347977161407f,    \
      -0.4903926253318787f, 0.4619397222995758f, 0.1913416981697083f,       \
      -0.1913417428731918f, -0.4619397819042206f, -0.4619397222995758f,     \
      -0.1913415491580963f, 0.1913417875766754f, 0.4619397521018982f,       \
      0.4157347679138184f, -0.09754515439271927f, -0.4903926253318787f,     \
      -0.2777849733829498f, 0.2777851819992065f, 0.4903925955295563f,       \
      0.09754502773284912f, -0.4157348573207855f, 0.3535533547401428f,      \
      -0.3535533547401428f, -0.353553295135498f, 0.3535534739494324f,       \
      0.3535533547401428f, -0.3535535931587219f, -0.3535532355308533f,      \
      0.3535533845424652f, 0.277785062789917f, -0.4903926253318787f,        \
      0.09754519909620285f, 0.4157346487045288f, -0.4157348573207855f,      \
      -0.09754510223865509f, 0.4903926253318787f, -0.2777853906154633f,     \
      0.1913416981697083f, -0.4619397222995758f, 0.4619397521018982f,       \
      -0.1913419365882874f, -0.1913414746522903f, 0.4619396328926086f,      \
      -0.4619398415088654f, 0.1913419365882874f, 0.09754510968923569f,      \
      -0.2777849733829498f, 0.4157346487045288f, -0.4903925657272339f,      \
      0.4903926849365234f, -0.4157347679138184f, 0.2777855396270752f,       \
      -0.09754576534032822f

namespace myyuv {

constexpr int kMaxSyms = 64;    // distinct symbols per block <= message size
constexpr int kMaxChunk = 255;  // chunk sizes are a u8 field

MYYUV_HD uint32_t bitrev(uint32_t v, int n) {
  uint32_t r = 0;
  for (int i = 0; i < n; ++i) r |= ((v >> i) & 1u) << (n - 1 - i);
  return r;
}

// One step of the JPEG zigzag walk over an 8x8 block: message position i
// reads coefficient (row, col) of the walk's i-th step (entropy/reference.py
// ZIGZAG). Walking avoids a lookup table that host and device would have
// to place in different memory spaces.
MYYUV_HD void zigzag_next(int& row, int& col) {
  if (((row + col) & 1) == 0) {  // moving up-right
    if (col == 7) ++row;
    else if (row == 0) ++col;
    else { --row; ++col; }
  } else {                       // moving down-left
    if (row == 7) ++col;
    else if (col == 0) ++row;
    else { ++row; --col; }
  }
}

// ---------------------------------------------------------------------------
// Transform
// ---------------------------------------------------------------------------

// x[64] pixel values centred by -128 (row-major) -> quantized coefficients.
MYYUV_HD void dct_quantize(const float* x, const float* qtab, const float* dct,
                           int16_t* coef) {
  float t[64];
  for (int i = 0; i < 8; ++i)  // t = C . X
    for (int j = 0; j < 8; ++j) {
      float acc = dct[i * 8] * x[j];
      for (int k = 1; k < 8; ++k) acc = acc + dct[i * 8 + k] * x[k * 8 + j];
      t[i * 8 + j] = acc;
    }
  for (int i = 0; i < 8; ++i)  // coef = T . C^T, then divide and round
    for (int j = 0; j < 8; ++j) {
      float acc = t[i * 8] * dct[j * 8];
      for (int k = 1; k < 8; ++k) acc = acc + t[i * 8 + k] * dct[j * 8 + k];
      coef[i * 8 + j] = int16_t(roundf(acc / qtab[i * 8 + j]));
    }
}

// quantized coefficients (row-major) -> pixels 0..255.
MYYUV_HD void dequantize_idct(const int16_t* coef, const float* qtab,
                              const float* dct, uint8_t* px) {
  float x[64], t[64];
  for (int i = 0; i < 64; ++i) x[i] = float(coef[i]) * qtab[i];
  for (int i = 0; i < 8; ++i)  // t = C^T . X
    for (int j = 0; j < 8; ++j) {
      float acc = dct[i] * x[j];
      for (int k = 1; k < 8; ++k) acc = acc + dct[k * 8 + i] * x[k * 8 + j];
      t[i * 8 + j] = acc;
    }
  for (int i = 0; i < 8; ++i)  // pixels = T . C
    for (int j = 0; j < 8; ++j) {
      float acc = t[i * 8] * dct[j];
      for (int k = 1; k < 8; ++k) acc = acc + t[i * 8 + k] * dct[k * 8 + j];
      int v = int(roundf(acc)) + 128;
      px[i * 8 + j] = uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
}

// ---------------------------------------------------------------------------
// Stream-space bit writer / reader
// ---------------------------------------------------------------------------

// Appends MSB-first fields and hands every completed word to sink(w, word).
template <class Sink>
struct WordWriter {
  Sink& sink;
  uint64_t acc = 0;
  int nbits = 0;  // pending bits in the low end of acc
  int w = 0;      // index of the next word to emit
  MYYUV_HD explicit WordWriter(Sink& s) : sink(s) {}
  MYYUV_HD void put(uint32_t v, int n) {  // n <= 32, v < 2^n
    if (n == 0) return;
    acc = (acc << n) | v;
    nbits += n;
    if (nbits >= 32) {
      nbits -= 32;
      sink(w++, uint32_t(acc >> nbits));
    }
  }
  MYYUV_HD void align_byte() { put(0, (8 - (nbits & 7)) & 7); }
  MYYUV_HD void flush() {
    if (nbits > 0) sink(w++, uint32_t(acc << (32 - nbits)));
    nbits = 0;
  }
};

// Reads MSB-first fields from src(w) (which returns 0 past the chunk).
template <class Src>
struct WordReader {
  Src& src;
  uint64_t win = 0;  // valid bits left-aligned
  int nvalid = 0;
  int w = 0;
  MYYUV_HD explicit WordReader(Src& s) : src(s) {}
  MYYUV_HD void refill() {
    while (nvalid <= 32) {
      win |= uint64_t(src(w++)) << (32 - nvalid);
      nvalid += 32;
    }
  }
  MYYUV_HD uint32_t peek(int n) {  // 1 <= n <= 32
    refill();
    return uint32_t(win >> (64 - n));
  }
  MYYUV_HD void skip(int n) {  // n <= 32
    refill();
    win = n >= 64 ? 0 : win << n;
    nvalid -= n;
  }
  MYYUV_HD uint32_t get(int n) {
    if (n == 0) return 0;
    uint32_t v = peek(n);
    skip(n);
    return v;
  }
};

// ---------------------------------------------------------------------------
// Encoder
// ---------------------------------------------------------------------------

// Stable insertion sort of idx[0..n) by key[idx[i]] ascending.
template <class K>
MYYUV_HD void sort_indices(uint8_t* idx, int n, const K* key) {
  for (int i = 1; i < n; ++i) {
    uint8_t v = idx[i];
    int j = i - 1;
    while (j >= 0 && key[idx[j]] > key[v]) {
      idx[j + 1] = idx[j];
      --j;
    }
    idx[j + 1] = v;
  }
}

// Optimal Huffman code lengths of n symbols with weights w via a stable
// weight sort and the two-queue merge (leaves win ties); lengths to len.
MYYUV_HD void huffman_lengths(const uint8_t* w, int n, uint8_t* len) {
  if (n == 1) {  // single-symbol message gets code length 1
    len[0] = 1;
    return;
  }
  uint8_t order[kMaxSyms], leafw[kMaxSyms], intw[kMaxSyms];
  uint8_t parent[2 * kMaxSyms], depth[2 * kMaxSyms];
  for (int i = 0; i < n; ++i) order[i] = uint8_t(i);
  sort_indices(order, n, w);
  for (int i = 0; i < n; ++i) leafw[i] = w[order[i]];
  // node ids: 0..n-1 sorted leaves, n.. internal nodes in creation order
  int lh = 0, ih = 0, it = 0;
  for (int m = 0; m < n - 1; ++m) {
    int wsum = 0;
    for (int p = 0; p < 2; ++p) {
      int node;
      if (lh < n && (ih >= it || leafw[lh] <= intw[ih])) {
        wsum += leafw[lh];
        node = lh++;
      } else {
        wsum += intw[ih];
        node = n + ih++;
      }
      parent[node] = uint8_t(n + it);
    }
    intw[it++] = uint8_t(wsum);
  }
  // parents always have larger ids than children: sweep ids descending
  depth[n + it - 1] = 0;
  for (int id = n + it - 2; id >= 0; --id) depth[id] = depth[parent[id]] + 1;
  for (int i = 0; i < n; ++i) len[order[i]] = depth[i];
}

// Encode one block of quantized coefficients (row-major) as a chunk in
// stream space: words go to sink(w, word) in order w = 0, 1, ..., the last
// one zero-padded. Returns the chunk size in bytes, or 0 if no code of
// length <= 8 exists (impossible for 64 weights, whose total < Fib(11)).
template <class Sink>
MYYUV_HD int encode_block(const int16_t* coef, Sink& sink) {
  // zigzag scan + trailing-zero trim (all-zero -> single 0 symbol)
  int16_t msg[64];
  int mlen = 0;
  {
    int row = 0, col = 0;
    for (int i = 0; i < 64; ++i) {
      msg[i] = coef[row * 8 + col];
      if (msg[i] != 0) mlen = i + 1;
      zigzag_next(row, col);
    }
  }
  if (mlen == 0) mlen = 1;

  // distinct symbols ascending + frequencies
  int16_t syms[kMaxSyms];
  uint8_t freq[kMaxSyms];
  int n_sym = 0;
  {
    int16_t s[64];
    for (int i = 0; i < mlen; ++i) {
      int16_t v = msg[i];
      int j = i - 1;
      while (j >= 0 && s[j] > v) {
        s[j + 1] = s[j];
        --j;
      }
      s[j + 1] = v;
    }
    for (int i = 0; i < mlen; ++i) {
      if (n_sym == 0 || s[i] != syms[n_sym - 1]) {
        syms[n_sym] = s[i];
        freq[n_sym++] = 1;
      } else {
        ++freq[n_sym - 1];
      }
    }
  }

  uint8_t lens[kMaxSyms];
  huffman_lengths(freq, n_sym, lens);

  // canonical order: (length, symbol) ascending; syms[] is symbol-ascending
  // so a stable sort by length suffices. Codes follow the canonical
  // first-code recurrence.
  uint8_t corder[kMaxSyms], code[kMaxSyms];
  for (int i = 0; i < n_sym; ++i) corder[i] = uint8_t(i);
  sort_indices(corder, n_sym, lens);
  {
    uint32_t c = 0;
    int prev = 0;
    for (int i = 0; i < n_sym; ++i) {
      int s = corder[i];
      if (lens[s] > 8) return 0;
      c <<= (lens[s] - prev);
      prev = lens[s];
      code[s] = uint8_t(c++);
    }
  }

  int enc_bits = 0;
  for (int i = 0; i < n_sym; ++i) enc_bits += int(freq[i]) * lens[i];
  // tree section: runs of equal length in canonical order, <= 32 per group
  int tree_size = 0;
  for (int i = 0; i < n_sym;) {
    int run_end = i;
    while (run_end < n_sym && lens[corder[run_end]] == lens[corder[i]])
      ++run_end;
    for (int start = i; start < run_end; start += 32) {
      int cnt = run_end - start < 32 ? run_end - start : 32;
      tree_size += 1 + (cnt * 11 + 7) / 8;
    }
    i = run_end;
  }

  WordWriter<Sink> wr(sink);
  wr.put(bitrev(uint32_t(enc_bits) & 0xFF, 8), 8);
  wr.put(bitrev(uint32_t(enc_bits) >> 8, 8), 8);
  wr.put(bitrev(uint32_t(tree_size) & 0xFF, 8), 8);
  for (int i = 0; i < n_sym;) {
    int len = lens[corder[i]];
    int run_end = i;
    while (run_end < n_sym && lens[corder[run_end]] == len) ++run_end;
    for (int start = i; start < run_end; start += 32) {
      int cnt = run_end - start < 32 ? run_end - start : 32;
      wr.put(bitrev(uint32_t(((len - 1) << 5) | (cnt - 1)), 8), 8);
      for (int k = start; k < start + cnt; ++k) {
        int s = syms[corder[k]];
        wr.put(bitrev(uint32_t(s < 0 ? 2048 + s : s), 11), 11);
      }
      wr.align_byte();
    }
    i = run_end;
  }
  for (int i = 0; i < mlen; ++i) {
    // binary search of the symbol-ascending distinct table
    int lo = 0, hi = n_sym - 1;
    while (lo < hi) {
      int mid = (lo + hi) >> 1;
      if (syms[mid] < msg[i]) lo = mid + 1;
      else hi = mid;
    }
    wr.put(code[lo], lens[lo]);
  }
  wr.flush();
  return 3 + tree_size + (enc_bits + 7) / 8;
}

// ---------------------------------------------------------------------------
// Decoder
// ---------------------------------------------------------------------------

// Decode one stream-space chunk (src(w) returns word w, 0 past the chunk)
// into row-major coefficients. Returns 0 on success, else an error code:
// 3 more than 64 tree symbols, 4 tree section size mismatch, 5 code runs
// past enc_bits, 7 no code of length <= 8 matches, 8 payload length
// mismatch.
template <class Src>
MYYUV_HD int decode_block(Src& src, int16_t* coef) {
  WordReader<Src> rd(src);
  int enc_bits = int(bitrev(rd.get(8), 8));
  enc_bits |= int(bitrev(rd.get(8), 8)) << 8;
  int tree_size = int(bitrev(rd.get(8), 8));

  // pass 1: group headers -> per-length symbol counts
  int counts[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
  int total = 0;
  WordReader<Src> tree = rd;
  int pos = 0;
  while (pos < tree_size) {
    int info = int(bitrev(rd.get(8), 8));
    int cnt = (info & 31) + 1;
    int nbytes = (cnt * 11 + 7) / 8;
    counts[(info >> 5) + 1] += cnt;
    total += cnt;
    for (int k = 0; k < nbytes; ++k) rd.skip(8);
    pos += 1 + nbytes;
  }
  if (pos != tree_size) return 4;
  if (total > kMaxSyms) return 3;

  // pass 2: symbols into one table ordered by (length, stored order)
  int base[9], placed[9];
  base[0] = 0;
  placed[0] = 0;
  for (int l = 1; l < 9; ++l) {
    base[l] = base[l - 1] + counts[l - 1];
    placed[l] = 0;
  }
  int16_t table[kMaxSyms];
  pos = 0;
  while (pos < tree_size) {
    int info = int(bitrev(tree.get(8), 8));
    int len = (info >> 5) + 1;
    int cnt = (info & 31) + 1;
    for (int k = 0; k < cnt; ++k) {
      int v = int(bitrev(tree.get(11), 11));
      table[base[len] + placed[len]++] = int16_t(v >= 1024 ? v - 2048 : v);
    }
    tree.skip((8 - (cnt * 11) % 8) % 8);
    pos += 1 + (cnt * 11 + 7) / 8;
  }

  // payload: canonical decode from an 8-bit peek (puff.c first/count walk)
  for (int i = 0; i < 64; ++i) coef[i] = 0;
  int bit = 0, row = 0, col = 0;
  for (int out = 0; bit < enc_bits && out < 64; ++out) {
    uint32_t peek = rd.peek(8);
    int first = 0, len = 1, idx = -1;
    for (; len <= 8; ++len) {
      int c = int(peek >> (8 - len));
      if (c < first + counts[len]) {
        idx = base[len] + c - first;
        break;
      }
      first = (first + counts[len]) << 1;
    }
    if (idx < 0) return 7;
    if (bit + len > enc_bits) return 5;
    rd.skip(len);
    bit += len;
    coef[row * 8 + col] = table[idx];
    zigzag_next(row, col);
  }
  return bit == enc_bits ? 0 : 8;
}

// ---------------------------------------------------------------------------
// Word-frame layout (engine/word_frame): block b = 8c + r of a frame with
// `cols` lane columns lives in column c, sublane r. Word w of the block's
// 16 pixel words (4 row pixels each, little-endian) is element
// [8w + r, c] of the [128, cols] frame; word w of its chunk is element
// [8w + r, c] of region A [64, cols] for w < 8, else element
// [8(w - 8) + r, c] of region C [8 * cont, cols].
// ---------------------------------------------------------------------------

struct RegionSink {
  uint32_t* a;
  uint32_t* cr;
  int64_t cols, off;  // off = r * cols + c
  int cont;
  MYYUV_HD void operator()(int w, uint32_t word) const {
    if (w < 8) a[(8 * w) * cols + off] = word;
    else if (w - 8 < cont) cr[(8 * (w - 8)) * cols + off] = word;
  }
};

struct RegionSrc {
  const uint32_t* a;
  const uint32_t* cr;
  int64_t cols, off;
  int cont;
  MYYUV_HD uint32_t operator()(int w) const {
    if (w < 8) return a[(8 * w) * cols + off];
    if (w - 8 < cont) return cr[(8 * (w - 8)) * cols + off];
    return 0;
  }
};

// Compress block (r, c) of a word frame: transform with the plane's table
// (qts holds three row-major 8x8 tables, pids the plane of each column),
// entropy-code, write its words to A and C (words past the chunk are
// zero, words past the capacity 8 + cont are dropped). Returns the chunk
// size in bytes (0 on failure).
MYYUV_HD int encode_word_block(const uint32_t* xw, const float* qts,
                               const int32_t* pids, const float* dct,
                               int64_t cols, int r, int64_t c, int cont,
                               uint32_t* a, uint32_t* cr) {
  int64_t off = r * cols + c;
  float x[64];
  for (int k = 0; k < 16; ++k) {
    uint32_t w = xw[(8 * k) * cols + off];
    for (int j = 0; j < 4; ++j)
      x[4 * k + j] = float((w >> (8 * j)) & 0xFFu) - 128.0f;
  }
  int16_t coef[64];
  dct_quantize(x, qts + 64 * pids[c], dct, coef);
  RegionSink sink{a, cr, cols, off, cont};
  int size = encode_block(coef, sink);
  for (int w = (size + 3) / 4; w < 8 + cont; ++w) sink(w, 0u);
  return size;
}

// Decompress block (r, c) from regions A and C into the word frame xw.
// Returns 0 on success, else decode_block's error code.
MYYUV_HD int decode_word_block(const uint32_t* a, const uint32_t* cr,
                               const float* qts, const int32_t* pids,
                               const float* dct, int64_t cols, int r,
                               int64_t c, int cont, uint32_t* xw) {
  int64_t off = r * cols + c;
  RegionSrc src{a, cr, cols, off, cont};
  int16_t coef[64];
  int err = decode_block(src, coef);
  uint8_t px[64];
  dequantize_idct(coef, qts + 64 * pids[c], dct, px);
  for (int k = 0; k < 16; ++k)
    xw[(8 * k) * cols + off] =
        uint32_t(px[4 * k]) | (uint32_t(px[4 * k + 1]) << 8) |
        (uint32_t(px[4 * k + 2]) << 16) | (uint32_t(px[4 * k + 3]) << 24);
  return err;
}

}  // namespace myyuv
