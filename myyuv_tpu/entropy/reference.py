"""Scalar (NumPy/Python) model of the per-block canonical Huffman codec.

This is the *oracle* implementation: a direct, readable formulation of the
bitstream semantics in SURVEY.md §7 used to validate the vectorized device
kernels and for differential tests against the compiled reference CLI. It is
deliberately per-block and slow.

Chunk layout (reference: Huffman.cpp:243-247 comment, fromDump/dump):
  u16 encoded_data_bits (LE)
  u8  tree_data_size
  repeated groups:
      u8 ((code_len-1) << 5 | (count-1))   # count <= 32, longer runs split
      ceil(count*11/8) bytes: symbols packed 11 bits each, LSB-first,
                              negatives stored as 2048+v
  ceil(encoded_data_bits/8) bytes: code bits, LSB-first within each byte

Code construction (Huffman.cpp:172-241):
  * message = coefficients in zigzag order with trailing zeros trimmed
    (all-zero block -> the single symbol 0)
  * Huffman tree over per-block symbol frequencies; single-symbol message
    gets code length 1
  * canonical codes: lengths ascending, symbols ascending within a length
  * codes are emitted MSB-first into the bitstream

Because total message weight is <= 64 < Fibonacci(11) = 89, the optimal
Huffman depth never exceeds 8, so every block fits the 3-bit length field.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Tuple

import numpy as np

from ..runtime.errors import BitstreamError

# Zigzag scan order (Huffman.cpp:32-34): position i of the message reads
# coefficient zigzag_indexes[i] of the row-major 8x8 block.
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], np.int32)

# inverse permutation: coefficient j sits at message position INV_ZIGZAG[j]
INV_ZIGZAG = np.argsort(ZIGZAG)


def code_lengths_from_freqs(freqs: Dict[int, int]) -> Dict[int, int]:
    """Optimal Huffman code length per symbol (Huffman.cpp:204-225).

    Tie-breaking differs from the C++ priority queue (unspecified there);
    any optimal tree yields the same total encoded bits and decodes
    identically under the canonical reconstruction.
    """
    if not freqs:
        raise ValueError("empty frequency table")
    if len(freqs) == 1:
        # single-symbol message: code length 1 (Huffman.cpp:76 `+ (len==0)`)
        return {next(iter(freqs)): 1}
    heap: List[Tuple[int, int, object]] = []
    for tiebreak, (sym, f) in enumerate(sorted(freqs.items())):
        heap.append((f, tiebreak, sym))
    heapq.heapify(heap)
    counter = len(heap)
    while len(heap) > 1:
        f1, _, n1 = heapq.heappop(heap)
        f2, _, n2 = heapq.heappop(heap)
        heapq.heappush(heap, (f1 + f2, counter, (n1, n2)))
        counter += 1
    lengths: Dict[int, int] = {}

    def walk(node, depth):
        if isinstance(node, tuple):
            walk(node[0], depth + 1)
            walk(node[1], depth + 1)
        else:
            lengths[node] = depth

    walk(heap[0][2], 0)
    return lengths


def canonical_codes(tree_data: Dict[int, List[int]]) -> Dict[int, Tuple[int, int]]:
    """symbol -> (length, code); canonical assignment (Huffman.cpp:86-103)."""
    res: Dict[int, Tuple[int, int]] = {}
    prev_len = 0
    code = 0
    for length in sorted(tree_data):
        code <<= (length - prev_len)
        for sym in tree_data[length]:
            assert code < 256
            res[sym] = (length, code)
            code += 1
        prev_len = length
    return res


def _message(coeffs: np.ndarray) -> np.ndarray:
    """Zigzag scan + trailing-zero trim (Huffman.cpp:174-203)."""
    zz = np.asarray(coeffs, np.int64).reshape(64)[ZIGZAG]
    nz = np.nonzero(zz)[0]
    if nz.size == 0:
        return np.zeros(1, np.int64)  # all-zero block -> single 0 symbol
    return zz[: nz[-1] + 1]


def block_tree_data(coeffs: np.ndarray) -> Dict[int, List[int]]:
    """length -> sorted symbols for one block."""
    msg = _message(coeffs)
    syms, counts = np.unique(msg, return_counts=True)
    lengths = code_lengths_from_freqs(
        {int(s): int(c) for s, c in zip(syms, counts)})
    tree_data: Dict[int, List[int]] = {}
    for sym, length in lengths.items():
        tree_data.setdefault(length, []).append(sym)
    for v in tree_data.values():
        v.sort()
    return tree_data


def encode_block(coeffs: np.ndarray) -> bytes:
    """int16[64] (row-major block) -> serialized Huffman chunk bytes."""
    msg = _message(coeffs)
    tree_data = block_tree_data(coeffs)
    codes = canonical_codes(tree_data)

    # encoded data bits, MSB-first per code, stream position ascending
    bits: List[int] = []
    for sym in msg:
        length, code = codes[int(sym)]
        bits.extend((code >> (length - 1 - j)) & 1 for j in range(length))
    enc_bits = len(bits)
    assert enc_bits <= 512

    out = bytearray()
    out += int(enc_bits).to_bytes(2, "little")
    out.append(0)  # tree_data_size placeholder

    # tree groups (Huffman::dump, Huffman.cpp:300-316)
    for length in sorted(tree_data):
        syms = tree_data[length]
        assert 1 <= length <= 8, "code length exceeds format limit"
        start = 0
        while start < len(syms):
            part = syms[start: start + 32]
            start += 32
            out.append(((length - 1) << 5) | (len(part) - 1))
            packed = bytearray((len(part) * 11 + 7) // 8)
            bit_off = 0
            for s in part:
                v = s + 2048 if s < 0 else s
                byte_ind, bit_ind = bit_off // 8, bit_off % 8
                packed[byte_ind] |= (v << bit_ind) & 0xFF
                packed[byte_ind + 1] |= (v >> (8 - bit_ind)) & 0xFF
                if bit_ind > 5:
                    packed[byte_ind + 2] |= (v >> (16 - bit_ind)) & 0xFF
                bit_off += 11
            out += packed
    out[2] = len(out) - 3  # tree_data_size

    # encoded data bytes, LSB-first within each byte (Huffman.cpp:319-325)
    enc = bytearray((enc_bits + 7) // 8)
    for i, b in enumerate(bits):
        enc[i // 8] |= b << (i % 8)
    out += enc
    if len(out) > 255:
        raise BitstreamError("Huffman chunk exceeds 255 bytes")
    return bytes(out)


def parse_chunk(chunk: bytes):
    """chunk -> (enc_bits, tree_data, payload_bits array)."""
    if len(chunk) < 3:
        raise BitstreamError("Huffman chunk too small")
    enc_bits = int.from_bytes(chunk[0:2], "little")
    tree_size = chunk[2]
    if 3 + tree_size + (enc_bits + 7) // 8 > len(chunk):
        raise BitstreamError("Huffman chunk truncated")
    tree_data: Dict[int, List[int]] = {}
    i = 3
    while i - 3 < tree_size:
        ch_info = chunk[i]
        i += 1
        length = (ch_info >> 5) + 1
        count = (ch_info & 31) + 1
        syms = tree_data.setdefault(length, [])
        bit_off = 0
        for _ in range(count):
            byte_ind, bit_ind = bit_off // 8, bit_off % 8
            v = (chunk[i + byte_ind] >> bit_ind) & 0xFF
            v |= (chunk[i + byte_ind + 1] << (8 - bit_ind)) & 0x7FF
            if bit_ind > 5:
                v |= (chunk[i + byte_ind + 2] << (16 - bit_ind)) & 0x7FF
            v &= 0x7FF
            syms.append(v - 2048 if v >= 1024 else v)
            bit_off += 11
        i += (count * 11 + 7) // 8
    if i - 3 != tree_size:
        raise BitstreamError("Huffman tree section size mismatch")
    payload = chunk[i: i + (enc_bits + 7) // 8]
    bits = np.unpackbits(
        np.frombuffer(payload, np.uint8), bitorder="little")[:enc_bits]
    return enc_bits, tree_data, bits


def decode_block(chunk: bytes) -> np.ndarray:
    """Serialized chunk -> int16[64] row-major coefficients.

    Canonical decode after zlib puff.c (Huffman.cpp:105-154).
    """
    enc_bits, tree_data, bits = parse_chunk(chunk)
    counts = [len(tree_data.get(l, [])) for l in range(1, 9)]
    data = np.zeros(64, np.int16)
    i = 0
    j = 0
    while i < enc_bits and j < 64:
        code = 0
        first = 0
        sym = None
        for length in range(1, 9):
            if i >= enc_bits:
                raise BitstreamError("Huffman bad code")
            code |= int(bits[i])
            i += 1
            c = counts[length - 1]
            if code < c + first:
                if c == 0:
                    raise BitstreamError("Huffman bad code")
                sym = tree_data[length][code - first]
                break
            first = (first + c) << 1
            code <<= 1
        if sym is None:
            raise BitstreamError("Huffman unknown symbol")
        data[ZIGZAG[j]] = sym
        j += 1
    if i != enc_bits:
        raise BitstreamError("Huffman trailing bits")
    return data
