"""Plain-JAX vectorized canonical Huffman codec (lockstep over blocks).

Decodes (and later encodes) *all blocks of a plane simultaneously* as dense
[N, 256]-byte lanes on the device, eliminating the host entropy bottleneck
and the coefficient-tensor transfers through the host<->device link — only
compressed bytes cross the boundary.

Bitstream semantics are the reference's per-block chunks (SURVEY.md §7;
Huffman.cpp): u16 encoded_bits, u8 tree_size, canonical-code groups of
11-bit symbols, payload bits MSB-first-per-code packed LSB-first in bytes.

Decoder design notes (every block in lockstep):
* the per-bit canonical walk (Huffman.cpp:105-141) is reformulated as an
  8-bit peek + closed-form length resolution: with canonical codes,
  symbol length = min L such that (peek >> (8-L)) < first_code[L] +
  count[L]; index = base[L] + peek8>>(8-L) - first_code[L]. One gather and
  ~30 VPU ops per symbol step instead of up to 8 dependent bit steps.
* tree parsing is a two-pass group scan (<= 64 groups) with per-row
  cursors; all rows advance in lockstep with masking (no data-dependent
  control flow under jit).
* every value is [N]-wide; gathers are per-row take_along_axis on the lane
  axis. The 64 symbol steps run under lax.fori_loop.

Each jitted call handles a fixed [N, 256] shape; callers pad N to a slab
size to bound the number of compiled variants.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .reference import ZIGZAG

I32 = jnp.int32
LANE = 256
MAX_GROUPS = 64          # <= 64 symbols per block, >= 1 symbol per group


def _take_byte(lanes: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """lanes [N, LANE] u8, idx [N] -> lanes[row, idx[row]] as int32."""
    idx = jnp.clip(idx, 0, LANE - 1)
    return jnp.take_along_axis(
        lanes, idx[:, None].astype(I32), axis=1)[:, 0].astype(I32)


def _bitrev8(v: jnp.ndarray) -> jnp.ndarray:
    """Reverse the low 8 bits (stream bits are LSB-first in bytes, codes
    MSB-first in stream order)."""
    v = ((v & 0xF0) >> 4) | ((v & 0x0F) << 4)
    v = ((v & 0xCC) >> 2) | ((v & 0x33) << 2)
    v = ((v & 0xAA) >> 1) | ((v & 0x55) << 1)
    return v


def _parse_trees(lanes: jnp.ndarray, tree_size: jnp.ndarray
                 ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Parse all chunks' tree sections.

    Returns (counts [N, 9], base [N, 9], symflat [N, 64]): per-length
    symbol counts, exclusive prefix (flat index of each length's first
    symbol), and the flat symbol table ordered by (length, storage order).
    """
    n = lanes.shape[0]
    rows = jnp.arange(n)

    # ---- pass 1: group headers -> per-length counts --------------------
    def scan_headers(g, state):
        cursor, counts = state
        active = cursor - 3 < tree_size
        hdr = _take_byte(lanes, cursor)
        length = (hdr >> 5) + 1
        cnt = jnp.where(active, (hdr & 31) + 1, 0)
        counts = counts.at[rows, jnp.where(active, length, 0)].add(
            cnt, unique_indices=True, indices_are_sorted=True)
        cursor = cursor + jnp.where(active, 1 + (cnt * 11 + 7) // 8, 0)
        return cursor, counts

    cursor0 = jnp.full((n,), 3, I32)
    counts0 = jnp.zeros((n, 10), I32)  # index 0 = inactive sink, 1..8 used
    _, counts = jax.lax.fori_loop(0, MAX_GROUPS, scan_headers,
                                  (cursor0, counts0))
    counts = counts.at[:, 0].set(0)
    base = jnp.cumsum(counts, axis=1) - counts  # exclusive prefix over len

    # ---- pass 2: place symbols into the flat canonical table ------------
    toff = jnp.arange(32, dtype=I32)  # symbol slot within a group

    def scan_symbols(g, state):
        cursor, placed, symflat = state
        active = cursor - 3 < tree_size
        hdr = _take_byte(lanes, cursor)
        length = (hdr >> 5) + 1
        cnt = jnp.where(active, (hdr & 31) + 1, 0)
        # 11-bit fields at bit offsets t*11 from (cursor+1)
        boff = toff[None, :] * 11                     # [1, 32]
        byte0 = cursor[:, None] + 1 + (boff >> 3)     # [N, 32]
        sh = boff & 7
        idx = jnp.clip(byte0, 0, LANE - 3)
        b0 = jnp.take_along_axis(lanes, idx, axis=1).astype(I32)
        b1 = jnp.take_along_axis(lanes, idx + 1, axis=1).astype(I32)
        b2 = jnp.take_along_axis(lanes, idx + 2, axis=1).astype(I32)
        v = ((b0 >> sh) | (b1 << (8 - sh)) | (b2 << (16 - sh))) & 0x7FF
        sym = jnp.where(v >= 1024, v - 2048, v).astype(jnp.int16)
        valid = (toff[None, :] < cnt[:, None]) & active[:, None]
        pos = (jnp.take_along_axis(base, length[:, None], axis=1)
               + jnp.take_along_axis(placed, length[:, None], axis=1)
               + toff[None, :])                       # [N, 32]
        pos = jnp.where(valid, pos, 64)               # 64 = dropped
        symflat = symflat.at[rows[:, None], pos].set(
            sym, mode="drop", unique_indices=True)
        placed = placed.at[rows, jnp.where(active, length, 0)].add(
            cnt, unique_indices=True, indices_are_sorted=True)
        cursor = cursor + jnp.where(active, 1 + (cnt * 11 + 7) // 8, 0)
        return cursor, placed, symflat

    placed0 = jnp.zeros((n, 10), I32)
    symflat0 = jnp.zeros((n, 64), jnp.int16)
    _, _, symflat = jax.lax.fori_loop(0, MAX_GROUPS, scan_symbols,
                                      (cursor0, placed0, symflat0))
    return counts[:, :9], base[:, :9], symflat


@functools.partial(jax.jit, donate_argnums=())
def decode_lanes(lanes: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """[N, 256] uint8 chunk lanes -> ([N, 64] int16 coefficients, [N] ok).

    ``ok`` is False for malformed chunks (bad code / trailing bits); the
    caller raises BitstreamError when any row fails (the device analog of
    the reference decoder's exceptions, Huffman.cpp:121-139).
    """
    n = lanes.shape[0]
    enc_bits = (_take_byte(lanes, jnp.zeros((n,), I32))
                | (_take_byte(lanes, jnp.ones((n,), I32)) << 8))
    tree_size = _take_byte(lanes, jnp.full((n,), 2, I32))
    counts, base, symflat = _parse_trees(lanes, tree_size)
    # a valid tree has <= 64 symbols (one per coefficient); larger totals
    # mean _parse_trees silently dropped entries -> flag the row bad (the
    # reference decoder throws on such streams, Huffman.cpp:121-139)
    total_syms = jnp.sum(counts, axis=1)
    tree_bad = total_syms > 64

    # canonical first_code per length: first[l+1] = (first[l]+count[l])<<1
    def fc_step(l, fc):
        nxt = (jnp.take_along_axis(fc, jnp.full((n, 1), l, I32), axis=1)[:, 0]
               + counts[:, l]) << 1
        return fc.at[:, l + 1].set(nxt)

    first_code = jax.lax.fori_loop(
        1, 8, fc_step, jnp.zeros((n, 9), I32).at[:, 1].set(0))

    payload_bit0 = (3 + tree_size) * 8
    rows = jnp.arange(n)
    zz = jnp.asarray(np.asarray(ZIGZAG, np.int32))

    def sym_step(p, state):
        bitpos, coeffs, bad = state
        active = bitpos < enc_bits
        ab = payload_bit0 + bitpos
        b0 = _take_byte(lanes, ab >> 3)
        b1 = _take_byte(lanes, (ab >> 3) + 1)
        sh = ab & 7
        peek = _bitrev8(((b0 >> sh) | (b1 << (8 - sh))) & 0xFF)
        # smallest L in 1..8 with peek>>(8-L) < first_code[L] + counts[L]
        length = jnp.full((n,), 9, I32)
        code = jnp.zeros((n,), I32)
        for L in range(8, 0, -1):
            cL = peek >> (8 - L)
            hit = cL < first_code[:, L] + counts[:, L]
            # also require enough bits left for an honest L-bit code
            length = jnp.where(hit, L, length)
            code = jnp.where(hit, cL, code)
        pos = jnp.take_along_axis(
            base, jnp.clip(length, 0, 8)[:, None], axis=1)[:, 0] \
            + code - jnp.take_along_axis(
                first_code, jnp.clip(length, 0, 8)[:, None], axis=1)[:, 0]
        cnt_hit = jnp.take_along_axis(
            counts, jnp.clip(length, 0, 8)[:, None], axis=1)[:, 0]
        # out-of-table = bad code (reference: 'Huffman bad code'), not a
        # silently clipped index
        ok_sym = (length <= 8) & (bitpos + length <= enc_bits) \
            & (cnt_hit > 0) & (pos >= 0) & (pos < total_syms)
        sym = jnp.take_along_axis(
            symflat, jnp.clip(pos, 0, 63)[:, None], axis=1)[:, 0]
        write = active & ok_sym
        coeffs = coeffs.at[rows, zz[p]].set(
            jnp.where(write, sym, coeffs[rows, zz[p]]),
            unique_indices=True, indices_are_sorted=True)
        bad = bad | (active & ~ok_sym)
        bitpos = jnp.where(write, bitpos + length, bitpos)
        return bitpos, coeffs, bad

    bitpos0 = jnp.zeros((n,), I32)
    coeffs0 = jnp.zeros((n, 64), jnp.int16)
    bad0 = tree_bad
    bitpos, coeffs, bad = jax.lax.fori_loop(
        0, 64, sym_step, (bitpos0, coeffs0, bad0))
    ok = ~bad & (bitpos == enc_bits)
    return coeffs, ok


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def _cummax(x: jnp.ndarray) -> jnp.ndarray:
    """Inclusive running maximum along axis 1."""
    return jax.lax.associative_scan(jnp.maximum, x, axis=1)


@jax.jit
def encode_lanes(coeffs: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray,
                                               jnp.ndarray]:
    """[N, 64] int16 coefficients -> ([N, 256] u8 lanes, [N] sizes, [N] ok).

    The on-device analog of Huffman::fromData + dump (Huffman.cpp:172-241,
    279-326), fully vectorized over blocks:

    1. zigzag scan + trailing-zero trim (all-zero -> single 0 symbol);
    2. per-block distinct symbols + frequencies via one sort + run-length
       boundaries (replacing the reference's std::map);
    3. optimal code lengths via the two-queue Huffman merge (63 masked
       lockstep steps; sorted leaves + FIFO of internal nodes), then depth
       recovery by a descending parent sweep — a priority-queue-free
       formulation that vectorizes; total weight <= 64 < Fib(11) bounds
       depth <= 8 for any optimal code, satisfying the format's 3-bit
       length field;
    4. canonical code assignment in (length, symbol) order via the Kraft
       prefix sum: code_i = (sum_{j<i} 2^(8-len_j)) >> (8-len_i);
    5. serialization by scatter-add of disjoint bit contributions into the
       byte canvas (group headers, 11-bit symbols LSB-first, payload codes
       MSB-first packed LSB-first in bytes).
    """
    n = coeffs.shape[0]
    rows = jnp.arange(n)
    rows2 = rows[:, None]
    pos64 = jnp.arange(64, dtype=I32)[None, :]
    zz = jnp.asarray(np.asarray(ZIGZAG, np.int32))

    m = coeffs.astype(I32)[:, zz]                        # message [N, 64]
    nz_last = jnp.max(jnp.where(m != 0, pos64 + 1, 0), axis=1)
    mlen = jnp.maximum(nz_last, 1)                       # [N]
    valid = pos64 < mlen[:, None]                        # [N, 64]

    # ---- distinct symbols + counts (sorted by symbol value) ------------
    svals = jnp.where(valid, m, 2048)
    sort_idx = jnp.argsort(svals, axis=1, stable=True)
    sv = jnp.take_along_axis(svals, sort_idx, axis=1)
    prev = jnp.concatenate([jnp.full((n, 1), -4096, I32), sv[:, :-1]], axis=1)
    is_new = (sv != prev) & valid                        # valid: sorted keeps
    gid = jnp.cumsum(is_new.astype(I32), axis=1) - 1     # [N, 64]
    n_sym = jnp.sum(is_new.astype(I32), axis=1)          # [N]
    gid_safe = jnp.where(valid, gid, 64)
    counts = jnp.zeros((n, 64), I32).at[rows2, gid_safe].add(
        valid.astype(I32), mode="drop", indices_are_sorted=True)
    symval = jnp.full((n, 64), 2048, I32).at[rows2, gid_safe].min(
        sv, mode="drop", indices_are_sorted=True)
    # group id of each original message position
    gorig = jnp.zeros((n, 64), I32).at[rows2, sort_idx].set(
        gid_safe, unique_indices=True)

    # ---- two-queue Huffman merge over count-sorted leaves --------------
    BIG = jnp.int32(1 << 29)
    leaf_sort = jnp.argsort(jnp.where(pos64 < n_sym[:, None], counts, BIG),
                            axis=1, stable=True)         # [N, 64]
    leafw = jnp.take_along_axis(
        jnp.where(pos64 < n_sym[:, None], counts, BIG), leaf_sort, axis=1)

    def pick(state):
        lh, ih, it, intw, active = state
        lw = jnp.take_along_axis(leafw, jnp.clip(lh, 0, 63)[:, None],
                                 axis=1)[:, 0]
        iw = jnp.take_along_axis(intw, jnp.clip(ih, 0, 62)[:, None],
                                 axis=1)[:, 0]
        leaf_has = lh < n_sym
        int_has = ih < it
        take_leaf = leaf_has & (~int_has | (lw <= iw))
        w = jnp.where(take_leaf, lw, iw)
        node = jnp.where(take_leaf, lh, 64 + ih)
        lh = lh + (take_leaf & active)
        ih = ih + (~take_leaf & active)
        return (lh, ih, it, intw, active), w, node

    def merge_step(s, _):
        lh, ih, it, intw, parent = s
        active = it < n_sym - 1
        st = (lh, ih, it, intw, active)
        st, w1, node1 = pick(st)
        st, w2, node2 = pick(st)
        lh, ih, it, intw, _ = st
        new_id = 64 + it
        parent = parent.at[rows, jnp.where(active, node1, 127)].set(
            new_id, mode="drop", unique_indices=True)
        parent = parent.at[rows, jnp.where(active, node2, 127)].set(
            new_id, mode="drop", unique_indices=True)
        intw = intw.at[rows, jnp.where(active, it, 63)].set(
            jnp.where(active, w1 + w2, 0), mode="drop", unique_indices=True)
        it = it + active
        return (lh, ih, it, intw, parent), None

    zero = jnp.zeros((n,), I32)
    parent0 = jnp.zeros((n, 127), I32)
    intw0 = jnp.full((n, 64), BIG, I32)
    (_, _, _, _, parent), _ = jax.lax.scan(
        merge_step, (zero, zero, zero, intw0, parent0), None, length=63)

    # depth recovery: ids descending; parents always have larger ids
    root = 64 + n_sym - 2                                # [N] (n_sym >= 2)

    def depth_step(i, depth):
        nid = 126 - i
        pd = jnp.take_along_axis(
            depth, jnp.clip(parent[:, nid], 0, 126)[:, None], axis=1)[:, 0]
        d = jnp.where(nid == root, 0, pd + 1)
        return depth.at[:, nid].set(d)

    depth = jax.lax.fori_loop(0, 127, depth_step, jnp.zeros((n, 127), I32))
    leaf_len = depth[:, :64]                             # per sorted leaf
    leaf_len = jnp.where(n_sym[:, None] == 1, 1, leaf_len)
    # scatter back: length per group id
    glen = jnp.zeros((n, 64), I32).at[
        rows2, jnp.where(pos64 < n_sym[:, None], leaf_sort, 64)].set(
        leaf_len, mode="drop", unique_indices=True)

    # ---- canonical order + codes ---------------------------------------
    in_range = pos64 < n_sym[:, None]
    ckey = jnp.where(in_range, glen * 64 + pos64, BIG)
    corder = jnp.argsort(ckey, axis=1, stable=True)      # canonical order
    len_c = jnp.take_along_axis(glen, corder, axis=1)    # [N, 64]
    sym_c = jnp.take_along_axis(symval, corder, axis=1)
    kraft = jnp.where(in_range, 1 << (8 - jnp.clip(len_c, 1, 8)), 0)
    S = jnp.cumsum(kraft, axis=1) - kraft                # exclusive
    code_c = S >> (8 - jnp.clip(len_c, 1, 8))
    # per-group code/len for payload emission
    gcode = jnp.zeros((n, 64), I32).at[
        rows2, jnp.where(in_range, corder, 64)].set(
        code_c, mode="drop", unique_indices=True)

    # ---- tree section layout (canonical-entry arithmetic) --------------
    prev_len = jnp.concatenate([jnp.full((n, 1), -1, I32), len_c[:, :-1]],
                               axis=1)
    run_start = in_range & (len_c != prev_len)
    last_run_start = _cummax(jnp.where(run_start, pos64, -1))
    idx_in_run = pos64 - last_run_start
    grp_start = in_range & (run_start | (idx_in_run % 32 == 0))
    last_grp_start = _cummax(jnp.where(grp_start, pos64, -1))
    idx_in_grp = pos64 - last_grp_start                  # [N, 64]
    tgid = jnp.cumsum(grp_start.astype(I32), axis=1) - 1
    tgid_safe = jnp.where(in_range, tgid, 64)
    gcnt = jnp.zeros((n, 64), I32).at[rows2, tgid_safe].add(
        in_range.astype(I32), mode="drop", indices_are_sorted=True)
    n_grp = jnp.sum(grp_start.astype(I32), axis=1)
    grp_bytes = jnp.where(pos64 < n_grp[:, None],
                          1 + (gcnt * 11 + 7) // 8, 0)
    goff = jnp.cumsum(grp_bytes, axis=1) - grp_bytes     # exclusive, [N,64]
    tree_size = jnp.sum(grp_bytes, axis=1)               # [N]

    total_bits_msg = jnp.sum(
        jnp.where(valid, jnp.take_along_axis(
            glen, jnp.where(valid, gorig, 0), axis=1), 0), axis=1)
    payload_bytes = (total_bits_msg + 7) // 8
    sizes = 3 + tree_size + payload_bytes                # [N]
    ok = sizes <= 255

    # ---- serialize into the lane canvas via disjoint-bit scatter-adds --
    canvas = jnp.zeros((n, LANE), jnp.uint8)
    canvas = canvas.at[:, 0].set((total_bits_msg & 0xFF).astype(jnp.uint8))
    canvas = canvas.at[:, 1].set((total_bits_msg >> 8).astype(jnp.uint8))
    canvas = canvas.at[:, 2].set(tree_size.astype(jnp.uint8))

    # group headers: at canonical entries where grp_start. Value-masked
    # (zero adds at a shared sink index) so indices stay sorted — sorted
    # scatters lower without the expensive expander (compile time scales
    # with N otherwise).
    # non-start entries re-target their group's header byte with a zero
    # add (keeps the index sequence monotone; a mid-sequence sink index
    # would falsify indices_are_sorted); the invalid tail goes to LANE-1.
    hdr_pos = jnp.where(in_range,
                        3 + jnp.take_along_axis(goff, tgid_safe % 64, axis=1),
                        LANE - 1)
    hdr_val = ((jnp.clip(len_c, 1, 8) - 1) << 5) | \
        (jnp.take_along_axis(gcnt, tgid_safe % 64, axis=1) - 1)
    canvas = canvas.at[rows2, hdr_pos].add(
        jnp.where(grp_start, hdr_val, 0).astype(jnp.uint8),
        mode="drop", indices_are_sorted=True)

    # 11-bit symbols: 3 byte contributions each (disjoint bits per k)
    v11 = jnp.where(sym_c < 0, sym_c + 2048, sym_c) & 0x7FF
    grp_byte0 = 3 + jnp.take_along_axis(goff, tgid_safe % 64, axis=1) + 1
    sym_bit = idx_in_grp * 11                            # within group
    sbyte = grp_byte0 + (sym_bit >> 3)
    ssh = sym_bit & 7
    for k in range(3):
        contrib = (v11 << ssh >> (8 * k)) & 0xFF
        p = jnp.where(in_range, sbyte + k, LANE - 1)
        canvas = canvas.at[rows2, p].add(
            jnp.where(in_range, contrib, 0).astype(jnp.uint8),
            mode="drop", indices_are_sorted=True)

    # payload: emit each code's bits (MSB-first) into a per-chunk bit
    # canvas at unique, sorted positions; pack to bytes densely; then
    # shift into place behind the variable-size tree section with one
    # per-row gather (scatters with duplicate byte targets would need the
    # slow general expander — bit positions are collision-free).
    plen = jnp.take_along_axis(glen, jnp.where(valid, gorig, 0), axis=1)
    pcode = jnp.take_along_axis(gcode, jnp.where(valid, gorig, 0), axis=1)
    bit_start = jnp.cumsum(jnp.where(valid, plen, 0), axis=1) - \
        jnp.where(valid, plen, 0)
    bits = jnp.zeros((n, 512), jnp.uint8)
    for t in range(8):
        has_bit = valid & (t < plen)
        bit = ((pcode >> jnp.clip(plen - 1 - t, 0, 31)) & 1).astype(
            jnp.uint8)
        # monotone even when masked: entries shorter than t re-add zero at
        # their last bit position; the invalid tail lands past the canvas
        # (bit_start there == total_bits) and is dropped.
        bpos = bit_start + jnp.minimum(t, jnp.maximum(plen - 1, 0))
        bits = bits.at[rows2, bpos].add(
            jnp.where(has_bit, bit, 0), mode="drop",
            indices_are_sorted=True)
    weights = (1 << jnp.arange(8, dtype=I32))
    pay_bytes = jnp.sum(bits.reshape(n, 64, 8).astype(I32)
                        * weights[None, None, :], axis=2)   # [N, 64] LSB-1st
    # gather-shift: canvas byte b (b >= 3+tree_size) = pay_bytes[b - off]
    bcol = jnp.arange(LANE, dtype=I32)[None, :]
    off = (3 + tree_size)[:, None]
    src = jnp.clip(bcol - off, 0, 63)
    in_pay = (bcol >= off) & (bcol - off < 64)
    shifted = jnp.take_along_axis(pay_bytes, src, axis=1)
    canvas = canvas | jnp.where(in_pay, shifted, 0).astype(jnp.uint8)

    return canvas, sizes, ok
