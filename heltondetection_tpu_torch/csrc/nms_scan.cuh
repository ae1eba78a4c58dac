// What both greedy-NMS kernels share (csrc/nms_fixpoint.cu and
// csrc/nms_mask.cu): the suppression predicate, and the greedy scan over a
// packed suppression bitmask with the `removed` words held in registers.
//
// The bitmask. Row i is N/32 words of 32 bits; bit k of word w is set iff
// box i suppresses box 32w + k, and only for 32w + k > i. The scan reads
// only the words at or right of a row's own word (w >= i / 32), so a
// builder may leave the words left of the diagonal unwritten.
//
// The scan, one warp per image. Lane l holds `removed` words l, l + 32, ...
// in registers (slot s holds word 32s + l). Rows go 32 at a time, the rows
// of word r (block r):
//   1. the lane that holds word r resolves the block's 32x32 diagonal
//      serially in registers: row 32r + k is kept iff bit k is still clear,
//      and a kept row ORs its diagonal word in (its bits are all > k);
//   2. one shuffle broadcasts the resolved word; its clear bits are the
//      block's kept rows;
//   3. every lane ORs the kept rows' words into its own removed words:
//      32 independent register ORs per word, no shuffle and no sync per row.
// A unit of work is one block and one slot: 32 row words per lane, loaded
// into registers one or two units ahead so their latency hides behind the
// units before. The chain of dependent steps per row is a bit test, a
// select and an OR in one register (three instructions); the
// shared-memory walk it replaces took two shared-memory round trips and
// two __syncwarp per row.
//
// Past the lanes' registers (nms_mask.cu keeps at most 16 words a lane,
// N <= 16384), greedy_scan_shared runs the same units in the same order with
// the `removed` words in shared memory instead: word w at removed[w], so
// lane l's slot s is removed[32s + l] and every lane touches only its own
// words. The diagonal lane reads its word back from shared memory (its own
// write, so no sync is needed) and ORs the resolved word in as before.
//
// Word width: 32 bits. A word is one lane's share of a 32-row block, one
// __ballot_sync packs it and one __shfl_sync moves it. 64-bit words would
// halve the blocks but keep the serial chain at N steps, double each
// shuffle and OR, and leave half the lanes without a word at N = 1024.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace nms {

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float area_of(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.0f),
                   fmaxf(__fsub_rn(b.w, b.y), 0.0f));
}

// inter > thr * (area_a + area_b - inter + 1e-7), every operation rounded on
// its own (_rn intrinsics; the build passes --fmad=false), as the plain
// PyTorch version rounds it.
__device__ __forceinline__ bool suppresses(float4 a, float area_a, float4 b,
                                           float area_b, float thr) {
  const float iw =
      fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.0f);
  const float ih =
      fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.0f);
  const float inter = __fmul_rn(iw, ih);
  const float uni =
      __fadd_rn(__fsub_rn(__fadd_rn(area_a, area_b), inter), 1e-7f);
  return inter > __fmul_rn(thr, uni);
}

// buf[k] = word (32 * slot + lane) of row 32 * blk + k, for the lanes whose
// word lies at or right of the block's diagonal word and inside the row;
// zero for the others, whose words are never read. Rows::load fills the 32
// words of one lane.
template <class Rows>
__device__ __forceinline__ void load_unit(const Rows& rows, int blk, int slot,
                                          int words, uint32_t (&buf)[32]) {
  const int w = (slot << 5) + static_cast<int>(threadIdx.x & 31);
  if (w >= blk && w < words) {
    rows.load(blk, w, buf);
  } else {
#pragma unroll
    for (int k = 0; k < 32; ++k) buf[k] = 0u;
  }
}

// The unit after (blk, slot), with `slots` slots per lane: block blk's next
// slot, or block blk + 1 from the slot of its diagonal word. Past the last
// block the cursor moves on, and load_unit gives zeros there.
__device__ __forceinline__ void advance(int& blk, int& slot, int words,
                                        int slots) {
  if (++slot == slots || (slot << 5) >= words) {
    ++blk;
    slot = blk >> 5;
  }
}

template <int WPL>
__device__ __forceinline__ void advance(int& blk, int& slot, int words) {
  advance(blk, slot, words, WPL);
}

// The diagonal of block blk, resolved serially by the lane that holds its
// word d (the block's removed word so far): row 32 blk + k is kept iff bit
// k is still clear, and a kept row ORs its word in. Returns the block's
// kept rows as a mask, broadcast to every lane.
__device__ __forceinline__ uint32_t resolve_diagonal(const uint32_t (&buf)[32],
                                                    int blk, uint32_t d) {
  if (static_cast<int>(threadIdx.x & 31) == (blk & 31)) {
#pragma unroll
    for (int k = 0; k < 32; ++k)
      if (!(d & (1u << k))) d |= buf[k];
  }
  return ~__shfl_sync(kFullMask, d, blk & 31);
}

// The OR of the words in buf of the rows set in `kept`: 32 independent
// register ORs in four chains.
__device__ __forceinline__ uint32_t or_kept_rows(const uint32_t (&buf)[32],
                                                 uint32_t kept) {
  uint32_t a0 = 0u, a1 = 0u, a2 = 0u, a3 = 0u;
#pragma unroll
  for (int k = 0; k < 32; k += 4) {
    a0 |= buf[k] & (0u - ((kept >> k) & 1u));
    a1 |= buf[k + 1] & (0u - ((kept >> (k + 1)) & 1u));
    a2 |= buf[k + 2] & (0u - ((kept >> (k + 2)) & 1u));
    a3 |= buf[k + 3] & (0u - ((kept >> (k + 3)) & 1u));
  }
  return (a0 | a1) | (a2 | a3);
}

// Scans one unit held in buf: on block blk's diagonal unit, the lane that
// holds word blk resolves the diagonal and a shuffle sets `kept` for the
// block; then every lane ORs the kept rows' words into its removed word
// (lanes left of the diagonal hold zeros, and the diagonal lane's OR gives
// the word it just resolved).
template <int WPL>
__device__ __forceinline__ void scan_unit(const uint32_t (&buf)[32], int blk,
                                          int slot, uint32_t& kept,
                                          uint32_t (&removed)[WPL]) {
  if (slot == (blk >> 5)) {
    uint32_t d = 0u;
#pragma unroll
    for (int t = 0; t < WPL; ++t)
      if (t == slot) d = removed[t];
    kept = resolve_diagonal(buf, blk, d);
  }
  const uint32_t acc = or_kept_rows(buf, kept);
#pragma unroll
  for (int t = 0; t < WPL; ++t)
    if (t == slot) removed[t] |= acc;
}

// scan_unit with the removed words in shared memory (word w at removed[w],
// slots * 32 of them).
__device__ __forceinline__ void scan_unit_shared(const uint32_t (&buf)[32],
                                                 int blk, int slot,
                                                 uint32_t& kept,
                                                 uint32_t* removed) {
  const int own = (slot << 5) + static_cast<int>(threadIdx.x & 31);
  if (slot == (blk >> 5)) kept = resolve_diagonal(buf, blk, removed[own]);
  removed[own] |= or_kept_rows(buf, kept);
}

// One step of the scan: start loading the unit at the load cursor into
// `into`, scan the unit at the scan cursor held in `from`, move both
// cursors on. Returns whether a unit is left to scan.
template <int WPL, class Rows>
__device__ __forceinline__ bool scan_step(const Rows& rows, int words,
                                          const uint32_t (&from)[32],
                                          uint32_t (&into)[32], int& blk,
                                          int& slot, int& load_blk,
                                          int& load_slot, uint32_t& kept,
                                          uint32_t (&removed)[WPL]) {
  load_unit(rows, load_blk, load_slot, words, into);
  advance<WPL>(load_blk, load_slot, words);
  scan_unit<WPL>(from, blk, slot, kept, removed);
  advance<WPL>(blk, slot, words);
  return blk < words;
}

// Greedy keep scan over `words` * 32 rows, run by one whole warp. On return
// removed[s] of lane l is word 32s + l of the removed mask (bit set: box
// suppressed). WPL is the number of slots per lane, at least words / 32.
// kAhead (1 or 2) is how many units' loads are in flight while one unit is
// scanned; the buffers rotate by name, so no register is copied.
template <int WPL, int kAhead, class Rows>
__device__ __forceinline__ void greedy_scan(const Rows& rows, int words,
                                            uint32_t (&removed)[WPL]) {
  static_assert(kAhead == 1 || kAhead == 2, "one or two units ahead");
#pragma unroll
  for (int t = 0; t < WPL; ++t) removed[t] = 0u;
  uint32_t kept = 0u;
  int blk = 0, slot = 0, load_blk = 0, load_slot = 0;
  uint32_t b0[32], b1[32], b2[32];
  load_unit(rows, load_blk, load_slot, words, b0);
  advance<WPL>(load_blk, load_slot, words);
  if constexpr (kAhead == 1) {
    while (scan_step(rows, words, b0, b1, blk, slot, load_blk, load_slot,
                     kept, removed) &&
           scan_step(rows, words, b1, b0, blk, slot, load_blk, load_slot,
                     kept, removed)) {
    }
  } else {
    load_unit(rows, load_blk, load_slot, words, b1);
    advance<WPL>(load_blk, load_slot, words);
    while (scan_step(rows, words, b0, b2, blk, slot, load_blk, load_slot,
                     kept, removed) &&
           scan_step(rows, words, b1, b0, blk, slot, load_blk, load_slot,
                     kept, removed) &&
           scan_step(rows, words, b2, b1, blk, slot, load_blk, load_slot,
                     kept, removed)) {
    }
  }
}

// The greedy scan of greedy_scan with the removed words in shared memory:
// `removed` holds slots * 32 words, slots = ceil(words / 32), any number of
// them. On return removed[w] is word w of the removed mask.
template <class Rows>
__device__ __forceinline__ void greedy_scan_shared(const Rows& rows,
                                                   int words, int slots,
                                                   uint32_t* removed) {
  const int lane = static_cast<int>(threadIdx.x & 31);
  for (int t = 0; t < slots; ++t) removed[(t << 5) + lane] = 0u;
  uint32_t kept = 0u;
  int blk = 0, slot = 0, load_blk = 0, load_slot = 0;
  uint32_t b0[32], b1[32], b2[32];
  load_unit(rows, load_blk, load_slot, words, b0);
  advance(load_blk, load_slot, words, slots);
  load_unit(rows, load_blk, load_slot, words, b1);
  advance(load_blk, load_slot, words, slots);
  // three buffers rotate by name, two units' loads in flight
  for (;;) {
    load_unit(rows, load_blk, load_slot, words, b2);
    advance(load_blk, load_slot, words, slots);
    scan_unit_shared(b0, blk, slot, kept, removed);
    advance(blk, slot, words, slots);
    if (blk >= words) break;
    load_unit(rows, load_blk, load_slot, words, b0);
    advance(load_blk, load_slot, words, slots);
    scan_unit_shared(b1, blk, slot, kept, removed);
    advance(blk, slot, words, slots);
    if (blk >= words) break;
    load_unit(rows, load_blk, load_slot, words, b1);
    advance(load_blk, load_slot, words, slots);
    scan_unit_shared(b2, blk, slot, kept, removed);
    advance(blk, slot, words, slots);
    if (blk >= words) break;
  }
}

// keep[32w + b] = 1 - bit b of removed word w: two 16-byte stores (out must
// be 16-byte aligned).
__device__ __forceinline__ void store_keep_word(uint32_t removed_word, int w,
                                                uint8_t* __restrict__ out) {
  const uint32_t x = ~removed_word;
  uint32_t q[8];
#pragma unroll
  for (int g = 0; g < 8; ++g) {
    const uint32_t nib = (x >> (4 * g)) & 0xfu;
    q[g] = (nib & 1u) | ((nib & 2u) << 7) | ((nib & 4u) << 14) |
           ((nib & 8u) << 21);
  }
  uint4* o = reinterpret_cast<uint4*>(out + (static_cast<size_t>(w) << 5));
  o[0] = make_uint4(q[0], q[1], q[2], q[3]);
  o[1] = make_uint4(q[4], q[5], q[6], q[7]);
}

// The keep bytes of the lane's removed words.
template <int WPL>
__device__ __forceinline__ void write_keep(const uint32_t (&removed)[WPL],
                                           int words,
                                           uint8_t* __restrict__ out) {
  const int lane = static_cast<int>(threadIdx.x & 31);
#pragma unroll
  for (int t = 0; t < WPL; ++t) {
    const int w = (t << 5) + lane;
    if (w < words) store_keep_word(removed[t], w, out);
  }
}

}  // namespace nms
