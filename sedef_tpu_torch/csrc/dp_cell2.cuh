// The cell of the anti-diagonal affine-gap DP on two lanes at once: lanes 2j
// and 2j + 1 in the low and the high int16 half of one 32-bit word, for every
// plane (u, v, x, y, the score and the query code).  Included only by the
// fill variants (wavefront_fill_variants.cu: dpx2, dpx2u4, dpx2reg,
// dpx2clu2, dpx2clu4).  The recurrence is dp_cell's (dp_cell.cuh), on both
// halves; tests/test_torch_fill_dpx2.py emulates this file word for word on
// the CPU (same intrinsics, same order) and holds it to the reference.
//
// Every step is one Hopper instruction on both halves:
//  * the additions: __vadd2 (VIADD.16x2); a subtraction z - w is z + 1 +
//    ~w, the "+ 1" taken once a word (__vsub2 would be three instructions);
//  * each max-and-test pair: __vibmax_s16x2 (VIMNMX.S16x2 with two
//    predicates), the max and "z >= a" for both halves; the strict test
//    "a > z" that decides a direction bit is the predicate's complement;
//  * the clamp: __vmins2 (VIMNMX.S16x2); x = max(a - z2, 0) and y: one
//    __viaddmax_s16x2_relu each (VIADDMNMX.S16x2.RELU), with -z2 = gapo - z
//    computed once;
//  * the score: a table lookup.  Query codes are 0..3 and 4 (wildcard),
//    target codes 0..3 and 8 (wildcard), so k = min(q ^ t, 4) is 0 for a
//    match, 1..3 for a mismatch and 4 where either side is a wildcard; one
//    prmt (byte_perm) with the sign-replicating selector reads the int8
//    score of both halves from an 8-byte table and sign-extends it to 16
//    bits.
//
// No borrow or carry crosses a half: every add is per half, except the two
// direction-flag adds, which add 0x7fff to values the relu put in [0, 0x7fff]
// (at most 0xfffe: no carry out of a half).  Lanes outside the band compute
// values that nothing in the band reads, and they stay in their own half.
// In the band every value fits an int16 when max_sc + gapo < 2^15 and the
// match and mismatch scores fit an int8 (the table): there u, v lie in
// [0, max_sc], x, y in [0, gapo], a and b in [0, max_sc + gapo], z2 in
// [-gapo, max_sc - gapo] and a - z2 in [gapo - max_sc, 2 gapo].  The
// wrapper refuses other scorings.

#pragma once

#include <stdint.h>

namespace sedef {

constexpr unsigned Q_WILD2 = 4;  // a query code in a word: 0..3 or 4
constexpr unsigned T_WILD2 = 8;  // a target code in a word: 0..3 or 8

// The scoring as words (both halves hold the same value).
struct Score2 {
  unsigned qe2;     // 2 (gapo + gape): z = score + qe2
  unsigned max_sc;  // the clamp
  unsigned gapo1;   // gapo + 1: gapo - z = ~z + gapo1
  unsigned tab_lo;  // int8 scores by k = min(q ^ t, 4): match, mis x 3, 0
  unsigned tab_hi;
};

__host__ __device__ inline unsigned splat16(int v) {
  return (unsigned)(v & 0xffff) * 0x10001u;
}

__host__ __device__ inline Score2 score2(int match, int mis, int gapo,
                                         int qe2) {
  const unsigned m = (unsigned)(match & 0xff), x = (unsigned)(mis & 0xff);
  return {splat16(qe2), splat16(match + qe2), splat16(gapo + 1),
          m | x << 8 | x << 16 | x << 24, 0u};
}

// The in-band values of a scoring fit an int16 and its scores the table.
__host__ __device__ inline bool score2_fits(int match, int mis, int gapo,
                                            int gape) {
  const int max_sc = match + 2 * (gapo + gape);
  return gapo >= 0 && gape >= 0 && match >= -128 && match <= 127 &&
         mis >= -128 && mis <= 127 && max_sc >= 0 && max_sc + gapo < 32768;
}

__device__ __forceinline__ unsigned prmt(unsigned a, unsigned b,
                                         unsigned sel) {
  unsigned d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// Lane t - 1 of the word holding lanes (t, t + 1): the high half of the
// word before and the low half of this one.
__device__ __forceinline__ unsigned left_of(unsigned prev, unsigned cur) {
  return __byte_perm(prev, cur, 0x5432);
}

// A query or target code as a word half holds it.
__device__ __forceinline__ unsigned query_code2(int c) {
  return (unsigned)c < 4u ? (unsigned)c : Q_WILD2;
}
__device__ __forceinline__ unsigned target_code2(int c) {
  return (unsigned)c < 4u ? (unsigned)c : T_WILD2;
}

// score + qe2 of both halves, from the query and target code words.
__device__ __forceinline__ unsigned score_word(unsigned q, unsigned t,
                                               const Score2& s) {
  const unsigned k = __vmins2(q ^ t, 0x00040004u);
  // selector nibbles: k_lo, k_lo | 8 (the sign of byte k_lo), k_hi, k_hi | 8
  const unsigned m = k * 0x11u + 0x00800080u;
  const unsigned sel = __byte_perm(m, 0u, 0x0020);
  return __vadd2(prmt(s.tab_lo, s.tab_hi, sel), s.qe2);
}

// One word of two cells.  (xs, vs): x and v of lanes t - 1 in the row
// before; (ub, yb): u and y of lanes t in the row before; z: the score word
// + qe2; all after boundary injection.  Returns the two direction bytes in
// bits 0-7 (low lane) and 16-23 (high lane).
__device__ __forceinline__ unsigned dp_cell2(unsigned z, unsigned xs,
                                             unsigned vs, unsigned ub,
                                             unsigned yb, const Score2& s,
                                             unsigned& u, unsigned& v,
                                             unsigned& x, unsigned& y) {
  const unsigned a = __vadd2(xs, vs);
  const unsigned b = __vadd2(yb, ub);
  bool za_hi, za_lo, zb_hi, zb_lo;  // z >= a, z >= b
  z = __vibmax_s16x2(z, a, &za_hi, &za_lo);
  z = __vibmax_s16x2(z, b, &zb_hi, &zb_lo);
  z = __vmins2(z, s.max_sc);
  const unsigned nz2 = __vadd2(~z, s.gapo1);  // gapo - z = -(z - gapo)
  x = __viaddmax_s16x2_relu(a, nz2, 0u);
  y = __viaddmax_s16x2_relu(b, nz2, 0u);
  const unsigned z1 = __vadd2(z, 0x00010001u);
  u = __vadd2(z1, ~vs);  // z - vs
  v = __vadd2(z1, ~ub);  // z - ub
  // x > 0 and y > 0 as bit 15 of each half (x, y <= 0x7fff: no carry)
  const unsigned fx = (x + 0x7fff7fffu) & 0x80008000u;
  const unsigned fy = (y + 0x7fff7fffu) & 0x80008000u;
  const unsigned d_lo = zb_lo ? (za_lo ? 0u : 1u) : 2u;
  const unsigned d_hi = zb_hi ? (za_hi ? 0u : 1u) : 2u;
  return (fx >> 12) | (fy >> 11) | d_lo | d_hi << 16;
}

// The four direction bytes of a thread's lanes, from its two words.
__device__ __forceinline__ unsigned dir_bytes(unsigned d0, unsigned d1) {
  return __byte_perm(d0, d1, 0x6420);
}

// The top-row injection (u, y) = (t ? gapo : 0, 0) of lane t0 + k, k =
// r - t0 in [0, 2 WPT), into the thread's WPT words of u and y.
template <int WPT = 2>
__device__ __forceinline__ void inject_top2(int k, int t0, int gapo,
                                            unsigned (&u)[WPT],
                                            unsigned (&y)[WPT]) {
  const int sh = (k & 1) * 16;
  const unsigned keep = ~(0xffffu << sh);
  const unsigned val = (unsigned)(t0 + k > 0 ? gapo : 0) << sh;
#pragma unroll
  for (int w = 0; w < WPT; ++w)
    if (k >> 1 == w) {
      u[w] = (u[w] & keep) | val;
      y[w] &= keep;
    }
}

}  // namespace sedef
