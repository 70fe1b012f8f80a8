// Banded seed extension of one lane with bwa-0.7.8 ksw_extend2 semantics
// (ops/extend_ref.ksw_extend_core, line for line), and the fused
// whole-alignment lane: L0, the L1 retry, left->right h0 chaining, R0 and
// the R1 retry.
//
// One source, two builds: the CUDA kernel (cuda/banded_extend.cu) runs one
// lane per thread on the GPU; banded_lanes.cpp runs the same functions on
// the host, which is how the CPU tests compare this arithmetic with
// extend_ref and with the plain XLA step (ops/extend_step.py).
//
// Layout: every array is lane-minor — element k of a lane sits at
// base[k * stride] (the transposed (rows, B) layout of the device step);
// queries, targets, scalars/outputs and the eh scratch each take their
// own stride, so a kernel can stage some of them in shared memory.
#pragma once

#include <cstdint>

#ifdef __CUDACC__
#define BW_HD __host__ __device__ __forceinline__
#else
#define BW_HD inline
#endif

struct BwPrm {
  int32_t a, b, o_del, e_del, o_ins, e_ins, zdrop;
};

struct BwRes {
  int32_t score, qle, tle, gtle, gscore, max_off;
};

// One banded pass.  q/t: base codes (0..4) of this lane; eh_h/eh_e hold
// qlen + 1 entries.  A lane with qlen, tlen or h0 <= 0 is inert and
// returns (h0, 0, 0, 0, -1, 0).
BW_HD BwRes bw_pass(const int8_t* q, int64_t q_stride, const int8_t* t,
                    int64_t t_stride, int32_t qlen, int32_t tlen, int32_t w,
                    int32_t h0, const BwPrm& p, int32_t* eh_h,
                    int32_t* eh_e, int64_t eh_stride) {
  BwRes r = {h0, 0, 0, 0, -1, 0};
  if (qlen <= 0 || tlen <= 0 || h0 <= 0) return r;
  const int32_t oe_del = p.o_del + p.e_del, oe_ins = p.o_ins + p.e_ins;
  // first (virtual) row: eh[0].h = h0, then decreasing by e_ins while > 0
  eh_h[0] = h0;
  eh_e[0] = 0;
  for (int32_t j = 1; j <= qlen; ++j) {
    int32_t v = h0 - oe_ins - (j - 1) * p.e_ins;
    eh_h[j * eh_stride] = v > 0 ? v : 0;
    eh_e[j * eh_stride] = 0;
  }
  int32_t max = h0, max_i = -1, max_j = -1, max_ie = -1, gscore = -1;
  int32_t max_off = 0, beg = 0, end = qlen;
  for (int32_t i = 0; i < tlen; ++i) {
    const int32_t ti = t[i * t_stride];
    int32_t f = 0, m = 0, mj = -1, h1;
    if (beg < i - w) beg = i - w;
    if (end > i + w + 1) end = i + w + 1;
    if (end > qlen) end = qlen;
    if (beg == 0) {
      h1 = h0 - (p.o_del + p.e_del * (i + 1));
      if (h1 < 0) h1 = 0;
    } else {
      h1 = 0;
    }
    for (int32_t j = beg; j < end; ++j) {
      // eh[j] = {H(i-1,j-1), E(i,j)}, f = F(i,j), h1 = H(i,j-1)
      int32_t* ph = eh_h + j * eh_stride;
      int32_t* pe = eh_e + j * eh_stride;
      const int32_t qj = q[j * q_stride];
      int32_t mm = *ph, e = *pe;
      *ph = h1;
      const int32_t s = (qj > 3 || ti > 3) ? -1 : (qj == ti ? p.a : -p.b);
      mm = mm ? mm + s : 0;
      int32_t h = mm > e ? mm : e;
      h = h > f ? h : f;
      h1 = h;
      if (h >= m) {  // mj = m > h ? mj : j (ties pick the later j)
        mj = j;
        m = h;
      }
      int32_t u = mm - oe_del;
      u = u > 0 ? u : 0;
      e -= p.e_del;
      *pe = e > u ? e : u;
      u = mm - oe_ins;
      u = u > 0 ? u : 0;
      f -= p.e_ins;
      f = f > u ? f : u;
    }
    eh_h[end * eh_stride] = h1;
    eh_e[end * eh_stride] = 0;
    if (end == qlen) {
      if (!(gscore > h1)) max_ie = i;
      if (h1 > gscore) gscore = h1;
    }
    if (m == 0) break;
    if (m > max) {
      max = m;
      max_i = i;
      max_j = mj;
      const int32_t off = mj > i ? mj - i : i - mj;
      if (off > max_off) max_off = off;
    } else if (p.zdrop > 0) {
      const int32_t di = i - max_i, dj = mj - max_j;
      const int32_t pen = di > dj ? (di - dj) * p.e_del : (dj - di) * p.e_ins;
      if (max - m - pen > p.zdrop) break;
    }
    // zero-run band trimming for the next row
    int32_t j = beg;
    while (j < end && eh_h[j * eh_stride] == 0 && eh_e[j * eh_stride] == 0)
      ++j;
    beg = j;
    j = end;
    while (j >= beg && eh_h[j * eh_stride] == 0 && eh_e[j * eh_stride] == 0)
      --j;
    end = j + 2 < qlen ? j + 2 : qlen;
  }
  r.score = max;
  r.qle = max_j + 1;
  r.tle = max_i + 1;
  r.gtle = max_ie + 1;
  r.gscore = gscore;
  r.max_off = max_off;
  return r;
}

BW_HD void bw_emit(int32_t* out, int64_t stride, int row0, const BwRes& r,
                   int32_t aw) {
  const int32_t v[8] = {r.score, r.qle, r.tle, r.gtle,
                        r.gscore, r.max_off, aw, 0};
  for (int k = 0; k < 8; ++k) out[(row0 + k) * stride] = v[k];
}

// The fused lane; the scalars s and out share `stride`.  s rows:
// [0]=qlen_l [1]=tlen_l [2]=aw0_l [3]=h0 [4]=aw1_l [5]=qlen_r [6]=tlen_r
// [7]=aw0_r [8]=aw1_r [9]=w.  A retry
// pass runs only when the first did not converge, max_off < (w>>1)+(w>>2)
// (csrc/mempipe.cpp mp_pass_done); otherwise its group holds the inert
// result.  out: 32 rows, [L0 | L1 | R0 | R1] x [score, qle, tle, gtle,
// gscore, max_off, aw, 0].
BW_HD void bw_fused_lane(const int8_t* ql, const int8_t* qr,
                         int64_t q_stride, const int8_t* tl,
                         const int8_t* tr, int64_t t_stride,
                         const int32_t* s, int32_t* out, int64_t stride,
                         const BwPrm& p, int32_t* eh_h, int32_t* eh_e,
                         int64_t eh_stride) {
  const int32_t w = s[9 * stride];
  const int32_t thr = (w >> 1) + (w >> 2);
  int32_t h0 = s[3 * stride];
  for (int side = 0; side < 2; ++side) {
    const int8_t* q = side ? qr : ql;
    const int8_t* t = side ? tr : tl;
    const int row = side ? 5 : 0;
    const int32_t qlen = s[row * stride], tlen = s[(row + 1) * stride];
    const int32_t aw0 = s[(row + 2) * stride];
    const int32_t aw1 = s[(side ? 8 : 4) * stride];
    const BwRes r0 = bw_pass(q, q_stride, t, t_stride, qlen, tlen, aw0, h0,
                             p, eh_h, eh_e, eh_stride);
    bw_emit(out, stride, 16 * side, r0, aw0);
    const bool conv = r0.max_off < thr;
    const BwRes r1 = bw_pass(q, q_stride, t, t_stride, conv ? 0 : qlen,
                             tlen, aw1, h0, p, eh_h, eh_e, eh_stride);
    bw_emit(out, stride, 16 * side + 8, r1, aw1);
    h0 = conv ? r0.score : r1.score;  // bwa's left->right h0 chaining
  }
}
