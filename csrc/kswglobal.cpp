// Banded global alignment with traceback (bwa's ksw_global2 semantics)
// plus NM/MD tag computation — the native twin of
// bwamem_tpu/pipeline/cigar.py (the tested golden implementation).
//
// The reference FPGA is score-only; bwa runs this second, traceback
// pass on the host CPU (SURVEY.md §7 "hard parts").  In this build the
// pass stays host-side too (ops/global_jax is the device option), but the Python/numpy row loop costs
// ~1 ms per region — the single largest host cost in the profile — so
// it is replicated here at C speed.  Cell ordering, tie-breaking
// (M >= E, H >= F; strict > keeps a gap open) and the 6-bit traceback
// encoding are byte-identical to cigar.py: the Python twin is the
// correctness oracle (tests/test_cigar.py fuzzes them against each
// other) and both reproduce bwa-0.7.8 CIGARs.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr int32_t NEG_INF = -(1 << 28);

inline void push_op(int32_t* cigar, int64_t& n, int32_t op, int32_t len) {
  if (n > 0 && cigar[2 * (n - 1)] == op) {
    cigar[2 * (n - 1) + 1] += len;
  } else {
    cigar[2 * n] = op;
    cigar[2 * n + 1] = len;
    ++n;
  }
}

}  // namespace

extern "C" {

// Returns the number of (op, len) pairs written to out_cigar (flattened
// pairs), or -1 if cigar_cap is too small.  Score lands in *out_score.
// ops: 0=M, 1=I, 2=D (cigar.py M_OP/I_OP/D_OP).  Caller guarantees
// qlen > 0 and tlen > 0 (the empty cases are trivial and stay in
// Python).
int64_t bwamem_ksw_global(const uint8_t* query, int64_t qlen,
                          const uint8_t* target, int64_t tlen,
                          const int8_t* mat, int64_t m, int64_t o_del,
                          int64_t e_del, int64_t o_ins, int64_t e_ins,
                          int64_t w, int32_t* out_cigar, int64_t cigar_cap,
                          int64_t* out_score) {
  const int32_t oe_del = static_cast<int32_t>(o_del + e_del);
  const int32_t oe_ins = static_cast<int32_t>(o_ins + e_ins);
  int64_t diff = tlen > qlen ? tlen - qlen : qlen - tlen;
  if (w < diff) w = diff;

  std::vector<int32_t> eh_h(qlen + 1, NEG_INF), eh_e(qlen + 1, NEG_INF);
  // z[i*(qlen)+j]: bits[1:0] H direction (0=M,1=E,2=F); bit2 E-continue;
  // bit5 F-continue (ksw.c's d |= 1<<2 / 2<<4 encoding)
  std::vector<uint8_t> z(static_cast<size_t>(tlen) * qlen);

  eh_h[0] = 0;
  for (int64_t j = 1; j <= qlen && j <= w; ++j)
    eh_h[j] = static_cast<int32_t>(-(o_ins + e_ins * j));

  for (int64_t i = 0; i < tlen; ++i) {
    const int8_t* mrow = mat + target[i] * m;
    int64_t beg = i - w > 0 ? i - w : 0;
    int64_t end = i + w + 1 < qlen ? i + w + 1 : qlen;
    int32_t h1 =
        beg == 0 ? static_cast<int32_t>(-(o_del + e_del * (i + 1))) : NEG_INF;
    int32_t f = NEG_INF;
    uint8_t* zrow = z.data() + static_cast<size_t>(i) * qlen;
    for (int64_t j = beg; j < end; ++j) {
      // eh[j] = { H(i-1,j-1), E(i,j) }; f = F(i,j); h1 = H(i,j-1)
      int32_t mh = eh_h[j];
      int32_t e = eh_e[j];
      eh_h[j] = h1;
      mh += mrow[query[j]];
      uint8_t d = mh >= e ? 0 : 1;
      int32_t h = mh >= e ? mh : e;
      d = h >= f ? d : 2;
      h = h >= f ? h : f;
      h1 = h;
      int32_t t = mh - oe_del;
      e -= static_cast<int32_t>(e_del);
      d |= e > t ? (1 << 2) : 0;
      e = e > t ? e : t;
      eh_e[j] = e;
      t = mh - oe_ins;
      f -= static_cast<int32_t>(e_ins);
      d |= f > t ? (2 << 4) : 0;
      f = f > t ? f : t;
      zrow[j] = d;
    }
    eh_h[end] = h1;
    eh_e[end] = NEG_INF;
  }
  *out_score = eh_h[qlen];

  // traceback (ksw.c: which = z >> (which<<1) & 3), ops reversed at end
  if (cigar_cap < 2) return -1;
  std::vector<int32_t> rev(2 * (qlen + tlen + 2));
  int64_t n = 0;
  int64_t i = tlen - 1, k = qlen - 1;
  int which = 0;
  while (i >= 0 && k >= 0) {
    which = (z[static_cast<size_t>(i) * qlen + k] >> (which << 1)) & 3;
    if (which == 0) {
      push_op(rev.data(), n, 0, 1);
      --i;
      --k;
    } else if (which == 1) {
      push_op(rev.data(), n, 2, 1);
      --i;
    } else {
      push_op(rev.data(), n, 1, 1);
      --k;
    }
  }
  if (i >= 0) push_op(rev.data(), n, 2, static_cast<int32_t>(i + 1));
  if (k >= 0) push_op(rev.data(), n, 1, static_cast<int32_t>(k + 1));
  if (n > cigar_cap) return -1;
  for (int64_t p = 0; p < n; ++p) {
    out_cigar[2 * p] = rev[2 * (n - 1 - p)];
    out_cigar[2 * p + 1] = rev[2 * (n - 1 - p) + 1];
  }
  return n;
}

// NM (edit distance) and MD tag from the aligned segments
// (bwa_gen_cigar2's on-the-fly computation; twin of
// cigar.py compute_nm_md).  Returns the MD string length written to
// md_out (NUL-terminated), or -1 if md_cap is too small.  NM lands in
// *out_nm.
int64_t bwamem_cigar_nm_md(const uint8_t* query, const uint8_t* rseq,
                           const int32_t* cigar, int64_t n_cigar,
                           char* md_out, int64_t md_cap, int64_t* out_nm) {
  static const char ACGTN[] = "ACGTN";
  int64_t nm = 0;
  int64_t qi = 0, ri = 0;
  int64_t len = 0;
  int32_t match_run = 0;
  auto put_num = [&](int32_t v) -> bool {
    char buf[12];
    int nd = 0;
    if (v == 0) buf[nd++] = '0';
    while (v > 0) {
      buf[nd++] = static_cast<char>('0' + v % 10);
      v /= 10;
    }
    if (len + nd >= md_cap) return false;
    for (int d = nd - 1; d >= 0; --d) md_out[len++] = buf[d];
    return true;
  };
  auto put_ch = [&](char c) -> bool {
    if (len + 1 >= md_cap) return false;
    md_out[len++] = c;
    return true;
  };
  for (int64_t ci = 0; ci < n_cigar; ++ci) {
    int32_t op = cigar[2 * ci], cn = cigar[2 * ci + 1];
    if (op == 0) {  // M
      for (int32_t t = 0; t < cn; ++t) {
        uint8_t q = query[qi], r = rseq[ri];
        if (q > 3 || r > 3 || q != r) {
          if (!put_num(match_run)) return -1;
          match_run = 0;
          if (!put_ch(ACGTN[r > 4 ? 4 : r])) return -1;
          ++nm;
        } else {
          ++match_run;
        }
        ++qi;
        ++ri;
      }
    } else if (op == 1) {  // I
      qi += cn;
      nm += cn;
    } else if (op == 2) {  // D
      if (!put_num(match_run)) return -1;
      match_run = 0;
      if (!put_ch('^')) return -1;
      for (int32_t t = 0; t < cn; ++t) {
        uint8_t r = rseq[ri + t];
        if (!put_ch(ACGTN[r > 4 ? 4 : r])) return -1;
      }
      ri += cn;
      nm += cn;
    } else if (op == 3) {  // S
      qi += cn;
    }  // H: nothing
  }
  if (!put_num(match_run)) return -1;
  md_out[len] = '\0';
  *out_nm = nm;
  return len;
}

}  // extern "C"
