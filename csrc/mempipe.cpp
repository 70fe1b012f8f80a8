// Native single-end host pipeline: chaining -> extension planning ->
// band-doubling replay -> regions -> dedup/MAPQ -> global realignment ->
// SAM fields, at C speed with internal threading.
//
// This is the build's "host half" — the role the patched bwa-0.7.8
// C host plays in the reference system (SURVEY.md §0: seeding, chaining
// and SAM emission run on CPU threads while the accelerator extends;
// README.md:28 `-t $NTHREAD`).  The device (ops/extend_step) handles only
// the banded extension; this module plans the extension tasks, consumes
// the (B, 8) result matrices between phases, and produces per-record
// SAM fields.
//
// Semantics are a line-by-line port of the tested Python oracle
// (bwamem_tpu/pipeline/{chain,align,driver,cigar}.py — bwa-0.7.8
// semantics); tests/test_native_pipe.py pins native SAM == Python SAM.
//
// Protocol (driven by bwamem_tpu/pipeline/native_driver.py):
//   h = mp_new(...)                      once per index
//   mp_chunk_start(h, reads, ...)        seed+chain+plan left tasks
//   loop: B = mp_task_count(h); fill device arrays via mp_fill_tasks;
//         run kernel; nretry = mp_pass_done(h, results)
//         (k=0 then optional k=1, for phase L then phase R;
//          mp_prepare_right switches phases)
//   mp_finalize(h)                       replay + regions + records
//   mp_get_records(h, ...)               flat fields + string blob
//   mp_export_regions(h, ...)            (PE path: regions only)

#include <algorithm>
#include <atomic>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <set>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

extern "C" int64_t bwamem_collect_seeds(
    const int64_t* C, int64_t primary, int64_t n_rows,
    const int32_t* occ_rows, const uint32_t* pk_rows,
    const uint32_t* va_rows, const int64_t* ssa, int64_t n_ssa,
    int64_t sa_intv, const uint8_t* reads, const int64_t* qlen,
    int64_t n_reads, int64_t L, int64_t min_seed_len, int64_t split_len,
    int64_t split_width, int64_t max_occ, int64_t* seeds_out, int64_t cap);

extern "C" int64_t bwamem_ksw_global(const uint8_t* query, int64_t qlen,
                                     const uint8_t* target, int64_t tlen,
                                     const int8_t* mat, int64_t m,
                                     int64_t o_del, int64_t e_del,
                                     int64_t o_ins, int64_t e_ins, int64_t w,
                                     int32_t* out_cigar, int64_t cigar_cap,
                                     int64_t* out_score);

extern "C" int64_t bwamem_cigar_nm_md(const uint8_t* query,
                                      const uint8_t* rseq,
                                      const int32_t* cigar, int64_t n_cigar,
                                      char* md_out, int64_t md_cap,
                                      int64_t* out_nm);

namespace {

struct Opt {
  int64_t a, b, o_del, e_del, o_ins, e_ins, w, zdrop;
  int64_t pen_clip5, pen_clip3, min_seed_len, split_width, max_occ;
  int64_t max_chain_gap, T, flag_M, flag_a, max_xa_hits;
  int64_t pen_unpaired = 17, max_matesw = 100, max_ins = 10000;
  int64_t skip_pairing = 0;  // -P (bwa MEM_F_NOPAIRING)
  double split_factor, drop_ratio, mask_level, mapq_coef_len, mapq_coef_fac;
  // -I: explicit FR insert-size distribution (skips mem_pestat)
  double pe_mean = -1.0, pe_std = -1.0, pe_max = -1.0, pe_min = -1.0;
};

struct SeedC {
  int64_t rbeg, qbeg, len;
  int64_t qend() const { return qbeg + len; }
  int64_t rend() const { return rbeg + len; }
};

struct ChainC {
  std::vector<SeedC> seeds;
  int64_t pos;
  int64_t w = 0;
};

struct ExtRes {
  int32_t score, qle, tle, gtle, gscore, max_off;
};

struct TaskC {
  int32_t ci, si;
  int8_t side;  // 0 = L, 1 = R
  int64_t qoff, qlen, toff, tlen;  // into PerRead::qbuf / chain rseq
  int64_t h0 = 0, max_ins = 1, max_del = 1;
  ExtRes res[2];  // pass k=0 / k=1 (k=1 duplicates k=0 if converged)
};

struct RegionC {
  int64_t rb = 0, re = 0, qb = 0, qe = 0;
  int64_t score = -1, truesc = -1, w = 0, seedcov = 0, seedlen0 = 0;
  int64_t sub = 0, csub = 0, sub_n = 0, secondary = -1;
};

struct RecordC {
  int64_t flag = 0, rid = -1, pos = -1, mapq = 0, nm = -1;
  int64_t score = 0, sub = -1;
  bool is_rev = false;
  int64_t ref_span = 0;              // reference length of the cigar
  // paired-end fields: mate_rid == -9 means "single-end record"
  int64_t src_read = -1, mate_rid = -9, pnext0 = -1, tlen = 0;
  std::string cigar, md, xa, sa;
};

constexpr int64_t MAX_BAND_TRY = 2;
constexpr double MASK_LEVEL_REDUN = 0.95;

struct PerRead {
  std::vector<ChainC> chains;
  std::vector<std::vector<uint8_t>> rseq;  // per chain
  std::vector<int64_t> rmax0;
  std::vector<uint8_t> qbuf;  // reversed/forward query segments
  std::vector<TaskC> tasks;
  // (ci, si, side) -> task index, laid out per chain: seeds*2
  std::vector<std::vector<int32_t>> tidx;
  std::vector<RegionC> regions;
  std::vector<RecordC> records;
};

struct PEStatC {
  int64_t low = 0, high = 0;
  double avg = 0.0, std = 0.0;
  bool failed = true;
};

// one reg2aln banded-global result (score + CIGAR), as produced by the
// device-CIGAR rounds (ops/global_jax) or the host retry loop
struct GlobalResC {
  int64_t score = 0;
  std::vector<std::pair<int32_t, int32_t>> cigar;
};

struct MemPipe {
  Opt opt;
  int8_t mat[25];
  const uint8_t* pac = nullptr;
  int64_t l_pac = 0;
  std::vector<int64_t> ctg_off, ctg_len;
  std::vector<std::string> ctg_name;
  // seeding index
  const int64_t* C = nullptr;
  int64_t primary = 0, n_rows = 0;
  const int32_t* occ_rows = nullptr;
  const uint32_t* pk_rows = nullptr;
  const uint32_t* va_rows = nullptr;
  const int64_t* ssa = nullptr;
  int64_t n_ssa = 0, sa_intv = 0;
  // chunk state
  int64_t n_reads = 0, L = 0;
  const uint8_t* reads = nullptr;
  std::vector<int64_t> qlen;
  std::vector<PerRead> per;
  int phase = 0;  // 0 = L, 1 = R
  int pass_k = 0;
  std::vector<std::pair<int32_t, int32_t>> cur;  // (read, task) sorted
  // fused protocol: one lane per (chain, seed) candidate; task index
  // -1 = that side absent
  struct FusedLane {
    int32_t ri, lt, rt;
    int64_t h0_seed;
  };
  std::vector<FusedLane> fused;
  // record export offsets
  std::vector<int64_t> rec_read;  // flattened record -> read idx
  // device-rescue wave protocol (mem_matesw batched onto the
  // accelerator): pestat + per-pair anchor lists + the current wave's
  // SW tasks.  Pairs are independent within a wave, so batching wave k
  // across all pairs preserves bwa's per-pair sequential-anchor
  // semantics exactly (each anchor's skip test sees the regions
  // appended by waves 0..k-1).
  std::string rg_id;  // -R read group: RG:Z:<id> on every record
  PEStatC pe_stat[4];
  int64_t pe_npairs = 0;
  std::vector<std::vector<RegionC>> rescue_anchors;  // per pair, one end
  struct RescueTask {
    int64_t mate_read;  // read index whose regions grow on success
    int64_t rb;         // window start (2-strand coords)
    int64_t l_ms;       // mate length
    bool is_rev;
    std::vector<uint8_t> seq, rseq;
  };
  std::vector<RescueTask> rescue_tasks;
  // device-CIGAR round protocol (reg2aln's banded global realignments
  // batched onto the accelerator, SE path): active retry-loop state
  // per (read, region) plus finished results keyed ri * cig_stride + ki
  struct CigTask {
    int64_t ri, ki;
    std::vector<uint8_t> qseg, rseg;
    int64_t w2, last_sc, round, truesc;
    int64_t qb = 0, rb = 0, re = 0;  // region coords (resident-ref
    //                                  device rounds gather from them)
  };
  std::vector<CigTask> cig_tasks;
  std::unordered_map<int64_t, GlobalResC> cig_results;
  int64_t cig_stride = 0;
};

int64_t cal_max_gap(const Opt& o, int64_t qlen) {
  int64_t l_del =
      static_cast<int64_t>((qlen * o.a - o.o_del) / (double)o.e_del + 1.0);
  int64_t l_ins =
      static_cast<int64_t>((qlen * o.a - o.o_ins) / (double)o.e_ins + 1.0);
  int64_t l = std::max(std::max(l_del, l_ins), (int64_t)1);
  return std::min(l, o.w << 1);
}

int64_t max_gap_bound(const Opt& o, int64_t qlen, int64_t oo, int64_t e,
                      int64_t end_bonus) {
  return std::max(
      static_cast<int64_t>((qlen * o.a + end_bonus - oo) / (double)e + 1.0),
      (int64_t)1);
}

// ---- chaining (chain.py chain_seeds / filter_chains) ----

bool test_and_merge(const Opt& o, int64_t l_pac, ChainC& c, const SeedC& s) {
  const SeedC& last = c.seeds.back();
  int64_t qend = last.qend(), rend = last.rend();
  if (s.rbeg >= c.seeds[0].rbeg && s.qbeg >= c.seeds[0].qbeg &&
      s.qend() <= qend && s.rend() <= rend)
    return true;  // contained seed, do nothing
  if ((c.seeds[0].rbeg < l_pac || last.rbeg < l_pac) && s.rbeg >= l_pac)
    return false;
  int64_t x = s.qbeg - last.qbeg;
  int64_t y = s.rbeg - last.rbeg;
  if (y >= 0 && x - y <= o.w && y - x <= o.w &&
      x - last.len < o.max_chain_gap && y - last.len < o.max_chain_gap) {
    c.seeds.push_back(s);
    return true;
  }
  return false;
}

int64_t chain_weight(const ChainC& c) {
  int64_t w_q = 0, end = 0;
  for (const auto& s : c.seeds) {
    if (s.qbeg >= end)
      w_q += s.len;
    else if (s.qend() > end)
      w_q += s.qend() - end;
    end = std::max(end, s.qend());
  }
  int64_t w_r = 0;
  end = 0;
  for (const auto& s : c.seeds) {
    if (s.rbeg >= end)
      w_r += s.len;
    else if (s.rend() > end)
      w_r += s.rend() - end;
    end = std::max(end, s.rend());
  }
  return std::min(w_q, w_r);
}

void chain_read(const MemPipe& mp, const SeedC* seeds, int64_t n,
                std::vector<ChainC>& out) {
  std::vector<ChainC> chains;
  std::set<std::pair<int64_t, int64_t>> keys;  // (pos, insertion id)
  for (int64_t i = 0; i < n; ++i) {
    const SeedC& s = seeds[i];
    bool merged = false;
    auto it = keys.upper_bound({s.rbeg, INT64_MAX});
    if (it != keys.begin()) {
      --it;
      merged = test_and_merge(mp.opt, mp.l_pac,
                              chains[static_cast<size_t>(it->second)], s);
    }
    if (!merged) {
      keys.insert({s.rbeg, static_cast<int64_t>(chains.size())});
      ChainC c;
      c.seeds.push_back(s);
      c.pos = s.rbeg;
      chains.push_back(std::move(c));
    }
  }
  // filter_chains
  out.clear();
  if (chains.empty()) return;
  for (auto& c : chains) c.w = chain_weight(c);
  std::vector<int32_t> order(chains.size());
  for (size_t i = 0; i < order.size(); ++i) order[i] = (int32_t)i;
  std::stable_sort(order.begin(), order.end(), [&](int32_t x, int32_t y) {
    if (chains[x].w != chains[y].w) return chains[x].w > chains[y].w;
    return chains[x].pos < chains[y].pos;
  });
  std::vector<int32_t> kept;
  kept.push_back(order[0]);
  for (size_t i = 1; i < order.size(); ++i) {
    ChainC& c = chains[order[i]];
    bool drop = false;
    for (int32_t ki : kept) {
      ChainC& k = chains[ki];
      int64_t kqb = k.seeds[0].qbeg, kqe = k.seeds.back().qend();
      int64_t cqb = c.seeds[0].qbeg, cqe = c.seeds.back().qend();
      int64_t b_max = std::max(kqb, cqb);
      int64_t e_min = std::min(kqe, cqe);
      if (e_min > b_max) {
        int64_t min_l = std::min(cqe - cqb, kqe - kqb);
        if (e_min - b_max >= min_l * mp.opt.mask_level &&
            min_l < mp.opt.max_chain_gap) {
          if (c.w < k.w * mp.opt.drop_ratio &&
              k.w - c.w >= mp.opt.min_seed_len * 2) {
            drop = true;
            break;
          }
        }
      }
    }
    if (!drop) kept.push_back(order[i]);
  }
  for (int32_t ki : kept) out.push_back(std::move(chains[ki]));
}

// ---- reference fetch (io/fasta.py Reference) ----

int pos2rid(const MemPipe& mp, int64_t pos) {
  for (size_t i = 0; i < mp.ctg_off.size(); ++i)
    if (mp.ctg_off[i] <= pos && pos < mp.ctg_off[i] + mp.ctg_len[i])
      return static_cast<int>(i);
  return -1;
}

void contig_window(const MemPipe& mp, int64_t pos, int64_t* lo, int64_t* hi) {
  int64_t l2 = mp.l_pac << 1;
  if (pos < mp.l_pac) {
    int r = pos2rid(mp, pos);
    *lo = mp.ctg_off[r];
    *hi = mp.ctg_off[r] + mp.ctg_len[r];
  } else {
    int r = pos2rid(mp, l2 - 1 - pos);
    *lo = l2 - (mp.ctg_off[r] + mp.ctg_len[r]);
    *hi = l2 - mp.ctg_off[r];
  }
}

void get_seq(const MemPipe& mp, int64_t beg, int64_t end,
             std::vector<uint8_t>& out) {
  int64_t l2 = mp.l_pac << 1;
  out.resize(end - beg);
  if (end <= mp.l_pac) {
    std::memcpy(out.data(), mp.pac + beg, end - beg);
  } else {
    for (int64_t i = 0; i < end - beg; ++i) {
      uint8_t c = mp.pac[l2 - 1 - (beg + i)];
      out[i] = c < 4 ? 3 - c : c;
    }
  }
}

// ---- extension planning (driver.py _plan_read) ----

void plan_read(const MemPipe& mp, int64_t ri, PerRead& pr) {
  const Opt& o = mp.opt;
  const uint8_t* read = mp.reads + ri * mp.L;
  int64_t l_query = mp.qlen[ri];
  pr.rseq.resize(pr.chains.size());
  pr.rmax0.resize(pr.chains.size());
  pr.tidx.resize(pr.chains.size());
  for (size_t ci = 0; ci < pr.chains.size(); ++ci) {
    const ChainC& c = pr.chains[ci];
    int64_t rmax0 = mp.l_pac << 1, rmax1 = 0;
    for (const auto& t : c.seeds) {
      int64_t b = t.rbeg - (t.qbeg + cal_max_gap(o, t.qbeg));
      int64_t e = t.rbeg + t.len + (l_query - t.qbeg - t.len) +
                  cal_max_gap(o, l_query - t.qbeg - t.len);
      rmax0 = std::min(rmax0, b);
      rmax1 = std::max(rmax1, e);
    }
    rmax0 = std::max(rmax0, (int64_t)0);
    rmax1 = std::min(rmax1, mp.l_pac << 1);
    if (rmax0 < mp.l_pac && mp.l_pac < rmax1) {
      if (c.seeds[0].rbeg < mp.l_pac)
        rmax1 = mp.l_pac;
      else
        rmax0 = mp.l_pac;
    }
    int64_t lo, hi;
    contig_window(mp, c.seeds[0].rbeg, &lo, &hi);
    rmax0 = std::max(rmax0, lo);
    rmax1 = std::min(rmax1, hi);
    get_seq(mp, rmax0, rmax1, pr.rseq[ci]);
    pr.rmax0[ci] = rmax0;
    pr.tidx[ci].assign(c.seeds.size() * 2, -1);
    for (size_t si = 0; si < c.seeds.size(); ++si) {
      const SeedC& s = c.seeds[si];
      if (s.qbeg > 0) {  // left: reversed query prefix, reversed target
        TaskC t;
        t.ci = (int32_t)ci;
        t.si = (int32_t)si;
        t.side = 0;
        t.qoff = (int64_t)pr.qbuf.size();
        t.qlen = s.qbeg;
        for (int64_t j = s.qbeg - 1; j >= 0; --j) pr.qbuf.push_back(read[j]);
        t.toff = 0;  // left target = rseq[:s.rbeg-rmax0] reversed (flagged)
        t.tlen = std::min(std::max(s.rbeg - rmax0, (int64_t)0),
                          (int64_t)pr.rseq[ci].size());
        t.h0 = s.len * o.a;
        t.max_ins = max_gap_bound(o, t.qlen, o.o_ins, o.e_ins, o.pen_clip5);
        t.max_del = max_gap_bound(o, t.qlen, o.o_del, o.e_del, o.pen_clip5);
        pr.tidx[ci][si * 2] = (int32_t)pr.tasks.size();
        pr.tasks.push_back(t);
      }
      if (s.qbeg + s.len != l_query) {  // right: forward suffixes
        TaskC t;
        t.ci = (int32_t)ci;
        t.si = (int32_t)si;
        t.side = 1;
        t.qoff = (int64_t)pr.qbuf.size();
        t.qlen = l_query - (s.qbeg + s.len);
        for (int64_t j = s.qbeg + s.len; j < l_query; ++j)
          pr.qbuf.push_back(read[j]);
        t.toff = std::min(std::max(s.rbeg + s.len - rmax0, (int64_t)0),
                          (int64_t)pr.rseq[ci].size());
        t.tlen = (int64_t)pr.rseq[ci].size() - t.toff;
        t.h0 = 0;  // filled by prepare_right
        t.max_ins = max_gap_bound(o, t.qlen, o.o_ins, o.e_ins, o.pen_clip3);
        t.max_del = max_gap_bound(o, t.qlen, o.o_del, o.e_del, o.pen_clip3);
        pr.tidx[ci][si * 2 + 1] = (int32_t)pr.tasks.size();
        pr.tasks.push_back(t);
      }
    }
  }
}

// driver.py _resolve: replay band-doubling convergence over the two
// stored passes; returns the taken result and the attempted width.
const ExtRes& resolve(const Opt& o, const TaskC& t, int64_t prev_score,
                      int64_t* aw_out = nullptr) {
  int64_t prev = prev_score;
  int k = 0;
  for (; k < MAX_BAND_TRY; ++k) {
    int64_t aw = o.w << k;
    const ExtRes& r = t.res[k];
    if (aw_out) *aw_out = aw;
    if (r.score == prev || r.max_off < ((aw >> 1) + (aw >> 2))) return r;
    prev = r.score;
  }
  if (aw_out) *aw_out = o.w << (MAX_BAND_TRY - 1);
  return t.res[MAX_BAND_TRY - 1];
}

// ---- replay (align.py chain2aln with the precomputed table) ----

void replay_read(const MemPipe& mp, int64_t ri, PerRead& pr) {
  const Opt& o = mp.opt;
  int64_t l_query = mp.qlen[ri];
  auto& regions = pr.regions;
  for (size_t ci = 0; ci < pr.chains.size(); ++ci) {
    const ChainC& c = pr.chains[ci];
    int64_t rmax0 = pr.rmax0[ci];
    // longest-first (ties -> later index first)
    std::vector<int32_t> order(c.seeds.size());
    for (size_t i = 0; i < order.size(); ++i) order[i] = (int32_t)i;
    std::stable_sort(order.begin(), order.end(), [&](int32_t x, int32_t y) {
      if (c.seeds[x].len != c.seeds[y].len)
        return c.seeds[x].len > c.seeds[y].len;
      return x > y;
    });
    for (int32_t k : order) {
      const SeedC& s = c.seeds[k];
      bool skip = false;
      for (const auto& p : regions) {
        if (!(s.rbeg >= p.rb && s.rend() <= p.re && s.qbeg >= p.qb &&
              s.qend() <= p.qe))
          continue;
        if (s.len - p.seedlen0 > 0.1 * l_query) continue;
        int64_t qd = s.qbeg - p.qb, rd = s.rbeg - p.rb;
        int64_t mg = cal_max_gap(o, std::min(qd, rd));
        int64_t ww = std::min(mg, p.w);
        if (qd - rd < ww && rd - qd < ww) {
          skip = true;
          break;
        }
        qd = l_query - s.qend();
        rd = p.re - s.rend();
        mg = cal_max_gap(o, std::min(qd, rd));
        ww = std::min(mg, p.w);
        if (qd - rd < ww && rd - qd < ww) {
          skip = true;
          break;
        }
      }
      if (skip) continue;

      RegionC a;
      a.w = o.w;
      a.seedlen0 = s.len;
      int64_t aw0 = o.w, aw1 = o.w;
      if (s.qbeg > 0) {
        const TaskC& t = pr.tasks[pr.tidx[ci][k * 2]];
        const ExtRes& res = resolve(o, t, -1, &aw0);
        a.score = res.score;
        if (res.gscore <= 0 || res.gscore <= a.score - o.pen_clip5) {
          a.qb = s.qbeg - res.qle;
          a.rb = s.rbeg - res.tle;
          a.truesc = a.score;
        } else {
          a.qb = 0;
          a.rb = s.rbeg - res.gtle;
          a.truesc = res.gscore;
        }
      } else {
        a.score = a.truesc = s.len * o.a;
        a.qb = 0;
        a.rb = s.rbeg;
      }
      if (s.qend() != l_query) {
        int64_t sc0 = a.score;
        const TaskC& t = pr.tasks[pr.tidx[ci][k * 2 + 1]];
        const ExtRes& res = resolve(o, t, sc0, &aw1);
        a.score = res.score;
        if (res.gscore <= 0 || res.gscore <= a.score - o.pen_clip3) {
          a.qe = s.qend() + res.qle;
          a.re = s.rend() + res.tle;
          a.truesc += a.score - sc0;
        } else {
          a.qe = l_query;
          a.re = s.rend() + res.gtle;  // rmax0 + re_off + gtle
          a.truesc += res.gscore - sc0;
        }
      } else {
        a.qe = l_query;
        a.re = s.rend();
      }
      a.w = std::max(aw0, aw1);
      for (const auto& t : c.seeds)
        if (t.qbeg >= a.qb && t.qend() <= a.qe && t.rbeg >= a.rb &&
            t.rend() <= a.re)
          a.seedcov += t.len;
      regions.push_back(a);
    }
  }
  // sort_and_dedup
  if (regions.size() > 1) {
    std::stable_sort(regions.begin(), regions.end(),
                     [](const RegionC& x, const RegionC& y) {
                       if (x.rb != y.rb) return x.rb < y.rb;
                       if (x.re != y.re) return x.re < y.re;
                       if (x.qb != y.qb) return x.qb < y.qb;
                       if (x.qe != y.qe) return x.qe < y.qe;
                       return x.score > y.score;
                     });
    std::vector<RegionC> out;
    for (const auto& r : regions) {
      bool dup = false;
      for (const auto& q : out) {
        if (q.rb == r.rb && q.qb == r.qb && q.score == r.score) {
          dup = true;
          break;
        }
        int64_t b = std::max(q.rb, r.rb);
        int64_t e = std::min(q.re, r.re);
        if (e > b) {
          int64_t min_l = std::min(q.re - q.rb, r.re - r.rb);
          if (e - b >= min_l * MASK_LEVEL_REDUN && min_l == r.re - r.rb &&
              q.score >= r.score) {
            dup = true;
            break;
          }
        }
      }
      if (!dup) out.push_back(r);
    }
    regions.swap(out);
  }
  std::stable_sort(regions.begin(), regions.end(),
                   [](const RegionC& x, const RegionC& y) {
                     if (x.score != y.score) return x.score > y.score;
                     if (x.rb != y.rb) return x.rb < y.rb;
                     return x.qb < y.qb;
                   });
}

// align.py mark_primary
void mark_primary(const Opt& o, std::vector<RegionC>& regions) {
  if (regions.empty()) return;
  for (auto& r : regions) {
    r.sub = 0;
    r.sub_n = 0;
    r.secondary = -1;
  }
  std::stable_sort(regions.begin(), regions.end(),
                   [](const RegionC& x, const RegionC& y) {
                     if (x.score != y.score) return x.score > y.score;
                     if (x.qb != y.qb) return x.qb < y.qb;
                     return x.rb < y.rb;
                   });
  int64_t tmp = std::max(std::max(o.a + o.b, o.o_del + o.e_del),
                         o.o_ins + o.e_ins);
  std::vector<int64_t> kept;
  for (size_t i = 0; i < regions.size(); ++i) {
    RegionC& p = regions[i];
    bool placed = false;
    for (int64_t k : kept) {
      RegionC& q = regions[k];
      int64_t b_max = std::max(q.qb, p.qb);
      int64_t e_min = std::min(q.qe, p.qe);
      if (e_min > b_max) {
        int64_t min_l = std::min(p.qe - p.qb, q.qe - q.qb);
        if (e_min - b_max >= min_l * o.mask_level) {
          if (q.sub == 0) q.sub = p.score;
          if (q.score - p.score <= tmp) q.sub_n += 1;
          p.secondary = k;
          placed = true;
          break;
        }
      }
    }
    if (!placed) kept.push_back((int64_t)i);
  }
}

// align.py approx_mapq_se
int64_t approx_mapq_se(const Opt& o, const RegionC& a) {
  int64_t sub = a.sub ? a.sub : o.min_seed_len * o.a;
  sub = std::max(a.csub, sub);
  if (sub >= a.score) return 0;
  int64_t l = std::max(a.qe - a.qb, a.re - a.rb);
  double identity =
      1.0 - (double)(l * o.a - a.score) / (o.a + o.b) / (double)l;
  int64_t mapq;
  if (a.score == 0) {
    mapq = 0;
  } else if (o.mapq_coef_len > 0) {
    double tmp =
        l < o.mapq_coef_len ? 1.0 : o.mapq_coef_fac / std::log((double)l);
    tmp *= identity * identity;
    mapq = (int64_t)(6.02 * (a.score - sub) / o.a * tmp * tmp + 0.499);
  } else {
    mapq = (int64_t)(30.0 * (1.0 - (double)sub / a.score) *
                         std::log((double)a.seedcov) +
                     0.499);
  }
  if (a.sub_n > 0)
    mapq -= (int64_t)(4.343 * std::log((double)a.sub_n + 1) + 0.499);
  return std::max((int64_t)0, std::min(mapq, (int64_t)60));
}

// cigar.py infer_bw
int64_t infer_bw(int64_t l1, int64_t l2, int64_t score, int64_t a, int64_t q,
                 int64_t r) {
  if (l1 == l2 && l1 * a - score < (q + r - a) * 2) return 0;
  int64_t w = (int64_t)((std::min(l1, l2) * a - score - q) / (double)r + 2.0);
  return std::max(w, l1 > l2 ? l1 - l2 : l2 - l1);
}

void cigar_to_string(const std::vector<std::pair<int32_t, int32_t>>& cig,
                     std::string& out) {
  static const char OPS[] = "MIDSH";
  out.clear();
  if (cig.empty()) {
    out = "*";
    return;
  }
  char buf[16];
  for (const auto& p : cig) {
    int n = snprintf(buf, sizeof buf, "%d%c", p.second, OPS[p.first]);
    out.append(buf, n);
  }
}

// mem_reg2aln's segment + band-width setup (align.py _gen_cigar_setup),
// shared by the host reg2aln path and the device-CIGAR task collector.
// Returns false for the no-gap fast path (equal spans, w2 == 0).
bool gen_cigar_setup(const MemPipe& mp, int64_t ri, const RegionC& ar,
                     std::vector<uint8_t>& qseg,
                     std::vector<uint8_t>& rseg, int64_t* w2_out) {
  const Opt& o = mp.opt;
  const uint8_t* read = mp.reads + ri * mp.L;
  int64_t qb = ar.qb, qe = ar.qe, rb = ar.rb, re = ar.re;
  int64_t w2 =
      std::max(infer_bw(qe - qb, re - rb, ar.truesc, o.a, o.o_del, o.e_del),
               infer_bw(qe - qb, re - rb, ar.truesc, o.a, o.o_ins, o.e_ins));
  if (w2 > o.w) w2 = std::min(w2, ar.w);
  qseg.assign(read + qb, read + qe);
  rseg.clear();
  get_seq(mp, rb, re, rseg);
  if (rb >= mp.l_pac) {
    std::reverse(qseg.begin(), qseg.end());
    std::reverse(rseg.begin(), rseg.end());
  }
  *w2_out = w2;
  return !(qe - qb == re - rb && w2 == 0);
}

// align.py reg2aln (single-end; mate handling stays in Python for PE).
// `pre` short-circuits the banded-global retry loop with a result the
// mp_cigar_* device rounds computed (which replay the identical
// band-doubling schedule) — align.py reg2aln's global_result.
RecordC reg2aln(const MemPipe& mp, int64_t ri, const RegionC& ar,
                const GlobalResC* pre = nullptr) {
  const Opt& o = mp.opt;
  int64_t l_query = mp.qlen[ri];
  RecordC a;
  if (ar.rb < 0 || ar.re < 0) {
    a.flag |= 0x4;
    return a;
  }
  int64_t qb = ar.qb, qe = ar.qe, rb = ar.rb, re = ar.re;
  a.mapq = ar.secondary < 0 ? approx_mapq_se(o, ar) : 0;
  if (ar.secondary >= 0) a.flag |= 0x100;
  std::vector<uint8_t> qseg, rseg;
  int64_t w2;
  bool need_global = gen_cigar_setup(mp, ri, ar, qseg, rseg, &w2);
  std::vector<std::pair<int32_t, int32_t>> cigar;
  int64_t score;
  if (!need_global) {
    score = 0;
    for (size_t i = 0; i < qseg.size(); ++i)
      score += mp.mat[rseg[i] * 5 + qseg[i]];
    cigar.push_back({0, (int32_t)(qe - qb)});
  } else if (pre) {
    score = pre->score;
    cigar = pre->cigar;
  } else {
    int64_t last_sc = -((int64_t)1 << 30);
    int64_t i = 0;
    std::vector<int32_t> cbuf(2 * (qseg.size() + rseg.size() + 2));
    for (;;) {
      w2 = std::min(w2, o.w << 2);
      int64_t nc = 0;
      if (qseg.empty()) {
        score = rseg.empty() ? 0 : -(o.o_del + o.e_del * (int64_t)rseg.size());
        if (!rseg.empty()) {
          cbuf[0] = 2;
          cbuf[1] = (int32_t)rseg.size();
          nc = 1;
        }
      } else if (rseg.empty()) {
        score = -(o.o_ins + o.e_ins * (int64_t)qseg.size());
        cbuf[0] = 1;
        cbuf[1] = (int32_t)qseg.size();
        nc = 1;
      } else {
        nc = bwamem_ksw_global(qseg.data(), qseg.size(), rseg.data(),
                               rseg.size(), mp.mat, 5, o.o_del, o.e_del,
                               o.o_ins, o.e_ins, w2, cbuf.data(),
                               (int64_t)(qseg.size() + rseg.size() + 2),
                               &score);
      }
      cigar.clear();
      for (int64_t c = 0; c < nc; ++c)
        cigar.push_back({cbuf[2 * c], cbuf[2 * c + 1]});
      if (score == last_sc || w2 == (o.w << 2)) break;
      last_sc = score;
      w2 <<= 1;
      i += 1;
      if (!(i < 3 && score < ar.truesc - o.a)) break;
    }
  }
  {  // NM / MD
    std::vector<int32_t> flat(2 * cigar.size());
    for (size_t c = 0; c < cigar.size(); ++c) {
      flat[2 * c] = cigar[c].first;
      flat[2 * c + 1] = cigar[c].second;
    }
    std::vector<char> md(16 + 5 * (qseg.size() + rseg.size()));
    int64_t nm = 0;
    int64_t ln = bwamem_cigar_nm_md(qseg.data(), rseg.data(), flat.data(),
                                    (int64_t)cigar.size(), md.data(),
                                    (int64_t)md.size(), &nm);
    a.nm = nm;
    a.md.assign(md.data(), ln > 0 ? ln : 0);
  }
  int64_t pos2;
  if (rb < mp.l_pac) {
    pos2 = rb;
    a.is_rev = false;
  } else {
    pos2 = (mp.l_pac << 1) - 1 - (re - 1);
    a.is_rev = true;
  }
  if (a.is_rev) a.flag |= 0x10;
  // leading OR trailing deletion (bwa mem_reg2aln's else-if: a rare
  // band-forced [D, ..., D] keeps its trailing D)
  if (!cigar.empty() && cigar.front().first == 2) {
    pos2 += cigar.front().second;
    cigar.erase(cigar.begin());
  } else if (!cigar.empty() && cigar.back().first == 2) {
    cigar.pop_back();
  }
  if (qb != 0 || qe != l_query) {
    int64_t clip5 = a.is_rev ? l_query - qe : qb;
    int64_t clip3 = a.is_rev ? qb : l_query - qe;
    if (clip5) cigar.insert(cigar.begin(), {3, (int32_t)clip5});
    if (clip3) cigar.push_back({3, (int32_t)clip3});
  }
  int64_t span = 0;
  for (const auto& p : cigar)
    if (p.first == 0 || p.first == 2) span += p.second;
  a.ref_span = span;
  a.rid = pos2rid(mp, pos2);
  if (a.rid < 0 || (span > 0 && pos2rid(mp, pos2 + span - 1) != a.rid)) {
    a.rid = -1;
    a.flag |= 0x4;
    a.cigar = "*";
    return a;
  }
  a.pos = pos2 - mp.ctg_off[a.rid];
  a.score = ar.score;
  a.sub = std::max(ar.sub, ar.csub);
  cigar_to_string(cigar, a.cigar);
  return a;
}

// lookup helper for the device-CIGAR result table (null when the
// host path computed no device rounds or this region wasn't a task)
inline const GlobalResC* cig_lookup(const MemPipe& mp, int64_t ri,
                                    int64_t ki) {
  if (mp.cig_results.empty()) return nullptr;
  auto it = mp.cig_results.find(ri * mp.cig_stride + ki);
  return it == mp.cig_results.end() ? nullptr : &it->second;
}

// align.py xa_string
void xa_string(const MemPipe& mp, int64_t ri,
               const std::vector<RegionC>& regions, std::string& out) {
  out.clear();
  std::vector<int64_t> alts;
  for (size_t k = 0; k < regions.size(); ++k)
    if (regions[k].secondary == 0 && regions[k].score >= mp.opt.T)
      alts.push_back((int64_t)k);
  if (alts.empty() || (int64_t)alts.size() > mp.opt.max_xa_hits) return;
  char buf[64];
  for (int64_t k : alts) {
    const RegionC* p = &regions[k];
    RecordC q = reg2aln(mp, ri, *p, cig_lookup(mp, ri, k));
    if (q.rid < 0) continue;
    out += mp.ctg_name[q.rid];
    int n = snprintf(buf, sizeof buf, ",%c%lld,", q.is_rev ? '-' : '+',
                     (long long)(q.pos + 1));
    out.append(buf, n);
    out += q.cigar;
    n = snprintf(buf, sizeof buf, ",%lld;", (long long)q.nm);
    out.append(buf, n);
  }
}

// align.py align_read record loop + aln2sam flag/tag logic (SE);
// records half — regions must already be replayed + primary-marked
void finalize_records(const MemPipe& mp, int64_t ri, PerRead& pr) {
  const Opt& o = mp.opt;
  std::vector<RecordC> alns;
  for (size_t ki = 0; ki < pr.regions.size(); ++ki) {
    const RegionC& p = pr.regions[ki];
    if (p.score < o.T) continue;
    if (p.secondary >= 0 && !o.flag_a) continue;
    RecordC q = reg2aln(mp, ri, p, cig_lookup(mp, ri, (int64_t)ki));
    if (p.secondary >= 0) q.sub = -1;
    if (!alns.empty() && p.secondary < 0)
      q.flag |= o.flag_M ? 0x100 : 0x800;
    if (!alns.empty() && q.mapq > alns[0].mapq) q.mapq = alns[0].mapq;
    alns.push_back(std::move(q));
  }
  // SA:Z (bwa mem_aln2sam, 0.7.6+): every non-secondary record of a
  // split read lists the OTHER non-secondary hits as
  // "rname,pos,strand,cigar,mapq,NM;" (cigar in soft-clip form — the
  // hard-clip transform happens only at line rendering)
  {
    std::vector<char> is_sec(alns.size());
    int64_t n_good = 0;
    {
      size_t ai = 0;
      for (size_t ki = 0; ki < pr.regions.size() && ai < alns.size();
           ++ki) {
        const RegionC& p = pr.regions[ki];
        if (p.score < o.T) continue;
        if (p.secondary >= 0 && !o.flag_a) continue;
        is_sec[ai++] = p.secondary >= 0 ? 1 : 0;
      }
    }
    for (size_t j = 0; j < alns.size(); ++j)
      if (!is_sec[j] && alns[j].rid >= 0 && !alns[j].cigar.empty() &&
          !(alns[j].flag & 0x4))
        ++n_good;
    if (n_good > 1) {
      char buf[64];
      for (size_t i = 0; i < alns.size(); ++i) {
        if (is_sec[i] || alns[i].rid < 0) continue;
        std::string sa;
        for (size_t j = 0; j < alns.size(); ++j) {
          if (j == i || is_sec[j] || alns[j].rid < 0 ||
              alns[j].cigar.empty() || (alns[j].flag & 0x4))
            continue;
          const RecordC& q = alns[j];
          sa += mp.ctg_name[q.rid];
          int n = snprintf(buf, sizeof buf, ",%lld,%c,",
                           (long long)(q.pos + 1),
                           q.is_rev ? '-' : '+');
          sa.append(buf, n);
          sa += q.cigar;
          n = snprintf(buf, sizeof buf, ",%lld,%lld;",
                       (long long)q.mapq, (long long)q.nm);
          sa.append(buf, n);
        }
        alns[i].sa = std::move(sa);
      }
    }
  }
  if (alns.empty()) {
    RecordC rec;
    rec.flag = 0x4;
    rec.cigar = "*";
    rec.src_read = ri;
    pr.records.push_back(std::move(rec));
    return;
  }
  for (auto& a : alns) {
    // aln2sam: -M remaps supplementary to secondary; unmapped strips
    int64_t flag = a.flag;
    if (o.flag_M && (flag & 0x800)) flag = (flag & ~0x800) | 0x100;
    if (a.rid < 0 || (flag & 0x4)) {
      flag = (flag | 0x4) & ~(0x10 | 0x100 | 0x800);
      RecordC rec;
      rec.flag = flag;
      rec.cigar = "*";
      rec.src_read = ri;
      pr.records.push_back(std::move(rec));
      continue;
    }
    a.flag = flag;
    a.src_read = ri;
    pr.records.push_back(std::move(a));
  }
  if (!o.flag_a) {
    std::string xa;
    xa_string(mp, ri, pr.regions, xa);
    if (!xa.empty()) pr.records[0].xa = std::move(xa);
  }
}

void finalize_read(const MemPipe& mp, int64_t ri, PerRead& pr) {
  replay_read(mp, ri, pr);
  mark_primary(mp.opt, pr.regions);
  finalize_records(mp, ri, pr);
}

// ---- paired-end machinery (pipeline/pair.py port) ----

constexpr int64_t MIN_DIR_CNT = 10;
constexpr double MIN_DIR_RATIO = 0.05;
constexpr double OUTLIER_BOUND = 2.0;
constexpr double MAPPING_BOUND = 3.0;
constexpr double MAX_STDDEV = 4.0;
constexpr double MIN_RATIO = 0.8;

// pair.py _infer_dir (bwa mem_infer_dir)
inline int infer_dir(int64_t l_pac, int64_t b1, int64_t b2,
                     int64_t* dist) {
  int r1 = b1 >= l_pac ? 1 : 0;
  int r2 = b2 >= l_pac ? 1 : 0;
  int64_t p2 = r1 == r2 ? b2 : (l_pac << 1) - 1 - b2;
  *dist = p2 > b1 ? p2 - b1 : b1 - p2;
  return (r1 == r2 ? 0 : 1) ^ (p2 > b1 ? 0 : 3);
}

// pair.py cal_sub (regs score-sorted)
int64_t cal_sub(const Opt& o, const std::vector<RegionC>& regs) {
  for (size_t j = 1; j < regs.size(); ++j) {
    int64_t b_max = std::max(regs[j].qb, regs[0].qb);
    int64_t e_min = std::min(regs[j].qe, regs[0].qe);
    if (e_min > b_max) {
      int64_t min_l =
          std::min(regs[j].qe - regs[j].qb, regs[0].qe - regs[0].qb);
      if (e_min - b_max >= min_l * o.mask_level) return regs[j].score;
    }
  }
  return o.min_seed_len * o.a;
}

// -I / mem_pestat dispatch: an explicit FR distribution (bwa -I)
// skips inference; std defaults to 10% of the mean, high/low to
// mean +- 4 sigma (+.499, low clamped to 1), FF/RF/RR stay failed.
void compute_pes(const MemPipe& mp, int64_t n_pairs, PEStatC pes[4]);

// pair.py infer_isize (bwa mem_pestat) over the chunk's pairs
void infer_isize(const MemPipe& mp, int64_t n_pairs, PEStatC pes[4]) {
  const Opt& o = mp.opt;
  std::vector<int64_t> isize[4];
  for (int64_t i = 0; i < n_pairs; ++i) {
    const auto& r1 = mp.per[i].regions;
    const auto& r2 = mp.per[n_pairs + i].regions;
    if (r1.empty() || r2.empty()) continue;
    if (cal_sub(o, r1) > MIN_RATIO * r1[0].score) continue;
    if (cal_sub(o, r2) > MIN_RATIO * r2[0].score) continue;
    int64_t dist;
    int d = infer_dir(mp.l_pac, r1[0].rb, r2[0].rb, &dist);
    if (dist > 0 && dist <= o.max_ins) isize[d].push_back(dist);
  }
  for (int d = 0; d < 4; ++d) {
    std::vector<int64_t>& v = isize[d];
    std::sort(v.begin(), v.end());
    PEStatC st;
    if ((int64_t)v.size() < MIN_DIR_CNT) {
      pes[d] = st;
      continue;
    }
    int64_t nv = (int64_t)v.size();
    int64_t p25 = v[(int64_t)(0.25 * nv + 0.499)];
    int64_t p75 = v[(int64_t)(0.75 * nv + 0.499)];
    st.low = (int64_t)(p25 - OUTLIER_BOUND * (p75 - p25) + 0.499);
    st.high = (int64_t)(p75 + OUTLIER_BOUND * (p75 - p25) + 0.499);
    st.low = std::max(st.low, (int64_t)1);
    double sum = 0;
    int64_t cnt = 0;
    for (int64_t x : v)
      if (x >= st.low && x <= st.high) {
        sum += (double)x;
        ++cnt;
      }
    if (!cnt) {
      pes[d] = st;
      continue;
    }
    st.avg = sum / cnt;
    double var = 0;
    for (int64_t x : v)
      if (x >= st.low && x <= st.high)
        var += ((double)x - st.avg) * ((double)x - st.avg);
    st.std = std::sqrt(var / cnt);
    if (st.std == 0.0) st.std = 1.0;  // python `or 1.0`
    st.low = (int64_t)(p25 - MAPPING_BOUND * (p75 - p25) + 0.499);
    st.high = (int64_t)(p75 + MAPPING_BOUND * (p75 - p25) + 0.499);
    st.low =
        std::min(st.low, (int64_t)(st.avg - MAX_STDDEV * st.std + 0.499));
    st.high =
        std::max(st.high, (int64_t)(st.avg + MAX_STDDEV * st.std + 0.499));
    st.low = std::max(st.low, (int64_t)1);
    st.failed = false;
    pes[d] = st;
  }
  int64_t cmax = 0;
  for (int d = 0; d < 4; ++d)
    cmax = std::max(cmax, (int64_t)isize[d].size());
  for (int d = 0; d < 4; ++d)
    if (!pes[d].failed && (int64_t)isize[d].size() < cmax * MIN_DIR_RATIO)
      pes[d].failed = true;
}

void compute_pes(const MemPipe& mp, int64_t n_pairs, PEStatC pes[4]) {
  const Opt& o = mp.opt;
  if (o.pe_mean <= 0) {
    infer_isize(mp, n_pairs, pes);
    return;
  }
  for (int d = 0; d < 4; ++d) pes[d] = PEStatC();
  double mean = o.pe_mean;
  double std = o.pe_std > 0 ? o.pe_std : mean * 0.1;
  pes[1].failed = false;
  pes[1].avg = mean;
  pes[1].std = std;
  pes[1].high = o.pe_max > 0 ? (int64_t)o.pe_max
                             : (int64_t)(mean + 4.0 * std + 0.499);
  pes[1].low = o.pe_min > 0 ? (int64_t)o.pe_min
                            : (int64_t)(mean - 4.0 * std + 0.499);
  if (pes[1].low < 1) pes[1].low = 1;
}

// pair.py mem_pair: returns (score, sub, n_sub, z found?)
bool mem_pair(const Opt& o, int64_t l_pac, const PEStatC pes[4],
              const std::vector<RegionC>& a0,
              const std::vector<RegionC>& a1, int64_t* score,
              int64_t* sub, int64_t* n_sub, int64_t z[2]) {
  struct Cand {
    int64_t q, i1, i2;
    bool operator<(const Cand& b) const {
      if (q != b.q) return q < b.q;
      if (i1 != b.i1) return i1 < b.i1;
      return i2 < b.i2;
    }
  };
  std::vector<Cand> cands;
  for (size_t i1 = 0; i1 < a0.size(); ++i1)
    for (size_t i2 = 0; i2 < a1.size(); ++i2) {
      int64_t dist;
      int d = infer_dir(l_pac, a0[i1].rb, a1[i2].rb, &dist);
      if (pes[d].failed || dist < pes[d].low || dist > pes[d].high)
        continue;
      double ns = ((double)dist - pes[d].avg) / pes[d].std;
      int64_t q =
          a0[i1].score + a1[i2].score +
          (int64_t)(0.721 * std::log(2.0 * std::erfc(std::fabs(ns) *
                                                     (1.0 / std::sqrt(2.0)))) *
                        o.a +
                    0.499);
      if (q < 0) q = 0;
      cands.push_back({q, (int64_t)i1, (int64_t)i2});
    }
  if (cands.empty()) {
    *score = 0;
    *sub = 0;
    *n_sub = 0;
    return false;
  }
  std::sort(cands.begin(), cands.end());
  const Cand& best = cands.back();
  *score = best.q;
  *sub = cands.size() > 1 ? cands[cands.size() - 2].q : 0;
  int64_t tmp = std::max(std::max(o.a + o.b, o.o_del + o.e_del),
                         o.o_ins + o.e_ins);
  int64_t ns_ = 0;
  for (size_t k = 0; k + 1 < cands.size(); ++k)
    if (cands[k].q >= best.q - tmp) ++ns_;
  *n_sub = ns_;
  z[0] = best.i1;
  z[1] = best.i2;
  return true;
}

extern "C" void bwamem_ksw_align(const uint8_t*, int64_t, const uint8_t*,
                                 int64_t, const int8_t*, int64_t, int64_t,
                                 int64_t, int64_t, int64_t, int64_t*);

// pair.py mem_matesw, split in two so the SW itself can run either on
// host (bwamem_ksw_align, the default) or batched on the accelerator
// (the mp_rescue_* wave protocol): emit computes the skip test + the
// rescue windows and materializes the oriented mate / reference-window
// sequences; apply runs the score filter + coordinate transform on a
// (score,qb,qe,tb,te,score2) result and appends the rescued region.
int matesw_emit(const MemPipe& mp, const PEStatC pes[4],
                const RegionC& anchor, const uint8_t* mate_read,
                int64_t l_ms, const std::vector<RegionC>& mate_regs,
                int64_t mate_ri,
                std::vector<MemPipe::RescueTask>& out) {
  int64_t l_pac = mp.l_pac;
  bool skip[4];
  for (int r = 0; r < 4; ++r) skip[r] = pes[r].failed;
  for (const auto& m : mate_regs) {
    int64_t dist;
    int r = infer_dir(l_pac, anchor.rb, m.rb, &dist);
    if (!pes[r].failed && dist >= pes[r].low && dist <= pes[r].high)
      skip[r] = true;
  }
  if (skip[0] && skip[1] && skip[2] && skip[3]) return 0;
  int n = 0;
  for (int r = 0; r < 4; ++r) {
    if (skip[r]) continue;
    bool is_rev = ((r >> 1) ^ (r & 1)) != 0;
    bool is_larger = !(r >> 1);
    int64_t rb, re;
    if (!is_rev) {
      rb = is_larger ? anchor.rb + pes[r].low : anchor.rb - pes[r].high;
      re = (is_larger ? anchor.rb + pes[r].high
                      : anchor.rb - pes[r].low) +
           l_ms;
    } else {
      rb = (is_larger ? anchor.rb + pes[r].low
                      : anchor.rb - pes[r].high) -
           l_ms;
      re = is_larger ? anchor.rb + pes[r].high : anchor.rb - pes[r].low;
    }
    rb = std::max(rb, (int64_t)0);
    re = std::min(re, l_pac << 1);
    if (rb < l_pac && l_pac < re) {
      if (anchor.rb < l_pac)
        re = l_pac;
      else
        rb = l_pac;
    }
    if (rb >= re) continue;
    MemPipe::RescueTask t;
    t.mate_read = mate_ri;
    t.rb = rb;
    t.l_ms = l_ms;
    t.is_rev = is_rev;
    t.seq.assign(mate_read, mate_read + l_ms);
    if (is_rev) {
      std::reverse(t.seq.begin(), t.seq.end());
      for (auto& c : t.seq)
        if (c < 4) c = 3 - c;
    }
    get_seq(mp, rb, re, t.rseq);
    out.push_back(std::move(t));
    ++n;
  }
  return n;
}

bool matesw_apply(const MemPipe& mp, const MemPipe::RescueTask& t,
                  const int64_t out6[6],
                  std::vector<RegionC>& mate_regs) {
  const Opt& o = mp.opt;
  int64_t l_pac = mp.l_pac;
  int64_t score = out6[0], qb = out6[1], qe = out6[2], tb = out6[3],
          te = out6[4], score2 = out6[5];
  if (score < o.min_seed_len * o.a || qb < 0) return false;
  RegionC b;
  if (t.is_rev) {
    b.qb = t.l_ms - qe;
    b.qe = t.l_ms - qb;
    b.rb = (l_pac << 1) - (t.rb + te);
    b.re = (l_pac << 1) - (t.rb + tb);
  } else {
    b.qb = qb;
    b.qe = qe;
    b.rb = t.rb + tb;
    b.re = t.rb + te;
  }
  b.score = b.truesc = score;
  b.csub = score2;
  b.secondary = -1;
  b.w = o.w;
  b.seedcov = std::min(b.re - b.rb, b.qe - b.qb) >> 1;
  mate_regs.push_back(b);
  return true;
}

// host-SW composition of the two halves (the default rescue path)
int mem_matesw(const MemPipe& mp, const PEStatC pes[4],
               const RegionC& anchor, const uint8_t* mate_read,
               int64_t l_ms, std::vector<RegionC>& mate_regs) {
  const Opt& o = mp.opt;
  std::vector<MemPipe::RescueTask> tasks;
  matesw_emit(mp, pes, anchor, mate_read, l_ms, mate_regs, -1, tasks);
  int n = 0;
  for (const auto& t : tasks) {
    int64_t out6[6];
    bwamem_ksw_align(t.seq.data(), t.l_ms, t.rseq.data(),
                     (int64_t)t.rseq.size(), mp.mat, 5, o.o_del, o.e_del,
                     o.o_ins, o.e_ins, out6);
    if (matesw_apply(mp, t, out6, mate_regs)) ++n;
  }
  return n;
}

// pair.py rescue_pairs.  BOTH ends' anchor lists snapshot BEFORE any
// matesw runs — bwa-0.7.8's up-front b[0]/b[1] kv_push loops in
// mem_sam_pe: a region rescued by end 0 never becomes an end-1 anchor
// within the same pair.
void rescue_pairs(MemPipe& mp, const PEStatC pes[4], int64_t n_pairs,
                  int64_t i) {
  const Opt& o = mp.opt;
  std::vector<RegionC> anchors2[2];
  for (int e = 0; e < 2; ++e) {
    auto& regs_i = mp.per[e == 0 ? i : n_pairs + i].regions;
    if (regs_i.empty()) continue;
    int64_t best = regs_i[0].score;
    for (const auto& r : regs_i) best = std::max(best, r.score);
    for (const auto& r : regs_i)
      if (r.score >= best - o.pen_unpaired) anchors2[e].push_back(r);
    if ((int64_t)anchors2[e].size() > o.max_matesw)
      anchors2[e].resize((size_t)o.max_matesw);
  }
  for (int e = 0; e < 2; ++e) {
    int64_t other_read = e == 0 ? n_pairs + i : i;
    const uint8_t* mate = mp.reads + other_read * mp.L;
    int64_t l_ms = mp.qlen[other_read];
    auto& mate_regs = mp.per[other_read].regions;
    for (const auto& a : anchors2[e])
      mem_matesw(mp, pes, a, mate, l_ms, mate_regs);
  }
}

// align.py aln2sam with a mate (PE flag/field logic); fills the PE
// fields on `a` in place.
RecordC aln2sam_pe(const MemPipe& mp, RecordC a, const RecordC& mate,
                   int which) {
  const Opt& o = mp.opt;
  int64_t flag = a.flag;
  if (o.flag_M && (flag & 0x800)) flag = (flag & ~0x800) | 0x100;
  flag |= 0x1 | (which == 0 ? 0x40 : 0x80);
  if (mate.rid < 0 || (mate.flag & 0x4))
    flag |= 0x8;
  else if (mate.is_rev)
    flag |= 0x20;
  if (a.rid < 0 || (flag & 0x4)) {
    RecordC rec;
    rec.flag = (flag | 0x4) & ~(0x10 | 0x100 | 0x800);
    rec.cigar = "*";
    rec.rid = -1;
    if (mate.rid >= 0 && !(mate.flag & 0x4)) {
      rec.mate_rid = mate.rid;
      rec.pnext0 = mate.pos;
      if (mate.is_rev) rec.flag |= 0x20;
    } else {
      rec.mate_rid = -1;  // mate also unmapped: bare unmapped record
    }
    return rec;
  }
  a.flag = flag;
  if (mate.rid >= 0 && !(mate.flag & 0x4)) {
    a.mate_rid = mate.rid;
    a.pnext0 = mate.pos;
    if (mate.rid == a.rid && !mate.cigar.empty() && mate.cigar != "*" &&
        !a.cigar.empty() && a.cigar != "*") {
      int64_t p0 = a.pos + (a.is_rev ? a.ref_span - 1 : 0);
      int64_t p1 = mate.pos + (mate.is_rev ? mate.ref_span - 1 : 0);
      int64_t sign = p0 > p1 ? 1 : (p0 < p1 ? -1 : 0);
      a.tlen = -(p0 - p1 + sign);
    }
  } else {
    // mate unmapped: placed at this read's coordinates
    a.mate_rid = a.rid;
    a.pnext0 = a.pos;
  }
  return a;
}

// pair.py sam_pe for pair i; appends all records to per[i].records.
void sam_pe(MemPipe& mp, int64_t n_pairs, int64_t i,
            const PEStatC pes[4]) {
  const Opt& o = mp.opt;
  int64_t reads_idx[2] = {i, n_pairs + i};
  std::vector<RegionC> regs[2] = {mp.per[i].regions,
                                  mp.per[n_pairs + i].regions};
  mark_primary(o, regs[0]);
  mark_primary(o, regs[1]);
  int64_t extra_flag = 1;
  int64_t z[2] = {-1, -1};
  int64_t q_se[2] = {-1, -1};

  bool paired_branch = false;
  // -P / MEM_F_NOPAIRING: bwa's `goto no_pairing` — fall straight
  // through to the independent-ends branch (rescue already ran unless
  // -S disabled it)
  if (!o.skip_pairing && !regs[0].empty() && !regs[1].empty()) {
    int64_t score, sub, n_sub, zz[2];
    bool found = mem_pair(o, mp.l_pac, pes, regs[0], regs[1], &score,
                          &sub, &n_sub, zz);
    if (found && score > 0) {
      bool multi = false;
      for (int e = 0; e < 2 && !multi; ++e)
        for (size_t k = 1; k < regs[e].size(); ++k)
          if (regs[e][k].secondary < 0 && regs[e][k].score >= o.T) {
            multi = true;
            break;
          }
      if (!multi) {
        int64_t score_un =
            regs[0][0].score + regs[1][0].score - o.pen_unpaired;
        sub = std::max(sub, score_un);
        int64_t q_pe = (int64_t)(6.02 * (score - sub) / o.a + 0.499);
        if (n_sub > 0)
          q_pe -= (int64_t)(4.343 * std::log((double)n_sub + 1) + 0.499);
        q_pe = std::max((int64_t)0, std::min(q_pe, (int64_t)60));
        if (score > score_un) {  // paired alignment preferred
          for (int e = 0; e < 2; ++e) {
            RegionC& c = regs[e][zz[e]];
            if (c.secondary >= 0) {
              c.sub = regs[e][c.secondary].score;
              c.secondary = -2;
            }
            int64_t q = approx_mapq_se(o, c);
            q = std::max(q, std::min(q_pe, q + 40));
            q = std::min(q, (int64_t)(6.02 * (c.score - c.csub) / o.a +
                                      0.499));
            q_se[e] = q;
            z[e] = zz[e];
          }
          extra_flag |= 2;
          paired_branch = true;
        } else {
          z[0] = 0;
          z[1] = 0;
          q_se[0] = approx_mapq_se(o, regs[0][0]);
          q_se[1] = approx_mapq_se(o, regs[1][0]);
          paired_branch = true;
        }
      }
    }
  }
  if (!paired_branch) {
    // no pairing: ends independent; flag a coincidental proper pair
    for (int e = 0; e < 2; ++e)
      if (!regs[e].empty() && regs[e][0].score >= o.T &&
          regs[e][0].secondary < 0)
        z[e] = 0;
    if (z[0] >= 0 && z[1] >= 0) {
      int64_t dist;
      int d = infer_dir(mp.l_pac, regs[0][0].rb, regs[1][0].rb, &dist);
      if (!pes[d].failed && pes[d].low <= dist && dist <= pes[d].high)
        extra_flag |= 2;
    }
    q_se[0] = q_se[1] = -1;
  }

  RecordC h[2];
  for (int e = 0; e < 2; ++e) {
    if (z[e] >= 0) {
      // mark_primary mutates only fields on the local copies, never
      // the order, so the copy index z[e] keys the device-CIGAR
      // result table built from the original region lists
      h[e] = reg2aln(mp, reads_idx[e], regs[e][z[e]],
                     cig_lookup(mp, reads_idx[e], z[e]));
      if (q_se[e] >= 0) h[e].mapq = q_se[e];
    } else {
      h[e] = RecordC();
      h[e].flag = 0x4;
      h[e].cigar = "*";
    }
    h[e].flag |= extra_flag;
  }
  auto& out = mp.per[i].records;
  for (int e = 0; e < 2; ++e) {
    RecordC rec = aln2sam_pe(mp, h[e], h[1 - e], e);
    rec.src_read = reads_idx[e];
    out.push_back(std::move(rec));
  }
  if (o.flag_a) {
    for (int e = 0; e < 2; ++e) {
      for (size_t k = 0; k < regs[e].size(); ++k) {
        if ((int64_t)k == z[e]) continue;
        const RegionC& p = regs[e][k];
        if (p.secondary < 0 || p.score < o.T) continue;
        RecordC q = reg2aln(mp, reads_idx[e], p,
                            cig_lookup(mp, reads_idx[e], (int64_t)k));
        q.sub = -1;
        q.flag |= 0x100;
        RecordC rec = aln2sam_pe(mp, q, h[1 - e], e);
        rec.src_read = reads_idx[e];
        out.push_back(std::move(rec));
      }
    }
  }
}

}  // namespace

// ======================= C API =======================

extern "C" {

void* mp_new(const int64_t* opt_i, const double* opt_d, const int8_t* mat,
             const uint8_t* pac, int64_t l_pac, const int64_t* ctg_off,
             const int64_t* ctg_len, int64_t n_ctg, const char* names_blob,
             const int64_t* C, int64_t primary, int64_t n_rows,
             const int32_t* occ_rows, const uint32_t* pk_rows,
             const uint32_t* va_rows, const int64_t* ssa, int64_t n_ssa,
             int64_t sa_intv) {
  MemPipe* mp = new MemPipe();
  Opt& o = mp->opt;
  o.a = opt_i[0];
  o.b = opt_i[1];
  o.o_del = opt_i[2];
  o.e_del = opt_i[3];
  o.o_ins = opt_i[4];
  o.e_ins = opt_i[5];
  o.w = opt_i[6];
  o.zdrop = opt_i[7];
  o.pen_clip5 = opt_i[8];
  o.pen_clip3 = opt_i[9];
  o.min_seed_len = opt_i[10];
  o.split_width = opt_i[11];
  o.max_occ = opt_i[12];
  o.max_chain_gap = opt_i[13];
  o.T = opt_i[14];
  o.flag_M = opt_i[15];
  o.flag_a = opt_i[16];
  o.max_xa_hits = opt_i[17];
  o.pen_unpaired = opt_i[18];
  o.max_matesw = opt_i[19];
  o.max_ins = opt_i[20];
  o.skip_pairing = opt_i[21];
  o.split_factor = opt_d[0];
  o.drop_ratio = opt_d[1];
  o.mask_level = opt_d[2];
  o.pe_mean = opt_d[5];
  o.pe_std = opt_d[6];
  o.pe_max = opt_d[7];
  o.pe_min = opt_d[8];
  o.mapq_coef_len = opt_d[3];
  o.mapq_coef_fac = opt_d[4];
  std::memcpy(mp->mat, mat, 25);
  mp->pac = pac;
  mp->l_pac = l_pac;
  mp->ctg_off.assign(ctg_off, ctg_off + n_ctg);
  mp->ctg_len.assign(ctg_len, ctg_len + n_ctg);
  const char* p = names_blob;
  for (int64_t i = 0; i < n_ctg; ++i) {
    mp->ctg_name.push_back(std::string(p));
    p += mp->ctg_name.back().size() + 1;
  }
  mp->C = C;
  mp->primary = primary;
  mp->n_rows = n_rows;
  mp->occ_rows = occ_rows;
  mp->pk_rows = pk_rows;
  mp->va_rows = va_rows;
  mp->ssa = ssa;
  mp->n_ssa = n_ssa;
  mp->sa_intv = sa_intv;
  return mp;
}

void mp_free(void* h) { delete static_cast<MemPipe*>(h); }

namespace {

// Chunk-header setup shared by the host-seeded and externally-seeded
// entry points.
void chunk_init(MemPipe& mp, const uint8_t* reads, const int64_t* qlen,
                int64_t n_reads, int64_t L) {
  mp.reads = reads;
  mp.n_reads = n_reads;
  mp.L = L;
  mp.qlen.assign(qlen, qlen + n_reads);
  mp.per.assign(n_reads, PerRead());
  mp.phase = 0;
  mp.pass_k = 0;
}

// Chain + plan (threaded over reads) and build the left-task list —
// the tail of chunk start, independent of where the seeds came from.
void chunk_chain_plan(MemPipe& mp,
                      std::vector<std::vector<SeedC>>& seeds,
                      int64_t nthreads) {
  int64_t n_reads = mp.n_reads;
  int nt = std::max((int)nthreads, 1);
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    for (;;) {
      int64_t ri = next.fetch_add(1);
      if (ri >= n_reads) break;
      PerRead& pr = mp.per[ri];
      if (!seeds[ri].empty())
        chain_read(mp, seeds[ri].data(), (int64_t)seeds[ri].size(),
                   pr.chains);
      plan_read(mp, ri, pr);
    }
  };
  if (nt == 1) {
    worker();
  } else {
    std::vector<std::thread> ths;
    for (int t = 0; t < nt; ++t) ths.emplace_back(worker);
    for (auto& t : ths) t.join();
  }
  // current task list = all LEFT tasks, sorted by -tlen (stable)
  mp.cur.clear();
  for (int64_t ri = 0; ri < n_reads; ++ri)
    for (size_t ti = 0; ti < mp.per[ri].tasks.size(); ++ti)
      if (mp.per[ri].tasks[ti].side == 0)
        mp.cur.push_back({(int32_t)ri, (int32_t)ti});
  std::stable_sort(mp.cur.begin(), mp.cur.end(),
                   [&](const std::pair<int32_t, int32_t>& x,
                       const std::pair<int32_t, int32_t>& y) {
                     return mp.per[x.first].tasks[x.second].tlen >
                            mp.per[y.first].tasks[y.second].tlen;
                   });
}

}  // namespace

// Seed + chain + plan the left-extension tasks for a chunk of reads.
// Returns 0, or -1 on seed-capacity failure.
int64_t mp_chunk_start(void* h, const uint8_t* reads, const int64_t* qlen,
                       int64_t n_reads, int64_t L, int64_t nthreads) {
  MemPipe& mp = *static_cast<MemPipe*>(h);
  chunk_init(mp, reads, qlen, n_reads, L);

  // seeding via the native SMEM engine, threaded over read ranges (the
  // rank-query chain is memory-latency bound; independent reads scale)
  int64_t split_len =
      (int64_t)(mp.opt.min_seed_len * mp.opt.split_factor + 0.499);
  int nt_seed = std::max((int)nthreads, 1);
  std::vector<std::vector<SeedC>> seeds(n_reads);
  std::atomic<bool> seed_fail(false);
  int64_t stripe = (n_reads + nt_seed - 1) / nt_seed;
  auto seed_worker = [&](int64_t r0, int64_t r1) {
    if (r0 >= r1) return;
    int64_t total_q = 0;
    for (int64_t i = r0; i < r1; ++i) total_q += qlen[i];
    int64_t cap = std::max((int64_t)1 << 16, total_q * 4);
    std::vector<int64_t> rows;
    int64_t n_seeds;
    for (;;) {
      rows.resize(cap * 4);
      n_seeds = bwamem_collect_seeds(
          mp.C, mp.primary, mp.n_rows, mp.occ_rows, mp.pk_rows,
          mp.va_rows, mp.ssa, mp.n_ssa, mp.sa_intv, reads + r0 * L,
          qlen + r0, r1 - r0, L, mp.opt.min_seed_len, split_len,
          mp.opt.split_width, mp.opt.max_occ, rows.data(), cap);
      if (n_seeds >= 0) break;
      cap *= 4;
      if (cap > ((int64_t)1 << 31)) {
        seed_fail.store(true);
        return;
      }
    }
    for (int64_t k = 0; k < n_seeds; ++k) {
      const int64_t* row = rows.data() + k * 4;
      seeds[r0 + row[0]].push_back(SeedC{row[1], row[2], row[3]});
    }
  };
  if (nt_seed == 1) {
    seed_worker(0, n_reads);
  } else {
    std::vector<std::thread> sths;
    for (int t = 0; t < nt_seed; ++t)
      sths.emplace_back(seed_worker, t * stripe,
                        std::min((int64_t)(t + 1) * stripe, n_reads));
    for (auto& t : sths) t.join();
  }
  if (seed_fail.load()) return -1;
  chunk_chain_plan(mp, seeds, nthreads);
  return 0;
}

// mp_chunk_start with the seeds supplied by the caller instead of the
// native SMEM engine — the entry point for DEVICE-side seeding
// (ops/smem_jax.collect_seeds_device produces the same
// {read_idx, rbeg, qbeg, len} rows as bwamem_collect_seeds, so the two
// paths are interchangeable upstream of chaining).  seed_rows: (n, 4)
// int64, any read order, but rows of one read must keep the seeder's
// emission order (chain_read is order-sensitive exactly like bwa's
// mem_chain).  Returns 0, or -1 on an out-of-range read index.
int64_t mp_chunk_start_seeded(void* h, const uint8_t* reads,
                              const int64_t* qlen, int64_t n_reads,
                              int64_t L, const int64_t* seed_rows,
                              int64_t n_seed_rows, int64_t nthreads) {
  MemPipe& mp = *static_cast<MemPipe*>(h);
  chunk_init(mp, reads, qlen, n_reads, L);
  std::vector<std::vector<SeedC>> seeds(n_reads);
  for (int64_t k = 0; k < n_seed_rows; ++k) {
    const int64_t* row = seed_rows + k * 4;
    if (row[0] < 0 || row[0] >= n_reads) return -1;
    seeds[row[0]].push_back(SeedC{row[1], row[2], row[3]});
  }
  chunk_chain_plan(mp, seeds, nthreads);
  return 0;
}

int64_t mp_task_count(void* h) {
  return (int64_t)static_cast<MemPipe*>(h)->cur.size();
}

void mp_task_dims(void* h, int64_t* qmax, int64_t* tmax) {
  MemPipe& mp = *static_cast<MemPipe*>(h);
  int64_t q = 1, t = 1;
  for (const auto& p : mp.cur) {
    const TaskC& task = mp.per[p.first].tasks[p.second];
    q = std::max(q, task.qlen);
    t = std::max(t, task.tlen);
  }
  *qmax = q;
  *tmax = t;
}

// Fill the kernel input arrays IN TRANSPOSED LAYOUT (the layout of
// ops/extend_step.py): query_t (qmax, Bp) int8,
// target_t (tmax, Bp) int8 (base codes 0..4 — the device widens them;
// int8 keeps the host->device transfer 4x smaller),
// scal_t (8, Bp) int32 rows [qlen, tlen, aw, h0, 0...].  Arrays must be
// zeroed by the caller; only columns 0..B-1 are written.  k is the
// band-doubling pass.
void mp_fill_tasks(void* h, int64_t k, int8_t* query_t, int64_t qmax,
                   int8_t* target_t, int64_t tmax, int32_t* scal_t,
                   int64_t Bp) {
  MemPipe& mp = *static_cast<MemPipe*>(h);
  const Opt& o = mp.opt;
  for (size_t slot = 0; slot < mp.cur.size(); ++slot) {
    const auto& pr = mp.per[mp.cur[slot].first];
    const TaskC& t = pr.tasks[mp.cur[slot].second];
    const uint8_t* q = pr.qbuf.data() + t.qoff;
    for (int64_t j = 0; j < t.qlen; ++j)
      query_t[j * Bp + slot] = (int8_t)q[j];
    const std::vector<uint8_t>& rs = pr.rseq[t.ci];
    if (t.side == 0) {  // left target is reversed rseq[:tlen]
      for (int64_t j = 0; j < t.tlen; ++j)
        target_t[j * Bp + slot] = (int8_t)rs[t.tlen - 1 - j];
    } else {
      for (int64_t j = 0; j < t.tlen; ++j)
        target_t[j * Bp + slot] = (int8_t)rs[t.toff + j];
    }
    int64_t aw = std::min((int64_t)(o.w << k), std::min(t.max_ins, t.max_del));
    scal_t[0 * Bp + slot] = (int32_t)t.qlen;
    scal_t[1 * Bp + slot] = (int32_t)t.tlen;
    scal_t[2 * Bp + slot] = (int32_t)aw;
    scal_t[3 * Bp + slot] = (int32_t)t.h0;
  }
}

// Consume one pass's kernel results: res_t is the (8, Bp) int32 output
// matrix [score, qle, tle, gtle, gscore, max_off, aw, 0].  For k=0 the
// current task list shrinks to the non-converged retry subset and its
// size is returned; for k=1 returns 0.
int64_t mp_pass_done(void* h, int64_t k, const int32_t* res_t, int64_t Bp) {
  MemPipe& mp = *static_cast<MemPipe*>(h);
  const Opt& o = mp.opt;
  std::vector<std::pair<int32_t, int32_t>> retry;
  for (size_t slot = 0; slot < mp.cur.size(); ++slot) {
    TaskC& t = mp.per[mp.cur[slot].first].tasks[mp.cur[slot].second];
    ExtRes r;
    r.score = res_t[0 * Bp + slot];
    r.qle = res_t[1 * Bp + slot];
    r.tle = res_t[2 * Bp + slot];
    r.gtle = res_t[3 * Bp + slot];
    r.gscore = res_t[4 * Bp + slot];
    r.max_off = res_t[5 * Bp + slot];
    t.res[k] = r;
    if (k == 0) {
      t.res[1] = r;  // default: converged tasks reuse pass 0
      int64_t aw0 = o.w;
      if (!(r.max_off < ((aw0 >> 1) + (aw0 >> 2))))
        retry.push_back(mp.cur[slot]);
    }
  }
  if (k == 0) {
    mp.cur.swap(retry);
    std::stable_sort(mp.cur.begin(), mp.cur.end(),
                     [&](const std::pair<int32_t, int32_t>& x,
                         const std::pair<int32_t, int32_t>& y) {
                       return mp.per[x.first].tasks[x.second].tlen >
                              mp.per[y.first].tasks[y.second].tlen;
                     });
  } else {
    mp.cur.clear();
  }
  return (int64_t)mp.cur.size();
}

// Resolve left results into right-task h0 and make the right tasks the
// current list.  Returns the task count.
int64_t mp_prepare_right(void* h) {
  MemPipe& mp = *static_cast<MemPipe*>(h);
  const Opt& o = mp.opt;
  mp.phase = 1;
  mp.cur.clear();
  for (int64_t ri = 0; ri < mp.n_reads; ++ri) {
    PerRead& pr = mp.per[ri];
    for (size_t ti = 0; ti < pr.tasks.size(); ++ti) {
      TaskC& t = pr.tasks[ti];
      if (t.side != 1) continue;
      const SeedC& s = pr.chains[t.ci].seeds[t.si];
      if (s.qbeg > 0) {
        const TaskC& lt = pr.tasks[pr.tidx[t.ci][t.si * 2]];
        t.h0 = resolve(o, lt, -1).score;
      } else {
        t.h0 = s.len * o.a;
      }
      mp.cur.push_back({(int32_t)ri, (int32_t)ti});
    }
  }
  std::stable_sort(mp.cur.begin(), mp.cur.end(),
                   [&](const std::pair<int32_t, int32_t>& x,
                       const std::pair<int32_t, int32_t>& y) {
                     return mp.per[x.first].tasks[x.second].tlen >
                            mp.per[y.first].tasks[y.second].tlen;
                   });
  return (int64_t)mp.cur.size();
}

// ---- fused whole-alignment protocol: ONE device call per chunk ----
// (ops/extend_step's fused step runs L0/L-retry/R0/R-retry with
// in-lane h0 chaining; the four-round-trip mp_fill_tasks /
// mp_pass_done / mp_prepare_right loop above remains as the tested
// fallback and the sharded path's protocol)

// Build the fused lane list: one lane per (chain, seed) candidate that
// has at least one extension side.  Returns the lane count.
int64_t mp_prepare_fused(void* h) {
  MemPipe& mp = *static_cast<MemPipe*>(h);
  mp.fused.clear();
  for (int64_t ri = 0; ri < mp.n_reads; ++ri) {
    PerRead& pr = mp.per[ri];
    for (size_t ci = 0; ci < pr.chains.size(); ++ci) {
      const ChainC& c = pr.chains[ci];
      for (size_t si = 0; si < c.seeds.size(); ++si) {
        int32_t lt = pr.tidx[ci][si * 2];
        int32_t rt = pr.tidx[ci][si * 2 + 1];
        if (lt < 0 && rt < 0) continue;
        mp.fused.push_back({(int32_t)ri, lt, rt,
                            c.seeds[si].len * mp.opt.a});
      }
    }
  }
  // longest total row count first keeps per-block tmax bounds tight
  auto rows = [&](const MemPipe::FusedLane& f) {
    int64_t r = 0;
    const auto& ts = mp.per[f.ri].tasks;
    if (f.lt >= 0) r += ts[f.lt].tlen;
    if (f.rt >= 0) r += ts[f.rt].tlen;
    return r;
  };
  std::stable_sort(mp.fused.begin(), mp.fused.end(),
                   [&](const MemPipe::FusedLane& x,
                       const MemPipe::FusedLane& y) {
                     return rows(x) > rows(y);
                   });
  return (int64_t)mp.fused.size();
}

void mp_fused_dims(void* h, int64_t* qmax_l, int64_t* tmax_l,
                   int64_t* qmax_r, int64_t* tmax_r) {
  MemPipe& mp = *static_cast<MemPipe*>(h);
  int64_t ql = 1, tl = 1, qr = 1, tr = 1;
  for (const auto& f : mp.fused) {
    const auto& ts = mp.per[f.ri].tasks;
    if (f.lt >= 0) {
      ql = std::max(ql, ts[f.lt].qlen);
      tl = std::max(tl, ts[f.lt].tlen);
    }
    if (f.rt >= 0) {
      qr = std::max(qr, ts[f.rt].qlen);
      tr = std::max(tr, ts[f.rt].tlen);
    }
  }
  *qmax_l = ql;
  *tmax_l = tl;
  *qmax_r = qr;
  *tmax_r = tr;
}

// Fill the fused kernel inputs (transposed, int8 base codes, caller-
// zeroed).  scal_t rows: [qlen_l, tlen_l, aw0_l, h0_seed, aw1_l,
// qlen_r, tlen_r, aw0_r, aw1_r, w, 0...] (16 rows).
void mp_fill_fused(void* h, int8_t* ql_t, int64_t qmax_l, int8_t* tl_t,
                   int64_t tmax_l, int8_t* qr_t, int64_t qmax_r,
                   int8_t* tr_t, int64_t tmax_r, int32_t* scal_t,
                   int64_t Bp) {
  MemPipe& mp = *static_cast<MemPipe*>(h);
  const Opt& o = mp.opt;
  (void)qmax_l;
  (void)tmax_l;
  (void)qmax_r;
  (void)tmax_r;
  for (size_t slot = 0; slot < mp.fused.size(); ++slot) {
    const auto& f = mp.fused[slot];
    const auto& pr = mp.per[f.ri];
    scal_t[3 * Bp + slot] = (int32_t)f.h0_seed;
    scal_t[9 * Bp + slot] = (int32_t)o.w;
    if (f.lt >= 0) {
      const TaskC& t = pr.tasks[f.lt];
      const uint8_t* q = pr.qbuf.data() + t.qoff;
      for (int64_t j = 0; j < t.qlen; ++j)
        ql_t[j * Bp + slot] = (int8_t)q[j];
      const std::vector<uint8_t>& rs = pr.rseq[t.ci];
      for (int64_t j = 0; j < t.tlen; ++j)  // left target reversed
        tl_t[j * Bp + slot] = (int8_t)rs[t.tlen - 1 - j];
      scal_t[0 * Bp + slot] = (int32_t)t.qlen;
      scal_t[1 * Bp + slot] = (int32_t)t.tlen;
      scal_t[2 * Bp + slot] =
          (int32_t)std::min(o.w, std::min(t.max_ins, t.max_del));
      scal_t[4 * Bp + slot] =
          (int32_t)std::min(o.w << 1, std::min(t.max_ins, t.max_del));
    }
    if (f.rt >= 0) {
      const TaskC& t = pr.tasks[f.rt];
      const uint8_t* q = pr.qbuf.data() + t.qoff;
      for (int64_t j = 0; j < t.qlen; ++j)
        qr_t[j * Bp + slot] = (int8_t)q[j];
      const std::vector<uint8_t>& rs = pr.rseq[t.ci];
      for (int64_t j = 0; j < t.tlen; ++j)
        tr_t[j * Bp + slot] = (int8_t)rs[t.toff + j];
      scal_t[5 * Bp + slot] = (int32_t)t.qlen;
      scal_t[6 * Bp + slot] = (int32_t)t.tlen;
      scal_t[7 * Bp + slot] =
          (int32_t)std::min(o.w, std::min(t.max_ins, t.max_del));
      scal_t[8 * Bp + slot] =
          (int32_t)std::min(o.w << 1, std::min(t.max_ins, t.max_del));
    }
  }
}

// Indexed fill for the device-resident-reference fused path: ships NO
// base payload at all.  Rows 0-9 are identical to mp_fill_fused; the
// device gathers the windows itself from the resident two-strand text
// and the chunk's read matrix via:
//   row 10 = read index          (left query j  = read[qlen_l-1-j],
//                                 right query j = read[row11 + j])
//   row 11 = right-query offset  (= l_query - qlen_r)
//   rows 12/13 = left/right target start, LOW 20 bits
//   rows 14/15 = left/right target start >> 20
// (left start = rmax0 + tlen_l - 1, descending; right = rmax0 + toff,
// ascending.  The hi/lo split keeps int32 lanes exact for references
// beyond 2^31 two-strand symbols — GRCh38 scale; the device either
// reconstructs a flat index or addresses a (rows, 2^20) text.)  This
// is the resident-reference answer to the reference's 4-bit payload
// packing (task_parse.v payload stream): ship offsets, not bases.
void mp_fill_fused_idx(void* h, int32_t* scal_t, int64_t Bp) {
  MemPipe& mp = *static_cast<MemPipe*>(h);
  const Opt& o = mp.opt;
  for (size_t slot = 0; slot < mp.fused.size(); ++slot) {
    const auto& f = mp.fused[slot];
    const auto& pr = mp.per[f.ri];
    scal_t[3 * Bp + slot] = (int32_t)f.h0_seed;
    scal_t[9 * Bp + slot] = (int32_t)o.w;
    scal_t[10 * Bp + slot] = f.ri;
    if (f.lt >= 0) {
      const TaskC& t = pr.tasks[f.lt];
      scal_t[0 * Bp + slot] = (int32_t)t.qlen;
      scal_t[1 * Bp + slot] = (int32_t)t.tlen;
      scal_t[2 * Bp + slot] =
          (int32_t)std::min(o.w, std::min(t.max_ins, t.max_del));
      scal_t[4 * Bp + slot] =
          (int32_t)std::min(o.w << 1, std::min(t.max_ins, t.max_del));
      int64_t st = pr.rmax0[t.ci] + t.tlen - 1;
      scal_t[12 * Bp + slot] = (int32_t)(st & 0xFFFFF);
      scal_t[14 * Bp + slot] = (int32_t)(st >> 20);
    }
    if (f.rt >= 0) {
      const TaskC& t = pr.tasks[f.rt];
      scal_t[5 * Bp + slot] = (int32_t)t.qlen;
      scal_t[6 * Bp + slot] = (int32_t)t.tlen;
      scal_t[7 * Bp + slot] =
          (int32_t)std::min(o.w, std::min(t.max_ins, t.max_del));
      scal_t[8 * Bp + slot] =
          (int32_t)std::min(o.w << 1, std::min(t.max_ins, t.max_del));
      scal_t[11 * Bp + slot] = (int32_t)(mp.qlen[f.ri] - t.qlen);
      int64_t st = pr.rmax0[t.ci] + t.toff;
      scal_t[13 * Bp + slot] = (int32_t)(st & 0xFFFFF);
      scal_t[15 * Bp + slot] = (int32_t)(st >> 20);
    }
  }
}

// Consume the fused kernel output res_t (32, Bp) int32: row groups
// [L0 | L1 | R0 | R1] x [score, qle, tle, gtle, gscore, max_off, aw,
// 0].  Stores res[0]/res[1] per task with exactly mp_pass_done's
// retry rule (!(max_off0 < (w>>1)+(w>>2))), so replay_read's resolve()
// sees byte-identical state to the four-pass protocol.
void mp_fused_done(void* h, const int32_t* res_t, int64_t Bp) {
  MemPipe& mp = *static_cast<MemPipe*>(h);
  int64_t thr = (mp.opt.w >> 1) + (mp.opt.w >> 2);
  auto grp = [&](int64_t base, size_t slot) {
    ExtRes r;
    r.score = res_t[(base + 0) * Bp + slot];
    r.qle = res_t[(base + 1) * Bp + slot];
    r.tle = res_t[(base + 2) * Bp + slot];
    r.gtle = res_t[(base + 3) * Bp + slot];
    r.gscore = res_t[(base + 4) * Bp + slot];
    r.max_off = res_t[(base + 5) * Bp + slot];
    return r;
  };
  for (size_t slot = 0; slot < mp.fused.size(); ++slot) {
    const auto& f = mp.fused[slot];
    auto& ts = mp.per[f.ri].tasks;
    if (f.lt >= 0) {
      TaskC& t = ts[f.lt];
      t.res[0] = grp(0, slot);
      t.res[1] = t.res[0].max_off < thr ? t.res[0] : grp(8, slot);
    }
    if (f.rt >= 0) {
      TaskC& t = ts[f.rt];
      t.res[0] = grp(16, slot);
      t.res[1] = t.res[0].max_off < thr ? t.res[0] : grp(24, slot);
    }
  }
  mp.fused.clear();
}

// Replay + regions + records for the whole chunk, threaded.
// Returns the total number of SAM records.
int64_t mp_finalize(void* h, int64_t nthreads) {
  MemPipe& mp = *static_cast<MemPipe*>(h);
  int nt = std::max((int)nthreads, 1);
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    for (;;) {
      int64_t ri = next.fetch_add(1);
      if (ri >= mp.n_reads) break;
      finalize_read(mp, ri, mp.per[ri]);
    }
  };
  if (nt == 1) {
    worker();
  } else {
    std::vector<std::thread> ths;
    for (int t = 0; t < nt; ++t) ths.emplace_back(worker);
    for (auto& t : ths) t.join();
  }
  int64_t n = 0;
  mp.rec_read.clear();
  for (int64_t ri = 0; ri < mp.n_reads; ++ri) {
    n += (int64_t)mp.per[ri].records.size();
    for (size_t k = 0; k < mp.per[ri].records.size(); ++k)
      mp.rec_read.push_back(ri);
  }
  return n;
}

// Total bytes needed for the string blob (cigar + md + xa per record,
// each NUL-terminated).
int64_t mp_blob_size(void* h) {
  MemPipe& mp = *static_cast<MemPipe*>(h);
  int64_t n = 0;
  for (const auto& pr : mp.per)
    for (const auto& r : pr.records)
      n += (int64_t)r.cigar.size() + r.md.size() + r.xa.size() + 3;
  return n;
}

// Replay + PE pairing for a chunk laid out [reads1..., reads2...]
// (n_pairs of each): insert-size inference over the chunk, mate
// rescue, pairing, and record emission — all records land on the
// read-1 PerRead so export order is pair-grouped.  Returns the total
// record count.
int64_t mp_finalize_pe(void* h, int64_t n_pairs, int64_t nthreads) {
  MemPipe& mp = *static_cast<MemPipe*>(h);
  int nt = std::max((int)nthreads, 1);
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    for (;;) {
      int64_t ri = next.fetch_add(1);
      if (ri >= mp.n_reads) break;
      replay_read(mp, ri, mp.per[ri]);
    }
  };
  if (nt == 1) {
    worker();
  } else {
    std::vector<std::thread> ths;
    for (int t = 0; t < nt; ++t) ths.emplace_back(worker);
    for (auto& t : ths) t.join();
  }
  PEStatC pes[4];
  compute_pes(mp, n_pairs, pes);
  std::atomic<int64_t> nextp(0);
  auto pworker = [&]() {
    for (;;) {
      int64_t i = nextp.fetch_add(1);
      if (i >= n_pairs) break;
      if (mp.opt.max_matesw > 0) rescue_pairs(mp, pes, n_pairs, i);
      sam_pe(mp, n_pairs, i, pes);
    }
  };
  if (nt == 1) {
    pworker();
  } else {
    std::vector<std::thread> ths;
    for (int t = 0; t < nt; ++t) ths.emplace_back(pworker);
    for (auto& t : ths) t.join();
  }
  int64_t n = 0;
  for (const auto& pr : mp.per) n += (int64_t)pr.records.size();
  return n;
}

// ---- device-rescue wave protocol -----------------------------------
// mp_finalize_pe split so mem_matesw's local-SW batches can run on the
// accelerator (ops/local_jax.py): prepare (replay + pestat), then per
// end phase e in {0,1} and wave k: build wave tasks -> device SW ->
// apply, and finally the pairing/record tail.  Byte-identical output
// to mp_finalize_pe because pairs are independent within a wave and
// each anchor's skip test sees exactly the regions a sequential
// per-pair loop would have appended.

void mp_pe_prepare(void* h, int64_t n_pairs, int64_t nthreads) {
  MemPipe& mp = *static_cast<MemPipe*>(h);
  int nt = std::max((int)nthreads, 1);
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    for (;;) {
      int64_t ri = next.fetch_add(1);
      if (ri >= mp.n_reads) break;
      replay_read(mp, ri, mp.per[ri]);
    }
  };
  if (nt == 1) {
    worker();
  } else {
    std::vector<std::thread> ths;
    for (int t = 0; t < nt; ++t) ths.emplace_back(worker);
    for (auto& t : ths) t.join();
  }
  compute_pes(mp, n_pairs, mp.pe_stat);
  mp.pe_npairs = n_pairs;
}

// Build the per-pair anchor lists for end phase e (e = 0: read-1
// regions anchor read-2 rescues; e = 1: vice versa, including regions
// rescued during phase 0).  Returns the number of waves.
// Snapshot BOTH ends' anchor lists up front (bwa's b[0]/b[1]) and
// return the wave count = the longest anchor list over both ends and
// all pairs.  The two ends' rescue chains touch DISJOINT region lists
// (end-0 anchors test/append the end-1 list and vice versa), so wave k
// batches both ends' k-th anchors into ONE device dispatch — half the
// round trips of the round-2 per-end phases, with bwa's sequential
// semantics intact (each list still receives its appends in anchor
// order).
int64_t mp_rescue_begin(void* h) {
  MemPipe& mp = *static_cast<MemPipe*>(h);
  const Opt& o = mp.opt;
  int64_t n_pairs = mp.pe_npairs;
  mp.rescue_anchors.assign((size_t)(2 * n_pairs), {});
  int64_t waves = 0;
  // read index ei covers both ends: end 0 = pairs 0..n-1, end 1 =
  // reads n..2n-1
  for (int64_t ei = 0; ei < 2 * n_pairs; ++ei) {
    auto& regs = mp.per[ei].regions;
    if (regs.empty()) continue;
    int64_t best = regs[0].score;
    for (const auto& r : regs) best = std::max(best, r.score);
    auto& anchors = mp.rescue_anchors[(size_t)ei];
    for (const auto& r : regs)
      if (r.score >= best - o.pen_unpaired) anchors.push_back(r);
    if ((int64_t)anchors.size() > o.max_matesw)
      anchors.resize((size_t)o.max_matesw);
    waves = std::max(waves, (int64_t)anchors.size());
  }
  return waves;
}

int64_t mp_rescue_wave_build(void* h, int64_t k, int64_t* max_q,
                             int64_t* max_t) {
  MemPipe& mp = *static_cast<MemPipe*>(h);
  int64_t n_pairs = mp.pe_npairs;
  mp.rescue_tasks.clear();
  for (int64_t ei = 0; ei < 2 * n_pairs; ++ei) {
    const auto& anchors = mp.rescue_anchors[(size_t)ei];
    if (k >= (int64_t)anchors.size()) continue;
    // the mate of read ei: end 0 (ei < n_pairs) pairs with ei+n_pairs
    int64_t other = ei < n_pairs ? ei + n_pairs : ei - n_pairs;
    matesw_emit(mp, mp.pe_stat, anchors[(size_t)k],
                mp.reads + other * mp.L, mp.qlen[other],
                mp.per[other].regions, other, mp.rescue_tasks);
  }
  int64_t mq = 0, mt = 0;
  for (const auto& t : mp.rescue_tasks) {
    mq = std::max(mq, t.l_ms);
    mt = std::max(mt, (int64_t)t.rseq.size());
  }
  *max_q = mq;
  *max_t = mt;
  return (int64_t)mp.rescue_tasks.size();
}

// seq (Bp, lq_pad) / rseq (Bp, lt_pad) row-major int8 (caller
// zero-filled; the device masks by length); lens (2, Bp) int32 rows
// [l_ms, l_ts].
void mp_rescue_fill(void* h, int8_t* seq, int64_t lq_pad, int8_t* rseq,
                    int64_t lt_pad, int32_t* lens, int64_t Bp) {
  MemPipe& mp = *static_cast<MemPipe*>(h);
  for (size_t i = 0; i < mp.rescue_tasks.size(); ++i) {
    const auto& t = mp.rescue_tasks[i];
    std::memcpy(seq + (int64_t)i * lq_pad, t.seq.data(), t.seq.size());
    std::memcpy(rseq + (int64_t)i * lt_pad, t.rseq.data(),
                t.rseq.size());
    lens[i] = (int32_t)t.l_ms;
    lens[Bp + (int64_t)i] = (int32_t)t.rseq.size();
  }
}

// Indexed fill for the device-resident-reference rescue path: no base
// payload; meta (6, Bp) int32 rows are
//   [l_ms, l_ts, mate read index, is_rev, win_lo20, win_hi]
// where win = rb (the window start in two-strand coordinates).  The
// device gathers seq from the chunk read matrix (revcomp'd in-lane
// when is_rev) and rseq from the resident text.
void mp_rescue_fill_idx(void* h, int32_t* meta, int64_t Bp) {
  MemPipe& mp = *static_cast<MemPipe*>(h);
  for (size_t i = 0; i < mp.rescue_tasks.size(); ++i) {
    const auto& t = mp.rescue_tasks[i];
    meta[0 * Bp + (int64_t)i] = (int32_t)t.l_ms;
    meta[1 * Bp + (int64_t)i] = (int32_t)t.rseq.size();
    meta[2 * Bp + (int64_t)i] = (int32_t)t.mate_read;
    meta[3 * Bp + (int64_t)i] = t.is_rev ? 1 : 0;
    meta[4 * Bp + (int64_t)i] = (int32_t)(t.rb & 0xFFFFF);
    meta[5 * Bp + (int64_t)i] = (int32_t)(t.rb >> 20);
  }
}

// out6 (6, Bp) int32: [score, qb, qe, tb, te, score2] per task lane.
void mp_rescue_apply(void* h, const int32_t* out6, int64_t Bp) {
  MemPipe& mp = *static_cast<MemPipe*>(h);
  for (size_t i = 0; i < mp.rescue_tasks.size(); ++i) {
    const auto& t = mp.rescue_tasks[i];
    int64_t o6[6];
    for (int j = 0; j < 6; ++j) o6[j] = out6[j * Bp + (int64_t)i];
    matesw_apply(mp, t, o6, mp.per[t.mate_read].regions);
  }
  mp.rescue_tasks.clear();
}

// Pairing + record emission using the stored pestat (rescue already
// done by the wave loop — or skipped when max_matesw == 0).
int64_t mp_finalize_pe_tail(void* h, int64_t n_pairs, int64_t nthreads) {
  MemPipe& mp = *static_cast<MemPipe*>(h);
  int nt = std::max((int)nthreads, 1);
  std::atomic<int64_t> nextp(0);
  auto pworker = [&]() {
    for (;;) {
      int64_t i = nextp.fetch_add(1);
      if (i >= n_pairs) break;
      sam_pe(mp, n_pairs, i, mp.pe_stat);
    }
  };
  if (nt == 1) {
    pworker();
  } else {
    std::vector<std::thread> ths;
    for (int t = 0; t < nt; ++t) ths.emplace_back(pworker);
    for (auto& t : ths) t.join();
  }
  mp.rescue_anchors.clear();
  mp.cig_tasks.clear();
  mp.cig_results.clear();
  int64_t n = 0;
  for (const auto& pr : mp.per) n += (int64_t)pr.records.size();
  return n;
}

// ---- device-CIGAR round protocol (SE) -------------------------------
// mp_finalize split so reg2aln's banded global realignments run as
// batched device rounds (ops/global_jax.py): begin replays +
// primary-marks every read and collects retry-loop state for each
// region that needs a global fill; then rounds of fill -> device ->
// apply run bwa's band-doubling retry compacted across the whole
// chunk (align.py batched_global_results replays the identical
// schedule); mp_finalize_records emits records consulting the result
// table.  Output byte-identical to mp_finalize.

int64_t mp_cigar_begin(void* h, int64_t nthreads) {
  MemPipe& mp = *static_cast<MemPipe*>(h);
  const Opt& o = mp.opt;
  int nt = std::max((int)nthreads, 1);
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    for (;;) {
      int64_t ri = next.fetch_add(1);
      if (ri >= mp.n_reads) break;
      replay_read(mp, ri, mp.per[ri]);
      mark_primary(o, mp.per[ri].regions);
    }
  };
  if (nt == 1) {
    worker();
  } else {
    std::vector<std::thread> ths;
    for (int t = 0; t < nt; ++t) ths.emplace_back(worker);
    for (auto& t : ths) t.join();
  }
  mp.cig_tasks.clear();
  mp.cig_results.clear();
  int64_t stride = 1;
  for (const auto& pr : mp.per)
    stride = std::max(stride, (int64_t)pr.regions.size() + 1);
  mp.cig_stride = stride;
  for (int64_t ri = 0; ri < mp.n_reads; ++ri) {
    const auto& regs = mp.per[ri].regions;
    // regions whose reg2aln will actually run: record emission
    // (primary/supplementary, or everything under -a) plus XA
    // alternates (secondary == 0, within the max_xa_hits gate)
    int64_t n_alts = 0;
    if (!o.flag_a)
      for (const auto& p : regs)
        if (p.secondary == 0 && p.score >= o.T) ++n_alts;
    bool xa_on = !o.flag_a && n_alts > 0 && n_alts <= o.max_xa_hits;
    for (size_t ki = 0; ki < regs.size(); ++ki) {
      const RegionC& p = regs[ki];
      if (p.score < o.T || p.rb < 0 || p.re < 0) continue;
      bool rec = p.secondary < 0 || o.flag_a;
      bool xa = xa_on && p.secondary == 0;
      if (!rec && !xa) continue;
      MemPipe::CigTask t;
      t.ri = ri;
      t.ki = (int64_t)ki;
      int64_t w2;
      if (!gen_cigar_setup(mp, ri, p, t.qseg, t.rseg, &w2))
        continue;  // no-gap fast path: host computes inline
      if (t.qseg.empty() || t.rseg.empty())
        continue;  // pure-indel host fast paths (no SW)
      t.w2 = w2;
      t.last_sc = -((int64_t)1 << 30);
      t.round = 0;
      t.truesc = p.truesc;
      t.qb = p.qb;
      t.rb = p.rb;
      t.re = p.re;
      mp.cig_tasks.push_back(std::move(t));
    }
  }
  return (int64_t)mp.cig_tasks.size();
}

void mp_cigar_dims(void* h, int64_t* max_q, int64_t* max_t) {
  MemPipe& mp = *static_cast<MemPipe*>(h);
  int64_t mq = 0, mt = 0;
  for (const auto& t : mp.cig_tasks) {
    mq = std::max(mq, (int64_t)t.qseg.size());
    mt = std::max(mt, (int64_t)t.rseg.size());
  }
  *max_q = mq;
  *max_t = mt;
}

// q (Bp, lq) / t (Bp, lt) row-major int8 (caller zero-filled); meta
// (3, Bp) int32 rows [qlen, tlen, w(this round, capped)].
void mp_cigar_fill(void* h, int8_t* q, int64_t lq, int8_t* t, int64_t lt,
                   int32_t* meta, int64_t Bp) {
  MemPipe& mp = *static_cast<MemPipe*>(h);
  const Opt& o = mp.opt;
  for (size_t i = 0; i < mp.cig_tasks.size(); ++i) {
    const auto& ct = mp.cig_tasks[i];
    std::memcpy(q + (int64_t)i * lq, ct.qseg.data(), ct.qseg.size());
    std::memcpy(t + (int64_t)i * lt, ct.rseg.data(), ct.rseg.size());
    meta[i] = (int32_t)ct.qseg.size();
    meta[Bp + (int64_t)i] = (int32_t)ct.rseg.size();
    meta[2 * Bp + (int64_t)i] = (int32_t)std::min(ct.w2, o.w << 2);
  }
}

// Indexed fill for the device-resident-reference CIGAR rounds: meta
// (8, Bp) int32 rows are
//   [qlen, tlen, w, read index, qcol0, is_rev, t_lo20, t_hi]
// where the device reads query base j as read[qcol0 - j] when is_rev
// (regions on the reverse strand align reversed segments, matching
// gen_cigar_setup) else read[qcol0 + j], and target base j from the
// resident text at tpos0 -+ j (tpos0 = t_hi*2^20 + t_lo).
void mp_cigar_fill_idx(void* h, int32_t* meta, int64_t Bp) {
  MemPipe& mp = *static_cast<MemPipe*>(h);
  const Opt& o = mp.opt;
  for (size_t i = 0; i < mp.cig_tasks.size(); ++i) {
    const auto& ct = mp.cig_tasks[i];
    bool rev = ct.rb >= mp.l_pac;
    int64_t qcol0 = rev ? ct.qb + (int64_t)ct.qseg.size() - 1 : ct.qb;
    int64_t tpos0 = rev ? ct.re - 1 : ct.rb;
    meta[0 * Bp + (int64_t)i] = (int32_t)ct.qseg.size();
    meta[1 * Bp + (int64_t)i] = (int32_t)ct.rseg.size();
    meta[2 * Bp + (int64_t)i] = (int32_t)std::min(ct.w2, o.w << 2);
    meta[3 * Bp + (int64_t)i] = (int32_t)ct.ri;
    meta[4 * Bp + (int64_t)i] = (int32_t)qcol0;
    meta[5 * Bp + (int64_t)i] = rev ? 1 : 0;
    meta[6 * Bp + (int64_t)i] = (int32_t)(tpos0 & 0xFFFFF);
    meta[7 * Bp + (int64_t)i] = (int32_t)(tpos0 >> 20);
  }
}

// scores (Bp,) int32; ncig (Bp,) int32; flat int32 (op, len) pairs
// task-major.  Returns the number of still-active tasks (next round).
int64_t mp_cigar_apply(void* h, const int32_t* scores,
                       const int32_t* ncig, const int32_t* flat,
                       int64_t Bp) {
  MemPipe& mp = *static_cast<MemPipe*>(h);
  const Opt& o = mp.opt;
  std::vector<MemPipe::CigTask> nxt;
  int64_t off = 0;
  for (size_t i = 0; i < mp.cig_tasks.size(); ++i) {
    MemPipe::CigTask& t = mp.cig_tasks[i];
    int64_t score = scores[i];
    GlobalResC res;
    res.score = score;
    res.cigar.reserve((size_t)ncig[i]);
    for (int32_t c = 0; c < ncig[i]; ++c)
      res.cigar.push_back({flat[off + 2 * c], flat[off + 2 * c + 1]});
    off += 2 * ncig[i];
    mp.cig_results[t.ri * mp.cig_stride + t.ki] = std::move(res);
    int64_t w2c = std::min(t.w2, o.w << 2);
    if (score == t.last_sc || w2c == (o.w << 2)) continue;
    t.last_sc = score;
    t.w2 = w2c << 1;
    t.round += 1;
    if (t.round < 3 && score < t.truesc - o.a)
      nxt.push_back(std::move(t));
  }
  mp.cig_tasks = std::move(nxt);
  return (int64_t)mp.cig_tasks.size();
}

// Record emission consulting the device-CIGAR result table; the
// replay/mark_primary already ran in mp_cigar_begin.
int64_t mp_finalize_records(void* h, int64_t nthreads) {
  MemPipe& mp = *static_cast<MemPipe*>(h);
  int nt = std::max((int)nthreads, 1);
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    for (;;) {
      int64_t ri = next.fetch_add(1);
      if (ri >= mp.n_reads) break;
      finalize_records(mp, ri, mp.per[ri]);
    }
  };
  if (nt == 1) {
    worker();
  } else {
    std::vector<std::thread> ths;
    for (int t = 0; t < nt; ++t) ths.emplace_back(worker);
    for (auto& t : ths) t.join();
  }
  mp.cig_tasks.clear();
  mp.cig_results.clear();
  int64_t n = 0;
  mp.rec_read.clear();
  for (int64_t ri = 0; ri < mp.n_reads; ++ri) {
    n += (int64_t)mp.per[ri].records.size();
    for (size_t k = 0; k < mp.per[ri].records.size(); ++k)
      mp.rec_read.push_back(ri);
  }
  return n;
}

// PE task collection for the device-CIGAR rounds: which regions
// sam_pe will reg2aln depends on pairing decisions made later, so
// collect the superset (every region of either end passing the score
// threshold — regions per read are few and the device batch makes the
// extras nearly free).  Runs after mp_pe_prepare + rescue so rescued
// regions are included; sam_pe's copies preserve region order, so
// (read, index) keys stay valid.
int64_t mp_cigar_collect_pe(void* h) {
  MemPipe& mp = *static_cast<MemPipe*>(h);
  const Opt& o = mp.opt;
  mp.cig_tasks.clear();
  mp.cig_results.clear();
  int64_t stride = 1;
  for (const auto& pr : mp.per)
    stride = std::max(stride, (int64_t)pr.regions.size() + 1);
  mp.cig_stride = stride;
  for (int64_t ri = 0; ri < mp.n_reads; ++ri) {
    const auto& regs = mp.per[ri].regions;
    for (size_t ki = 0; ki < regs.size(); ++ki) {
      const RegionC& p = regs[ki];
      if (p.score < o.T || p.rb < 0 || p.re < 0) continue;
      MemPipe::CigTask t;
      t.ri = ri;
      t.ki = (int64_t)ki;
      int64_t w2;
      if (!gen_cigar_setup(mp, ri, p, t.qseg, t.rseg, &w2)) continue;
      if (t.qseg.empty() || t.rseg.empty()) continue;
      t.w2 = w2;
      t.last_sc = -((int64_t)1 << 30);
      t.round = 0;
      t.truesc = p.truesc;
      t.qb = p.qb;
      t.rb = p.rb;
      t.re = p.re;
      mp.cig_tasks.push_back(std::move(t));
    }
  }
  return (int64_t)mp.cig_tasks.size();
}

// Host-side rescue for the split PE path (used when only the CIGARs
// are delegated to the device): the rescue half of mp_finalize_pe's
// pair worker, threaded.
void mp_rescue_host(void* h, int64_t n_pairs, int64_t nthreads) {
  MemPipe& mp = *static_cast<MemPipe*>(h);
  if (mp.opt.max_matesw <= 0) return;
  int nt = std::max((int)nthreads, 1);
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n_pairs) break;
      rescue_pairs(mp, mp.pe_stat, n_pairs, i);
    }
  };
  if (nt == 1) {
    worker();
  } else {
    std::vector<std::thread> ths;
    for (int t = 0; t < nt; ++t) ths.emplace_back(worker);
    for (auto& t : ths) t.join();
  }
}

// fields: (n_records, 16) int64 rows
// [src_read, flag, rid, pos, mapq, nm, score(AS), sub(XS; -1 = absent),
//  is_rev, cigar_len, md_len, xa_len, mate_rid(-9 = SE record),
//  pnext0, tlen, group]; strings packed into blob in record order as
// cigar\0md\0xa\0.  `group` is the read index (SE) or pair index (PE).
void mp_get_records(void* h, int64_t* fields, char* blob) {
  MemPipe& mp = *static_cast<MemPipe*>(h);
  int64_t k = 0;
  char* p = blob;
  for (int64_t ri = 0; ri < mp.n_reads; ++ri) {
    for (const auto& r : mp.per[ri].records) {
      int64_t* f = fields + k * 16;
      f[0] = r.src_read;
      f[1] = r.flag;
      f[2] = r.rid;
      f[3] = r.pos;
      f[4] = r.mapq;
      f[5] = r.nm;
      f[6] = r.score;
      f[7] = r.sub;
      f[8] = r.is_rev ? 1 : 0;
      f[9] = (int64_t)r.cigar.size();
      f[10] = (int64_t)r.md.size();
      f[11] = (int64_t)r.xa.size();
      f[12] = r.mate_rid;
      f[13] = r.pnext0;
      f[14] = r.tlen;
      f[15] = ri;
      std::memcpy(p, r.cigar.c_str(), r.cigar.size() + 1);
      p += r.cigar.size() + 1;
      std::memcpy(p, r.md.c_str(), r.md.size() + 1);
      p += r.md.size() + 1;
      std::memcpy(p, r.xa.c_str(), r.xa.size() + 1);
      p += r.xa.size() + 1;
      ++k;
    }
  }
}

// PE support: run replay only (no records) and export the deduped,
// score-sorted regions per read.  Counts first, then rows.
int64_t mp_region_count(void* h, int64_t nthreads) {
  MemPipe& mp = *static_cast<MemPipe*>(h);
  int nt = std::max((int)nthreads, 1);
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    for (;;) {
      int64_t ri = next.fetch_add(1);
      if (ri >= mp.n_reads) break;
      replay_read(mp, ri, mp.per[ri]);
    }
  };
  if (nt == 1) {
    worker();
  } else {
    std::vector<std::thread> ths;
    for (int t = 0; t < nt; ++t) ths.emplace_back(worker);
    for (auto& t : ths) t.join();
  }
  int64_t n = 0;
  for (const auto& pr : mp.per) n += (int64_t)pr.regions.size();
  return n;
}

// rows: (n_regions, 10) int64
// [read_idx, rb, re, qb, qe, score, truesc, w, seedcov, seedlen0]
void mp_export_regions(void* h, int64_t* rows) {
  MemPipe& mp = *static_cast<MemPipe*>(h);
  int64_t k = 0;
  for (int64_t ri = 0; ri < mp.n_reads; ++ri) {
    for (const auto& r : mp.per[ri].regions) {
      int64_t* f = rows + k * 10;
      f[0] = ri;
      f[1] = r.rb;
      f[2] = r.re;
      f[3] = r.qb;
      f[4] = r.qe;
      f[5] = r.score;
      f[6] = r.truesc;
      f[7] = r.w;
      f[8] = r.seedcov;
      f[9] = r.seedlen0;
      ++k;
    }
  }
}

// ---- whole-line SAM emission ---------------------------------------
// The aln2sam seq/qual/tag assembly (bwa-0.7.8 mem_aln2sam, SURVEY §2.3)
// as complete SAM lines — byte-identical to the Python
// SamRecord.line() the oracle path renders (pinned by
// tests/test_native_pipe.py).  This removes the last per-record Python
// from the hot path: the host hands back one text blob per chunk.

static void sam_int(std::string& s, int64_t v) {
  char b[24];
  s.append(b, (size_t)snprintf(b, sizeof b, "%lld", (long long)v));
}

static const char kBase[5] = {'A', 'C', 'G', 'T', 'N'};

// S -> H at both cigar ends; returns (clip5, clip3), rewrites cig.
static void sam_hard_clip(std::string& cig, int64_t* c5, int64_t* c3) {
  *c5 = *c3 = 0;
  if (cig.empty() || cig == "*") return;
  size_t i = 0;
  while (i < cig.size() && isdigit((unsigned char)cig[i])) ++i;
  if (i < cig.size() && cig[i] == 'S') {
    *c5 = strtoll(cig.c_str(), nullptr, 10);
    cig[i] = 'H';
  }
  size_t j = cig.size() - 1;
  if (cig[j] == 'S' && j > i) {
    size_t k = j;
    while (k > 0 && isdigit((unsigned char)cig[k - 1])) --k;
    *c3 = strtoll(cig.c_str() + k, nullptr, 10);
    cig[j] = 'H';
  }
}

static void sam_emit_one(const MemPipe& mp, const RecordC& r,
                         const char* name, int64_t name_len,
                         const char* qual, int64_t qual_len,
                         std::string& s) {
  const uint8_t* rd = mp.reads + r.src_read * mp.L;
  int64_t ql = mp.qlen[r.src_read];
  s.append(name, (size_t)name_len);
  s.push_back('\t');
  sam_int(s, r.flag);
  s.push_back('\t');
  if (r.rid < 0) {  // unmapped: placed at the mate when paired
    if (r.mate_rid >= 0) {
      s.append(mp.ctg_name[r.mate_rid]);
      s.push_back('\t');
      sam_int(s, r.pnext0 + 1);
      s.append("\t0\t*\t=\t");
      sam_int(s, r.pnext0 + 1);
      s.append("\t0\t");
    } else {
      s.append("*\t0\t0\t*\t*\t0\t0\t");
    }
    for (int64_t j = 0; j < ql; ++j)
      s.push_back(kBase[std::min<int64_t>(rd[j], 4)]);
    s.push_back('\t');
    if (qual_len > 0)
      s.append(qual, (size_t)qual_len);
    else
      s.push_back('*');
    return;  // no tags on unmapped records
  }
  std::string cig = r.cigar;
  int64_t c5 = 0, c3 = 0;
  if (r.flag & 0x800) sam_hard_clip(cig, &c5, &c3);
  s.append(mp.ctg_name[r.rid]);
  s.push_back('\t');
  sam_int(s, r.pos + 1);
  s.push_back('\t');
  sam_int(s, r.mapq);
  s.push_back('\t');
  s.append(cig);
  s.push_back('\t');
  if (r.mate_rid >= 0) {
    if (r.mate_rid == r.rid)
      s.push_back('=');
    else
      s.append(mp.ctg_name[r.mate_rid]);
    s.push_back('\t');
    sam_int(s, r.pnext0 + 1);
    s.push_back('\t');
    sam_int(s, r.tlen);
  } else {
    s.append("*\t0\t0");
  }
  s.push_back('\t');
  // seq (revcomp when mapped reverse), hard-clip trimmed
  if (r.is_rev) {
    for (int64_t j = ql - 1 - c5; j >= c3; --j) {
      int64_t c = std::min<int64_t>(rd[j], 4);
      s.push_back(kBase[c < 4 ? 3 - c : 4]);
    }
  } else {
    for (int64_t j = c5; j < ql - c3; ++j)
      s.push_back(kBase[std::min<int64_t>(rd[j], 4)]);
  }
  s.push_back('\t');
  if (qual_len > 0) {
    if (r.is_rev)
      for (int64_t j = qual_len - 1 - c5; j >= c3; --j)
        s.push_back(qual[j]);
    else
      s.append(qual + c5, (size_t)(qual_len - c5 - c3));
  } else {
    s.push_back('*');
  }
  s.append("\tNM:i:");
  sam_int(s, r.nm);
  s.append("\tMD:Z:");
  s.append(r.md);
  if (r.sub >= 0) {
    s.append("\tXS:i:");
    sam_int(s, r.sub);
  }
  s.append("\tAS:i:");
  sam_int(s, r.score);
  if (!mp.rg_id.empty()) {
    s.append("\tRG:Z:");
    s.append(mp.rg_id);
  }
  if (!r.sa.empty()) {
    s.append("\tSA:Z:");
    s.append(r.sa);
  }
  if (!r.xa.empty()) {
    s.append("\tXA:Z:");
    s.append(r.xa);
  }
}

// Upper bound on mp_emit_sam's output size.  name_off: (n_reads+1)
// prefix offsets of the concatenated qname blob.
int64_t mp_sam_size(void* h, const int64_t* name_off) {
  MemPipe& mp = *static_cast<MemPipe*>(h);
  int64_t maxctg = 1;
  for (const auto& n : mp.ctg_name)
    maxctg = std::max<int64_t>(maxctg, (int64_t)n.size());
  int64_t tot = 0;
  for (const auto& pr : mp.per)
    for (const auto& r : pr.records)
      tot += (name_off[r.src_read + 1] - name_off[r.src_read]) +
             (int64_t)(r.cigar.size() + r.md.size() + r.xa.size() +
                       r.sa.size()) +
             2 * mp.qlen[r.src_read] + 2 * maxctg + 160 +
             (int64_t)mp.rg_id.size();
  return tot;
}

// Render every record as a complete SAM line.  names/name_off: qname
// blob per input read; quals/qual_off: phred blob or NULL (=> "*").
// out: >= mp_sam_size bytes; line_off: (nrec+1) byte offsets into out;
// group: (nrec) read/pair index of each line (mp_get_records f[15]).
// newline != 0 appends '\n' to every line (the blob is then directly
// streamable; size the buffer with mp_sam_size + nrec).
void mp_emit_sam(void* h, const char* names, const int64_t* name_off,
                 const char* quals, const int64_t* qual_off, char* out,
                 int64_t* line_off, int64_t* group, int64_t nthreads,
                 int64_t newline) {
  MemPipe& mp = *static_cast<MemPipe*>(h);
  struct Ref {
    const RecordC* r;
    int64_t g;
  };
  std::vector<Ref> refs;
  for (int64_t ri = 0; ri < mp.n_reads; ++ri)
    for (const auto& r : mp.per[ri].records) refs.push_back({&r, ri});
  std::vector<std::string> lines(refs.size());
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= (int64_t)refs.size()) break;
      const RecordC& r = *refs[i].r;
      int64_t src = r.src_read;
      const char* q = nullptr;
      int64_t qn = 0;
      if (quals && qual_off) {
        q = quals + qual_off[src];
        qn = qual_off[src + 1] - qual_off[src];
      }
      lines[i].reserve(192);
      sam_emit_one(mp, r, names + name_off[src],
                   name_off[src + 1] - name_off[src], q, qn, lines[i]);
    }
  };
  int nt = std::max((int)nthreads, 1);
  if (nt == 1) {
    worker();
  } else {
    std::vector<std::thread> ths;
    for (int t = 0; t < nt; ++t) ths.emplace_back(worker);
    for (auto& t : ths) t.join();
  }
  int64_t off = 0;
  for (size_t i = 0; i < refs.size(); ++i) {
    line_off[i] = off;
    std::memcpy(out + off, lines[i].data(), lines[i].size());
    off += (int64_t)lines[i].size();
    if (newline) out[off++] = '\n';
    group[i] = refs[i].g;
  }
  line_off[refs.size()] = off;
}

// -R: set the read-group ID once per handle; every emitted record
// then carries RG:Z:<id> (bwa adds it in mem_aln2sam when -R has ID:).
void mp_set_rg(void* h, const char* id) {
  static_cast<MemPipe*>(h)->rg_id = id ? id : "";
}

void mp_chunk_end(void* h) {
  MemPipe& mp = *static_cast<MemPipe*>(h);
  mp.per.clear();
  mp.qlen.clear();
  mp.cur.clear();
  mp.rec_read.clear();
  mp.rescue_tasks.clear();
  mp.rescue_anchors.clear();
  mp.cig_tasks.clear();
  mp.cig_results.clear();
  mp.reads = nullptr;
  mp.n_reads = 0;
}

}  // extern "C"
