// stvd native metrics core.
//
// The reference's evaluation pipeline shells out to Java (METEOR jar,
// PTBTokenizer) for its host-side scoring (SURVEY.md §2 row 11).  Our
// pure-Python scorers replace those; this C++ core accelerates the two
// quadratic host-side kernels that dominate validation-round wall clock
// while the device sits idle:
//
//   * lcs_len        — ROUGE-L longest-common-subsequence DP
//   * meteor_align   — staged unigram alignment (exact -> stem ->
//                      synonym-class) + chunk counting
//
// Tokens arrive as int32 ids (Python interns strings -> ids); the
// synonym stage matches on a caller-provided equivalence-class id per
// token (wordnet synset class, or -1 for none).
//
// C ABI only — loaded via ctypes (no pybind11 in this image).

#include <algorithm>
#include <array>
#include <cstdint>
#include <cstring>
#include <functional>
#include <unordered_map>
#include <vector>

extern "C" {

// Longest common subsequence length between a[0..na) and b[0..nb).
// Single-row DP, O(na*nb) time, O(nb) space.
int32_t stvd_lcs_len(const int32_t* a, int32_t na,
                     const int32_t* b, int32_t nb) {
  if (na <= 0 || nb <= 0) return 0;
  std::vector<int32_t> prev(nb + 1, 0), cur(nb + 1, 0);
  for (int32_t i = 0; i < na; ++i) {
    cur[0] = 0;
    const int32_t ai = a[i];
    for (int32_t j = 1; j <= nb; ++j) {
      cur[j] = (ai == b[j - 1])
                   ? prev[j - 1] + 1
                   : (prev[j] > cur[j - 1] ? prev[j] : cur[j - 1]);
    }
    std::swap(prev, cur);
  }
  return prev[nb];
}

// Batched LCS: m hypotheses against their reference blocks.
// hyp_tok / ref_tok are flattened with offset arrays (CSR style).
void stvd_lcs_batch(const int32_t* hyp_tok, const int32_t* hyp_off,
                    const int32_t* ref_tok, const int32_t* ref_off,
                    int32_t n_pairs, const int32_t* pair_hyp,
                    const int32_t* pair_ref, int32_t* out) {
  for (int32_t p = 0; p < n_pairs; ++p) {
    const int32_t h = pair_hyp[p], r = pair_ref[p];
    out[p] = stvd_lcs_len(hyp_tok + hyp_off[h], hyp_off[h + 1] - hyp_off[h],
                          ref_tok + ref_off[r], ref_off[r + 1] - ref_off[r]);
  }
}

// METEOR alignment — the jar's resolution algorithm (Denkowski &
// Lavie 2011): beam search (width 40) over hypothesis positions
// selecting the non-conflicting match subset that 1. maximizes word
// coverage, 2. minimizes chunk count, 3. minimizes total
// |hyp_pos - ref_pos|.  Mirrors stvd/metrics/meteor.py:_resolve_beam
// EXACTLY, including tie-breaks: states expand in beam order, skip
// before matches, candidates in ascending ref position; an
// equal-valued state never replaces an earlier arrival; the per-level
// prune is a stable sort by (coverage desc, chunks asc, dist asc).
//
// hyp / ref: surface-form ids.  hyp_stem / ref_stem: Porter-stem ids.
// hyp_syn / ref_syn: synonym-class ids (-1 = no class; stage skipped
// for such tokens).  A candidate (i, j) carries the highest-precedence
// stage matching it (exact < stem < synonym).
//
// Inputs longer than 62 tokens (ref) are unsupported (the used-set
// must fit a 64-bit mask): *m_out = -1 signals the caller, mirroring
// stvd_meteor_align_pairs' npairs = -1.  The Python wrapper routes
// such pairs to the pure-Python resolver before calling in.
//
// Outputs: *m = matches, *chunks = contiguous-run count.

static const int32_t kMeteorBeam = 40;

struct BeamState {
  uint64_t used;           // ref positions consumed
  int32_t pi, pj;          // last matched (hyp, ref) position, -2 = none
  int32_t m, ch, dist;     // coverage, chunks, total |i-j|
};

// strictly better by (coverage desc, chunks asc, distance asc)
static inline bool beam_better(const BeamState& a, const BeamState& b) {
  if (a.m != b.m) return a.m > b.m;
  if (a.ch != b.ch) return a.ch < b.ch;
  return a.dist < b.dist;
}

// per appended state: which pruned state of the previous level it came
// from, and the match taken at this level (j = -1 for skip)
struct BeamRec {
  int32_t parent;
  int32_t j;
  int8_t stage;
};

static void beam_align(const int32_t* hyp, const int32_t* hyp_stem,
                       const int32_t* hyp_syn, int32_t nh,
                       const int32_t* ref, const int32_t* ref_stem,
                       const int32_t* ref_syn, int32_t nr,
                       int32_t* m_out, int32_t* chunks_out,
                       int32_t* pairs_out, int32_t* npairs_out) {
  // candidates per hyp position: (ref position, stage), j ascending;
  // stage = the highest-precedence module matching (exact<stem<syn)
  std::vector<std::vector<std::pair<int32_t, int8_t>>> cand(nh);
  for (int32_t i = 0; i < nh; ++i) {
    for (int32_t j = 0; j < nr; ++j) {
      int8_t stage = -1;
      if (hyp[i] == ref[j]) stage = 0;
      else if (hyp_stem[i] == ref_stem[j]) stage = 1;
      else if (hyp_syn && ref_syn && hyp_syn[i] >= 0 &&
               hyp_syn[i] == ref_syn[j]) stage = 2;
      if (stage >= 0) cand[i].emplace_back(j, stage);
    }
  }

  std::vector<BeamState> cur;
  cur.push_back(BeamState{0, -2, -2, 0, 0, 0});
  std::vector<BeamState> next;
  std::vector<BeamRec> nrec;                     // parallel to `next`
  std::vector<std::vector<BeamRec>> recs(nh);    // per level, pruned order
  // dedup map: (used, pi+2, pj+2) -> index into `next`
  struct Key {
    uint64_t used;
    uint32_t pp;
    bool operator==(const Key& o) const {
      return used == o.used && pp == o.pp;
    }
  };
  struct KeyHash {
    size_t operator()(const Key& k) const {
      return std::hash<uint64_t>()(
          (k.used ^ (uint64_t(k.pp) << 48)) * 0x9e3779b97f4a7c15ull);
    }
  };
  std::unordered_map<Key, size_t, KeyHash> seen;

  for (int32_t i = 0; i < nh; ++i) {
    next.clear();
    nrec.clear();
    seen.clear();
    auto consider = [&](const BeamState& s, const BeamRec& r) {
      const Key k{s.used, uint32_t(s.pi + 2) << 8 | uint32_t(s.pj + 2)};
      auto it = seen.find(k);
      if (it == seen.end()) {
        seen.emplace(k, next.size());
        next.push_back(s);
        nrec.push_back(r);
      } else if (beam_better(s, next[it->second])) {
        next[it->second] = s;
        nrec[it->second] = r;
      }
    };
    for (size_t si = 0; si < cur.size(); ++si) {
      const BeamState s = cur[si];
      consider(s, BeamRec{int32_t(si), -1, -1});   // skip hyp position i
      for (auto [j, stage] : cand[i]) {
        if (s.used >> j & 1) continue;
        BeamState t = s;
        t.used |= uint64_t(1) << j;
        t.ch += (s.pi == i - 1 && s.pj == j - 1) ? 0 : 1;
        t.pi = i;
        t.pj = j;
        t.m += 1;
        t.dist += i > j ? i - j : j - i;
        consider(t, BeamRec{int32_t(si), j, stage});
      }
    }
    // stable prune: sort indices so the parallel records reorder too
    std::vector<int32_t> order(next.size());
    for (size_t k = 0; k < order.size(); ++k) order[k] = int32_t(k);
    std::stable_sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
      return beam_better(next[a], next[b]);
    });
    const size_t keep = std::min(order.size(), size_t(kMeteorBeam));
    std::vector<BeamState> pruned(keep);
    recs[i].resize(keep);
    for (size_t k = 0; k < keep; ++k) {
      pruned[k] = next[order[k]];
      recs[i][k] = nrec[order[k]];
    }
    cur.swap(pruned);
  }
  *m_out = cur[0].m;
  *chunks_out = cur[0].ch;
  if (pairs_out && npairs_out) {
    // walk parents back from the winning state, emit (i, j, stage)
    int32_t n = 0;
    int32_t idx = 0;
    std::vector<std::array<int32_t, 3>> rev;
    for (int32_t i = nh - 1; i >= 0; --i) {
      const BeamRec& r = recs[i][idx];
      if (r.j >= 0) rev.push_back({i, r.j, int32_t(r.stage)});
      idx = r.parent;
    }
    for (auto it = rev.rbegin(); it != rev.rend(); ++it, ++n) {
      pairs_out[n * 3 + 0] = (*it)[0];
      pairs_out[n * 3 + 1] = (*it)[1];
      pairs_out[n * 3 + 2] = (*it)[2];
    }
    *npairs_out = n;
  }
}

void stvd_meteor_align(const int32_t* hyp, const int32_t* hyp_stem,
                       const int32_t* hyp_syn, int32_t nh,
                       const int32_t* ref, const int32_t* ref_stem,
                       const int32_t* ref_syn, int32_t nr,
                       int32_t* m_out, int32_t* chunks_out) {
  if (nr > 62) {
    // Unsupported shape (used-set must fit a 64-bit mask): signal the
    // caller instead of silently degrading to a different resolver.
    // Python wrappers pre-filter len(ref) > 62 to the pure-Python beam.
    *m_out = -1;
    *chunks_out = 0;
    return;
  }
  beam_align(hyp, hyp_stem, hyp_syn, nh, ref, ref_stem, ref_syn, nr,
             m_out, chunks_out, nullptr, nullptr);
}

// Pairs-returning variant for the weighted (METEOR-1.5) scorer:
// pairs_out must hold nh*3 int32 (i, j, stage triples, hyp order).
// *npairs_out = -1 signals an unsupported shape (ref > 62 tokens);
// the Python caller resolves those pairs in pure Python.
void stvd_meteor_align_pairs(const int32_t* hyp, const int32_t* hyp_stem,
                             const int32_t* hyp_syn, int32_t nh,
                             const int32_t* ref, const int32_t* ref_stem,
                             const int32_t* ref_syn, int32_t nr,
                             int32_t* pairs_out, int32_t* npairs_out,
                             int32_t* m_out, int32_t* chunks_out) {
  if (nr > 62) {
    *npairs_out = -1;
    *m_out = 0;
    *chunks_out = 0;
    return;
  }
  beam_align(hyp, hyp_stem, hyp_syn, nh, ref, ref_stem, ref_syn, nr,
             m_out, chunks_out, pairs_out, npairs_out);
}

// Clipped n-gram match counting for corpus BLEU (one hypothesis vs its
// reference block), n = 1..4.  n-grams are hashed into 64-bit keys
// (tokens are <2^21 in practice; 4 tokens * 16 bits would overflow, so
// use a rolling 64-bit mix).  Open-addressing table sized per call.
static inline uint64_t mix(uint64_t h, uint64_t x) {
  h ^= x + 0x9e3779b97f4a7c15ull + (h << 6) + (h >> 2);
  return h;
}

// splitmix64 finalizer: low bits must avalanche (adjacent token ids
// otherwise collide once a low bit is reserved for table bookkeeping).
static inline uint64_t fin(uint64_t x) {
  x ^= x >> 30; x *= 0xbf58476d1ce4e5b9ull;
  x ^= x >> 27; x *= 0x94d049bb133111ebull;
  x ^= x >> 31;
  return x;
}

void stvd_bleu_stats(const int32_t* hyp, int32_t nh,
                     const int32_t* ref_tok, const int32_t* ref_off,
                     int32_t n_refs,
                     int64_t* match_out /*[4]*/, int64_t* total_out /*[4]*/,
                     int32_t* closest_len_out) {
  // closest reference length (ties -> shorter), COCO convention
  int32_t best_len = 0;
  int64_t best_key = INT64_MAX;
  for (int32_t r = 0; r < n_refs; ++r) {
    const int32_t rl = ref_off[r + 1] - ref_off[r];
    const int64_t diff = rl > nh ? rl - nh : nh - rl;
    const int64_t key = diff * 1000000 + rl;
    if (key < best_key) { best_key = key; best_len = rl; }
  }
  *closest_len_out = best_len;

  for (int n = 1; n <= 4; ++n) {
    const int ni = n - 1;
    const int32_t hcount = nh - n + 1;
    if (hcount <= 0) { match_out[ni] = 0; total_out[ni] = 0; continue; }
    total_out[ni] = hcount;

    // hash map: key -> (hyp count, max ref count); occ marks live slots
    struct Slot { uint64_t key; int32_t hc, rc; int8_t occ; };
    const int32_t cap_hint = hcount * 4 + 64;
    std::vector<Slot> table(cap_hint, Slot{0, 0, 0, 0});
    auto find = [&](uint64_t key) -> Slot* {
      size_t idx = key % table.size();
      for (;;) {
        Slot& s = table[idx];
        if (!s.occ) { s.occ = 1; s.key = key; return &s; }
        if (s.key == key) return &s;
        idx = (idx + 1) % table.size();
      }
    };
    // lookup WITHOUT inserting: the table is sized for hypothesis
    // n-grams only; reference-side folding must not grow it (40+ refs
    // per video would overflow it and wedge the linear probe)
    auto lookup = [&](uint64_t key) -> Slot* {
      size_t idx = key % table.size();
      for (;;) {
        Slot& s = table[idx];
        if (!s.occ) return nullptr;
        if (s.key == key) return &s;
        idx = (idx + 1) % table.size();
      }
    };
    auto ngram_key = [&](const int32_t* t, int32_t pos) -> uint64_t {
      uint64_t h = 1469598103934665603ull;
      for (int k = 0; k < n; ++k) h = mix(h, (uint64_t)(t[pos + k] + 1));
      return fin(h);
    };

    for (int32_t i = 0; i < hcount; ++i) find(ngram_key(hyp, i))->hc++;
    for (int32_t r = 0; r < n_refs; ++r) {
      const int32_t rl = ref_off[r + 1] - ref_off[r];
      const int32_t* rt = ref_tok + ref_off[r];
      if (rl - n + 1 <= 0) continue;
      // per-ref counts: use a local map, then fold max into table
      std::vector<Slot> local((rl - n + 1) * 4 + 64, Slot{0, 0, 0, 0});
      auto lfind = [&](uint64_t key) -> Slot* {
        size_t idx = key % local.size();
        for (;;) {
          Slot& s = local[idx];
          if (!s.occ) { s.occ = 1; s.key = key; return &s; }
          if (s.key == key) return &s;
          idx = (idx + 1) % local.size();
        }
      };
      for (int32_t i = 0; i + n <= rl; ++i) lfind(ngram_key(rt, i))->hc++;
      for (const Slot& s : local) {
        if (!s.occ) continue;
        Slot* g = lookup(s.key);  // ref-only n-grams never clip anything
        if (g && s.hc > g->rc) g->rc = s.hc;
      }
    }
    int64_t matched = 0;
    for (const Slot& s : table) {
      if (!s.occ || s.hc == 0) continue;
      matched += s.hc < s.rc ? s.hc : s.rc;
    }
    match_out[ni] = matched;
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// CIDEr-D corpus scorer.
//
// Token ids arrive interned (CSR layout).  For each n in 1..4:
//   df[g]   = number of videos whose reference set contains gram g
//   weights = count * (log(N) - log(max(df,1)))
//   sim     = sum_g min(wh, wr) * wr / (|wh||wr|)   (CIDEr-D clipping)
//   penalty = exp(-(lh-lr)^2 / (2 sigma^2))
// score(video) = 10 * mean_refs( mean_n( sim * penalty ) )
// Matches stvd/metrics/cider.py (fuzz-tested).
// ---------------------------------------------------------------------------

#include <cmath>
#include <unordered_map>

namespace {

struct GramCounts {
  std::unordered_map<uint64_t, int32_t> c;
  int32_t len = 0;  // token count
};

inline uint64_t cider_key(const int32_t* t, int32_t pos, int n) {
  uint64_t h = 1469598103934665603ull;
  for (int k = 0; k < n; ++k) h = mix(h, (uint64_t)(t[pos + k] + 1));
  return fin(h);
}

void count_grams(const int32_t* tok, int32_t len, int n, GramCounts* out) {
  out->len = len;
  for (int32_t i = 0; i + n <= len; ++i) out->c[cider_key(tok, i, n)]++;
}

}  // namespace

extern "C" void stvd_cider(
    const int32_t* hyp_tok, const int32_t* hyp_off,
    const int32_t* ref_tok, const int32_t* ref_off,
    const int32_t* vid_ref_off,  // per-video [start, end) into refs
    int32_t n_vid, double sigma, double* out_scores) {
  const double log_n = std::log(std::max(n_vid, 1));
  for (int n = 1; n <= 4; ++n) {
    // document frequency over videos
    std::unordered_map<uint64_t, int32_t> df;
    for (int32_t v = 0; v < n_vid; ++v) {
      std::unordered_map<uint64_t, int32_t> seen;
      for (int32_t r = vid_ref_off[v]; r < vid_ref_off[v + 1]; ++r) {
        const int32_t rl = ref_off[r + 1] - ref_off[r];
        for (int32_t i = 0; i + n <= rl; ++i)
          seen.emplace(cider_key(ref_tok + ref_off[r], i, n), 1);
      }
      for (auto& kv : seen) df[kv.first]++;
    }
    auto idf = [&](uint64_t g) {
      auto it = df.find(g);
      const double d = it == df.end() ? 1.0 : std::max(it->second, 1);
      return log_n - std::log(d);
    };
    for (int32_t v = 0; v < n_vid; ++v) {
      GramCounts hc;
      count_grams(hyp_tok + hyp_off[v], hyp_off[v + 1] - hyp_off[v], n, &hc);
      double hnorm2 = 0.0;
      for (auto& kv : hc.c) {
        const double w = kv.second * idf(kv.first);
        hnorm2 += w * w;
      }
      const double hnorm = std::sqrt(hnorm2);
      const int32_t n_refs = vid_ref_off[v + 1] - vid_ref_off[v];
      double acc = 0.0;
      for (int32_t r = vid_ref_off[v]; r < vid_ref_off[v + 1]; ++r) {
        GramCounts rc;
        count_grams(ref_tok + ref_off[r], ref_off[r + 1] - ref_off[r], n, &rc);
        double rnorm2 = 0.0;
        for (auto& kv : rc.c) {
          const double w = kv.second * idf(kv.first);
          rnorm2 += w * w;
        }
        const double rnorm = std::sqrt(rnorm2);
        double dot = 0.0;
        for (auto& kv : hc.c) {
          auto it = rc.c.find(kv.first);
          if (it == rc.c.end()) continue;
          const double i = idf(kv.first);
          const double wh = kv.second * i, wr = it->second * i;
          dot += (wh < wr ? wh : wr) * wr;
        }
        double sim = (hnorm > 0.0 && rnorm > 0.0) ? dot / (hnorm * rnorm)
                                                  : 0.0;
        const double delta = (double)hc.len - (double)rc.len;
        sim *= std::exp(-(delta * delta) / (2.0 * sigma * sigma));
        acc += sim;
      }
      // accumulate mean over refs for this n; caller divides by 4 via
      // the running sum here (add each n's contribution)
      out_scores[v] += 10.0 * (n_refs > 0 ? acc / n_refs : 0.0) / 4.0;
    }
  }
}

// ---------------------------------------------------------------------------
// METEOR corpus driver: per-video best-reference alignment statistics.
// Reuses stvd_meteor_align per pair; 'best' = highest segment score
// under (alpha, beta, gamma), ties to fewer chunks — mirrors
// stvd/metrics/meteor.py:_segment_stats exactly.
// out_stats: n_vid * 4 ints: [matches, hyp_len, ref_len, chunks].
// ---------------------------------------------------------------------------

namespace {

double meteor_pair_score(int32_t m, int32_t hlen, int32_t rlen,
                         int32_t chunks, double alpha, double beta,
                         double gamma) {
  if (m == 0 || hlen == 0 || rlen == 0) return 0.0;
  const double p = (double)m / hlen, r = (double)m / rlen;
  const double f = p * r / (alpha * p + (1.0 - alpha) * r);
  const double frag = (double)chunks / m;
  const double penalty = chunks > 0 ? gamma * std::pow(frag, beta) : 0.0;
  return f * (1.0 - penalty);
}

}  // namespace

extern "C" void stvd_meteor_corpus(
    const int32_t* hyp_tok, const int32_t* hyp_stem, const int32_t* hyp_off,
    const int32_t* ref_tok, const int32_t* ref_stem, const int32_t* ref_off,
    const int32_t* vid_ref_off, int32_t n_vid,
    double alpha, double beta, double gamma, int32_t* out_stats) {
  for (int32_t v = 0; v < n_vid; ++v) {
    const int32_t nh = hyp_off[v + 1] - hyp_off[v];
    const int32_t* h = hyp_tok + hyp_off[v];
    const int32_t* hs = hyp_stem + hyp_off[v];
    int32_t best[4] = {0, nh, 0, 0};
    double best_score = -1.0;
    for (int32_t r = vid_ref_off[v]; r < vid_ref_off[v + 1]; ++r) {
      const int32_t nr = ref_off[r + 1] - ref_off[r];
      int32_t m = 0, chunks = 0;
      stvd_meteor_align(h, hs, nullptr, nh,
                        ref_tok + ref_off[r], ref_stem + ref_off[r],
                        nullptr, nr, &m, &chunks);
      if (m < 0) continue;  // >62-token ref: unsupported, skip (the
                            // Python wrapper pre-filters these)
      const double s = meteor_pair_score(m, nh, nr, chunks, alpha, beta,
                                         gamma);
      if (s > best_score ||
          (s == best_score && best_score >= 0.0 && chunks < best[3])) {
        best_score = s;
        best[0] = m; best[1] = nh; best[2] = nr; best[3] = chunks;
      }
    }
    for (int k = 0; k < 4; ++k) out_stats[v * 4 + k] = best[k];
  }
}
