// CTC prefix beam-search decoder: host C++ of the port
// (vtd_tpu_torch/native/__init__.py builds it with g++ and binds it with
// ctypes).
//
// The CRNN gives per-timestep log-probabilities for every text crop of a
// batch; greedy collapse runs on the card (ops/ctc.py), but beam search
// is sequential per sample and branches on data, so it runs here on the
// host, with std::thread parallelism across the crop batch.
//
// Algorithm: standard CTC prefix beam search over (p_blank, p_non_blank)
// per prefix, with per-step top-K symbol pruning. The plain Python
// version it is held against is ctc_beam_decode_plain in __init__.py.
//
// C ABI:
//   ctc_beam_decode_batch(log_probs[B*T*V], B, T, V, beam_width,
//                         blank_id, out_ids[B*max_len], out_lens[B],
//                         out_scores[B], max_len, n_threads)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

constexpr float kNegInf = -1e30f;

inline float log_add(float a, float b) {
  if (a <= kNegInf) return b;
  if (b <= kNegInf) return a;
  float hi = a > b ? a : b;
  float lo = a > b ? b : a;
  return hi + std::log1p(std::exp(lo - hi));
}

struct Beam {
  std::vector<int32_t> prefix;
  float p_b;   // log prob of prefix ending in blank
  float p_nb;  // log prob of prefix ending in non-blank
  float total() const { return log_add(p_b, p_nb); }
};

struct PrefixHash {
  size_t operator()(const std::vector<int32_t>& v) const {
    size_t h = 1469598103934665603ull;
    for (int32_t x : v) {
      h ^= static_cast<size_t>(x) + 0x9e3779b97f4a7c15ull + (h << 6) + (h >> 2);
    }
    return h;
  }
};

void decode_one(const float* lp, int T, int V, int beam_width, int blank,
                int32_t* out_ids, int32_t* out_len, float* out_score,
                int max_len) {
  std::vector<Beam> beams;
  beams.push_back({{}, 0.0f, kNegInf});

  std::vector<int> symbols(V);
  const int prune = std::min(V, std::max(beam_width * 2, 8));

  for (int t = 0; t < T; ++t) {
    const float* row = lp + static_cast<size_t>(t) * V;

    // top-`prune` symbols this step
    for (int v = 0; v < V; ++v) symbols[v] = v;
    std::partial_sort(symbols.begin(), symbols.begin() + prune, symbols.end(),
                      [&](int a, int b) { return row[a] > row[b]; });

    std::unordered_map<std::vector<int32_t>, Beam, PrefixHash> next;
    next.reserve(beams.size() * (prune + 1));

    auto upsert = [&](const std::vector<int32_t>& prefix, float add_b,
                      float add_nb) {
      auto it = next.find(prefix);
      if (it == next.end()) {
        next.emplace(prefix, Beam{prefix, add_b, add_nb});
      } else {
        it->second.p_b = log_add(it->second.p_b, add_b);
        it->second.p_nb = log_add(it->second.p_nb, add_nb);
      }
    };

    for (const Beam& bm : beams) {
      const int32_t last =
          bm.prefix.empty() ? -1 : bm.prefix.back();
      // blank extends: prefix unchanged, ends in blank
      upsert(bm.prefix, bm.total() + row[blank], kNegInf);

      for (int si = 0; si < prune; ++si) {
        const int s = symbols[si];
        if (s == blank) continue;
        const float p = row[s];
        if (s == last) {
          // repeat: same prefix only from blank-ending; extended prefix
          // from non-blank-ending collapses
          upsert(bm.prefix, kNegInf, bm.p_nb + p);
          std::vector<int32_t> ext = bm.prefix;
          ext.push_back(s);
          upsert(ext, kNegInf, bm.p_b + p);
        } else {
          std::vector<int32_t> ext = bm.prefix;
          ext.push_back(s);
          upsert(ext, kNegInf, bm.total() + p);
        }
      }
    }

    beams.clear();
    beams.reserve(next.size());
    for (auto& kv : next) beams.push_back(std::move(kv.second));
    const size_t keep =
        std::min(static_cast<size_t>(beam_width), beams.size());
    std::partial_sort(
        beams.begin(), beams.begin() + keep, beams.end(),
        [](const Beam& a, const Beam& b) { return a.total() > b.total(); });
    beams.resize(keep);
  }

  const Beam& best = beams.front();
  const int n = std::min<int>(best.prefix.size(), max_len);
  std::memcpy(out_ids, best.prefix.data(), n * sizeof(int32_t));
  *out_len = n;
  *out_score = best.total();
}

}  // namespace

extern "C" {

void ctc_beam_decode_batch(const float* log_probs, int B, int T, int V,
                           int beam_width, int blank, int32_t* out_ids,
                           int32_t* out_lens, float* out_scores, int max_len,
                           int n_threads) {
  if (n_threads < 1) n_threads = 1;
  auto work = [&](int start, int stride) {
    for (int b = start; b < B; b += stride) {
      decode_one(log_probs + static_cast<size_t>(b) * T * V, T, V, beam_width,
                 blank, out_ids + static_cast<size_t>(b) * max_len,
                 out_lens + b, out_scores + b, max_len);
    }
  };
  if (n_threads == 1 || B <= 1) {
    work(0, 1);
    return;
  }
  std::vector<std::thread> threads;
  const int nt = std::min(n_threads, B);
  threads.reserve(nt);
  for (int i = 0; i < nt; ++i) threads.emplace_back(work, i, nt);
  for (auto& th : threads) th.join();
}

int vtd_native_abi_version() { return 1; }

}  // extern "C"
