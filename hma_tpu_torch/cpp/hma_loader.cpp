// Native data loader of hma_tpu_torch: mmap token datasets + MaskGIT
// collation with prefetch threads.
//
// The replacement for the reference's torch DataLoader worker processes
// (hma/train_multi.py:948, torch C++ dataloader machinery): the hot
// host-side path — windowed memmap reads, base-512 factorization,
// Copilot4D corruption, non-MLM prefix masking, and cosine-scheduled
// MaskGIT masking (semantics of hma/data.py:28-95) — runs in C++ worker
// threads feeding an ordered prefetch buffer, so the device never waits on
// Python.
//
// Determinism contract: batch i is a pure function of (seed, i), and
// delivery is strictly in index order regardless of thread scheduling —
// the same contract the torch DataLoader gives the reference (worker
// results are returned in sampler order, hma/train_multi.py:948). This
// makes native-loader training runs reproducible and makes resume
// exact: a loader created with start_index=k yields exactly batches
// k, k+1, ... of a fresh run's sequence. All random draws use fixed
// algorithms (uni01/bounded below), never std::uniform_*_distribution,
// so the stream survives compiler/stdlib upgrades between rebuilds.
//
// C ABI (used via ctypes from hma_tpu_torch/data/native_loader.py):
//   hma_loader_create(...)        -> opaque handle
//   hma_loader_next(handle, ...)  -> blocking copy of one batch
//   hma_loader_destroy(handle)
//
// Build (native_loader.py does it at first use, into build/hma_tpu_torch/):
//   g++ -O3 -std=c++17 -shared -fPIC -o libhma_loader.so hma_loader.cpp -lpthread

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <functional>
#include <map>
#include <memory>
#include <mutex>
#include <random>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

constexpr double kPi = 3.14159265358979323846;

struct Mmap {
  void* data = nullptr;
  size_t size = 0;
  bool open(const char* path) {
    int fd = ::open(path, O_RDONLY);
    if (fd < 0) return false;
    struct stat st;
    if (fstat(fd, &st) != 0) { close(fd); return false; }
    size = st.st_size;
    data = mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
    close(fd);
    return data != MAP_FAILED;
  }
  ~Mmap() { if (data && data != MAP_FAILED) munmap(data, size); }
};

struct Batch {
  std::vector<int32_t> input_ids;  // B * T * S
  std::vector<int32_t> labels;     // B * T * S
  std::vector<float> actions;      // B * T * action_width (may be empty)
};

// Toolchain-stable draws. std::uniform_{int,real}_distribution algorithms
// are implementation-defined, so the (seed, i) stream — and with it the
// bit-exact resume contract — would silently change across stdlib
// versions when libhma_loader.so is rebuilt. These fixed forms pin the
// stream to the mt19937_64 output alone.
inline double uni01(std::mt19937_64& rng) {
  // 53-bit mantissa uniform in [0, 1)
  return (double)(rng() >> 11) * (1.0 / 9007199254740992.0);
}
inline uint64_t bounded(std::mt19937_64& rng, uint64_t n) {
  // Lemire's nearly-divisionless unbiased bounded draw in [0, n)
  unsigned __int128 m = (unsigned __int128)rng() * n;
  uint64_t lo = (uint64_t)m;
  if (lo < n) {
    uint64_t t = (0 - n) % n;
    while (lo < t) {
      m = (unsigned __int128)rng() * n;
      lo = (uint64_t)m;
    }
  }
  return (uint64_t)(m >> 64);
}

// fp16 -> fp32 (portable bit-twiddle; the latent files are float16)
inline float half_to_float(uint16_t h) {
  uint32_t sign = (uint32_t)(h >> 15) << 31;
  uint32_t exp = (h >> 10) & 0x1f;
  uint32_t man = h & 0x3ff;
  uint32_t bits;
  if (exp == 0) {
    if (man == 0) {
      bits = sign;
    } else {  // subnormal: renormalize
      int shift = 0;
      while (!(man & 0x400)) { man <<= 1; ++shift; }
      man &= 0x3ff;
      bits = sign | ((127 - 15 - shift + 1) << 23) | (man << 13);
    }
  } else if (exp == 31) {
    bits = sign | 0x7f800000 | (man << 13);  // inf / nan
  } else {
    bits = sign | ((exp - 15 + 127) << 23) | (man << 13);
  }
  float f;
  std::memcpy(&f, &bits, 4);
  return f;
}

// Deterministic ordered prefetcher. Workers atomically claim batch
// indices, compute each batch with a PRNG derived purely from
// (seed, index), and park results in a reorder buffer; next() emits
// strictly in index order. Thread count affects throughput only, never
// the delivered sequence. The buffer is bounded by `depth` (a worker
// holding batch i blocks until i < next_emit + depth), so memory stays
// O(depth + num_threads) batches, same as the old bounded queue.
template <typename T>
class OrderedPrefetcher {
 public:
  using CollateFn = std::function<void(std::mt19937_64&, T*)>;

  OrderedPrefetcher(uint64_t seed, int64_t start_index, int num_threads,
                    int depth, CollateFn fn)
      : seed_(seed), depth_(depth < 1 ? 1 : depth), fn_(std::move(fn)),
        next_claim_(start_index), next_emit_(start_index) {
    for (int i = 0; i < (num_threads < 1 ? 1 : num_threads); ++i)
      workers_.emplace_back([this] { worker(); });
  }

  ~OrderedPrefetcher() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : workers_) t.join();
  }

  bool next(T* out) {
    std::unique_lock<std::mutex> lk(mu_);
    cv_.wait(lk, [this] { return stop_ || ready_.count(next_emit_) != 0; });
    auto it = ready_.find(next_emit_);
    if (it == ready_.end()) return false;  // stopped
    *out = std::move(it->second);
    ready_.erase(it);
    ++next_emit_;
    lk.unlock();
    cv_.notify_all();  // wake workers blocked on the depth bound
    return true;
  }

 private:
  void worker() {
    for (;;) {
      int64_t i;
      {
        std::lock_guard<std::mutex> lk(mu_);
        if (stop_) return;
        i = next_claim_++;
      }
      // splitmix64 finalizer over (seed, index): adjacent indices get
      // decorrelated mt19937_64 seeds (a raw seed+i stream would hand
      // correlated initial states to neighboring batches).
      uint64_t z = seed_ + 0x9E3779B97F4A7C15ULL * (uint64_t)(i + 1);
      z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
      z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
      std::mt19937_64 rng(z ^ (z >> 31));
      T b;
      fn_(rng, &b);
      std::unique_lock<std::mutex> lk(mu_);
      cv_.wait(lk, [this, i] { return stop_ || i < next_emit_ + depth_; });
      if (stop_) return;
      ready_.emplace(i, std::move(b));
      lk.unlock();
      cv_.notify_all();
    }
  }

  const uint64_t seed_;
  const int64_t depth_;
  CollateFn fn_;
  std::mutex mu_;
  std::condition_variable cv_;
  std::map<int64_t, T> ready_;
  int64_t next_claim_;
  int64_t next_emit_;
  bool stop_ = false;
  std::vector<std::thread> workers_;
};

struct LoaderConfig {
  int64_t num_images;
  int h, w;
  int window_size;     // T
  int stride;
  int batch_size;
  int action_dim;      // per-frame action dim in the file (0 = no actions)
  int action_width;    // padded output width = action_dim * stride padded
  // collator knobs (reference: hma/config.py:34-40, hma/data.py:42-83)
  int mask_token_id;   // == image_vocab_size
  int factored_vocab_size;
  int num_factored_vocabs;
  double max_corrupt_rate;
  double non_mlm_ratio;
  int num_prompt_frames;
  double mask_ratio_min;
  int apply_corruption;
  int apply_mask;
  uint64_t seed;
  int num_threads;
  int queue_depth;
  int64_t start_index;  // first batch index to deliver (resume fast-forward)
};

// Valid window start indices: windows must not straddle segment
// boundaries (reference: hma/data.py:237-244). Shared by both loaders so
// the sampling rule cannot drift between the token and feature paths.
static std::vector<int64_t> compute_valid_starts(int64_t num_images,
                                                 int window_size, int stride,
                                                 bool has_segs,
                                                 const int32_t* segs) {
  std::vector<int64_t> out;
  int64_t video_len = (int64_t)(window_size - 1) * stride;
  int64_t n = num_images - video_len - stride;
  for (int64_t s = 0; s < n; ++s) {
    if (has_segs && segs[s] != segs[s + video_len]) continue;
    out.push_back(s);
  }
  return out;
}

class Loader {
 public:
  Loader(const LoaderConfig& cfg, const char* video_path,
         const char* seg_path, const char* actions_path)
      : cfg_(cfg) {
    ok_ = video_.open(video_path);
    if (seg_path && seg_path[0]) has_segs_ = segs_.open(seg_path);
    if (actions_path && actions_path[0]) has_actions_ = acts_.open(actions_path);
    if (!ok_) return;
    valid_starts_ = compute_valid_starts(cfg_.num_images, cfg_.window_size,
                                         cfg_.stride, has_segs_,
                                         has_segs_ ? segs() : nullptr);
    if (valid_starts_.empty()) { ok_ = false; return; }
    pf_ = std::make_unique<OrderedPrefetcher<Batch>>(
        cfg_.seed, cfg_.start_index, cfg_.num_threads, cfg_.queue_depth,
        [this](std::mt19937_64& rng, Batch* out) { collate(rng, out); });
  }

  bool ok() const { return ok_; }
  int64_t num_windows() const { return (int64_t)valid_starts_.size(); }

  bool next(int32_t* input_ids, int32_t* labels, float* actions) {
    Batch b;
    if (!pf_->next(&b)) return false;
    std::memcpy(input_ids, b.input_ids.data(), b.input_ids.size() * 4);
    std::memcpy(labels, b.labels.data(), b.labels.size() * 4);
    if (actions && !b.actions.empty())
      std::memcpy(actions, b.actions.data(), b.actions.size() * 4);
    return true;
  }

 private:
  const uint32_t* video() const { return (const uint32_t*)video_.data; }
  const int32_t* segs() const { return (const int32_t*)segs_.data; }
  const float* acts() const { return (const float*)acts_.data; }

  void collate(std::mt19937_64& rng, Batch* out) {
    const int T = cfg_.window_size, S = cfg_.h * cfg_.w, B = cfg_.batch_size;
    const int nv = cfg_.num_factored_vocabs, fv = cfg_.factored_vocab_size;
    const uint64_t n_starts = (uint64_t)valid_starts_.size();
    auto uni = [](std::mt19937_64& r) { return uni01(r); };
    auto pick = [&](std::mt19937_64& r) { return (int64_t)bounded(r, n_starts); };
    auto rand_tok = [&](std::mt19937_64& r) { return (int32_t)bounded(r, (uint64_t)fv); };

    out->input_ids.resize((size_t)B * T * S);
    out->labels.resize((size_t)B * T * S);
    if (has_actions_ && cfg_.action_width > 0)
      out->actions.assign((size_t)B * T * cfg_.action_width, 0.f);

    // gather windows
    std::vector<int32_t> factored((size_t)B * T * S * nv);
    for (int b = 0; b < B; ++b) {
      int64_t start = valid_starts_[pick(rng)];
      for (int t = 0; t < T; ++t) {
        int64_t frame = start + (int64_t)t * cfg_.stride;
        const uint32_t* src = video() + frame * S;
        int32_t* lab = out->labels.data() + ((size_t)b * T + t) * S;
        int32_t* fac = factored.data() + (((size_t)b * T + t) * S) * nv;
        for (int s = 0; s < S; ++s) {
          int32_t id = (int32_t)src[s];
          lab[s] = id;
          int32_t rem = id;
          for (int k = 0; k < nv; ++k) { fac[s * nv + k] = rem % fv; rem /= fv; }
        }
        if (has_actions_ && cfg_.action_width > 0) {
          // stride-concatenated raw actions (reference: hma/data.py:286-291)
          float* dst = out->actions.data() +
                       ((size_t)b * T + t) * cfg_.action_width;
          for (int j = 0; j < cfg_.stride; ++j) {
            const float* a = acts() + (frame + j) * cfg_.action_dim;
            std::memcpy(dst + j * cfg_.action_dim, a, cfg_.action_dim * 4);
          }
        }
      }
    }

    // Copilot4D-style uniform corruption (reference: hma/data.py:42-49)
    if (cfg_.apply_corruption) {
      double rate = cfg_.max_corrupt_rate * uni(rng);
      for (auto& v : factored)
        if (uni(rng) < rate) v = rand_tok(rng);
    }

    // non-MLM prefix branch (reference: hma/data.py:51-64)
    int first_masked_frame = 1;
    if (uni(rng) < cfg_.non_mlm_ratio) {
      int lo = std::min(cfg_.num_prompt_frames, T - 1);
      first_masked_frame = lo + (int)bounded(rng, (uint64_t)(T - lo));
      double correct = cfg_.mask_ratio_min +
                       uni(rng) * (1.0 - cfg_.mask_ratio_min);
      for (int t = first_masked_frame; t < T; ++t) {
        correct *= 0.9 + 0.1 * uni(rng);
        for (int b = 0; b < B; ++b) {
          int32_t* fac = factored.data() + (((size_t)b * T + t) * S) * nv;
          for (int i = 0; i < S * nv; ++i)
            if (uni(rng) > correct) fac[i] = rand_tok(rng);
        }
      }
    }

    // unfactorize + cosine-scheduled masking (reference: hma/data.py:68-83)
    bool any_masked = false;
    while (true) {
      for (int b = 0; b < B; ++b) {
        for (int t = 0; t < T; ++t) {
          int32_t* dst = out->input_ids.data() + ((size_t)b * T + t) * S;
          const int32_t* fac = factored.data() + (((size_t)b * T + t) * S) * nv;
          double mask_prob = (t >= first_masked_frame && cfg_.apply_mask)
                                 ? std::cos(uni(rng) * kPi / 2) : -1.0;
          for (int s = 0; s < S; ++s) {
            int32_t id = 0, mult = 1;
            for (int k = 0; k < nv; ++k) { id += fac[s * nv + k] * mult; mult *= fv; }
            if (mask_prob >= 0 && uni(rng) < mask_prob) {
              id = cfg_.mask_token_id;
              any_masked = true;
            }
            dst[s] = id;
          }
        }
      }
      if (any_masked || !cfg_.apply_mask) break;  // retry-if-nothing-masked
    }
  }

  LoaderConfig cfg_;
  Mmap video_, segs_, acts_;
  bool ok_ = false, has_segs_ = false, has_actions_ = false;
  std::vector<int64_t> valid_starts_;
  // declared last: its worker threads read the members above, so it must
  // be destroyed first (members destruct in reverse declaration order)
  std::unique_ptr<OrderedPrefetcher<Batch>> pf_;
};

// ---------------------------------------------------------------------------
// Continuous (feature/latent) loader: float16 (N, C, h, w) VAE latents ->
// (B, T, h, w, C) float32 x scale windows + masked_tokens_indicator,
// mirroring get_maskgit_collator_feature (reference: hma/data.py:103-157)
// and RawFeatureDataset's on-read SVD_SCALE multiply (hma/data.py:298-435).
// Masked positions are NOT substituted here — STMAR swaps in its learned
// latent mask token inside the model (hma_tpu_torch/models/st_mar.py).
// ---------------------------------------------------------------------------

struct FeatureBatch {
  std::vector<float> latents;   // B * T * h * w * C
  std::vector<float> labels;    // B * T * h * w * C
  std::vector<int32_t> mask;    // B * T * h * w
  std::vector<float> actions;   // B * T * action_width (may be empty)
};

struct FeatureConfig {
  int64_t num_images;
  int c, h, w;
  int window_size;  // T
  int stride;
  int batch_size;
  int action_dim;
  int action_width;
  double non_mlm_ratio;
  int num_prompt_frames;
  double mask_ratio_min;
  int apply_mask;
  double scale;  // SVD_SCALE
  uint64_t seed;
  int num_threads;
  int queue_depth;
  int64_t start_index;  // first batch index to deliver (resume fast-forward)
};

class FeatureLoader {
 public:
  FeatureLoader(const FeatureConfig& cfg, const char* video_path,
                const char* seg_path, const char* actions_path)
      : cfg_(cfg) {
    ok_ = video_.open(video_path);
    if (seg_path && seg_path[0]) has_segs_ = segs_.open(seg_path);
    if (actions_path && actions_path[0]) has_actions_ = acts_.open(actions_path);
    if (!ok_) return;
    valid_starts_ = compute_valid_starts(cfg_.num_images, cfg_.window_size,
                                         cfg_.stride, has_segs_,
                                         has_segs_ ? segs() : nullptr);
    if (valid_starts_.empty()) { ok_ = false; return; }
    pf_ = std::make_unique<OrderedPrefetcher<FeatureBatch>>(
        cfg_.seed, cfg_.start_index, cfg_.num_threads, cfg_.queue_depth,
        [this](std::mt19937_64& rng, FeatureBatch* out) { collate(rng, out); });
  }

  bool ok() const { return ok_; }
  int64_t num_windows() const { return (int64_t)valid_starts_.size(); }

  bool next(float* latents, float* labels, int32_t* mask, float* actions) {
    FeatureBatch b;
    if (!pf_->next(&b)) return false;
    std::memcpy(latents, b.latents.data(), b.latents.size() * 4);
    std::memcpy(labels, b.labels.data(), b.labels.size() * 4);
    std::memcpy(mask, b.mask.data(), b.mask.size() * 4);
    if (actions && !b.actions.empty())
      std::memcpy(actions, b.actions.data(), b.actions.size() * 4);
    return true;
  }

 private:
  const uint16_t* video() const { return (const uint16_t*)video_.data; }
  const int32_t* segs() const { return (const int32_t*)segs_.data; }
  const float* acts() const { return (const float*)acts_.data; }

  void collate(std::mt19937_64& rng, FeatureBatch* out) {
    const int T = cfg_.window_size, H = cfg_.h, W = cfg_.w, C = cfg_.c;
    const int B = cfg_.batch_size, S = H * W;
    const uint64_t n_starts = (uint64_t)valid_starts_.size();
    auto uni = [](std::mt19937_64& r) { return uni01(r); };
    auto pick = [&](std::mt19937_64& r) { return (int64_t)bounded(r, n_starts); };
    const float scale = (float)cfg_.scale;

    out->latents.resize((size_t)B * T * S * C);
    out->labels.resize((size_t)B * T * S * C);
    out->mask.assign((size_t)B * T * S, 0);
    if (has_actions_ && cfg_.action_width > 0)
      out->actions.assign((size_t)B * T * cfg_.action_width, 0.f);

    for (int b = 0; b < B; ++b) {
      int64_t start = valid_starts_[pick(rng)];
      for (int t = 0; t < T; ++t) {
        int64_t frame = start + (int64_t)t * cfg_.stride;
        // file layout (C, h, w) fp16 -> batch layout (h, w, C) fp32*scale
        const uint16_t* src = video() + frame * (int64_t)C * S;
        float* dst = out->latents.data() + (((size_t)b * T + t) * S) * C;
        for (int c = 0; c < C; ++c)
          for (int s = 0; s < S; ++s)
            dst[s * C + c] = half_to_float(src[c * S + s]) * scale;
        if (has_actions_ && cfg_.action_width > 0) {
          float* adst = out->actions.data() +
                        ((size_t)b * T + t) * cfg_.action_width;
          for (int j = 0; j < cfg_.stride; ++j) {
            const float* a = acts() + (frame + j) * cfg_.action_dim;
            std::memcpy(adst + j * cfg_.action_dim, a, cfg_.action_dim * 4);
          }
        }
      }
    }
    std::memcpy(out->labels.data(), out->latents.data(),
                out->latents.size() * 4);

    if (!cfg_.apply_mask) return;
    // non-MLM prefix branch then cosine-scheduled per-frame masking with
    // a mask_ratio_min floor; retry until >= 1 position masked
    // (reference: hma/data.py:120-143)
    int first_masked_frame = 1;
    if (uni(rng) < cfg_.non_mlm_ratio) {
      int lo = std::min(cfg_.num_prompt_frames, T - 1);
      first_masked_frame = lo + (int)bounded(rng, (uint64_t)(T - lo));
    }
    bool any = false;
    while (!any) {
      for (int b = 0; b < B; ++b) {
        for (int t = first_masked_frame; t < T; ++t) {
          double u = uni(rng) * (1.0 - cfg_.mask_ratio_min) + cfg_.mask_ratio_min;
          double p = std::cos(u * kPi / 2);
          int32_t* m = out->mask.data() + ((size_t)b * T + t) * S;
          for (int s = 0; s < S; ++s) {
            m[s] = uni(rng) < p ? 1 : 0;
            any |= (m[s] != 0);
          }
        }
      }
    }
  }

  FeatureConfig cfg_;
  Mmap video_, segs_, acts_;
  bool ok_ = false, has_segs_ = false, has_actions_ = false;
  std::vector<int64_t> valid_starts_;
  // declared last: destroyed first, while the members it reads still live
  std::unique_ptr<OrderedPrefetcher<FeatureBatch>> pf_;
};

}  // namespace

extern "C" {

void* hma_loader_create(const char* video_path, const char* seg_path,
                        const char* actions_path, int64_t num_images, int h,
                        int w, int window_size, int stride, int batch_size,
                        int action_dim, int action_width, int mask_token_id,
                        int factored_vocab_size, int num_factored_vocabs,
                        double max_corrupt_rate, double non_mlm_ratio,
                        int num_prompt_frames, double mask_ratio_min,
                        int apply_corruption, int apply_mask, uint64_t seed,
                        int num_threads, int queue_depth,
                        int64_t start_index) {
  LoaderConfig cfg{num_images, h, w, window_size, stride, batch_size,
                   action_dim, action_width, mask_token_id,
                   factored_vocab_size, num_factored_vocabs, max_corrupt_rate,
                   non_mlm_ratio, num_prompt_frames, mask_ratio_min,
                   apply_corruption, apply_mask, seed, num_threads,
                   queue_depth, start_index};
  auto* loader = new Loader(cfg, video_path, seg_path, actions_path);
  if (!loader->ok()) { delete loader; return nullptr; }
  return loader;
}

int64_t hma_loader_num_windows(void* handle) {
  return ((Loader*)handle)->num_windows();
}

int hma_loader_next(void* handle, int32_t* input_ids, int32_t* labels,
                    float* actions) {
  return ((Loader*)handle)->next(input_ids, labels, actions) ? 1 : 0;
}

void hma_loader_destroy(void* handle) { delete (Loader*)handle; }

void* hma_floader_create(const char* video_path, const char* seg_path,
                         const char* actions_path, int64_t num_images, int c,
                         int h, int w, int window_size, int stride,
                         int batch_size, int action_dim, int action_width,
                         double non_mlm_ratio, int num_prompt_frames,
                         double mask_ratio_min, int apply_mask, double scale,
                         uint64_t seed, int num_threads, int queue_depth,
                         int64_t start_index) {
  FeatureConfig cfg{num_images, c, h, w, window_size, stride, batch_size,
                    action_dim, action_width, non_mlm_ratio,
                    num_prompt_frames, mask_ratio_min, apply_mask, scale,
                    seed, num_threads, queue_depth, start_index};
  auto* loader = new FeatureLoader(cfg, video_path, seg_path, actions_path);
  if (!loader->ok()) { delete loader; return nullptr; }
  return loader;
}

int64_t hma_floader_num_windows(void* handle) {
  return ((FeatureLoader*)handle)->num_windows();
}

int hma_floader_next(void* handle, float* latents, float* labels,
                     int32_t* mask, float* actions) {
  return ((FeatureLoader*)handle)->next(latents, labels, mask, actions) ? 1 : 0;
}

void hma_floader_destroy(void* handle) { delete (FeatureLoader*)handle; }

}  // extern "C"
