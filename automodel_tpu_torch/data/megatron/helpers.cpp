// Native index builders for the pretraining data pipeline, the port's copy
// of automodel_tpu/data/megatron/helpers.cpp (the same algorithms, so
// both packages build the same indices).
//
// Parity: the reference's pybind11 helpers
// (components/datasets/llm/megatron/helpers.cpp — build_sample_idx:143,
// build_blending_indices:75): O(total_docs·epochs) index-construction loops
// that are orders of magnitude too slow in Python for billion-document
// corpora. Plain extern-C functions bound via ctypes (no pybind11).
//
// Build: g++ -O3 -shared -fPIC helpers.cpp -o lib.so, done at first use by
// helpers.py into automodel_tpu_torch/_build/, keyed by this file's hash.

#include <cstdint>
#include <cmath>

extern "C" {

// Map each training sample of (seq_length+1) tokens onto (document index,
// token offset) pairs. sizes: per-document token counts; doc_idx: epoch-
// repeated shuffled document ids. Output sample_idx: [(num_samples+1) x 2]
// int64 (doc_idx position, offset into that document).
// Returns the number of samples written (excluding the leading sentinel),
// or -1 if doc_idx was exhausted early.
int64_t build_sample_idx(const int32_t* sizes,
                         const int64_t* doc_idx,
                         int64_t doc_idx_len,
                         int64_t* sample_idx /* [(max_samples+1)*2] */,
                         int64_t max_samples,
                         int32_t seq_length) {
  int64_t doc_pos = 0;      // position in doc_idx
  int32_t doc_offset = 0;   // token offset within current document
  sample_idx[0] = 0;
  sample_idx[1] = 0;
  int64_t n = 0;
  while (n < max_samples) {
    int32_t remaining = seq_length + 1;  // +1: labels are inputs shifted
    while (remaining > 0) {
      if (doc_pos >= doc_idx_len) return -1;
      int32_t doc_len = sizes[doc_idx[doc_pos]] - doc_offset;
      if (doc_len > remaining) {
        // sample ends inside this document; next sample starts at the
        // overlapping last token (Megatron convention)
        doc_offset += remaining - 1;
        remaining = 0;
      } else {
        remaining -= doc_len;
        ++doc_pos;
        doc_offset = 0;
      }
    }
    ++n;
    sample_idx[2 * n] = doc_pos;
    sample_idx[2 * n + 1] = doc_offset;
  }
  return n;
}

// Interleave samples from weighted datasets so that after k draws each
// dataset i has received ~weights[i]*k of them (error-greedy assignment,
// the reference's build_blending_indices algorithm).
void build_blending_indices(int16_t* dataset_index,   // [size]
                            int64_t* dataset_sample_index,  // [size]
                            const double* weights,
                            int32_t num_datasets,
                            int64_t size) {
  int64_t* current = new int64_t[num_datasets]();
  for (int64_t i = 0; i < size; ++i) {
    // pick the dataset with the largest deficit weight*(i+1) - drawn
    double max_err = -1e300;
    int32_t pick = 0;
    for (int32_t d = 0; d < num_datasets; ++d) {
      double err = weights[d] * (double)(i + 1) - (double)current[d];
      if (err > max_err) {
        max_err = err;
        pick = d;
      }
    }
    dataset_index[i] = (int16_t)pick;
    dataset_sample_index[i] = current[pick];
    ++current[pick];
  }
  delete[] current;
}

// Draw exactly sizes[d] samples from each dataset d, round-robin weighted
// by remaining need (reference build_exhaustive_blending_indices:21 — exact
// counts instead of ratio targets).
void build_exhaustive_blending_indices(int16_t* dataset_index,
                                       int64_t* dataset_sample_index,
                                       const int64_t* sizes,
                                       int32_t num_datasets) {
  int64_t total = 0;
  for (int32_t d = 0; d < num_datasets; ++d) total += sizes[d];
  int64_t* drawn = new int64_t[num_datasets]();
  for (int64_t i = 0; i < total; ++i) {
    // largest remaining fraction first — interleaves proportionally while
    // guaranteeing the exact per-dataset totals
    double best = -1.0;
    int32_t pick = 0;
    for (int32_t d = 0; d < num_datasets; ++d) {
      int64_t rem = sizes[d] - drawn[d];
      if (rem <= 0) continue;
      double frac = (double)rem / (double)sizes[d];
      if (frac > best) {
        best = frac;
        pick = d;
      }
    }
    dataset_index[i] = (int16_t)pick;
    dataset_sample_index[i] = drawn[pick];
    ++drawn[pick];
  }
  delete[] drawn;
}

// ---------------------------------------------------------------------------
// BERT-style sentence-pair mappings (reference build_mapping:266 /
// build_blocks_mapping:564). Both greedily pack consecutive sentences of a
// document up to a target length and emit one row per packed sample, then
// Fisher-Yates-shuffle the rows. Two passes: count, then fill.
//
// A tiny xorshift generator stands in for the reference's std::mt19937 —
// the SAMPLE DISTRIBUTION is what matters (short-sequence ratio, uniform
// shuffle); the exact stream is an implementation detail nobody can rely on
// across libraries anyway.
// ---------------------------------------------------------------------------

static const int32_t kLongSentenceLen = 512;

static inline uint64_t xorshift64(uint64_t* s) {
  uint64_t x = *s;
  x ^= x << 13;
  x ^= x >> 7;
  x ^= x << 17;
  return *s = x;
}

static inline int32_t target_len(int32_t short_ratio, int32_t max_len,
                                 uint64_t* rng) {
  if (short_ratio == 0) return max_len;
  uint64_t r = xorshift64(rng);
  if ((r % (uint64_t)short_ratio) == 0) {
    // independent draw for the length: reusing r would confine short
    // lengths to multiples of gcd(short_ratio, max_len-1)
    uint64_t r2 = xorshift64(rng);
    return 2 + (int32_t)(r2 % (uint64_t)(max_len - 1));
  }
  return max_len;
}

static void shuffle_rows(int64_t* maps, int64_t n, int64_t width, uint64_t seed) {
  uint64_t s = seed * 0x9E3779B97F4A7C15ull + 1;
  for (int64_t i = n - 1; i > 0; --i) {
    int64_t j = (int64_t)(xorshift64(&s) % (uint64_t)(i + 1));
    for (int64_t w = 0; w < width; ++w) {
      int64_t t = maps[width * i + w];
      maps[width * i + w] = maps[width * j + w];
      maps[width * j + w] = t;
    }
  }
}

// docs: [n_docs+1] sentence-index offsets; sizes: [n_sents] token counts.
// Pass 1 (maps == NULL): return the row count. Pass 2: fill maps
// [n x 3] = (start_sent, end_sent_exclusive, target_seq_len) and shuffle.
// The two passes must be called with identical arguments (same seed).
int64_t build_mapping(const int64_t* docs, int64_t n_docs,
                      const int32_t* sizes,
                      int32_t num_epochs, int64_t max_num_samples,
                      int32_t max_seq_length, double short_seq_prob,
                      int64_t seed, int32_t min_num_sent,
                      int64_t* maps /* may be NULL */) {
  int32_t short_ratio =
      short_seq_prob > 0 ? (int32_t)(1.0 / short_seq_prob + 0.5) : 0;
  uint64_t rng = (uint64_t)seed * 0x2545F4914F6CDD1Dull + 1;
  int64_t map_index = 0;
  for (int32_t epoch = 0; epoch < num_epochs; ++epoch) {
    if (map_index >= max_num_samples) break;
    for (int64_t doc = 0; doc < n_docs; ++doc) {
      const int64_t first = docs[doc];
      const int64_t last = docs[doc + 1];
      int64_t remain = last - first;
      if (remain < min_num_sent) continue;
      bool has_long = false;
      for (int64_t s = first; s < last; ++s)
        if (sizes[s] > kLongSentenceLen) { has_long = true; break; }
      if (has_long) continue;

      int64_t prev_start = first;
      int32_t seq_len = 0, num_sent = 0;
      int32_t target = target_len(short_ratio, max_seq_length, &rng);
      for (int64_t s = first; s < last; ++s) {
        seq_len += sizes[s];
        ++num_sent;
        --remain;
        if ((seq_len >= target && remain > 1 && num_sent >= min_num_sent) ||
            remain == 0) {
          if (maps) {
            maps[3 * map_index] = prev_start;
            maps[3 * map_index + 1] = s + 1;
            maps[3 * map_index + 2] = target;
          }
          ++map_index;
          prev_start = s + 1;
          target = target_len(short_ratio, max_seq_length, &rng);
          seq_len = 0;
          num_sent = 0;
        }
      }
    }
  }
  if (maps) shuffle_rows(maps, map_index, 3, (uint64_t)seed + 1);
  return map_index;
}

// Blocks variant: per-document target = max_seq_length - titles_sizes[doc];
// rows are (start_sent, end_sent_exclusive, doc, block_id) with block_id
// unique per epoch (reference build_blocks_mapping:564-805).
int64_t build_blocks_mapping(const int64_t* docs, int64_t n_docs,
                             const int32_t* sizes,
                             const int32_t* titles_sizes,
                             int32_t num_epochs, int64_t max_num_samples,
                             int32_t max_seq_length, int64_t seed,
                             int32_t use_one_sent_blocks,
                             int64_t* maps /* may be NULL */) {
  const int32_t min_num_sent = use_one_sent_blocks ? 1 : 2;
  int64_t map_index = 0;
  for (int32_t epoch = 0; epoch < num_epochs; ++epoch) {
    if (map_index >= max_num_samples) break;
    int64_t block_id = 0;
    for (int64_t doc = 0; doc < n_docs; ++doc) {
      const int64_t first = docs[doc];
      const int64_t last = docs[doc + 1];
      const int32_t target = max_seq_length - titles_sizes[doc];
      int64_t remain = last - first;
      if (remain < min_num_sent || target <= 0) continue;
      bool has_long = false;
      for (int64_t s = first; s < last; ++s)
        if (sizes[s] > kLongSentenceLen) { has_long = true; break; }
      if (has_long) continue;

      int64_t prev_start = first;
      int32_t seq_len = 0, num_sent = 0;
      for (int64_t s = first; s < last; ++s) {
        seq_len += sizes[s];
        ++num_sent;
        --remain;
        if ((seq_len >= target && remain > 1 && num_sent >= min_num_sent) ||
            remain == 0) {
          if (maps) {
            maps[4 * map_index] = prev_start;
            maps[4 * map_index + 1] = s + 1;
            maps[4 * map_index + 2] = doc;
            maps[4 * map_index + 3] = block_id;
          }
          ++map_index;
          ++block_id;
          prev_start = s + 1;
          seq_len = 0;
          num_sent = 0;
        }
      }
    }
  }
  if (maps) shuffle_rows(maps, map_index, 4, (uint64_t)seed + 1);
  return map_index;
}

}  // extern "C"
