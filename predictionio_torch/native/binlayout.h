// binlayout.h — shared host-side core of the zero-copy columnar->binned
// pipeline: layout planning + single-pass compressed fill.
//
// This header is the ONE implementation of the segmented-layout math
// (a bit-identical port of ops/ragged.build_segmented_groups +
// ops/als.compress_side) consumed by BOTH native libraries:
//   - raggedbin.cpp exports rb_bin_compressed (COO codes -> compressed
//     SideOut) for callers that already hold host COO arrays;
//   - eventlog.cpp exports el_bin_columnar (mmap'd log -> both sides'
//     compressed SideOut + vocabularies) — the fused ingest->bin lane.
//
// Why a header: the two .so files are compiled independently (see
// native/__init__.py build_library), so shared logic must be inlined
// into each; duplicating the layout math would let the two lanes drift
// apart, which the pinned equivalence tests exist to prevent.
//
// Output contract (must stay bit-identical to the Python reference):
//   idx_lo  [R, L] uint16   low 16 bits of the opposing-row index
//   idx_hi  [R, L] uint8    bits 16..23 (nullptr when max index < 2^16)
//   val     [R, L] uint8    affine value codes (code 255 = padded slot)
//           -- or --
//   val_f32 [R, L] float32  raw values + mask [R, L] uint8 when the
//                           distinct value set is not an affine ladder
//   seg     [R]    int32    group id local to the shard (pad rows carry
//                           the shard's last local id)
//   counts  [G]    int32    post-cap group sizes (padded group axis)
//
// All buffers are 64-byte-aligned allocations (posix_memalign) so
// numpy views over them can go to torch.from_numpy and the card with no
// host-side realignment copy; free with free()/el_free()/rb_free().
//
// KNOWN (documented) divergence from the Python reference: the Python
// compress_side probes the first 2^18 slots of the PADDED value array
// before computing the full distinct set. At EXACTLY 255 distinct
// rating values with 0.0 not among them and a padded slot inside the
// probe window, the probe may count 256 and skip coding even though
// the full set is codable. This port reproduces that outcome from the
// plan (pad_in_probe_window below) except in the sub-case where not
// every distinct value appears inside the window — there it stays
// conservatively UNCOMPRESSED (semantically identical, different
// layout). Real rating scales have ~10 distinct values; the pinned
// equivalence fixtures sit nowhere near the 255 edge.

#ifndef PIO_NATIVE_BINLAYOUT_H_
#define PIO_NATIVE_BINLAYOUT_H_

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace binlayout {

constexpr uint8_t kPadCode = 255;        // ops/als.PAD_CODE
constexpr int64_t kIdxWireLimit = 1 << 24;  // _split_idx 24-bit wire cap
constexpr int64_t kProbeWindow = 1 << 18;   // compress_side probe slots

inline int64_t pad_to_multiple(int64_t n, int64_t multiple) {
  return multiple > 1 ? ((n + multiple - 1) / multiple) * multiple : n;
}

// exact port of ops/ragged.auto_seg_len: evaluate the row count for
// every candidate L from the group-size histogram; first strict
// minimum wins (matching Python's `cost < best_cost`)
inline int64_t auto_seg_len(const int64_t* counts, int64_t n_groups,
                            double row_cost_slots, int64_t lo = 16,
                            int64_t hi = 512) {
  bool any = false;
  for (int64_t g = 0; g < n_groups; ++g) {
    if (counts[g] > 0) { any = true; break; }
  }
  if (!any) return lo;
  int64_t best_L = lo;
  double best_cost = -1.0;
  for (int64_t L = lo; L <= hi; L += 16) {
    int64_t rows = 0;
    for (int64_t g = 0; g < n_groups; ++g) {
      if (counts[g] > 0) rows += (counts[g] + L - 1) / L;
    }
    double cost = static_cast<double>(rows)
                  * (static_cast<double>(L) + row_cost_slots);
    if (best_cost < 0.0 || cost < best_cost) {
      best_L = L;
      best_cost = cost;
    }
  }
  return best_L;
}

struct SidePlan {
  int64_t L = 0;              // slots per virtual row
  int64_t g_per_shard = 0;
  int64_t G = 0;              // padded group axis (g_per_shard * n_shards)
  int64_t R_s = 0;            // rows per shard (padded)
  int64_t R_total = 0;        // n_shards * R_s
  int64_t row_block = 0;
  int64_t group_block = 0;
  int64_t n_shards = 1;
  int64_t n_groups = 0;       // true group count
  int64_t max_len = -1;       // -1 = uncapped
  std::vector<int64_t> counts_true;      // [n_groups]
  std::vector<int64_t> kept;             // [G] post-cap counts
  std::vector<int64_t> group_row_start;  // [G]
};

// exact port of the layout math in build_segmented_groups (counts ->
// blocks/padding/row starts); counts_true must hold the TRUE group
// sizes (pre-cap)
inline void plan_segmented(std::vector<int64_t>&& counts_true,
                           int64_t n_groups, int64_t seg_len,
                           int64_t max_len, int64_t n_shards,
                           int64_t block_size, double row_cost_slots,
                           SidePlan* plan) {
  plan->n_groups = n_groups;
  plan->n_shards = n_shards;
  plan->max_len = max_len;
  plan->counts_true = std::move(counts_true);
  const std::vector<int64_t>& ct = plan->counts_true;

  if (seg_len < 0) {  // "auto"
    if (max_len < 0) {
      seg_len = auto_seg_len(ct.data(), n_groups, row_cost_slots);
    } else {
      std::vector<int64_t> capped(n_groups);
      for (int64_t g = 0; g < n_groups; ++g)
        capped[g] = std::min(ct[g], max_len);
      seg_len = auto_seg_len(capped.data(), n_groups, row_cost_slots);
    }
  }
  const int64_t L = std::max<int64_t>(pad_to_multiple(seg_len, 8), 8);
  const int64_t g_raw = pad_to_multiple(
      std::max<int64_t>(1, (n_groups + n_shards - 1) / n_shards), 8);
  const int64_t group_block = std::min(block_size, g_raw);
  const int64_t g_per_shard = pad_to_multiple(g_raw, group_block);
  const int64_t G = g_per_shard * n_shards;

  plan->kept.assign(G, 0);
  for (int64_t g = 0; g < n_groups; ++g)
    plan->kept[g] = max_len < 0 ? ct[g] : std::min(ct[g], max_len);

  std::vector<int64_t> rows_by_shard(n_shards, 0);
  for (int64_t g = 0; g < G; ++g)
    rows_by_shard[g / g_per_shard] += (plan->kept[g] + L - 1) / L;
  int64_t rows_max = 1;
  for (int64_t s = 0; s < n_shards; ++s)
    rows_max = std::max(rows_max, rows_by_shard[s]);
  const int64_t row_block =
      std::min(block_size, pad_to_multiple(rows_max, 8));
  const int64_t R_s = pad_to_multiple(rows_max, row_block);

  plan->group_row_start.assign(G, 0);
  for (int64_t s = 0; s < n_shards; ++s) {
    int64_t acc = 0;
    for (int64_t j = 0; j < g_per_shard; ++j) {
      int64_t g = s * g_per_shard + j;
      plan->group_row_start[g] = acc + s * R_s;
      acc += (plan->kept[g] + L - 1) / L;
    }
  }
  plan->L = L;
  plan->g_per_shard = g_per_shard;
  plan->G = G;
  plan->R_s = R_s;
  plan->R_total = n_shards * R_s;
  plan->row_block = row_block;
  plan->group_block = group_block;
}

// does the first kProbeWindow slots of the row-major padded value
// array contain a padded slot? (the Python probe would then see the
// 0.0 pad filler as an extra distinct value). Derivable from the plan:
// row r's filled slots are exactly its first fill(r) positions.
inline bool pad_in_probe_window(const SidePlan& plan) {
  const int64_t L = plan.L;
  const int64_t window = std::min(kProbeWindow, plan.R_total * L);
  std::vector<int64_t> fill(plan.R_total, 0);
  for (int64_t g = 0; g < plan.G; ++g) {
    int64_t kept = plan.kept[g];
    if (kept == 0) continue;
    int64_t r0 = plan.group_row_start[g];
    int64_t rows = (kept + L - 1) / L;
    for (int64_t j = 0; j < rows; ++j)
      fill[r0 + j] = (j < rows - 1) ? L : kept - (rows - 1) * L;
  }
  for (int64_t r = 0; r * L < window; ++r) {
    // first pad slot of row r sits at global position r*L + fill[r] —
    // but a COMPLETELY full row (fill == L) has no pad of its own
    // (that position is row r+1's first slot, which may be filled)
    if (fill[r] < L && r * L + fill[r] < window) return true;
  }
  return false;
}

struct SideOut {
  uint16_t* idx_lo = nullptr;  // [R, L]
  uint8_t* idx_hi = nullptr;   // [R, L] or nullptr when max idx < 2^16
  uint8_t* val_u8 = nullptr;   // [R, L] affine codes (255 = pad) ...
  float* val_f32 = nullptr;    // ... or raw float32 values
  uint8_t* mask = nullptr;     // [R, L] 1/0, only with val_f32
  int32_t* seg = nullptr;      // [R]
  int32_t* counts = nullptr;   // [G]
  int64_t affine = 0;          // 1 = val_u8 carries codes
  double affine_a = 0.0;
  double affine_b = 0.0;
  int64_t kept_entries = 0;    // sum of post-cap counts
  double kept_value_sum = 0.0; // f64 sum of kept (binned) float32 values

  void free_all() {
    free(idx_lo); free(idx_hi); free(val_u8); free(val_f32);
    free(mask); free(seg); free(counts);
    *this = SideOut{};
  }
};

inline void* alloc_aligned(size_t nbytes) {
  void* p = nullptr;
  if (posix_memalign(&p, 64, nbytes ? nbytes : 64) != 0) return nullptr;
  return p;
}

// Fill one side's compressed layout from COO triples. Returns 0 ok,
// -1 group/item index out of range, -2 allocation failure, -3 item
// index exceeds the 24-bit wire format. ``values`` must already be
// the float32 the Python path would bin (value resolution — NaN->0,
// per-event-name overrides — happens in the caller).
template <typename IdxT>
inline int fill_compressed(const IdxT* group_idx, const IdxT* item_idx,
                           const float* values, int64_t nnz,
                           const SidePlan& plan, SideOut* out) {
  const int64_t L = plan.L;
  const int64_t n_groups = plan.n_groups;
  const int64_t max_len = plan.max_len;

  // pass 1: distinct KEPT values (what compress_side's np.unique over
  // the masked array sees — truncation-dropped entries must not count)
  // + the max kept item index (decides the idx_hi stream). Without a
  // cap every entry is kept, so no cursor walk is needed.
  std::unordered_map<uint32_t, uint8_t> value_codes;
  value_codes.reserve(512);
  bool too_many = false;
  bool has_nan = false;
  int64_t max_idx = 0;
  bool have_last = false;
  uint32_t last_bits = 0;
  auto note_value = [&](float v) {
    if (v != v) {  // NaN (any encoding): never codable — np.unique
      has_nan = true;  // would keep it and the ladder check fails, so
      return;          // the reference stays uncoded; keeping NaN out
    }                  // of the set also keeps std::sort well-defined
    if (v == 0.0f) v = 0.0f;  // collapse -0.0 onto 0.0 like np.unique
    uint32_t bits;
    memcpy(&bits, &v, 4);
    if (have_last && bits == last_bits) return;
    have_last = true;
    last_bits = bits;
    if (too_many) return;
    value_codes.emplace(bits, 0);
    if (value_codes.size() > 256) too_many = true;
  };
  std::vector<int64_t> cursor(n_groups, 0);
  for (int64_t k = 0; k < nnz; ++k) {
    int64_t g = static_cast<int64_t>(group_idx[k]);
    int64_t it = static_cast<int64_t>(item_idx[k]);
    if (g < 0 || g >= n_groups || it < 0) return -1;
    if (it >= kIdxWireLimit) return -3;
    if (max_len >= 0) {
      int64_t pos = cursor[g]++;
      int64_t drop = plan.counts_true[g] - max_len;
      if (drop > 0 && pos < drop) continue;  // truncated away: not kept
    }
    if (it > max_idx) max_idx = it;
    note_value(values[k]);
  }

  // coding decision — exact port of compress_side (plus the documented
  // probe edge at exactly 255 distinct values)
  int64_t n_vals = static_cast<int64_t>(value_codes.size());
  bool coded = false;
  double a = 0.0, b = 0.0;
  std::vector<float> uniq;
  if (!too_many && !has_nan && n_vals <= 255) {
    uniq.reserve(n_vals);
    for (const auto& kv : value_codes) {
      float v;
      uint32_t bits = kv.first;
      memcpy(&v, &bits, 4);
      uniq.push_back(v);
    }
    std::sort(uniq.begin(), uniq.end());
    if (n_vals == 1) {
      coded = true;
      a = static_cast<double>(uniq[0]);
      b = 0.0;
    } else if (n_vals >= 2) {
      float bf = uniq[1] - uniq[0];  // f32 subtraction, like numpy
      if (bf != 0.0f) {
        bool ladder = true;
        for (int64_t k = 0; k < n_vals; ++k) {
          float expect = uniq[0] + bf * static_cast<float>(k);
          if (uniq[k] != expect) { ladder = false; break; }
        }
        if (ladder) {
          coded = true;
          a = static_cast<double>(uniq[0]);
          b = static_cast<double>(bf);
        }
      }
    }
    if (coded && n_vals == 255) {
      // the Python probe window includes pad slots valued 0.0: at 255
      // distinct non-zero values + a pad inside the window it counts
      // 256 and skips coding — reproduce that outcome
      bool zero_in_vals =
          std::binary_search(uniq.begin(), uniq.end(), 0.0f);
      if (!zero_in_vals && pad_in_probe_window(plan)) coded = false;
    }
    if (coded) {
      for (int64_t k = 0; k < n_vals; ++k) {
        uint32_t bits;
        memcpy(&bits, &uniq[k], 4);
        value_codes[bits] = static_cast<uint8_t>(k);
      }
    }
  }

  const size_t slots = static_cast<size_t>(plan.R_total) * L;
  out->idx_lo = static_cast<uint16_t*>(alloc_aligned(slots * 2));
  out->idx_hi = max_idx >= (1 << 16)
                    ? static_cast<uint8_t*>(alloc_aligned(slots))
                    : nullptr;
  if (coded) {
    out->val_u8 = static_cast<uint8_t*>(alloc_aligned(slots));
  } else {
    out->val_f32 = static_cast<float*>(alloc_aligned(slots * 4));
    out->mask = static_cast<uint8_t*>(alloc_aligned(slots));
  }
  out->seg = static_cast<int32_t*>(alloc_aligned(plan.R_total * 4));
  out->counts = static_cast<int32_t*>(alloc_aligned(plan.G * 4));
  bool alloc_ok = out->idx_lo && out->seg && out->counts &&
                  (max_idx < (1 << 16) || out->idx_hi) &&
                  (coded ? out->val_u8 != nullptr
                         : out->val_f32 && out->mask);
  if (!alloc_ok) {
    out->free_all();
    return -2;
  }
  memset(out->idx_lo, 0, slots * 2);
  if (out->idx_hi) memset(out->idx_hi, 0, slots);
  if (coded) {
    memset(out->val_u8, kPadCode, slots);       // pads decode to 255
  } else {
    memset(out->val_f32, 0, slots * 4);
    memset(out->mask, 0, slots);
  }
  // pad rows point at the shard's LAST local group (nondecreasing seg)
  for (int64_t r = 0; r < plan.R_total; ++r)
    out->seg[r] = static_cast<int32_t>(plan.g_per_shard - 1);
  int64_t kept_total = 0;
  for (int64_t g = 0; g < plan.G; ++g) {
    out->counts[g] = static_cast<int32_t>(plan.kept[g]);
    kept_total += plan.kept[g];
  }
  out->affine = coded ? 1 : 0;
  out->affine_a = a;
  out->affine_b = b;
  out->kept_entries = kept_total;

  // pass 2: the cursor-walk fill (rb_fill_segmented's walk, writing
  // the wire-compressed streams directly — no intermediate f32
  // val/mask arrays, no post-hoc searchsorted/split passes)
  std::fill(cursor.begin(), cursor.end(), 0);
  have_last = false;  // coded values are never NaN (has_nan forces the
  last_bits = 0;      // f32 path), so the bits cache is collision-free
  uint8_t last_code = 0;
  double vsum = 0.0;
  for (int64_t k = 0; k < nnz; ++k) {
    int64_t g = static_cast<int64_t>(group_idx[k]);
    int64_t pos = cursor[g]++;
    if (max_len >= 0) {
      int64_t drop = plan.counts_true[g] - max_len;
      if (drop > 0) {
        if (pos < drop) continue;  // keep only the latest max_len
        pos -= drop;
      }
    }
    int64_t row = plan.group_row_start[g] + pos / L;
    int64_t slot = pos % L;
    int64_t at = row * L + slot;
    int32_t it = static_cast<int32_t>(item_idx[k]);
    out->idx_lo[at] = static_cast<uint16_t>(it & 0xFFFF);
    if (out->idx_hi) out->idx_hi[at] = static_cast<uint8_t>(it >> 16);
    float v = values[k];
    vsum += static_cast<double>(v);
    if (coded) {
      if (v == 0.0f) v = 0.0f;  // -0.0 folded like pass 1
      uint32_t bits;
      memcpy(&bits, &v, 4);
      if (!have_last || bits != last_bits) {
        have_last = true;
        last_bits = bits;
        last_code = value_codes[bits];
      }
      out->val_u8[at] = last_code;
    } else {
      out->val_f32[at] = v;
      out->mask[at] = 1;
    }
    out->seg[row] = static_cast<int32_t>(g % plan.g_per_shard);
  }
  out->kept_value_sum = vsum;
  return 0;
}

// C-ABI view of one side's layout (mirrored field-for-field by the
// ctypes Structure in the Python bindings; every field is 8 bytes so
// the layout is padding-free and identical across compilers)
struct CSide {
  uint16_t* idx_lo;
  uint8_t* idx_hi;
  uint8_t* val_u8;
  float* val_f32;
  uint8_t* mask;
  int32_t* seg;
  int32_t* counts;
  int64_t rows;          // R_total
  int64_t L;
  int64_t g_per_shard;
  int64_t n_shards;
  int64_t row_block;
  int64_t group_block;
  int64_t n_groups;      // true group count (pre-padding)
  int64_t affine;        // 1 = val_u8 carries codes
  double affine_a;
  double affine_b;
  int64_t kept_entries;
  double kept_value_sum;
};

inline void export_side(const SidePlan& plan, SideOut* out, CSide* c) {
  c->idx_lo = out->idx_lo;
  c->idx_hi = out->idx_hi;
  c->val_u8 = out->val_u8;
  c->val_f32 = out->val_f32;
  c->mask = out->mask;
  c->seg = out->seg;
  c->counts = out->counts;
  c->rows = plan.R_total;
  c->L = plan.L;
  c->g_per_shard = plan.g_per_shard;
  c->n_shards = plan.n_shards;
  c->row_block = plan.row_block;
  c->group_block = plan.group_block;
  c->n_groups = plan.n_groups;
  c->affine = out->affine;
  c->affine_a = out->affine_a;
  c->affine_b = out->affine_b;
  c->kept_entries = out->kept_entries;
  c->kept_value_sum = out->kept_value_sum;
  *out = SideOut{};  // ownership moved to the C view
}

}  // namespace binlayout

#endif  // PIO_NATIVE_BINLAYOUT_H_
