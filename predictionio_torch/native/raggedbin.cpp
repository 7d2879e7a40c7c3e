// raggedbin: native fill pass for ragged->static-shape binning.
//
// The host-side loader of the ALS trainer's segmented layout
// (predictionio_torch/ops/ragged.py). The numpy route must argsort the
// full COO stream to group entries (O(nnz log nnz) plus three
// scattered fancy-index writes over every rating); this native pass
// uses what numpy cannot express: a per-group cursor walk over the
// input in arrival order is already chronological within each group,
// so one O(nnz) sequential pass assigns every entry its (row, slot)
// and writes the rows directly.
//
// Reference analogue: MLlib ALS's InBlock/OutBlock construction, which
// Spark does with a cluster shuffle; here it is a single-machine
// native pass into host buffers the trainer puts on the card.
//
// Layout math (counts, row starts, padding) stays in Python where it is
// vectorized and cheap for rb_fill_segmented; rb_bin_compressed plans
// and fills in one call through binlayout.h.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC raggedbin.cpp -o _raggedbin.so

#include <cstdint>
#include <cstring>
#include <vector>

#include "binlayout.h"

extern "C" {

// Fill segmented virtual rows (SegmentedGroups layout, ragged.py):
//   group_row_start[g] — first global row of group g (shard-padded layout)
//   counts_true[g]     — true entry count of group g
//   max_len            — cap per group keeping the LATEST entries; -1 = none
//   L                  — slots per row;  g_per_shard — groups per shard
// Outputs (pre-zeroed by the caller; seg pre-filled with the pad value):
//   idx_out  [rows, L] int32
//   val_out  [rows, L] float32
//   mask_out [rows, L] float32
//   seg_out  [rows]    int32
// Returns 0 on success, -1 on bad input (group id out of range).
int rb_fill_segmented(
    const int64_t* group_idx, const int64_t* item_idx, const float* values,
    int64_t nnz, int64_t n_groups,
    const int64_t* group_row_start, const int64_t* counts_true,
    int64_t max_len, int64_t L, int64_t g_per_shard,
    int32_t* idx_out, float* val_out, float* mask_out, int32_t* seg_out) {
  std::vector<int64_t> cursor(n_groups, 0);
  for (int64_t k = 0; k < nnz; ++k) {
    int64_t g = group_idx[k];
    if (g < 0 || g >= n_groups) return -1;
    int64_t pos = cursor[g]++;
    if (max_len >= 0) {
      int64_t drop = counts_true[g] - max_len;
      if (drop > 0) {
        if (pos < drop) continue;  // keep only the latest max_len entries
        pos -= drop;
      }
    }
    int64_t row = group_row_start[g] + pos / L;
    int64_t slot = pos % L;
    int64_t at = row * L + slot;
    idx_out[at] = static_cast<int32_t>(item_idx[k]);
    val_out[at] = values[k];
    mask_out[at] = 1.0f;
    seg_out[row] = static_cast<int32_t>(g % g_per_shard);
  }
  return 0;
}

void rb_free(void* p) { free(p); }

// Single-pass COO -> transfer-compressed segmented layout: plans the
// blocks/padding (binlayout.h — the one port of the Python layout
// math), then fills the WIRE streams directly (uint16 idx_lo [+ uint8
// idx_hi], uint8 affine value codes or f32+mask, int32 seg/counts)
// into 64-byte-aligned buffers. Replaces the old two-stage
// build_segmented_groups -> compress_side pipeline, which materialized
// [R, L] float32 val + mask + int32 idx (12-16 B/slot) only to
// re-scan them down to 3-4 B/slot (np.unique + searchsorted + bit
// splits over 20M+ elements).
//
// ``seg_len`` -1 = auto (size from the group-size histogram);
// ``max_len`` -1 = uncapped. Returns 0 ok, -1 index out of range,
// -2 allocation failure, -3 item index exceeds the 24-bit wire
// format. Buffers in *out are caller-owned (rb_free each).
int rb_bin_compressed(
    const int64_t* group_idx, const int64_t* item_idx, const float* values,
    int64_t nnz, int64_t n_groups,
    int64_t seg_len, int64_t max_len, int64_t n_shards, int64_t block_size,
    double row_cost_slots, binlayout::CSide* out) {
  memset(out, 0, sizeof(*out));
  std::vector<int64_t> counts(n_groups, 0);
  for (int64_t k = 0; k < nnz; ++k) {
    int64_t g = group_idx[k];
    if (g < 0 || g >= n_groups) return -1;
    ++counts[g];
  }
  binlayout::SidePlan plan;
  binlayout::plan_segmented(std::move(counts), n_groups, seg_len, max_len,
                            n_shards, block_size, row_cost_slots, &plan);
  binlayout::SideOut side;
  int rc = binlayout::fill_compressed(group_idx, item_idx, values, nnz,
                                      plan, &side);
  if (rc != 0) {
    side.free_all();
    return rc;
  }
  binlayout::export_side(plan, &side, out);
  return 0;
}

}  // extern "C"
