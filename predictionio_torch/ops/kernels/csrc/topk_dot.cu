// Fused dot product + top-k for exact retrieval, for Hopper (sm_90a).
//
// Replaces the TPU kernel predictionio_tpu/ops/pallas/topk_dot.py::
// _topk_dot_kernel (built by make_topk_dot). For queries q [B, D] against
// an item table [I, D] (f32, row-major) it returns, per query row, the k
// best items of q . item^T as (scores [B, k] f32, ids [B, k] int32).
// Excluded ids (excl [B, E], -1 pads, ids outside [0, I) ignored) score
// NEG_INF = -1e30 and still fill slots when nothing better is left. The
// [B, I] logits never reach device memory.
//
// Order: score descending, then item id ascending — one total order, the
// same as the plain version (ops/kernels/topk_dot.py::topk_dot_reference).
// Each candidate is one 64-bit key:
//   high 32 bits: the score's bits mapped so that unsigned order is float
//                 order (-0.0 is folded into +0.0 first),
//   low 32 bits:  0xFFFFFFFF - id, so a lower id is a larger key.
// Key 0 is below every real candidate and marks an empty slot.
//
// What bounds it: the table read, I*D*4 bytes once, against 2*B*I*D f32
// operations, which at B <= 8 are far below the f32 rate: bytes bound it.
// At the ALS serve shape (B = 1, I = 26,744, D = 64: 6.8 MB, 2 us at
// 3.35 TB/s) the launch, the dependent load rounds and the final merge
// bound it instead; at a 1M x 128 catalog (512 MB, 153 us) the HBM read.
//
// Design: ONE launch per search. Grid = blocks x query blocks of QB rows
// (QB = 1, 2, 4 or 8 by B); each block scans a contiguous item range.
//  - Loads in flight: each warp reads U items at once, P lanes per item,
//    each lane 16 bytes (D % 4 == 0 and 16-byte alignment; else 4 bytes)
//    into registers, so one load instruction of a warp covers 32 * 16
//    contiguous bytes. The next batch's loads are issued right after the
//    products of this one, so they stay in flight while the block reduces
//    (xor shuffles over the P lanes), filters and waits at its one barrier
//    per batch. q is read through the read-only cache.
//  - A threshold filter instead of a sort per chunk: each block keeps its
//    running top-K2 keys per row in shared memory, sorted, and the K2-th
//    key as a threshold. A candidate not above it is dropped with one
//    compare (exact: K2 better keys are held); the survivors of a warp
//    are appended to the row's buffer with one shared atomicAdd (ballot
//    and popc); exclusions are looked up for survivors only (an excluded
//    item drops to NEG_INF and is offered again). The block merges the
//    buffer into the top only when the next batch could overflow it, and
//    once at the end: each key counts the keys above it (broadcast reads
//    of the row, two barriers in all, where a bitonic sort needs one per
//    stage), and a key with fewer than K2 above it lands in its place.
//    Random scores almost never pass after the first merge; scores that
//    rise along the table make a block merge every few batches and stay
//    exact.
//  - The merge in the same launch ("threadfence reduction"): each block
//    writes its top-K2 keys to a scratch buffer, runs __threadfence() and
//    takes a ticket with atomicAdd on its query block's counter; the last
//    block to arrive keeps its own top as the running top and pushes every
//    other block's keys (read past L1 with __ldcg) through the same
//    filter, level by level with the next rounds' loads in flight: every
//    block's best key first, which lifts the threshold near its final
//    value, and it stops at the first level where no key passes (each
//    list is sorted). Then it writes (scores, ids) and
//    resets the counter to 0. The
//    keys form a total order, so the answer does not depend on which block
//    arrives last, and each item's dot is summed in the same order whatever
//    the grid: every block count gives the same bits.
//
// Left out: wgmma/TMA (at B <= 8 the products are a few percent of the
// f32 rate and the scan is bound by bytes and latency; tensor cores would
// also need TF32 or a 3xTF32 split, changing the f32 scores the order
// relies on) and CUDA graphs (the launch is one kernel already; a graph
// belongs to the caller's serving loop).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRow = 512;        // keys per row in shared memory: top, buffer
constexpr int kMergeLoads = 16;  // merge rounds whose keys are loaded at once
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xFFFFFFFFu;

typedef unsigned long long u64;

__device__ __forceinline__ u64 make_key(float s, long long gid) {
  if (s == 0.0f) s = 0.0f;  // -0.0 ranks as +0.0
  unsigned int u = __float_as_uint(s);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((u64)u << 32) | (u64)(0xFFFFFFFFu - (unsigned int)gid);
}

__device__ __forceinline__ void decode_key(u64 key, float* s, int* gid) {
  if (key == 0ull) {  // an empty slot (never output while k <= I)
    *s = kNegInf;
    *gid = -1;
    return;
  }
  unsigned int u = (unsigned int)(key >> 32);
  u = (u & 0x80000000u) ? (u & 0x7FFFFFFFu) : ~u;
  *s = __uint_as_float(u);
  *gid = (int)(0xFFFFFFFFu - (unsigned int)(key & 0xFFFFFFFFull));
}

// one load unit: 16 bytes (VEC = 4) or 4 bytes (VEC = 1) of a row
template <int VEC>
struct Vec;

template <>
struct Vec<4> {
  typedef float4 T;
  static __device__ __forceinline__ T zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  static __device__ __forceinline__ T load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ float fma(T a, T b, float acc) {
    acc = fmaf(a.x, b.x, acc);
    acc = fmaf(a.y, b.y, acc);
    acc = fmaf(a.z, b.z, acc);
    return fmaf(a.w, b.w, acc);
  }
};

template <>
struct Vec<1> {
  typedef float T;
  static __device__ __forceinline__ T zero() { return 0.f; }
  static __device__ __forceinline__ T load(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ float fma(T a, T b, float acc) {
    return fmaf(a, b, acc);
  }
};

// Merge each row's buffer into its running top: every key of the top
// and the buffer (key 0, an empty slot, aside) counts the keys above it,
// reading them in order so that a warp's reads are broadcasts, and a key
// with fewer than K2 above it goes to that place of `fresh`; a warp stops
// counting once all its keys have K2 above them. Then `fresh` becomes the
// top (and is cleared), the K2-th key the threshold, and the buffer
// empty (its slots 0 again, as every slot past it always is). Every
// thread calls it, after a barrier.
template <int QB>
__device__ __forceinline__ void flush(u64* keys, u64* fresh, u64* thr,
                                      int* cnt, int K2) {
  int n[QB], most = 0;
#pragma unroll
  for (int r = 0; r < QB; ++r) {
    n[r] = cnt[r];
    most = max(most, n[r]);
  }
  __syncthreads();  // every thread has read the counts
  if (most == 0) return;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < QB; ++r) {
    const u64* row = keys + r * kRow;
    const int m = K2 + n[r];
    for (int w0 = threadIdx.x & ~31; w0 < m; w0 += kThreads) {
      const u64 x = (w0 + lane < m) ? row[w0 + lane] : 0ull;
      int above = 0;
      for (int t = 0; t < m; t += 16) {  // slots past the buffer hold 0
        ulonglong2 y[8];
#pragma unroll
        for (int v = 0; v < 8; ++v)
          y[v] = reinterpret_cast<const ulonglong2*>(row + t)[v];
        int a = 0;
#pragma unroll
        for (int v = 0; v < 8; ++v) a += (y[v].x > x) + (y[v].y > x);
        above += a;
        if (__all_sync(kFull, x == 0ull || above >= K2)) break;
      }
      if (x != 0ull && above < K2) fresh[r * K2 + above] = x;
    }
  }
  __syncthreads();
  const int lgK2 = 31 - __clz(K2);
  for (int i = threadIdx.x; i < QB * K2; i += kThreads) {
    const int r = i >> lgK2, j = i & (K2 - 1);
    const u64 v = fresh[i];
    fresh[i] = 0ull;
    keys[r * kRow + j] = v;
    if (j == K2 - 1) thr[r] = v;
  }
#pragma unroll
  for (int r = 0; r < QB; ++r)  // the buffer is empty: all 0 again
    for (int i = threadIdx.x; i < n[r]; i += kThreads)
      keys[r * kRow + K2 + i] = 0ull;
  if (threadIdx.x < QB) cnt[threadIdx.x] = 0;
  __syncthreads();
}

// Row r's candidates from one warp (every lane calls it; `pass` marks the
// lanes whose `key` enters): one shared atomicAdd reserves their slots in
// the buffer. `need` is set when the buffer is past `limit` (the next
// round could overflow it).
__device__ __forceinline__ void offer(u64* keys, int* cnt, int K2, int r,
                                      u64 key, bool pass, int limit,
                                      bool& need) {
  const unsigned mask = __ballot_sync(kFull, pass);
  if (!mask) return;
  const int lane = threadIdx.x & 31, leader = __ffs(mask) - 1;
  int slot = 0;
  if (lane == leader) slot = atomicAdd(&cnt[r], __popc(mask));
  slot = __shfl_sync(kFull, slot, leader) + __popc(mask & ((1u << lane) - 1));
  if (pass) {
    keys[r * kRow + K2 + slot] = key;
    need |= slot >= limit;
  }
}

// The key this thread filters in merge round `round`: rounds walk the
// levels of the published lists ([K2][blocks][QB]), per_level rounds of
// kThreads keys each; 0 past the end and for the merging block's own keys.
__device__ __forceinline__ u64 merge_key(const u64* lists, int round,
                                         int per_level, int rounds,
                                         int level, int qb) {
  if (round >= rounds) return 0ull;
  const int j = round / per_level;
  const int i = (round % per_level) * kThreads + threadIdx.x;
  if (i >= level || i / qb == (int)blockIdx.x) return 0ull;
  return __ldcg(lists + (long long)j * level + i);
}

// up to 128 registers a thread: two blocks on each SM
template <int QB, int VEC>
__global__ void __launch_bounds__(kThreads, 2)
topk_dot_kernel(const float* __restrict__ q, const float* __restrict__ items,
                const int* __restrict__ excl, u64* __restrict__ lists,
                int* __restrict__ tickets, float* __restrict__ out_s,
                int* __restrict__ out_i, int B, int I, int D, int E, int k,
                int K2, int per_block, int P) {
  typedef Vec<VEC> V;
  typedef typename V::T T;
  constexpr int U = QB >= 4 ? 4 : 8;  // items each lane group loads at once

  extern __shared__ __align__(16) unsigned char smem[];
  u64* keys = reinterpret_cast<u64*>(smem);  // [QB][kRow]: top K2, buffer
  u64* fresh = keys + QB * kRow;              // [QB][K2] the next top
  u64* thr = fresh + QB * K2;                 // [QB] the K2-th key
  int* cnt = reinterpret_cast<int*>(thr + QB);  // [QB] keys in the buffer
  int* ex = cnt + QB;                           // [QB][E]
  int* last = ex + QB * E;                      // this block merges

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b0 = blockIdx.y * QB;
  const int nb = gridDim.x;
  const int G = 32 / P;  // items one load instruction of a warp covers
  const int p = lane & (P - 1), grp = lane / P;
  const int nchunks = D / VEC;
  const int C = (nchunks + P - 1) / P;  // load units per lane per item
  const long long start = (long long)blockIdx.x * per_block;
  const long long end = min((long long)I, start + per_block);
  const int batch = U * kWarps * G;  // items per block per batch

  // the scan: item of slot u of the batch at `base` is
  // base + (u * kWarps + warp) * G + grp. The first batch's loads and
  // q's first load units go out before the block sets up.
  T buf[U], q0[QB];
  const long long lane_off = (long long)warp * G + grp;
  if (start < end) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long it = start + (long long)u * kWarps * G + lane_off;
      buf[u] = (it < end && p < nchunks) ? V::load(items + it * D + p * VEC)
                                         : V::zero();
    }
  }
#pragma unroll
  for (int r = 0; r < QB; ++r)
    q0[r] = (p < nchunks && b0 + r < B)
                ? V::load(q + (long long)(b0 + r) * D + p * VEC)
                : V::zero();
  for (int i = tid; i < QB * kRow; i += kThreads) keys[i] = 0ull;
  for (int i = tid; i < QB * K2; i += kThreads) fresh[i] = 0ull;
  for (int i = tid; i < QB * E; i += kThreads) {
    const int r = i / E;
    ex[i] = (b0 + r < B) ? excl[(long long)(b0 + r) * E + i % E] : -1;
  }
  if (tid < QB) {
    thr[tid] = 0ull;
    cnt[tid] = 0;
  }
  __syncthreads();

  const int scan_limit = kRow - K2 - batch;
  for (long long base = start; base < end; base += batch) {
    float acc[U][QB];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int r = 0; r < QB; ++r) acc[u][r] = 0.0f;
    for (int j = 0; j < C; ++j) {
      const int c = p + j * P;
      T qv[QB];
#pragma unroll
      for (int r = 0; r < QB; ++r)
        qv[r] = j == 0 ? q0[r]
                : (c < nchunks && b0 + r < B)
                    ? V::load(q + (long long)(b0 + r) * D + c * VEC)
                    : V::zero();
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int r = 0; r < QB; ++r)
          acc[u][r] = V::fma(qv[r], buf[u], acc[u][r]);
      // issue the next loads now: this lane's next unit of the batch, or
      // the next batch's first
      const long long nbase = (j + 1 < C) ? base : base + batch;
      const int nc = (j + 1 < C) ? c + P : p;
      if (nbase < end) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const long long it = nbase + (long long)u * kWarps * G + lane_off;
          buf[u] = (it < end && nc < nchunks)
                       ? V::load(items + it * D + nc * VEC)
                       : V::zero();
        }
      }
    }
    // sum over the P lanes of each item (every lane gets the same bits)
    for (int off = P >> 1; off > 0; off >>= 1)
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int r = 0; r < QB; ++r)
          acc[u][r] += __shfl_xor_sync(kFull, acc[u][r], off);

    // lane u of each group offers item u of the batch
    bool need = false;
    const long long it = base + (long long)p * kWarps * G + lane_off;
    const bool mine = p < U && it < end;
#pragma unroll
    for (int r = 0; r < QB; ++r) {
      float v = acc[0][r];
#pragma unroll
      for (int u = 1; u < U; ++u)
        if (p == u) v = acc[u][r];
      const u64 t = thr[r];
      u64 key = make_key(v, it);
      bool pass = mine && b0 + r < B && key > t;
      if (pass) {
        for (int e = 0; e < E; ++e)
          if ((long long)ex[r * E + e] == it) {
            key = make_key(kNegInf, it);
            pass = key > t;
            break;
          }
      }
      offer(keys, cnt, K2, r, key, pass, scan_limit, need);
    }
    if (__syncthreads_or(need)) flush<QB>(keys, fresh, thr, cnt, K2);
  }
  flush<QB>(keys, fresh, thr, cnt, K2);

  // publish this block's top-K2 level by level ([K2][blocks][QB] per
  // query block: level j holds every block's j-th key), then take a ticket
  const int level = nb * QB;
  u64* mine = lists + (long long)blockIdx.y * K2 * level;
  const int lgK2 = 31 - __clz(K2);
  for (int i = tid; i < QB * K2; i += kThreads) {
    const int r = i >> lgK2, j = i & (K2 - 1);
    mine[(long long)j * level + blockIdx.x * QB + r] = keys[r * kRow + j];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) *last = atomicAdd(&tickets[blockIdx.y], 1) == nb - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();

  // the last block: its own top is the running top; every other block's
  // keys go through the same filter, level by level, in rounds of at most
  // kThreads keys of one level; the keys of the next kMergeLoads rounds
  // are loaded while these are filtered. The heads (level 0) are merged
  // first, which lifts the threshold near its final value; a level where
  // no key passes ends the merge, since every later key of a list is
  // below that list's key on this level.
  const int per_level = (level + kThreads - 1) / kThreads;  // rounds
  const int rounds = K2 * per_level;
  const int merge_limit = kRow - K2 - kThreads;
  u64 kv[kMergeLoads], nx[kMergeLoads];
#pragma unroll
  for (int m = 0; m < kMergeLoads; ++m)
    kv[m] = merge_key(mine, m, per_level, rounds, level, QB);
  bool any = false, stop = false;  // a key of this level passed
  for (int g = 0; g < rounds && !stop; g += kMergeLoads) {
#pragma unroll
    for (int m = 0; m < kMergeLoads; ++m)
      nx[m] = merge_key(mine, g + kMergeLoads + m, per_level, rounds, level,
                        QB);
#pragma unroll
    for (int m = 0; m < kMergeLoads; ++m) {
      const int round = g + m;
      if (!stop && round < rounds) {  // uniform
        const int i = (round % per_level) * kThreads + tid;  // in its level
        bool need = false;
#pragma unroll
        for (int r = 0; r < QB; ++r) {
          const bool pass = (i & (QB - 1)) == r && kv[m] > thr[r];
          offer(keys, cnt, K2, r, kv[m], pass, merge_limit, need);
          any |= pass;
        }
        if (__syncthreads_or(need)) flush<QB>(keys, fresh, thr, cnt, K2);
        if ((round + 1) % per_level == 0) {  // the end of a level
          stop = !__syncthreads_or(any);
          any = false;
          if (round < per_level) flush<QB>(keys, fresh, thr, cnt, K2);
        }
      }
      kv[m] = nx[m];
    }
  }
  flush<QB>(keys, fresh, thr, cnt, K2);

  for (int i = tid; i < QB * k; i += kThreads) {
    const int r = i / k, j = i % k;
    if (b0 + r < B)
      decode_key(keys[r * kRow + j], out_s + (long long)(b0 + r) * k + j,
                 out_i + (long long)(b0 + r) * k + j);
  }
  if (tid == 0) tickets[blockIdx.y] = 0;  // ready for the next search
}

template <int QB, int VEC>
cudaError_t launch(const float* q, const float* items, const int* excl,
                   u64* lists, int* tickets, float* out_s, int* out_i, int B,
                   int I, int D, int E, int k, int K2, int n_blocks,
                   int per_block, int P, cudaStream_t stream) {
  // at most 8 * (512 + 128 + 1) * 8 + (8 + 8 * 64 + 1) * 4 bytes: no
  // opt-in
  const size_t smem = sizeof(u64) * QB * (kRow + K2 + 1) +
                      sizeof(int) * (QB + QB * E + 1);
  dim3 grid(n_blocks, (B + QB - 1) / QB);
  topk_dot_kernel<QB, VEC><<<grid, kThreads, smem, stream>>>(
      q, items, excl, lists, tickets, out_s, out_i, B, I, D, E, k, K2,
      per_block, P);
  return cudaGetLastError();
}

template <int VEC>
cudaError_t launch_rows(const float* q, const float* items, const int* excl,
                        u64* lists, int* tickets, float* out_s, int* out_i,
                        int B, int I, int D, int E, int k, int K2,
                        int n_blocks, int per_block, int P,
                        cudaStream_t stream) {
  if (B >= 8)
    return launch<8, VEC>(q, items, excl, lists, tickets, out_s, out_i, B, I,
                          D, E, k, K2, n_blocks, per_block, P, stream);
  if (B >= 4)
    return launch<4, VEC>(q, items, excl, lists, tickets, out_s, out_i, B, I,
                          D, E, k, K2, n_blocks, per_block, P, stream);
  if (B >= 2)
    return launch<2, VEC>(q, items, excl, lists, tickets, out_s, out_i, B, I,
                          D, E, k, K2, n_blocks, per_block, P, stream);
  return launch<1, VEC>(q, items, excl, lists, tickets, out_s, out_i, B, I, D,
                        E, k, K2, n_blocks, per_block, P, stream);
}

}  // namespace

// The C entry the Python wrapper calls through ctypes. The wrapper has
// checked shapes, types, devices and caps (B <= 128, E <= 64,
// 1 <= k <= K2 <= 128, K2 a power of two, P in {8, 16, 32}), planned the
// grid (n_blocks x per_block items covering [0, I)), allocated `lists`
// ([ceil(B / QB), K2, n_blocks, QB] 64-bit, QB = 8, 4, 2 or 1 by B) and
// the outputs, and passes `tickets`: at least ceil(B / QB) int32 counters,
// zero, owned by this stream. Launches one kernel on `stream` without
// synchronising and returns cudaGetLastError() (0 = launched).
extern "C" int topk_dot_launch(const float* q, const float* items,
                               const int* excl, void* lists, int* tickets,
                               float* out_s, int* out_i, int B, int I, int D,
                               int E, int k, int K2, int n_blocks,
                               int per_block, int P, int vec4,
                               void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  u64* l = static_cast<u64*>(lists);
  cudaError_t err =
      vec4 ? launch_rows<4>(q, items, excl, l, tickets, out_s, out_i, B, I, D,
                            E, k, K2, n_blocks, per_block, P, stream)
           : launch_rows<1>(q, items, excl, l, tickets, out_s, out_i, B, I, D,
                            E, k, K2, n_blocks, per_block, P, stream);
  return (int)err;
}

extern "C" const char* topk_dot_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
