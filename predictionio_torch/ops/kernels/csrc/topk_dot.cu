// Fused dot product + top-k for exact retrieval, for Hopper (sm_90a).
//
// Replaces the TPU kernel predictionio_tpu/ops/pallas/topk_dot.py::
// _topk_dot_kernel. For queries q [B, D] against an item table [I, D]
// (f32, row-major) it returns, per query row, the k best items of
// q . item^T as (scores [B, k] f32, ids [B, k] int32). Excluded ids
// (excl [B, E], -1 pads, ids outside [0, I) ignored) score NEG_INF =
// -1e30 and still fill slots when nothing better is left. The [B, I]
// logits never reach device memory.
//
// Order: score descending, then item id ascending — one total order,
// the same as the plain version (ops/kernels/topk_dot.py::
// topk_dot_reference). Each candidate is one 64-bit key:
//   high 32 bits: the score's bits mapped so that unsigned order is float
//                 order (-0.0 is folded into +0.0 first),
//   low 32 bits:  0xFFFFFFFF - id, so a lower id is a larger key.
// Key 0 is below every real candidate and marks an empty slot.
//
// What bounds it: the table read, I*D*4 bytes once (6.8 MB at
// MovieLens-20M, rank 64: about 2 us at 3.35 TB/s), against 2*B*I*D
// flops, which at B <= 128 is far below the f32 rate. At B = 1 (a lone
// query) the launch dominates. The design spreads the table over many
// blocks so the read runs in parallel, and keeps the selection in shared
// memory:
//
// Pass 1 (topk_dot_tiles): grid = tiles x query blocks of QB rows. A
//   block walks its tile in chunks of CH = 256 - K2 items (K2 = k rounded
//   up to a power of two). Per chunk it stages q and the items through
//   shared memory 32 columns at a time (16-byte coalesced loads when D is
//   a multiple of 4), computes the QB x CH f32 dots, masks the ragged
//   tail and the exclusions, and places the chunk's keys after the
//   running top-K2 of each row; one bitonic sort of the 256 keys
//   (descending) leaves the new running top-K2 in front. The tile's
//   top-K2 keys go to a scratch [B, n_tiles, K2] that the wrapper
//   allocates.
// Pass 2 (topk_dot_merge): one block per query row loads its n_tiles
//   sorted lists into shared memory and merges them pairwise in a tree:
//   max(A[i], B[K2-1-i]) keeps the top K2 of two sorted lists as a
//   bitonic sequence, and log2(K2) half-cleaner steps sort it. The first
//   k keys are decoded into (score, id).
//
// No wgmma, TMA or single-pass merge yet: a simple kernel that is right
// comes first.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // block size of both passes
constexpr int kSlots = 256;     // keys per row per sort: K2 running + CH chunk
constexpr int kDC = 32;         // columns of q and items staged at a time
constexpr float kNegInf = -1e30f;

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

// Bitonic sort, descending, of `rows` independent rows of kSlots keys.
__device__ void sort_rows_desc(u64* keys, int rows) {
  const int half = kSlots / 2;
  for (int size = 2; size <= kSlots; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int p = threadIdx.x; p < rows * half; p += blockDim.x) {
        const int r = p / half, j = p % half;
        const int a = 2 * j - (j & (stride - 1));
        u64* row = keys + r * kSlots;
        const u64 ka = row[a], kb = row[a + stride];
        const bool desc = (a & size) == 0;
        if ((ka < kb) == desc) {
          row[a] = kb;
          row[a + stride] = ka;
        }
      }
      __syncthreads();
    }
  }
}

template <int QB>
__global__ void __launch_bounds__(kThreads)
topk_dot_tiles(const float* __restrict__ q, const float* __restrict__ items,
               const int* __restrict__ excl, u64* __restrict__ cand,
               int B, int I, int D, int E, int K2, int chunks_per_tile,
               int n_tiles, int vec4) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* keys = reinterpret_cast<u64*>(smem);                   // [QB][kSlots]
  float* its = reinterpret_cast<float*>(keys + QB * kSlots);  // [CH][kDC+1]
  float* qs = its + kSlots * (kDC + 1);                       // [QB][kDC]
  int* ex = reinterpret_cast<int*>(qs + QB * kDC);            // [QB][E]

  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int b0 = blockIdx.y * QB;
  const int CH = kSlots - K2;
  const int n_chunks = (I + CH - 1) / CH;

  for (int i = tid; i < QB * E; i += kThreads) {
    const int r = i / E;
    ex[i] = (b0 + r < B) ? excl[(long long)(b0 + r) * E + i % E] : -1;
  }
  for (int i = tid; i < QB * kSlots; i += kThreads) keys[i] = 0ull;
  __syncthreads();

  const int c_end = min((tile + 1) * chunks_per_tile, n_chunks);
  for (int c = tile * chunks_per_tile; c < c_end; ++c) {
    const long long base = (long long)c * CH;
    float acc[QB];
#pragma unroll
    for (int r = 0; r < QB; ++r) acc[r] = 0.0f;

    for (int d0 = 0; d0 < D; d0 += kDC) {
      const int dc = min(kDC, D - d0);
      for (int i = tid; i < QB * dc; i += kThreads) {
        const int r = i / dc;
        qs[r * kDC + i % dc] =
            (b0 + r < B) ? q[(long long)(b0 + r) * D + d0 + i % dc] : 0.0f;
      }
      if (vec4) {
        // dc is a multiple of 4 here: 16-byte loads, neighbouring threads
        // on neighbouring addresses of one row
        const int nv = dc >> 2;
        for (int L = tid; L < CH * nv; L += kThreads) {
          const int i = L / nv, v = L % nv;
          const long long g = base + i;
          float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
          if (g < I)
            x = *reinterpret_cast<const float4*>(items + g * D + d0 + 4 * v);
          float* dst = its + i * (kDC + 1) + 4 * v;
          dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
        }
      } else {
        for (int L = tid; L < CH * dc; L += kThreads) {
          const int i = L / dc, d = L % dc;
          const long long g = base + i;
          its[i * (kDC + 1) + d] = (g < I) ? items[g * D + d0 + d] : 0.0f;
        }
      }
      __syncthreads();
      if (tid < CH) {
        const float* row = its + tid * (kDC + 1);  // stride 33: no conflicts
        for (int dd = 0; dd < dc; ++dd) {
          const float x = row[dd];
#pragma unroll
          for (int r = 0; r < QB; ++r) acc[r] = fmaf(qs[r * kDC + dd], x, acc[r]);
        }
      }
      __syncthreads();
    }

    if (tid < CH) {
      const long long g = base + tid;
#pragma unroll
      for (int r = 0; r < QB; ++r) {
        u64 key = 0ull;
        if (g < I && b0 + r < B) {
          float s = acc[r];
          for (int e = 0; e < E; ++e)
            if ((long long)ex[r * E + e] == g) s = kNegInf;
          key = make_key(s, g);
        }
        keys[r * kSlots + K2 + tid] = key;
      }
    }
    __syncthreads();
    sort_rows_desc(keys, QB);
  }

  for (int i = tid; i < QB * K2; i += kThreads) {
    const int r = i / K2;
    if (b0 + r < B)
      cand[((long long)(b0 + r) * n_tiles + tile) * K2 + i % K2] =
          keys[r * kSlots + i % K2];
  }
}

__global__ void __launch_bounds__(kThreads)
topk_dot_merge(const u64* __restrict__ cand, float* __restrict__ out_s,
               int* __restrict__ out_i, int n_tiles, int K2, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* lists = reinterpret_cast<u64*>(smem);  // [n_tiles][K2], each sorted
  const int b = blockIdx.x;
  const int n = n_tiles * K2;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    lists[i] = cand[(long long)b * n + i];
  __syncthreads();

  for (int step = 1; step < n_tiles; step <<= 1) {
    // pair m merges list m*2*step with list m*2*step + step into the first
    const int pairs = (n_tiles - step + 2 * step - 1) / (2 * step);
    for (int p = threadIdx.x; p < pairs * K2; p += blockDim.x) {
      const int m = p / K2, i = p % K2;
      u64* A = lists + (long long)m * 2 * step * K2;
      const u64 x = A[i], y = A[step * K2 + K2 - 1 - i];
      A[i] = x > y ? x : y;
    }
    __syncthreads();
    const int half = K2 / 2;
    for (int stride = half; stride > 0; stride >>= 1) {
      for (int p = threadIdx.x; p < pairs * half; p += blockDim.x) {
        const int m = p / half, j = p % half;
        const int a = 2 * j - (j & (stride - 1));
        u64* A = lists + (long long)m * 2 * step * K2;
        const u64 ka = A[a], kb = A[a + stride];
        if (ka < kb) {
          A[a] = kb;
          A[a + stride] = ka;
        }
      }
      __syncthreads();
    }
  }

  for (int j = threadIdx.x; j < k; j += blockDim.x)
    decode_key(lists[j], out_s + (long long)b * k + j,
               out_i + (long long)b * k + j);
}

constexpr int kMaxExclude = 64;     // topk_dot.py MAX_EXCLUDE
constexpr int kMaxDevices = 64;

template <int QB>
constexpr size_t tiles_smem(int E) {
  return sizeof(u64) * QB * kSlots +
         sizeof(float) * (kSlots * (kDC + 1) + QB * kDC) + sizeof(int) * QB * E;
}

template <int QB>
cudaError_t launch_tiles(const float* q, const float* items, const int* excl,
                         u64* cand, int B, int I, int D, int E, int K2,
                         int chunks_per_tile, int n_tiles, int vec4,
                         cudaStream_t stream) {
  // above 48 KB (QB = 8) dynamic shared memory needs an opt-in, set once
  // per instantiation and device for the largest E; racing first calls
  // set the same value
  static bool opted_in[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !opted_in[dev]) {
    err = cudaFuncSetAttribute(
        topk_dot_tiles<QB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)tiles_smem<QB>(kMaxExclude));
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) opted_in[dev] = true;
  }
  const size_t smem = tiles_smem<QB>(E);
  dim3 grid(n_tiles, (B + QB - 1) / QB);
  topk_dot_tiles<QB><<<grid, kThreads, smem, stream>>>(
      q, items, excl, cand, B, I, D, E, K2, chunks_per_tile, n_tiles, vec4);
  return cudaGetLastError();
}

}  // namespace

// The C entry the Python wrapper calls through ctypes. The wrapper has
// checked shapes, types, devices and caps (B, k <= 128, E <= 64,
// 1 <= k <= K2 <= 128, K2 a power of two, n_tiles * K2 <= 4096) and
// allocated `cand`
// ([B, n_tiles, K2] 64-bit) and the outputs on the current device.
// Launches both passes on `stream` without synchronising and returns
// cudaGetLastError() (0 = launched).
extern "C" int topk_dot_launch(const float* q, const float* items,
                               const int* excl, void* cand, float* out_s,
                               int* out_i, int B, int I, int D, int E, int k,
                               int K2, int chunks_per_tile, int n_tiles,
                               int vec4, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  u64* c = static_cast<u64*>(cand);
  cudaError_t err;
  if (B >= 8)
    err = launch_tiles<8>(q, items, excl, c, B, I, D, E, K2, chunks_per_tile,
                          n_tiles, vec4, stream);
  else if (B >= 4)
    err = launch_tiles<4>(q, items, excl, c, B, I, D, E, K2, chunks_per_tile,
                          n_tiles, vec4, stream);
  else if (B >= 2)
    err = launch_tiles<2>(q, items, excl, c, B, I, D, E, K2, chunks_per_tile,
                          n_tiles, vec4, stream);
  else
    err = launch_tiles<1>(q, items, excl, c, B, I, D, E, K2, chunks_per_tile,
                          n_tiles, vec4, stream);
  if (err != cudaSuccess) return (int)err;
  // n_tiles * K2 <= MAX_CANDIDATES = 4096 keys: 32 KB, under the 48 KB
  // that needs no opt-in
  const size_t smem = sizeof(u64) * (size_t)n_tiles * K2;
  topk_dot_merge<<<B, kThreads, smem, stream>>>(c, out_s, out_i, n_tiles, K2,
                                                 k);
  return (int)cudaGetLastError();
}

extern "C" const char* topk_dot_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
