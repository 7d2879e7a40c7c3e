// flash_ce: the two-tower symmetric in-batch softmax cross-entropy,
// forward and backward, for Hopper (sm_90a).
//
// Replaces predictionio_tpu/ops/pallas/flash_ce.py: make_flash_ce's
// forward pallas_call (body _fwd_kernel) and its backward pallas_calls
// (bodies _bwd_du_kernel and _bwd_dv_kernel), with the helpers
// _tile_logits, _tile_masks and _bwd_coef restated on 64 x 64 tiles.
//
// What it computes, for unit-norm towers u, v [B, D] and the batch's
// user ids, item ids and weights:
//
//   L[b,j]   = f32(cdt(cdt(sum_d cdt(u[b,d]) cdt(v[j,d])) / temp))
//   fwd      sum_ui[b]  = sum_j exp(L[b,j])  (not ban_ui)
//            iu_parts[i, j] = sum_{b in row tile i} exp(L[b,j])  (not ban_iu)
//            diag[b]    = L[b,b]
//   bwd      coef[b,j]  = (w_b (p_ui - delta) + w_j (p_iu - delta)) * scale
//            du = cdt(coef) . cdt(v),  dv = cdt(coef)^T . cdt(u)  (f32 sums)
//
// with ban_ui = (i_idx[j] == i_idx[b] | w_j <= 0) & b != j and
// ban_iu = (u_idx[b] == u_idx[j] | w_b <= 0) & b != j, p_ui =
// exp(L - lse_ui[b]) and p_iu = exp(L - lse_iu[j]). The rounding of
// the logits is the JAX package's exactly (matmul output in cdt, then
// the divide by the cdt-rounded temperature in cdt), in all three
// passes, so the backward reconstructs probabilities consistent with
// the saved LSEs. cdt = float32 is true f32 on the CUDA cores (no TF32);
// cdt = bfloat16 runs the products on the tensor cores through WMMA
// (bf16 fragments, f32 accumulation).
//
// Layout. One block of 256 threads owns one 64-row tile (forward, du)
// or one 64-column tile (dv) and loops over every tile of the other
// side in order, so each output accumulates in a fixed order inside one
// block: no atomics, and the loss is the same from run to run. The
// TPU's sequential grid carried the row sums across grid steps in VMEM;
// here the loop inside the block does. Column exp-sums of the forward
// cannot accumulate in one block, so, like the Pallas kernel, it writes
// one partial per row tile ([n_tiles, B]) and the wrapper sums them.
// Rows and columns past B are masked (they contribute nothing), so no
// padding copy is made. D is padded with zeros in shared memory to 32,
// 64, 128 or 256.
//
// What bounds it on the card: 2 B^2 D products for the forward and
// 4 B^2 D for the backward (the logits recompute adds another 4 B^2 D,
// a cost of this design), plus B^2 exponentials per pass. At B = 8192,
// D = 128 in bf16 that is 17 GFLOP forward, about 17 us at the tensor
// cores' peak. This first version favours being right: WMMA without
// TMA or wgmma, one block per 64-row tile, no pipelining of the loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int kTile = 64;       // rows and columns of one logits tile
constexpr int kThreads = 256;   // thread (ty, tx) = (tid / 16, tid % 16)
constexpr int kLdl = 68;        // float stride of the staged logits tile

enum Mode { kForward = 0, kGradU = 1, kGradV = 2 };

struct Params {
  const float* u;
  const float* v;
  const long long* u_idx;
  const long long* i_idx;
  const float* w;
  const float* lse_ui;    // backward
  const float* lse_iu;    // backward
  const float* scale;     // backward: ct / (2 sum(w) temp), one float
  float* sum_ui;          // forward [B]
  float* diag;            // forward [B]
  float* iu_parts;        // forward [n_tiles, B]
  float* out;             // backward [B, D]: du or dv
  int B, D, Dp, n_tiles;
  float temp;             // the divisor, already rounded to cdt
};

// Byte offsets of the shared-memory regions, each 128-byte aligned.
struct Plan {
  unsigned own, oth, ls, coef, meta, colpart, total;
  int ldk, ldc;
};

__host__ __device__ inline unsigned take(unsigned* off, unsigned bytes) {
  const unsigned at = *off;
  *off = (at + bytes + 127u) & ~127u;
  return at;
}

__host__ __device__ inline Plan plan(int Dp, bool is_bf16, int mode) {
  Plan s;
  const unsigned es = is_bf16 ? 2u : 4u;
  // bf16: strides a multiple of 8 elements (WMMA); f32: odd strides,
  // so the 16 threads of a row read 16 different banks
  s.ldk = Dp + (is_bf16 ? 8 : 1);
  s.ldc = kTile + (is_bf16 ? 8 : 1);
  unsigned off = 0;
  s.own = take(&off, kTile * s.ldk * es);
  s.oth = take(&off, kTile * s.ldk * es);
  s.ls = take(&off, is_bf16 ? kTile * kLdl * 4u : 0u);
  s.coef = take(&off, mode != kForward ? kTile * s.ldc * es : 0u);
  s.meta = take(&off, 4 * kTile * 8u + 4 * kTile * 4u);
  s.colpart = take(&off, mode == kForward ? 16 * kTile * 4u : 0u);
  s.total = off;
  return s;
}

template <typename T> __device__ __forceinline__ T to_cdt(float x);
template <> __device__ __forceinline__ float to_cdt<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 to_cdt<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// One 64-row tile of u or v into shared memory as cdt, zero past B and D.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int ldk, const float* src,
                                          int base, const Params& p,
                                          int tid) {
  for (int e = tid; e < kTile * p.Dp; e += kThreads) {
    const int r = e / p.Dp;
    const int k = e - r * p.Dp;
    const int g = base + r;
    const float x = (g < p.B && k < p.D) ? src[(size_t)g * p.D + k] : 0.f;
    dst[r * ldk + k] = to_cdt<T>(x);
  }
}

// Ids, weights and (backward) saved LSEs of one tile's 64 entries; a
// row tile takes lse_ui, a column tile lse_iu.
__device__ __forceinline__ void load_meta(const Params& p, int base,
                                          bool row_side, bool backward,
                                          long long* mu, long long* mi,
                                          float* mw, float* ml, int tid) {
  if (tid < kTile) {
    const int g = base + tid;
    const bool ok = g < p.B;
    mu[tid] = ok ? p.u_idx[g] : 0;
    mi[tid] = ok ? p.i_idx[g] : 0;
    mw[tid] = ok ? p.w[g] : 0.f;
    ml[tid] = (ok && backward) ? (row_side ? p.lse_ui[g] : p.lse_iu[g])
                               : 0.f;
  }
}

template <typename T, int MODE, int NFW>
__global__ void __launch_bounds__(kThreads) flash_ce_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  constexpr bool kBackward = MODE != kForward;
  constexpr bool kOwnRows = MODE != kGradV;
  const Plan s = plan(p.Dp, kBf16, MODE);
  T* own = reinterpret_cast<T*>(smem + s.own);
  T* oth = reinterpret_cast<T*>(smem + s.oth);
  float* ls = reinterpret_cast<float*>(smem + s.ls);
  T* coef = reinterpret_cast<T*>(smem + s.coef);
  long long* own_u = reinterpret_cast<long long*>(smem + s.meta);
  long long* own_i = own_u + kTile;
  long long* oth_u = own_i + kTile;
  long long* oth_i = oth_u + kTile;
  float* own_w = reinterpret_cast<float*>(oth_i + kTile);
  float* own_l = own_w + kTile;
  float* oth_w = own_l + kTile;
  float* oth_l = oth_w + kTile;
  float* colpart = reinterpret_cast<float*>(smem + s.colpart);

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int t = blockIdx.x;

  const float* own_src = kOwnRows ? p.u : p.v;
  const float* oth_src = kOwnRows ? p.v : p.u;
  load_tile<T>(own, s.ldk, own_src, t * kTile, p, tid);
  load_meta(p, t * kTile, kOwnRows, kBackward, own_u, own_i, own_w, own_l,
            tid);

  // the logits tile is always [row][col]: u rows times v columns
  const T* rows = kOwnRows ? own : oth;
  const T* cols = kOwnRows ? oth : own;
  const long long* r_user = kOwnRows ? own_u : oth_u;
  const long long* r_item = kOwnRows ? own_i : oth_i;
  const float* r_w = kOwnRows ? own_w : oth_w;
  const float* r_lse = kOwnRows ? own_l : oth_l;
  const long long* c_user = kOwnRows ? oth_u : own_u;
  const long long* c_item = kOwnRows ? oth_i : own_i;
  const float* c_w = kOwnRows ? oth_w : own_w;
  const float* c_lse = kOwnRows ? oth_l : own_l;
  const float scale = kBackward ? *p.scale : 0.f;

  float row_acc[4] = {0.f, 0.f, 0.f, 0.f};
  // backward accumulators: the block's 64 x Dp rows of du or dv
  float acc2[4][2 * NFW];
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> frag2[NFW];
  if constexpr (kBackward) {
    if constexpr (kBf16) {
#pragma unroll
      for (int f = 0; f < NFW; ++f) wmma::fill_fragment(frag2[f], 0.f);
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 2 * NFW; ++c) acc2[r][c] = 0.f;
    }
  }

  for (int sidx = 0; sidx < p.n_tiles; ++sidx) {
    __syncthreads();   // the previous step is done with oth, ls, coef
    load_tile<T>(oth, s.ldk, oth_src, sidx * kTile, p, tid);
    load_meta(p, sidx * kTile, !kOwnRows, kBackward, oth_u, oth_i, oth_w,
              oth_l, tid);
    __syncthreads();
    const int ri = kOwnRows ? t : sidx;    // row tile
    const int ci = kOwnRows ? sidx : t;    // column tile

    // -- tile logits, raw f32 sums: thread holds rows ty+16r, cols tx+16c
    float acc[4][4];
    if constexpr (kBf16) {
      const int fr = warp >> 1;
      const int fc = (warp & 1) * 2;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c0, c1;
      wmma::fill_fragment(c0, 0.f);
      wmma::fill_fragment(c1, 0.f);
      for (int k0 = 0; k0 < p.Dp; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(a, rows + fr * 16 * s.ldk + k0, s.ldk);
        wmma::load_matrix_sync(b, cols + fc * 16 * s.ldk + k0, s.ldk);
        wmma::mma_sync(c0, a, b, c0);
        wmma::load_matrix_sync(b, cols + (fc + 1) * 16 * s.ldk + k0, s.ldk);
        wmma::mma_sync(c1, a, b, c1);
      }
      wmma::store_matrix_sync(ls + fr * 16 * kLdl + fc * 16, c0, kLdl,
                              wmma::mem_row_major);
      wmma::store_matrix_sync(ls + fr * 16 * kLdl + (fc + 1) * 16, c1, kLdl,
                              wmma::mem_row_major);
      __syncthreads();
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[r][c] = ls[(ty + 16 * r) * kLdl + tx + 16 * c];
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
      for (int k = 0; k < p.D; ++k) {
        float a[4], b[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = rows[(ty + 16 * r) * s.ldk + k];
#pragma unroll
        for (int c = 0; c < 4; ++c) b[c] = cols[(tx + 16 * c) * s.ldk + k];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
      }
    }

    // -- rounding, masks, exponentials
    float rs[4] = {0.f, 0.f, 0.f, 0.f};
    float cs[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int lr = ty + 16 * r;
      const int gr = ri * kTile + lr;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int lc = tx + 16 * c;
        const int gc = ci * kTile + lc;
        const bool valid = gr < p.B && gc < p.B;
        float x = acc[r][c];
        if constexpr (kBf16) {
          x = round_bf16(round_bf16(x) / p.temp);
        } else {
          x = x / p.temp;
        }
        const bool not_diag = gr != gc;
        const bool ban_ui = ((c_item[lc] == r_item[lr]) || c_w[lc] <= 0.f) && not_diag;
        const bool ban_iu = ((r_user[lr] == c_user[lc]) || r_w[lr] <= 0.f) && not_diag;
        if constexpr (!kBackward) {
          const float e = expf(x);
          if (valid) {
            rs[r] += ban_ui ? 0.f : e;
            cs[c] += ban_iu ? 0.f : e;
            if (!not_diag) p.diag[gr] = x;
          }
        } else {
          float cf = 0.f;
          if (valid) {
            const float p_ui = ban_ui ? 0.f : expf(x - r_lse[lr]);
            const float p_iu = ban_iu ? 0.f : expf(x - c_lse[lc]);
            const float isdiag = not_diag ? 0.f : 1.f;
            cf = (r_w[lr] * (p_ui - isdiag) + c_w[lc] * (p_iu - isdiag)) * scale;
          }
          coef[lr * s.ldc + lc] = to_cdt<T>(cf);
        }
      }
    }

    if constexpr (!kBackward) {
      // row sums: the 16 threads of a row are one half-warp
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], off);
        row_acc[r] += rs[r];
      }
      // column sums over this row tile, in a fixed order
#pragma unroll
      for (int c = 0; c < 4; ++c) colpart[ty * kTile + tx + 16 * c] = cs[c];
      __syncthreads();
      if (tid < kTile) {
        float sum = 0.f;
        for (int y = 0; y < 16; ++y) sum += colpart[y * kTile + tid];
        const int g = ci * kTile + tid;
        if (g < p.B) p.iu_parts[(size_t)ri * p.B + g] = sum;
      }
    } else {
      __syncthreads();
      // out[a] += sum_o C(a, o) oth[o]: C = coef (du) or coef^T (dv)
      if constexpr (kBf16) {
        const int am = warp & 3;
        const int dn0 = warp >> 2;
#pragma unroll
        for (int ok = 0; ok < 4; ++ok) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          if constexpr (MODE == kGradU) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
                a;
            wmma::load_matrix_sync(a, coef + am * 16 * s.ldc + ok * 16,
                                   s.ldc);
#pragma unroll
            for (int f = 0; f < NFW; ++f) {
              wmma::load_matrix_sync(
                  b, oth + ok * 16 * s.ldk + (dn0 + 2 * f) * 16, s.ldk);
              wmma::mma_sync(frag2[f], a, b, frag2[f]);
            }
          } else {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>
                a;
            wmma::load_matrix_sync(a, coef + ok * 16 * s.ldc + am * 16,
                                   s.ldc);
#pragma unroll
            for (int f = 0; f < NFW; ++f) {
              wmma::load_matrix_sync(
                  b, oth + ok * 16 * s.ldk + (dn0 + 2 * f) * 16, s.ldk);
              wmma::mma_sync(frag2[f], a, b, frag2[f]);
            }
          }
        }
      } else {
        for (int o = 0; o < kTile; ++o) {
          float cv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int a = ty + 16 * r;
            cv[r] = MODE == kGradU ? coef[a * s.ldc + o] : coef[o * s.ldc + a];
          }
#pragma unroll
          for (int c = 0; c < 2 * NFW; ++c) {
            const float ov = oth[o * s.ldk + tx + 16 * c];
#pragma unroll
            for (int r = 0; r < 4; ++r) acc2[r][c] = fmaf(cv[r], ov, acc2[r][c]);
          }
        }
      }
    }
  }

  if constexpr (!kBackward) {
    if (tx == 0) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int g = t * kTile + ty + 16 * r;
        if (g < p.B) p.sum_ui[g] = row_acc[r];
      }
    }
  } else if constexpr (kBf16) {
    __syncthreads();   // ls is free: stage each warp's fragments there
    float* st = ls + warp * 256;
    const int am = warp & 3;
    const int dn0 = warp >> 2;
#pragma unroll
    for (int f = 0; f < NFW; ++f) {
      wmma::store_matrix_sync(st, frag2[f], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int g = t * kTile + am * 16 + (e >> 4);
        const int d = (dn0 + 2 * f) * 16 + (e & 15);
        if (g < p.B && d < p.D) p.out[(size_t)g * p.D + d] = st[e];
      }
      __syncwarp();
    }
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int g = t * kTile + ty + 16 * r;
#pragma unroll
      for (int c = 0; c < 2 * NFW; ++c) {
        const int d = tx + 16 * c;
        if (g < p.B && d < p.D) p.out[(size_t)g * p.D + d] = acc2[r][c];
      }
    }
  }
}

template <typename T, int MODE, int NFW>
cudaError_t launch_one(const Params& p, cudaStream_t stream) {
  const Plan s = plan(p.Dp, std::is_same<T, bf16>::value, MODE);
  const auto kernel = flash_ce_kernel<T, MODE, NFW>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s.total);
  if (err != cudaSuccess) return err;
  kernel<<<p.n_tiles, kThreads, s.total, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int MODE>
cudaError_t launch_backward(const Params& p, cudaStream_t stream) {
  switch (p.Dp) {
    case 32: return launch_one<T, MODE, 1>(p, stream);
    case 64: return launch_one<T, MODE, 2>(p, stream);
    case 128: return launch_one<T, MODE, 4>(p, stream);
    case 256: return launch_one<T, MODE, 8>(p, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_typed(int mode, const Params& p, cudaStream_t stream) {
  switch (mode) {
    case kForward: return launch_one<T, kForward, 1>(p, stream);
    case kGradU: return launch_backward<T, kGradU>(p, stream);
    case kGradV: return launch_backward<T, kGradV>(p, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int flash_ce_launch(int mode, int is_bf16, const float* u,
                               const float* v, const long long* u_idx,
                               const long long* i_idx, const float* w,
                               const float* lse_ui, const float* lse_iu,
                               const float* scale, float* sum_ui, float* diag,
                               float* iu_parts, float* out, int B, int D,
                               float temp, void* stream) {
  if (B < 1 || D < 1 || D > 256) return (int)cudaErrorInvalidValue;
  Params p;
  p.u = u;
  p.v = v;
  p.u_idx = u_idx;
  p.i_idx = i_idx;
  p.w = w;
  p.lse_ui = lse_ui;
  p.lse_iu = lse_iu;
  p.scale = scale;
  p.sum_ui = sum_ui;
  p.diag = diag;
  p.iu_parts = iu_parts;
  p.out = out;
  p.B = B;
  p.D = D;
  p.Dp = D <= 32 ? 32 : D <= 64 ? 64 : D <= 128 ? 128 : 256;
  p.n_tiles = (B + kTile - 1) / kTile;
  p.temp = temp;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? launch_typed<bf16>(mode, p, st)
                                  : launch_typed<float>(mode, p, st);
  return (int)err;
}

extern "C" const char* flash_ce_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
