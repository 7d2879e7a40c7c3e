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
//            du = cdt(coef) . cdt(v)  (f32 sums)
//
// with ban_ui = (i_idx[j] == i_idx[b] | w_j <= 0) & b != j and
// ban_iu = (u_idx[b] == u_idx[j] | w_b <= 0) & b != j, p_ui =
// exp(L - lse_ui[b]) and p_iu = exp(L - lse_iu[j]). The rounding of
// the logits is the JAX package's exactly (matmul output in cdt, then
// a true divide by the cdt-rounded temperature, rounded to cdt), in
// both passes, so the backward reconstructs probabilities consistent
// with the saved LSEs.
//
// One backward kernel serves both gradients. The loss is symmetric:
// called with u <-> v, u_idx <-> i_idx and lse_ui <-> lse_iu swapped,
// its tile is L'[j,b] = L[b,j], its bans are ban_iu and ban_ui, its
// coef is coef^T, so it returns dv = coef^T . v'. No dv mode exists.
//
// Rows and columns past B load as zeros with zero weight and zero ids
// (cp.async zero-fill), which bans them or gives them a zero coef, so
// no padding copy of the batch is made; outputs past B are not
// written.
//
// Determinism: the loop over the other side is split into S chunks
// (grid n_tiles x S); each block writes its own partial (forward row
// sums [S, B], backward gradient [S, B, D] f32) and the wrapper sums
// the partials in a fixed order. Each (row tile, column tile) pair has
// one owner, so the column exp-sums go to iu_parts [n_tiles, B] as in
// the Pallas kernel. No atomics: the loss and its gradients are the
// same bit for bit from run to run.
//
// cdt = bfloat16 (both train paths). What bounds it at B = 8192,
// D = 128: the products (2 B^2 D forward, 4 B^2 D backward with the
// logits recompute) need 0.052 ms at the tensor cores' peak, the B^2
// exponentials of the forward and 2 B^2 of the backward 0.048 ms at
// the special-function units' rate (the two backward passes here
// compute 4 B^2, as each recomputes the tile), and the per-logit
// epilogue about as much again on the CUDA cores: two bf16 roundings,
// a divide, four id compares, selects, the sums or the coef
// arithmetic and its conversion, some 15-25 instructions for each of
// the 67 M logits of a pass. The design keeps everything else out of
// the way of the products and that epilogue:
// - u and v arrive as bf16 [B, Dp] (cast once per loss by the
//   wrapper), read with 16-byte cp.async into a ring of kStages
//   shared-memory stages, so tile s+1 (and its ids, weights and LSEs)
//   loads while tile s computes; one __syncthreads per step.
// - A block is 4 warps on a 64-row tile; each warp owns 16 rows
//   against the 64 columns of the other tile and runs
//   mma.sync.m16n8k16 (bf16 in, f32 out) on operands taken with
//   ldmatrix from padded rows (Dp + 8 elements: no bank conflicts);
//   the forward keeps its own 16 x Dp operand in registers.
// - The logits stay in the accumulator registers: rounding (two
//   values per cvt), divide, masks and ex2.approx work there. The
//   divide is a true one, correctly rounded, as a product by the
//   correctly rounded reciprocal and one FMA correction (div_rn), a
//   third of a divide's instructions. Only the diagonal tile tests
//   for the diagonal. The forward's row sums stay in registers to the
//   end (one quad shuffle then); its column sums reduce-scatter
//   across the warp's 8 row groups (14 shuffles), and the 4 warps'
//   partials combine in shared memory behind the next step's barrier.
// - Backward: the coef tile, in the accumulator layout, converted to
//   bf16 pairs, is directly the A operand of coef . oth (with oth
//   taken through ldmatrix.trans): it never goes to shared memory.
// - Split grid: n_tiles x S blocks, S from the wrapper (flash_ce.py
//   SPLIT = 3): at B = 8192 that is 384 blocks, and with 118-168
//   registers a thread and 75 KB of shared memory a block the card
//   holds 3 blocks on each of its 132 SMs, so all of them run in one
//   wave. S = 6 measured the same, S = 2 and 4 slower (PERF.md); the
//   backward partials are 12 MB at S = 3. At Dp = 256 a block's
//   gradient covers 128 of the columns (grid z = 2), so its
//   accumulator stays in registers without spills.
//
// Exponentials use ex2.approx on x log2(e) (x log2(e) - lse log2(e)
// in one FMA in the backward): a relative error of about 2^-22 per
// term, far under the bf16 tolerances.
//
// cdt = float32 is true f32 on the CUDA cores (no TF32, an IEEE
// divide, expf), 256 threads each holding a 4 x 4 piece of the logits
// tile, with synchronous loads; no train path uses it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kTile = 64;       // rows and columns of one logits tile
constexpr int kStages = 3;      // cp.async ring depth (bf16)
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* u;          // row side: bf16 [B, Dp] or f32 [B, D]
  const void* v;          // column side, the same
  const int* u_idx;
  const int* i_idx;
  const float* w;
  const float* lse_ui;    // backward
  const float* lse_iu;    // backward
  const float* scale;     // backward: ct / (2 sum(w) temp), one float
  float* sum_ui;          // forward [S, B]
  float* diag;            // forward [B]
  float* iu_parts;        // forward [n_tiles, B]
  float* out;             // backward [S, B, D]
  int B, D, Dp, n_tiles;
  float temp;             // the divisor, already rounded to cdt
};

// ---------------------------------------------------------------- bf16

// both values rounded to bf16 by one cvt.rn.bf16x2.f32
__device__ __forceinline__ void round_bf16x2(float& a, float& b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  a = __low2float(h);
  b = __high2float(h);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled when !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a . b on a 16 x 8 x 16 tile: bf16 operands, f32 accumulator
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// a / b correctly rounded, from rcp_b = 1/b correctly rounded: a
// product and one FMA correction (Markstein). Equal to a true divide
// for every bf16 numerator of magnitude above 1e-30 at the bf16
// temperatures the loss allows (checked exhaustively against exact
// rational arithmetic); below that the FMA residual is subnormal, and
// such a logit's exp is 1 either way.
__device__ __forceinline__ float div_rn(float a, float b, float rcp_b) {
  const float q = __fmul_rn(a, rcp_b);
  return fmaf(fmaf(-q, b, a), rcp_b, q);
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// Shared memory of the bf16 kernel, in bytes: the own tile and its
// ids / weights / LSEs, kStages stages of the other side's tile and
// its ids / weights / LSEs, then the forward's column partials.
template <int DP>
struct Layout {
  static constexpr int kLdk = DP + 8;   // row stride in elements
  static constexpr unsigned kTileBytes = kTile * kLdk * 2;
  static constexpr unsigned kMetaBytes = 4 * kTile * 4;
  static constexpr unsigned kStageBytes = kTileBytes + kMetaBytes;
  static constexpr unsigned kRing = kTileBytes + kMetaBytes;
  static constexpr unsigned kColpart = kRing + kStages * kStageBytes;
  static constexpr unsigned kTotal = kColpart + 2 * 4 * kTile * 4;
};

// ids, weights and (with_lse) LSEs of the 64 entries from base, as
// int u[64], int i[64], float w[64], float lse[64]
__device__ __forceinline__ void load_meta(unsigned char* dst, const Params& p,
                                          int base, const float* lse,
                                          int tid) {
  int* mu = reinterpret_cast<int*>(dst);
  const int e = tid & (kTile - 1);
  const int g = base + e;
  const bool ok = g < p.B;
  const int gs = ok ? g : 0;
  if (tid < kTile) {
    cp_async4(mu + e, p.u_idx + gs, ok);
    cp_async4(mu + kTile + e, p.i_idx + gs, ok);
  } else {
    cp_async4(mu + 2 * kTile + e, p.w + gs, ok);
    if (lse != nullptr) cp_async4(mu + 3 * kTile + e, lse + gs, ok);
  }
}

template <int DP>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int base, int B, int tid) {
  constexpr int kChunks = DP / 8;   // 16-byte pieces of a row
#pragma unroll
  for (int c = tid; c < kTile * kChunks; c += 128) {
    const int r = c / kChunks;
    const int k = (c % kChunks) * 8;
    const int g = base + r;
    const bool ok = g < B;
    cp_async16(dst + r * Layout<DP>::kLdk + k,
               src + (size_t)(ok ? g : 0) * DP + k, ok);
  }
}

// 4 warps; warp w owns rows 16w..16w+15 of the block's row tile. In
// mma.sync's accumulator layout lane (g, q) = (lane / 4, lane % 4)
// holds, for each 8-column slice n, rows g and g + 8 at columns
// 8n + 2q and 8n + 2q + 1: acc[n][2h + e].
template <int DP, bool BWD>
__global__ void __launch_bounds__(128) flash_ce_kernel_bf16(Params p) {
  using L = Layout<DP>;
  constexpr int LDK = L::kLdk;
  constexpr int KSTEPS = DP / 16;
  constexpr int DC = DP > 128 ? 128 : DP;    // gradient columns per block
  constexpr bool kARegs = !BWD && DP <= 128; // own operand in registers
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* own = reinterpret_cast<bf16*>(smem);
  unsigned char* own_meta = smem + L::kTileBytes;
  float* colpart = reinterpret_cast<float*>(smem + L::kColpart);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int t = blockIdx.x;
  const int S = gridDim.y;
  const int s = blockIdx.y;
  const int k0 = s * p.n_tiles / S;
  const int k1 = (s + 1) * p.n_tiles / S;
  const int nsteps = k1 - k0;
  const int dbase = blockIdx.z * DC;
  const bf16* U = static_cast<const bf16*>(p.u);
  const bf16* V = static_cast<const bf16*>(p.v);

  auto stage_tile = [&](int st) {
    return reinterpret_cast<bf16*>(smem + L::kRing + st * L::kStageBytes);
  };
  auto stage_meta = [&](int st) {
    return smem + L::kRing + st * L::kStageBytes + L::kTileBytes;
  };

  // prologue: the own tile and its meta, then the first stages
  load_tile<DP>(own, U, t * kTile, p.B, tid);
  load_meta(own_meta, p, t * kTile, BWD ? p.lse_ui : nullptr, tid);
  cp_async_commit();
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nsteps) {
      load_tile<DP>(stage_tile(st), V, (k0 + st) * kTile, p.B, tid);
      load_meta(stage_meta(st), p, (k0 + st) * kTile,
                BWD ? p.lse_iu : nullptr, tid);
    }
    cp_async_commit();
  }

  const float scale = BWD ? *p.scale : 0.f;
  const float rcp = __frcp_rn(p.temp);
  unsigned areg[kARegs ? KSTEPS : 1][4];
  int r_user[2], r_item[2];
  float r_w[2], r_lse[2];
  bool r_pad[2];
  const int r_g[2] = {t * kTile + warp * 16 + g, t * kTile + warp * 16 + g + 8};
  float row_acc[2] = {0.f, 0.f};
  float gacc[DC / 8][4];
#pragma unroll
  for (int n = 0; n < DC / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) gacc[n][e] = 0.f;

  // the forward's column partials of step i, combined across warps
  auto flush_colpart = [&](int buf, int ci) {
    if (tid < kTile) {
      const float* cp = colpart + buf * 4 * kTile;
      const float sum = ((cp[tid] + cp[kTile + tid]) + cp[2 * kTile + tid]) +
                        cp[3 * kTile + tid];
      const int gc = ci * kTile + tid;
      if (gc < p.B) p.iu_parts[(size_t)t * p.B + gc] = sum;
    }
  };

  for (int i = 0; i < nsteps; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // tile i is in; every warp is done with step i - 1
    {
      const int kn = i + kStages - 1;
      if (kn < nsteps) {
        const int st = kn % kStages;
        load_tile<DP>(stage_tile(st), V, (k0 + kn) * kTile, p.B, tid);
        load_meta(stage_meta(st), p, (k0 + kn) * kTile,
                  BWD ? p.lse_iu : nullptr, tid);
      }
      cp_async_commit();
    }
    if (i == 0) {
      const int* mu = reinterpret_cast<const int*>(own_meta);
      const float* mf = reinterpret_cast<const float*>(own_meta);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int lr = warp * 16 + g + 8 * h;
        r_user[h] = mu[lr];
        r_item[h] = mu[kTile + lr];
        r_w[h] = mf[2 * kTile + lr];
        r_lse[h] = mf[3 * kTile + lr] * kLog2e;
        r_pad[h] = r_w[h] <= 0.f;
      }
      if constexpr (kARegs) {
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk)
          ldmatrix_x4(areg[kk], own + (warp * 16 + (lane & 15)) * LDK +
                                    kk * 16 + (lane >> 4) * 8);
      }
    }
    if (!BWD && i > 0) flush_colpart((i - 1) & 1, k0 + i - 1);

    const int st = i % kStages;
    const bf16* oth = stage_tile(st);
    const int* cm = reinterpret_cast<const int*>(stage_meta(st));
    const float* cmf = reinterpret_cast<const float*>(stage_meta(st));
    const int ci = k0 + i;

    // -- logits: 16 rows x 64 columns per warp, in registers
    float acc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      unsigned a[4];
      if constexpr (kARegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = areg[kk][e];
      } else {
        ldmatrix_x4(a, own + (warp * 16 + (lane & 15)) * LDK + kk * 16 +
                           (lane >> 4) * 8);
      }
#pragma unroll
      for (int n = 0; n < 8; n += 2) {
        unsigned b[4];
        ldmatrix_x4(b, oth + (n * 8 + (lane & 7) + ((lane >> 4) << 3)) * LDK +
                           kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(acc[n], a, b[0], b[1]);
        mma_bf16(acc[n + 1], a, b[2], b[3]);
      }
    }

    // -- rounding, masks, exponentials on the accumulators; only the
    // diagonal tile (ci == t) looks for the diagonal
    float cs[16];   // forward: this thread's column sums, [2n + e]
    auto epilogue = [&](auto diag_tile) {
      constexpr bool kDiag = decltype(diag_tile)::value;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int lc = n * 8 + 2 * q;
        const int2 c_user = *reinterpret_cast<const int2*>(cm + lc);
        const int2 c_item = *reinterpret_cast<const int2*>(cm + kTile + lc);
        const float2 c_w =
            *reinterpret_cast<const float2*>(cmf + 2 * kTile + lc);
        float2 c_lse = make_float2(0.f, 0.f);
        if constexpr (BWD)
          c_lse = *reinterpret_cast<const float2*>(cmf + 3 * kTile + lc);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cu = e ? c_user.y : c_user.x;
          const int cit = e ? c_item.y : c_item.x;
          const float cw = e ? c_w.y : c_w.x;
          const bool c_pad = cw <= 0.f;
          const float cl = (e ? c_lse.y : c_lse.x) * kLog2e;
          const int gc = ci * kTile + lc + e;
          float colsum = 0.f;
          float xs[2] = {acc[n][e], acc[n][2 + e]};
          round_bf16x2(xs[0], xs[1]);
          xs[0] = div_rn(xs[0], p.temp, rcp);
          xs[1] = div_rn(xs[1], p.temp, rcp);
          round_bf16x2(xs[0], xs[1]);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float x = xs[h];
            const bool not_diag = !kDiag || r_g[h] != gc;
            const bool ban_ui = (cit == r_item[h] || c_pad) && not_diag;
            const bool ban_iu = (r_user[h] == cu || r_pad[h]) && not_diag;
            if constexpr (!BWD) {
              const float ex = ex2(x * kLog2e);
              row_acc[h] += ban_ui ? 0.f : ex;
              colsum += ban_iu ? 0.f : ex;
              if (kDiag && !not_diag && r_g[h] < p.B) p.diag[r_g[h]] = x;
            } else {
              const float p_ui =
                  ban_ui ? 0.f : ex2(fmaf(x, kLog2e, -r_lse[h]));
              const float p_iu = ban_iu ? 0.f : ex2(fmaf(x, kLog2e, -cl));
              if constexpr (kDiag) {
                const float d = not_diag ? 0.f : 1.f;
                acc[n][2 * h + e] =
                    (r_w[h] * (p_ui - d) + cw * (p_iu - d)) * scale;
              } else {
                acc[n][2 * h + e] = (r_w[h] * p_ui + cw * p_iu) * scale;
              }
            }
          }
          cs[2 * n + e] = colsum;
        }
      }
    };
    if (ci == t) {
      epilogue(std::true_type{});
    } else {
      epilogue(std::false_type{});
    }

    if constexpr (!BWD) {
      // column sums over the warp's 16 rows: reduce-scatter over the 8
      // row groups (lane bits 4, 3, 2); lane ends with columns
      // 8 (b2 + 2 b3 + 4 b4) + 2q + {0, 1}
      float v8[8], v4[4], v2[2];
      const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float send = b4 ? cs[j] : cs[j + 8];
        v8[j] = (b4 ? cs[j + 8] : cs[j]) +
                __shfl_xor_sync(0xffffffffu, send, 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float send = b3 ? v8[j] : v8[j + 4];
        v4[j] = (b3 ? v8[j + 4] : v8[j]) +
                __shfl_xor_sync(0xffffffffu, send, 8);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float send = b2 ? v4[j] : v4[j + 2];
        v2[j] = (b2 ? v4[j + 2] : v4[j]) +
                __shfl_xor_sync(0xffffffffu, send, 4);
      }
      const int n = (b2 ? 1 : 0) + (b3 ? 2 : 0) + (b4 ? 4 : 0);
      *reinterpret_cast<float2*>(colpart + (i & 1) * 4 * kTile +
                                 warp * kTile + n * 8 + 2 * q) =
          make_float2(v2[0], v2[1]);
    } else {
      // grad[16 x DC] += bf16(coef)[16 x 64] . oth[64 x DC]: coef's
      // accumulator registers are the A operand as they stand
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const unsigned a[4] = {
            pack_bf16(acc[2 * kk][0], acc[2 * kk][1]),
            pack_bf16(acc[2 * kk][2], acc[2 * kk][3]),
            pack_bf16(acc[2 * kk + 1][0], acc[2 * kk + 1][1]),
            pack_bf16(acc[2 * kk + 1][2], acc[2 * kk + 1][3])};
#pragma unroll
        for (int n = 0; n < DC / 8; n += 2) {
          unsigned b[4];
          ldmatrix_x4_trans(
              b, oth + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDK +
                     dbase + (n + (lane >> 4)) * 8);
          mma_bf16(gacc[n], a, b[0], b[1]);
          mma_bf16(gacc[n + 1], a, b[2], b[3]);
        }
      }
    }
  }

  if constexpr (!BWD) {
    __syncthreads();
    if (nsteps > 0) flush_colpart((nsteps - 1) & 1, k1 - 1);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float r = row_acc[h];
      r += __shfl_xor_sync(0xffffffffu, r, 1);
      r += __shfl_xor_sync(0xffffffffu, r, 2);
      if (q == 0 && r_g[h] < p.B) p.sum_ui[(size_t)s * p.B + r_g[h]] = r;
    }
  } else {
    float* out = p.out + (size_t)s * p.B * p.D;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (r_g[h] >= p.B) continue;
      float* row = out + (size_t)r_g[h] * p.D;
#pragma unroll
      for (int n = 0; n < DC / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = dbase + n * 8 + 2 * q + e;
          if (d < p.D) row[d] = gacc[n][2 * h + e];
        }
    }
  }
}

template <int DP, bool BWD>
cudaError_t launch_bf16(const Params& p, int S, cudaStream_t stream) {
  const auto kernel = flash_ce_kernel_bf16<DP, BWD>;
  const unsigned smem = Layout<DP>::kTotal;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.n_tiles, S, BWD && DP > 128 ? DP / 128 : 1);
  kernel<<<grid, 128, smem, stream>>>(p);
  return cudaGetLastError();
}

// ----------------------------------------------------------------- f32

constexpr int kF32Threads = 256;   // thread (ty, tx) = (tid / 16, tid % 16)

// Byte offsets of the f32 kernel's shared-memory regions, 128-aligned.
struct PlanF32 {
  unsigned own, oth, coef, meta, colpart, total;
  int ldk, ldc;
};

__host__ __device__ inline unsigned take(unsigned* off, unsigned bytes) {
  const unsigned at = *off;
  *off = (at + bytes + 127u) & ~127u;
  return at;
}

__host__ __device__ inline PlanF32 plan_f32(int Dp, bool bwd) {
  PlanF32 s;
  // odd strides, so the 16 threads of a row read 16 different banks
  s.ldk = Dp + 1;
  s.ldc = kTile + 1;
  unsigned off = 0;
  s.own = take(&off, kTile * s.ldk * 4u);
  s.oth = take(&off, kTile * s.ldk * 4u);
  s.coef = take(&off, bwd ? kTile * s.ldc * 4u : 0u);
  s.meta = take(&off, 8 * kTile * 4u);
  s.colpart = take(&off, bwd ? 0u : 16 * kTile * 4u);
  s.total = off;
  return s;
}

__device__ __forceinline__ void load_tile_f32(float* dst, int ldk,
                                              const float* src, int base,
                                              const Params& p, int tid) {
  for (int e = tid; e < kTile * p.Dp; e += kF32Threads) {
    const int r = e / p.Dp;
    const int k = e - r * p.Dp;
    const int g = base + r;
    dst[r * ldk + k] = (g < p.B && k < p.D) ? src[(size_t)g * p.D + k] : 0.f;
  }
}

__device__ __forceinline__ void load_meta_f32(const Params& p, int base,
                                              const float* lse, int* mu,
                                              int* mi, float* mw, float* ml,
                                              int tid) {
  if (tid < kTile) {
    const int g = base + tid;
    const bool ok = g < p.B;
    mu[tid] = ok ? p.u_idx[g] : 0;
    mi[tid] = ok ? p.i_idx[g] : 0;
    mw[tid] = ok ? p.w[g] : 0.f;
    ml[tid] = (ok && lse != nullptr) ? lse[g] : 0.f;
  }
}

template <bool BWD, int NFW>
__global__ void __launch_bounds__(kF32Threads) flash_ce_kernel_f32(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const PlanF32 s = plan_f32(p.Dp, BWD);
  float* rows = reinterpret_cast<float*>(smem + s.own);
  float* cols = reinterpret_cast<float*>(smem + s.oth);
  float* coef = reinterpret_cast<float*>(smem + s.coef);
  int* r_user = reinterpret_cast<int*>(smem + s.meta);
  int* r_item = r_user + kTile;
  int* c_user = r_item + kTile;
  int* c_item = c_user + kTile;
  float* r_w = reinterpret_cast<float*>(c_item + kTile);
  float* r_lse = r_w + kTile;
  float* c_w = r_lse + kTile;
  float* c_lse = c_w + kTile;
  float* colpart = reinterpret_cast<float*>(smem + s.colpart);

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int t = blockIdx.x;
  const int S = gridDim.y;
  const int sp = blockIdx.y;
  const int k0 = sp * p.n_tiles / S;
  const int k1 = (sp + 1) * p.n_tiles / S;
  const float* U = static_cast<const float*>(p.u);
  const float* V = static_cast<const float*>(p.v);

  load_tile_f32(rows, s.ldk, U, t * kTile, p, tid);
  load_meta_f32(p, t * kTile, BWD ? p.lse_ui : nullptr, r_user, r_item, r_w,
                r_lse, tid);
  const float scale = BWD ? *p.scale : 0.f;

  float row_acc[4] = {0.f, 0.f, 0.f, 0.f};
  float acc2[4][2 * NFW];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 2 * NFW; ++c) acc2[r][c] = 0.f;

  for (int ci = k0; ci < k1; ++ci) {
    __syncthreads();   // the previous step is done with cols and coef
    load_tile_f32(cols, s.ldk, V, ci * kTile, p, tid);
    load_meta_f32(p, ci * kTile, BWD ? p.lse_iu : nullptr, c_user, c_item,
                  c_w, c_lse, tid);
    __syncthreads();

    // -- tile logits: thread holds rows ty+16r, cols tx+16c
    float acc[4][4];
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

    // -- divide, masks, exponentials
    float cs[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int lr = ty + 16 * r;
      const int gr = t * kTile + lr;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int lc = tx + 16 * c;
        const int gc = ci * kTile + lc;
        const bool valid = gr < p.B && gc < p.B;
        const float x = acc[r][c] / p.temp;
        const bool not_diag = gr != gc;
        const bool ban_ui =
            ((c_item[lc] == r_item[lr]) || c_w[lc] <= 0.f) && not_diag;
        const bool ban_iu =
            ((r_user[lr] == c_user[lc]) || r_w[lr] <= 0.f) && not_diag;
        if constexpr (!BWD) {
          const float e = expf(x);
          if (valid) {
            row_acc[r] += ban_ui ? 0.f : e;
            cs[c] += ban_iu ? 0.f : e;
            if (!not_diag) p.diag[gr] = x;
          }
        } else {
          float cf = 0.f;
          if (valid) {
            const float p_ui = ban_ui ? 0.f : expf(x - r_lse[lr]);
            const float p_iu = ban_iu ? 0.f : expf(x - c_lse[lc]);
            const float isdiag = not_diag ? 0.f : 1.f;
            cf = (r_w[lr] * (p_ui - isdiag) + c_w[lc] * (p_iu - isdiag)) *
                 scale;
          }
          coef[lr * s.ldc + lc] = cf;
        }
      }
    }

    if constexpr (!BWD) {
      // column sums over this row tile, in a fixed order
#pragma unroll
      for (int c = 0; c < 4; ++c) colpart[ty * kTile + tx + 16 * c] = cs[c];
      __syncthreads();
      if (tid < kTile) {
        float sum = 0.f;
        for (int y = 0; y < 16; ++y) sum += colpart[y * kTile + tid];
        const int g = ci * kTile + tid;
        if (g < p.B) p.iu_parts[(size_t)t * p.B + g] = sum;
      }
    } else {
      __syncthreads();
      // out[a] += sum_o coef[a, o] cols[o]
      for (int o = 0; o < kTile; ++o) {
        float cv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = coef[(ty + 16 * r) * s.ldc + o];
#pragma unroll
        for (int c = 0; c < 2 * NFW; ++c) {
          const float ov = cols[o * s.ldk + tx + 16 * c];
#pragma unroll
          for (int r = 0; r < 4; ++r) acc2[r][c] = fmaf(cv[r], ov, acc2[r][c]);
        }
      }
    }
  }

  if constexpr (!BWD) {
    // row sums: the 16 threads of a row are one half-warp
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float v = row_acc[r];
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      const int g = t * kTile + ty + 16 * r;
      if (tx == 0 && g < p.B) p.sum_ui[(size_t)sp * p.B + g] = v;
    }
  } else {
    float* out = p.out + (size_t)sp * p.B * p.D;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int g = t * kTile + ty + 16 * r;
#pragma unroll
      for (int c = 0; c < 2 * NFW; ++c) {
        const int d = tx + 16 * c;
        if (g < p.B && d < p.D) out[(size_t)g * p.D + d] = acc2[r][c];
      }
    }
  }
}

template <bool BWD, int NFW>
cudaError_t launch_f32(const Params& p, int S, cudaStream_t stream) {
  const PlanF32 s = plan_f32(p.Dp, BWD);
  const auto kernel = flash_ce_kernel_f32<BWD, NFW>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s.total);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.n_tiles, S), kF32Threads, s.total, stream>>>(p);
  return cudaGetLastError();
}

template <bool BWD>
cudaError_t launch_typed(bool is_bf16, const Params& p, int S,
                         cudaStream_t stream) {
  if (is_bf16) {
    switch (p.Dp) {
      case 32: return launch_bf16<32, BWD>(p, S, stream);
      case 64: return launch_bf16<64, BWD>(p, S, stream);
      case 128: return launch_bf16<128, BWD>(p, S, stream);
      case 256: return launch_bf16<256, BWD>(p, S, stream);
    }
  } else if (!BWD) {
    return launch_f32<false, 1>(p, S, stream);
  } else {
    switch (p.Dp) {
      case 32: return launch_f32<true, 1>(p, S, stream);
      case 64: return launch_f32<true, 2>(p, S, stream);
      case 128: return launch_f32<true, 4>(p, S, stream);
      case 256: return launch_f32<true, 8>(p, S, stream);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// mode 0: forward (sum_ui [S, B], diag [B], iu_parts [n_tiles, B]);
// mode 1: the gradient of the row side (out [S, B, D]). bf16: u, v are
// bf16 [B, Dp] with Dp = D rounded up to 32, 64, 128 or 256 and zeros
// past D; f32: u, v are f32 [B, D]. split: S, at most n_tiles.
extern "C" int flash_ce_launch(int mode, int is_bf16, const void* u,
                               const void* v, const int* u_idx,
                               const int* i_idx, const float* w,
                               const float* lse_ui, const float* lse_iu,
                               const float* scale, float* sum_ui, float* diag,
                               float* iu_parts, float* out, int B, int D,
                               int split, float temp, void* stream) {
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
  if (split < 1 || split > p.n_tiles) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      mode == 0 ? launch_typed<false>(is_bf16 != 0, p, split, st)
      : mode == 1 ? launch_typed<true>(is_bf16 != 0, p, split, st)
                  : cudaErrorInvalidValue;
  return (int)err;
}

extern "C" const char* flash_ce_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
