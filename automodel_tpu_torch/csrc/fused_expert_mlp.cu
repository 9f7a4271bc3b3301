// Fused expert MLP of the MoE experts (experts: ragged_fused): the forward
// out = act(lhs @ Wg + gb, lhs @ Wu + ub) @ Wd + db per row's group, and
// the kernels of its backward.
//
// Replaces the Pallas TPU kernels of automodel_tpu/ops/fused_expert_mlp.py:
// _kernel (:59, through _fwd :130), _bwd_gu_kernel (:423, through _bwd_gu
// :465), _bwd_dwd_kernel (:530, through _bwd_dwd :560) and _bwd_dx_kernel
// (:615, through _bwd_dx :649); the last two together with the grouped-matmul
// kernels of grouped_matmul.cu, which carry their products.
//
// Operands (bf16 unless said): lhs [M, D] with rows sorted by group, group g
// owning rows [start_g, end_g) of the cumsum of group_sizes; gate_up
// [G, D, 2I], the gate half in columns [0, I) and the up half in [I, 2I),
// both read in place with row stride 2I; down [G, I, D]; the optional biases
// gate_up_bias [G, 2I] and down_bias [G, D]. act is swiglu, silu(g) * u
// (with an optional clamp `limit`: min(silu(g), limit) * clip(u, +-limit)),
// or swiglu_oai, (clip(u, +-7) + 1) * g' * sigmoid(1.702 g') with
// g' = min(g, 7); always in fp32. At a clamp's bound the gradient is 0.5,
// JAX's rule for min and max, which torch.clamp does not follow.
//
// - fwd_gu_act, then fwd_down (K3a, one call of the forward in two
//   launches): the TPU kernel keeps a [512, D] fp32 accumulator for the down
//   product in VMEM across its I chunks (6 MB at D = 2880); an SM has 228 KB
//   of shared memory. So mid = act(lhs @ Wg + gb, lhs @ Wu + ub) is stored
//   as bf16 [M, I] (the value the TPU kernel rounds mid to before its down
//   product, :107-108) and fwd_down computes mid @ Wd + db with db added to
//   the fp32 sum. Each work unit stores only its own group's rows; rows at or
//   past sum(group_sizes) are written as zeros.
// - bwd_gu (K3b): dW [G, D, 2I] fp32 = lhs_g^T [dg | du] per group, with dg
//   and du from the recomputed g, u (bf16, biases added) and dmid, rounded to
//   bf16 before the product as :438-445 does; the bias grads are the fp32
//   row sums of the unrounded dg, du (:455-462). One CTA per (group, D tile,
//   I tile) loops over its group's rows, as tgmm does: no atomics, the
//   result repeats bit for bit; an empty group writes zeros.
// - bwd_act (the activation of K3c and K3d): one pass over the routed rows
//   reads g | u and dmid and writes mid = act(g, u) [M, I] (as :537-547
//   rounds it) and dg | du [M, 2I] (as :629-642 rounds them), each computed
//   in fp32 and rounded once to bf16; rows past sum(group_sizes) are written
//   as zeros. K3c is then tgmm(mid, dy) with a bf16 out (the fp32 sum rounded
//   once: _vjp_bwd's dWd.astype(down.dtype), :777, taken in the kernel) and
//   bwd_ddb, the fp32 row sums of dy per group (:552-557); K3d is
//   gmm(dg | du, gate_up, transpose_rhs) over K = 2I, gate_up read in place
//   as the [G, N = D, K = 2I] rhs. The TPU kernels recompute the activation
//   per output tile because VMEM holds a [512, I] row block for the whole
//   grid walk; an SM's 227 KB does not (dg | du of 128 rows at I = 2880 is
//   1.47 MB), and recomputing per 128-column tile ran the activation 23
//   times an element at gpt-oss-20b's widths. Written once, the operands
//   cost ~566 MB of traffic (~0.17 ms at 3.35 TB/s), and the products run
//   on the wgmma / TMA kernels of grouped_matmul.cu.
//
// A kernel reads only its group's rows (bwd_act only rows before the groups'
// end), so rows past sum(group_sizes), which may hold NaN in lhs and dy,
// never reach a weight or bias gradient.
//
// What bounds them on an H100 at gpt-oss-20b's widths (4096 tokens top-4:
// M = 16384 rows over 32 experts, D = I = 2880): ~512 rows per expert give
// each weight slab ~512 flops per byte, above the ~295 where the tensor
// cores become the limit, so the forward, K3c's tgmm (with its bf16 out)
// and K3d's gmm are bound by operations; bwd_gu writes its fp32 weight grad
// ([32, 2880, 5760] is 2.1 GB) and is bound by bytes, as bwd_act and bwd_ddb
// (elementwise and a row sum) are. bwd_act moves 16 bytes a thread a load
// and a store in a grid-stride loop, with no shared memory. The forward and
// bwd_gu are the simple first design: mma.sync m16n8k16 with fp32
// accumulators, cp.async staging in three stages, 128-row tiles of the
// device-built gmm plan (ops/grouped_matmul.py gmm_plan), no wgmma, TMA or
// persistent scheduling; K and N edges zero-filled by cp.async.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;  // 8 warps: 2 along m (or k) x 4 along n
constexpr int kStages = 3;
constexpr int kErrUnsupported = 100001;

// gmm-shaped tiles (fwd_gu_act, fwd_down)
constexpr int BM = 128, BN = 128, BK = 32;
constexpr int HN = 64;       // gate (and up) columns of a fwd_gu_act / bwd_gu tile
constexpr int PA = BK + 8;   // padded row of a [BM][BK] tile
constexpr int PB = BN + 8;   // padded row of a [BK][BN] tile
// a tgmm-shaped tile (bwd_gu): out tile [TK][2 HN], rows in chunks of TR
constexpr int TK = 128, TR = 32;
constexpr int PL = TK + 8;      // padded row of a [TR][TK] chunk
constexpr int PH = HN + 8;      // padded row of a [TR][HN] chunk
constexpr int PG = 2 * HN + 8;  // padded row of the [TR][dg | du] chunk

// -- primitives (as in grouped_matmul.cu) --------------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ldmatrix row addresses for the lane, inside a tile with padded row P:
// A fragment (16 rows from r0, 16 columns from c0) of a row-major [m][k] tile
template <int P>
__device__ __forceinline__ const bf16* a_addr(const bf16* t, int r0, int c0, int lane) {
  return t + (r0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * P + c0 + (lane >> 4) * 8;
}
// A fragment (16 m from m0, 16 k from k0) of a tile stored [k][m], for ldsm_x4_t
template <int P>
__device__ __forceinline__ const bf16* at_addr(const bf16* t, int m0, int k0, int lane) {
  return t + (k0 + (lane >> 4) * 8 + (lane & 7)) * P + m0 + ((lane >> 3) & 1) * 8;
}
// B fragments of two n tiles from a tile stored [k][n], for ldsm_x4_t
template <int P>
__device__ __forceinline__ const bf16* bt_addr(const bf16* t, int k0, int n0, int lane) {
  return t + (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * P + n0 + (lane >> 4) * 8;
}

// ROWS x COLS bf16 from a row-major matrix (row stride `ld`) into a padded
// shared tile: row r is taken when row0 + r lies in [row_lo, row_hi), column
// chunk c (8 values) when col0 + 8c < n_cols; everything else is zero
template <int ROWS, int COLS, int P>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long ld, int row0, int row_lo,
                                          int row_hi, int col0, int n_cols) {
  constexpr int CPR = COLS / 8;
  for (int c = threadIdx.x; c < ROWS * CPR; c += kThreads) {
    const int r = c / CPR;
    const int w = c - r * CPR;
    const int row = row0 + r;
    const int col = col0 + w * 8;
    const bool ok = row >= row_lo && row < row_hi && col < n_cols;
    const bf16* s = ok ? src + static_cast<long long>(row) * ld + col : src;
    cp_async16(dst + r * P + w * 8, s, ok);
  }
}

template <int MI, int NI>
__device__ __forceinline__ void zero(float (&acc)[MI][NI][4]) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// -- the activation ---------------------------------------------------------------

struct Act {
  int oai;      // 1: swiglu_oai, 0: swiglu
  float limit;  // swiglu's clamp; <= 0: none
};

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// d/dx of min(max(x, lo), hi) under JAX's rule: 1 inside, 0 outside, 0.5 at a bound
__device__ __forceinline__ float clip_grad(float x, float lo, float hi) {
  if (x == lo || x == hi) return 0.5f;
  return (x > lo && x < hi) ? 1.f : 0.f;
}

__device__ __forceinline__ float act_fwd(float g, float u, Act a) {
  if (a.oai) {
    const float gc = fminf(g, 7.f);
    const float uc = fminf(fmaxf(u, -7.f), 7.f);
    return (uc + 1.f) * (gc * sigmoid(1.702f * gc));
  }
  float m = g * sigmoid(g);
  if (a.limit > 0.f) {
    m = fminf(m, a.limit);
    u = fminf(fmaxf(u, -a.limit), a.limit);
  }
  return m * u;
}

// (dg, du) of act at (g, u) for the upstream dm, in fp32
__device__ __forceinline__ void act_bwd(float g, float u, float dm, Act a, float& dg, float& du) {
  if (a.oai) {
    const float gc = fminf(g, 7.f);
    const float uc = fminf(fmaxf(u, -7.f), 7.f);
    const float s = sigmoid(1.702f * gc);
    du = dm * (gc * s) * clip_grad(u, -7.f, 7.f);
    dg = dm * (uc + 1.f) * (s + 1.702f * gc * s * (1.f - s)) * clip_grad(g, -INFINITY, 7.f);
    return;
  }
  const float s = sigmoid(g);
  const float silu = g * s;
  float m = silu, uc = u, cm = 1.f, cu = 1.f;
  if (a.limit > 0.f) {
    m = fminf(silu, a.limit);
    uc = fminf(fmaxf(u, -a.limit), a.limit);
    cm = clip_grad(silu, -INFINITY, a.limit);
    cu = clip_grad(u, -a.limit, a.limit);
  }
  du = dm * m * cu;
  dg = dm * uc * cm * (s + g * s * (1.f - s));
}

// -- the plan of a work unit (gmm_plan's [4, W] int32) ----------------------------

struct Unit {
  int g, m0, row_lo, row_hi;
};

__device__ __forceinline__ Unit plan_unit(const int* plan, int W, int M, int unit) {
  Unit u;
  u.g = plan[unit];
  u.m0 = plan[W + unit] * BM;
  u.row_lo = plan[2 * W + unit];
  u.row_hi = min(plan[3 * W + unit], M);
  return u;
}

// rows [row_lo, row_hi) x columns [c0, c0 + width) of a [M, N] bf16 matrix
// set to zero (the tail past sum(group_sizes))
__device__ __forceinline__ void store_zeros(bf16* out, int N, const Unit& u, int c0, int width) {
  const __nv_bfloat162 z = __floats2bfloat162_rn(0.f, 0.f);
  for (int c = threadIdx.x; c < BM * (width / 2); c += kThreads) {
    const int r = u.m0 + c / (width / 2);
    const int col = c0 + 2 * (c % (width / 2));
    if (r >= u.row_lo && r < u.row_hi && col < N)
      *reinterpret_cast<__nv_bfloat162*>(out + static_cast<long long>(r) * N + col) = z;
  }
}

// -- K3a, first launch: mid = act(lhs @ Wg + gb, lhs @ Wu + ub) ------------------

struct FwdArgs {
  const bf16* lhs;      // [M, D]
  const bf16* gate_up;  // [G, D, 2I]
  const bf16* gu_bias;  // [G, 2I] or null
  const bf16* down;     // [G, I, D]
  const bf16* d_bias;   // [G, D] or null
  const int* plan;      // [4, W]
  bf16* mid;            // [M, I]
  bf16* out;            // [M, D]
  int M, D, I, G, W;
  Act act;
};

// grid (ceil(I / 64), W): each CTA owns 64 gate and the same 64 up columns,
// so every thread holds g and u of the same (row, column) in registers
__global__ void __launch_bounds__(kThreads) fwd_gu_act_kernel(const FwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* a_s = reinterpret_cast<bf16*>(smem);  // [kStages][BM][PA]
  bf16* b_s = a_s + kStages * BM * PA;        // [kStages][BK][PB]: gate in columns 0..63, up in 64..127

  const Unit u = plan_unit(a.plan, a.W, a.M, blockIdx.y);
  if (u.row_lo >= u.row_hi) return;  // past the plan's end (uniform over the CTA)
  const int n0 = blockIdx.x * HN;
  if (u.g >= a.G) {
    store_zeros(a.mid, a.I, u, n0, HN);
    return;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;  // warp tile: 64 rows x (16 gate + 16 up) columns
  const long long ld = 2LL * a.I;
  const bf16* w = a.gate_up + static_cast<long long>(u.g) * a.D * ld;
  const int n_k = (a.D + BK - 1) / BK;
  auto issue = [&](int kt) {
    if (kt < n_k) {
      const int st = kt % kStages;
      bf16* bs = b_s + st * BK * PB;
      load_tile<BM, BK, PA>(a_s + st * BM * PA, a.lhs, a.D, u.m0, u.row_lo, u.row_hi, kt * BK, a.D);
      load_tile<BK, HN, PB>(bs, w, ld, kt * BK, 0, a.D, n0, a.I);
      load_tile<BK, HN, PB>(bs + HN, w + a.I, ld, kt * BK, 0, a.D, n0, a.I);
    }
    cp_async_commit();
  };

  float acc_g[4][2][4], acc_u[4][2][4];
  zero(acc_g);
  zero(acc_u);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt has landed, and every warp is done with tile kt - 1
    issue(kt + kStages - 1);
    const int st = kt % kStages;
    const bf16* as = a_s + st * BM * PA;
    const bf16* bs = b_s + st * BK * PB;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t af[4][4], bg[4], bu[4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) ldsm_x4(af[mi], a_addr<PA>(as, wm * 64 + mi * 16, kk * 16, lane));
      ldsm_x4_t(bg, bt_addr<PB>(bs, kk * 16, wn * 16, lane));
      ldsm_x4_t(bu, bt_addr<PB>(bs, kk * 16, HN + wn * 16, lane));
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        mma(acc_g[mi][0], af[mi], bg[0], bg[1]);
        mma(acc_g[mi][1], af[mi], bg[2], bg[3]);
        mma(acc_u[mi][0], af[mi], bu[0], bu[1]);
        mma(acc_u[mi][1], af[mi], bu[2], bu[3]);
      }
    }
  }
  cp_async_wait<0>();

  const bf16* gb = a.gu_bias ? a.gu_bias + static_cast<long long>(u.g) * 2 * a.I : nullptr;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = u.m0 + wm * 64 + mi * 16 + (lane >> 2) + 8 * h;
      if (r < u.row_lo || r >= u.row_hi) continue;
      bf16* orow = a.mid + static_cast<long long>(r) * a.I;
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
        const int col = n0 + wn * 16 + ni * 8 + 2 * (lane & 3);
        if (col >= a.I) continue;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float g = acc_g[mi][ni][2 * h + e], up = acc_u[mi][ni][2 * h + e];
          if (gb) {
            g += __bfloat162float(gb[col + e]);
            up += __bfloat162float(gb[a.I + col + e]);
          }
          v[e] = act_fwd(g, up, a.act);
        }
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(v[0], v[1]);
      }
    }
  }
}

// -- K3a, second launch: out = mid @ Wd + db ----------------------------------------

// grid (ceil(D / 128), W)
__global__ void __launch_bounds__(kThreads) fwd_down_kernel(const FwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* a_s = reinterpret_cast<bf16*>(smem);  // [kStages][BM][PA]
  bf16* b_s = a_s + kStages * BM * PA;        // [kStages][BK][PB]

  const Unit u = plan_unit(a.plan, a.W, a.M, blockIdx.y);
  if (u.row_lo >= u.row_hi) return;
  const int n0 = blockIdx.x * BN;
  if (u.g >= a.G) {
    store_zeros(a.out, a.D, u, n0, BN);
    return;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;  // warp tile: 64 rows x 32 columns
  const bf16* w = a.down + static_cast<long long>(u.g) * a.I * a.D;
  const int n_k = (a.I + BK - 1) / BK;
  auto issue = [&](int kt) {
    if (kt < n_k) {
      const int st = kt % kStages;
      load_tile<BM, BK, PA>(a_s + st * BM * PA, a.mid, a.I, u.m0, u.row_lo, u.row_hi, kt * BK, a.I);
      load_tile<BK, BN, PB>(b_s + st * BK * PB, w, a.D, kt * BK, 0, a.I, n0, a.D);
    }
    cp_async_commit();
  };

  float acc[4][4][4];
  zero(acc);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    issue(kt + kStages - 1);
    const int st = kt % kStages;
    const bf16* as = a_s + st * BM * PA;
    const bf16* bs = b_s + st * BK * PB;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t af[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) ldsm_x4(af[mi], a_addr<PA>(as, wm * 64 + mi * 16, kk * 16, lane));
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t bf[4];
        ldsm_x4_t(bf, bt_addr<PB>(bs, kk * 16, wn * 32 + j * 16, lane));
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          mma(acc[mi][2 * j], af[mi], bf[0], bf[1]);
          mma(acc[mi][2 * j + 1], af[mi], bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  const bf16* db = a.d_bias ? a.d_bias + static_cast<long long>(u.g) * a.D : nullptr;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = u.m0 + wm * 64 + mi * 16 + (lane >> 2) + 8 * h;
      if (r < u.row_lo || r >= u.row_hi) continue;
      bf16* orow = a.out + static_cast<long long>(r) * a.D;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn * 32 + ni * 8 + 2 * (lane & 3);
        if (col >= a.D) continue;
        float v0 = acc[mi][ni][2 * h], v1 = acc[mi][ni][2 * h + 1];
        if (db) {
          v0 += __bfloat162float(db[col]);
          v1 += __bfloat162float(db[col + 1]);
        }
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// -- K3b: dW [G, D, 2I] = lhs_g^T [dg | du], dbias = row sums ------------------------

struct BwdGuArgs {
  const bf16* lhs;   // [M, D]
  const bf16* gu;    // [M, 2I]: the recomputed g | u, biases added
  const bf16* dmid;  // [M, I]
  const int* ends;   // [G] inclusive cumsum of group_sizes
  float* dw;         // [G, D, 2I]
  float* dbias;      // [G, 2I] or null
  int M, D, I, G;
  Act act;
};

// grid (ceil(I / 64), ceil(D / 128), G)
__global__ void __launch_bounds__(kThreads) bwd_gu_kernel(const BwdGuArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int STAGE = TR * PL + 3 * TR * PH;
  bf16* st_s = reinterpret_cast<bf16*>(smem);  // [kStages][lhs [TR][PL], g, u, dmid [TR][PH]]
  bf16* d_s = st_s + kStages * STAGE;          // [TR][PG]: dg in columns 0..63, du in 64..127
  float* red = reinterpret_cast<float*>(d_s + TR * PG);  // [4][2 * HN] bias partial sums

  const int g = blockIdx.z;
  const int k0 = blockIdx.y * TK;
  const int n0 = blockIdx.x * HN;
  const int end = min(a.ends[g], a.M);
  const int start = min(g > 0 ? a.ends[g - 1] : 0, end);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;  // warp tile: 64 of D x (16 gate + 16 up) columns
  // the transform's element: one column, 8 of the chunk's rows
  const int tc = threadIdx.x % HN, tr = (threadIdx.x / HN) * (TR / 4);
  const long long ld = 2LL * a.I;

  float acc_g[4][2][4], acc_u[4][2][4];
  zero(acc_g);
  zero(acc_u);
  float sum_g = 0.f, sum_u = 0.f;

  const int n_chunks = (end - start + TR - 1) / TR;
  auto issue = [&](int c) {
    if (c < n_chunks) {
      bf16* s = st_s + (c % kStages) * STAGE;
      const int r0 = start + c * TR;
      load_tile<TR, TK, PL>(s, a.lhs, a.D, r0, start, end, k0, a.D);
      load_tile<TR, HN, PH>(s + TR * PL, a.gu, ld, r0, start, end, n0, a.I);
      load_tile<TR, HN, PH>(s + TR * PL + TR * PH, a.gu + a.I, ld, r0, start, end, n0, a.I);
      load_tile<TR, HN, PH>(s + TR * PL + 2 * TR * PH, a.dmid, a.I, r0, start, end, n0, a.I);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk c has landed, and every warp is done with chunk c - 1 and d_s
    issue(c + kStages - 1);
    const bf16* s = st_s + (c % kStages) * STAGE;
    const bf16* gs = s + TR * PL;
    const bf16* us = gs + TR * PH;
    const bf16* ms = us + TR * PH;
    // rows outside the group were zero-filled: their dg and du are 0
#pragma unroll
    for (int i = 0; i < TR / 4; ++i) {
      const int r = tr + i;
      float dg, du;
      act_bwd(__bfloat162float(gs[r * PH + tc]), __bfloat162float(us[r * PH + tc]),
              __bfloat162float(ms[r * PH + tc]), a.act, dg, du);
      sum_g += dg;
      sum_u += du;
      d_s[r * PG + tc] = __float2bfloat16(dg);
      d_s[r * PG + HN + tc] = __float2bfloat16(du);
    }
    __syncthreads();
    const bf16* ls = s;
#pragma unroll
    for (int kk = 0; kk < TR / 16; ++kk) {  // contraction over 16 rows at a time
      uint32_t af[4][4], bg[4], bu[4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) ldsm_x4_t(af[mi], at_addr<PL>(ls, wm * 64 + mi * 16, kk * 16, lane));
      ldsm_x4_t(bg, bt_addr<PG>(d_s, kk * 16, wn * 16, lane));
      ldsm_x4_t(bu, bt_addr<PG>(d_s, kk * 16, HN + wn * 16, lane));
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        mma(acc_g[mi][0], af[mi], bg[0], bg[1]);
        mma(acc_g[mi][1], af[mi], bg[2], bg[3]);
        mma(acc_u[mi][0], af[mi], bu[0], bu[1]);
        mma(acc_u[mi][1], af[mi], bu[2], bu[3]);
      }
    }
  }
  cp_async_wait<0>();

  float* out_g = a.dw + static_cast<long long>(g) * a.D * ld;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kr = k0 + wm * 64 + mi * 16 + (lane >> 2) + 8 * h;
      if (kr >= a.D) continue;
      float* orow = out_g + static_cast<long long>(kr) * ld;
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
        const int col = n0 + wn * 16 + ni * 8 + 2 * (lane & 3);
        if (col >= a.I) continue;
        *reinterpret_cast<float2*>(orow + col) = make_float2(acc_g[mi][ni][2 * h], acc_g[mi][ni][2 * h + 1]);
        *reinterpret_cast<float2*>(orow + a.I + col) =
            make_float2(acc_u[mi][ni][2 * h], acc_u[mi][ni][2 * h + 1]);
      }
    }
  }
  // the bias grads: every D tile sums the same rows; the first one writes
  if (a.dbias != nullptr && blockIdx.y == 0) {
    __syncthreads();
    red[(tr / (TR / 4)) * 2 * HN + tc] = sum_g;
    red[(tr / (TR / 4)) * 2 * HN + HN + tc] = sum_u;
    __syncthreads();
    if (threadIdx.x < 2 * HN) {
      const int t = threadIdx.x;
      const float v = red[t] + red[2 * HN + t] + red[4 * HN + t] + red[6 * HN + t];
      const int col = n0 + (t % HN);
      if (col < a.I) a.dbias[static_cast<long long>(g) * ld + (t < HN ? 0 : a.I) + col] = v;
    }
  }
}

// -- the backward's elementwise pass (for K3c and K3d): mid, dg | du --------------

struct BwdActArgs {
  const bf16* gu;    // [M, 2I]: the recomputed g | u, biases added
  const bf16* dmid;  // [M, I]; read only when dgdu is written
  const int* ends;   // [G] inclusive cumsum of group_sizes
  bf16* mid;         // [M, I] or null
  bf16* dgdu;        // [M, 2I] or null: dg in columns [0, I), du in [I, 2I)
  int M, I, G;
  Act act;
};

__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return v;
}

// A grid-stride loop over (row, 8 columns of I): three 16-byte loads (g, u,
// dmid) and three 16-byte stores (mid, dg, du) an item, neighbouring
// threads on neighbouring columns. Rows at or past sum(group_sizes) load
// nothing and store zeros.
__global__ void __launch_bounds__(kThreads) bwd_act_kernel(const BwdActArgs a) {
  const int rows = min(a.ends[a.G - 1], a.M);
  const int chunks = a.I / 8;
  const long long n = static_cast<long long>(a.M) * chunks;
  const long long ld = 2LL * a.I;
  for (long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; e < n;
       e += static_cast<long long>(gridDim.x) * kThreads) {
    const int r = static_cast<int>(e / chunks);
    const int c = static_cast<int>(e - static_cast<long long>(r) * chunks) * 8;
    float m[8] = {}, dg[8] = {}, du[8] = {};
    if (r < rows) {
      float g[8], u[8];
      unpack8(*reinterpret_cast<const uint4*>(a.gu + r * ld + c), g);
      unpack8(*reinterpret_cast<const uint4*>(a.gu + r * ld + a.I + c), u);
      if (a.mid) {
#pragma unroll
        for (int i = 0; i < 8; ++i) m[i] = act_fwd(g[i], u[i], a.act);
      }
      if (a.dgdu) {
        float dm[8];
        unpack8(*reinterpret_cast<const uint4*>(a.dmid + static_cast<long long>(r) * a.I + c), dm);
#pragma unroll
        for (int i = 0; i < 8; ++i) act_bwd(g[i], u[i], dm[i], a.act, dg[i], du[i]);
      }
    }
    if (a.mid) *reinterpret_cast<uint4*>(a.mid + static_cast<long long>(r) * a.I + c) = pack8(m);
    if (a.dgdu) {
      *reinterpret_cast<uint4*>(a.dgdu + r * ld + c) = pack8(dg);
      *reinterpret_cast<uint4*>(a.dgdu + r * ld + a.I + c) = pack8(du);
    }
  }
}

// -- K3c's bias grad: ddb [G, D] fp32 = the row sums of dy per group -------------

constexpr int kDdbColThreads = 8;                     // threads along a row, 8 columns each
constexpr int kDdbLanes = kThreads / kDdbColThreads;  // row lanes of a CTA
constexpr int kDdbCols = kDdbColThreads * 8;          // columns of a CTA

// grid (ceil(D / 64), G): row lane l sums the group's rows start + l,
// start + l + 32, ... in order (a warp reads four rows' 128 contiguous
// bytes at a time), then thread t adds the 32 lanes' sums of column t in
// lane order. A fixed order, no atomics: a repeat gives the same bits. An
// empty group writes zeros. The tiles are narrow and the row lanes many
// because the CTAs of the largest group (~1700 rows at gpt-oss-20b's
// routing, 3.4x the mean) set the launch's time.
__global__ void __launch_bounds__(kThreads) bwd_ddb_kernel(const bf16* dy, const int* ends, float* ddb, int M,
                                                            int D) {
  __shared__ float part[kDdbLanes][kDdbCols];
  const int g = blockIdx.y;
  const int end = min(ends[g], M);
  const int start = min(g > 0 ? ends[g - 1] : 0, end);
  const int ct = threadIdx.x % kDdbColThreads, rl = threadIdx.x / kDdbColThreads;
  const int c = blockIdx.x * kDdbCols + ct * 8;
  float s[8] = {};
  if (c < D) {
    // unrolled so that four rows' loads are in flight at once; the sum
    // still takes the lane's rows one by one, in order
#pragma unroll 4
    for (int r = start + rl; r < end; r += kDdbLanes) {
      float f[8];
      unpack8(*reinterpret_cast<const uint4*>(dy + static_cast<long long>(r) * D + c), f);
#pragma unroll
      for (int i = 0; i < 8; ++i) s[i] += f[i];
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) part[rl][ct * 8 + i] = s[i];
  __syncthreads();
  const int col = blockIdx.x * kDdbCols + threadIdx.x;
  if (threadIdx.x < kDdbCols && col < D) {
    float v = 0.f;
#pragma unroll
    for (int l = 0; l < kDdbLanes; ++l) v += part[l][threadIdx.x];
    ddb[static_cast<long long>(g) * D + col] = v;
  }
}

// -- launch ------------------------------------------------------------------

template <typename Kernel, typename A>
int launch(Kernel kernel, dim3 grid, size_t smem, const A& a, cudaStream_t stream) {
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    sms = 132;
  return sms;
}

bool shape_ok(int M, int D, int I, int G, int act_kind) {
  return M >= 1 && D >= 8 && I >= 8 && G >= 1 && G <= 65535 && D % 8 == 0 && I % 8 == 0 &&
         (act_kind == 0 || act_kind == 1);
}

Act make_act(int act_kind, float limit) { return Act{act_kind, act_kind == 0 ? limit : 0.f}; }

constexpr size_t kGemmSmem = static_cast<size_t>(kStages) * (BM * PA + BK * PB) * sizeof(bf16);

}  // namespace

extern "C" {

// Each launches on `stream`, allocates nothing and returns cudaGetLastError()
// after the launch (0 = launched), or an error code for a shape it does not
// take (D or I not a multiple of 8). act_kind: 0 swiglu, 1 swiglu_oai;
// limit > 0 clamps swiglu (ignored for swiglu_oai). plan: int32 [4, W] from
// ops/grouped_matmul.py gmm_plan with tile 128 and W = ceil(M / 128) + G + 1;
// ends: int32 [G], the inclusive cumsum of group_sizes. Bias pointers may be
// null.

int fused_expert_mlp_fwd_gu_act(const void* lhs, const void* gate_up, const void* gate_up_bias, const int* plan,
                                void* mid, int M, int D, int I, int G, int W, int act_kind, float limit,
                                void* stream) {
  if (!shape_ok(M, D, I, G, act_kind) || W < 1 || W > 65535) return kErrUnsupported;
  FwdArgs a = {static_cast<const bf16*>(lhs), static_cast<const bf16*>(gate_up),
               static_cast<const bf16*>(gate_up_bias), nullptr, nullptr, plan, static_cast<bf16*>(mid), nullptr,
               M, D, I, G, W, make_act(act_kind, limit)};
  return launch(fwd_gu_act_kernel, dim3((I + HN - 1) / HN, W), kGemmSmem, a, static_cast<cudaStream_t>(stream));
}

int fused_expert_mlp_fwd_down(const void* mid, const void* down, const void* down_bias, const int* plan, void* out,
                              int M, int D, int I, int G, int W, void* stream) {
  if (!shape_ok(M, D, I, G, 0) || W < 1 || W > 65535) return kErrUnsupported;
  FwdArgs a = {nullptr, nullptr, nullptr, static_cast<const bf16*>(down), static_cast<const bf16*>(down_bias),
               plan, const_cast<bf16*>(static_cast<const bf16*>(mid)), static_cast<bf16*>(out),
               M, D, I, G, W, make_act(0, 0.f)};
  return launch(fwd_down_kernel, dim3((D + BN - 1) / BN, W), kGemmSmem, a, static_cast<cudaStream_t>(stream));
}

int fused_expert_mlp_bwd_gu(const void* lhs, const void* gu, const void* dmid, const int* ends, float* dw,
                            float* dbias, int M, int D, int I, int G, int act_kind, float limit, void* stream) {
  if (!shape_ok(M, D, I, G, act_kind)) return kErrUnsupported;
  BwdGuArgs a = {static_cast<const bf16*>(lhs), static_cast<const bf16*>(gu), static_cast<const bf16*>(dmid),
                 ends, dw, dbias, M, D, I, G, make_act(act_kind, limit)};
  const size_t smem = static_cast<size_t>(kStages) * (TR * PL + 3 * TR * PH) * sizeof(bf16) +
                      TR * PG * sizeof(bf16) + 4 * 2 * HN * sizeof(float);
  const dim3 grid((I + HN - 1) / HN, (D + TK - 1) / TK, G);
  return launch(bwd_gu_kernel, grid, smem, a, static_cast<cudaStream_t>(stream));
}

// The backward's elementwise pass: mid [M, I] = act(g, u) and dgdu [M, 2I]
// = (dg | du) of act at (g, u) for dmid, each computed in fp32 and rounded
// once to bf16; either output may be null (not both), dmid is read only
// for dgdu. Rows at or past sum(group_sizes) are written as zeros.
int fused_expert_mlp_bwd_act(const void* gu, const void* dmid, const int* ends, void* mid, void* dgdu, int M, int I,
                             int G, int act_kind, float limit, void* stream) {
  if (!shape_ok(M, 8, I, G, act_kind) || (!mid && !dgdu) || (dgdu && !dmid)) return kErrUnsupported;
  BwdActArgs a = {static_cast<const bf16*>(gu), static_cast<const bf16*>(dmid), ends, static_cast<bf16*>(mid),
                  static_cast<bf16*>(dgdu), M, I, G, make_act(act_kind, limit)};
  // one wave of full SMs (2048 threads each), each thread looping over items
  long long blocks = (static_cast<long long>(M) * (I / 8) + kThreads - 1) / kThreads;
  const long long wave = static_cast<long long>(sm_count()) * (2048 / kThreads);
  if (blocks > wave) blocks = wave;
  return launch(bwd_act_kernel, dim3(static_cast<unsigned>(blocks)), 0, a, static_cast<cudaStream_t>(stream));
}

// ddb [G, D] fp32: the row sums of dy [M, D] over each group's rows
int fused_expert_mlp_bwd_ddb(const void* dy, const int* ends, float* ddb, int M, int D, int G, void* stream) {
  if (!shape_ok(M, D, 8, G, 0)) return kErrUnsupported;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bwd_ddb_kernel<<<dim3((D + kDdbCols - 1) / kDdbCols, G), kThreads, 0, s>>>(static_cast<const bf16*>(dy), ends,
                                                                             ddb, M, D);
  return static_cast<int>(cudaGetLastError());
}

const char* fused_expert_mlp_error_string(int code) {
  if (code == kErrUnsupported) return "shape not supported by the fused expert-MLP kernels";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
