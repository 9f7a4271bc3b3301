// Grouped matmul for the MoE experts: gmm (and gmm with a transposed rhs)
// and the transposed grouped matmul tgmm of its backward.
//
// Replaces the Pallas TPU kernels of automodel_tpu/ops/grouped_matmul.py:
// _gmm_kernel (:155, through _gmm :175, both layouts of rhs) and
// _tgmm_kernel (:230, through _tgmm :247).
//
// Function (the same as the JAX kernels, with one definition added):
// - gmm: lhs [M, K] bf16 with rows sorted by group, group g owning rows
//   [start_g, end_g) (a cumsum of group_sizes), rhs [G, K, N] bf16 (or
//   [G, N, K] under transpose_rhs, contracted on its last axis) ->
//   out[m, :] = lhs[m, :] @ rhs[g(m)] in bf16, fp32 accumulation. Rows at or
//   past sum(group_sizes) are written as zeros (the TPU kernel leaves them
//   uninitialised).
// - tgmm: lhs [M, K], dout [M, N] bf16 -> out[g] = lhs_g^T @ dout_g, [G, K, N]
//   fp32; an empty group writes zeros.
//
// What bounds them on an H100 at the MoE shapes (M = 32768 rows over 128
// experts of Qwen3-30B-A3B): bytes. Each group's rhs slab ([2048, 1536] bf16,
// 6 MB) serves only ~256 rows, so the weights stream from device memory at
// ~130 flops per byte, under the ~295 where the tensor cores would be the
// limit; tgmm also writes a [G, K, N] fp32 result. The least time is the
// operands and the output moved once over 3.35 TB/s.
//
// Design (simple first: mma.sync m16n8k16 with fp32 accumulators, cp.async
// staging in three stages, no wgmma/TMA/persistent scheduling yet):
// - gmm: a fixed grid of (n tile, work unit). A work unit is one (group,
//   m tile) pair that overlaps: the plan (ops/grouped_matmul.py gmm_plan,
//   built on the device with torch ops, as the JAX _plan :70 is) gives W =
//   ceil(M/128) + G + 1 units, the last group being the tail past
//   sum(group_sizes), which writes zeros. A unit loads and stores only the
//   rows of its own group: an m tile that spans a group boundary is computed
//   by two CTAs that run at the same time and write disjoint rows, where the
//   TPU kernel blends the tile in place across consecutive grid steps
//   (:169-172), which the GPU's unordered CTAs would make a race. Units past
//   the plan's end exit at once. K and N edges are zero-filled by cp.async.
//   A transposed rhs is read in place ([N][K] rows, ldmatrix without .trans)
//   and never copied.
// - tgmm: one CTA per (group, k tile, n tile) loops over its group's rows in
//   chunks of 32 and accumulates lhs^T.dout in fp32 registers (lhs^T is the
//   A operand, loaded from lhs rows by ldmatrix.trans); it writes its slab
//   once. No atomics and no plan, so the result repeats bit for bit. A CTA's
//   time follows its group's row count: uneven groups leave SMs idle at the
//   end (a later PR's load balancing).
// - shared-memory rows are padded by 16 bytes so ldmatrix's eight row
//   addresses fall in different banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;  // 8 warps: 2 along m x 4 along n
constexpr int kStages = 3;
constexpr int kErrUnsupported = 100001;

// gmm tiles
constexpr int BM = 128, BN = 128, BK = 32;
constexpr int PA = BK + 8;  // padded row of an lhs tile [BM][BK]
constexpr int PB = BN + 8;  // padded row of an rhs tile [BK][BN]
constexpr int PBT = BK + 8; // padded row of a transposed rhs tile [BN][BK]
// tgmm tiles: out tile [TK][TN], rows consumed in chunks of TR
constexpr int TK = 128, TN = 128, TR = 32;
constexpr int PL = TK + 8;  // padded row of an lhs chunk [TR][TK]
constexpr int PD = TN + 8;  // padded row of a dout chunk [TR][TN]

// -- primitives (as in flash_attention.cu) -------------------------------------

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
// B fragments of two n tiles from a tile stored [n][k] (n from n0, k from k0)
template <int P>
__device__ __forceinline__ const bf16* b_addr(const bf16* t, int n0, int k0, int lane) {
  return t + (n0 + (lane >> 4) * 8 + (lane & 7)) * P + k0 + ((lane >> 3) & 1) * 8;
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

// -- gmm ---------------------------------------------------------------------

struct GmmArgs {
  const bf16* lhs;  // [M, K]
  const bf16* rhs;  // [G, K, N], or [G, N, K] when transposed
  const int* plan;  // [4, W]: group, m tile, first row, end row (G = the zero tail)
  bf16* out;        // [M, N]
  int M, K, N, G, W;
};

template <bool TRANS>
__global__ void __launch_bounds__(kThreads) gmm_kernel(const GmmArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int B_STAGE = TRANS ? BN * PBT : BK * PB;
  bf16* a_s = reinterpret_cast<bf16*>(smem);  // [kStages][BM][PA]
  bf16* b_s = a_s + kStages * BM * PA;        // [kStages][B_STAGE]

  const int unit = blockIdx.y;
  const int g = a.plan[unit];
  const int tile = a.plan[a.W + unit];
  const int row_lo = a.plan[2 * a.W + unit];
  const int row_hi = min(a.plan[3 * a.W + unit], a.M);
  if (row_lo >= row_hi) return;  // past the plan's end (uniform over the CTA)
  const int n0 = blockIdx.x * BN;
  const int m0 = tile * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;  // warp tile: 64 rows x 32 columns

  if (g >= a.G) {  // the tail past sum(group_sizes): zeros
    const __nv_bfloat162 z = __floats2bfloat162_rn(0.f, 0.f);
    for (int c = threadIdx.x; c < BM * (BN / 2); c += kThreads) {
      const int r = m0 + c / (BN / 2);
      const int col = n0 + 2 * (c % (BN / 2));
      if (r >= row_lo && r < row_hi && col < a.N)
        *reinterpret_cast<__nv_bfloat162*>(a.out + static_cast<long long>(r) * a.N + col) = z;
    }
    return;
  }

  const bf16* rhs_g = a.rhs + static_cast<long long>(g) * a.K * a.N;
  const int n_k = (a.K + BK - 1) / BK;
  auto issue = [&](int kt) {
    if (kt < n_k) {
      const int st = kt % kStages;
      load_tile<BM, BK, PA>(a_s + st * BM * PA, a.lhs, a.K, m0, row_lo, row_hi, kt * BK, a.K);
      if (TRANS)  // rhs_g is [N][K]: rows n0.., columns kt*BK..
        load_tile<BN, BK, PBT>(b_s + st * B_STAGE, rhs_g, a.K, n0, 0, a.N, kt * BK, a.K);
      else  // rhs_g is [K][N]: rows kt*BK.., columns n0..
        load_tile<BK, BN, PB>(b_s + st * B_STAGE, rhs_g, a.N, kt * BK, 0, a.K, n0, a.N);
    }
    cp_async_commit();
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt has landed, and every warp is done with tile kt - 1
    issue(kt + kStages - 1);
    const int st = kt % kStages;
    const bf16* as = a_s + st * BM * PA;
    const bf16* bs = b_s + st * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t af[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) ldsm_x4(af[mi], a_addr<PA>(as, wm * 64 + mi * 16, kk * 16, lane));
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t bf[4];
        if (TRANS)
          ldsm_x4(bf, b_addr<PBT>(bs, wn * 32 + j * 16, kk * 16, lane));
        else
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

  // only this unit's rows: a neighbouring unit may own the rest of the tile
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + wm * 64 + mi * 16 + (lane >> 2) + 8 * h;
      if (r < row_lo || r >= row_hi) continue;
      bf16* orow = a.out + static_cast<long long>(r) * a.N;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn * 32 + ni * 8 + 2 * (lane & 3);
        if (col < a.N)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
    }
  }
}

// -- tgmm --------------------------------------------------------------------

struct TgmmArgs {
  const bf16* lhs;   // [M, K]
  const bf16* dout;  // [M, N]
  const int* ends;   // [G] inclusive cumsum of group_sizes
  float* out;        // [G, K, N]
  int M, K, N, G;
};

__global__ void __launch_bounds__(kThreads) tgmm_kernel(const TgmmArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* l_s = reinterpret_cast<bf16*>(smem);  // [kStages][TR][PL]
  bf16* d_s = l_s + kStages * TR * PL;        // [kStages][TR][PD]

  const int g = blockIdx.z;
  const int k0 = blockIdx.y * TK;
  const int n0 = blockIdx.x * TN;
  const int end = min(a.ends[g], a.M);
  const int start = min(g > 0 ? a.ends[g - 1] : 0, end);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;  // warp tile: 64 of k x 32 of n

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int n_chunks = (end - start + TR - 1) / TR;
  auto issue = [&](int c) {
    if (c < n_chunks) {
      const int st = c % kStages;
      const int r0 = start + c * TR;
      load_tile<TR, TK, PL>(l_s + st * TR * PL, a.lhs, a.K, r0, start, end, k0, a.K);
      load_tile<TR, TN, PD>(d_s + st * TR * PD, a.dout, a.N, r0, start, end, n0, a.N);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    issue(c + kStages - 1);
    const int st = c % kStages;
    const bf16* ls = l_s + st * TR * PL;
    const bf16* ds = d_s + st * TR * PD;
#pragma unroll
    for (int kk = 0; kk < TR / 16; ++kk) {  // contraction over 16 rows at a time
      uint32_t af[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) ldsm_x4_t(af[mi], at_addr<PL>(ls, wm * 64 + mi * 16, kk * 16, lane));
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t bf[4];
        ldsm_x4_t(bf, bt_addr<PD>(ds, kk * 16, wn * 32 + j * 16, lane));
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          mma(acc[mi][2 * j], af[mi], bf[0], bf[1]);
          mma(acc[mi][2 * j + 1], af[mi], bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  float* out_g = a.out + static_cast<long long>(g) * a.K * a.N;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kr = k0 + wm * 64 + mi * 16 + (lane >> 2) + 8 * h;
      if (kr >= a.K) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn * 32 + ni * 8 + 2 * (lane & 3);
        if (col < a.N)
          *reinterpret_cast<float2*>(out_g + static_cast<long long>(kr) * a.N + col) =
              make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
    }
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

bool shape_ok(int M, int K, int N, int G) {
  return M >= 1 && K >= 8 && N >= 8 && G >= 1 && K % 8 == 0 && N % 8 == 0;
}

}  // namespace

extern "C" {

// Each launches on `stream`, allocates nothing and returns cudaGetLastError()
// after the launch (0 = launched), or an error code for a shape it does not
// take (K or N not a multiple of 8).

// plan: int32 [4, W] from ops/grouped_matmul.py gmm_plan with tile 128 and
// W = ceil(M / 128) + G + 1
int grouped_matmul_gmm(const void* lhs, const void* rhs, const int* plan, void* out, int M, int K, int N,
                       int G, int W, int transpose_rhs, void* stream) {
  if (!shape_ok(M, K, N, G) || W < 1 || W > 65535) return kErrUnsupported;
  GmmArgs a = {static_cast<const bf16*>(lhs), static_cast<const bf16*>(rhs), plan, static_cast<bf16*>(out),
               M, K, N, G, W};
  const dim3 grid((N + BN - 1) / BN, W);
  const size_t a_bytes = static_cast<size_t>(kStages) * BM * PA * sizeof(bf16);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (transpose_rhs)
    return launch(gmm_kernel<true>, grid, a_bytes + static_cast<size_t>(kStages) * BN * PBT * sizeof(bf16), a,
                  s);
  return launch(gmm_kernel<false>, grid, a_bytes + static_cast<size_t>(kStages) * BK * PB * sizeof(bf16), a, s);
}

// ends: int32 [G], the inclusive cumsum of group_sizes
int grouped_matmul_tgmm(const void* lhs, const void* dout, const int* ends, float* out, int M, int K, int N,
                        int G, void* stream) {
  if (!shape_ok(M, K, N, G) || G > 65535) return kErrUnsupported;
  TgmmArgs a = {static_cast<const bf16*>(lhs), static_cast<const bf16*>(dout), ends, out, M, K, N, G};
  const dim3 grid((N + TN - 1) / TN, (K + TK - 1) / TK, G);
  const size_t smem = static_cast<size_t>(kStages) * (TR * PL + TR * PD) * sizeof(bf16);
  return launch(tgmm_kernel, grid, smem, a, reinterpret_cast<cudaStream_t>(stream));
}

const char* grouped_matmul_error_string(int code) {
  if (code == kErrUnsupported) return "shape not supported by the grouped-matmul kernels";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
