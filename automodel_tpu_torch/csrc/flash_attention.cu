// Flash attention for training: the forward and the two backward kernels
// (dq, and dk/dv), with positional masking and the logits soft cap.
//
// Replaces the Pallas TPU kernels of automodel_tpu/ops/ring_flash.py:
// _fwd_kernel (:62, through flash_block_fwd :219), _dq_kernel (:102) and
// _dkv_kernel (:134, both through flash_block_bwd :258); and with them the
// library splash kernel that automodel_tpu/ops/attention.py:206
// _splash_flash runs for `attn: flash`, its attn_logits_soft_cap (:263)
// included. gpt-oss sinks are folded around these kernels in
// ops/ring_flash.py.
//
// Function (the same as the JAX kernels): q [B, Sq, N, H] attends k/v
// [B, Sk, Nkv, H], all bf16, H 64, 128 or 256, head n reading kv head
// n / (N / Nkv). Entry (i, j) is visible when seg_q[b, i] == seg_kv[b, j]
// (if segment ids are given), q_pos[i] >= kv_pos[j] (if causal) and
// q_pos[i] - kv_pos[j] < window (if a window is given). Positions are
// global and non-decreasing. s = scale * q.k in fp32; under a soft cap c
// (cap > 0) s = c * tanh(scale * q.k / c), applied BEFORE the mask (a
// masked score is NEG_INF, never c * tanh(NEG_INF / c) = -c, which would
// let masked keys in with weight e^-(c + max)); softmax in fp32 over the
// capped scores, so the lse is of them; a row that sees nothing writes out
// 0 and lse NEG_INF. Backward: P = exp(s - lse) recomputed from the saved
// lse, dP = dO.V^T, dS = P * (dP - delta) with delta = rowsum(dO * out),
// times 1 - t^2 under the cap, where t = tanh(scale * q.k / c) is
// recomputed from the fp32 scores (not from s / c); dq = scale * dS.K,
// dk = scale * dS^T.Q, dv = P^T.dO; dk and dv are summed over the q heads
// of each kv head inside the kernel.
//
// The cap's tanh is full-precision tanhf (at most 2 ulp), not
// tanh.approx.f32: the approximation's relative error of ~2^-11 is up to
// 0.024 in s at c = 50, ~2.4% in P, three times the 2^-7 held on output
// rows. The cap is a template flag chosen at launch (cap <= 0: none), so
// the kernels without it are the same code as before it existed.
//
// What bounds it on an H100: tensor-core operations. Per live (q, k) pair
// and head the forward does 4*H flops (two products), dq 6*H (three) and
// dkv 8*H (four), at 2*H/2 bytes of q/k/v per row reused across a whole
// tile, far above the ~295 flops per byte where bandwidth would be the
// limit. The least time is the live pairs' flops over 989 TFLOP/s bf16
// (the cap's tanh, one per live pair and head in each kernel, not counted).
//
// Design (simple first: mma.sync, cp.async, no wgmma/TMA/warp
// specialisation yet):
// - fwd: one CTA of 4 warps per (batch, q head, 64 q rows); each warp owns
//   16 rows. A loop over kv tiles of 64 rows replaces the TPU's sequential
//   grid axis; it runs from the first tile the window can see to the last
//   tile at or before the causal diagonal (found by binary search over the
//   positions), so dead tiles are never read. K/V tiles are staged in
//   shared memory with cp.async, two stages. S = Q.K^T and O += P.V are
//   mma.sync m16n8k16 bf16 with fp32 accumulation; the online softmax runs
//   in fp32 registers; P is rounded to bf16 for the P.V product (the TPU
//   kernel keeps it fp32). The ragged edge is masked in the kernel: rows
//   past S load as zeros and are never stored, so no padding copy.
// - dq: one CTA per (batch, q head, 64 q rows), loop over live kv tiles of
//   32 rows; dq accumulates in fp32 registers and is written in fp32.
// - dkv: one CTA per (batch, kv head, 64 kv rows), loop over the rep q
//   heads of the group and their live q tiles of 32 rows; dk and dv
//   accumulate in fp32 registers, so the GQA sum needs no [B*N, Sk, H]
//   intermediate and no atomics: the result is deterministic.
// - H = 256: a warp's fp32 [16, 256] accumulator is 128 registers a
//   thread, so the fwd's O and dq's dQ each fit (with Q and dO fragments
//   read from shared memory at each k step instead of kept in registers,
//   as at H <= 128), but dkv's dK and dV together (256) cannot. dkv at
//   H = 256 runs 8 warps: two warps per 16-row kv strip, each owning half
//   of the head dim of dK and dV, each recomputing the strip's S^T and dP^T
//   (the two products over the whole head dim; 1.5x dkv's tensor work
//   there, no shared-memory exchange and no extra barrier).
// - shared memory per CTA, rows padded to H + 8: fwd 64 + 4 x 64 rows
//   (168,960 B at H = 256), dq and dkv 2 x 64 + 4 x 32 rows (135,168 B),
//   under the 227 KB a block may take; the 16-byte pad puts ldmatrix's
//   eight row addresses in different banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 128;  // 4 warps: fwd, dq, and dkv at H <= 128
constexpr int kErrUnsupported = 100001;
// NEG_INF of ring_flash.py: -0.7 * float32 max, rounded once to fp32
constexpr float kNegInf = static_cast<float>(-0.7 * 3.4028234663852886e38);

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* lse;
  const float* delta;
  const int* q_pos;
  const int* kv_pos;
  const int* seg_q;   // [B, Sq] or null
  const int* seg_kv;  // [B, Sk] or null
  bf16* out;
  float* lse_out;
  float* dq;
  float* dk;
  float* dv;
  int B, Sq, Sk, N, Nkv, causal, window;
  float scale;
  float cap;  // logits soft cap; <= 0: none
};

// -- primitives ---------------------------------------------------------------

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

// four 8x8 b16 matrices; lanes 8j..8j+7 give the row addresses of matrix j
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// an A fragment (16 rows x 16 k) from the accumulators of two 16x8 tiles
// (columns k0..k0+7 and k0+8..k0+15), rounded to bf16
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4], const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// ldmatrix row addresses inside a [rows][P] tile, for the lane:
// A fragment (16 rows from r0, 16 columns from c0)
template <int P>
__device__ __forceinline__ const bf16* a_addr(const bf16* t, int r0, int c0, int lane) {
  return t + (r0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * P + c0 + (lane >> 4) * 8;
}
// B fragments of two n-tiles from a row-major [n][k] tile (n from n0, k from k0)
template <int P>
__device__ __forceinline__ const bf16* b_addr(const bf16* t, int n0, int k0, int lane) {
  return t + (n0 + (lane >> 4) * 8 + (lane & 7)) * P + k0 + ((lane >> 3) & 1) * 8;
}
// B fragments of two n-tiles from a row-major [k][n] tile, for ldsm_x4_t
template <int P>
__device__ __forceinline__ const bf16* bt_addr(const bf16* t, int k0, int n0, int lane) {
  return t + (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * P + n0 + (lane >> 4) * 8;
}

// ROWS rows of H bf16 from `src` (row stride in elements) into a padded
// shared tile, by THREADS threads; rows at or past n_rows are zero-filled
template <int ROWS, int H, int THREADS = kThreads>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, long long stride, int row0,
                                          int n_rows) {
  constexpr int P = H + 8;
  constexpr int CPR = H / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < ROWS * CPR; c += THREADS) {
    const int r = c / CPR;
    const int w = c - r * CPR;
    const bool ok = row0 + r < n_rows;
    const bf16* s = ok ? src + static_cast<long long>(row0 + r) * stride + w * 8 : src;
    cp_async16(dst + r * P + w * 8, s, ok);
  }
}

__device__ __forceinline__ bool visible(int qp, int kp, int causal, int window) {
  return (!causal || qp >= kp) && (window <= 0 || qp - kp < window);
}

// Tiles of `tile` rows over non-decreasing pos[0, len): the number of tiles
// whose first position is <= bound, and the first tile whose last position
// is > bound.
__device__ int tiles_first_le(const int* pos, int tile, int n_tiles, long long bound) {
  int lo = 0, hi = n_tiles;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (static_cast<long long>(pos[mid * tile]) <= bound) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__device__ int first_tile_last_gt(const int* pos, int len, int tile, int n_tiles, long long bound) {
  int lo = 0, hi = n_tiles;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int last = min((mid + 1) * tile, len) - 1;
    if (static_cast<long long>(pos[last]) > bound) hi = mid;
    else lo = mid + 1;
  }
  return lo;
}

// live kv tiles [lo, hi) for the q rows whose positions span [qmin, qmax]
__device__ __forceinline__ void live_kv_tiles(const Args& a, int bk, int qmin, int qmax, int& lo, int& hi) {
  const int n = (a.Sk + bk - 1) / bk;
  hi = a.causal ? tiles_first_le(a.kv_pos, bk, n, qmax) : n;
  lo = a.window > 0 ? first_tile_last_gt(a.kv_pos, a.Sk, bk, n, static_cast<long long>(qmin) - a.window) : 0;
}

// -- forward ------------------------------------------------------------------

template <int H, bool CAP>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Args a) {
  constexpr int BQ = 64, BK = 64, P = H + 8, KC = H / 16, NT = BK / 8, HT = H / 8;
  // Q fragments stay in registers at H <= 128; at H = 256 they are read from
  // shared memory at each k step, leaving the registers to the accumulator
  constexpr bool kRegs = H <= 128;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);  // [BQ][P]
  bf16* k_s = q_s + BQ * P;                   // [2][BK][P]
  bf16* v_s = k_s + 2 * BK * P;               // [2][BK][P]
  __shared__ int kpos_s[2][BK];
  __shared__ int kseg_s[2][BK];

  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest causal rows first
  const int b = blockIdx.y / a.N;
  const int n = blockIdx.y - b * a.N;
  const int g = n / (a.N / a.Nkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = qt * BQ;
  const long long kv_stride = static_cast<long long>(a.Nkv) * H;
  const bf16* kb = a.k + (static_cast<long long>(b) * a.Sk * a.Nkv + g) * H;
  const bf16* vb = a.v + (static_cast<long long>(b) * a.Sk * a.Nkv + g) * H;
  const int* segq = a.seg_q ? a.seg_q + static_cast<long long>(b) * a.Sq : nullptr;
  const int* segk = a.seg_kv ? a.seg_kv + static_cast<long long>(b) * a.Sk : nullptr;

  int row[2], qp[2], qs[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = q0 + warp * 16 + (lane >> 2) + 8 * h;
    const int r = min(row[h], a.Sq - 1);
    qp[h] = a.q_pos[r];
    qs[h] = segq ? segq[r] : 0;
  }
  int t_lo, t_hi;
  live_kv_tiles(a, BK, a.q_pos[q0], a.q_pos[min(q0 + BQ, a.Sq) - 1], t_lo, t_hi);

  auto issue = [&](int t) {
    if (t < t_hi) {
      const int st = (t - t_lo) & 1;
      load_rows<BK, H>(k_s + st * BK * P, kb, kv_stride, t * BK, a.Sk);
      load_rows<BK, H>(v_s + st * BK * P, vb, kv_stride, t * BK, a.Sk);
      if (threadIdx.x < BK) {
        const int c = min(t * BK + static_cast<int>(threadIdx.x), a.Sk - 1);
        kpos_s[st][threadIdx.x] = a.kv_pos[c];
        kseg_s[st][threadIdx.x] = segk ? segk[c] : 0;
      }
    }
    cp_async_commit();
  };

  load_rows<BQ, H>(q_s, a.q + (static_cast<long long>(b) * a.Sq * a.N + n) * H,
                   static_cast<long long>(a.N) * H, q0, a.Sq);
  cp_async_commit();
  issue(t_lo);
  cp_async_wait<1>();
  __syncthreads();
  uint32_t qf[kRegs ? KC : 1][4];
  if constexpr (kRegs) {
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) ldsm_x4(qf[kk], a_addr<P>(q_s, warp * 16, kk * 16, lane));
  }

  float o[HT][4];
#pragma unroll
  for (int i = 0; i < HT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums

  for (int t = t_lo; t < t_hi; ++t) {
    issue(t + 1);
    cp_async_wait<1>();
    __syncthreads();  // tile t has landed
    const int st = (t - t_lo) & 1;
    const bf16* ks = k_s + st * BK * P;
    const bf16* vs = v_s + st * BK * P;

    float s[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      uint32_t qa[4];
      if constexpr (kRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[e] = qf[kk][e];
      } else {
        ldsm_x4(qa, a_addr<P>(q_s, warp * 16, kk * 16, lane));
      }
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        uint32_t kf[4];
        ldsm_x4(kf, b_addr<P>(ks, j * 16, kk * 16, lane));
        mma(s[2 * j], qa, kf[0], kf[1]);
        mma(s[2 * j + 1], qa, kf[2], kf[3]);
      }
    }

    uint32_t live = 0;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < NT; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int c = i * 8 + 2 * (lane & 3) + (e & 1);
        const bool ok = t * BK + c < a.Sk && visible(qp[h], kpos_s[st][c], a.causal, a.window) &&
                        (!segq || qs[h] == kseg_s[st][c]);
        float x;
        if constexpr (CAP) {
          x = ok ? a.cap * tanhf(s[i][e] * a.scale / a.cap) : kNegInf;  // the cap, then the mask
        } else {
          x = ok ? s[i][e] * a.scale : kNegInf;
        }
        s[i][e] = x;
        live |= static_cast<uint32_t>(ok) << (i * 4 + e);
        mx[h] = fmaxf(mx[h], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      corr[h] = __expf(m[h] - m_new);
      m[h] = m_new;
      l[h] *= corr[h];
    }
#pragma unroll
    for (int i = 0; i < NT; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float p = (live >> (i * 4 + e)) & 1u ? __expf(s[i][e] - m[h]) : 0.f;
        s[i][e] = p;
        l[h] += p;
      }
    }
#pragma unroll
    for (int i = 0; i < HT; ++i) {
      o[i][0] *= corr[0];
      o[i][1] *= corr[0];
      o[i][2] *= corr[1];
      o[i][3] *= corr[1];
    }
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t pa[4];
      acc_to_a(pa, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
      for (int j = 0; j < HT / 2; ++j) {
        uint32_t vf[4];
        ldsm_x4_t(vf, bt_addr<P>(vs, kc * 16, j * 16, lane));
        mma(o[2 * j], pa, vf[0], vf[1]);
        mma(o[2 * j + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lh = l[h];
    lh += __shfl_xor_sync(0xffffffffu, lh, 1);
    lh += __shfl_xor_sync(0xffffffffu, lh, 2);
    if (row[h] >= a.Sq) continue;
    const float denom = fmaxf(lh, 1e-30f);
    bf16* orow = a.out + ((static_cast<long long>(b) * a.Sq + row[h]) * a.N + n) * H + 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < HT; ++i) {
      const float x0 = lh > 0.f ? o[i][2 * h] / denom : 0.f;
      const float x1 = lh > 0.f ? o[i][2 * h + 1] / denom : 0.f;
      *reinterpret_cast<__nv_bfloat162*>(orow + i * 8) = __floats2bfloat162_rn(x0, x1);
    }
    if ((lane & 3) == 0) {
      a.lse_out[(static_cast<long long>(b) * a.N + n) * a.Sq + row[h]] =
          lh > 0.f ? m[h] + logf(denom) : kNegInf;
    }
  }
}

// -- backward: dq ---------------------------------------------------------------

template <int H, bool CAP>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(const Args a) {
  constexpr int BQ = 64, BK = 32, P = H + 8, KC = H / 16, NT = BK / 8, HT = H / 8;
  constexpr bool kRegs = H <= 128;  // Q and dO fragments in registers, as in the fwd
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);  // [BQ][P]
  bf16* do_s = q_s + BQ * P;                  // [BQ][P]
  bf16* k_s = do_s + BQ * P;                  // [2][BK][P]
  bf16* v_s = k_s + 2 * BK * P;               // [2][BK][P]
  __shared__ int kpos_s[2][BK];
  __shared__ int kseg_s[2][BK];

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int b = blockIdx.y / a.N;
  const int n = blockIdx.y - b * a.N;
  const int g = n / (a.N / a.Nkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = qt * BQ;
  const long long q_stride = static_cast<long long>(a.N) * H;
  const long long kv_stride = static_cast<long long>(a.Nkv) * H;
  const long long q_base = (static_cast<long long>(b) * a.Sq * a.N + n) * H;
  const bf16* kb = a.k + (static_cast<long long>(b) * a.Sk * a.Nkv + g) * H;
  const bf16* vb = a.v + (static_cast<long long>(b) * a.Sk * a.Nkv + g) * H;
  const int* segq = a.seg_q ? a.seg_q + static_cast<long long>(b) * a.Sq : nullptr;
  const int* segk = a.seg_kv ? a.seg_kv + static_cast<long long>(b) * a.Sk : nullptr;
  const long long row_base = (static_cast<long long>(b) * a.N + n) * a.Sq;

  int row[2], qp[2], qs[2];
  float lse[2], dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = q0 + warp * 16 + (lane >> 2) + 8 * h;
    const int r = min(row[h], a.Sq - 1);
    qp[h] = a.q_pos[r];
    qs[h] = segq ? segq[r] : 0;
    lse[h] = a.lse[row_base + r];
    dlt[h] = a.delta[row_base + r];
  }
  int t_lo, t_hi;
  live_kv_tiles(a, BK, a.q_pos[q0], a.q_pos[min(q0 + BQ, a.Sq) - 1], t_lo, t_hi);

  auto issue = [&](int t) {
    if (t < t_hi) {
      const int st = (t - t_lo) & 1;
      load_rows<BK, H>(k_s + st * BK * P, kb, kv_stride, t * BK, a.Sk);
      load_rows<BK, H>(v_s + st * BK * P, vb, kv_stride, t * BK, a.Sk);
      if (threadIdx.x < BK) {
        const int c = min(t * BK + static_cast<int>(threadIdx.x), a.Sk - 1);
        kpos_s[st][threadIdx.x] = a.kv_pos[c];
        kseg_s[st][threadIdx.x] = segk ? segk[c] : 0;
      }
    }
    cp_async_commit();
  };

  load_rows<BQ, H>(q_s, a.q + q_base, q_stride, q0, a.Sq);
  load_rows<BQ, H>(do_s, a.dout + q_base, q_stride, q0, a.Sq);
  cp_async_commit();
  issue(t_lo);
  cp_async_wait<1>();
  __syncthreads();
  uint32_t qf[kRegs ? KC : 1][4], df[kRegs ? KC : 1][4];
  if constexpr (kRegs) {
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      ldsm_x4(qf[kk], a_addr<P>(q_s, warp * 16, kk * 16, lane));
      ldsm_x4(df[kk], a_addr<P>(do_s, warp * 16, kk * 16, lane));
    }
  }

  float dq[HT][4];
#pragma unroll
  for (int i = 0; i < HT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[i][e] = 0.f;

  for (int t = t_lo; t < t_hi; ++t) {
    issue(t + 1);
    cp_async_wait<1>();
    __syncthreads();
    const int st = (t - t_lo) & 1;
    const bf16* ks = k_s + st * BK * P;
    const bf16* vs = v_s + st * BK * P;

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      uint32_t qa[4], da[4];
      if constexpr (kRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          qa[e] = qf[kk][e];
          da[e] = df[kk][e];
        }
      } else {
        ldsm_x4(qa, a_addr<P>(q_s, warp * 16, kk * 16, lane));
        ldsm_x4(da, a_addr<P>(do_s, warp * 16, kk * 16, lane));
      }
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        uint32_t kf[4], vf[4];
        ldsm_x4(kf, b_addr<P>(ks, j * 16, kk * 16, lane));
        mma(s[2 * j], qa, kf[0], kf[1]);
        mma(s[2 * j + 1], qa, kf[2], kf[3]);
        ldsm_x4(vf, b_addr<P>(vs, j * 16, kk * 16, lane));
        mma(dp[2 * j], da, vf[0], vf[1]);
        mma(dp[2 * j + 1], da, vf[2], vf[3]);
      }
    }
#pragma unroll
    for (int i = 0; i < NT; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int c = i * 8 + 2 * (lane & 3) + (e & 1);
        const bool ok = t * BK + c < a.Sk && visible(qp[h], kpos_s[st][c], a.causal, a.window) &&
                        (!segq || qs[h] == kseg_s[st][c]);
        if constexpr (CAP) {
          // t from the fp32 scores, as the forward computed it
          const float t = ok ? tanhf(s[i][e] * a.scale / a.cap) : 0.f;
          const float p = ok ? __expf(a.cap * t - lse[h]) : 0.f;
          s[i][e] = p * (dp[i][e] - dlt[h]) * (1.f - t * t);  // dS, through the cap
        } else {
          const float p = ok ? __expf(s[i][e] * a.scale - lse[h]) : 0.f;
          s[i][e] = p * (dp[i][e] - dlt[h]);  // dS
        }
      }
    }
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t da[4];
      acc_to_a(da, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
      for (int j = 0; j < HT / 2; ++j) {
        uint32_t kf[4];
        ldsm_x4_t(kf, bt_addr<P>(ks, kc * 16, j * 16, lane));
        mma(dq[2 * j], da, kf[0], kf[1]);
        mma(dq[2 * j + 1], da, kf[2], kf[3]);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= a.Sq) continue;
    float* drow = a.dq + ((static_cast<long long>(b) * a.Sq + row[h]) * a.N + n) * H + 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < HT; ++i) {
      *reinterpret_cast<float2*>(drow + i * 8) =
          make_float2(a.scale * dq[i][2 * h], a.scale * dq[i][2 * h + 1]);
    }
  }
}

// -- backward: dk, dv -----------------------------------------------------------

// dkv's tiling: at H = 256 two warps share each 16-row kv strip, each
// owning H / 2 columns of dK and dV
template <int H>
struct DkvTiling {
  static constexpr int kSplit = H > 128 ? 2 : 1;  // warps per strip
  static constexpr int kThreads = 128 * kSplit;
};

template <int H, bool CAP>
__global__ void __launch_bounds__(DkvTiling<H>::kThreads) flash_dkv_kernel(const Args a) {
  constexpr int SPLIT = DkvTiling<H>::kSplit, THREADS = DkvTiling<H>::kThreads;
  constexpr int BK = 64, BQ = 32, P = H + 8, KC = H / 16, NT = BQ / 8, HW = H / SPLIT, HT = HW / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);  // [BK][P]
  bf16* v_s = k_s + BK * P;                   // [BK][P]
  bf16* q_s = v_s + BK * P;                   // [2][BQ][P]
  bf16* do_s = q_s + 2 * BQ * P;              // [2][BQ][P]
  __shared__ int qpos_s[2][BQ];
  __shared__ int qseg_s[2][BQ];
  __shared__ float lse_s[2][BQ];
  __shared__ float dlt_s[2][BQ];

  const int kt = blockIdx.x;  // under causal the first kv tiles see the most rows
  const int b = blockIdx.y / a.Nkv;
  const int g = blockIdx.y - b * a.Nkv;
  const int rep = a.N / a.Nkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int strip = warp / SPLIT, col0 = (warp % SPLIT) * HW;  // 16 kv rows, HW columns of dK/dV
  const int k0 = kt * BK;
  const long long q_stride = static_cast<long long>(a.N) * H;
  const long long kv_stride = static_cast<long long>(a.Nkv) * H;
  const long long kv_base = (static_cast<long long>(b) * a.Sk * a.Nkv + g) * H;
  const int* segq = a.seg_q ? a.seg_q + static_cast<long long>(b) * a.Sq : nullptr;
  const int* segk = a.seg_kv ? a.seg_kv + static_cast<long long>(b) * a.Sk : nullptr;

  int row[2], kp[2], ksg[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = k0 + strip * 16 + (lane >> 2) + 8 * h;
    const int r = min(row[h], a.Sk - 1);
    kp[h] = a.kv_pos[r];
    ksg[h] = segk ? segk[r] : 0;
  }
  // live q tiles: causal needs a row at or after the tile's first key,
  // a window a row within `window` of its last key
  const int n_qt = (a.Sq + BQ - 1) / BQ;
  const int kmin = a.kv_pos[k0], kmax = a.kv_pos[min(k0 + BK, a.Sk) - 1];
  const int lo = a.causal ? first_tile_last_gt(a.q_pos, a.Sq, BQ, n_qt, static_cast<long long>(kmin) - 1) : 0;
  const int hi = a.window > 0
                     ? tiles_first_le(a.q_pos, BQ, n_qt, static_cast<long long>(kmax) + a.window - 1)
                     : n_qt;
  const int n_live = max(hi - lo, 0);
  const int total = rep * n_live;

  auto issue = [&](int i) {
    if (i < total) {
      const int st = i & 1;
      const int head = g * rep + i / n_live;
      const int q0 = (lo + i % n_live) * BQ;
      const long long base = (static_cast<long long>(b) * a.Sq * a.N + head) * H;
      load_rows<BQ, H, THREADS>(q_s + st * BQ * P, a.q + base, q_stride, q0, a.Sq);
      load_rows<BQ, H, THREADS>(do_s + st * BQ * P, a.dout + base, q_stride, q0, a.Sq);
      if (threadIdx.x < BQ) {
        const int c = min(q0 + static_cast<int>(threadIdx.x), a.Sq - 1);
        const long long rb = (static_cast<long long>(b) * a.N + head) * a.Sq;
        qpos_s[st][threadIdx.x] = a.q_pos[c];
        qseg_s[st][threadIdx.x] = segq ? segq[c] : 0;
        lse_s[st][threadIdx.x] = a.lse[rb + c];
        dlt_s[st][threadIdx.x] = a.delta[rb + c];
      }
    }
    cp_async_commit();
  };

  load_rows<BK, H, THREADS>(k_s, a.k + kv_base, kv_stride, k0, a.Sk);
  load_rows<BK, H, THREADS>(v_s, a.v + kv_base, kv_stride, k0, a.Sk);
  cp_async_commit();
  issue(0);

  float dk[HT][4], dv[HT][4];
#pragma unroll
  for (int i = 0; i < HT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;

  for (int i = 0; i < total; ++i) {
    issue(i + 1);
    cp_async_wait<1>();
    __syncthreads();
    const int st = i & 1;
    const int q0 = (lo + i % n_live) * BQ;
    const bf16* qs = q_s + st * BQ * P;
    const bf16* dos = do_s + st * BQ * P;

    // S^T = K.Q^T and dP^T = V.dO^T for this warp's 16 kv rows (over the
    // whole head dim: at H = 256 both warps of a strip compute them)
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      uint32_t ka[4], va[4];
      ldsm_x4(ka, a_addr<P>(k_s, strip * 16, kk * 16, lane));
      ldsm_x4(va, a_addr<P>(v_s, strip * 16, kk * 16, lane));
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        uint32_t qb[4], ob[4];
        ldsm_x4(qb, b_addr<P>(qs, j * 16, kk * 16, lane));
        mma(s[2 * j], ka, qb[0], qb[1]);
        mma(s[2 * j + 1], ka, qb[2], qb[3]);
        ldsm_x4(ob, b_addr<P>(dos, j * 16, kk * 16, lane));
        mma(dp[2 * j], va, ob[0], ob[1]);
        mma(dp[2 * j + 1], va, ob[2], ob[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int c = j * 8 + 2 * (lane & 3) + (e & 1);
        const bool ok = q0 + c < a.Sq && row[h] < a.Sk &&
                        visible(qpos_s[st][c], kp[h], a.causal, a.window) &&
                        (!segq || qseg_s[st][c] == ksg[h]);
        if constexpr (CAP) {
          const float t = ok ? tanhf(s[j][e] * a.scale / a.cap) : 0.f;
          const float p = ok ? __expf(a.cap * t - lse_s[st][c]) : 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - dlt_s[st][c]) * (1.f - t * t);  // dS^T, through the cap
        } else {
          const float p = ok ? __expf(s[j][e] * a.scale - lse_s[st][c]) : 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - dlt_s[st][c]);  // dS^T
        }
      }
    }
    // dV += P^T.dO, dK += dS^T.Q over this warp's HW columns
#pragma unroll
    for (int kc = 0; kc < BQ / 16; ++kc) {
      uint32_t pa[4], da[4];
      acc_to_a(pa, s[2 * kc], s[2 * kc + 1]);
      acc_to_a(da, dp[2 * kc], dp[2 * kc + 1]);
#pragma unroll
      for (int j = 0; j < HT / 2; ++j) {
        uint32_t ob[4], qb[4];
        ldsm_x4_t(ob, bt_addr<P>(dos, kc * 16, col0 + j * 16, lane));
        mma(dv[2 * j], pa, ob[0], ob[1]);
        mma(dv[2 * j + 1], pa, ob[2], ob[3]);
        ldsm_x4_t(qb, bt_addr<P>(qs, kc * 16, col0 + j * 16, lane));
        mma(dk[2 * j], da, qb[0], qb[1]);
        mma(dk[2 * j + 1], da, qb[2], qb[3]);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= a.Sk) continue;
    const long long off = ((static_cast<long long>(b) * a.Sk + row[h]) * a.Nkv + g) * H + col0 + 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < HT; ++i) {
      *reinterpret_cast<float2*>(a.dk + off + i * 8) =
          make_float2(a.scale * dk[i][2 * h], a.scale * dk[i][2 * h + 1]);
      *reinterpret_cast<float2*>(a.dv + off + i * 8) = make_float2(dv[i][2 * h], dv[i][2 * h + 1]);
    }
  }
}

// -- launch -------------------------------------------------------------------

template <typename Kernel>
int launch(Kernel kernel, dim3 grid, int threads, size_t smem, const Args& a, cudaStream_t stream) {
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// dynamic shared memory: padded bf16 rows
template <int H>
constexpr size_t rows_bytes(int rows) {
  return static_cast<size_t>(rows) * (H + 8) * sizeof(bf16);
}

enum Which { kFwd, kDq, kDkv };

template <int H, bool CAP>
int dispatch_cap(Which w, const Args& a, cudaStream_t stream) {
  switch (w) {
    case kFwd:
      return launch(flash_fwd_kernel<H, CAP>, dim3((a.Sq + 63) / 64, a.B * a.N), kThreads,
                    rows_bytes<H>(64 + 4 * 64), a, stream);
    case kDq:
      return launch(flash_dq_kernel<H, CAP>, dim3((a.Sq + 63) / 64, a.B * a.N), kThreads,
                    rows_bytes<H>(2 * 64 + 4 * 32), a, stream);
    case kDkv:
      return launch(flash_dkv_kernel<H, CAP>, dim3((a.Sk + 63) / 64, a.B * a.Nkv), DkvTiling<H>::kThreads,
                    rows_bytes<H>(2 * 64 + 4 * 32), a, stream);
  }
  return kErrUnsupported;
}

template <int H>
int dispatch(Which w, const Args& a, cudaStream_t stream) {
  return a.cap > 0.f ? dispatch_cap<H, true>(w, a, stream) : dispatch_cap<H, false>(w, a, stream);
}

int run(Which w, const Args& a, int H, void* stream_ptr) {
  if (a.B < 1 || a.Sq < 1 || a.Sk < 1 || a.Nkv < 1 || a.N % a.Nkv != 0 || a.B * a.N > 65535)
    return kErrUnsupported;
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  switch (H) {
    case 64: return dispatch<64>(w, a, stream);
    case 128: return dispatch<128>(w, a, stream);
    case 256: return dispatch<256>(w, a, stream);
  }
  return kErrUnsupported;
}

Args make_args(const void* q, const void* k, const void* v, const int* q_pos, const int* kv_pos,
               const int* seg_q, const int* seg_kv, int B, int Sq, int Sk, int N, int Nkv, int causal,
               int window, float scale, float cap) {
  Args a = {};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.q_pos = q_pos;
  a.kv_pos = kv_pos;
  a.seg_q = seg_q;
  a.seg_kv = seg_kv;
  a.B = B;
  a.Sq = Sq;
  a.Sk = Sk;
  a.N = N;
  a.Nkv = Nkv;
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  a.cap = cap;
  return a;
}

}  // namespace

extern "C" {

// Each launches on `stream`, allocates nothing and returns cudaGetLastError()
// after the launch (0 = launched), or an error code for a shape it does not
// take. window <= 0 means no window, cap <= 0 no soft cap; seg_q/seg_kv
// may be null.

int flash_attention_fwd(const void* q, const void* k, const void* v, const int* q_pos, const int* kv_pos,
                        const int* seg_q, const int* seg_kv, void* out, float* lse, int B, int Sq, int Sk,
                        int N, int Nkv, int H, int causal, int window, float scale, float cap, void* stream) {
  Args a = make_args(q, k, v, q_pos, kv_pos, seg_q, seg_kv, B, Sq, Sk, N, Nkv, causal, window, scale, cap);
  a.out = static_cast<bf16*>(out);
  a.lse_out = lse;
  return run(kFwd, a, H, stream);
}

int flash_attention_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                       const float* delta, const int* q_pos, const int* kv_pos, const int* seg_q,
                       const int* seg_kv, float* dq, int B, int Sq, int Sk, int N, int Nkv, int H,
                       int causal, int window, float scale, float cap, void* stream) {
  Args a = make_args(q, k, v, q_pos, kv_pos, seg_q, seg_kv, B, Sq, Sk, N, Nkv, causal, window, scale, cap);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = lse;
  a.delta = delta;
  a.dq = dq;
  return run(kDq, a, H, stream);
}

int flash_attention_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                        const float* delta, const int* q_pos, const int* kv_pos, const int* seg_q,
                        const int* seg_kv, float* dk, float* dv, int B, int Sq, int Sk, int N, int Nkv,
                        int H, int causal, int window, float scale, float cap, void* stream) {
  Args a = make_args(q, k, v, q_pos, kv_pos, seg_q, seg_kv, B, Sq, Sk, N, Nkv, causal, window, scale, cap);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = lse;
  a.delta = delta;
  a.dk = dk;
  a.dv = dv;
  return run(kDkv, a, H, stream);
}

const char* flash_attention_error_string(int code) {
  if (code == kErrUnsupported) return "shape not supported by the flash-attention kernels";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
