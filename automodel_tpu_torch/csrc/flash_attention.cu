// Flash attention for training on Hopper: the forward and the two backward
// kernels (dq, and dk/dv), with positional masking and the logits soft cap.
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
// [B, Sk, Nkv, H], all bf16, H 64, 128, 192 or 256, head n reading kv head
// n / (N / Nkv). Entry (i, j) is visible when seg_q[b, i] == seg_kv[b, j]
// (if segment ids are given), q_pos[i] >= kv_pos[j] (if causal) and
// q_pos[i] - kv_pos[j] < window (if a window is given). Positions are
// global and non-decreasing. s = scale * q.k in fp32; under a soft cap c
// (cap > 0) s = c * tanh(scale * q.k / c), applied BEFORE the mask (a
// masked score is -inf, never c * tanh(-inf) = -c, which would let masked
// keys in with weight e^-(c + max)); softmax in fp32 over the capped
// scores, so the lse is of them; a row that sees nothing writes out 0 and
// lse NEG_INF. Backward: P = exp(s - lse) recomputed from the saved lse,
// dP = dO.V^T, dS = P * (dP - delta) with delta = rowsum(dO * out), times
// 1 - t^2 under the cap, where t = tanh(scale * q.k / c) is recomputed from
// the fp32 scores (not from s / c); dq = scale * dS.K, dk = scale *
// dS^T.Q, dv = P^T.dO; dk and dv are summed over the q heads of each kv
// head inside the kernel. The cap's tanh is full-precision tanhf (at most
// 2 ulp), not tanh.approx.f32, whose ~2^-11 is up to 2.4% in P at c = 50;
// the cap is a template flag chosen at launch (cap <= 0: none).
//
// What bounds it on an H100: tensor-core operations. Per live (q, k) pair
// and q head the forward does 4*H flops (two products), dq 6*H (three)
// and dkv 8*H (four), at 2*H bytes of q/k/v a row reused across a whole
// tile, far above the ~295 flops per byte where bandwidth would bound it.
// The least time is the live pairs' flops over 989 TFLOP/s bf16 (the
// cap's tanh, one per live pair and head in each kernel, not counted).
// The tiles cover a few more pairs than are live (the causal diagonal's
// tiles: 3% at S = 4096); PERF.md has each kernel's time against the bound.
//
// Design (Hopper: wgmma, TMA, mbarriers, warp specialisation):
// - Every product is wgmma.mma_async m64nNk16 bf16 -> fp32. The first
//   products (S = Q.K^T, dP = dO.V^T, and their transposes in dkv) read
//   both operands from shared memory, K-major. The second products
//   (O += P.V, dQ += dS.K, dV += P^T.dO, dK += dS^T.Q) take P or dS from
//   registers as the A operand (the fp32 accumulator of the first product,
//   rounded to bf16, is the A fragment's layout) and read B from shared
//   memory MN-major through the transpose bit, so no transposed copy is
//   ever made. In the accumulator a thread holds rows warp%4*16 + lane/4 +
//   8i and columns 8j + 2(lane%4) + {0,1}; the mask, the cap and the
//   softmax run in that layout.
// - Tiles arrive by TMA (cp.async.bulk.tensor) into 128-byte-swizzled
//   shared memory, the layout the wgmma descriptors name (K-major: stride
//   1024 bytes between 8-row groups; MN-major: the same, and the box's
//   bytes between 64-column chunks). The host builds 4-D tensor maps (H,
//   heads, S, B) once per call (cuTensorMapEncodeTiled, reached through
//   cudaGetDriverEntryPoint, so the library links no -lcuda); a box is 64
//   columns (128 bytes) by the tile's rows of one head of one batch
//   element, so H = 128 loads as two boxes, H = 192 as three and H = 256 as
//   four, a box never
//   crosses into the next batch element, and rows past S arrive as zeros
//   (no padding copy). An mbarrier's transaction count is the whole box,
//   zero-filled rows included.
// - Each CTA is 384 threads: warpgroup 0 is the producer (setmaxnreg 24;
//   one warp: lane 0 issues the loads, then the 32 lanes copy the tile's
//   positions, segment ids, lse and delta into shared memory and arrive on
//   the stage's full barrier), warpgroups 1 and 2 consume (setmaxnreg 240;
//   128 x 24 + 256 x 240 = 64,512 of the 65,536 registers). Rings of
//   stages, each with a full and an empty mbarrier, keep the next tiles in
//   flight while the consumers work; every consumer thread arrives on the
//   empty barrier once its last read of the stage is done. (ptxas gives the
//   consumers their 240 registers only while no __trap() or call sits in
//   the kernel: a watchdog in the barrier wait made every H = 256 kernel
//   spill.)
// - The mask: a tile every pair of which is visible (found from the tile's
//   first and last positions, no segment ids) takes a path with no mask at
//   all; any other tile computes each pair's mask without branches (a
//   branch per element costs more than the tile's products).
// - fwd: one CTA per (batch, q head, 128 q rows), each consumer owning 64
//   rows; Q is loaded once; K and V tiles of 128 rows (H <= 128) or 64
//   (H = 192, 256) from the first tile the window can see to the last tile at or
//   before the causal diagonal (binary search over the positions), so dead
//   tiles are never read; two stages of K and V. Online softmax in fp32,
//   in log2 units (one FFMA and one ex2 a score); P is rounded to bf16 for
//   P.V (the TPU kernel keeps it fp32). Shared memory at H = 256: Q 64 KB +
//   K and V 128 KB.
// - dq: one CTA per (batch, q head, 128 q rows), Q and dO loaded once, K
//   and V tiles of 64 rows in four stages (32 rows in three at H = 192 and
//   256, where Q and dO take 96 and 128 KB); dS is rounded to bf16 for dS.K, which is
//   left running into the next tile's S and dP; dQ accumulates in fp32
//   registers.
// - dkv: one CTA per (batch, kv head, 128 kv rows; 64 at H > 128), K and V
//   loaded once, looping over the rep q heads of the group and their live
//   q tiles of 64 rows in four stages (two at H > 128). At H <= 128 each
//   consumer owns 64 kv rows and the whole head dim. Above it dK and dV of
//   64 rows would be H fp32 registers a thread (192 or 256), so the two
//   consumers share the 64 kv rows: consumer 0 owns the first 128 columns
//   of dK and dV, consumer 1 the other H - 128 (128 at H = 256, 64 at H =
//   192: a split on the 64-column chunks the MN-major descriptors address,
//   where halves of 96 would start inside a chunk), each recomputing S^T
//   and dP^T over the whole head dim (1.5x the tensor work at H = 256, no
//   exchange between them). dS^T is computed while dV += P^T.dO runs.
// - No atomics: dQ sums over its kv tiles inside one CTA, and dK / dV sum
//   over the rep q heads and their q tiles inside one CTA, in a fixed
//   order, so two launches give the same bits.
// - Causal grids launch the longest tiles first: blockIdx.x walks the heads
//   and blockIdx.y the q tiles from the last (fwd, dq) or the kv tiles from
//   the first (dkv).
// - Where the result rounds: S, dP and every sum are fp32; P and dS round
//   to bf16 once, before the second products; out rounds to bf16 once; lse,
//   dq, dk and dv are written in fp32.

#include "hopper.cuh"

namespace {

constexpr int kThreads = 384;        // producer warpgroup + two consumer warpgroups
constexpr int kConsumers = 256;      // threads arriving on an empty barrier
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
static_assert(128 * kProducerRegs + kConsumers * kConsumerRegs <= 65536, "register split");
constexpr int kErrUnsupported = 100001;
constexpr int kErrTensorMap = 100002;
// NEG_INF of ring_flash.py: -0.7 * float32 max, rounded once to fp32
constexpr float kNegInf = static_cast<float>(-0.7 * 3.4028234663852886e38);
constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;

// tiles per head dim; the bounds chip_smoke.py reports count live pairs,
// not these tiles, and the register split is kProducerRegs / kConsumerRegs
// above (ptxas's report of each instantiation: _cuda_build.ptxas_usage)
template <int H>
struct Tiles {
  static constexpr int kFwdBq = 128, kFwdBk = H <= 128 ? 128 : 64, kFwdStages = 2;
  static constexpr int kDqBq = 128, kDqBk = H <= 128 ? 64 : 32, kDqStages = H <= 128 ? 4 : 3;
  static constexpr bool kDkvSplit = H > 128;
  static constexpr int kDkvBk = kDkvSplit ? 64 : 128, kDkvBq = 64, kDkvStages = kDkvSplit ? 2 : 4;
};

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

// -- primitives (the shared ones are in hopper.cuh) ----------------------------

// ROWS rows of one head of one batch element: H / 64 boxes, chunk c at
// dst + c * ROWS * 128 bytes
template <int H, int ROWS>
__device__ __forceinline__ void tma_tile(bf16* dst, const CUtensorMap* map, uint64_t* bar, int head, int row0,
                                         int b) {
#pragma unroll
  for (int c = 0; c < H / 64; ++c) tma_load(dst + c * ROWS * 64, map, bar, c * 64, head, row0, b);
}

template <int V>
struct IntC {  // a column count carried into a generic lambda as a type
  static constexpr int value = V;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the A fragments (16 columns each) of a [64 x N] fp32 accumulator, rounded to bf16
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[N / 16][4], const float (&d)[N / 2]) {
#pragma unroll
  for (int kc = 0; kc < N / 16; ++kc) {
#pragma unroll
    for (int e = 0; e < 4; ++e) a[kc][e] = pack_bf16(d[8 * kc + 2 * e], d[8 * kc + 2 * e + 1]);
  }
}

__device__ __forceinline__ float ex2(float x) {  // 2^x; 2^-inf = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the mask of one (q row, kv row) pair whose rows are `in_range`, without
// branches (bitwise, every operand loaded)
__device__ __forceinline__ bool visible_at(const Args& a, bool in_range, int qp, int qs, int kp, int ks, bool segs) {
  return in_range & (!a.causal | (qp >= kp)) & ((a.window <= 0) | (qp - kp < a.window)) & (!segs | (qs == ks));
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

// every pair of q rows [q_lo, q_hi] x kv rows [k_lo, k_hi] (all in range)
// is visible: the tile needs no mask
__device__ __forceinline__ bool all_visible(const Args& a, int qmin, int qmax, int kmin, int kmax) {
  return !a.seg_q && (!a.causal || qmin >= kmax) && (a.window <= 0 || qmax - kmin < a.window);
}

// The online softmax of one tile of scores, in the accumulator's layout and
// in log2 units: s (raw q.k) becomes P = 2^(x - m2) in place, where x is
// scale * q.k (capped under CAP) times log2(e) and m2 the running row max;
// l (this thread's share of the row sums) and corr (the factor for what was
// summed before) follow. A masked score is -inf before the max, so its P is
// 2^-inf = 0 and a row with nothing visible yet keeps m2 = NEG_INF.
template <int BK, bool CAP>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], float (&m2)[2], float (&l)[2], float (&corr)[2],
                                             const Args& a, bool full_tile, int k0, const int* kpos,
                                             const int* kseg, const int (&qp)[2], const int (&qs)[2], bool segs,
                                             int lane) {
  const float c = CAP ? 1.f : a.scale * kLog2e;  // x = c * s where s holds what the max is taken of
  float mx[2] = {-INFINITY, -INFINITY};
  if (full_tile) {  // uniform across the warpgroup: no mask at all
#pragma unroll
    for (int x = 0; x < BK / 2; ++x) {
      if constexpr (CAP) s[x] = a.cap * tanhf(s[x] * a.scale / a.cap) * kLog2e;
      mx[(x >> 1) & 1] = fmaxf(mx[(x >> 1) & 1], s[x]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, col = 8 * j + 2 * (lane & 3) + (e & 1);
        const bool ok = visible_at(a, k0 + col < a.Sk, qp[h], qs[h], kpos[col], kseg[col], segs);
        float x = s[4 * j + e];
        if constexpr (CAP) x = a.cap * tanhf(x * a.scale / a.cap) * kLog2e;  // the cap, then the mask
        s[4 * j + e] = ok ? x : -INFINITY;
        mx[h] = fmaxf(mx[h], s[4 * j + e]);
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m2[h], mx[h] * c);
    corr[h] = ex2(m2[h] - m_new);
    m2[h] = m_new;
    l[h] *= corr[h];
  }
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2(fmaf(s[4 * j + e], c, -m2[e >> 1]));
      s[4 * j + e] = p;
      l[e >> 1] += p;
    }
  }
}

__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
}
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
}

// the producer warp's per-row copy of one kv tile's positions and segment
// ids (rows past Sk repeat the last: they are masked by index)
__device__ __forceinline__ void copy_kv_meta(const Args& a, const int* segk, int row0, int rows, int lane,
                                             int* kpos, int* kseg) {
  for (int r = lane; r < rows; r += 32) {
    const int c = min(row0 + r, a.Sk - 1);
    kpos[r] = a.kv_pos[c];
    kseg[r] = segk ? segk[c] : 0;
  }
}

// -- forward ------------------------------------------------------------------

template <int H>
struct FwdSmem {
  static constexpr int BQ = Tiles<H>::kFwdBq, BK = Tiles<H>::kFwdBk, kStages = Tiles<H>::kFwdStages;
  static constexpr int kQ = 0, kK = kQ + BQ * H * 2, kV = kK + kStages * BK * H * 2;
  static constexpr int kPos = kV + kStages * BK * H * 2, kSeg = kPos + kStages * BK * 4;
  static constexpr int kBars = kSeg + kStages * BK * 4, kRange = kBars + (1 + 2 * kStages) * 8;
  static constexpr int kBytes = kRange + 16 + 1024;  // + the alignment slack
};

template <int H, bool CAP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const Args a, const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv) {
  using L = FwdSmem<H>;
  constexpr int kStages = L::kStages;
  constexpr int BQ = L::BQ, BK = L::BK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_base(smem_raw);
  bf16* q_s = reinterpret_cast<bf16*>(sm + L::kQ);
  bf16* k_s = reinterpret_cast<bf16*>(sm + L::kK);
  bf16* v_s = reinterpret_cast<bf16*>(sm + L::kV);
  int* kpos_s = reinterpret_cast<int*>(sm + L::kPos);
  int* kseg_s = reinterpret_cast<int*>(sm + L::kSeg);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;
  int* range = reinterpret_cast<int*>(sm + L::kRange);

  const int bn = blockIdx.x, b = bn / a.N, n = bn - b * a.N;
  const int g = n / (a.N / a.Nkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // the longest causal rows first
  if (threadIdx.x == 0) {
    int lo, hi;
    live_kv_tiles(a, BK, a.q_pos[q0], a.q_pos[min(q0 + BQ, a.Sq) - 1], lo, hi);
    range[0] = lo;
    range[1] = max(hi - lo, 0);
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);  // the producer warp's lanes: the loads' bytes and the positions
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int t_lo = range[0], n_tiles = range[1];
  const int* segk = a.seg_kv ? a.seg_kv + static_cast<long long>(b) * a.Sk : nullptr;

  if (threadIdx.x < 128) {
    // -- producer: one warp loads Q once, then each tile's K and V (with
    // the tile's positions) into the ring
    producer_regs();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    if (lane == 0 && n_tiles > 0) {
      mbar_arrive_expect_tx(q_full, BQ * H * 2);
      tma_tile<H, BQ>(q_s, &tq, q_full, n, q0, b);
    }
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % kStages;
      if (i >= kStages) mbar_wait(&empty[st], ((i / kStages) & 1) ^ 1);
      const int row0 = (t_lo + i) * BK;
      if (lane == 0) {  // the loads first: the copy's global reads wait beside them
        mbar_expect_tx(&full[st], 2 * BK * H * 2);
        tma_tile<H, BK>(k_s + st * BK * H, &tk, &full[st], g, row0, b);
        tma_tile<H, BK>(v_s + st * BK * H, &tv, &full[st], g, row0, b);
      }
      copy_kv_meta(a, segk, row0, BK, lane, kpos_s + st * BK, kseg_s + st * BK);
      mbar_arrive(&full[st]);
    }
  } else {
    // -- consumers: 64 q rows each
    consumer_regs();
    const int wg = threadIdx.x / 128 - 1, tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int* segq = a.seg_q ? a.seg_q + static_cast<long long>(b) * a.Sq : nullptr;
    const int wq0 = q0 + wg * 64;
    int row[2], qp[2], qs[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      row[h] = wq0 + warp * 16 + (lane >> 2) + 8 * h;
      const int r = min(row[h], a.Sq - 1);
      qp[h] = a.q_pos[r];
      qs[h] = segq ? segq[r] : 0;
    }
    const int qmin = a.q_pos[min(wq0, a.Sq - 1)], qmax = a.q_pos[min(wq0 + 63, a.Sq - 1)];
    float o[H / 2];
    zero(o);
    float m2[2] = {kNegInf, kNegInf};  // running row max, log2 units
    float l[2] = {0.f, 0.f};           // this thread's share of the row sums
    float s[BK / 2];
    uint32_t pf[BK / 16][4];
    const bool segs = segq != nullptr;
    if (n_tiles > 0) mbar_wait(q_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % kStages, k0 = (t_lo + i) * BK;
      mbar_wait(&full[st], (i / kStages) & 1);
      zero(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < H / 16; ++kk)
        wgmma_ss<BK>(s, desc_k(q_s, BQ, wg * 64, kk), desc_k(k_s + st * BK * H, BK, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      const int* kpos = kpos_s + st * BK;
      const bool full_tile = k0 + BK <= a.Sk && all_visible(a, qmin, qmax, kpos[0], kpos[BK - 1]);
      float corr[2];
      softmax_tile<BK, CAP>(s, m2, l, corr, a, full_tile, k0, kpos, kseg_s + st * BK, qp, qs, segs, lane);
#pragma unroll
      for (int j = 0; j < H / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) o[4 * j + e] *= corr[e >> 1];
      }
      acc_to_a<BK>(pf, s);

      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc) wgmma_rs<H>(o, pf[kc], desc_mn(v_s + st * BK * H, BK, 0, kc));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pf);
      mbar_arrive(&empty[st]);
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float lh = l[h];
      lh += __shfl_xor_sync(0xffffffffu, lh, 1);
      lh += __shfl_xor_sync(0xffffffffu, lh, 2);
      if (row[h] >= a.Sq) continue;
      const float denom = fmaxf(lh, 1e-30f);
      const float inv = lh > 0.f ? __fdividef(1.f, denom) : 0.f;  // denom >= 1: the row max's own term
      bf16* orow = a.out + ((static_cast<long long>(b) * a.Sq + row[h]) * a.N + n) * H + 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < H / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
            __floats2bfloat162_rn(o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
      }
      if ((lane & 3) == 0) {
        a.lse_out[(static_cast<long long>(b) * a.N + n) * a.Sq + row[h]] =
            lh > 0.f ? m2[h] * kLn2 + logf(denom) : kNegInf;
      }
    }
  }
}

// -- backward: dq ---------------------------------------------------------------

template <int H>
struct DqSmem {
  static constexpr int BQ = Tiles<H>::kDqBq, BK = Tiles<H>::kDqBk, kStages = Tiles<H>::kDqStages;
  static constexpr int kQ = 0, kDo = kQ + BQ * H * 2, kK = kDo + BQ * H * 2, kV = kK + kStages * BK * H * 2;
  static constexpr int kPos = kV + kStages * BK * H * 2, kSeg = kPos + kStages * BK * 4;
  static constexpr int kBars = kSeg + kStages * BK * 4, kRange = kBars + (1 + 2 * kStages) * 8;
  static constexpr int kBytes = kRange + 16 + 1024;
};

template <int H, bool CAP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dq_kernel(const Args a, const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo) {
  using L = DqSmem<H>;
  constexpr int kStages = L::kStages;
  constexpr int BQ = L::BQ, BK = L::BK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_base(smem_raw);
  bf16* q_s = reinterpret_cast<bf16*>(sm + L::kQ);
  bf16* do_s = reinterpret_cast<bf16*>(sm + L::kDo);
  bf16* k_s = reinterpret_cast<bf16*>(sm + L::kK);
  bf16* v_s = reinterpret_cast<bf16*>(sm + L::kV);
  int* kpos_s = reinterpret_cast<int*>(sm + L::kPos);
  int* kseg_s = reinterpret_cast<int*>(sm + L::kSeg);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;
  int* range = reinterpret_cast<int*>(sm + L::kRange);

  const int bn = blockIdx.x, b = bn / a.N, n = bn - b * a.N;
  const int g = n / (a.N / a.Nkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  if (threadIdx.x == 0) {
    int lo, hi;
    live_kv_tiles(a, BK, a.q_pos[q0], a.q_pos[min(q0 + BQ, a.Sq) - 1], lo, hi);
    range[0] = lo;
    range[1] = max(hi - lo, 0);
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int t_lo = range[0], n_tiles = range[1];
  const int* segk = a.seg_kv ? a.seg_kv + static_cast<long long>(b) * a.Sk : nullptr;

  if (threadIdx.x < 128) {
    producer_regs();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    if (lane == 0 && n_tiles > 0) {
      mbar_arrive_expect_tx(q_full, 2 * BQ * H * 2);
      tma_tile<H, BQ>(q_s, &tq, q_full, n, q0, b);
      tma_tile<H, BQ>(do_s, &tdo, q_full, n, q0, b);
    }
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % kStages;
      if (i >= kStages) mbar_wait(&empty[st], ((i / kStages) & 1) ^ 1);
      const int row0 = (t_lo + i) * BK;
      if (lane == 0) {  // the loads first: the copy's global reads wait beside them
        mbar_expect_tx(&full[st], 2 * BK * H * 2);
        tma_tile<H, BK>(k_s + st * BK * H, &tk, &full[st], g, row0, b);
        tma_tile<H, BK>(v_s + st * BK * H, &tv, &full[st], g, row0, b);
      }
      copy_kv_meta(a, segk, row0, BK, lane, kpos_s + st * BK, kseg_s + st * BK);
      mbar_arrive(&full[st]);
    }
  } else {
    consumer_regs();
    const int wg = threadIdx.x / 128 - 1, tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int* segq = a.seg_q ? a.seg_q + static_cast<long long>(b) * a.Sq : nullptr;
    const long long row_base = (static_cast<long long>(b) * a.N + n) * a.Sq;
    const int wq0 = q0 + wg * 64;
    int row[2], qp[2], qs[2];
    float lse[2], dlt[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      row[h] = wq0 + warp * 16 + (lane >> 2) + 8 * h;
      const int r = min(row[h], a.Sq - 1);
      qp[h] = a.q_pos[r];
      qs[h] = segq ? segq[r] : 0;
      lse[h] = a.lse[row_base + r];
      dlt[h] = a.delta[row_base + r];
    }
    const int qmin = a.q_pos[min(wq0, a.Sq - 1)], qmax = a.q_pos[min(wq0 + 63, a.Sq - 1)];
    const bool segs = segq != nullptr;
    float dq[H / 2];
    zero(dq);
    uint32_t df[BK / 16][4];  // dS of the tile whose dS.K is in flight
    if (n_tiles > 0) mbar_wait(q_full, 0);

    // Per tile: S = Q.K^T and dP = dO.V^T issued together; P (times the
    // cap's 1 - t^2) computed while dP is on the tensor cores; then dS and
    // dQ += dS.K, left in flight into the next tile's products
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % kStages;
      mbar_wait(&full[st], (i / kStages) & 1);
      const bf16* ks = k_s + st * BK * H;
      const bf16* vs = v_s + st * BK * H;
      const int* kpos = kpos_s + st * BK;
      const int* kseg = kseg_s + st * BK;
      const int k0 = (t_lo + i) * BK;

      float s[BK / 2], dp[BK / 2];
      zero(s);
      zero(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < H / 16; ++kk)
        wgmma_ss<BK>(s, desc_k(q_s, BQ, wg * 64, kk), desc_k(ks, BK, 0, kk), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < H / 16; ++kk)
        wgmma_ss<BK>(dp, desc_k(do_s, BQ, wg * 64, kk), desc_k(vs, BK, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<1>();  // the last tile's dS.K and this S; dP may still run
      fence_regs(s);
      fence_regs(df);
      if (i > 0) mbar_arrive(&empty[(i - 1) % kStages]);

      const bool full_tile = k0 + BK <= a.Sk && all_visible(a, qmin, qmax, kpos[0], kpos[BK - 1]);
      auto prob = [&](float sc, int h) {  // P (times the cap's 1 - t^2) of one visible score
        if constexpr (CAP) {
          const float t = tanhf(sc * a.scale / a.cap);  // t from the fp32 scores, as the forward computed it
          return __expf(a.cap * t - lse[h]) * (1.f - t * t);
        } else {
          return __expf(sc * a.scale - lse[h]);
        }
      };
      if (full_tile) {  // uniform across the warpgroup
#pragma unroll
        for (int x = 0; x < BK / 2; ++x) s[x] = prob(s[x], (x >> 1) & 1);
      } else {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1, c = 8 * j + 2 * (lane & 3) + (e & 1), x = 4 * j + e;
            const bool ok = visible_at(a, k0 + c < a.Sk, qp[h], qs[h], kpos[c], kseg[c], segs);
            s[x] = ok ? prob(s[x], h) : 0.f;
          }
        }
      }
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int x = 0; x < BK / 2; ++x) s[x] *= dp[x] - dlt[(x >> 1) & 1];  // dS
      acc_to_a<BK>(df, s);

      fence_regs(dq);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc) wgmma_rs<H>(dq, df[kc], desc_mn(ks, BK, 0, kc));
      wgmma_commit();
    }
    wgmma_wait<0>();  // the last dS.K (none pending when there were no tiles)
    fence_regs(dq);
    fence_regs(df);
    if (n_tiles > 0) mbar_arrive(&empty[(n_tiles - 1) % kStages]);

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (row[h] >= a.Sq) continue;
      float* drow = a.dq + ((static_cast<long long>(b) * a.Sq + row[h]) * a.N + n) * H + 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < H / 8; ++j) {
        *reinterpret_cast<float2*>(drow + 8 * j) =
            make_float2(a.scale * dq[4 * j + 2 * h], a.scale * dq[4 * j + 2 * h + 1]);
      }
    }
  }
}

// -- backward: dk, dv -----------------------------------------------------------

template <int H>
struct DkvSmem {
  static constexpr int BK = Tiles<H>::kDkvBk, BQ = Tiles<H>::kDkvBq, kStages = Tiles<H>::kDkvStages;
  static constexpr int kK = 0, kV = kK + BK * H * 2, kQ = kV + BK * H * 2, kDo = kQ + kStages * BQ * H * 2;
  static constexpr int kPos = kDo + kStages * BQ * H * 2, kSeg = kPos + kStages * BQ * 4;
  static constexpr int kLse = kSeg + kStages * BQ * 4, kDlt = kLse + kStages * BQ * 4;
  static constexpr int kBars = kDlt + kStages * BQ * 4, kRange = kBars + (1 + 2 * kStages) * 8;
  static constexpr int kBytes = kRange + 16 + 1024;
};

template <int H, bool CAP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dkv_kernel(const Args a, const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo) {
  using L = DkvSmem<H>;
  constexpr int kStages = L::kStages;
  constexpr int BK = L::BK, BQ = L::BQ;
  constexpr bool SPLIT = Tiles<H>::kDkvSplit;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_base(smem_raw);
  bf16* k_s = reinterpret_cast<bf16*>(sm + L::kK);
  bf16* v_s = reinterpret_cast<bf16*>(sm + L::kV);
  bf16* q_s = reinterpret_cast<bf16*>(sm + L::kQ);
  bf16* do_s = reinterpret_cast<bf16*>(sm + L::kDo);
  int* qpos_s = reinterpret_cast<int*>(sm + L::kPos);
  int* qseg_s = reinterpret_cast<int*>(sm + L::kSeg);
  float* lse_s = reinterpret_cast<float*>(sm + L::kLse);
  float* dlt_s = reinterpret_cast<float*>(sm + L::kDlt);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;
  int* range = reinterpret_cast<int*>(sm + L::kRange);

  const int bg = blockIdx.x, b = bg / a.Nkv, g = bg - b * a.Nkv;
  const int rep = a.N / a.Nkv;
  const int k0 = blockIdx.y * BK;  // under causal the first kv tiles see the most rows
  const int n_qt = (a.Sq + BQ - 1) / BQ;
  if (threadIdx.x == 0) {
    // live q tiles: causal needs a row at or after the tile's first key, a
    // window a row within `window` of its last key
    const int kmin = a.kv_pos[k0], kmax = a.kv_pos[min(k0 + BK, a.Sk) - 1];
    const int lo = a.causal ? first_tile_last_gt(a.q_pos, a.Sq, BQ, n_qt, static_cast<long long>(kmin) - 1) : 0;
    const int hi = a.window > 0 ? tiles_first_le(a.q_pos, BQ, n_qt, static_cast<long long>(kmax) + a.window - 1)
                                : n_qt;
    range[0] = lo;
    range[1] = max(hi - lo, 0);
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int lo = range[0], n_live = range[1], total = rep * n_live;

  if (threadIdx.x < 128) {
    producer_regs();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    const int* segq = a.seg_q ? a.seg_q + static_cast<long long>(b) * a.Sq : nullptr;
    if (lane == 0 && total > 0) {
      mbar_arrive_expect_tx(kv_full, 2 * BK * H * 2);
      tma_tile<H, BK>(k_s, &tk, kv_full, g, k0, b);
      tma_tile<H, BK>(v_s, &tv, kv_full, g, k0, b);
    }
    for (int i = 0; i < total; ++i) {
      const int st = i % kStages;
      if (i >= kStages) mbar_wait(&empty[st], ((i / kStages) & 1) ^ 1);
      const int head = g * rep + i / n_live;
      const int q0 = (lo + i % n_live) * BQ;
      const long long rb = (static_cast<long long>(b) * a.N + head) * a.Sq;
      if (lane == 0) {
        mbar_expect_tx(&full[st], 2 * BQ * H * 2);
        tma_tile<H, BQ>(q_s + st * BQ * H, &tq, &full[st], head, q0, b);
        tma_tile<H, BQ>(do_s + st * BQ * H, &tdo, &full[st], head, q0, b);
      }
      for (int r = lane; r < BQ; r += 32) {
        const int c = min(q0 + r, a.Sq - 1);
        qpos_s[st * BQ + r] = a.q_pos[c];
        qseg_s[st * BQ + r] = segq ? segq[c] : 0;
        lse_s[st * BQ + r] = a.lse[rb + c];
        dlt_s[st * BQ + r] = a.delta[rb + c];
      }
      mbar_arrive(&full[st]);
    }
  } else {
    consumer_regs();
    const int wg = threadIdx.x / 128 - 1, tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    // one consumer's work: kv rows row0 + [0, 64) of the tile, HW columns of
    // dK and dV from 64-column chunk chunk0
    auto consume = [&](auto hw, const int row0, const int chunk0) {
      constexpr int HW = decltype(hw)::value;
      const int* segk = a.seg_kv ? a.seg_kv + static_cast<long long>(b) * a.Sk : nullptr;
      int krow[2], kp[2], ksg[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        krow[h] = k0 + row0 + warp * 16 + (lane >> 2) + 8 * h;
        const int r = min(krow[h], a.Sk - 1);
        kp[h] = a.kv_pos[r];
        ksg[h] = segk ? segk[r] : 0;
      }
      const bool rows_in = k0 + row0 + 64 <= a.Sk, segs = segk != nullptr;
      const bool krow_in[2] = {krow[0] < a.Sk, krow[1] < a.Sk};
      const int kmin = a.kv_pos[min(k0 + row0, a.Sk - 1)], kmax = a.kv_pos[min(k0 + row0 + 63, a.Sk - 1)];
      float dk[HW / 2], dv[HW / 2];
      zero(dk);
      zero(dv);
      if (total > 0) mbar_wait(kv_full, 0);

      for (int i = 0; i < total; ++i) {
        const int st = i % kStages;
        mbar_wait(&full[st], (i / kStages) & 1);
        const bf16* qs = q_s + st * BQ * H;
        const bf16* dos = do_s + st * BQ * H;
        const int* qpos = qpos_s + st * BQ;
        const int* qseg = qseg_s + st * BQ;
        const float* lse = lse_s + st * BQ;
        const float* dlt = dlt_s + st * BQ;
        const int q0 = (lo + i % n_live) * BQ;

        // S^T = K.Q^T and dP^T = V.dO^T for this consumer's 64 kv rows, over
        // the whole head dim; dS^T is computed while dV += P^T.dO runs
        float s[BQ / 2], dp[BQ / 2];
        zero(s);
        zero(dp);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < H / 16; ++kk)
          wgmma_ss<BQ>(s, desc_k(k_s, BK, row0, kk), desc_k(qs, BQ, 0, kk), kk > 0);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < H / 16; ++kk)
          wgmma_ss<BQ>(dp, desc_k(v_s, BK, row0, kk), desc_k(dos, BQ, 0, kk), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);

        const bool full_tile = rows_in && q0 + BQ <= a.Sq && all_visible(a, qpos[0], qpos[BQ - 1], kmin, kmax);
        uint32_t pf[BQ / 16][4], df[BQ / 16][4];
        auto prob = [&](int x, int c, bool ok) {  // P^T of one score; s[x] becomes what dS^T multiplies
          float p;
          if constexpr (CAP) {
            const float t = tanhf(s[x] * a.scale / a.cap);
            p = ok ? __expf(a.cap * t - lse[c]) : 0.f;
            s[x] = p * (1.f - t * t);  // through the cap
          } else {
            p = ok ? __expf(s[x] * a.scale - lse[c]) : 0.f;
            s[x] = p;
          }
          return p;
        };
        if (full_tile) {  // uniform across the warpgroup
#pragma unroll
          for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int c = 8 * j + 2 * (lane & 3), x = 4 * j + 2 * h;
              pf[j >> 1][(j & 1) * 2 + h] = pack_bf16(prob(x, c, true), prob(x + 1, c + 1, true));
            }
          }
        } else {
#pragma unroll
          for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int c = 8 * j + 2 * (lane & 3), x = 4 * j + 2 * h;
              bool ok[2];
#pragma unroll
              for (int e = 0; e < 2; ++e)
                ok[e] = visible_at(a, (q0 + c + e < a.Sq) & krow_in[h], qpos[c + e], qseg[c + e], kp[h], ksg[h], segs);
              pf[j >> 1][(j & 1) * 2 + h] = pack_bf16(prob(x, c, ok[0]), prob(x + 1, c + 1, ok[1]));
            }
          }
        }

        // dV += P^T.dO over this consumer's HW columns
        fence_regs(dv);
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < BQ / 16; ++kc) wgmma_rs<HW>(dv, pf[kc], desc_mn(dos, BQ, chunk0, kc));
        wgmma_commit();
#pragma unroll
        for (int x = 0; x < BQ / 2; ++x) s[x] *= dp[x] - dlt[8 * (x >> 2) + 2 * (lane & 3) + (x & 1)];  // dS^T
        acc_to_a<BQ>(df, s);

        // dK += dS^T.Q
        fence_regs(dk);
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < BQ / 16; ++kc) wgmma_rs<HW>(dk, df[kc], desc_mn(qs, BQ, chunk0, kc));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv);
        fence_regs(dk);
        fence_regs(pf);
        fence_regs(df);
        mbar_arrive(&empty[st]);
      }

#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (krow[h] >= a.Sk) continue;
        const long long off =
            ((static_cast<long long>(b) * a.Sk + krow[h]) * a.Nkv + g) * H + chunk0 * 64 + 2 * (lane & 3);
#pragma unroll
        for (int j = 0; j < HW / 8; ++j) {
          *reinterpret_cast<float2*>(a.dk + off + 8 * j) =
              make_float2(a.scale * dk[4 * j + 2 * h], a.scale * dk[4 * j + 2 * h + 1]);
          *reinterpret_cast<float2*>(a.dv + off + 8 * j) = make_float2(dv[4 * j + 2 * h], dv[4 * j + 2 * h + 1]);
        }
      }
    };
    if constexpr (!SPLIT) {
      consume(IntC<H>{}, wg * 64, 0);
    } else if constexpr (H - 128 == 128) {
      consume(IntC<128>{}, 0, wg * 2);
    } else if (wg == 0) {
      consume(IntC<128>{}, 0, 0);
    } else {
      consume(IntC<H - 128>{}, 0, 2);
    }
  }
}

// -- launch -------------------------------------------------------------------

// the 4-D map (H, heads, S, B) of a bf16 [B, S, heads, H] tensor, boxes of
// 64 columns x `rows` rows of one head of one batch element, 128-byte
// swizzle, rows past S read as zeros
int tensor_map(CUtensorMap* map, const bf16* base, int H, int heads, int S, int B, int rows) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return kErrTensorMap;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(H) * 2;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * S};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<bf16*>(base), dims, strides, box, unit,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap;
}

template <typename Kernel, typename... Maps>
int launch(Kernel kernel, dim3 grid, int smem, cudaStream_t stream, const Args& a, const Maps&... maps) {
  if (grid.y > 65535) return kErrUnsupported;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, kThreads, smem, stream>>>(a, maps...);
  return static_cast<int>(cudaGetLastError());
}

enum Which { kFwd, kDq, kDkv };

template <int H, bool CAP>
int dispatch_cap(Which w, const Args& a, cudaStream_t stream) {
  using T = Tiles<H>;
  CUtensorMap tq, tk, tv, tdo;
  int rc = 0;
  switch (w) {
    case kFwd:
      if ((rc = tensor_map(&tq, a.q, H, a.N, a.Sq, a.B, T::kFwdBq)) || (rc = tensor_map(&tk, a.k, H, a.Nkv, a.Sk, a.B, T::kFwdBk)) ||
          (rc = tensor_map(&tv, a.v, H, a.Nkv, a.Sk, a.B, T::kFwdBk)))
        return rc;
      return launch(flash_fwd_kernel<H, CAP>, dim3(a.B * a.N, (a.Sq + T::kFwdBq - 1) / T::kFwdBq), FwdSmem<H>::kBytes,
                    stream, a, tq, tk, tv);
    case kDq:
      if ((rc = tensor_map(&tq, a.q, H, a.N, a.Sq, a.B, T::kDqBq)) || (rc = tensor_map(&tdo, a.dout, H, a.N, a.Sq, a.B, T::kDqBq)) ||
          (rc = tensor_map(&tk, a.k, H, a.Nkv, a.Sk, a.B, T::kDqBk)) || (rc = tensor_map(&tv, a.v, H, a.Nkv, a.Sk, a.B, T::kDqBk)))
        return rc;
      return launch(flash_dq_kernel<H, CAP>, dim3(a.B * a.N, (a.Sq + T::kDqBq - 1) / T::kDqBq), DqSmem<H>::kBytes,
                    stream, a, tq, tk, tv, tdo);
    case kDkv:
      if ((rc = tensor_map(&tq, a.q, H, a.N, a.Sq, a.B, T::kDkvBq)) || (rc = tensor_map(&tdo, a.dout, H, a.N, a.Sq, a.B, T::kDkvBq)) ||
          (rc = tensor_map(&tk, a.k, H, a.Nkv, a.Sk, a.B, T::kDkvBk)) || (rc = tensor_map(&tv, a.v, H, a.Nkv, a.Sk, a.B, T::kDkvBk)))
        return rc;
      return launch(flash_dkv_kernel<H, CAP>, dim3(a.B * a.Nkv, (a.Sk + T::kDkvBk - 1) / T::kDkvBk),
                    DkvSmem<H>::kBytes, stream, a, tq, tk, tv, tdo);
  }
  return kErrUnsupported;
}

static_assert(FwdSmem<256>::kBytes <= 232448 && DqSmem<256>::kBytes <= 232448 && DkvSmem<256>::kBytes <= 232448,
              "shared memory per block");
static_assert(FwdSmem<192>::kBytes <= 232448 && DqSmem<192>::kBytes <= 232448 && DkvSmem<192>::kBytes <= 232448,
              "shared memory per block");
static_assert(FwdSmem<128>::kBytes <= 232448 && DqSmem<128>::kBytes <= 232448 && DkvSmem<128>::kBytes <= 232448,
              "shared memory per block");

template <int H>
int dispatch(Which w, const Args& a, cudaStream_t stream) {
  return a.cap > 0.f ? dispatch_cap<H, true>(w, a, stream) : dispatch_cap<H, false>(w, a, stream);
}

int run(Which w, const Args& a, int H, void* stream_ptr) {
  if (a.B < 1 || a.Sq < 1 || a.Sk < 1 || a.Nkv < 1 || a.N % a.Nkv != 0) return kErrUnsupported;
  if (int rc = bind_primary_context()) return rc;  // before the tensor maps' driver calls
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  switch (H) {
    case 64: return dispatch<64>(w, a, stream);
    case 128: return dispatch<128>(w, a, stream);
    case 192: return dispatch<192>(w, a, stream);
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
// take or a tensor map the driver refused. window <= 0 means no window,
// cap <= 0 no soft cap; seg_q/seg_kv may be null. q, k, v and dout must
// start on a 16-byte boundary (TMA).

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
  if (code == kErrTensorMap) return "cuTensorMapEncodeTiled refused a tensor map (or the driver lacks it)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
