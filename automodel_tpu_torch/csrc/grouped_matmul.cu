// Grouped matmul for the MoE experts: gmm (and gmm with a transposed rhs)
// and the transposed grouped matmul tgmm of its backward; and the two
// products of the fused expert MLP's forward, which are gmm with another
// epilogue.
//
// Replaces the Pallas TPU kernels of automodel_tpu/ops/grouped_matmul.py:
// _gmm_kernel (:155, through _gmm :175, both layouts of rhs) and
// _tgmm_kernel (:230, through _tgmm :247); with gmm_act_kernel and
// gmm_bias_kernel, the fused expert MLP's forward kernel
// automodel_tpu/ops/fused_expert_mlp.py _kernel (:59, through _fwd :130),
// K3a; and tgmm_kernel<true> carries the weight grad of its _bwd_gu_kernel
// (:423, through _bwd_gu :465), K3b (fused_expert_mlp.cu has the rest).
//
// Function (the same as the JAX kernels, with one definition added):
// - gmm: lhs [M, K] bf16 with rows sorted by group, group g owning rows
//   [start_g, end_g) (a cumsum of group_sizes), rhs [G, K, N] bf16 (or
//   [G, N, K] under transpose_rhs, contracted on its last axis) ->
//   out[m, :] = lhs[m, :] @ rhs[g(m)] in bf16, fp32 accumulation. Rows at or
//   past sum(group_sizes) are written as zeros (the TPU kernel leaves them
//   uninitialised).
// - gmm_bias (K3a's down product): gmm plus a per-group row bias [G, N]
//   added to the fp32 sum before its one rounding: out = mid @ Wd + db.
// - gmm_act (K3a's gate_up product): mid [M, I] = act(lhs @ Wg + gb,
//   lhs @ Wu + ub) per row's group, gate_up [G, K, 2I] read in place (gate
//   in [..., :I]), gate_up_bias [G, 2I]; g and u stay in fp32, the bias is
//   added and the activation (expert_act.cuh) applied in fp32, and mid is
//   rounded once to bf16: the value the TPU kernel rounds mid to before its
//   down product (:107-108).
// - tgmm: lhs [M, K], dout [M, N] bf16 -> out[g] = lhs_g^T @ dout_g, [G, K, N]
//   in fp32 or bf16 (the same fp32 sum, rounded once); an empty group writes
//   zeros. The bf16 output is JAX's _grouped_matmul_bwd drhs.astype(rhs.dtype)
//   (:318-333) taken inside the kernel.
//
// What bounds them on an H100 at Qwen3-30B-A3B's MoE shapes (M = 32768 rows
// over 128 experts): bytes. Each group's rhs slab ([2048, 1536] bf16, 6 MB)
// serves only ~256 rows, ~130 flops per byte, under the ~295 where the
// tensor cores would be the limit; tgmm writes a [G, K, N] result, 87% of its
// bytes in fp32. At gpt-oss-20b's (M = 16384 over 32 experts, K = 2880) gmm,
// the fused expert MLP's two forward products and K3b's tgmm with a bf16 out
// are bound by operations. The least time is the larger of the operands and
// the output moved once over 3.35 TB/s and the products over 989 TFLOP/s.
//
// K3a keeps its two launches: the TPU kernel holds a [512, D] fp32 down
// accumulator in VMEM across its I chunks, which for one 128-row tile at
// D = 2880 is 1.47 MB, the shared memory of 8 SMs; mid's bf16 round trip
// through device memory (2 x 94 MB at gpt-oss-20b's widths, ~0.06 ms) costs
// ~3% of the call, and JAX rounds mid to bf16 before its down product
// anyway. Both launches run gmm's pipeline below unchanged but for the
// epilogue (and, for gmm_act, the rhs boxes).
//
// Design (Hopper: wgmma, TMA, mbarriers, warp specialisation, persistent):
// - Each CTA is 384 threads: warpgroup 0 is the producer (setmaxnreg 24;
//   one thread issues every TMA load), warpgroups 1 and 2 consume
//   (setmaxnreg 240), each owning 64 rows of the 128-row output tile. A ring
//   of stages in shared memory, each with a full and an empty mbarrier,
//   keeps the loads in flight across tile and item boundaries; every
//   consumer thread arrives on a stage's empty barrier (an arrival from one
//   thread for its warpgroup let a warp that skips the products run a ring
//   ahead of its siblings, and the kernel hung). Every product is
//   wgmma.mma_async m64nNk16 bf16 -> fp32 with both operands in
//   128-byte-swizzled shared memory. One CTA per SM walks a static list of
//   items (blockIdx.x, then every gridDim.x-th), so no work is handed out at
//   run time.
// - Tensor maps are built on the host per call (cuTensorMapEncodeTiled,
//   through cudaGetDriverEntryPoint: no -lcuda, after binding the device's
//   context to the calling thread) and passed as __grid_constant__. Reads
//   past M, K or N arrive as zeros; the K = N = 1000 case ends its last
//   boxes there.
// - gmm: the items are (work unit, n tile) pairs, a unit being one (group,
//   128-row tile) pair that overlaps, then the tail past sum(group_sizes)
//   (ops/grouped_matmul.py gmm_plan: int32 [4, W], W = ceil(M/128) + G + 1,
//   the groups' units in order), so the units of a group run at the same
//   time on neighbouring CTAs. Within a group the items go unit by unit
//   over the n tiles or, where the output is at least as wide as the
//   contraction (N >= K), n tile by n tile over the units (gmm_item; the
//   kernel finds a unit's group extent from the plan and the groups' ends).
//   Units past the plan's end close a CTA's walk at the first one. lhs
//   boxes are 128 rows x 64 k
//   from a 2-D map over [M, K]; rhs boxes come from a 3-D map over (N, K, G)
//   (MN-major B, through wgmma's transpose bit) or, under transpose_rhs,
//   over (K, N, G) (K-major B), read in place. A box may hold rows of a
//   neighbouring group: a row of the product depends on its own lhs row
//   only, and the epilogue stores only the unit's rows [row_lo, row_hi), so
//   a tile across a group boundary is written by two CTAs, each its own
//   rows. A consumer whose 64 rows hold none of the unit's skips the
//   products. A consumer frees a stage once its products are done (holding
//   it until the next stage's products were issued was slower: the loads,
//   not the products, bound the kernel on an H100). The epilogue passes each
//   warp's 8 rows at a time through a padded staging tile of its own and
//   stores them in 16-byte pieces, whole rows at a time (the accumulator's
//   4-byte pieces, stored directly, held the consumers far longer). The tail
//   unit loads nothing and writes zeros. The n tile is 256 columns (4
//   stages of 48 KB): a narrower N ends its boxes past N, which read as
//   zeros, and its stores stop at N.
// - gmm_act: the rhs tile's four 64-column boxes are two of the gate half
//   (columns n0, n0 + 64) and the same two of the up half, from two 3-D maps
//   over gate_up, a gate view (I, K, G) with rows 2I apart and an up view
//   based I columns on: a box that ends past I reads zeros, never the other
//   half's columns (I = 1000 ends its last boxes there). An item's 256
//   accumulator columns are then 128 gate and the same 128 up columns: in
//   the m64n256 accumulator a thread holds gate column c in n8-chunk c / 8
//   and up column c in chunk 16 + c / 8, so each thread adds the biases,
//   applies the activation and rounds once with no exchange, and the output
//   tile is 128 columns of mid. The activation costs ~40 fp32 operations
//   an element against the 2 x 2 x 2880 of its products.
// - gmm_bias: the bias row of the unit's group is added in the epilogue.
// - tgmm: the items are (group, k tile, n tile), 128 x 128 tiles of the
//   [K, N] slab, the groups taken largest first (an order the wrapper sorts
//   on the device; the host never reads the sizes), so under skew the long
//   contractions start first. Each item contracts its group's rows in
//   chunks of 64 that start at the group's first row: A is lhs^T, the lhs
//   chunk read MN-major through wgmma's transpose bit for A, B the dout
//   chunk, MN-major; one group of products stays in flight. Only the
//   group's last chunk can hold rows past its end (a neighbour's, or past
//   sum(group_sizes), which may hold anything): the consumers zero those
//   rows in both operands, fence the generic writes to the async proxy and
//   meet at a named barrier before the products read them. The epilogue
//   writes the accumulator, rounded to the output type, into a swizzled
//   staging tile per consumer and stores it with a TMA store
//   (cp.async.bulk.tensor, one bulk group), which runs on while the consumer
//   goes on to the next item; its staging tile is rewritten only after the
//   store has read it (wait_group.read). Stores past K or N are clipped by
//   the map. An empty group writes its zeros by the same path.
// - No atomics and no split over K or over rows: every output element is
//   one CTA's sum in a fixed order, so two launches give the same bits, and
//   tgmm's bf16 output is its fp32 output rounded to nearest even.

#include "hopper.cuh"
#include "expert_act.cuh"

namespace {

constexpr int kThreads = 384;    // producer warpgroup + two consumer warpgroups
constexpr int kConsumers = 256;  // threads arriving on an empty barrier: every consumer thread
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
static_assert(128 * kProducerRegs + kConsumers * kConsumerRegs <= 65536, "register split");
constexpr int kErrUnsupported = 100001;
constexpr int kErrTensorMap = 100002;
constexpr int kSmemLimit = 232448;  // shared memory a block can use on an H100
constexpr int kBoxBytes = 64 * 128;  // a 64-row box of 128-byte rows

__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
}
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
}

__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty, int stages) {
  for (int s = 0; s < stages; ++s) {
    mbar_init(&full[s], 1);  // the producer's arrive, with the loads' bytes
    mbar_init(&empty[s], kConsumers);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// -- gmm ---------------------------------------------------------------------

// the epilogues: gmm's plain store; gmm_bias's per-group row bias [G, N],
// added to the fp32 sum before the rounding; gmm_act's gate_up activation,
// the accumulator's 256 columns being 128 gate and the same 128 up columns
constexpr int kEpiStore = 0, kEpiRowBias = 1, kEpiGateUpAct = 2;

struct GmmArgs {
  const int* plan;  // [4, W]: group, m tile, first row, end row (G = the zero tail)
  const int* ends;  // [G] inclusive cumsum of group_sizes
  bf16* out;        // [M, N]
  int M, K, N, G, W;
  int n_major;       // a group's items n tile by n tile (gmm_item); needs ends
  const bf16* bias;  // kEpiRowBias: [G, N]; kEpiGateUpAct: [G, 2N], gate | up; or null
  Act act;           // kEpiGateUpAct's activation
};

constexpr int BK = 64;   // k values a stage: 128-byte rows, the 128-byte swizzle
constexpr int BN = 256;  // the n tile

// a stage: the lhs box (128 rows x BK k) and the rhs (BN/64 boxes of BK k x
// 64 n, or one of BN n x BK k), as many stages as shared memory holds
// beside each consumer warp's staging tile of 8 output rows (BN + 8 values
// a row: the padding puts the rows a warp writes at once in different banks)
struct GmmSmem {
  static constexpr int kA = 128 * BK * 2;
  static constexpr int kB = BN * BK * 2;
  static constexpr int kStage = kA + kB;
  static constexpr int kOutRow = BN + 8;
  static constexpr int kOutWarp = 8 * kOutRow * 2;
  static constexpr int kFree = kSmemLimit - 1024 - 16 * 16 - 8 * kOutWarp;
  static constexpr int kStages = kFree / kStage < 16 ? kFree / kStage : 16;
  static constexpr int kOut = kStages * kStage;
  static constexpr int kBars = kOut + 8 * kOutWarp;
  static constexpr int kBytes = kBars + 2 * kStages * 8 + 1024;  // + the alignment slack
};

// The unit and n tile (its first column n0, tiles `tile` columns wide) of
// an item, false once the walk is past the plan's end. A group's units u
// in [first, first + count) own the items
// [first * n_tiles, (first + count) * n_tiles): unit by unit, each over the
// n tiles, or under n_major n tile by n tile, each over the units. Unit by
// unit, a unit's items share its lhs rows; n tile by n tile, the group's
// units read its columns [n0, n0 + BN) at the same time. Which is faster
// was measured, not derived (grouped_matmul_gmm_n_major). The tail's units
// go one by one.
__device__ __forceinline__ bool gmm_item(const GmmArgs& a, int item, int n_tiles, int tile, int& unit, int& n0) {
  const int u = item / n_tiles;
  if (a.plan[2 * a.W + u] >= min(a.plan[3 * a.W + u], a.M)) return false;
  if (!a.n_major) {
    unit = u;
    n0 = (item - u * n_tiles) * tile;
    return true;
  }
  const int g = a.plan[u];
  int first = u, count = 1;
  if (g < a.G) {
    const int end = min(a.ends[g], a.M), start = g > 0 ? min(a.ends[g - 1], end) : 0;
    first = u - (a.plan[a.W + u] - start / 128);
    count = (end - 1) / 128 - start / 128 + 1;  // the group has a unit, so rows
  }
  const int j = item - first * n_tiles;
  unit = first + j % count;
  n0 = (j / count) * tile;
  return true;
}

// the plan's unit: its group, its tile's first row and its rows [lo, hi)
__device__ __forceinline__ void gmm_unit(const GmmArgs& a, int unit, int& g, int& m0, int& lo, int& hi) {
  lo = a.plan[2 * a.W + unit];
  hi = min(a.plan[3 * a.W + unit], a.M);
  g = a.plan[unit];
  m0 = a.plan[a.W + unit] * 128;
}

// The gmm pipeline with epilogue EPI; t_up is read only by kEpiGateUpAct,
// whose t_rhs is then the gate view.
template <bool TRANS, int EPI>
__device__ __forceinline__ void gmm_body(const GmmArgs& a, const CUtensorMap* t_lhs, const CUtensorMap* t_rhs,
                                         const CUtensorMap* t_up) {
  using L = GmmSmem;
  static_assert(L::kBytes <= kSmemLimit, "gmm shared memory");
  static_assert(!TRANS || EPI == kEpiStore, "the epilogues take an N-major rhs");
  constexpr int kStages = L::kStages;
  constexpr int TN = EPI == kEpiGateUpAct ? BN / 2 : BN;  // output columns of an item
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_base(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* empty = full + kStages;
  if (threadIdx.x == 0) init_ring(full, empty, kStages);
  __syncthreads();

  const int n_tiles = (a.N + TN - 1) / TN;
  const int n_k = (a.K + BK - 1) / BK;
  const int items = a.W * n_tiles;

  if (threadIdx.x < 128) {
    // -- producer: one thread loads each item's lhs and rhs boxes, k by k
    producer_regs();
    if (threadIdx.x != 0) return;
    int it = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      int unit, n0, g, m0, lo, hi;
      if (!gmm_item(a, item, n_tiles, TN, unit, n0)) break;
      gmm_unit(a, unit, g, m0, lo, hi);
      if (g >= a.G) continue;  // the zero tail: nothing to load
      for (int kt = 0; kt < n_k; ++kt, ++it) {
        const int st = it % kStages;
        if (it >= kStages) mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
        unsigned char* as = sm + st * L::kStage;
        bf16* bs = reinterpret_cast<bf16*>(as + L::kA);
        mbar_arrive_expect_tx(&full[st], L::kStage);
        tma_load_2d(as, t_lhs, &full[st], kt * BK, m0);
        if (TRANS) {
          tma_load_3d(bs, t_rhs, &full[st], kt * BK, n0, g);
        } else if (EPI == kEpiGateUpAct) {
          // gate columns [n0, n0 + 128) in boxes 0-1, the same up columns in 2-3
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            tma_load_3d(bs + c * BK * 64, t_rhs, &full[st], n0 + c * 64, kt * BK, g);
            tma_load_3d(bs + (2 + c) * BK * 64, t_up, &full[st], n0 + c * 64, kt * BK, g);
          }
        } else {
#pragma unroll
          for (int c = 0; c < BN / 64; ++c) tma_load_3d(bs + c * BK * 64, t_rhs, &full[st], n0 + c * 64, kt * BK, g);
        }
      }
    }
  } else {
    // -- consumers: 64 rows of the tile each
    consumer_regs();
    const int wg = threadIdx.x / 128 - 1, tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    bf16* stage_out = reinterpret_cast<bf16*>(sm + L::kOut + (wg * 4 + warp) * L::kOutWarp);
    float acc[BN / 2];
    int it = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      int unit, n0, g, m0, lo, hi;
      if (!gmm_item(a, item, n_tiles, TN, unit, n0)) break;
      gmm_unit(a, unit, g, m0, lo, hi);
      const int w0 = m0 + wg * 64;          // this consumer's first row
      const int r0 = w0 + warp * 16 + (lane >> 2);  // this thread's rows: r0 and r0 + 8
      const int c0 = n0 + 2 * (lane & 3);           // and columns c0 + 8j, c0 + 8j + 1
      if (g >= a.G) {  // the tail past sum(group_sizes): zeros
        const __nv_bfloat162 z = __floats2bfloat162_rn(0.f, 0.f);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + 8 * h;
          if (r < lo || r >= hi) continue;
          bf16* orow = a.out + static_cast<long long>(r) * a.N;
#pragma unroll
          for (int j = 0; j < TN / 8; ++j)
            if (c0 + 8 * j < a.N) *reinterpret_cast<__nv_bfloat162*>(orow + c0 + 8 * j) = z;
        }
        continue;
      }
      const bool active = w0 < hi && w0 + 64 > lo;  // uniform over the warpgroup
      zero(acc);
      for (int kt = 0; kt < n_k; ++kt, ++it) {
        const int st = it % kStages;
        mbar_wait(&full[st], (it / kStages) & 1);
        if (active) {
          const bf16* as = reinterpret_cast<const bf16*>(sm + st * L::kStage);
          const bf16* bs = as + L::kA / 2;
          fence_regs(acc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) {
            const uint64_t da = desc_k(as, 128, wg * 64, kk);
            if (TRANS)
              wgmma_ss_t<0, 0>(acc, da, desc_k(bs, BN, 0, kk), 1);
            else
              wgmma_ss_t<0, 1>(acc, da, desc_mn(bs, BK, 0, kk), 1);
          }
          wgmma_commit();
          // this stage's products done before it is freed: where the loads
          // bound the kernel, a stage held until the next one has arrived
          // costs more than the products' overlap gains
          wgmma_wait<0>();
          fence_regs(acc);
        }
        mbar_arrive(&empty[st]);
      }
      if (!active) continue;

      // only this unit's rows (a neighbouring unit may own the rest of the
      // tile), in two passes of the warp's 8 rows through its staging tile:
      // 4-byte writes in the accumulator's layout, then each row out in
      // 16-byte stores, a warp writing 512 contiguous bytes at a time
      const int r8 = lane >> 2;
      const bf16* brow = nullptr;  // the group's bias row (gate | up under kEpiGateUpAct)
      if (EPI != kEpiStore && a.bias != nullptr)
        brow = a.bias + static_cast<long long>(g) * (EPI == kEpiGateUpAct ? 2 : 1) * a.N;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int j = 0; j < TN / 8; ++j) {
          float x0 = acc[4 * j + 2 * h], x1 = acc[4 * j + 2 * h + 1];
          if constexpr (EPI != kEpiStore) {
            float2 b = make_float2(0.f, 0.f), bu = make_float2(0.f, 0.f);
            if (brow != nullptr && c0 + 8 * j < a.N) {  // N % 8 == 0: the pair lies inside
              b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(brow + c0 + 8 * j));
              if (EPI == kEpiGateUpAct)
                bu = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(brow + a.N + c0 + 8 * j));
            }
            if (EPI == kEpiRowBias) {
              x0 += b.x;
              x1 += b.y;
            } else {  // up column c0 + 8j sits in n8-chunk TN / 8 + j
              x0 = act_fwd(x0 + b.x, acc[4 * (TN / 8 + j) + 2 * h] + bu.x, a.act);
              x1 = act_fwd(x1 + b.y, acc[4 * (TN / 8 + j) + 2 * h + 1] + bu.y, a.act);
            }
          }
          *reinterpret_cast<__nv_bfloat162*>(stage_out + r8 * L::kOutRow + 8 * j + 2 * (lane & 3)) =
              __floats2bfloat162_rn(x0, x1);
        }
        __syncwarp();
        if constexpr (TN == BN) {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int r = w0 + warp * 16 + 8 * h + i;
            if (r < lo || r >= hi) continue;
            bf16* orow = a.out + static_cast<long long>(r) * a.N + n0;
#pragma unroll
            for (int c = 8 * lane; c < BN; c += 256)
              if (n0 + c < a.N)
                *reinterpret_cast<uint4*>(orow + c) = *reinterpret_cast<const uint4*>(stage_out + i * L::kOutRow + c);
          }
        } else {  // 128-column rows: two rows at a time, 16 lanes each
#pragma unroll
          for (int i0 = 0; i0 < 8; i0 += 2) {
            const int i = i0 + (lane >> 4), c = 8 * (lane & 15);
            const int r = w0 + warp * 16 + 8 * h + i;
            if (r < lo || r >= hi || n0 + c >= a.N) continue;
            *reinterpret_cast<uint4*>(a.out + static_cast<long long>(r) * a.N + n0 + c) =
                *reinterpret_cast<const uint4*>(stage_out + i * L::kOutRow + c);
          }
        }
        __syncwarp();
      }
    }
  }
}

template <bool TRANS>
__global__ void __launch_bounds__(kThreads, 1)
    gmm_kernel(const GmmArgs a, const __grid_constant__ CUtensorMap t_lhs, const __grid_constant__ CUtensorMap t_rhs) {
  gmm_body<TRANS, kEpiStore>(a, &t_lhs, &t_rhs, &t_rhs);
}

// K3a's down product: out = mid @ Wd + db
__global__ void __launch_bounds__(kThreads, 1)
    gmm_bias_kernel(const GmmArgs a, const __grid_constant__ CUtensorMap t_lhs,
                    const __grid_constant__ CUtensorMap t_rhs) {
  gmm_body<false, kEpiRowBias>(a, &t_lhs, &t_rhs, &t_rhs);
}

// K3a's gate_up product: mid = act(lhs @ Wg + gb, lhs @ Wu + ub)
__global__ void __launch_bounds__(kThreads, 1)
    gmm_act_kernel(const GmmArgs a, const __grid_constant__ CUtensorMap t_lhs,
                   const __grid_constant__ CUtensorMap t_gate, const __grid_constant__ CUtensorMap t_up) {
  gmm_body<false, kEpiGateUpAct>(a, &t_lhs, &t_gate, &t_up);
}

// -- tgmm --------------------------------------------------------------------

struct TgmmArgs {
  const int* ends;   // [G] inclusive cumsum of group_sizes
  const int* order;  // [G] the groups, largest first
  int M, K, N, G;
};

template <bool BF16_OUT>
struct TgmmSmem {
  static constexpr int kStages = BF16_OUT ? 6 : 5;
  static constexpr int kL = 2 * kBoxBytes;  // lhs chunk: 64 rows x 128 k, two boxes
  static constexpr int kD = 2 * kBoxBytes;  // dout chunk: 64 rows x 128 n, two boxes
  static constexpr int kStage = kL + kD;
  // a consumer's staging tile, 64 x 128 of the output: boxes of 64 rows x
  // 128 bytes (32 fp32 or 64 bf16 columns)
  static constexpr int kOutBoxes = BF16_OUT ? 2 : 4;
  static constexpr int kOutTile = kOutBoxes * kBoxBytes;
  static constexpr int kOut = kStages * kStage;
  static constexpr int kBars = kOut + 2 * kOutTile;
  static constexpr int kBytes = kBars + 2 * kStages * 8 + 1024;
};
static_assert(TgmmSmem<true>::kBytes <= kSmemLimit && TgmmSmem<false>::kBytes <= kSmemLimit,
              "tgmm shared memory");

// the group of an item and its rows [start, end)
__device__ __forceinline__ int tgmm_group(const TgmmArgs& a, int gi, int& start, int& end) {
  const int g = a.order[gi];
  end = min(a.ends[g], a.M);
  start = min(g > 0 ? a.ends[g - 1] : 0, end);
  return g;
}

template <bool BF16_OUT>
__global__ void __launch_bounds__(kThreads, 1)
    tgmm_kernel(const TgmmArgs a, const __grid_constant__ CUtensorMap t_lhs, const __grid_constant__ CUtensorMap t_dout,
                const __grid_constant__ CUtensorMap t_out) {
  using L = TgmmSmem<BF16_OUT>;
  constexpr int kStages = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_base(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* empty = full + kStages;
  if (threadIdx.x == 0) init_ring(full, empty, kStages);
  __syncthreads();

  const int n_tiles = (a.N + 127) / 128;
  const int per_group = ((a.K + 127) / 128) * n_tiles;
  const int items = a.G * per_group;

  if (threadIdx.x < 128) {
    // -- producer: one thread loads each item's chunks of lhs and dout rows
    producer_regs();
    if (threadIdx.x != 0) return;
    int it = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int gi = item / per_group, rest = item - gi * per_group;
      const int k0 = (rest / n_tiles) * 128, n0 = (rest % n_tiles) * 128;
      int start, end;
      tgmm_group(a, gi, start, end);
      for (int r = start; r < end; r += 64, ++it) {
        const int st = it % kStages;
        if (it >= kStages) mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
        unsigned char* ls = sm + st * L::kStage;
        unsigned char* ds = ls + L::kL;
        mbar_arrive_expect_tx(&full[st], L::kStage);
        tma_load_2d(ls, &t_lhs, &full[st], k0, r);
        tma_load_2d(ls + kBoxBytes, &t_lhs, &full[st], k0 + 64, r);
        tma_load_2d(ds, &t_dout, &full[st], n0, r);
        tma_load_2d(ds + kBoxBytes, &t_dout, &full[st], n0 + 64, r);
      }
    }
  } else {
    // -- consumers: 64 k rows of the 128 x 128 slab tile each
    consumer_regs();
    const int wg = threadIdx.x / 128 - 1, tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    unsigned char* stage_out = sm + L::kOut + wg * L::kOutTile;
    float acc[64];
    int it = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int gi = item / per_group, rest = item - gi * per_group;
      const int k0 = (rest / n_tiles) * 128, n0 = (rest % n_tiles) * 128;
      int start, end;
      const int g = tgmm_group(a, gi, start, end);
      zero(acc);
      int prev = 0;
      for (int r = start; r < end; r += 64, ++it) {
        const int st = it % kStages;
        mbar_wait(&full[st], (it / kStages) & 1);
        unsigned char* ls = sm + st * L::kStage;
        const int valid = end - r;
        if (valid < 64) {
          // the group's last chunk: its rows from `valid` on belong to
          // another group or lie past the groups, so zero them in all four
          // boxes (whole 128-byte rows: the swizzle permutes within a row)
          const int first = valid * 128 / 16, per_box = kBoxBytes / 16;
          for (int i = threadIdx.x - 128; i < 4 * (per_box - first); i += kConsumers) {
            const int box = i / (per_box - first), off = first + i % (per_box - first);
            reinterpret_cast<uint4*>(ls + box * kBoxBytes)[off] = make_uint4(0, 0, 0, 0);
          }
          fence_proxy_async();
          named_barrier(1, kConsumers);
        }
        const bf16* lsb = reinterpret_cast<const bf16*>(ls);
        const bf16* dsb = lsb + L::kL / 2;
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) wgmma_ss_t<1, 1>(acc, desc_mn(lsb, 64, wg, kc), desc_mn(dsb, 64, 0, kc), 1);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(acc);
        if (r > start) mbar_arrive(&empty[prev]);
        prev = st;
      }
      wgmma_wait<0>();  // also where no chunk ran: ptxas then sees no product in flight
      fence_regs(acc);
      if (end > start) mbar_arrive(&empty[prev]);

      // the epilogue: the staging tile is free once the previous store has read it
      if (tid == 0) bulk_wait_read<0>();
      named_barrier(2 + wg, 128);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = warp * 16 + (lane >> 2) + 8 * h;
          const float x0 = acc[4 * j + 2 * h], x1 = acc[4 * j + 2 * h + 1];
          if (BF16_OUT) {  // box j / 8, 16-byte chunk j % 8 of the row, swizzled
            unsigned char* p = stage_out + (j >> 3) * kBoxBytes + row * 128 + (((j & 7) ^ (row & 7)) << 4) +
                               (lane & 3) * 4;
            *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
          } else {  // box j / 4, 16-byte chunk 2 (j % 4) + (lane % 4) / 2, swizzled
            const int chunk = 2 * (j & 3) + ((lane & 3) >> 1);
            unsigned char* p = stage_out + (j >> 2) * kBoxBytes + row * 128 + ((chunk ^ (row & 7)) << 4) +
                               (lane & 1) * 8;
            *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
          }
        }
      }
      fence_proxy_async();
      named_barrier(2 + wg, 128);
      if (tid == 0) {
        constexpr int kCols = BF16_OUT ? 64 : 32;  // columns of a box
#pragma unroll
        for (int b = 0; b < L::kOutBoxes; ++b)
          tma_store_3d(&t_out, stage_out + b * kBoxBytes, n0 + b * kCols, k0 + wg * 64, g);
        bulk_commit();
      }
    }
    if (tid == 0) bulk_wait<0>();
  }
}

// -- launch ------------------------------------------------------------------

// a tensor map over a row-major tensor of `rank` dims (innermost first),
// boxes `box` of 128-byte rows, 128-byte swizzle, reads past the bounds as
// zeros; `row_strides` (bytes, rank - 1 of them) give a view's strides,
// null a contiguous tensor's
int tensor_map(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes, const void* base, int rank,
               const long long* dims, const int* box, const long long* row_strides = nullptr) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return kErrTensorMap;
  cuuint64_t d[3], strides[2];
  cuuint32_t b[3], unit[3] = {1, 1, 1};
  cuuint64_t stride = static_cast<cuuint64_t>(elem_bytes);
  for (int i = 0; i < rank; ++i) {
    d[i] = static_cast<cuuint64_t>(dims[i]);
    b[i] = static_cast<cuuint32_t>(box[i]);
    if (i > 0) strides[i - 1] = row_strides ? static_cast<cuuint64_t>(row_strides[i - 1]) : stride;
    stride *= d[i];
  }
  CUresult r = fn(map, type, rank, const_cast<void*>(base), d, strides, b, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap;
}

// one CTA per SM, no more than there are items
int persistent_grid(int items) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    sms = 132;
  return max(1, min(items, sms));
}

template <typename Kernel, typename A, typename... Maps>
int launch(Kernel kernel, int grid, int smem, cudaStream_t stream, const A& a, const Maps&... maps) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, kThreads, smem, stream>>>(a, maps...);
  return static_cast<int>(cudaGetLastError());
}

bool shape_ok(int M, int K, int N, int G) {
  return M >= 1 && K >= 8 && N >= 8 && G >= 1 && K % 8 == 0 && N % 8 == 0;
}

template <bool TRANS>
int gmm_launch(const GmmArgs& a, const void* lhs, const void* rhs, cudaStream_t stream) {
  if (int rc = bind_primary_context()) return rc;
  CUtensorMap t_lhs, t_rhs;
  const long long lhs_dims[2] = {a.K, a.M};
  const int lhs_box[2] = {BK, 128};
  const long long rhs_dims[3] = {TRANS ? a.K : a.N, TRANS ? a.N : a.K, a.G};
  const int rhs_box[3] = {TRANS ? BK : 64, TRANS ? BN : BK, 1};
  int rc;
  if ((rc = tensor_map(&t_lhs, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, lhs, 2, lhs_dims, lhs_box)) ||
      (rc = tensor_map(&t_rhs, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, rhs, 3, rhs_dims, rhs_box)))
    return rc;
  const int items = a.W * ((a.N + BN - 1) / BN);
  return launch(gmm_kernel<TRANS>, persistent_grid(items), GmmSmem::kBytes, stream, a, t_lhs, t_rhs);
}

// K3a's launches: gmm_bias over a contiguous rhs [G, K, N]; gmm_act over
// gate_up [G, K, 2N] through its gate and up views (N = I columns each,
// rows 2N apart; the up view's base is 16-byte aligned since N % 8 == 0)
template <int EPI>
int gmm_epilogue_launch(const GmmArgs& a, const void* lhs, const void* rhs, cudaStream_t stream) {
  if (int rc = bind_primary_context()) return rc;
  CUtensorMap t_lhs, t_rhs, t_up;
  const long long lhs_dims[2] = {a.K, a.M};
  const int lhs_box[2] = {BK, 128};
  const long long rhs_dims[3] = {a.N, a.K, a.G};
  const int rhs_box[3] = {64, BK, 1};
  int rc;
  if ((rc = tensor_map(&t_lhs, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, lhs, 2, lhs_dims, lhs_box))) return rc;
  if (EPI == kEpiRowBias) {
    if ((rc = tensor_map(&t_rhs, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, rhs, 3, rhs_dims, rhs_box))) return rc;
    const int items = a.W * ((a.N + BN - 1) / BN);
    return launch(gmm_bias_kernel, persistent_grid(items), GmmSmem::kBytes, stream, a, t_lhs, t_rhs);
  }
  const long long strides[2] = {2LL * a.N * 2, 2LL * a.N * a.K * 2};
  if ((rc = tensor_map(&t_rhs, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, rhs, 3, rhs_dims, rhs_box, strides)) ||
      (rc = tensor_map(&t_up, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, static_cast<const bf16*>(rhs) + a.N, 3, rhs_dims,
                       rhs_box, strides)))
    return rc;
  const int items = a.W * ((a.N + BN / 2 - 1) / (BN / 2));
  return launch(gmm_act_kernel, persistent_grid(items), GmmSmem::kBytes, stream, a, t_lhs, t_rhs, t_up);
}

template <bool BF16_OUT>
int tgmm_launch(const TgmmArgs& a, const void* lhs, const void* dout, void* out, cudaStream_t stream) {
  if (int rc = bind_primary_context()) return rc;
  CUtensorMap t_lhs, t_dout, t_out;
  const long long lhs_dims[2] = {a.K, a.M}, dout_dims[2] = {a.N, a.M}, out_dims[3] = {a.N, a.K, a.G};
  const int in_box[2] = {64, 64};
  const int out_box[3] = {BF16_OUT ? 64 : 32, 64, 1};
  int rc;
  if ((rc = tensor_map(&t_lhs, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, lhs, 2, lhs_dims, in_box)) ||
      (rc = tensor_map(&t_dout, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, dout, 2, dout_dims, in_box)) ||
      (rc = tensor_map(&t_out, BF16_OUT ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                       BF16_OUT ? 2 : 4, out, 3, out_dims, out_box)))
    return rc;
  const int items = a.G * ((a.K + 127) / 128) * ((a.N + 127) / 128);
  return launch(tgmm_kernel<BF16_OUT>, persistent_grid(items), TgmmSmem<BF16_OUT>::kBytes, stream, a, t_lhs,
                t_dout, t_out);
}

}  // namespace

extern "C" {

// Each launches on `stream`, allocates nothing and returns cudaGetLastError()
// after the launch (0 = launched), or an error code for a shape it does not
// take (K or N not a multiple of 8, an unknown act_kind) or a tensor map
// cuTensorMapEncodeTiled refused. Every tensor must start on a 16-byte
// boundary (TMA).

// The order of a group's items the wrapper gives gmm: n tile by n tile (1)
// where the output is at least as wide as the contraction, else unit by unit
// (0). Fitted to readings, not derived: on an H100 it picked the faster
// order at five of the six launches chip_smoke.py times both ways.
int grouped_matmul_gmm_n_major(int K, int N) { return N >= K; }

// plan: int32 [4, W] from ops/grouped_matmul.py gmm_plan with tile 128 and
// W = ceil(M / 128) + G + 1; n_major: 1 a group's items n tile by n tile,
// 0 unit by unit; ends: int32 [G], the inclusive cumsum of group_sizes,
// read only under n_major (may be null otherwise)
int grouped_matmul_gmm(const void* lhs, const void* rhs, const int* plan, const int* ends, void* out, int M, int K,
                       int N, int G, int W, int transpose_rhs, int n_major, void* stream) {
  if (!shape_ok(M, K, N, G) || W < 1 || (n_major && !ends)) return kErrUnsupported;
  GmmArgs a = {plan, ends, static_cast<bf16*>(out), M, K, N, G, W, n_major != 0};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return transpose_rhs ? gmm_launch<true>(a, lhs, rhs, s) : gmm_launch<false>(a, lhs, rhs, s);
}

// K3a's first launch: mid [M, I] bf16 = act(lhs @ Wg + gb, lhs @ Wu + ub)
// per row's group, g and u in fp32 and mid rounded once, rows past
// sum(group_sizes) zeros; lhs [M, D], gate_up [G, D, 2I] (gate in
// [..., :I]) read in place, gate_up_bias [G, 2I] or null. act_kind: 0
// swiglu, 1 swiglu_oai; limit > 0 clamps swiglu (ignored for swiglu_oai).
// plan, ends and n_major as for grouped_matmul_gmm (the order of a group's
// 128-column n tiles over its units).
int grouped_matmul_gmm_act(const void* lhs, const void* gate_up, const void* gate_up_bias, const int* plan,
                           const int* ends, void* mid, int M, int D, int I, int G, int W, int n_major, int act_kind,
                           float limit, void* stream) {
  if (!shape_ok(M, D, I, G) || W < 1 || (n_major && !ends) || (act_kind != 0 && act_kind != 1))
    return kErrUnsupported;
  GmmArgs a = {plan, ends, static_cast<bf16*>(mid), M, D, I, G, W, n_major != 0,
               static_cast<const bf16*>(gate_up_bias), make_act(act_kind, limit)};
  return gmm_epilogue_launch<kEpiGateUpAct>(a, lhs, gate_up, reinterpret_cast<cudaStream_t>(stream));
}

// K3a's second launch: out [M, N] bf16 = lhs @ rhs[g] + bias[g] per row's
// group, the bias [G, N] (or null) added to the fp32 sum before the
// rounding, rows past sum(group_sizes) zeros; arguments as for
// grouped_matmul_gmm with an N-major rhs [G, K, N]
int grouped_matmul_gmm_bias(const void* lhs, const void* rhs, const void* bias, const int* plan, const int* ends,
                            void* out, int M, int K, int N, int G, int W, int n_major, void* stream) {
  if (!shape_ok(M, K, N, G) || W < 1 || (n_major && !ends)) return kErrUnsupported;
  GmmArgs a = {plan, ends, static_cast<bf16*>(out), M, K, N, G, W, n_major != 0, static_cast<const bf16*>(bias),
               Act{0, 0.f}};
  return gmm_epilogue_launch<kEpiRowBias>(a, lhs, rhs, reinterpret_cast<cudaStream_t>(stream));
}

// ends: int32 [G], the inclusive cumsum of group_sizes; order: int32 [G],
// every group once, largest first; out [G, K, N] fp32 (out_bf16 = 0) or bf16
int grouped_matmul_tgmm(const void* lhs, const void* dout, const int* ends, const int* order, void* out, int M,
                        int K, int N, int G, int out_bf16, void* stream) {
  if (!shape_ok(M, K, N, G)) return kErrUnsupported;
  TgmmArgs a = {ends, order, M, K, N, G};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return out_bf16 ? tgmm_launch<true>(a, lhs, dout, out, s) : tgmm_launch<false>(a, lhs, dout, out, s);
}

const char* grouped_matmul_error_string(int code) {
  if (code == kErrUnsupported) return "shape not supported by the grouped-matmul kernels";
  if (code == kErrTensorMap) return "cuTensorMapEncodeTiled refused a tensor map (or the driver lacks it)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
