// Paged attention for decode and verify, in place over the KV block pool.
//
// Replaces the Pallas TPU kernel automodel_tpu/ops/paged_attention.py
// (_paged_kernel :97, reached through paged_attend :175). Same function:
// q [B, Sq, N, H] bf16, scaled here by bf16(scale) and rounded to bf16 as
// the plain version scales it, attends one layer's pool [NB, BS, Nkv, H]
// (bf16, or int8 with fp32 row scales [NB, BS, Nkv]) through per-sequence
// block tables [B, NBseq] int32 and lengths [B] int32. Query row qi sits at
// absolute position length + qi and attends pos <= length + qi (and
// length + qi - pos < window under a sliding window); logits pass the soft
// cap before masking; softmax is fp32 and a row that attends nothing writes
// zeros. Out: [B, Sq, N, H] bf16. Only live blocks are read: from the
// window's first block to (length + Sq - 1) / BS. Any Sq * rep query rows a
// kv head are taken (row r is query position r / rep, head g * rep + r % rep).
//
// What bounds it on an H100: device-memory bytes. The live KV is read once
// and each bf16 KV byte meets 4 flops at Sq*rep = 4 query rows (8 for
// int8), far under the ~295 flops a byte where the tensor cores would set
// the pace. The least time is the live KV bytes over 3.35 TB/s, so the
// design is about moving those bytes once, at full rate, on every SM. (A
// plain torch read of 268 MB runs at ~2.8 TB/s on the card, and so does
// this kernel at long bf16 contexts; the short and ragged cases lose the
// rest to each CTA's start, the dead chunks, the partials and the merge,
// and int8 to the instructions a byte; PERF.md section 6.)
//
// Row tiles. A CTA takes at most kTileRows = 32 of a kv head's query rows:
// the grid's x axis is (row tile, kv head), kv head fastest, so a verify
// chunk of Sq * rep > 32 rows (Qwen3-30B-A3B's 8 heads a kv head at Sq = 5:
// 40 rows) runs ceil(rows / 32) tiles of the same instantiations, each
// reading the same live blocks, and the last tile pads its rows as a short
// chunk always has. Each tile reads the KV again: at 40 rows the kernel
// reads it twice where the bound reads it once (PERF.md section 6). The
// partials index rows over the whole Sq * rep, so only the merge counter is
// per tile.
//
// Split-KV (flash-decoding). The grid is (tiles * Nkv, B, splits), sized from
// what the host knows without reading lengths: splits = ceil(NBseq / CB)
// chunks of CB blocks at fixed offsets (chunk s holds blocks [s*CB,
// s*CB + CB)). A CTA whose chunk misses its sequence's live blocks exits at
// once; the split index is the slowest, so the live chunks start first and
// the dead ones retire in the tail.
// The split rule (ops/paged_attention.py chunk_blocks, the one place it is
// written): CB = 32 blocks (512 tokens) while B * Nkv * ceil(NBseq / CB)
// still gives every SM a CTA when every table is full, else 16, 8, 4. A
// CTA costs a start (the length and table, then the first blocks' full
// latency), a partial and a share of the merge, so fewer, longer chunks
// won on the card at every shape measured as long as the longest sequence
// still spreads over the SMs: the ragged 1-4096 case at B = 16, Nkv = 8
// gives ~600 live CTAs of at most 512 tokens, a lone 4096 context 136 of
// 256 (PERF.md section 6).
//
// The merge, deterministic and in the same launch. A sequence whose live
// blocks fall in one chunk writes its output directly. Otherwise each live
// CTA writes its rows' fp32 partials (row max in log2 units, row sum,
// unnormalised accumulator) to scratch the wrapper allocates, then bumps
// the (sequence, kv head, row tile)'s counter; the CTA that brings it to the number
// of live chunks reads every partial in split order, writes the output
// and puts the counter back to 0, so the wrapper's cached counter buffer
// is zeroed only once. Which CTA merges changes from run to run; the sum
// it takes, in split order, does not: repeats are bit-identical. A split
// whose rows saw nothing contributes weight 0; a row no split saw writes
// zeros.
//
// Inside a CTA: 4 warps. Each worker (one warp, or two sharing the KV
// when the CTA's padded query rows reach 24-32) owns a ring of NS slots of
// one 16-token block each (K rows, V rows, the int8 row scales), filled by
// cp.async 16 bytes a lane, rows padded by 16 bytes so ldmatrix's eight
// rows hit distinct banks, and takes every fourth (or second) block of the
// chunk: NS - 1 blocks stay in flight per worker while it computes one.
// NS is what 16 KB of slots a worker holds (2 at bf16 H = 128, 3 at int8):
// 3 CTAs an SM at H = 128 either way (set by these slots and the
// registers ptxas reports, which chip_smoke.py prints),
// ~100 KB of KV in flight per SM. More stages and fewer CTAs measured
// slower on the card: int8 issues ~500 instructions a block (a count of
// this code), and more warps hide them better than more bytes in flight.
// A lane's copy addresses are fixed offsets from the block's, a block
// that every query row sees whole skips the mask, and the accumulator is
// rescaled only when some row's max moved. The length and the chunk's
// slice of the block table are read together, once, into shared memory
// before the loop, and the first blocks' copies are issued before the
// query tile is read, so no copy waits on a dependent load of the table
// and the CTA's start costs one latency less.
//
// The products run on the tensor cores (mma.sync m16n8k16, bf16 in, fp32
// sums), with the 16 tokens of a block as M and the worker's query rows
// (Sq*rep, padded to 8 or 16 a warp) as N: S^T = K . Q^T over the head
// dim, then O^T += V^T . P^T over the block's tokens. P^T comes from S^T's
// accumulator by one movmatrix (8x8 transpose) per 8 tokens. P is rounded
// to bf16 before P.V, as the flash kernels round it; the row sums stay
// fp32. int8 K and V go through the same bf16 products: int8 -> bf16 is
// exact for |v| <= 127 (two lanes at a time: 128 + (v & 127) minus 128 or
// 256 in bf16x2), ldmatrix reads the int8 rows as they landed, the query's
// head dims are permuted within each 16 to match the bytes a lane holds,
// the K row scales multiply the scores and the V row scales P, as before.
// The online softmax keeps one max per row across the 8 lanes that share
// it (3 shuffles a block) and sums each lane's own tokens, reduced once at
// the end; the 4 workers' rows merge in shared memory in worker order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kBS = 16;  // tokens a block: the serving configs' block size
constexpr int kThreads = 128;
constexpr int kMaxChunk = 32;  // blocks a chunk, at most
constexpr int kTileRows = 32;  // query rows a CTA takes, at most (a row tile)
constexpr int kErrUnsupported = 100001;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void cp_async16(void* smem_ptr, const void* gmem_ptr) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(smem_ptr)), "l"(gmem_ptr) : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem_ptr, const void* gmem_ptr) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(smem_ptr)), "l"(gmem_ptr) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// d[16 x 8] += A[16 x 16] . B[16 x 8], bf16 in, fp32 sums
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the transpose of an 8x8 b16 matrix held one row pair a lane
__device__ __forceinline__ uint32_t movmatrix_t(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// 2^x, one MUFU instruction (2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// bytes B0 and B1 of w, two int8 values, as bf16x2, exactly: with b the
// byte, 128 + (b & 127) minus 128 (b >= 0) or 256 (b < 0), all in bf16
template <int B0, int B1>
__device__ __forceinline__ uint32_t i8x2_bf16x2(uint32_t w) {
  const uint32_t x = __byte_perm(w, 0u, B0 | (4 << 4) | (B1 << 8) | (4 << 12));
  uint32_t hi = (x & 0x007F007Fu) | 0x43004300u;
  uint32_t sub = (x & 0x00800080u) | 0x43004300u;
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&hi), *reinterpret_cast<__nv_bfloat162*>(&sub));
  return *reinterpret_cast<uint32_t*>(&r);
}

// two bf16 values times sc, rounded to bf16: bf16(float(q) * float(bf16(scale)))
// is what the plain version's eager bf16 multiply gives
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t w, float sc) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w));
  return pack_bf16x2(f.x * sc, f.y * sc);
}

// the pool's element type: int8 (QUANT = 1) or bf16
template <int QUANT>
using KVOf = typename std::conditional<QUANT != 0, int8_t, __nv_bfloat16>::type;

template <int QUANT, int H>
struct Geo {
  using KV = KVOf<QUANT>;
  static constexpr bool kQuant = QUANT != 0;
  static constexpr int kRow = H * static_cast<int>(sizeof(KV));  // bytes of a token row
  static constexpr int kPitch = kRow + 16;                        // padded shared row
  static constexpr int kSide = kBS * kPitch;
  static constexpr int kSlot = 2 * kSide + (kQuant ? 2 * kBS * 4 : 0);  // K rows, V rows, [k | v scales]
  static constexpr int kStagesRaw = 16384 / kSlot;
  static constexpr int kStages = kStagesRaw < 2 ? 2 : (kStagesRaw > 5 ? 5 : kStagesRaw);
  static constexpr int kQPitch = 2 * H + 16;  // bytes of a query row in shared memory
  static constexpr int kOPitch = H + 4;       // floats of a merge row
};

template <int QUANT, int H, int NTW, int WR>
struct Smem {
  using G = Geo<QUANT, H>;
  static constexpr int kWorkers = 4 / WR;
  static constexpr int kRowsPad = 8 * NTW * WR;
  static constexpr int kRing = kWorkers * G::kStages * G::kSlot;
  static constexpr int kMerge = kWorkers * kRowsPad * (G::kOPitch + 2) * 4;
  static constexpr int kFirst = ((kRing > kMerge ? kRing : kMerge) + 127) / 128 * 128;
  static constexpr int kQ = kFirst;                                // query tile
  static constexpr int kTable = kQ + kRowsPad * G::kQPitch;       // the chunk's table slice
  static constexpr int kFlag = kTable + kMaxChunk * 4;
  static constexpr int kBytes = kFlag + 16;
};

// out[b, qi, head, c4 * 4 .. + 4) = o / l in bf16 (zeros where l = 0)
__device__ __forceinline__ void store_out(__nv_bfloat16* out, size_t at, float4 o, float l) {
  const float inv = l > 0.f ? 1.f / fmaxf(l, 1e-30f) : 0.f;
  uint2 w;
  w.x = pack_bf16x2(l > 0.f ? o.x * inv : 0.f, l > 0.f ? o.y * inv : 0.f);
  w.y = pack_bf16x2(l > 0.f ? o.z * inv : 0.f, l > 0.f ? o.w * inv : 0.f);
  *reinterpret_cast<uint2*>(out + at) = w;
}

template <int QUANT, int H, int NTW, int WR>
__global__ void __launch_bounds__(kThreads, 2) paged_attention_kernel(
    const __nv_bfloat16* __restrict__ q, const KVOf<QUANT>* __restrict__ k_pool,
    const KVOf<QUANT>* __restrict__ v_pool,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale, const int* __restrict__ tables,
    const int* __restrict__ lengths, __nv_bfloat16* __restrict__ out, float* __restrict__ part,
    int* __restrict__ counters, int Sq, int N, int Nkv, int NBseq, int cb, int window, float soft_cap,
    float scale) {
  using KV = KVOf<QUANT>;
  using G = Geo<QUANT, H>;
  using S = Smem<QUANT, H, NTW, WR>;
  constexpr bool kQuant = G::kQuant;
  constexpr int WB = S::kWorkers;
  constexpr int RP = S::kRowsPad;
  constexpr int NS = G::kStages;
  constexpr int WT = WR * 32;  // threads of a worker
  constexpr int MT = H / 16;   // 16-dim tiles of the head

  const int g = blockIdx.x % Nkv, tile = blockIdx.x / Nkv, b = blockIdx.y, s = blockIdx.z;
  const int n_splits = gridDim.z, n_tiles = gridDim.x / Nkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int worker = warp / WR, wr = warp % WR;
  const int rep = N / Nkv, rows = Sq * rep;  // every query row of the kv head
  // this CTA's rows: r0 .. r0 + tr - 1 of them (local row r is row r0 + r)
  const int r0 = tile * kTileRows;
  const int tr = rows - r0 < kTileRows ? rows - r0 : kTileRows;
  const int r4 = lane >> 2, q4 = lane & 3;  // fragment row group and column pair

  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* q_s = smem + S::kQ;
  int* tbl_s = reinterpret_cast<int*>(smem + S::kTable);
  int* flag_s = reinterpret_cast<int*>(smem + S::kFlag);

  // the chunk's table entries are fetched while the live range is worked
  // out: entries outside it are read, never followed
  const int j0 = s * cb;
  int tv = 0;
  if (tid < cb && j0 + tid < NBseq) tv = tables[static_cast<size_t>(b) * NBseq + j0 + tid];
  const int length = lengths[b];
  int j_hi = (length + Sq - 1) / kBS;
  if (j_hi > NBseq - 1) j_hi = NBseq - 1;
  int j_lo = 0;
  if (window > 0 && length - window + 1 > 0) j_lo = (length - window + 1) / kBS;
  const size_t out_row0 = static_cast<size_t>(b) * Sq * N;

  if (j_lo > j_hi) {  // no live block at all: chunk 0 writes the zeros
    if (s == 0) {
      for (int idx = tid; idx < tr * (H / 4); idx += kThreads) {
        const int r = r0 + idx / (H / 4), c4 = idx % (H / 4);
        const size_t at = (out_row0 + static_cast<size_t>(r / rep) * N + g * rep + r % rep) * H + c4 * 4;
        store_out(out, at, make_float4(0.f, 0.f, 0.f, 0.f), 0.f);
      }
    }
    return;
  }
  const int c_lo = j0 > j_lo ? j0 : j_lo;
  const int c_hi = j0 + cb - 1 < j_hi ? j0 + cb - 1 : j_hi;
  if (c_lo > c_hi) return;  // a dead chunk: nothing to read or write
  const int s_lo = j_lo / cb, s_hi = j_hi / cb;
  const bool single = s_lo == s_hi;

  if (tid < cb) tbl_s[tid] = tv;
  __syncthreads();  // the table slice in place

  // this worker's blocks: c_lo + worker, + WB, ... up to c_hi
  const int first = c_lo + worker;
  const int n_mine = first <= c_hi ? (c_hi - first) / WB + 1 : 0;
  unsigned char* ring = smem + worker * NS * G::kSlot;
  const int wt = wr * 32 + lane;

  // a lane's share of every block's copies: 16-byte piece w0 of token rows
  // t0, t0 + TS, ... of K, then of V; only the block's offset changes
  constexpr int kChunks = G::kRow / 16;  // 16-byte pieces of a token row
  constexpr int TS = WT / kChunks;       // token rows one pass of the worker covers
  const int w0 = wt % kChunks, t0 = wt / kChunks;
  const size_t row_stride = static_cast<size_t>(Nkv) * G::kRow;  // bytes from one token row to the next
  const size_t lane_off = static_cast<size_t>(g) * G::kRow + t0 * row_stride + w0 * 16;
  const unsigned char* k_lane = reinterpret_cast<const unsigned char*>(k_pool) + lane_off;
  const unsigned char* v_lane = reinterpret_cast<const unsigned char*>(v_pool) + lane_off;

  auto issue = [&](int i) {
    if (i < n_mine) {
      const int j = first + i * WB;
      const size_t blk_off = static_cast<size_t>(tbl_s[j - j0]) * kBS * row_stride;
      unsigned char* slot = ring + (i % NS) * G::kSlot;
      unsigned char* dst = slot + t0 * G::kPitch + w0 * 16;
#pragma unroll
      for (int k = 0; k < 2 * kBS / TS; ++k) {
        const int side = k * TS / kBS, t = k * TS % kBS;
        cp_async16(dst + side * G::kSide + t * G::kPitch, (side ? v_lane : k_lane) + blk_off + t * row_stride);
      }
      if (kQuant && wt < 2 * kBS) {
        const int side = wt / kBS, t = wt % kBS;
        const size_t blk = static_cast<size_t>(tbl_s[j - j0]);
        cp_async4(slot + 2 * G::kSide + wt * 4, (side ? v_scale : k_scale) + (blk * kBS + t) * Nkv + g);
      }
    }
    cp_async_commit();  // one group per block slot, empty past the end
  };
  // the first blocks' copies start before the query tile is read
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) issue(i);

  // the query tile: RP rows (local row r is row r0 + r = qi * rep + head
  // offset), rows past the tile's `tr` zero
  {
    const float sc = __bfloat162float(__float2bfloat16(scale));
    for (int idx = tid; idx < RP * (H / 16); idx += kThreads) {
      const int r = idx / (H / 16), grp = idx % (H / 16);
      uint32_t w[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) w[i] = 0u;
      if (r < tr) {
        const int ra = r0 + r;
        const uint4* src = reinterpret_cast<const uint4*>(
            q + (out_row0 + static_cast<size_t>(ra / rep) * N + g * rep + ra % rep) * H + grp * 16);
        const uint4 a = src[0], c = src[1];
        const uint32_t in[8] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) w[i] = scale_bf16x2(in[i], sc);
      }
      // 16 head dims, words w_i = dims 2i, 2i+1; for an int8 pool stored
      // [w0 w2 w4 w6 | w1 w3 w5 w7], so that the fragment a lane reads at
      // stored columns 2c, 2c+1 (8 + 2c, 8 + 2c + 1) holds dims 4c, 4c+1
      // (4c+2, 4c+3): the four bytes that lane holds of an int8 K row
      uint4* dst = reinterpret_cast<uint4*>(q_s + r * G::kQPitch + grp * 32);
      if (kQuant) {
        dst[0] = make_uint4(w[0], w[2], w[4], w[6]);
        dst[1] = make_uint4(w[1], w[3], w[5], w[7]);
      } else {
        dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
        dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
      }
    }
  }
  __syncthreads();  // the query tile in place

  auto worker_sync = [&]() {
    if (WR == 1) {
      __syncwarp();
    } else {
      named_barrier(1 + worker, WT);
    }
  };

  // this warp's query rows: n-tile nt holds rows rbase + 8 nt .. + 7; a lane
  // keeps rows rbase + 8 nt + 2 q4 + {0, 1}
  const int rbase = wr * NTW * 8;
  int q_abs[NTW][2];
  float m[NTW][2], l[NTW][2];
  float acc[MT][NTW][4];
#pragma unroll
  for (int nt = 0; nt < NTW; ++nt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      q_abs[nt][i] = length + (r0 + rbase + 8 * nt + 2 * q4 + i) / rep;
      m[nt][i] = -INFINITY;
      l[nt][i] = 0.f;
    }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  // the lane address pattern of every ldmatrix.x4 over a 16-row tile:
  // rows (lane % 8) + 8 ((lane / 8) % 2), 16-byte column lane / 16
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lcol = (lane >> 4) * 16;

  for (int i = 0; i < n_mine; ++i) {
    cp_async_wait<NS - 2>();
    worker_sync();   // block i has landed; the worker is done with block i - 1
    issue(i + NS - 1);  // into the slot block i - 1 used
    const unsigned char* ks = ring + (i % NS) * G::kSlot;
    const unsigned char* vs = ks + G::kSide;
    const float* scs = reinterpret_cast<const float*>(ks + 2 * G::kSide);
    const int j = first + i * WB;

    // S^T [16 tokens, rows] = K . Q^T over the head dim, two k-steps a pass
    float sacc[NTW][4];
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[nt][e] = 0.f;
#pragma unroll
    for (int kp = 0; kp < H / 32; ++kp) {
      uint32_t a0[4], a1[4];
      if (kQuant) {
        uint32_t r[4];
        ldsm_x4(r, ks + lrow * G::kPitch + kp * 32 + lcol);
        a0[0] = i8x2_bf16x2<0, 1>(r[0]);
        a0[1] = i8x2_bf16x2<0, 1>(r[1]);
        a0[2] = i8x2_bf16x2<2, 3>(r[0]);
        a0[3] = i8x2_bf16x2<2, 3>(r[1]);
        a1[0] = i8x2_bf16x2<0, 1>(r[2]);
        a1[1] = i8x2_bf16x2<0, 1>(r[3]);
        a1[2] = i8x2_bf16x2<2, 3>(r[2]);
        a1[3] = i8x2_bf16x2<2, 3>(r[3]);
      } else {
        ldsm_x4(a0, ks + lrow * G::kPitch + kp * 64 + lcol);
        ldsm_x4(a1, ks + lrow * G::kPitch + kp * 64 + 32 + lcol);
      }
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) {
        uint32_t qb[4];
        ldsm_x4(qb, q_s + (rbase + 8 * nt + (lane & 7)) * G::kQPitch + kp * 64 + (lane >> 3) * 16);
        mma16816(sacc[nt], a0, qb[0], qb[1]);
        mma16816(sacc[nt], a1, qb[2], qb[3]);
      }
    }

    // scale (int8), cap and mask; a lane holds tokens r4 and r4 + 8 of rows
    // 2 q4, 2 q4 + 1 (e = 2 * token half + row)
    const int pos0 = j * kBS + r4;
    float ksc[2] = {1.f, 1.f}, vsc[2] = {1.f, 1.f};
    if (kQuant) {
      ksc[0] = scs[r4];
      ksc[1] = scs[r4 + 8];
      vsc[0] = scs[kBS + r4];
      vsc[1] = scs[kBS + r4 + 8];
    }
    // a block that every query row sees whole needs no mask (warp-uniform)
    const bool whole = j * kBS + kBS - 1 <= length && (window <= 0 || length + Sq - 1 - j * kBS < window);
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sacc[nt][e] * ksc[e >> 1];
        if (soft_cap > 0.f) x = soft_cap * tanhf(x / soft_cap);
        sacc[nt][e] = x * kLog2e;
      }
    }
    if (!whole) {
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int pos = pos0 + 8 * (e >> 1);
          const int qa = q_abs[nt][e & 1];
          if (!(pos <= qa && (window <= 0 || qa - pos < window))) sacc[nt][e] = -INFINITY;
        }
      }
    }
    // online softmax: one max per row over the 8 lanes that hold it
    float bm[NTW][2];
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int i = 0; i < 2; ++i) bm[nt][i] = fmaxf(sacc[nt][i], sacc[nt][i + 2]);
#pragma unroll
    for (int o = 4; o < 32; o <<= 1)
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
        for (int i = 0; i < 2; ++i) bm[nt][i] = fmaxf(bm[nt][i], __shfl_xor_sync(0xffffffffu, bm[nt][i], o));
    uint32_t pb[NTW][2];
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_new = fmaxf(m[nt][i], bm[nt][i]);
        const float mu = m_new == -INFINITY ? 0.f : m_new;  // a row that has seen nothing stays at 0
        const float corr = ex2(m[nt][i] - mu);
        const float p0 = ex2(sacc[nt][i] - mu);
        const float p1 = ex2(sacc[nt][i + 2] - mu);
        l[nt][i] = l[nt][i] * corr + p0 + p1;
        m[nt][i] = m_new;
        if (__any_sync(0xffffffffu, corr != 1.f)) {  // most blocks leave every row's max where it was
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            acc[mt][nt][i] *= corr;
            acc[mt][nt][i + 2] *= corr;
          }
        }
        // P (times the V row scale, 0 where masked whatever the scale holds)
        sacc[nt][i] = kQuant ? (p0 > 0.f ? p0 * vsc[0] : 0.f) : p0;
        sacc[nt][i + 2] = kQuant ? (p1 > 0.f ? p1 * vsc[1] : 0.f) : p1;
      }
      // P^T [tokens, rows] as the B fragment: one 8x8 transpose per 8 tokens
      pb[nt][0] = movmatrix_t(pack_bf16x2(sacc[nt][0], sacc[nt][1]));
      pb[nt][1] = movmatrix_t(pack_bf16x2(sacc[nt][2], sacc[nt][3]));
    }

    // O^T [head dims, rows] += V^T . P^T over the block's 16 tokens
    if (kQuant) {
#pragma unroll
      for (int mp = 0; mp < H / 32; ++mp) {
        uint32_t r[4];
        ldsm_x4_t(r, vs + lrow * G::kPitch + mp * 32 + lcol);
        const uint32_t a0[4] = {i8x2_bf16x2<0, 2>(r[0]), i8x2_bf16x2<1, 3>(r[0]), i8x2_bf16x2<0, 2>(r[1]),
                                i8x2_bf16x2<1, 3>(r[1])};
        const uint32_t a1[4] = {i8x2_bf16x2<0, 2>(r[2]), i8x2_bf16x2<1, 3>(r[2]), i8x2_bf16x2<0, 2>(r[3]),
                                i8x2_bf16x2<1, 3>(r[3])};
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt) {
          mma16816(acc[2 * mp][nt], a0, pb[nt][0], pb[nt][1]);
          mma16816(acc[2 * mp + 1][nt], a1, pb[nt][0], pb[nt][1]);
        }
      }
    } else {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t r[4];
        ldsm_x4_t(r, vs + lrow * G::kPitch + mt * 32 + lcol);
        const uint32_t a[4] = {r[0], r[2], r[1], r[3]};
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt) mma16816(acc[mt][nt], a, pb[nt][0], pb[nt][1]);
      }
    }
  }
  cp_async_wait<0>();

  // row sums: each lane summed its own tokens
#pragma unroll
  for (int o = 4; o < 32; o <<= 1)
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int i = 0; i < 2; ++i) l[nt][i] += __shfl_xor_sync(0xffffffffu, l[nt][i], o);

  // the workers' rows merge in shared memory (the ring's bytes), in worker order
  __syncthreads();
  float* ob = reinterpret_cast<float*>(smem);  // [WB][RP][kOPitch]
  float* mb = ob + WB * RP * G::kOPitch;       // [WB][RP]
  float* lb = mb + WB * RP;                    // [WB][RP]
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // the head dim of accumulator row r4 (+ 8) of tile mt: int8 V tiles
        // hold dims 2 r4 and 2 r4 + 1
        const int dim = kQuant ? 16 * mt + 2 * r4 + (e >> 1) : 16 * mt + r4 + 8 * (e >> 1);
        const int row = rbase + 8 * nt + 2 * q4 + (e & 1);
        ob[(worker * RP + row) * G::kOPitch + dim] = acc[mt][nt][e];
      }
  if (lane < 4) {
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = rbase + 8 * nt + 2 * q4 + i;
        mb[worker * RP + row] = m[nt][i];
        lb[worker * RP + row] = l[nt][i];
      }
  }
  __syncthreads();

  const size_t bg = static_cast<size_t>(b) * Nkv + g;
  const size_t part_rows = static_cast<size_t>(gridDim.y) * Nkv * n_splits * rows;  // rows of every partial
  float* po = part + (bg * n_splits) * rows * H;      // [split][row][H], unnormalised
  float* pml = part + part_rows * H + (bg * n_splits) * rows * 2;  // [split][row][max, sum]
  for (int idx = tid; idx < tr * (H / 4); idx += kThreads) {
    const int r = idx / (H / 4), c4 = idx % (H / 4), ra = r0 + r;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < WB; ++w) mx = fmaxf(mx, mb[w * RP + r]);
    const float mu = mx == -INFINITY ? 0.f : mx;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    float lsum = 0.f;
#pragma unroll
    for (int w = 0; w < WB; ++w) {
      const float wgt = exp2f(mb[w * RP + r] - mu);
      const float4 v = *reinterpret_cast<const float4*>(ob + (w * RP + r) * G::kOPitch + c4 * 4);
      lsum += lb[w * RP + r] * wgt;
      o.x += v.x * wgt;
      o.y += v.y * wgt;
      o.z += v.z * wgt;
      o.w += v.w * wgt;
    }
    if (single) {
      store_out(out, (out_row0 + static_cast<size_t>(ra / rep) * N + g * rep + ra % rep) * H + c4 * 4, o, lsum);
    } else {
      *reinterpret_cast<float4*>(po + (static_cast<size_t>(s) * rows + ra) * H + c4 * 4) = o;
      if (c4 == 0) {
        pml[(static_cast<size_t>(s) * rows + ra) * 2] = mx;
        pml[(static_cast<size_t>(s) * rows + ra) * 2 + 1] = lsum;
      }
    }
  }
  if (single) return;

  // the last live chunk of (b, g, tile) to finish merges the tile's partials,
  // in split order
  int* counter = counters + bg * n_tiles + tile;
  __threadfence();
  __syncthreads();
  if (tid == 0) flag_s[0] = atomicAdd(counter, 1) == s_hi - s_lo;
  __syncthreads();
  if (!flag_s[0]) return;
  __threadfence();
  for (int idx = tid; idx < tr * (H / 4); idx += kThreads) {
    const int r = r0 + idx / (H / 4), c4 = idx % (H / 4);
    float mx = -INFINITY;
#pragma unroll 8
    for (int sp = s_lo; sp <= s_hi; ++sp) mx = fmaxf(mx, __ldcg(pml + (static_cast<size_t>(sp) * rows + r) * 2));
    const float mu = mx == -INFINITY ? 0.f : mx;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    float lsum = 0.f;
#pragma unroll 8
    for (int sp = s_lo; sp <= s_hi; ++sp) {
      const size_t at = static_cast<size_t>(sp) * rows + r;
      const float wgt = exp2f(__ldcg(pml + at * 2) - mu);
      const float4 v = __ldcg(reinterpret_cast<const float4*>(po + at * H + c4 * 4));
      lsum += __ldcg(pml + at * 2 + 1) * wgt;
      o.x += v.x * wgt;
      o.y += v.y * wgt;
      o.z += v.z * wgt;
      o.w += v.w * wgt;
    }
    store_out(out, (out_row0 + static_cast<size_t>(r / rep) * N + g * rep + r % rep) * H + c4 * 4, o, lsum);
  }
  if (tid == 0) *counter = 0;  // ready for the next call on this stream
}

struct Args {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const float* k_scale;
  const float* v_scale;
  const int* tables;
  const int* lengths;
  void* out;
  float* part;
  int* counters;
  int B, Sq, N, Nkv, NBseq, cb, window;
  float soft_cap, scale;
};

// the dynamic shared memory the kernel asks for (over the 48 KB default)
template <int QUANT, int H, int NTW, int WR>
cudaError_t set_smem() {
  return cudaFuncSetAttribute(paged_attention_kernel<QUANT, H, NTW, WR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Smem<QUANT, H, NTW, WR>::kBytes);
}

template <int QUANT, int H, int NTW, int WR>
int launch(const Args& a, cudaStream_t stream) {
  using KV = KVOf<QUANT>;
  using S = Smem<QUANT, H, NTW, WR>;
  auto kernel = paged_attention_kernel<QUANT, H, NTW, WR>;
  cudaError_t e = set_smem<QUANT, H, NTW, WR>();
  if (e != cudaSuccess) return static_cast<int>(e);
  // split slowest: the live chunks start first, the dead ones retire last
  const int tiles = (a.Sq * (a.N / a.Nkv) + kTileRows - 1) / kTileRows;
  dim3 grid(tiles * a.Nkv, a.B, (a.NBseq + a.cb - 1) / a.cb);
  kernel<<<grid, kThreads, S::kBytes, stream>>>(
      reinterpret_cast<const __nv_bfloat16*>(a.q), reinterpret_cast<const KV*>(a.k_pool),
      reinterpret_cast<const KV*>(a.v_pool), a.k_scale, a.v_scale, a.tables, a.lengths,
      reinterpret_cast<__nv_bfloat16*>(a.out), a.part, a.counters, a.Sq, a.N, a.Nkv, a.NBseq, a.cb, a.window,
      a.soft_cap, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// padded query rows of a tile: 8 a warp (one worker a warp), 16 a warp, or
// 16 a warp with two warps a worker (rows 17-32, and every tile of a wider
// chunk): 3 head dims x 3 x 2 pool dtypes = 18 instantiations
template <int QUANT, int H>
int dispatch_rows(int rows, const Args& a, cudaStream_t stream) {
  if (rows <= 8) return launch<QUANT, H, 1, 1>(a, stream);
  if (rows <= 16) return launch<QUANT, H, 2, 1>(a, stream);
  return launch<QUANT, H, 2, 2>(a, stream);
}

template <int QUANT>
int dispatch_head(int H, int rows, const Args& a, cudaStream_t stream) {
  switch (H) {
    case 64: return dispatch_rows<QUANT, 64>(rows, a, stream);
    case 128: return dispatch_rows<QUANT, 128>(rows, a, stream);
    case 256: return dispatch_rows<QUANT, 256>(rows, a, stream);
  }
  return kErrUnsupported;
}

}  // namespace

extern "C" {

// Launches on `stream`, allocates nothing, returns cudaGetLastError() after
// the launch (0 = launched) or an error code for a shape it does not take.
// `part` holds B * Nkv * ceil(NBseq / chunk_blocks) * Sq * (N / Nkv) * (H + 2)
// floats (unused, and may be null, when that ceil is 1); `counters`
// B * Nkv * ceil(Sq * (N / Nkv) / 32) ints, zero before the first call, left
// zero by every call.
int paged_attention_fwd(const void* q, const void* k_pool, const void* v_pool, const float* k_scale,
                        const float* v_scale, const int* tables, const int* lengths, void* out, float* part,
                        int* counters, int B, int Sq, int N, int Nkv, int H, int BS, int NBseq, int window,
                        int quantized, float soft_cap, float scale, int chunk_blocks, void* stream_ptr) {
  if (B < 1 || Sq < 1 || Nkv < 1 || N % Nkv != 0 || NBseq < 1 || BS != kBS) return kErrUnsupported;
  if (chunk_blocks < 1 || chunk_blocks > kMaxChunk) return kErrUnsupported;
  if (B > 65535 || (NBseq + chunk_blocks - 1) / chunk_blocks > 65535) return kErrUnsupported;  // grid y, z
  const int rows = Sq * (N / Nkv);
  if (static_cast<long long>((rows + kTileRows - 1) / kTileRows) * Nkv > 2147483647LL) return kErrUnsupported;  // grid x
  if ((NBseq + chunk_blocks - 1) / chunk_blocks > 1 && (part == nullptr || counters == nullptr)) {
    return kErrUnsupported;
  }
  const Args a{q, k_pool, v_pool, k_scale, v_scale, tables, lengths, out, part, counters,
               B, Sq, N, Nkv, NBseq, chunk_blocks, window, soft_cap, scale};
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const int tile_rows = rows < kTileRows ? rows : kTileRows;
  if (quantized) return dispatch_head<1>(H, tile_rows, a, stream);
  return dispatch_head<0>(H, tile_rows, a, stream);
}

const char* paged_attention_error_string(int code) {
  if (code == kErrUnsupported) return "shape not supported by the paged-attention kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
