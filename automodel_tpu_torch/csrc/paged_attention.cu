// Paged attention for decode and verify, in place over the KV block pool.
//
// Replaces the Pallas TPU kernel automodel_tpu/ops/paged_attention.py
// (_paged_kernel :97, reached through paged_attend :175). Same function:
// q [B, Sq, N, H] bf16 (pre-scaled in bf16 by the wrapper) attends one
// layer's pool [NB, BS, Nkv, H] (bf16, or int8 with fp32 row scales
// [NB, BS, Nkv]) through per-sequence block tables [B, NBseq] int32 and
// lengths [B] int32. Query row qi sits at absolute position length + qi and
// attends pos <= length + qi (and length + qi - pos < window under a
// sliding window); logits pass the soft cap before masking; softmax is fp32
// and a row that attends nothing writes zeros. Out: [B, Sq, N, H] bf16.
//
// What bounds it on an H100: device-memory bytes. Each (sequence, kv head)
// reads its live KV once and does 4 flops per byte of bf16 KV at Sq*rep = 4
// query rows, far under the ~295 flops/byte where the tensor cores would
// become the limit. The least time is the live KV bytes over 3.35 TB/s.
//
// Design (simple first):
// - grid (B, Nkv): one CTA of 4 warps per (sequence, kv head), so GQA is
//   native: the CTA's Sq*rep query rows all read its head's KV once. Each
//   warp owns up to RPW query rows.
// - the CTA walks only the live blocks, from the window start to
//   (length + Sq - 1) / BS, reading tables[b, j] itself; blocks past the
//   live range are never read.
// - each block's K and V rows for head g (and int8 row scales) are copied
//   to shared memory with cp.async, kStages blocks in flight; K rows are
//   padded by 16 bytes so lanes reading different rows hit different banks.
// - scores: a token per 32/BS lanes, each lane a share of the channels,
//   then one online-softmax update per block (max and sum by shuffles).
//   Values: each lane owns H/32 channels of each row's fp32 accumulator
//   in registers and takes the block's probabilities by shuffle.
//
// Later work: split-KV (flash-decoding) for when B * Nkv is below the 132
// SMs or sequences are long; TMA bulk copies; wgmma for the verify chunk
// (Sq > 1) where rows per head reach 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 4;
constexpr int kErrUnsupported = 100001;

__device__ __forceinline__ void cp_async16(void* smem_ptr, const void* gmem_ptr) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem_ptr));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem_ptr));
}

__device__ __forceinline__ void cp_async4(void* smem_ptr, const void* gmem_ptr) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem_ptr));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem_ptr));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int BYTES>
struct alignas(BYTES) Chunk {
  unsigned char b[BYTES];
};

// E consecutive values at p (aligned to E * sizeof(T)) → fp32
template <int E>
__device__ __forceinline__ void load_f32(const __nv_bfloat16* p, float (&dst)[E]) {
  Chunk<E * 2> c = *reinterpret_cast<const Chunk<E * 2>*>(p);
  const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(c.b);
#pragma unroll
  for (int i = 0; i < E / 2; ++i) {
    float2 f = __bfloat1622float2(v[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

template <int E>
__device__ __forceinline__ void load_f32(const int8_t* p, float (&dst)[E]) {
  Chunk<E> c = *reinterpret_cast<const Chunk<E>*>(p);
#pragma unroll
  for (int i = 0; i < E; ++i) dst[i] = static_cast<float>(static_cast<int8_t>(c.b[i]));
}

template <typename KV, int H, int BS>
struct Layout {
  static constexpr int kRowBytes = H * static_cast<int>(sizeof(KV));
  static constexpr int kPitch = kRowBytes + 16;  // padded smem row
  static constexpr int kChunksPerRow = kRowBytes / 16;
  static constexpr int kStageBytes = 2 * BS * kPitch;  // k rows then v rows
  static constexpr int kKVBytes = kStages * kStageBytes;
  static constexpr int kScaleBytes = kStages * 2 * BS * 4;
};

template <typename KV, int H, int RPW, int BS>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const __nv_bfloat16* __restrict__ q, const KV* __restrict__ k_pool,
    const KV* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ tables,
    const int* __restrict__ lengths, __nv_bfloat16* __restrict__ out, int Sq, int N,
    int Nkv, int NBseq, int window, float soft_cap) {
  using L = Layout<KV, H, BS>;
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  constexpr int E = H / 32;             // value channels per lane
  constexpr int LPT = 32 / BS;          // lanes per token in the score
  constexpr int EPC = 16 / sizeof(KV);  // elements per 16-byte chunk
  constexpr int CPL = L::kChunksPerRow / LPT;  // score chunks per lane

  const int b = blockIdx.x;
  const int g = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int tok = lane / LPT;  // this lane's token in a block
  const int part = lane % LPT;
  const int rep = N / Nkv;
  const int rows = Sq * rep;
  const int length = lengths[b];
  const int* tbl = tables + static_cast<size_t>(b) * NBseq;

  // shared memory: [stage][k rows | v rows] padded KV, the int8 row scales
  // [stage][k | v][BS], then the CTA's query rows [rows][H] fp32
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* kv_s = smem;
  float* sc_s = reinterpret_cast<float*>(smem + L::kKVBytes);
  float* q_s = reinterpret_cast<float*>(smem + L::kKVBytes + (kQuant ? L::kScaleBytes : 0));

  for (int idx = threadIdx.x; idx < rows * (H / 2); idx += kThreads) {
    const int r = idx / (H / 2);
    const int c = idx - r * (H / 2);
    const int qi = r / rep;
    const int head = g * rep + r % rep;
    const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(
        q + ((static_cast<size_t>(b) * Sq + qi) * N + head) * H + 2 * c);
    const float2 f = __bfloat1622float2(v);
    q_s[r * H + 2 * c] = f.x;
    q_s[r * H + 2 * c + 1] = f.y;
  }

  float acc[RPW][E];
  float m[RPW];
  float l[RPW];
  int q_abs[RPW];
  bool has[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = warp + i * kWarps;  // row r = qi * rep + head offset
    has[i] = r < rows;
    q_abs[i] = length + (has[i] ? r / rep : 0);
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[i][e] = 0.f;
  }

  // live blocks only: past the last query position nothing is attended,
  // and under a window nothing before the first position row 0 can see
  int j_hi = (length + Sq - 1) / BS;
  if (j_hi > NBseq - 1) j_hi = NBseq - 1;
  int j_lo = 0;
  if (window > 0) {
    const int lo_pos = length - window + 1;
    if (lo_pos > 0) j_lo = lo_pos / BS;
  }

  auto issue = [&](int j) {
    if (j <= j_hi) {
      const size_t blk = static_cast<size_t>(tbl[j]);
      unsigned char* stage = kv_s + ((j - j_lo) % kStages) * L::kStageBytes;
      constexpr int chunks = BS * L::kChunksPerRow;  // per side
      for (int c = threadIdx.x; c < 2 * chunks; c += kThreads) {
        const int side = c / chunks;
        const int cc = c - side * chunks;
        const int t = cc / L::kChunksPerRow;
        const int w = cc - t * L::kChunksPerRow;
        const KV* pool = side ? v_pool : k_pool;
        cp_async16(stage + (side * BS + t) * L::kPitch + w * 16,
                   reinterpret_cast<const unsigned char*>(pool + ((blk * BS + t) * Nkv + g) * H) +
                       w * 16);
      }
      if (kQuant) {
        float* sc = sc_s + ((j - j_lo) % kStages) * 2 * BS;
        for (int c = threadIdx.x; c < 2 * BS; c += kThreads) {
          const int side = c / BS;
          const int t = c - side * BS;
          cp_async4(sc + c, (side ? v_scale : k_scale) + (blk * BS + t) * Nkv + g);
        }
      }
    }
    cp_async_commit();  // one group per block slot, empty past the end
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(j_lo + s);

  for (int j = j_lo; j <= j_hi; ++j) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // block j has landed; every warp is done with j - 1
    issue(j + kStages - 1);  // into the stage block j - 1 used
    const unsigned char* stage = kv_s + ((j - j_lo) % kStages) * L::kStageBytes;
    const KV* ks = reinterpret_cast<const KV*>(stage);
    const unsigned char* vs = stage + BS * L::kPitch;
    const float* scs = sc_s + ((j - j_lo) % kStages) * 2 * BS;

    // scores for this lane's token, all of the warp's rows
    float s[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) s[i] = 0.f;
    const KV* krow = reinterpret_cast<const KV*>(reinterpret_cast<const unsigned char*>(ks) +
                                                 tok * L::kPitch);
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int ch = (c * LPT + part) * EPC;  // interleaved: neighbours differ in bank
      float kf[EPC];
      load_f32<EPC>(krow + ch, kf);
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        if (!has[i]) continue;
        const float* qr = q_s + (warp + i * kWarps) * H + ch;
#pragma unroll
        for (int e = 0; e < EPC; e += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(qr + e);
          s[i] += qv.x * kf[e] + qv.y * kf[e + 1] + qv.z * kf[e + 2] + qv.w * kf[e + 3];
        }
      }
    }
    const int pos = j * BS + tok;
    const float k_sc = kQuant ? scs[tok] : 1.f;
    float p[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      p[i] = 0.f;
      if (!has[i]) continue;  // warp-uniform
#pragma unroll
      for (int o = 1; o < LPT; o <<= 1) s[i] += __shfl_xor_sync(0xffffffffu, s[i], o);
      float sc = s[i] * k_sc;
      if (soft_cap > 0.f) sc = soft_cap * tanhf(sc / soft_cap);
      const bool valid = pos <= q_abs[i] && (window <= 0 || q_abs[i] - pos < window);
      float bmax = valid ? sc : -INFINITY;
#pragma unroll
      for (int o = LPT; o < 32; o <<= 1) bmax = fmaxf(bmax, __shfl_xor_sync(0xffffffffu, bmax, o));
      if (bmax == -INFINITY) continue;  // warp-uniform: the row sees nothing here
      const float m_new = fmaxf(m[i], bmax);
      p[i] = valid ? expf(sc - m_new) : 0.f;
      float psum = p[i];
#pragma unroll
      for (int o = LPT; o < 32; o <<= 1) psum += __shfl_xor_sync(0xffffffffu, psum, o);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + psum;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[i][e] *= corr;
    }

    // values: lane owns channels [lane * E, lane * E + E)
#pragma unroll 4
    for (int t = 0; t < BS; ++t) {
      float vf[E];
      load_f32<E>(reinterpret_cast<const KV*>(vs + t * L::kPitch) + lane * E, vf);
      const float v_sc = kQuant ? scs[BS + t] : 1.f;
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        if (!has[i]) continue;
        const float pt = __shfl_sync(0xffffffffu, p[i], t * LPT) * v_sc;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[i][e] += pt * vf[e];
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    if (!has[i]) continue;
    const int r = warp + i * kWarps;
    const int qi = r / rep;
    const int head = g * rep + r % rep;
    __nv_bfloat16* o = out + ((static_cast<size_t>(b) * Sq + qi) * N + head) * H + lane * E;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int e = 0; e < E; ++e) o[e] = __float2bfloat16(l[i] > 0.f ? acc[i][e] / denom : 0.f);
  }
}

template <typename KV, int H, int RPW, int BS>
int launch(const void* q, const void* k_pool, const void* v_pool, const float* k_scale,
           const float* v_scale, const int* tables, const int* lengths, void* out, int B,
           int Sq, int N, int Nkv, int NBseq, int window, float soft_cap,
           cudaStream_t stream) {
  using L = Layout<KV, H, BS>;
  const bool quant = std::is_same<KV, int8_t>::value;
  const int rows = Sq * (N / Nkv);
  const size_t smem = L::kKVBytes + (quant ? L::kScaleBytes : 0) +
                      static_cast<size_t>(rows) * H * sizeof(float);
  auto kernel = paged_attention_kernel<KV, H, RPW, BS>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(B, Nkv);
  kernel<<<grid, kThreads, smem, stream>>>(
      reinterpret_cast<const __nv_bfloat16*>(q), reinterpret_cast<const KV*>(k_pool),
      reinterpret_cast<const KV*>(v_pool), k_scale, v_scale, tables, lengths,
      reinterpret_cast<__nv_bfloat16*>(out), Sq, N, Nkv, NBseq, window, soft_cap);
  return static_cast<int>(cudaGetLastError());
}

#define PA_ARGS q, k_pool, v_pool, k_scale, v_scale, tables, lengths, out, B, Sq, N, Nkv, \
                NBseq, window, soft_cap, stream
#define PA_PARAMS const void *q, const void *k_pool, const void *v_pool, const float *k_scale, \
                  const float *v_scale, const int *tables, const int *lengths, void *out,     \
                  int B, int Sq, int N, int Nkv, int NBseq, int window, float soft_cap,       \
                  cudaStream_t stream

// one block size, the serving configs' 16 tokens: 3 head dims x 4 row
// counts x 2 pool dtypes = 24 instantiations
constexpr int kBlockSize = 16;

template <typename KV, int H>
int dispatch_rows(int rpw, int BS, PA_PARAMS) {
  if (BS != kBlockSize) return kErrUnsupported;
  switch (rpw) {
    case 1: return launch<KV, H, 1, kBlockSize>(PA_ARGS);
    case 2: return launch<KV, H, 2, kBlockSize>(PA_ARGS);
    case 4: return launch<KV, H, 4, kBlockSize>(PA_ARGS);
    case 8: return launch<KV, H, 8, kBlockSize>(PA_ARGS);
  }
  return kErrUnsupported;
}

template <typename KV>
int dispatch_head(int H, int rpw, int BS, PA_PARAMS) {
  switch (H) {
    case 64: return dispatch_rows<KV, 64>(rpw, BS, PA_ARGS);
    case 128: return dispatch_rows<KV, 128>(rpw, BS, PA_ARGS);
    case 256: return dispatch_rows<KV, 256>(rpw, BS, PA_ARGS);
  }
  return kErrUnsupported;
}

}  // namespace

extern "C" {

// Launches on `stream`, allocates nothing, returns cudaGetLastError() after
// the launch (0 = launched) or an error code for a shape it does not take.
int paged_attention_fwd(const void* q, const void* k_pool, const void* v_pool,
                        const float* k_scale, const float* v_scale, const int* tables,
                        const int* lengths, void* out, int B, int Sq, int N, int Nkv, int H,
                        int BS, int NBseq, int window, int quantized, float soft_cap,
                        void* stream_ptr) {
  if (B < 1 || Sq < 1 || Nkv < 1 || N % Nkv != 0 || NBseq < 1) return kErrUnsupported;
  const int rows = Sq * (N / Nkv);
  int rpw = 1;
  while (rpw * kWarps < rows) rpw *= 2;
  if (rpw > 8) return kErrUnsupported;
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  if (quantized) {
    return dispatch_head<int8_t>(H, rpw, BS, q, k_pool, v_pool, k_scale, v_scale, tables,
                                 lengths, out, B, Sq, N, Nkv, NBseq, window, soft_cap, stream);
  }
  return dispatch_head<__nv_bfloat16>(H, rpw, BS, q, k_pool, v_pool, nullptr, nullptr, tables,
                                      lengths, out, B, Sq, N, Nkv, NBseq, window, soft_cap,
                                      stream);
}

const char* paged_attention_error_string(int code) {
  if (code == kErrUnsupported) return "shape not supported by the paged-attention kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
