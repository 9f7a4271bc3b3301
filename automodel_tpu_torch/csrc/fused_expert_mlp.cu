// Fused expert MLP of the MoE experts (experts: ragged_fused): the forward
// out = act(lhs @ Wg + gb, lhs @ Wu + ub) @ Wd + db per row's group, and
// the kernels of its backward that are not grouped matmuls.
//
// Replaces, with the grouped-matmul kernels of grouped_matmul.cu that carry
// the products, the Pallas TPU kernels of automodel_tpu/ops/fused_expert_mlp.py:
// _kernel (:59, through _fwd :130; K3a), _bwd_gu_kernel (:423, through
// _bwd_gu :465; K3b), _bwd_dwd_kernel (:530, through _bwd_dwd :560; K3c) and
// _bwd_dx_kernel (:615, through _bwd_dx :649; K3d).
//
// Operands (bf16 unless said): lhs [M, D] with rows sorted by group, group g
// owning rows [start_g, end_g) of the cumsum of group_sizes; gate_up
// [G, D, 2I], the gate half in columns [0, I) and the up half in [I, 2I),
// both read in place with row stride 2I; down [G, I, D]; the optional biases
// gate_up_bias [G, 2I] and down_bias [G, D]. The activation and its
// gradient (expert_act.cuh) run in fp32.
//
// - K3a, the forward, is two launches of grouped_matmul.cu's gmm pipeline
//   (wgmma, TMA, a persistent grid over the gmm plan): gmm_act_kernel
//   writes mid = act(lhs @ Wg + gb, lhs @ Wu + ub) [M, I] in bf16 from its
//   epilogue, gmm_bias_kernel then out = mid @ Wd + db. It is bound by
//   operations at gpt-oss-20b's widths; why the two launches stay two:
//   grouped_matmul.cu's header.
// - K3b, dW [G, D, 2I] = lhs_g^T [dg | du] per group with dg and du rounded
//   to bf16 before the product (:438-445), is grouped_matmul.cu's
//   tgmm_kernel over the dg | du that bwd_act writes once (below), in fp32
//   (JAX's output) or bf16 (the backward's weight grad, the fp32 sum
//   rounded once in the kernel: the cast the backward did in eager torch).
//   The bias grads are fp32 row sums of the unrounded dg, du (:455-462), not
//   of bwd_act's bf16 output: bwd_dgub_kernel recomputes them from g | u
//   and dmid and sums them in a fixed order. The product is bound by
//   operations, the sums (~283 MB read) by bytes.
// - bwd_act (the activation of K3b, K3c and K3d): one pass over the routed
//   rows reads g | u and dmid and writes mid = act(g, u) [M, I] (as :537-547
//   rounds it) and dg | du [M, 2I] (as :629-642 rounds them), each computed
//   in fp32 and rounded once to bf16; rows past sum(group_sizes) are written
//   as zeros. K3c is then tgmm(mid, dy) with a bf16 out (_vjp_bwd's
//   dWd.astype(down.dtype), :777, taken in the kernel) and bwd_ddb, the fp32
//   row sums of dy per group (:552-557); K3d is gmm(dg | du, gate_up,
//   transpose_rhs) over K = 2I, gate_up read in place as the
//   [G, N = D, K = 2I] rhs. The TPU kernels recompute the activation per
//   output tile because VMEM holds a [512, I] row block for the whole grid
//   walk; an SM's 227 KB does not (dg | du of 128 rows at I = 2880 is
//   1.47 MB), and recomputing per 128-column tile ran the activation 23
//   times an element at gpt-oss-20b's widths. Written once, the operands
//   cost ~566 MB of traffic (~0.17 ms at 3.35 TB/s).
//
// A kernel reads only its group's rows (bwd_act only rows before the groups'
// end), so rows past sum(group_sizes), which may hold NaN in lhs and dy,
// never reach a weight or bias gradient.
//
// What bounds these kernels on an H100 at gpt-oss-20b's widths (4096
// tokens top-4: M = 16384 rows over 32 experts, D = I = 2880): bytes.
// bwd_act moves 16 bytes a thread a load and a store in a grid-stride loop,
// with no shared memory; bwd_ddb and bwd_dgub are row sums over (column
// tile, group) CTAs in a fixed order, no atomics: a repeat gives the same
// bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "expert_act.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kErrUnsupported = 100001;

// -- the backward's elementwise pass (for K3b, K3c and K3d): mid, dg | du --------

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


// -- K3b's bias grads: dbias [G, 2I] fp32 = the row sums of the unrounded dg, du --

struct BwdDgubArgs {
  const bf16* gu;    // [M, 2I]: the recomputed g | u, biases added
  const bf16* dmid;  // [M, I]
  const int* ends;   // [G] inclusive cumsum of group_sizes
  float* dbias;      // [G, 2I]: dg's sums in columns [0, I), du's in [I, 2I)
  int M, I;
  Act act;
};

// bwd_ddb_kernel's layout over I: grid (ceil(I / 64), G), row lane l
// recomputes dg and du of the group's rows start + l, start + l + 32, ...
// in fp32 from g, u and dmid (three 16-byte loads a row) and sums them in
// order, then thread t adds the 32 lanes' sums of column t (dg's for t <
// 64, du's after) in lane order. No atomics: a repeat gives the same bits;
// an empty group writes zeros.
__global__ void __launch_bounds__(kThreads) bwd_dgub_kernel(const BwdDgubArgs a) {
  __shared__ float part[kDdbLanes][2 * kDdbCols];
  const int g = blockIdx.y;
  const int end = min(a.ends[g], a.M);
  const int start = min(g > 0 ? a.ends[g - 1] : 0, end);
  const int ct = threadIdx.x % kDdbColThreads, rl = threadIdx.x / kDdbColThreads;
  const int c = blockIdx.x * kDdbCols + ct * 8;
  const long long ld = 2LL * a.I;
  float sg[8] = {}, su[8] = {};
  if (c < a.I) {
#pragma unroll 2
    for (int r = start + rl; r < end; r += kDdbLanes) {
      float gv[8], uv[8], dm[8];
      unpack8(*reinterpret_cast<const uint4*>(a.gu + r * ld + c), gv);
      unpack8(*reinterpret_cast<const uint4*>(a.gu + r * ld + a.I + c), uv);
      unpack8(*reinterpret_cast<const uint4*>(a.dmid + static_cast<long long>(r) * a.I + c), dm);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float dg, du;
        act_bwd(gv[i], uv[i], dm[i], a.act, dg, du);
        sg[i] += dg;
        su[i] += du;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    part[rl][ct * 8 + i] = sg[i];
    part[rl][kDdbCols + ct * 8 + i] = su[i];
  }
  __syncthreads();
  if (threadIdx.x < 2 * kDdbCols) {
    const int col = blockIdx.x * kDdbCols + threadIdx.x % kDdbCols;
    if (col < a.I) {
      float v = 0.f;
#pragma unroll
      for (int l = 0; l < kDdbLanes; ++l) v += part[l][threadIdx.x];
      a.dbias[static_cast<long long>(g) * ld + (threadIdx.x < kDdbCols ? 0 : a.I) + col] = v;
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

}  // namespace

extern "C" {

// Each launches on `stream`, allocates nothing and returns cudaGetLastError()
// after the launch (0 = launched), or an error code for a shape it does not
// take (D or I not a multiple of 8, an unknown act_kind). act_kind: 0
// swiglu, 1 swiglu_oai; limit > 0 clamps swiglu (ignored for swiglu_oai).
// ends: int32 [G], the inclusive cumsum of group_sizes. K3a's launches and
// the products of K3b-K3d are grouped_matmul.cu's entry points.

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

// K3b's bias grads: dbias [G, 2I] fp32, the row sums over each group's
// rows of the unrounded fp32 dg (columns [0, I)) and du ([I, 2I)) of act
// at gu [M, 2I] (g | u) for dmid [M, I]
int fused_expert_mlp_bwd_dgub(const void* gu, const void* dmid, const int* ends, float* dbias, int M, int I, int G,
                              int act_kind, float limit, void* stream) {
  if (!shape_ok(M, 8, I, G, act_kind)) return kErrUnsupported;
  BwdDgubArgs a = {static_cast<const bf16*>(gu), static_cast<const bf16*>(dmid), ends, dbias, M, I,
                   make_act(act_kind, limit)};
  return launch(bwd_dgub_kernel, dim3((I + kDdbCols - 1) / kDdbCols, G), 0, a, static_cast<cudaStream_t>(stream));
}

const char* fused_expert_mlp_error_string(int code) {
  if (code == kErrUnsupported) return "shape not supported by the fused expert-MLP kernels";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
