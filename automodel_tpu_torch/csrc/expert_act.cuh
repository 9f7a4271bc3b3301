// The expert MLP's activation and its gradient, in fp32, shared by the
// fused expert MLP's kernels (fused_expert_mlp.cu: the backward's
// elementwise pass and the bias grads) and the grouped matmul's gate_up
// epilogue (grouped_matmul.cu: K3a's first launch). Each source includes it
// into its own anonymous namespace.
//
// act is swiglu, silu(g) * u (with an optional clamp `limit`:
// min(silu(g), limit) * clip(u, +-limit)), or swiglu_oai,
// (clip(u, +-7) + 1) * g' * sigmoid(1.702 g') with g' = min(g, 7). At a
// clamp's bound the gradient is 0.5, JAX's rule for min and max, which
// torch.clamp does not follow.

#pragma once

#include <math.h>

namespace {

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

// act_kind 0 swiglu, 1 swiglu_oai; limit > 0 clamps swiglu (ignored for swiglu_oai)
inline Act make_act(int act_kind, float limit) { return Act{act_kind, act_kind == 0 ? limit : 0.f}; }

}  // namespace
