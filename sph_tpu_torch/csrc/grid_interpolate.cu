// The field interpolation of the grid t-SNE tier, for Hopper (sm_90a).
//
// Replaces no Pallas kernel.  It replaces the interpolation of the JAX
// package's grid repulsion, sph_tpu/ops/tsne_grid.py::interpolate_fields
// (:149), an XLA program that samples the four convolved fields back at the
// points through dense [c, G] cubic-Lagrange weight rows on the TPU's
// matrix unit.  Each point has 4 x 4 nonzero taps, so here one thread a
// point gathers them, and the twin (ops/tsne_grid.py
// grid_interpolate_reference) fixes the order:
//
//   tv[dv][q] = ((wy0 F[u0][v0+dv][q] + wy1 F[u0+1][..]) + wy2 ..) + wy3 ..
//   phi[q]    = ((wx0 tv[0][q] + wx1 tv[1][q]) + wx2 tv[2][q]) + wx3 tv[3][q]
//   rep       = (y_x phi0 - phi1, y_y phi0 - phi2),  phi_z = phi3
//
// (the y taps first, as the JAX package's matmuls contract them), each
// operation an IEEE round-to-nearest intrinsic, never contracted into a
// fused multiply-add, so the kernel gives the twin's bits.  The taps (the
// base node and the cardinal weights) are recomputed in registers with the
// deposit's arithmetic (csrc/grid_deposit.cu): no tap table.
//
// Input: y [npad, 2] float32 (rows >= n are pads); lo [2], h [2] float32,
// the box; fields [G, G, 4] float32, node-major (ops/tsne_grid.py
// grid_interpolate copies the [4, G, G] fields so), so that a tap is one
// 16-byte load.
// Output: rep [npad, 2] float32, pad rows 0, and phi_z [n] float32, which
// the wrapper sums with the same torch call as the twin for Z.
//
// What bounds it: bytes.  The function reads the fields (16 G^2 bytes) and
// y's n rows and writes rep [npad, 2] and Z: 32.8 MB at 10^6 points on the
// 1024 grid, about 10 us at 3.35 TB/s; about 200 flops a point.  The
// gathers stay in the 50 MB L2 (the 1024 grid's fields are 16 MB); a
// point's four taps along x are 64 contiguous bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kMargin = 3.0f;       // ops/tsne_grid.py _MARGIN
// float32(1 / 6), ops/tsne_grid.py _SIXTH
__device__ __forceinline__ float sixth() { return __int_as_float(0x3E2AAAAB); }

// (y - lo) / h + 3, rounded step by step as the twin's torch ops round
__device__ __forceinline__ float coord(float y, float lo, float h) {
  return __fadd_rn(__fdiv_rn(__fsub_rn(y, lo), h), kMargin);
}

// the twin's _cardinal: the 4-point Lagrange weight at distance s >= 0
__device__ __forceinline__ float cardinal(float s) {
  if (s < 1.0f)
    return __fmul_rn(__fmul_rn(__fmul_rn(__fadd_rn(s, 1.0f),
                                         __fsub_rn(s, 1.0f)),
                               __fsub_rn(s, 2.0f)),
                     0.5f);
  if (s < 2.0f)
    return __fmul_rn(__fmul_rn(__fmul_rn(-__fsub_rn(s, 1.0f),
                                         __fsub_rn(s, 2.0f)),
                               __fsub_rn(s, 3.0f)),
                     sixth());
  return 0.0f;
}

// first node floor(t) - 1 (clamped onto the grid, which a finite point in
// its own box never leaves) and the weights of nodes first .. first + 3
__device__ __forceinline__ int taps(float t, int grid, float (&w)[4]) {
  const float first = __fsub_rn(floorf(t), 1.0f);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    w[j] = cardinal(fabsf(__fsub_rn(t, __fadd_rn(first,
                                                 static_cast<float>(j)))));
  const int f = static_cast<int>(first);
  return min(max(f, 0), grid - 4);
}

__device__ __forceinline__ float4 axpy_first(float w, float4 f) {
  return make_float4(__fmul_rn(w, f.x), __fmul_rn(w, f.y), __fmul_rn(w, f.z),
                     __fmul_rn(w, f.w));
}

__device__ __forceinline__ float4 axpy(float4 acc, float w, float4 f) {
  return make_float4(__fadd_rn(acc.x, __fmul_rn(w, f.x)),
                     __fadd_rn(acc.y, __fmul_rn(w, f.y)),
                     __fadd_rn(acc.z, __fmul_rn(w, f.z)),
                     __fadd_rn(acc.w, __fmul_rn(w, f.w)));
}

__global__ void __launch_bounds__(kThreads)
interpolate_points(const float2* __restrict__ y, long long n, long long npad,
                   const float* __restrict__ lo, const float* __restrict__ h,
                   const float4* __restrict__ fields, int grid,
                   float2* __restrict__ rep, float* __restrict__ phi_z) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= npad) return;
  if (i >= n) {
    rep[i] = make_float2(0.0f, 0.0f);
    return;
  }
  const float2 p = y[i];
  float wx[4], wy[4];
  const int v0 = taps(coord(p.x, lo[0], h[0]), grid, wx);
  const int u0 = taps(coord(p.y, lo[1], h[1]), grid, wy);
  const float4* row = fields + static_cast<long long>(u0) * grid + v0;
  float4 f[4][4];                       // [du][dv], all 16 loads in flight
#pragma unroll
  for (int du = 0; du < 4; ++du)
#pragma unroll
    for (int dv = 0; dv < 4; ++dv) f[du][dv] = row[du * grid + dv];
  float4 phi;
#pragma unroll
  for (int dv = 0; dv < 4; ++dv) {
    float4 tv = axpy_first(wy[0], f[0][dv]);
#pragma unroll
    for (int du = 1; du < 4; ++du) tv = axpy(tv, wy[du], f[du][dv]);
    phi = dv == 0 ? axpy_first(wx[0], tv) : axpy(phi, wx[dv], tv);
  }
  rep[i] = make_float2(__fsub_rn(__fmul_rn(p.x, phi.x), phi.y),
                       __fsub_rn(__fmul_rn(p.y, phi.x), phi.z));
  phi_z[i] = phi.w;
}

}  // namespace

// n <= npad; grid >= 4.
extern "C" int grid_interpolate_launch(const void* y, long long n,
                                       long long npad, const void* lo,
                                       const void* h, const void* fields,
                                       int grid, void* rep, void* phi_z,
                                       void* stream) {
  if (n < 0 || npad < n || grid < 4)
    return static_cast<int>(cudaErrorInvalidValue);
  if (npad == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long blocks = (npad + kThreads - 1) / kThreads;
  interpolate_points<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      static_cast<const float2*>(y), n, npad, static_cast<const float*>(lo),
      static_cast<const float*>(h), static_cast<const float4*>(fields), grid,
      static_cast<float2*>(rep), static_cast<float*>(phi_z));
  return static_cast<int>(cudaGetLastError());
}
