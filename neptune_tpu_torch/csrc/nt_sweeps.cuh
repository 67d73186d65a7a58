// Kernel C, stencil_sweeps: kDepth sweeps of one unary apply per pass over
// device memory.
//
// Replaces the three temporal-blocking TPU kernels of the JAX package:
//   neptune_tpu/lowering/pallas_multisweep.py::execute_sweeps_resident (grid in VMEM)
//   neptune_tpu/lowering/pallas_multisweep.py::_sweeps_window_impl     (dim-0 slabs)
//   neptune_tpu/lowering/pallas_multisweep.py::_sweeps_window2_impl    (slabs x panels)
// Those differ only in how they stage the grid through VMEM. Here one block
// owns one output tile: it loads the tile with a halo of kDepth * h cells per
// side into shared memory (nt_tile.cuh), runs the sweeps there, one template
// instance per sweep so that each region is a compile-time box, ping-ponging
// between two buffers over a region that shrinks by h per sweep, and writes
// the tile's centre back. Each sweep keeps the apply's copy-through contract
// by global coordinate, the previous sweep's value being the seed, so the
// result is K launches of kernel A, bit for bit.
//
// Bound on the H100: a single sweep is bound by bytes (8 B per cell); here
// the bytes are paid once per kDepth sweeps plus the halo, so the sweeps are
// bound by shared-memory reads and the recomputed halo cells instead
// (sweeps.py plans the tile and the depth so that the recompute stays under
// 2x). Simple first version: no TMA, no overlap of the next tile's load.
//
// The generated source defines a body struct (see nt_apply.cuh) and a plan
//   struct P { using Body; using Tile = NtTile<...>;
//              static constexpr int kDepth, kH0, kH1, kH2; };  // per-sweep halo
// with Tile's halo = kDepth * (kH0, kH1, kH2); then NT_DEFINE_SWEEPS(P).
#pragma once

#include "nt_tile.cuh"

// sweeps T .. kDepth, the tile in cur; then the centre to out. Each sweep
// is its own instance, so its region [T h, W - T h) is a compile-time box.
template <class P, int T>
__device__ __forceinline__ void nt_sweeps_from(const NtGrid& g, const int (&org)[3],
                                               const int* tab, const NtBox& box, float* cur,
                                               float* nxt, const typename P::Body::Scalars& s,
                                               float* __restrict__ out) {
  using B = typename P::Body;
  using Tl = typename P::Tile;
  if constexpr (T > P::kDepth) {
    nt_tile_store<Tl>(g, org, cur, out);
  } else {
    const float* src[1] = {cur};
    nt_tile_apply<Tl, B, B::kPeriodic, 1, T * P::kH0, T * P::kH1, T * P::kH2>(
        g, org, tab, box, src, s, [&](int, int, int, int i, float v) { nxt[i] = v; });
    __syncthreads();
    nt_sweeps_from<P, T + 1>(g, org, tab, box, nxt, cur, s, out);
  }
}

template <class P>
__global__ void __launch_bounds__(kNtTileThreads)
    nt_sweeps_kernel(const NtGrid g, const float* __restrict__ in, float* __restrict__ out,
                     const typename P::Body::Scalars s) {
  using Tl = typename P::Tile;
  constexpr bool kWrap = P::Body::kPeriodic;
  extern __shared__ float nt_smem[];
  int* tab = reinterpret_cast<int*>(nt_smem + 2 * Tl::kCells);
  int org[3];
  nt_tile_origin<Tl>(org);
  const NtBox box{{g.blo[0], g.blo[1], g.blo[2]}, {g.bhi[0], g.bhi[1], g.bhi[2]}};
  if (kWrap) {
    nt_tile_wraps<Tl>(g, org, tab);
    __syncthreads();
  }
  nt_tile_load<Tl, kWrap>(g, org, tab, in, nt_smem);
  __syncthreads();
  nt_sweeps_from<P, 1>(g, org, tab, box, nt_smem, nt_smem + Tl::kCells, s, out);
}

// meta: n[3], lb[3], blo[3], bhi[3]. Returns the launch status.
#define NT_DEFINE_SWEEPS(P)                                                           \
  extern "C" int nt_sweeps(int device, const void* in, void* out, const double* scalars, \
                           const int* meta, void* stream) {                           \
    cudaError_t err = cudaSetDevice(device);                                          \
    if (err != cudaSuccess) return (int)err;                                          \
    NtGrid g;                                                                         \
    for (int d = 0; d < 3; ++d) {                                                     \
      g.n[d] = meta[d];                                                               \
      g.lb[d] = meta[3 + d];                                                          \
      g.blo[d] = meta[6 + d];                                                         \
      g.bhi[d] = meta[9 + d];                                                         \
    }                                                                                 \
    using Tl = P::Tile;                                                               \
    const int smem = (2 * Tl::kCells + Tl::kTab) * 4;                                 \
    err = cudaFuncSetAttribute(nt_sweeps_kernel<P>,                                   \
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);    \
    if (err != cudaSuccess) return (int)err;                                          \
    const dim3 block(kNtTileThreads);                                                 \
    const dim3 grid((g.n[2] + Tl::T2 - 1) / Tl::T2, (g.n[1] + Tl::T1 - 1) / Tl::T1,   \
                    (g.n[0] + Tl::T0 - 1) / Tl::T0);                                  \
    nt_sweeps_kernel<P><<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(    \
        g, static_cast<const float*>(in), static_cast<float*>(out),                   \
        P::Body::load(scalars));                                                      \
    return (int)cudaGetLastError();                                                   \
  }
