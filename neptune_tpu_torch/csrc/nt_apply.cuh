// Kernel A, stencil_apply: one `neptune.apply` over a rank-2 or rank-3 grid.
//
// Replaces the three TPU apply kernels of the JAX package:
//   neptune_tpu/lowering/pallas_backend.py::_execute            (multi-copy slabs)
//   neptune_tpu/lowering/pallas_backend.py::_execute_dma_rank3  (ring window, rank 3)
//   neptune_tpu/lowering/pallas_backend.py::_execute_dma_rank2  (ring window, wide h0)
// Those differ only in how they stage dim-0 halos through VMEM. Hopper has no
// such constraint here: one thread computes one output cell and reads its
// neighbours straight from global memory (L1/L2 catch the reuse).
//
// Bound on the H100: bytes. A 5-pt f32 apply moves at least 8 B per cell
// (one read, one write); its few flops per cell are far below the ridge.
// This first version is deliberately simple -- no shared-memory tiling, no
// TMA, no vectorized loads; those are later work.
//
// The generated source defines a body struct B and ends with
// NT_DEFINE_APPLY(B):
//   using T = float | __nv_bfloat16;       element type of inputs and outputs
//   static constexpr int kIn, kOut;        tensor inputs, results
//   static constexpr bool kPeriodic;
//   struct Scalars {...}; static Scalars load(const double* v);
//   template <class A, class S>
//   static __device__ void eval(const A& a, const S& s, float* y);
// where `a` is an NtGlobalAcc (nt_common.cuh) and `s` the Scalars.
#pragma once

#include "nt_common.cuh"

template <class B>
struct NtApplyPtrs {
  const typename B::T* in[B::kIn > 0 ? B::kIn : 1];
  typename B::T* out[B::kOut];
};

constexpr int kNtApplyThreads = 256;

template <class B>
__global__ void __launch_bounds__(kNtApplyThreads)
    nt_apply_kernel(const NtGrid g, const NtApplyPtrs<B> p, const typename B::Scalars s) {
  using T = typename B::T;
  const int i2 = blockIdx.x * blockDim.x + threadIdx.x;
  if (i2 >= g.n[2]) return;
  for (int i0 = blockIdx.z; i0 < g.n[0]; i0 += gridDim.z) {
    for (int i1 = blockIdx.y; i1 < g.n[1]; i1 += gridDim.y) {
      const long long idx = nt_index(g, i0, i1, i2);
      if (nt_in_bounds(g, i0, i1, i2)) {
        float y[B::kOut];
        const NtGlobalAcc<B::kPeriodic, T> a{&g, p.in, i0, i1, i2,
                                             i0 + g.lb[0], i1 + g.lb[1], i2 + g.lb[2]};
        B::eval(a, s, y);
#pragma unroll
        for (int j = 0; j < B::kOut; ++j) p.out[j][idx] = nt_cast<T>(y[j]);
      } else {
        // copy-through: output j keeps input j (zeros when there is none)
#pragma unroll
        for (int j = 0; j < B::kOut; ++j)
          p.out[j][idx] = j < B::kIn ? p.in[j][idx] : nt_cast<T>(0.0f);
      }
    }
  }
}

// meta: n[3], lb[3], blo[3], bhi[3]. Returns the launch status.
#define NT_DEFINE_APPLY(B)                                                          \
  extern "C" int nt_apply(int device, const void* const* in_ptrs,                   \
                          void* const* out_ptrs, const double* scalars,             \
                          const int* meta, void* stream) {                          \
    cudaError_t err = cudaSetDevice(device);                                        \
    if (err != cudaSuccess) return (int)err;                                        \
    NtGrid g;                                                                       \
    for (int d = 0; d < 3; ++d) {                                                   \
      g.n[d] = meta[d];                                                             \
      g.lb[d] = meta[3 + d];                                                        \
      g.blo[d] = meta[6 + d];                                                       \
      g.bhi[d] = meta[9 + d];                                                       \
    }                                                                               \
    NtApplyPtrs<B> p;                                                               \
    for (int k = 0; k < B::kIn; ++k)                                                \
      p.in[k] = static_cast<const B::T*>(in_ptrs[k]);                               \
    for (int j = 0; j < B::kOut; ++j) p.out[j] = static_cast<B::T*>(out_ptrs[j]);   \
    const dim3 block(kNtApplyThreads);                                              \
    const dim3 grid((g.n[2] + kNtApplyThreads - 1) / kNtApplyThreads,               \
                    g.n[1] < 65535 ? g.n[1] : 65535, g.n[0] < 65535 ? g.n[0] : 65535); \
    nt_apply_kernel<B><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(      \
        g, p, B::load(scalars));                                                    \
    return (int)cudaGetLastError();                                                 \
  }
