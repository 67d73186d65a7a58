// Kernel A, stencil_apply: one `neptune.apply` over a rank-2 or rank-3 grid.
//
// Replaces the three TPU apply kernels of the JAX package:
//   neptune_tpu/lowering/pallas_backend.py::_execute            (multi-copy slabs)
//   neptune_tpu/lowering/pallas_backend.py::_execute_dma_rank3  (ring window, rank 3)
//   neptune_tpu/lowering/pallas_backend.py::_execute_dma_rank2  (ring window, wide h0)
// and, with other launch data, execute_apply_window (the window form).
//
// Bound on the H100: bytes. A 5-pt f32 apply moves at least 8 B per cell
// (one read, one write); its few flops per cell are far below the ridge.
// What kept the first design (one thread per cell, every neighbour read from
// global memory through nt_ld) at half the copy rate was instructions and
// latency, not bytes. The tiled design:
//   * a block owns an output tile of kT1 x kT2 cells of each of kD planes
//     along dim 0 (a rank-2 grid is one plane, (1, n0, n1)); the tile's
//     planes and kH0 more on each side, each with a halo of kH1 rows and
//     kH2P >= kH2 columns, are staged once in shared memory, so a neighbour
//     is fetched from device memory once per block, not per read (marching
//     along dim 0 with a ring of planes loaded ahead timed slower on the
//     H100 at 256^3: too little work per step between barriers);
//   * the loads are 16-byte cp.async copies wherever the rows are whole
//     vectors and the inputs aligned, all in flight at once; edge tiles
//     wrap or zero whole vectors;
//   * a block whose tile and halo lie inside the grid and whose cells lie
//     inside the apply's bounds runs the unchecked instance: no grid or bounds
//     test per cell and none per read. Edge blocks run the checked instance,
//     which fills the tile once, with zeros off the grid or the wrapped cells
//     of a periodic apply, and then reads it as freely;
//   * each thread computes a strip of kR cells down dim 1 of one column, so
//     the vertical neighbours of the strip are read once from shared memory
//     (the unrolled strip's repeated reads are plain shared loads at constant
//     offsets, which the compiler shares);
//   * offsets are 32-bit where the grid has fewer than 2^31 cells.
// The generated body is the same for both designs, and the build keeps
// --fmad=false, so f32 and f64 results are bitwise those of eager PyTorch.
// An f64 apply is the same code over 8-byte elements: twice the bytes a
// cell, 2 elements a 16-byte copy, and a body computing in double
// (NtArith); the plan sizes its tile from the element size.
//
// The generated source defines a body struct B:
//   using T = float | __nv_bfloat16 | double;  element type of inputs and outputs
//   static constexpr int kIn, kOut;        tensor inputs, results
//   static constexpr bool kPeriodic;
//   struct Scalars {...}; static Scalars load(const double* v);
//   template <class A, class S>
//   static __device__ void eval(const A& a, const S& s, V* y);
// (V = NtArith<T>::type, double for f64 and float otherwise)
// where `a` is an accessor (NtGlobalAcc, NtApplyAcc) and `s` the Scalars;
// then either a plan struct P (kT1, kT2, kR, kD, kH0, kH1, kH2) and
// NT_DEFINE_APPLY_TILED(B, P), or, for an apply whose halo makes the tile
// too large for shared memory, NT_DEFINE_APPLY(B): the first design.
#pragma once

#include <stdint.h>

#include "nt_common.cuh"

template <class B>
struct NtApplyPtrs {
  const typename B::T* in[B::kIn > 0 ? B::kIn : 1];
  typename B::T* out[B::kOut];
};

// ---- the first design: one thread per cell, reads from global memory ------

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
        typename NtArith<T>::type y[B::kOut];
        const NtGlobalAcc<B::kPeriodic, T> a{&g, p.in, i0, i1, i2,
                                             i0 + g.lb[0], i1 + g.lb[1], i2 + g.lb[2]};
        B::eval(a, s, y);
#pragma unroll
        for (int j = 0; j < B::kOut; ++j) p.out[j][idx] = nt_out<T>(y[j]);
      } else {
        // copy-through: output j keeps input j (zeros when there is none)
#pragma unroll
        for (int j = 0; j < B::kOut; ++j)
          p.out[j][idx] = j < B::kIn ? p.in[j][idx] : nt_cast<T>(0.0f);
      }
    }
  }
}

// meta: n[3], lb[3], blo[3], bhi[3]
__host__ __forceinline__ NtGrid nt_grid_from_meta(const int* meta) {
  NtGrid g;
  for (int d = 0; d < 3; ++d) {
    g.n[d] = meta[d];
    g.lb[d] = meta[3 + d];
    g.blo[d] = meta[6 + d];
    g.bhi[d] = meta[9 + d];
  }
  return g;
}

template <class B>
__host__ __forceinline__ NtApplyPtrs<B> nt_apply_ptrs(const void* const* in_ptrs,
                                                     void* const* out_ptrs) {
  NtApplyPtrs<B> p;
  for (int k = 0; k < B::kIn; ++k) p.in[k] = static_cast<const typename B::T*>(in_ptrs[k]);
  for (int j = 0; j < B::kOut; ++j) p.out[j] = static_cast<typename B::T*>(out_ptrs[j]);
  return p;
}

// Returns the launch status.
#define NT_DEFINE_APPLY(B)                                                          \
  extern "C" int nt_apply(int device, const void* const* in_ptrs,                   \
                          void* const* out_ptrs, const double* scalars,             \
                          const int* meta, void* stream) {                          \
    cudaError_t err = cudaSetDevice(device);                                        \
    if (err != cudaSuccess) return (int)err;                                        \
    const NtGrid g = nt_grid_from_meta(meta);                                       \
    const NtApplyPtrs<B> p = nt_apply_ptrs<B>(in_ptrs, out_ptrs);                   \
    const dim3 block(kNtApplyThreads);                                              \
    const dim3 grid((g.n[2] + kNtApplyThreads - 1) / kNtApplyThreads,               \
                    g.n[1] < 65535 ? g.n[1] : 65535, g.n[0] < 65535 ? g.n[0] : 65535); \
    nt_apply_kernel<B><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(      \
        g, p, B::load(scalars));                                                    \
    return (int)cudaGetLastError();                                                 \
  }

// ---- the tiled design -------------------------------------------------------

// The tile geometry of body B under plan P.
template <class B, class P>
struct NtApplyGeom {
  using T = typename B::T;
  static constexpr int kVec = 16 / (int)sizeof(T);               // elements per 16 B
  static constexpr int kH2P = (P::kH2 + kVec - 1) / kVec * kVec;  // column halo, whole vectors
  static constexpr int kW1 = P::kT1 + 2 * P::kH1;
  static constexpr int kW2 = P::kT2 + 2 * kH2P;
  static constexpr int kPlane = kW1 * kW2;
  static constexpr int kPlanes = P::kD + 2 * P::kH0;
  static constexpr int kThreads = P::kT2 * (P::kT1 / P::kR);
  static constexpr int kSmem = B::kIn * kPlanes * kPlane * (int)sizeof(T);
  static_assert(P::kT2 % 32 == 0 && P::kT1 % P::kR == 0, "tile: whole warps, whole strips");
};

// What a generated body sees of the staged tile: input k at an offset from
// the cell, i its position in the tile's planes (plane z - z0 + kH0 holds
// grid plane z).
template <class B, class P>
struct NtApplyAcc {
  using Gm = NtApplyGeom<B, P>;
  const typename B::T* sm;
  int i;
  int c0, c1, c2;  // logical coordinates, for index() bodies
  __device__ __forceinline__ typename NtArith<typename B::T>::type ld(int k, int o0, int o1,
                                                                      int o2) const {
    return nt_f(sm[k * Gm::kPlanes * Gm::kPlane + i + o0 * Gm::kPlane + o1 * Gm::kW2 + o2]);
  }
};

// i mod n, with the modulo only for i off [0, n)
__device__ __forceinline__ int nt_wrap_near(int i, int n) {
  return (unsigned)i < (unsigned)n ? i : nt_wrap(i, n);
}

// Where input k's cell (w0, w1, w2) of a staged plane comes from: the cell
// itself, its wrapped cell on a periodic apply, or nowhere (fill false: the
// tile holds 0 there) off the grid of a bounded one.
template <class B, class P, class Idx, bool CHECKED>
__device__ __forceinline__ const typename B::T* nt_apply_src(const NtGrid& g,
                                                            const NtApplyPtrs<B>& p, int k,
                                                            int w0, int w1, int w2, bool& fill) {
  if (CHECKED && B::kPeriodic) {
    w0 = nt_wrap_near(w0, g.n[0]);
    w1 = nt_wrap_near(w1, g.n[1]);
    w2 = nt_wrap_near(w2, g.n[2]);
  }
  fill = !CHECKED || B::kPeriodic || nt_in_grid(g.n, w0, w1, w2);
  return fill ? p.in[k] + ((Idx)w0 * g.n[1] + w1) * (Idx)g.n[2] + w2 : p.in[k];
}

// Plane q (a grid index along dim 0, possibly off the grid) of every input
// into staged plane `slot`, zero off the grid or the wrapped cell on a
// periodic apply (checked). With `vec`, in 16-byte cp.async copies; otherwise
// element by element (asynchronous for f32 and f64).
template <class B, class P, class Idx, bool CHECKED>
__device__ __forceinline__ void nt_apply_load_plane(const NtGrid& g, const NtApplyPtrs<B>& p,
                                                    typename B::T* sm, int slot, int q,
                                                    int org1, int org2, bool vec) {
  using Gm = NtApplyGeom<B, P>;
  using T = typename B::T;
  const int r0 = org1 - P::kH1, c0 = org2 - Gm::kH2P;
  if (vec) {
    // c0 and n2 are whole vectors, so a vector lies on the grid or off it
    // whole, and wraps whole
    constexpr int kChunks = Gm::kW2 / Gm::kVec, kPer = Gm::kW1 * kChunks;
    for (int j = (int)threadIdx.x; j < B::kIn * kPer; j += Gm::kThreads) {
      const int k = j / kPer, rc = j - k * kPer;
      const int r = rc / kChunks, c = (rc - r * kChunks) * Gm::kVec;
      int w0 = q, w1 = r0 + r, w2 = c0 + c;
      bool fill = true;
      if (CHECKED && B::kPeriodic) {
        w0 = nt_wrap_near(w0, g.n[0]);
        w1 = nt_wrap_near(w1, g.n[1]);
        w2 = nt_wrap_near(w2, g.n[2]);
      } else if (CHECKED) {
        fill = nt_in_grid(g.n, w0, w1, w2);
      }
      T* dst = sm + (k * Gm::kPlanes + slot) * Gm::kPlane + r * Gm::kW2 + c;
      if (fill)
        nt_cp_async16(dst, p.in[k] + ((Idx)w0 * g.n[1] + w1) * (Idx)g.n[2] + w2);
      else
        *reinterpret_cast<int4*>(dst) = make_int4(0, 0, 0, 0);
    }
    return;
  }
  constexpr int kPer = Gm::kPlane, kTotal = B::kIn * kPer;
  if constexpr (sizeof(T) == 4 || sizeof(T) == 8) {
    for (int j = (int)threadIdx.x; j < kTotal; j += Gm::kThreads) {
      const int k = j / kPer, rc = j - k * kPer;
      bool fill;
      const T* src = nt_apply_src<B, P, Idx, CHECKED>(g, p, k, q, r0 + rc / Gm::kW2,
                                                      c0 + rc % Gm::kW2, fill);
      if constexpr (sizeof(T) == 4)
        nt_cp_async4(sm + (k * Gm::kPlanes + slot) * Gm::kPlane + rc, src, fill);
      else
        nt_cp_async8(sm + (k * Gm::kPlanes + slot) * Gm::kPlane + rc, src, fill);
    }
  } else {
    // bf16 has no 2-byte cp.async: kBatch loads per thread are issued
    // before the first store
    constexpr int kBatch = 4;
    for (int j0 = (int)threadIdx.x; j0 < kTotal; j0 += kBatch * Gm::kThreads) {
      T v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int j = j0 + u * Gm::kThreads;
        if (j >= kTotal) continue;
        const int k = j / kPer, rc = j - k * kPer;
        bool fill;
        const T* src = nt_apply_src<B, P, Idx, CHECKED>(g, p, k, q, r0 + rc / Gm::kW2,
                                                        c0 + rc % Gm::kW2, fill);
        v[u] = fill ? *src : nt_cast<T>(0.0f);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int j = j0 + u * Gm::kThreads;
        if (j < kTotal) sm[(j / kPer * Gm::kPlanes + slot) * Gm::kPlane + j % kPer] = v[u];
      }
    }
  }
}

// Output plane z of the tile: each thread its strip of kR cells down dim 1.
template <class B, class P, class Idx, bool CHECKED>
__device__ __forceinline__ void nt_apply_plane(const NtGrid& g, const NtApplyPtrs<B>& p,
                                               const typename B::Scalars& s,
                                               const typename B::T* sm, int first, int z,
                                               int org1, int org2) {
  using Gm = NtApplyGeom<B, P>;
  using T = typename B::T;
  const int at = (z - first) * Gm::kPlane;  // the cell's plane in the tile
  const int tx = (int)threadIdx.x % P::kT2, ty = (int)threadIdx.x / P::kT2;
  const int q2 = org2 + tx;
  typename NtArith<T>::type y[P::kR][B::kOut];
#pragma unroll
  for (int r = 0; r < P::kR; ++r) {
    const int row = ty * P::kR + r, q1 = org1 + row;
    const int i = at + (row + P::kH1) * Gm::kW2 + Gm::kH2P + tx;
    if (!CHECKED || nt_in_bounds(g, z, q1, q2)) {
      const NtApplyAcc<B, P> a{sm, i, z + g.lb[0], q1 + g.lb[1], q2 + g.lb[2]};
      B::eval(a, s, y[r]);
    } else {
      // copy-through: output j keeps input j (zeros when there is none)
#pragma unroll
      for (int j = 0; j < B::kOut; ++j)
        y[r][j] = j < B::kIn ? nt_f(sm[j * Gm::kPlanes * Gm::kPlane + i]) : 0.0f;
    }
  }
#pragma unroll
  for (int r = 0; r < P::kR; ++r) {
    const int q1 = org1 + ty * P::kR + r;
    if (CHECKED && (q1 >= g.n[1] || q2 >= g.n[2])) continue;
    const Idx cell = ((Idx)z * g.n[1] + q1) * (Idx)g.n[2] + q2;
#pragma unroll
    for (int j = 0; j < B::kOut; ++j) p.out[j][cell] = nt_out<T>(y[r][j]);
  }
}

// One block: output planes [z0, z1) of the tile at (org1, org2).
template <class B, class P, class Idx, bool CHECKED>
__device__ __forceinline__ void nt_apply_block(const NtGrid& g, const NtApplyPtrs<B>& p,
                                               const typename B::Scalars& s, typename B::T* sm,
                                               int z0, int z1, int org1, int org2, bool vec) {
  constexpr int H0 = P::kH0;
  const int first = z0 - H0;  // the first plane read, staged plane 0
  for (int q = first; q < z1 + H0; ++q)
    nt_apply_load_plane<B, P, Idx, CHECKED>(g, p, sm, q - first, q, org1, org2, vec);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  for (int z = z0; z < z1; ++z)
    nt_apply_plane<B, P, Idx, CHECKED>(g, p, s, sm, first, z, org1, org2);
}

template <class B, class P, class Idx>
__global__ void __launch_bounds__(NtApplyGeom<B, P>::kThreads)
    nt_apply_tiled_kernel(const NtGrid g, const NtApplyPtrs<B> p, const typename B::Scalars s,
                          int vec) {
  extern __shared__ __align__(16) unsigned char nt_apply_smem[];
  auto* sm = reinterpret_cast<typename B::T*>(nt_apply_smem);
  using Gm = NtApplyGeom<B, P>;
  const int z0 = (int)blockIdx.z * P::kD;
  const int z1 = nt_min(z0 + P::kD, g.n[0]);
  const int org1 = (int)blockIdx.y * P::kT1, org2 = (int)blockIdx.x * P::kT2;
  // the tile and its halo inside the grid, its cells inside the bounds
  const bool interior =
      z0 - P::kH0 >= 0 && z1 + P::kH0 <= g.n[0] && org1 - P::kH1 >= 0 &&
      org1 + P::kT1 + P::kH1 <= g.n[1] && org2 - Gm::kH2P >= 0 &&
      org2 + P::kT2 + Gm::kH2P <= g.n[2] && z0 >= g.blo[0] && z1 <= g.bhi[0] &&
      org1 >= g.blo[1] && org1 + P::kT1 <= g.bhi[1] && org2 >= g.blo[2] &&
      org2 + P::kT2 <= g.bhi[2];
  if (interior)
    nt_apply_block<B, P, Idx, false>(g, p, s, sm, z0, z1, org1, org2, vec != 0);
  else
    nt_apply_block<B, P, Idx, true>(g, p, s, sm, z0, z1, org1, org2, vec != 0);
}

// sized: whether this library has set the kernel's shared-memory attribute
// on the device. It lives in the library's C entry: a static of this
// template would be one object for every library that instantiates the same
// names (GNU unique symbols), whatever their plans.
template <class B, class P, class Idx>
__host__ int nt_apply_tiled_launch(bool& sized, const NtGrid& g, const NtApplyPtrs<B>& p,
                                   const double* scalars, int vec, cudaStream_t stream) {
  using Gm = NtApplyGeom<B, P>;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        nt_apply_tiled_kernel<B, P, Idx>, cudaFuncAttributeMaxDynamicSharedMemorySize, Gm::kSmem);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  const dim3 grid((g.n[2] + P::kT2 - 1) / P::kT2, (g.n[1] + P::kT1 - 1) / P::kT1,
                  (g.n[0] + P::kD - 1) / P::kD);
  nt_apply_tiled_kernel<B, P, Idx><<<grid, Gm::kThreads, Gm::kSmem, stream>>>(
      g, p, B::load(scalars), vec);
  return (int)cudaGetLastError();
}

// vec: 16-byte loads are allowed (every input 16-byte aligned and rows a
// whole number of 16-byte vectors), decided here from the pointers and n2.
#define NT_DEFINE_APPLY_TILED(B, P)                                                   \
  extern "C" int nt_apply(int device, const void* const* in_ptrs,                     \
                          void* const* out_ptrs, const double* scalars,               \
                          const int* meta, void* stream) {                            \
    cudaError_t err = cudaSetDevice(device);                                          \
    if (err != cudaSuccess) return (int)err;                                          \
    const NtGrid g = nt_grid_from_meta(meta);                                         \
    const NtApplyPtrs<B> p = nt_apply_ptrs<B>(in_ptrs, out_ptrs);                     \
    int vec = g.n[2] % NtApplyGeom<B, P>::kVec == 0;                                  \
    for (int k = 0; k < B::kIn; ++k)                                                  \
      vec &= (reinterpret_cast<uintptr_t>(p.in[k]) & 15) == 0;                        \
    const long long cells = (long long)g.n[0] * g.n[1] * g.n[2];                      \
    const cudaStream_t st = static_cast<cudaStream_t>(stream);                        \
    static bool sized[64][2] = {};                                                    \
    if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;               \
    return cells < (1ll << 31)                                                        \
               ? nt_apply_tiled_launch<B, P, int>(sized[device][0], g, p, scalars, vec, st) \
               : nt_apply_tiled_launch<B, P, long long>(sized[device][1], g, p, scalars, vec, st); \
  }
