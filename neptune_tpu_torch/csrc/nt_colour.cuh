// Kernel A's colour form: one pass of a multicolour Gauss-Seidel sweep, in
// place, over the cells of one colour only.
//
// The apply it runs is a colour pass (passes/smoother.py, marked
// `colour = "parity"`): y = where(colour(index) == c, x + d (b - A x), x),
// x its first input, with a cell's colour the parity of its index along each
// dim from the apply's lower bound. It replaces no TPU kernel: the JAX package
// has no multicolour smoother. Kernel A's tiled design runs the same apply out
// of place, reading x, b and 1/diag and writing y over the whole grid, four
// grids to change one colour's cells (an eighth of them in rank 3). Bound on
// the H100: bytes. No two cells of one colour are coupled (the operator reaches
// one cell along each dim), so the pass needs only:
//   * x read whole, for the neighbours;
//   * b and 1/diag read at the colour's cells, each once;
//   * x written at the colour's cells, in place.
// Counted in 32-byte sectors that is ~1.75 grids in rank 3: x whole, and a
// quarter of the rows of b, 1/diag and x (every other element of them).
//
// The design:
//   * a block owns kD colour planes x kT1 colour rows x kT2 colour columns,
//     each 2 cells apart in the grid (a rank-2 grid is one plane, kH0 = 0);
//   * it stages x once, with a halo of one cell, in shared memory with
//     16-byte cp.async copies: (2kD + 1) x (2kT1 + 1) x (2kT2 + kVec) cells
//     whose column range starts on a whole vector. That region holds no
//     colour cell of another block except in the columns added to make whole
//     vectors, which the block never reads, so the in-place writes of the
//     other blocks cannot change what the block reads;
//   * each thread reads b and 1/diag of its cells from global memory before
//     the barrier (each is used once), evaluates the apply's generated body
//     B::eval at its cells only (kD planes x a strip of kR rows of one colour
//     column), and writes x there. Every other cell, the copy-through ring
//     included, is left as it is;
//   * blocks whose staged region lies in the grid and whose cells are all
//     the colour's run the unchecked instance; edge blocks fill off-grid
//     cells with zeros and skip cells past the colour's count.
// The body is the apply's own, built with --fmad=false, so x at the colour's
// cells is bitwise the out-of-place pass; elsewhere x is untouched, as the
// out-of-place pass copies it.
//
// The generated source defines the body struct B (see nt_apply.cuh) and a
// plan struct P (kT1, kT2, kR, kD, kH0), then NT_DEFINE_APPLY_COLOUR(B, P).
#pragma once

#include "nt_apply.cuh"

// The colour's cells, per dim (rank-3 padded): the first one's grid index
// and their count inside the apply's bounds.
struct NtColour {
  int first[3];
  int count[3];
};

template <class B, class P>
struct NtColourGeom {
  using T = typename B::T;
  static constexpr int kVec = 16 / (int)sizeof(T);
  static constexpr int kS0 = P::kH0 ? 2 : 1;  // grid planes between colour planes
  static constexpr int kPlanes = kS0 * (P::kD - 1) + 1 + 2 * P::kH0;
  static constexpr int kW1 = 2 * P::kT1 + 1;
  static constexpr int kW2 = 2 * P::kT2 + kVec;
  static constexpr int kPlane = kW1 * kW2;
  static constexpr int kThreads = P::kT2 * (P::kT1 / P::kR);
  static constexpr int kSmem = kPlanes * kPlane * (int)sizeof(T);
  static_assert(P::kT2 % 32 == 0 && P::kT1 % P::kR == 0, "tile: whole warps, whole strips");
  static_assert(P::kH0 == 1 || P::kD == 1, "a rank-2 grid is one plane");
};

// What the generated body sees: x staged in the tile, input k > 0 at the
// cell itself (the only place a colour pass reads it), read ahead.
template <class B, class P>
struct NtColourAcc {
  using Gm = NtColourGeom<B, P>;
  using V = typename NtArith<typename B::T>::type;
  const typename B::T* sm;
  int i;
  int c0, c1, c2;  // logical coordinates, for the colour test
  V at[B::kIn > 1 ? B::kIn - 1 : 1];
  __device__ __forceinline__ V ld(int k, int o0, int o1, int o2) const {
    return k == 0 ? nt_f(sm[i + o0 * Gm::kPlane + o1 * Gm::kW2 + o2]) : at[k - 1];
  }
};

template <class B, class P, class Idx, bool CHECKED>
__device__ __forceinline__ void nt_colour_block(const NtGrid& g, const NtApplyPtrs<B>& p,
                                                const typename B::Scalars& s, const NtColour& c,
                                                typename B::T* sm, const int (&j)[3],
                                                bool vec) {
  using Gm = NtColourGeom<B, P>;
  using T = typename B::T;
  using V = typename NtArith<T>::type;
  // the block's first colour cell and the staged region's origin
  const int z = c.first[0] + Gm::kS0 * j[0], r = c.first[1] + 2 * j[1];
  const int q = c.first[2] + 2 * j[2];
  const int z_lo = z - P::kH0, r_lo = r - 1;
  const int c_lo = q - 1 - nt_wrap(q - 1, Gm::kVec);  // whole vectors
  const int tx = (int)threadIdx.x % P::kT2, ty = (int)threadIdx.x / P::kT2;

  // b and 1/diag at the thread's cells, in flight while x is staged
  V at[P::kD][P::kR][B::kIn > 1 ? B::kIn - 1 : 1];
  bool mine[P::kD][P::kR];
  Idx cell[P::kD][P::kR];
#pragma unroll
  for (int d = 0; d < P::kD; ++d) {
#pragma unroll
    for (int u = 0; u < P::kR; ++u) {
      const int row = ty * P::kR + u;
      mine[d][u] = !CHECKED || (j[0] + d < c.count[0] && j[1] + row < c.count[1] &&
                                j[2] + tx < c.count[2]);
      cell[d][u] = mine[d][u] ? ((Idx)(z + Gm::kS0 * d) * g.n[1] + (r + 2 * row)) *
                                        (Idx)g.n[2] + q + 2 * tx
                              : 0;
#pragma unroll
      for (int k = 1; k < B::kIn; ++k)
        at[d][u][k - 1] = mine[d][u] ? nt_f(p.in[k][cell[d][u]]) : V(0);
    }
  }

  // x: the staged planes, rows and columns, zeros off the grid (checked)
  const T* x = p.in[0];
  if (vec) {
    constexpr int kChunks = Gm::kW2 / Gm::kVec, kPer = Gm::kW1 * kChunks;
    for (int e = (int)threadIdx.x; e < Gm::kPlanes * kPer; e += Gm::kThreads) {
      const int pl = e / kPer, rc = e - pl * kPer;
      const int row = rc / kChunks, col = (rc - row * kChunks) * Gm::kVec;
      const int w0 = z_lo + pl, w1 = r_lo + row, w2 = c_lo + col;
      T* dst = sm + pl * Gm::kPlane + row * Gm::kW2 + col;
      if (!CHECKED || nt_in_grid(g.n, w0, w1, w2))
        nt_cp_async16(dst, x + ((Idx)w0 * g.n[1] + w1) * (Idx)g.n[2] + w2);
      else
        *reinterpret_cast<int4*>(dst) = make_int4(0, 0, 0, 0);
    }
  } else {
    for (int e = (int)threadIdx.x; e < Gm::kPlanes * Gm::kPlane; e += Gm::kThreads) {
      const int pl = e / Gm::kPlane, rc = e - pl * Gm::kPlane;
      const int w0 = z_lo + pl, w1 = r_lo + rc / Gm::kW2, w2 = c_lo + rc % Gm::kW2;
      const bool fill = !CHECKED || nt_in_grid(g.n, w0, w1, w2);
      const T* src = fill ? x + ((Idx)w0 * g.n[1] + w1) * (Idx)g.n[2] + w2 : x;
      if constexpr (sizeof(T) == 8)
        nt_cp_async8(sm + e, src, fill);
      else if constexpr (sizeof(T) == 4)
        nt_cp_async4(sm + e, src, fill);
      else
        sm[e] = fill ? *src : nt_cast<T>(0.0f);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // the body at the thread's cells, then x there
  V y[P::kD][P::kR][B::kOut];
#pragma unroll
  for (int d = 0; d < P::kD; ++d) {
#pragma unroll
    for (int u = 0; u < P::kR; ++u) {
      if (!mine[d][u]) continue;
      const int row = ty * P::kR + u;
      NtColourAcc<B, P> a{sm,
                          (P::kH0 + Gm::kS0 * d) * Gm::kPlane + (1 + 2 * row) * Gm::kW2 +
                              (q - c_lo) + 2 * tx,
                          z + Gm::kS0 * d + g.lb[0], r + 2 * row + g.lb[1], q + 2 * tx + g.lb[2]};
#pragma unroll
      for (int k = 1; k < B::kIn; ++k) a.at[k - 1] = at[d][u][k - 1];
      B::eval(a, s, y[d][u]);
    }
  }
#pragma unroll
  for (int d = 0; d < P::kD; ++d) {
#pragma unroll
    for (int u = 0; u < P::kR; ++u)
      if (mine[d][u]) p.out[0][cell[d][u]] = nt_out<T>(y[d][u][0]);
  }
}

template <class B, class P, class Idx>
__global__ void __launch_bounds__(NtColourGeom<B, P>::kThreads)
    nt_apply_colour_kernel(const NtGrid g, const NtApplyPtrs<B> p, const typename B::Scalars s,
                           const NtColour c, int vec) {
  extern __shared__ __align__(16) unsigned char nt_colour_smem[];
  auto* sm = reinterpret_cast<typename B::T*>(nt_colour_smem);
  using Gm = NtColourGeom<B, P>;
  // the block's cells, counted in the colour's own cells along each dim
  const int j[3] = {(int)blockIdx.z * P::kD, (int)blockIdx.y * P::kT1,
                    (int)blockIdx.x * P::kT2};
  const int z_lo = c.first[0] + Gm::kS0 * j[0] - P::kH0;
  const int r_lo = c.first[1] + 2 * j[1] - 1;
  const int q = c.first[2] + 2 * j[2];
  const int c_lo = q - 1 - nt_wrap(q - 1, Gm::kVec);
  // every cell of the tile the colour's, the staged region inside the grid
  const bool interior =
      j[0] + P::kD <= c.count[0] && j[1] + P::kT1 <= c.count[1] &&
      j[2] + P::kT2 <= c.count[2] && z_lo >= 0 && z_lo + Gm::kPlanes <= g.n[0] && r_lo >= 0 &&
      r_lo + Gm::kW1 <= g.n[1] && c_lo >= 0 && c_lo + Gm::kW2 <= g.n[2];
  if (interior)
    nt_colour_block<B, P, Idx, false>(g, p, s, c, sm, j, vec != 0);
  else
    nt_colour_block<B, P, Idx, true>(g, p, s, c, sm, j, vec != 0);
}

// sized: as nt_apply_tiled_launch's.
template <class B, class P, class Idx>
__host__ int nt_apply_colour_launch(bool& sized, const NtGrid& g, const NtApplyPtrs<B>& p,
                                    const double* scalars, const NtColour& c, int vec,
                                    cudaStream_t stream) {
  using Gm = NtColourGeom<B, P>;
  if (!sized) {
    const cudaError_t err =
        cudaFuncSetAttribute(nt_apply_colour_kernel<B, P, Idx>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, Gm::kSmem);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  const dim3 grid((c.count[2] + P::kT2 - 1) / P::kT2, (c.count[1] + P::kT1 - 1) / P::kT1,
                  (c.count[0] + P::kD - 1) / P::kD);
  nt_apply_colour_kernel<B, P, Idx><<<grid, Gm::kThreads, Gm::kSmem, stream>>>(
      g, p, B::load(scalars), c, vec);
  return (int)cudaGetLastError();
}

// in_ptrs: x, then the other inputs; x is also the output. meta: the grid's
// (n, lb, blo, bhi), then the colour's first cells and counts. Returns the
// launch status; a colour with no cell launches nothing.
#define NT_DEFINE_APPLY_COLOUR(B, P)                                                  \
  static_assert(B::kIn >= 1 && B::kOut == 1 && !B::kPeriodic,                         \
                "a colour pass: x first, one result, bounded");                       \
  extern "C" int nt_apply_colour(int device, const void* const* in_ptrs,              \
                                 const double* scalars, const int* meta, void* stream) { \
    cudaError_t err = cudaSetDevice(device);                                          \
    if (err != cudaSuccess) return (int)err;                                          \
    const NtGrid g = nt_grid_from_meta(meta);                                         \
    void* const out_ptrs[1] = {const_cast<void*>(in_ptrs[0])};                        \
    const NtApplyPtrs<B> p = nt_apply_ptrs<B>(in_ptrs, out_ptrs);                     \
    NtColour c;                                                                       \
    for (int d = 0; d < 3; ++d) {                                                     \
      c.first[d] = meta[12 + d];                                                      \
      c.count[d] = meta[15 + d];                                                      \
      if (c.count[d] <= 0) return 0;                                                  \
    }                                                                                 \
    const int vec = g.n[2] % NtColourGeom<B, P>::kVec == 0 &&                         \
                    (reinterpret_cast<uintptr_t>(p.in[0]) & 15) == 0;                 \
    const long long cells = (long long)g.n[0] * g.n[1] * g.n[2];                      \
    const cudaStream_t st = static_cast<cudaStream_t>(stream);                        \
    static bool sized[64][2] = {};                                                    \
    if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;               \
    return cells < (1ll << 31)                                                        \
               ? nt_apply_colour_launch<B, P, int>(sized[device][0], g, p, scalars, c, vec, st) \
               : nt_apply_colour_launch<B, P, long long>(sized[device][1], g, p, scalars, c,  \
                                                         vec, st);                     \
  }
