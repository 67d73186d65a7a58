// Shared device code for the generated Hopper kernels of neptune_tpu_torch.
//
// The kernel generator (neptune_tpu_torch/kernels/codegen.py) emits only the
// per-operator scalar body from the IR; indexing, neighbour reads with the
// zero-fill / periodic rule, the copy-through mask and the element
// conversions live here. Every grid is addressed as rank 3, (n0, n1, n2) in
// C order; a rank-2 grid is (1, n0, n1).
//
// Arithmetic: bodies compute in f32. A bf16 body rounds to bf16 after every
// operation (nt_bf), as PyTorch's eager bf16 does. The build passes
// --fmad=false, so no multiply-add is contracted and an f32 body is bitwise
// equal to the eager PyTorch version of the same IR.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

struct NtGrid {
  int n[3];    // extents, C order
  int lb[3];   // logical coordinate of physical index 0 (for index values)
  int blo[3];  // apply bounds, physical: cells with blo <= i < bhi compute,
  int bhi[3];  // the rest copy their seed through
};

__device__ __forceinline__ float nt_f(float v) { return v; }
__device__ __forceinline__ float nt_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <class T>
__device__ __forceinline__ T nt_cast(float v);
template <>
__device__ __forceinline__ float nt_cast<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 nt_cast<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// round an f32 result to the nearest bf16 (one eager bf16 operation)
__device__ __forceinline__ float nt_bf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ int nt_wrap(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

__device__ __forceinline__ long long nt_index(const NtGrid& g, int i0, int i1, int i2) {
  return ((long long)i0 * g.n[1] + i1) * g.n[2] + i2;
}

// a[i + offset]: outside the grid it reads 0, or wraps modulo the extent on
// a periodic apply -- never outside the allocation.
template <bool PERIODIC, class T>
__device__ __forceinline__ float nt_ld(const T* a, const NtGrid& g,
                                       int i0, int i1, int i2) {
  if (PERIODIC) {
    i0 = nt_wrap(i0, g.n[0]);
    i1 = nt_wrap(i1, g.n[1]);
    i2 = nt_wrap(i2, g.n[2]);
  } else if ((unsigned)i0 >= (unsigned)g.n[0] || (unsigned)i1 >= (unsigned)g.n[1] ||
             (unsigned)i2 >= (unsigned)g.n[2]) {
    return 0.0f;
  }
  return nt_f(a[nt_index(g, i0, i1, i2)]);
}

__device__ __forceinline__ bool nt_in_bounds(const NtGrid& g, int i0, int i1, int i2) {
  return i0 >= g.blo[0] && i0 < g.bhi[0] && i1 >= g.blo[1] && i1 < g.bhi[1] &&
         i2 >= g.blo[2] && i2 < g.bhi[2];
}

__device__ __forceinline__ bool nt_in_grid(const int* n, int i0, int i1, int i2) {
  return (unsigned)i0 < (unsigned)n[0] && (unsigned)i1 < (unsigned)n[1] &&
         (unsigned)i2 < (unsigned)n[2];
}

// What a generated body sees of its inputs (kernel A): input k at an
// offset from the cell (i0, i1, i2), read from global memory under nt_ld's
// rule; c0..c2 are the cell's logical coordinates, for index() bodies.
// The generated body calls a.ld(k, o0, o1, o2) and reads a.c0..a.c2; the
// shared-memory tiles of kernels B, C and D provide the same interface.
template <bool PERIODIC, class T>
struct NtGlobalAcc {
  const NtGrid* g;
  const T* const* in;
  int i0, i1, i2;
  int c0, c1, c2;
  __device__ __forceinline__ float ld(int k, int o0, int o1, int o2) const {
    return nt_ld<PERIODIC>(in[k], *g, i0 + o0, i1 + o1, i2 + o2);
  }
};

// Asynchronous copies from global into shared memory (cp.async): 16 bytes,
// or 4 bytes that are zeros when !fill (nothing is read then). They land
// after `cp.async.wait_all` and a barrier.
__device__ __forceinline__ void nt_cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void nt_cp_async4(void* smem, const void* gmem, bool fill) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(fill ? 4 : 0)
               : "memory");
}

// NaN-propagating min / max, as torch.minimum / torch.maximum
__device__ __forceinline__ float nt_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float nt_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}
__device__ __forceinline__ int nt_min(int a, int b) { return a < b ? a : b; }
__device__ __forceinline__ int nt_max(int a, int b) { return a > b ? a : b; }
