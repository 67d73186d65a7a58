// Kernel B, fused_cg: the whole (Jacobi-preconditioned) CG solve in one
// persistent cooperative kernel.
//
// Replaces neptune_tpu/solvers/fused.py::fused_cg (with its in-kernel
// operator, build_inkernel_matvec), which keeps every CG vector in a TPU
// core's VMEM. A Hopper SM has no room for that: x, r, z, p, Ap and the
// inverse diagonal of a 512^2 f32 grid are 7 MB against 227 KB of shared
// memory per block. So the vectors stay in global memory, where the 50 MB L2
// holds them, and every block of the grid is co-resident (launched with
// cudaLaunchCooperativeKernel, sized from the occupancy API) so that
// cooperative_groups grid syncs separate the phases of an iteration:
//   1. the matvec Ap = A p (one phase per inner apply of a composite
//      operator, a grid sync between them), with each block's partial p.Ap;
//   2. alpha from the p.Ap partials, the x / r / z updates, the r.z and r.r
//      partials;
//   3. beta and the residual from those partials, the p update.
// Reductions are deterministic: each block writes one partial, and after the
// grid sync every block sums all partials in the same fixed order, so every
// block takes the same loop decision and a rerun gives the same iterates.
// No float atomics. Each dot product sums its f32 products in f64 and rounds
// the total to f32 once, as the plain version (solvers/fused.py) does; the
// order of the f64 sum then almost never shows in the f32 result, so kernel
// and plain version take the same iterations. This departs on purpose from
// the TPU kernel's f32 sums, at about 15% of the time per iteration.
//
// Bound on the H100 at these sizes: grid-sync latency (3 syncs per
// iteration) and the cross-block partial sums, not bandwidth -- the state is
// L2-resident. Simple first version: no shared-memory tiling of the matvec.
//
// The generated source defines the operator's stage bodies and a struct M
// with
//   static constexpr int kScratch;   intermediate grids of a composite operator
//   static __device__ double apply(const float* x, float* y, float* const* scratch,
//                                  cg::grid_group& grid);
// which writes y = A x and returns this thread's share of x.y; then it ends
// with NT_DEFINE_FUSED_CG(M).
#pragma once

#include <cooperative_groups.h>

#include "nt_common.cuh"

namespace cg = cooperative_groups;

constexpr int kNtCgThreads = 512;
constexpr int kNtCgMaxScratch = 8;

// One phase of the in-kernel matvec over a rank-2 grid: out = body inside
// the apply bounds, the stage's seed outside. Returns this thread's share of
// sum(dot_with * out), in f64, when dot_with is given.
template <class B>
__device__ __forceinline__ double nt_stage(const NtGrid& g, const float* const* in,
                                           float* out, const float* dot_with) {
  double acc = 0.0;
  const long long n = (long long)g.n[1] * g.n[2];
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += stride) {
    const int i1 = (int)(idx / g.n[2]);
    const int i2 = (int)(idx - (long long)i1 * g.n[2]);
    float v;
    if (nt_in_bounds(g, 0, i1, i2)) {
      float y[1];
      const NtGlobalAcc<B::kPeriodic, float> a{&g, in, 0, i1, i2,
                                               g.lb[0], i1 + g.lb[1], i2 + g.lb[2]};
      B::eval(a, typename B::Scalars{}, y);
      v = y[0];
    } else {
      v = B::kIn > 0 ? in[0][idx] : 0.0f;
    }
    out[idx] = v;
    if (dot_with != nullptr) acc += (double)(dot_with[idx] * v);
  }
  return acc;
}

// block-wide sum; the result is valid in thread 0
__device__ __forceinline__ double nt_block_sum(double v) {
  __shared__ double warp_sums[32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // the previous call's readers are done with warp_sums
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  double t = 0.0;
  if (warp == 0) {
    t = lane < (int)(blockDim.x >> 5) ? warp_sums[lane] : 0.0;
    for (int o = 16; o > 0; o >>= 1) t += __shfl_down_sync(0xffffffffu, t, o);
  }
  return t;
}

__device__ __forceinline__ void nt_write_partial(double v, double* part) {
  v = nt_block_sum(v);
  if (threadIdx.x == 0) part[blockIdx.x] = v;
}

// the sum of all blocks' partials, in a fixed order, rounded to f32 and
// broadcast to every thread; identical in every block
__device__ __forceinline__ float nt_grid_total(const double* part) {
  __shared__ float total;
  double v = 0.0;
  for (int i = threadIdx.x; i < (int)gridDim.x; i += blockDim.x) v += __ldcg(part + i);
  v = nt_block_sum(v);
  if (threadIdx.x == 0) total = (float)v;
  __syncthreads();
  const float t = total;
  __syncthreads();
  return t;
}

struct NtCgArgs {
  const float* b;
  const float* dinv;  // inverse diagonal, or null without a preconditioner
  float *x, *r, *z, *p, *Ap;
  float* scratch[kNtCgMaxScratch];
  double* part;  // 4 * gridDim.x partial sums
  int* iters;
  float* resnorm;
  long long n;
  float tol;
  int maxiter;
};

template <class M, bool PRECOND>
__global__ void __launch_bounds__(kNtCgThreads) nt_fused_cg_kernel(const NtCgArgs a) {
  cg::grid_group grid = cg::this_grid();
  double* part_pap = a.part;
  double* part_rz = a.part + gridDim.x;
  double* part_rr = a.part + 2 * gridDim.x;
  double* part_bb = a.part + 3 * gridDim.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;

  // x0 = 0, r0 = b, z0 = M r0, p0 = z0
  double bb = 0.0, rz = 0.0;
  for (long long i = first; i < a.n; i += stride) {
    const float bv = a.b[i];
    const float zv = PRECOND ? bv * a.dinv[i] : bv;
    a.x[i] = 0.0f;
    a.r[i] = bv;
    a.z[i] = zv;
    a.p[i] = zv;
    bb += (double)(bv * bv);
    rz += (double)(bv * zv);
  }
  nt_write_partial(bb, part_bb);
  nt_write_partial(rz, part_rz);
  grid.sync();
  const float bnorm = sqrtf(nt_grid_total(part_bb));
  float rz_cur = nt_grid_total(part_rz);
  const float target = a.tol * (bnorm == 0.0f ? 1.0f : bnorm);
  float rn = bnorm;
  int k = 0;

  while (k < a.maxiter && rn > target) {
    // phase 1: Ap = A p, with p.Ap partials
    const double pap_t = M::apply(a.p, a.Ap, a.scratch, grid);
    nt_write_partial(pap_t, part_pap);
    grid.sync();

    // phase 2: alpha; x, r, z updates; r.z and r.r partials
    const float pap = nt_grid_total(part_pap);
    const float alpha = rz_cur / (pap == 0.0f ? 1.0f : pap);
    double rz_t = 0.0, rr_t = 0.0;
    for (long long i = first; i < a.n; i += stride) {
      const float pv = a.p[i];
      a.x[i] = a.x[i] + alpha * pv;
      const float rv = a.r[i] - alpha * a.Ap[i];
      a.r[i] = rv;
      const float zv = PRECOND ? rv * a.dinv[i] : rv;
      a.z[i] = zv;
      rz_t += (double)(rv * zv);
      rr_t += (double)(rv * rv);
    }
    nt_write_partial(rz_t, part_rz);
    nt_write_partial(rr_t, part_rr);
    grid.sync();

    // phase 3: beta, the recurrence residual, p update
    const float rz_new = nt_grid_total(part_rz);
    const float rr = nt_grid_total(part_rr);
    const float beta = rz_new / (rz_cur == 0.0f ? 1.0f : rz_cur);
    for (long long i = first; i < a.n; i += stride) a.p[i] = a.z[i] + beta * a.p[i];
    rz_cur = rz_new;
    rn = sqrtf(rr);
    ++k;
    grid.sync();
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *a.iters = k;
    *a.resnorm = rn;
  }
}

template <class M, bool PRECOND>
int nt_fused_cg_grid_size(int device, int* blocks) {
  int sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, nt_fused_cg_kernel<M, PRECOND>, kNtCgThreads, 0);
  if (err != cudaSuccess) return (int)err;
  *blocks = per_sm * sms;
  return *blocks > 0 ? 0 : (int)cudaErrorCooperativeLaunchTooLarge;
}

template <class M, bool PRECOND>
int nt_fused_cg_launch(const NtCgArgs& a, int blocks, cudaStream_t stream) {
  void* params[] = {const_cast<NtCgArgs*>(&a)};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)nt_fused_cg_kernel<M, PRECOND>, dim3(blocks), dim3(kNtCgThreads),
      params, 0, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// work: 4 + M::kScratch grids of n floats (r, z, p, Ap, scratch...);
// part: 4 * blocks doubles, blocks from nt_fused_cg_blocks.
#define NT_DEFINE_FUSED_CG(M)                                                       \
  static_assert(M::kScratch <= kNtCgMaxScratch, "too many matvec stages");          \
  extern "C" int nt_fused_cg_blocks(int device, int precond, int* blocks) {         \
    cudaError_t err = cudaSetDevice(device);                                        \
    if (err != cudaSuccess) return (int)err;                                        \
    return precond ? nt_fused_cg_grid_size<M, true>(device, blocks)                 \
                   : nt_fused_cg_grid_size<M, false>(device, blocks);               \
  }                                                                                 \
  extern "C" int nt_fused_cg(int device, const float* b, const float* dinv,         \
                             float* x, float* work, double* part, int blocks,       \
                             int* iters, float* resnorm, long long n, float tol,    \
                             int maxiter, void* stream) {                           \
    cudaError_t err = cudaSetDevice(device);                                        \
    if (err != cudaSuccess) return (int)err;                                        \
    NtCgArgs a = {};                                                                \
    a.b = b;                                                                        \
    a.dinv = dinv;                                                                  \
    a.x = x;                                                                        \
    a.r = work;                                                                     \
    a.z = work + n;                                                                 \
    a.p = work + 2 * n;                                                             \
    a.Ap = work + 3 * n;                                                            \
    for (int s = 0; s < M::kScratch; ++s) a.scratch[s] = work + (4 + s) * n;        \
    a.part = part;                                                                  \
    a.iters = iters;                                                                \
    a.resnorm = resnorm;                                                            \
    a.n = n;                                                                        \
    a.tol = tol;                                                                    \
    a.maxiter = maxiter;                                                            \
    cudaStream_t s = static_cast<cudaStream_t>(stream);                             \
    return dinv ? nt_fused_cg_launch<M, true>(a, blocks, s)                         \
                : nt_fused_cg_launch<M, false>(a, blocks, s);                       \
  }
