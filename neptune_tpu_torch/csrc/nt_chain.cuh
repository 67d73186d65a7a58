// Kernel D, stencil_chain: a composite opdef's whole apply DAG in one pass
// over device memory.
//
// Replaces neptune_tpu/lowering/pallas_chain.py::execute_chain, which walks
// the flattened DAG once per VMEM window. Here one block owns one output
// tile: it loads every field argument's tile with a halo of the DAG's
// composed reach per side into shared memory (nt_tile.cuh), evaluates the
// stages in DAG order, each over the positions its consumers still read
// (the region shrinks by each stage's halo), with the live intermediates in
// shared-memory buffers that the planner reuses once a value is dead, and
// writes the last stage straight to global memory. Each stage keeps its own
// copy-through mask and neighbour rule by global coordinate (nt_tile.cuh),
// with its first input as the seed, so the chain equals its stages run one
// by one, bit for bit, also where periodic and bounded stages mix.
//
// Bound on the H100: per stage, a stage-at-a-time run moves its inputs and
// its output through device memory; the chain moves the fields in and the
// result out once, so it is bound by shared-memory reads and the recomputed
// halo cells. Simple first version: no TMA, no overlap of loads and compute.
//
// The generated source defines one body struct per stage (see nt_apply.cuh)
// and a chain struct
//   struct C { using Tile = NtTile<...>;  // halo = the composed reach
//              static constexpr bool kWrap;   // some stage is periodic
//              static constexpr int kFields, kBuffers;
//              struct Scalars {...}; static Scalars load(const double*);
//              static __device__ void run(const NtGrid&, const int (&org)[3],
//                                         const int* tab, float* const* buf,
//                                         float* out, const Scalars&); };
// whose run() calls nt_chain_stage / nt_chain_last per stage; fields are in
// buffers 0 .. kFields-1 when run() starts. Then NT_DEFINE_CHAIN(C).
#pragma once

#include "nt_tile.cuh"

constexpr int kNtChainMaxFields = 8;

// an intermediate stage: its value at tile positions [L, W - L) into dst
template <class Tl, class B, bool WRAP, int NIN, int L0, int L1, int L2, class S>
__device__ __forceinline__ void nt_chain_stage(const NtGrid& g, const int (&org)[3],
                                               const int* tab, const NtBox& box,
                                               const float* const (&in)[NIN], float* dst,
                                               const S& s) {
  nt_tile_apply<Tl, B, WRAP, NIN, L0, L1, L2>(
      g, org, tab, box, in, s, [&](int, int, int, int i, float v) { dst[i] = v; });
  __syncthreads();
}

// the last stage: its value over the tile itself, to the grid cells of out
template <class Tl, class B, bool WRAP, int NIN, class S>
__device__ __forceinline__ void nt_chain_last(const NtGrid& g, const int (&org)[3],
                                              const int* tab, const NtBox& box,
                                              const float* const (&in)[NIN],
                                              float* __restrict__ out, const S& s) {
  nt_tile_apply<Tl, B, WRAP, NIN, Tl::H0, Tl::H1, Tl::H2>(
      g, org, tab, box, in, s, [&](int p0, int p1, int p2, int, float v) {
        const int q0 = org[0] - Tl::H0 + p0, q1 = org[1] - Tl::H1 + p1,
                  q2 = org[2] - Tl::H2 + p2;
        if (nt_in_grid(g.n, q0, q1, q2)) out[nt_index(g, q0, q1, q2)] = v;
      });
}

struct NtChainPtrs {
  const float* in[kNtChainMaxFields];
  float* out;
};

template <class C>
__global__ void __launch_bounds__(kNtTileThreads)
    nt_chain_kernel(const NtGrid g, const NtChainPtrs p, const typename C::Scalars s) {
  using Tl = typename C::Tile;
  extern __shared__ float nt_smem[];
  float* buf[C::kBuffers];
#pragma unroll
  for (int b = 0; b < C::kBuffers; ++b) buf[b] = nt_smem + b * Tl::kCells;
  int* tab = reinterpret_cast<int*>(nt_smem + C::kBuffers * Tl::kCells);
  int org[3];
  nt_tile_origin<Tl>(org);
  if (C::kWrap) {
    nt_tile_wraps<Tl>(g, org, tab);
    __syncthreads();
  }
#pragma unroll
  for (int f = 0; f < C::kFields; ++f) nt_tile_load<Tl, C::kWrap>(g, org, tab, p.in[f], buf[f]);
  __syncthreads();
  C::run(g, org, tab, buf, p.out, s);
}

// meta: n[3], lb[3] (then the unused blo[3], bhi[3]). Returns the launch status.
#define NT_DEFINE_CHAIN(C)                                                            \
  static_assert(C::kFields <= kNtChainMaxFields, "too many field arguments");        \
  extern "C" int nt_chain(int device, const void* const* in_ptrs, void* out,          \
                          const double* scalars, const int* meta, void* stream) {     \
    cudaError_t err = cudaSetDevice(device);                                          \
    if (err != cudaSuccess) return (int)err;                                          \
    NtGrid g;                                                                         \
    for (int d = 0; d < 3; ++d) {                                                     \
      g.n[d] = meta[d];                                                               \
      g.lb[d] = meta[3 + d];                                                          \
      g.blo[d] = meta[6 + d];                                                         \
      g.bhi[d] = meta[9 + d];                                                         \
    }                                                                                 \
    NtChainPtrs p;                                                                    \
    for (int f = 0; f < C::kFields; ++f) p.in[f] = static_cast<const float*>(in_ptrs[f]); \
    p.out = static_cast<float*>(out);                                                 \
    using Tl = C::Tile;                                                               \
    const int smem = (C::kBuffers * Tl::kCells + Tl::kTab) * 4;                       \
    err = cudaFuncSetAttribute(nt_chain_kernel<C>,                                    \
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);    \
    if (err != cudaSuccess) return (int)err;                                          \
    const dim3 block(kNtTileThreads);                                                 \
    const dim3 grid((g.n[2] + Tl::T2 - 1) / Tl::T2, (g.n[1] + Tl::T1 - 1) / Tl::T1,   \
                    (g.n[0] + Tl::T0 - 1) / Tl::T0);                                  \
    nt_chain_kernel<C><<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(     \
        g, p, C::load(scalars));                                                      \
    return (int)cudaGetLastError();                                                   \
  }
