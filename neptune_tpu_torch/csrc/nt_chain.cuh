// Kernel D, stencil_chain: a composite opdef's whole apply DAG in one pass
// over device memory.
//
// Replaces neptune_tpu/lowering/pallas_chain.py::execute_chain, which walks
// the flattened DAG once per VMEM window with the next window's fetch in
// flight. Here a block owns an output tile: it stages every field
// argument's tile with a halo of the DAG's composed reach per side in shared
// memory, evaluates the stages in DAG order, each over the positions its
// consumers still read (the region shrinks by each stage's halo), with the
// live intermediates in shared-memory buffers that the planner reuses once a
// value is dead, and writes the last stage straight to global memory. Each
// stage keeps its own copy-through mask and neighbour rule by global
// coordinate (nt_tile.cuh), with its first input as the seed, so the chain
// equals its stages run one by one, bit for bit, also where periodic and
// bounded stages mix.
//
// Bound on the H100: bytes. A one-field chain moves 8 B per cell, as one
// apply does; its intermediates never leave the SM. What held the first
// design at 40% of that bound was the SM's side: scalar loads through
// registers with a grid test per cell, rows of 66-68 cells walked by warps
// with 2-4 live lanes in their last pass, a box test and a nine-field
// accessor per stage cell, and no load in flight while a block computed.
// This design (lowering/chain.py plans it):
//   * the field tiles are staged with 16-byte cp.async copies wherever rows
//     are whole vectors and the fields aligned; the column halo is widened to
//     whole vectors (Tile::H2 >= the reach), and edge tiles wrap or zero
//     whole vectors; other rows go as 4-byte copies that zero-fill;
//   * a tile whose field halo lies inside the grid, and where every stage's
//     region lies inside that stage's bounds or wholly outside them, runs
//     the unchecked instance: no grid or bounds test and no wrapped-cell
//     lookup per cell. Edge tiles run the checked instance, the first
//     design's rule per cell (the wrapped-cell table is filled for them
//     only, and only for a chain with a periodic stage);
//   * a stage's region is walked flat as (plane, strip, column) items, lanes
//     on neighbouring columns, so warps are full whatever the region's
//     width; each item is a strip of R cells down dim 1 (R per stage, chosen
//     by the planner), computed into registers first, so the vertical
//     neighbours of the strip are read once from shared memory. The last
//     strip of a column ends at the region's end and may overlap the one
//     before it: those cells are computed twice and written twice with the
//     same value;
//   * with kAhead > 0 the grid is persistent, a few blocks per SM walking
//     tiles in C order, and a block issues the copies of a tile kAhead tiles
//     ahead, into a field set of its own, before it runs the current tile's
//     stages: the TPU kernel's double-buffered window fetch (kAhead = 1), or
//     deeper. With kAhead = 0 one block runs one tile and other blocks on
//     the SM hide its loads.
// What is left between it and the bytes is still the SM's side: each stage
// ends at a barrier, and the registers a strip needs cap the blocks an SM
// holds; small blocks (128 threads), several per SM, each one tile ahead,
// overlap one block's barriers with another's loads best (PERF.md has the
// candidates' times).
//
// The generated source defines one body struct per stage (see nt_apply.cuh)
// and a chain struct
//   struct C { using Tile = NtTile<...>;  // halo: the composed reach, H2 widened
//              static constexpr bool kWrap;   // some stage is periodic
//              static constexpr int kFields, kBuffers, kStages;
//              static constexpr int kThreads, kMinBlocks;  // __launch_bounds__
//              static constexpr int kAhead;  // tiles in flight beyond the current
//              struct Scalars {...}; static Scalars load(const double*);
//              static __device__ NtBox box0(const NtGrid&), box1(...), ...;
//              static __device__ bool sides(const NtGrid&, const int (&org)[3],
//                                           unsigned& copy);
//              template <bool CHECKED>
//              static __device__ void run(const NtGrid&, const int (&org)[3],
//                                         const int* tab, float* const* buf,
//                                         float* out, const Scalars&,
//                                         unsigned copy); };
// whose boxI() is stage I's box (constant on a whole grid, mapped with
// nt_box_at on a block), sides() calls nt_chain_side per stage and run()
// nt_chain_stage / nt_chain_last per stage; the fields are in buffers
// 0 .. kFields-1 when run() starts. Then NT_DEFINE_CHAIN(C).
#pragma once

#include <stdint.h>

#include "nt_tile.cuh"

constexpr int kNtChainMaxFields = 8;
constexpr int kNtChainVec = 4;  // floats per 16-byte copy

struct NtChainPtrs {
  const float* in[kNtChainMaxFields];
  float* out;
};

// i mod n, with the modulo only for i off [0, n)
__device__ __forceinline__ int nt_chain_wrap(int i, int n) {
  return (unsigned)i < (unsigned)n ? i : nt_wrap(i, n);
}

// The tile at org, halo included, of every field into `set` (field f at
// f * kCells): the cell itself (unchecked), or its wrapped cell in a chain
// with a periodic stage, or 0 off the grid (checked). With `vec`, in 16-byte
// copies: the tile's first column and n2 are whole vectors, so a vector lies
// on the grid or off it whole, and wraps whole. The copies land after their
// group is waited for (cp.async.wait_group) and a barrier.
template <class C, bool CHECKED>
__device__ __forceinline__ void nt_chain_load(const NtGrid& g, const NtChainPtrs& p, float* set,
                                              const int (&org)[3], bool vec) {
  using Tl = typename C::Tile;
  const int b0 = org[0] - Tl::H0, b1 = org[1] - Tl::H1, b2 = org[2] - Tl::H2;
  if (vec) {
    // a thread's vectors: row r (dim 0 and dim 1 together), chunk c, and
    // kThreads vectors further on each step, without dividing again
    constexpr int kChunks = Tl::W2 / kNtChainVec, kRows = Tl::W0 * Tl::W1;
    constexpr int kDr = C::kThreads / kChunks, kDc = C::kThreads % kChunks;
#pragma unroll
    for (int f = 0; f < C::kFields; ++f) {
      int r = (int)threadIdx.x / kChunks, c = (int)threadIdx.x % kChunks;
      for (; r < kRows; r += kDr) {
        const int p0 = Tl::W0 == 1 ? 0 : r / Tl::W1;
        int w0 = b0 + p0, w1 = b1 + (r - p0 * Tl::W1), w2 = b2 + c * kNtChainVec;
        bool fill = true;
        if (CHECKED && C::kWrap) {
          w0 = nt_chain_wrap(w0, g.n[0]);
          w1 = nt_chain_wrap(w1, g.n[1]);
          w2 = nt_chain_wrap(w2, g.n[2]);
        } else if (CHECKED) {
          fill = nt_in_grid(g.n, w0, w1, w2);
        }
        float* dst = set + f * Tl::kCells + r * Tl::W2 + c * kNtChainVec;
        if (fill)
          nt_cp_async16(dst, p.in[f] + nt_index(g, w0, w1, w2));
        else
          *reinterpret_cast<float4*>(dst) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        c += kDc;
        if (c >= kChunks) {
          c -= kChunks;
          ++r;
        }
      }
    }
    return;
  }
  // field by field, so that p.in is indexed by constants (a run-time index
  // would put the pointers in local memory)
#pragma unroll
  for (int f = 0; f < C::kFields; ++f) {
    for (int j = (int)threadIdx.x; j < Tl::kCells; j += C::kThreads) {
      const int p0 = j / Tl::kS0, r1 = j - p0 * Tl::kS0;
      const int p1 = r1 / Tl::kS1;
      int w0 = b0 + p0, w1 = b1 + p1, w2 = b2 + (r1 - p1 * Tl::kS1);
      bool fill = true;
      if (CHECKED && C::kWrap) {
        w0 = nt_chain_wrap(w0, g.n[0]);
        w1 = nt_chain_wrap(w1, g.n[1]);
        w2 = nt_chain_wrap(w2, g.n[2]);
      } else if (CHECKED) {
        fill = nt_in_grid(g.n, w0, w1, w2);
      }
      nt_cp_async4(set + f * Tl::kCells + j, fill ? p.in[f] + nt_index(g, w0, w1, w2) : p.in[f],
                   fill);
    }
  }
}

// One stage (body B, NIN tile inputs) over the tile positions [L, W - L),
// handed to put(p0, p1, p2, i, v): the body's value where the cell lies
// inside the stage's box, input 0's value (the copy-through seed) elsewhere.
// Unchecked, the region lies wholly inside the box, or wholly outside it
// when `copy`. Items are (plane, strip, column), lanes on columns; a strip
// is R cells down dim 1, and the last one of a column ends at the region's
// end.
template <class C, class B, bool CHECKED, int NIN, int L0, int L1, int L2, int R, class S,
          class Put>
__device__ __forceinline__ void nt_chain_walk(const NtGrid& g, const int (&org)[3],
                                              const int* tab, const NtBox& box, bool copy,
                                              const float* const (&in)[NIN], const S& s,
                                              Put&& put) {
  using Tl = typename C::Tile;
  constexpr int E0 = Tl::W0 - 2 * L0, E1 = Tl::W1 - 2 * L1, E2 = Tl::W2 - 2 * L2;
  constexpr int kStrips = (E1 + R - 1) / R, kPlane = kStrips * E2;
  static_assert(R >= 1 && R <= E1, "a strip lies in its region");
  constexpr bool kCheck = C::kWrap && !B::kPeriodic;
  for (int j = (int)threadIdx.x; j < E0 * kPlane; j += C::kThreads) {
    const int q = j / kPlane, rem = j - q * kPlane;
    const int st = rem / E2;
    const int p0 = L0 + q, p1 = L1 + nt_min(st * R, E1 - R), p2 = L2 + (rem - st * E2);
    const int i0 = Tl::at(p0, p1, p2);
    float y[R];
    if (CHECKED) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        int w0, w1, w2;
        nt_tile_cell<Tl, C::kWrap>(org, tab, p0, p1 + r, p2, w0, w1, w2);
        const int i = i0 + r * Tl::kS1;
        y[r] = in[0][i];
        if (nt_in_box(box, w0, w1, w2)) {
          NtTileAcc<Tl, NIN, kCheck> a;
#pragma unroll
          for (int k = 0; k < NIN; ++k) a.b[k] = in[k];
          a.i = i;
          a.c0 = w0 + g.lb[0];
          a.c1 = w1 + g.lb[1];
          a.c2 = w2 + g.lb[2];
          a.w0 = w0;
          a.w1 = w1;
          a.w2 = w2;
          a.n = g.n;
          float v[1];
          B::eval(a, s, v);
          y[r] = v[0];
        }
      }
    } else if (copy) {
#pragma unroll
      for (int r = 0; r < R; ++r) y[r] = in[0][i0 + r * Tl::kS1];
    } else {
      const int w0 = org[0] - Tl::H0 + p0, w1 = org[1] - Tl::H1 + p1,
                w2 = org[2] - Tl::H2 + p2;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        NtTileAcc<Tl, NIN, false> a;
#pragma unroll
        for (int k = 0; k < NIN; ++k) a.b[k] = in[k];
        a.i = i0 + r * Tl::kS1;
        a.c0 = w0 + g.lb[0];
        a.c1 = w1 + r + g.lb[1];
        a.c2 = w2 + g.lb[2];
        a.w0 = w0;
        a.w1 = w1 + r;
        a.w2 = w2;
        a.n = g.n;
        float v[1];
        B::eval(a, s, v);
        y[r] = v[0];
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) put(p0, p1 + r, p2, i0 + r * Tl::kS1, y[r]);
  }
}

// an intermediate stage: its value at tile positions [L, W - L) into dst
template <class C, class B, bool CHECKED, int NIN, int L0, int L1, int L2, int R, class S>
__device__ __forceinline__ void nt_chain_stage(const NtGrid& g, const int (&org)[3],
                                               const int* tab, const NtBox& box, bool copy,
                                               const float* const (&in)[NIN], float* dst,
                                               const S& s) {
  nt_chain_walk<C, B, CHECKED, NIN, L0, L1, L2, R>(
      g, org, tab, box, copy, in, s, [&](int, int, int, int i, float v) { dst[i] = v; });
  __syncthreads();
}

// the last stage: its value over the tile itself, to the grid cells of out
template <class C, class B, bool CHECKED, int NIN, int R, class S>
__device__ __forceinline__ void nt_chain_last(const NtGrid& g, const int (&org)[3],
                                              const int* tab, const NtBox& box, bool copy,
                                              const float* const (&in)[NIN],
                                              float* __restrict__ out, const S& s) {
  using Tl = typename C::Tile;
  nt_chain_walk<C, B, CHECKED, NIN, Tl::H0, Tl::H1, Tl::H2, R>(
      g, org, tab, box, copy, in, s, [&](int p0, int p1, int p2, int, float v) {
        const int q0 = org[0] - Tl::H0 + p0, q1 = org[1] - Tl::H1 + p1,
                  q2 = org[2] - Tl::H2 + p2;
        if (!CHECKED || nt_in_grid(g.n, q0, q1, q2)) out[nt_index(g, q0, q1, q2)] = v;
      });
}

// Whether a stage's region [L, W - L) of the tile at org lies inside its
// box, or wholly outside it (then `bit` is set in copy); false when the
// region straddles the box's edge.
template <class Tl, int L0, int L1, int L2>
__device__ __forceinline__ bool nt_chain_side(const int (&org)[3], const NtBox& b,
                                              unsigned& copy, unsigned bit) {
  const int lo[3] = {org[0] - Tl::H0 + L0, org[1] - Tl::H1 + L1, org[2] - Tl::H2 + L2};
  const int hi[3] = {org[0] + Tl::T0 + Tl::H0 - L0, org[1] + Tl::T1 + Tl::H1 - L1,
                     org[2] + Tl::T2 + Tl::H2 - L2};
  bool inside = true, outside = false;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    inside = inside && lo[d] >= b.lo[d] && hi[d] <= b.hi[d];
    outside = outside || hi[d] <= b.lo[d] || lo[d] >= b.hi[d];
  }
  if (outside) copy |= bit;
  return inside || outside;
}

// Tile t of the grid (C order, dim 2 fastest): its first output cell, and
// whether it runs unchecked: its field halo inside the grid and every
// stage's region inside its box or wholly outside it (copy).
template <class C>
__device__ __forceinline__ bool nt_chain_tile(const NtGrid& g, int t,
                                              int tiles1, int tiles2, int (&org)[3],
                                              unsigned& copy) {
  using Tl = typename C::Tile;
  const int t0 = t / (tiles1 * tiles2), r = t - t0 * tiles1 * tiles2;
  const int t1 = r / tiles2;
  org[0] = t0 * Tl::T0;
  org[1] = t1 * Tl::T1;
  org[2] = (r - t1 * tiles2) * Tl::T2;
  copy = 0u;
  return org[0] - Tl::H0 >= 0 && org[0] + Tl::T0 + Tl::H0 <= g.n[0] &&
         org[1] - Tl::H1 >= 0 && org[1] + Tl::T1 + Tl::H1 <= g.n[1] &&
         org[2] - Tl::H2 >= 0 && org[2] + Tl::T2 + Tl::H2 <= g.n[2] &&
         C::sides(g, org, copy);
}

template <class C>
__device__ __forceinline__ void nt_chain_load_tile(const NtGrid& g, const NtChainPtrs& p,
                                                   float* set, const int (&org)[3],
                                                   bool interior, bool vec) {
  if (interior)
    nt_chain_load<C, false>(g, p, set, org, vec);
  else
    nt_chain_load<C, true>(g, p, set, org, vec);
}

// Wait until at most N groups of this thread's copies are in flight.
template <int N>
__device__ __forceinline__ void nt_chain_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void nt_chain_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// A block walks tiles blockIdx.x, + gridDim.x, ... With kAhead > 0 the grid
// is persistent and the copies of the kAhead tiles after the current one are
// in flight while it computes, each tile in its own field set (tile k of the
// block in set k mod (kAhead + 1)), one commit group per tile. With kAhead
// = 0 a block loads its next tile only when the current one is done.
template <class C>
__global__ void __launch_bounds__(C::kThreads, C::kMinBlocks)
    nt_chain_kernel(const NtGrid g, const NtChainPtrs p, const typename C::Scalars s, int vec) {
  using Tl = typename C::Tile;
  extern __shared__ __align__(16) float nt_chain_smem[];
  constexpr int kSets = C::kAhead + 1, kSet = C::kFields * Tl::kCells;
  // the field sets, then the stages' own buffers, then the wrapped-cell table
  float* const work = nt_chain_smem + kSets * kSet;
  int* const tab = reinterpret_cast<int*>(work + (C::kBuffers - C::kFields) * Tl::kCells);
  const int tiles2 = (g.n[2] + Tl::T2 - 1) / Tl::T2, tiles1 = (g.n[1] + Tl::T1 - 1) / Tl::T1;
  const int tiles = (g.n[0] + Tl::T0 - 1) / Tl::T0 * tiles1 * tiles2;
  const int step = (int)gridDim.x;
  int t = (int)blockIdx.x;
  if (t >= tiles) return;
  // the first tile, and the kAhead after it
#pragma unroll
  for (int a = 0; a < (C::kAhead > 0 ? C::kAhead : 1); ++a) {
    const int ta = t + a * step;
    if (ta < tiles) {
      int o[3];
      unsigned c;
      const bool in = nt_chain_tile<C>(g, ta, tiles1, tiles2, o, c);
      nt_chain_load_tile<C>(g, p, nt_chain_smem + a * kSet, o, in, vec != 0);
    }
    nt_chain_commit();
  }
  for (int k = 0;; ++k, t += step) {
    int org[3];
    unsigned copy;
    const bool interior = nt_chain_tile<C>(g, t, tiles1, tiles2, org, copy);
    nt_chain_wait<(C::kAhead > 0 ? C::kAhead - 1 : 0)>();  // this tile's copies have landed
    if (C::kWrap && !interior) nt_tile_wraps<Tl, C::kThreads>(g, org, tab);
    __syncthreads();
    if (C::kAhead > 0) {
      // into the set of the tile before this one, whose stages are done
      const int ta = t + C::kAhead * step;
      if (ta < tiles) {
        int o[3];
        unsigned c;
        const bool in = nt_chain_tile<C>(g, ta, tiles1, tiles2, o, c);
        nt_chain_load_tile<C>(g, p, nt_chain_smem + (k + C::kAhead) % kSets * kSet, o, in,
                              vec != 0);
      }
      nt_chain_commit();
    }
    float* const fields = nt_chain_smem + k % kSets * kSet;
    float* buf[C::kBuffers];
#pragma unroll
    for (int b = 0; b < C::kBuffers; ++b)
      buf[b] = b < C::kFields ? fields + b * Tl::kCells : work + (b - C::kFields) * Tl::kCells;
    if (interior)
      C::template run<false>(g, org, tab, buf, p.out, s, copy);
    else
      C::template run<true>(g, org, tab, buf, p.out, s, copy);
    if (t + step >= tiles) break;
    __syncthreads();
    if (C::kAhead == 0) {
      int o[3];
      unsigned c;
      const bool in = nt_chain_tile<C>(g, t + step, tiles1, tiles2, o, c);
      nt_chain_load_tile<C>(g, p, nt_chain_smem, o, in, vec != 0);
      nt_chain_commit();
    }
  }
}

template <class C>
__host__ __forceinline__ int nt_chain_smem_bytes() {
  using Tl = typename C::Tile;
  return (((C::kAhead + 1) * C::kFields + C::kBuffers - C::kFields) * Tl::kCells + Tl::kTab) * 4;
}

// The launch. state[device]: 0 until this library has set the kernel's
// shared-memory attribute on the device, then the blocks a persistent grid
// launches there. It lives in the library's C entry: a static of a template
// would be one object for every library that instantiates the same names
// (GNU unique symbols), whatever their plans.
template <class C>
__host__ int nt_chain_launch(int& state, int device, const NtGrid& g, const NtChainPtrs& p,
                             const double* scalars, cudaStream_t stream) {
  using Tl = typename C::Tile;
  const int smem = nt_chain_smem_bytes<C>();
  if (state == 0) {
    cudaError_t err = cudaFuncSetAttribute(nt_chain_kernel<C>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, nt_chain_kernel<C>, C::kThreads,
                                                        smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    state = per_sm * sms;
  }
  int vec = g.n[2] % kNtChainVec == 0;
  for (int f = 0; f < C::kFields; ++f)
    vec &= (reinterpret_cast<uintptr_t>(p.in[f]) & 15) == 0;
  const long long tiles = (long long)((g.n[0] + Tl::T0 - 1) / Tl::T0) *
                          ((g.n[1] + Tl::T1 - 1) / Tl::T1) * ((g.n[2] + Tl::T2 - 1) / Tl::T2);
  if (tiles >= (1ll << 31)) return (int)cudaErrorInvalidConfiguration;
  const int grid = C::kAhead > 0 && tiles > state ? state : (int)tiles;
  nt_chain_kernel<C><<<grid, C::kThreads, smem, stream>>>(g, p, C::load(scalars), vec);
  return (int)cudaGetLastError();
}

// meta: n[3], lb[3] (then the unused blo[3], bhi[3]). nt_chain returns the
// launch status; nt_chain_blocks_per_sm the blocks of this kernel that one
// SM holds at once on the device (negative: a CUDA error).
#define NT_DEFINE_CHAIN(C)                                                             \
  static_assert(C::kFields <= kNtChainMaxFields, "too many field arguments");         \
  static_assert(C::Tile::T2 % kNtChainVec == 0 && C::Tile::H2 % kNtChainVec == 0,      \
                "the tile's columns are whole vectors");                               \
  extern "C" int nt_chain(int device, const void* const* in_ptrs, void* out,           \
                          const double* scalars, const int* meta, void* stream) {      \
    static int state[64] = {};                                                         \
    if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;                \
    cudaError_t err = cudaSetDevice(device);                                           \
    if (err != cudaSuccess) return (int)err;                                           \
    NtGrid g;                                                                          \
    for (int d = 0; d < 3; ++d) {                                                      \
      g.n[d] = meta[d];                                                                \
      g.lb[d] = meta[3 + d];                                                           \
      g.blo[d] = meta[6 + d];                                                          \
      g.bhi[d] = meta[9 + d];                                                          \
    }                                                                                  \
    NtChainPtrs p = {};                                                                \
    for (int f = 0; f < C::kFields; ++f) p.in[f] = static_cast<const float*>(in_ptrs[f]); \
    p.out = static_cast<float*>(out);                                                  \
    return nt_chain_launch<C>(state[device], device, g, p, scalars,                    \
                              static_cast<cudaStream_t>(stream));                      \
  }                                                                                    \
  extern "C" int nt_chain_blocks_per_sm(int device) {                                  \
    cudaError_t err = cudaSetDevice(device);                                           \
    if (err != cudaSuccess) return -(int)err;                                          \
    const int smem = nt_chain_smem_bytes<C>();                                         \
    err = cudaFuncSetAttribute(nt_chain_kernel<C>,                                     \
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);     \
    if (err != cudaSuccess) return -(int)err;                                          \
    int per_sm = 0;                                                                    \
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, nt_chain_kernel<C>,   \
                                                        C::kThreads, smem);            \
    return err == cudaSuccess ? per_sm : -(int)err;                                    \
  }
