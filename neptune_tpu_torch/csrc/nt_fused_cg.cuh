// Kernel B, fused_cg: the whole (Jacobi-preconditioned) CG solve in one
// persistent cooperative kernel, its state resident in shared memory.
//
// Replaces neptune_tpu/solvers/fused.py::fused_cg (with its in-kernel
// operator, build_inkernel_matvec), which keeps every CG vector in a TPU
// core's VMEM for the whole solve. The grids that route admits (<= 12 MB of
// working set) fit in the H100's shared memory too, spread over its SMs: at
// most one block per SM, each owning one tile of the grid (solvers/fused.py
// cg_plan: bands of whole rows, or 2-D tiles on grids of fewer rows than
// SMs), keeps for the whole solve
//   * x, r, Ap and 1/diag on its tile (z = r * 1/diag is recomputed where it
//     is needed, the same f32 product every time),
//   * p on the tile and the operator's composed halo, and one buffer per
//     live intermediate stage of a composite operator,
// in dynamic shared memory, in nt_tile.cuh's tile layout. A tile stores its
// halo only along a dim cut into several tiles: along a dim that is not cut
// the tile is the whole dim, so a read that leaves the tile leaves the grid
// and reads 0, or wraps onto the tile itself (NtCgAcc). b and 1/diag are
// read once, x is written once.
//
// Bound on this card: neither bytes nor operations (at 512^2 an iteration
// moves ~6 MB through shared memory and does ~20 operations per cell, well
// under a microsecond of either spread over 132 SMs) but the latency of the
// grid barriers that the two global reductions of an iteration need. So an
// iteration crosses two barriers, whatever the number of the operator's
// stages:
//   1. Ap = A p from shared memory: the stages over the tile's shrinking
//      regions, as kernel D runs a chain, with no barrier between them; the
//      p.Ap partial.                                         -- barrier 1
//   2. alpha; x, r, z on the tile; the r.z and r.r partials; the z values of
//      the tile's edge, as deep as the halo, published to a grid-shaped
//      exchange buffer.                                      -- barrier 2
//   3. beta; p = z + beta p on the tile AND on its halo: the halo's z from
//      the published edges, its p the block's own copy, kept current since
//      p0 = z0. The owner of a cell computes the same f32 operations on the
//      same values, so every copy stays bitwise equal to its cell and the
//      next matvec needs no barrier before it. A periodic operator's halo
//      reads the wrapped cells.
// The exchange grid is written between barriers 1 and 2 and read between 2
// and the next 1, so one copy suffices; the partial sums take turns in two
// slot sets (nt_cg_allreduce).
//
// Reductions are deterministic: each block writes its partial sums, and
// after the barrier one warp of every block sums all blocks' partials in the
// same fixed order, so every block takes the same loop decision and a rerun
// gives the same iterates. No float atomics. Each dot product sums its f32
// products in f64 and rounds the total to f32 once, as the plain version
// (solvers/fused.py) does, so the order of the f64 sum almost never shows in
// the f32 result, and kernel and plain version take the same iterations.
//
// Each barrier is cooperative_groups' grid sync (the launch is cooperative,
// so the blocks are co-resident) and carries a reduction (nt_cg_allreduce).
// A hand-rolled arrive/wait barrier on a global counter tied with it on the
// H100 (PERF.md), so the kernel keeps the grid sync. The barrier probe
// (nt_cg_probe_kernel) times the two barriers and reductions alone at the
// kernel's grid size: the floor of any design with two global reductions
// per iteration. After barrier 2 the halo's published z is loaded in the
// same round trip through L2 as the partial sums.
//
// The generated source defines the operator's stage bodies and a plan
// struct P with
//   using Tile = NtTile<1, T1, T2, 0, H1, H2>;  // tile, stored halo; rank-3 padded
//   static constexpr bool kWrap;                // some stage is periodic
//   static constexpr int kN1, kN2;              // the grid
//   static constexpr int kTiles2, kBlocks;      // tiles along dim 2, in all
//   static constexpr int kEdge1, kEdge2;        // published depth per side
//   static constexpr int kBuffers, kSmem;       // stage buffers, bytes
//   static NtGrid grid();
//   template <class Put> static void matvec(g, org, tab, p, buf, put);
// whose matvec runs nt_cg_stage per intermediate stage and nt_cg_apply for
// the last one, which hands Ap on the tile to put(p1, p2, j, v); then it ends
// with NT_DEFINE_FUSED_CG(P).
#pragma once

#include <cooperative_groups.h>

#include "nt_tile.cuh"

namespace cg = cooperative_groups;

constexpr int kNtCgThreads = kNtTileThreads;
constexpr int kNtCgWarps = kNtCgThreads / 32;

// calls f(p1, p2, j) for each position of the box [L, L + E) of a rank-2
// tile (dim 0 padded), j the position's index in the box, walked flat: a
// tile of a few rows keeps every thread busy
template <int L1, int L2, int E1, int E2, class F>
__device__ __forceinline__ void nt_cg_for(F&& f) {
  for (int j = (int)threadIdx.x; j < E1 * E2; j += kNtCgThreads) {
    const int r = j / E2;
    f(L1 + r, L2 + (j - r * E2), j);
  }
}

// What a stage body sees of kernel B's tile: nt_tile.cuh's NtTileAcc reads
// (CHECK: a bounded body in a wrapped tile), and along a dim stored without
// halo (Tl::H1 or H2 = 0: a dim that is not cut, or that no stage reads
// along) a read that leaves the tile leaves the grid, so it reads 0, or on
// a periodic body the wrapped cell of the tile itself. (p1, p2): the tile
// position of the read's centre.
template <class Tl, int NIN, bool CHECK, bool PERIODIC>
struct NtCgAcc {
  const float* b[NIN];
  int i;
  int p1, p2;
  int c0, c1, c2;  // logical coordinates, for index() bodies
  int w0, w1, w2;  // the wrapped cell (read only when CHECK)
  const int* n;    // grid extents (read only when CHECK)
  __device__ __forceinline__ float ld(int k, int o0, int o1, int o2) const {
    if (CHECK && !nt_in_grid(n, w0 + o0, w1 + o1, w2 + o2)) return 0.0f;
    if (Tl::H1 == 0 && o1 != 0 && (unsigned)(p1 + o1) >= (unsigned)Tl::T1) {
      if (!PERIODIC) return 0.0f;
      o1 = nt_wrap(p1 + o1, Tl::T1) - p1;
    }
    if (Tl::H2 == 0 && o2 != 0 && (unsigned)(p2 + o2) >= (unsigned)Tl::T2) {
      if (!PERIODIC) return 0.0f;
      o2 = nt_wrap(p2 + o2, Tl::T2) - p2;
    }
    return b[k][i + o0 * Tl::kS0 + o1 * Tl::kS1 + o2];
  }
};

// the positions of a box of N cells that one thread takes
template <int N>
constexpr int kNtCgPer = (N + kNtCgThreads - 1) / kNtCgThreads;

// The same walk in two halves, for the loops of every iteration: each
// thread takes the same positions every time; nt_cg_gather sets v[m] =
// load(p1, p2, j) for the m-th of them, unrolled, so that the loads of all
// of them are in flight together, and nt_cg_scatter then calls use(p1, p2,
// j, v[m]). Walked position by position, a shared-memory store of one would
// keep the compiler from issuing the next one's loads before it.
template <int L1, int L2, int E1, int E2, class V, int M, class Load>
__device__ __forceinline__ void nt_cg_gather(V (&v)[M], Load&& load) {
  static_assert(M == kNtCgPer<E1 * E2>, "one value per position");
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int j = (int)threadIdx.x + m * kNtCgThreads;
    if (j < E1 * E2) {
      const int r = j / E2;
      v[m] = load(L1 + r, L2 + (j - r * E2), j);
    }
  }
}

template <int L1, int L2, int E1, int E2, class V, int M, class Use>
__device__ __forceinline__ void nt_cg_scatter(const V (&v)[M], Use&& use) {
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int j = (int)threadIdx.x + m * kNtCgThreads;
    if (j < E1 * E2) {
      const int r = j / E2;
      use(L1 + r, L2 + (j - r * E2), j, v[m]);
    }
  }
}

template <int L1, int L2, int E1, int E2, class Load, class Use>
__device__ __forceinline__ void nt_cg_walk(Load&& load, Use&& use) {
  decltype(load(0, 0, 0)) v[kNtCgPer<E1 * E2>];
  nt_cg_gather<L1, L2, E1, E2>(v, load);
  nt_cg_scatter<L1, L2, E1, E2>(v, use);
}

// One stage over tile positions [L, W - L): the body's value where the cell
// lies inside the stage's bounds, input 0's value (the copy-through seed, 0
// for a stage without inputs) elsewhere, handed to put(p1, p2, j, v).
// Tile cells beyond the grid follow nt_tile.cuh's rules.
template <class Tl, class B, bool WRAP, int NIN, int L1, int L2, int NA, class Put>
__device__ __forceinline__ void nt_cg_apply(const NtGrid& g, const int (&org)[3], const int* tab,
                                            const NtBox& box, const float* const (&in)[NA],
                                            Put&& put) {
  static_assert(NA == (NIN > 0 ? NIN : 1), "one input pointer per input, or a null one");
  constexpr bool kCheck = WRAP && !B::kPeriodic;
  nt_cg_walk<L1, L2, Tl::W1 - 2 * L1, Tl::W2 - 2 * L2>(
      [&](int p1, int p2, int) {
        int w0, w1, w2;
        nt_tile_cell<Tl, WRAP>(org, tab, 0, p1, p2, w0, w1, w2);
        const int i = Tl::at(0, p1, p2);
        float v = NIN > 0 ? in[0][i] : 0.0f;
        if (nt_in_box(box, w0, w1, w2)) {
          NtCgAcc<Tl, (NIN > 0 ? NIN : 1), kCheck, B::kPeriodic> a;
#pragma unroll
          for (int k = 0; k < NIN; ++k) a.b[k] = in[k];
          a.i = i;
          a.p1 = p1;
          a.p2 = p2;
          a.c0 = w0 + g.lb[0];
          a.c1 = w1 + g.lb[1];
          a.c2 = w2 + g.lb[2];
          a.w0 = w0;
          a.w1 = w1;
          a.w2 = w2;
          a.n = g.n;
          float y[1];
          B::eval(a, typename B::Scalars{}, y);
          v = y[0];
        }
        return v;
      },
      put);
}

// an intermediate stage into its shared-memory buffer
template <class Tl, class B, bool WRAP, int NIN, int L1, int L2, int NA>
__device__ __forceinline__ void nt_cg_stage(const NtGrid& g, const int (&org)[3], const int* tab,
                                            const NtBox& box, const float* const (&in)[NA],
                                            float* dst) {
  nt_cg_apply<Tl, B, WRAP, NIN, L1, L2>(g, org, tab, box, in,
                                        [&](int p1, int p2, int, float v) {
                                          dst[Tl::at(0, p1, p2)] = v;
                                        });
  __syncthreads();
}

// This block's sums of NV values, each in f64 over its threads in a fixed
// order; valid in thread 0. Every thread's earlier writes happen before it
// returns in thread 0 (a bar.sync).
template <int NV>
__device__ __forceinline__ void nt_cg_block_sums(double (&v)[NV]) {
  __shared__ double warp_sums[NV][kNtCgWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    for (int o = 16; o > 0; o >>= 1) v[k] += __shfl_down_sync(0xffffffffu, v[k], o);
    if (lane == 0) warp_sums[k][warp] = v[k];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      v[k] = lane < kNtCgWarps ? warp_sums[k][lane] : 0.0;
      for (int o = 16; o > 0; o >>= 1) v[k] += __shfl_down_sync(0xffffffffu, v[k], o);
    }
  }
}

// A reduction across the grid's NB blocks of this block's NV values v
// (kNtCgSlots at most): each block's sums go to its slots in `part`, the
// grid barrier orders them before every block's loads,
// and warp 0 of every block loads all NB sums at once and adds them up in
// the same fixed order -- lane by lane, then across lanes -- and rounds
// each total to f32 once: the same in every block. Reductions alternate
// between two slot sets (e % 2), so a block that has passed the next
// barrier never overwrites sums that a slower block is still loading.
constexpr int kNtCgSlots = 2;

template <int NB, int NV, class Barrier>
__device__ __forceinline__ void nt_cg_allreduce(double (&v)[NV], double* part, int e,
                                                float (&out)[NV], Barrier&& barrier) {
  static_assert(NV <= kNtCgSlots, "too many values for one reduction");
  constexpr int kPer = (NB + 31) / 32;
  __shared__ float total[NV];
  double* cur = part + (e & 1) * kNtCgSlots * NB;
  nt_cg_block_sums(v);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < NV; ++k) cur[k * NB + blockIdx.x] = v[k];
  }
  barrier();
  if (threadIdx.x < 32) {
    double got[NV][kPer];
#pragma unroll
    for (int k = 0; k < NV; ++k)
#pragma unroll
      for (int m = 0; m < kPer; ++m) {
        const int i = (int)threadIdx.x + 32 * m;
        got[k][m] = i < NB ? __ldcg(cur + k * NB + i) : 0.0;  // past L1: other SMs wrote them
      }
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      double s = 0.0;
#pragma unroll
      for (int m = 0; m < kPer; ++m) s += got[k][m];
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (threadIdx.x == 0) total[k] = (float)s;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < NV; ++k) out[k] = total[k];
}

// a tile cell's operands of the x, r, z update
struct NtCgCell {
  float p, x, r, ap, d;
};

// a tile-and-halo position's operands of the p update
struct NtCgUpdate {
  float z, p;
  bool set;
};

struct NtCgArgs {
  const float* b;
  const float* dinv;  // inverse diagonal, or null without a preconditioner
  float* x;
  float* exch;   // the grid: each block's published edge z
  double* part;  // 2 * kNtCgSlots * P::kBlocks partial sums
  int* iters;
  float* resnorm;
  float tol;
  int maxiter;
};

template <class P, bool PRECOND>
__global__ void __launch_bounds__(kNtCgThreads) nt_fused_cg_kernel(const NtCgArgs a) {
  using Tl = typename P::Tile;
  constexpr int kT = Tl::T1 * Tl::T2;
  constexpr int NB = P::kBlocks;
  static_assert(((1 + P::kBuffers) * Tl::kCells + 4 * kT + (P::kWrap ? Tl::kTab : 0)) * 4 <=
                    P::kSmem,
                "the plan's shared memory does not hold the layout");
  extern __shared__ float nt_smem[];
  float* p = nt_smem;  // tile and halo
  float* buf[P::kBuffers > 0 ? P::kBuffers : 1];
#pragma unroll
  for (int k = 0; k < P::kBuffers; ++k) buf[k] = nt_smem + (1 + k) * Tl::kCells;
  float* sx = nt_smem + (1 + P::kBuffers) * Tl::kCells;  // the tile's x, r, Ap, 1/diag
  float* sr = sx + kT;
  float* sap = sr + kT;
  float* sd = sap + kT;
  int* tab = reinterpret_cast<int*>(sd + kT);
  const NtGrid g = P::grid();
  const int org[3] = {0, (int)(blockIdx.x / P::kTiles2) * Tl::T1,
                      (int)(blockIdx.x % P::kTiles2) * Tl::T2};
  cg::grid_group grid = cg::this_grid();
  auto barrier = [&] { grid.sync(); };
  if (P::kWrap) {
    nt_tile_wraps<Tl>(g, org, tab);
    __syncthreads();
  }
  // a tile position's cell; owned: in the tile and in the grid
  auto owned = [&](int t1, int t2) {
    return (unsigned)t1 < (unsigned)Tl::T1 && (unsigned)t2 < (unsigned)Tl::T2 &&
           org[1] + t1 < P::kN1 && org[2] + t2 < P::kN2;
  };
  auto cell = [&](int t1, int t2) { return (long long)(org[1] + t1) * P::kN2 + org[2] + t2; };
  auto edge = [&](int t1, int t2) {
    return t1 < P::kEdge1 || t1 >= Tl::T1 - P::kEdge1 || t2 < P::kEdge2 ||
           t2 >= Tl::T2 - P::kEdge2;
  };

  // x0 = 0, r0 = b on the tile; p0 = z0 on the tile and its halo
  double init[2] = {0.0, 0.0};  // r.z, b.b
  nt_cg_for<0, 0, Tl::T1, Tl::T2>([&](int t1, int t2, int j) {
    float bv = 0.0f, dv = 0.0f;
    if (owned(t1, t2)) {
      bv = a.b[cell(t1, t2)];
      if (PRECOND) dv = a.dinv[cell(t1, t2)];
      const float zv = PRECOND ? bv * dv : bv;
      init[0] += (double)(bv * zv);
      init[1] += (double)(bv * bv);
    }
    sx[j] = 0.0f;
    sr[j] = bv;
    sd[j] = dv;
  });
  nt_cg_for<0, 0, Tl::W1, Tl::W2>([&](int p1, int p2, int) {
    int w0, w1, w2;
    nt_tile_cell<Tl, P::kWrap>(org, tab, 0, p1, p2, w0, w1, w2);
    float zv = 0.0f;
    if (P::kWrap || nt_in_grid(g.n, w0, w1, w2)) {
      const long long c = (long long)w1 * P::kN2 + w2;
      zv = PRECOND ? a.b[c] * a.dinv[c] : a.b[c];
    }
    p[Tl::at(0, p1, p2)] = zv;
  });
  float tot[2];
  nt_cg_allreduce<NB>(init, a.part, 0, tot, barrier);
  const float bnorm = sqrtf(tot[1]);
  float rz_cur = tot[0];
  const float goal = a.tol * (bnorm == 0.0f ? 1.0f : bnorm);
  float rn = bnorm;
  int k = 0;

  while (k < a.maxiter && rn > goal) {
    // 1. Ap = A p on the tile, the p.Ap partial; barrier 1
    double pap[1] = {0.0};
    P::matvec(g, org, tab, p, buf, [&](int p1, int p2, int j, float v) {
      sap[j] = v;
      if (owned(p1 - Tl::H1, p2 - Tl::H2)) pap[0] += (double)(p[Tl::at(0, p1, p2)] * v);
    });
    float t1v[1];
    nt_cg_allreduce<NB>(pap, a.part, 1, t1v, barrier);

    // 2. alpha; x, r, z; the edge z published; the r.z and r.r partials;
    // barrier 2
    const float alpha = rz_cur / (t1v[0] == 0.0f ? 1.0f : t1v[0]);
    double rzr[2] = {0.0, 0.0};
    nt_cg_walk<0, 0, Tl::T1, Tl::T2>(
        [&](int t1, int t2, int j) {
          return NtCgCell{p[Tl::at(0, t1 + Tl::H1, t2 + Tl::H2)], sx[j], sr[j], sap[j], sd[j]};
        },
        [&](int t1, int t2, int j, const NtCgCell& c) {
          if (!owned(t1, t2)) return;
          sx[j] = c.x + alpha * c.p;
          const float rv = c.r - alpha * c.ap;
          sr[j] = rv;
          const float zv = PRECOND ? rv * c.d : rv;
          rzr[0] += (double)(rv * zv);
          rzr[1] += (double)(rv * rv);
          if (edge(t1, t2)) a.exch[cell(t1, t2)] = zv;
        });
    // 3. beta, the recurrence residual; p = z + beta p on the tile and halo,
    // whose operands -- the halo's published z among them -- are loaded
    // while warp 0 loads the partial sums: one round trip through L2 for both
    NtCgUpdate up[kNtCgPer<Tl::W1 * Tl::W2>];
    float t2v[2];
    nt_cg_allreduce<NB>(rzr, a.part, 0, t2v, [&] {
      barrier();
      nt_cg_gather<0, 0, Tl::W1, Tl::W2>(up, [&](int p1, int p2, int) {
        const int t1 = p1 - Tl::H1, t2 = p2 - Tl::H2;
        NtCgUpdate u{0.0f, p[Tl::at(0, p1, p2)], true};
        if (owned(t1, t2)) {
          const int j = t1 * Tl::T2 + t2;
          u.z = PRECOND ? sr[j] * sd[j] : sr[j];
        } else {
          int w0, w1, w2;
          nt_tile_cell<Tl, P::kWrap>(org, tab, 0, p1, p2, w0, w1, w2);
          if (P::kWrap || nt_in_grid(g.n, w0, w1, w2))
            u.z = __ldcg(a.exch + (long long)w1 * P::kN2 + w2);
          else
            u.set = false;  // beyond a bounded grid: stays 0
        }
        return u;
      });
    });
    const float beta = t2v[0] / (rz_cur == 0.0f ? 1.0f : rz_cur);
    nt_cg_scatter<0, 0, Tl::W1, Tl::W2>(up, [&](int p1, int p2, int, const NtCgUpdate& u) {
      if (u.set) p[Tl::at(0, p1, p2)] = u.z + beta * u.p;
    });
    rz_cur = t2v[0];
    rn = sqrtf(t2v[1]);
    ++k;
    __syncthreads();  // p whole before the next matvec
  }
  nt_cg_for<0, 0, Tl::T1, Tl::T2>([&](int t1, int t2, int j) {
    if (owned(t1, t2)) a.x[cell(t1, t2)] = sx[j];
  });
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *a.iters = k;
    *a.resnorm = rn;
  }
}

// The barrier floor at the kernel's grid size: per iteration only what
// kernel B does to reduce across blocks -- one value, a barrier, two values,
// a barrier, each total in every block.
template <class P>
__global__ void __launch_bounds__(kNtCgThreads) nt_cg_probe_kernel(double* part, int iters,
                                                                    float* out) {
  constexpr int NB = P::kBlocks;
  cg::grid_group grid = cg::this_grid();
  auto barrier = [&] { grid.sync(); };
  float acc = 0.0f;
  for (int k = 0; k < iters; ++k) {
    double v1[1] = {(double)threadIdx.x};
    float t1[1];
    nt_cg_allreduce<NB>(v1, part, 1, t1, barrier);
    double v2[2] = {(double)t1[0], (double)blockIdx.x};
    float t2[2];
    nt_cg_allreduce<NB>(v2, part, 0, t2, barrier);
    acc += t2[0] + t2[1];
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *out = acc;
}

template <class K>
int nt_cg_cooperative(K kernel, int smem, void** params, cudaStream_t stream, int blocks) {
  const cudaError_t err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks),
                                                      dim3(kNtCgThreads), params, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// nt_fused_cg_setup: the shared-memory attribute, the most blocks that are
// co-resident at the plan's size (into *most) and the kernel's static shared
// memory (into *fixed, the larger of its two forms'). nt_fused_cg: one
// solve, with exch (the grid's cells) and part (2 * kNtCgSlots * P::kBlocks
// doubles) from the caller's workspace, which one launch uses at a time.
// nt_cg_barrier_probe: `iters` iterations of the barrier floor, with a part
// of its own.
#define NT_DEFINE_FUSED_CG(P)                                                              \
  extern "C" int nt_fused_cg_setup(int device, int* most, int* fixed) {                    \
    cudaError_t err = cudaSetDevice(device);                                               \
    if (err != cudaSuccess) return (int)err;                                               \
    int sms = 0, per_sm = 0, fewest = 1 << 30;                                             \
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);            \
    if (err != cudaSuccess) return (int)err;                                               \
    const void* kernels[] = {(const void*)nt_fused_cg_kernel<P, true>,                     \
                             (const void*)nt_fused_cg_kernel<P, false>};                   \
    *fixed = 0;                                                                            \
    for (const void* k : kernels) {                                                        \
      cudaFuncAttributes attr;                                                             \
      err = cudaFuncGetAttributes(&attr, k);                                               \
      if (err != cudaSuccess) return (int)err;                                             \
      *fixed = (int)attr.sharedSizeBytes > *fixed ? (int)attr.sharedSizeBytes : *fixed;    \
      err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem); \
      if (err != cudaSuccess) return (int)err;                                             \
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, kNtCgThreads,        \
                                                          P::kSmem);                       \
      if (err != cudaSuccess) return (int)err;                                             \
      fewest = per_sm < fewest ? per_sm : fewest;                                          \
    }                                                                                      \
    *most = fewest * sms;                                                                  \
    return 0;                                                                              \
  }                                                                                        \
  extern "C" int nt_fused_cg(int device, const float* b, const float* dinv, float* x,      \
                             float* exch, double* part, int* iters, float* resnorm,        \
                             float tol, int maxiter,                                       \
                             void* stream) {                                               \
    cudaError_t err = cudaSetDevice(device);                                               \
    if (err != cudaSuccess) return (int)err;                                               \
    NtCgArgs a = {b, dinv, x, exch, part, iters, resnorm, tol, maxiter};                   \
    void* params[] = {&a};                                                                 \
    cudaStream_t s = static_cast<cudaStream_t>(stream);                                    \
    return dinv ? nt_cg_cooperative(nt_fused_cg_kernel<P, true>, P::kSmem, params, s,      \
                                    P::kBlocks)                                            \
                : nt_cg_cooperative(nt_fused_cg_kernel<P, false>, P::kSmem, params, s,     \
                                    P::kBlocks);                                           \
  }                                                                                        \
  extern "C" int nt_cg_barrier_probe(int device, int iters, double* part, float* out,      \
                                     void* stream) {                                       \
    cudaError_t err = cudaSetDevice(device);                                               \
    if (err != cudaSuccess) return (int)err;                                               \
    void* params[] = {&part, &iters, &out};                                                \
    return nt_cg_cooperative(nt_cg_probe_kernel<P>, 0, params,                             \
                             static_cast<cudaStream_t>(stream), P::kBlocks);               \
  }
