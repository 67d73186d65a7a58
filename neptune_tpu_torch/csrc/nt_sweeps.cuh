// Kernel C, stencil_sweeps: kDepth sweeps of one unary apply per pass over
// device memory.
//
// Replaces the three temporal-blocking TPU kernels of the JAX package:
//   neptune_tpu/lowering/pallas_multisweep.py::execute_sweeps_resident (grid in VMEM)
//   neptune_tpu/lowering/pallas_multisweep.py::_sweeps_window_impl     (dim-0 slabs)
//   neptune_tpu/lowering/pallas_multisweep.py::_sweeps_window2_impl    (slabs x panels)
// and, with other launch data, their global_start cases (the local form).
// Those differ only in how they stage the grid through VMEM. Here one block
// owns one output tile: it loads the tile with a halo of kDepth * h cells per
// side into shared memory, runs the sweeps there, ping-ponging between two
// buffers over a region that shrinks by h per sweep, and writes the tile's
// centre back. Each sweep keeps the apply's copy-through contract by global
// coordinate, the previous sweep's value being the seed, so the result is K
// launches of kernel A, bit for bit.
//
// Bound on the H100: a single sweep is bound by bytes (8 B per cell); here
// the bytes are paid once per kDepth sweeps plus the halo, so the sweeps are
// bound by the updates (the recomputed halo cells included) and their
// shared-memory traffic. What the first design spent per 5-pt update -- five
// shared loads and a store, the tile walk, the coordinate arithmetic and a
// bounds test -- bounded it at 12x its byte bound. The register-strip design:
//   * a tile row is kW2 = 32 kC cells wide: lane l of a warp owns columns
//     [kC l, kC l + kC) of every row it touches, loaded as one vector;
//   * a warp's task is a strip of kR rows over a run of kL planes: it keeps
//     a window of 2 kH0 + 1 planes x (kR + 2 kH1) rows x (kC + 2 kH2)
//     columns in registers (all indices compile-time) and marches along
//     dim 0, streaming in one new plane per step, row by row, and taking
//     the columns beyond its own from the lanes next door (__shfl_sync);
//     so a 5-pt update costs (kC + 2) / kC vector-loaded values and 1 / kC
//     of a vector store, and a 7-pt one (kR + 2) / kR rows of the window;
//   * the warps share the tasks of each sweep's region, which shrinks by
//     the halo per sweep; a task's rows past the region, and the outermost
//     lanes' columns, compute values that no later sweep reads (the buffers
//     are padded to kRows rows for them);
//   * a tile whose buffer region lies inside the grid and inside the
//     apply's bounds runs the unchecked instance: no coordinates and no
//     bounds test per update; edge tiles run the checked one, whose wrapped
//     tiles (a periodic apply) look the wrapped cell up in a table filled
//     once per block;
//   * the tile is loaded with cp.async copies, 16 bytes wide where it lies
//     inside the grid and its rows are aligned, element by element (zero
//     filled off the grid) elsewhere; two blocks share an SM where the
//     shared memory allows, so one block's load and store overlap the
//     other's sweeps.
//
// The generated source defines a body struct (see nt_apply.cuh) and a plan
//   struct P { using Body; static constexpr int kDepth, kH0, kH1, kH2;  // per-sweep halo
//              kT0, kT1, kT2 (output tile), kP2 (halo columns on the left,
//              kDepth kH2 widened to whole 16-byte vectors, so that aligned
//              tiles load as vectors; kP2 + kT2 + kDepth kH2 <= 32 kC),
//              kC, kR, kL, kWarps, kRows (buffer rows, padded); };
// then NT_DEFINE_SWEEPS(P).
#pragma once

#include "nt_tile.cuh"

template <class P>
struct NtStripGeom {
  static constexpr int kW0 = P::kT0 + 2 * P::kDepth * P::kH0;
  static constexpr int kW1 = P::kT1 + 2 * P::kDepth * P::kH1;
  static constexpr int kW2 = 32 * P::kC;
  static constexpr int kPlane = P::kRows * kW2;
  static constexpr int kBuf = kW0 * kPlane;
  static constexpr int kTab = kW0 + P::kRows + kW2;
  static constexpr int kThreads = 32 * P::kWarps;
  static constexpr int kSmem = (2 * kBuf + kTab) * 4;
  static_assert(P::kP2 >= P::kDepth * P::kH2 && P::kP2 + P::kT2 + P::kDepth * P::kH2 <= kW2,
                "a tile row, halo included, is one warp's columns");
  static_assert(P::kH2 <= P::kC, "column halo from the next lane only");
  static_assert(P::kC == 1 || P::kC == 2 || P::kC == 4 || P::kC == 8, "vector widths");
};

// kC floats at p into v (aligned vector loads), and back
template <int C>
__device__ __forceinline__ void nt_ld_vec(const float* p, float* v) {
  if constexpr (C % 4 == 0) {
#pragma unroll
    for (int j = 0; j < C; j += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + j);
      v[j] = x.x; v[j + 1] = x.y; v[j + 2] = x.z; v[j + 3] = x.w;
    }
  } else if constexpr (C == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x; v[1] = x.y;
  } else {
    v[0] = *p;
  }
}
template <int C>
__device__ __forceinline__ void nt_st_vec(float* p, const float* v) {
  if constexpr (C % 4 == 0) {
#pragma unroll
    for (int j = 0; j < C; j += 4)
      *reinterpret_cast<float4*>(p + j) = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
  } else if constexpr (C == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// What a generated body sees in the register window at phase PH of the
// march: input 0 at an offset from window row r + kH1, column c + kH2 of the
// plane in slot (PH + o0 + kH0) mod (2 kH0 + 1).
template <class P, int PH>
struct NtStripAcc {
  static constexpr int kNW = 2 * P::kH0 + 1;
  using Win = float[kNW][P::kR + 2 * P::kH1][P::kC + 2 * P::kH2];
  const Win& e;
  int r, c;
  int c0, c1, c2;  // logical coordinates, for index() bodies
  __device__ __forceinline__ float ld(int, int o0, int o1, int o2) const {
    return e[(PH + o0 + P::kH0) % kNW][r + P::kH1 + o1][c + P::kH2 + o2];
  }
};

// Window row rr of slot `slot`: grid row row0 - kH1 + rr of buffer plane
// `plane`, this lane's kC columns and, from the lanes next door, kH2 more on
// each side.
template <class P>
__device__ __forceinline__ void nt_strip_row(
    const float* cur, int plane, int row0, int rr, int col,
    float (&v)[P::kC + 2 * P::kH2]) {
  using Gm = NtStripGeom<P>;
  constexpr int C = P::kC, H2 = P::kH2;
  constexpr unsigned kAll = 0xffffffffu;
  nt_ld_vec<C>(cur + plane * Gm::kPlane + (row0 - P::kH1 + rr) * Gm::kW2 + col, &v[H2]);
#pragma unroll
  for (int j = 0; j < H2; ++j) {
    v[H2 - 1 - j] = __shfl_up_sync(kAll, v[H2 + C - 1 - j], 1);
    v[H2 + C + j] = __shfl_down_sync(kAll, v[H2 + j], 1);
  }
}

// One step of the march, at phase PH: buffer plane p of rows [row0, row0 +
// kR), from cur into nxt. Planes p - kH0 .. p + kH0 - 1 are in the window
// already; plane p + kH0 streams in row by row, each row just before the
// row of outputs that first reads it.
template <class P, bool CHECKED, int PH>
__device__ __forceinline__ void nt_strip_step(const NtGrid& g, const int (&org)[3],
                                              const int* tab, const NtBox& box,
                                              const float* cur, float* nxt,
                                              typename NtStripAcc<P, PH>::Win& e, int p,
                                              int row0, const typename P::Body::Scalars& s) {
  using Gm = NtStripGeom<P>;
  using B = typename P::Body;
  constexpr int H0 = P::kH0, H1 = P::kH1, H2 = P::kH2, C = P::kC, R = P::kR, kD = P::kDepth;
  constexpr int kNew = (PH + 2 * H0) % (2 * H0 + 1);  // the slot of plane p + H0
  const int col = C * ((int)threadIdx.x & 31);
  // the first cell of the buffer region, per dim
  const int b0 = org[0] - kD * H0, b1 = org[1] - kD * H1, b2 = org[2] - P::kP2;
#pragma unroll
  for (int rr = 0; rr < 2 * H1; ++rr) nt_strip_row<P>(cur, p + H0, row0, rr, col, e[kNew][rr]);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    nt_strip_row<P>(cur, p + H0, row0, r + 2 * H1, col, e[kNew][r + 2 * H1]);
    float y[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      int w0 = b0 + p, w1 = b1 + row0 + r, w2 = b2 + col + c;
      if (CHECKED && B::kPeriodic) {
        w0 = tab[p];
        w1 = tab[Gm::kW0 + row0 + r];
        w2 = tab[Gm::kW0 + P::kRows + col + c];
      }
      y[c] = e[(PH + H0) % (2 * H0 + 1)][r + H1][c + H2];
      if (!CHECKED || nt_in_box(box, w0, w1, w2)) {
        const NtStripAcc<P, PH> a{e, r, c, w0 + g.lb[0], w1 + g.lb[1], w2 + g.lb[2]};
        float v[1];
        B::eval(a, s, v);
        y[c] = v[0];
      }
    }
    nt_st_vec<C>(nxt + p * Gm::kPlane + (row0 + r) * Gm::kW2 + col, y);
  }
}

// Steps p, p + 1, ... below pb at phases PH, PH + 1, ..., 2 kH0: one round
// of the window's slots, so that every slot index is a constant.
template <class P, bool CHECKED, int PH>
__device__ __forceinline__ void nt_strip_round(const NtGrid& g, const int (&org)[3],
                                               const int* tab, const NtBox& box,
                                               const float* cur, float* nxt,
                                               typename NtStripAcc<P, 0>::Win& e, int p, int pb,
                                               int row0, const typename P::Body::Scalars& s) {
  if (p >= pb) return;
  nt_strip_step<P, CHECKED, PH>(g, org, tab, box, cur, nxt, e, p, row0, s);
  if constexpr (PH < 2 * P::kH0)
    nt_strip_round<P, CHECKED, PH + 1>(g, org, tab, box, cur, nxt, e, p + 1, pb, row0, s);
}

// One task: rows [row0, row0 + kR) of buffer planes [pa, pb), from cur into
// nxt, marching along dim 0 with a window of 2 kH0 + 1 planes.
template <class P, bool CHECKED>
__device__ __forceinline__ void nt_strip_task(const NtGrid& g, const int (&org)[3],
                                              const int* tab, const NtBox& box,
                                              const float* cur, float* nxt, int pa, int pb,
                                              int row0, const typename P::Body::Scalars& s) {
  constexpr int H0 = P::kH0, H1 = P::kH1, NW = 2 * H0 + 1;
  const int col = P::kC * ((int)threadIdx.x & 31);
  typename NtStripAcc<P, 0>::Win e;
  // planes pa - H0 .. pa + H0 - 1 into the slots of offsets -H0 .. H0 - 1
#pragma unroll
  for (int o = 0; o < 2 * H0; ++o) {
#pragma unroll
    for (int rr = 0; rr < P::kR + 2 * H1; ++rr)
      nt_strip_row<P>(cur, pa - H0 + o, row0, rr, col, e[o][rr]);
  }
  for (int p = pa; p < pb; p += NW)
    nt_strip_round<P, CHECKED, 0>(g, org, tab, box, cur, nxt, e, p, pb, row0, s);
}

// kDepth sweeps of the tile in buf0 (sweep s: planes [s H0, W0 - s H0) in
// runs of kL, rows from s H1 in strips of kR), then the centre to out.
template <class P, bool CHECKED>
__device__ __forceinline__ void nt_strip_sweeps(const NtGrid& g, const int (&org)[3],
                                                const int* tab, const NtBox& box, float* buf0,
                                                float* buf1, const typename P::Body::Scalars& s,
                                                float* __restrict__ out) {
  using Gm = NtStripGeom<P>;
  const int warp = (int)threadIdx.x >> 5;
  float* cur = buf0;
  float* nxt = buf1;
  for (int sw = 1; sw <= P::kDepth; ++sw) {
    const int l0 = sw * P::kH0, l1 = sw * P::kH1;
    const int n_s = (Gm::kW1 - 2 * l1 + P::kR - 1) / P::kR;
    const int n_p = Gm::kW0 - 2 * l0;
    const int tasks = (n_p + P::kL - 1) / P::kL * n_s;
    for (int t = warp; t < tasks; t += P::kWarps) {
      const int run = t / n_s;
      const int pa = l0 + run * P::kL;
      nt_strip_task<P, CHECKED>(g, org, tab, box, cur, nxt, pa, nt_min(pa + P::kL, l0 + n_p),
                                l1 + (t - run * n_s) * P::kR, s);
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  // the centre, the cells of the grid only
  constexpr int kC1 = P::kT1 * P::kT2, kCells = P::kT0 * kC1;
  constexpr int L0 = P::kDepth * P::kH0, L1 = P::kDepth * P::kH1, L2 = P::kP2;
  for (int j = (int)threadIdx.x; j < kCells; j += Gm::kThreads) {
    const int p0 = j / kC1, rc = j - p0 * kC1;
    const int p1 = rc / P::kT2, p2 = rc - p1 * P::kT2;
    const int q0 = org[0] + p0, q1 = org[1] + p1, q2 = org[2] + p2;
    if (!CHECKED || nt_in_grid(g.n, q0, q1, q2))
      out[nt_index(g, q0, q1, q2)] = cur[(L0 + p0) * Gm::kPlane + (L1 + p1) * Gm::kW2 + L2 + p2];
  }
}

template <class P>
__global__ void __launch_bounds__(NtStripGeom<P>::kThreads)
    nt_sweeps_strip_kernel(const NtGrid g, const float* __restrict__ in, float* __restrict__ out,
                           const typename P::Body::Scalars s, int vec) {
  using Gm = NtStripGeom<P>;
  constexpr bool kWrap = P::Body::kPeriodic;
  constexpr int kD = P::kDepth;
  extern __shared__ __align__(16) float nt_strip_smem[];
  float* buf0 = nt_strip_smem;
  float* buf1 = nt_strip_smem + Gm::kBuf;
  int* tab = reinterpret_cast<int*>(nt_strip_smem + 2 * Gm::kBuf);
  const int org[3] = {(int)blockIdx.z * P::kT0, (int)blockIdx.y * P::kT1,
                      (int)blockIdx.x * P::kT2};
  const int b[3] = {org[0] - kD * P::kH0, org[1] - kD * P::kH1, org[2] - P::kP2};
  const int w[3] = {Gm::kW0, Gm::kW1, Gm::kW2};
  const NtBox box{{g.blo[0], g.blo[1], g.blo[2]}, {g.bhi[0], g.bhi[1], g.bhi[2]}};
  // the buffer region inside the grid and inside the apply's bounds
  bool interior = true;
#pragma unroll
  for (int d = 0; d < 3; ++d)
    interior = interior && b[d] >= 0 && b[d] + w[d] <= g.n[d] && b[d] >= box.lo[d] &&
               b[d] + w[d] <= box.hi[d];
  if (kWrap && !interior) {
    // the wrapped cell of each position, per dim (rows up to the padding)
    for (int j = (int)threadIdx.x; j < Gm::kTab; j += Gm::kThreads) {
      const int d = j < Gm::kW0 ? 0 : (j < Gm::kW0 + P::kRows ? 1 : 2);
      const int pos = j - (d == 0 ? 0 : (d == 1 ? Gm::kW0 : Gm::kW0 + P::kRows));
      tab[j] = nt_wrap(b[d] + pos, g.n[d]);
    }
    __syncthreads();
  }
  // the buffer region, halo included, from global memory
  constexpr int kRow = Gm::kW0 * Gm::kW1;
  if (interior && vec && b[2] % 4 == 0) {
    constexpr int kChunks = Gm::kW2 / 4;
    for (int j = (int)threadIdx.x; j < kRow * kChunks; j += Gm::kThreads) {
      const int rw = j / kChunks, c = (j - rw * kChunks) * 4;
      const int p0 = rw / Gm::kW1, p1 = rw - p0 * Gm::kW1;
      nt_cp_async16(buf0 + p0 * Gm::kPlane + p1 * Gm::kW2 + c,
                    in + nt_index(g, b[0] + p0, b[1] + p1, b[2] + c));
    }
  } else {
    // element by element, still asynchronous: the wrapped cell, or zeros
    // off the grid
    for (int j = (int)threadIdx.x; j < kRow * Gm::kW2; j += Gm::kThreads) {
      const int rw = j / Gm::kW2, c = j - rw * Gm::kW2;
      const int p0 = rw / Gm::kW1, p1 = rw - p0 * Gm::kW1;
      int q0 = b[0] + p0, q1 = b[1] + p1, q2 = b[2] + c;
      if (kWrap && !interior) {
        q0 = tab[p0];
        q1 = tab[Gm::kW0 + p1];
        q2 = tab[Gm::kW0 + P::kRows + c];
      }
      const bool fill = interior || kWrap || nt_in_grid(g.n, q0, q1, q2);
      nt_cp_async4(buf0 + p0 * Gm::kPlane + p1 * Gm::kW2 + c,
                   fill ? in + nt_index(g, q0, q1, q2) : in, fill);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  if (interior)
    nt_strip_sweeps<P, false>(g, org, tab, box, buf0, buf1, s, out);
  else
    nt_strip_sweeps<P, true>(g, org, tab, box, buf0, buf1, s, out);
}

// meta: n[3], lb[3], blo[3], bhi[3]. Returns the launch status.
#define NT_DEFINE_SWEEPS(P)                                                               \
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
    using Gm = NtStripGeom<P>;                                                        \
    static bool sized[64] = {}; /* per library: this function is not inline */        \
    if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;               \
    if (!sized[device]) {                                                             \
      err = cudaFuncSetAttribute(nt_sweeps_strip_kernel<P>,                           \
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, Gm::kSmem); \
      if (err != cudaSuccess) return (int)err;                                        \
      sized[device] = true;                                                           \
    }                                                                                 \
    const int vec = g.n[2] % 4 == 0 && (reinterpret_cast<size_t>(in) & 15) == 0;      \
    const dim3 grid((g.n[2] + P::kT2 - 1) / P::kT2, (g.n[1] + P::kT1 - 1) / P::kT1,   \
                    (g.n[0] + P::kT0 - 1) / P::kT0);                                  \
    nt_sweeps_strip_kernel<P><<<grid, Gm::kThreads, Gm::kSmem,                        \
                                static_cast<cudaStream_t>(stream)>>>(                 \
        g, static_cast<const float*>(in), static_cast<float*>(out), P::Body::load(scalars), vec); \
    return (int)cudaGetLastError();                                                   \
  }
