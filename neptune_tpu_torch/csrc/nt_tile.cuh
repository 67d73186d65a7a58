// Shared-memory tiles for kernels B (fused_cg) and D (stencil_chain), and
// the bounds boxes that kernel C shares.
//
// A block owns one output tile of T0 x T1 x T2 cells (a rank-2 grid is
// (1, n0, n1), so T0 = 1 and H0 = 0 there) and holds it in shared memory
// with a halo of H0, H1, H2 cells on each side. Tile position p stands for
// the grid cell q = org - H + p, where org is the tile's first output cell.
//
// Cells beyond the grid, two rules:
//   * bounded tiles hold 0 there and never compute there (the cell lies
//     outside every apply's bounds, so it copies its seed through, which is
//     0 again); a neighbour read off the grid therefore reads 0, kernel A's
//     rule, with no test per read;
//   * wrapped tiles (some apply is periodic) hold the value of the wrapped
//     cell w = q mod n, and every apply evaluates there as at w: its mask,
//     its index() values, and -- for a bounded apply among periodic ones --
//     a read that leaves the grid from w reads 0 (NtTileAcc<.., CHECK>).
//     A table of w per position and dim (nt_tile_wraps) follows the tile's
//     buffers in shared memory.
// Each kernel walks its tiles itself (nt_fused_cg.cuh, nt_chain.cuh).
#pragma once

#include "nt_common.cuh"

constexpr int kNtTileThreads = 512;

template <int T0_, int T1_, int T2_, int H0_, int H1_, int H2_>
struct NtTile {
  static constexpr int T0 = T0_, T1 = T1_, T2 = T2_;
  static constexpr int H0 = H0_, H1 = H1_, H2 = H2_;
  static constexpr int W0 = T0 + 2 * H0, W1 = T1 + 2 * H1, W2 = T2 + 2 * H2;
  static constexpr int kCells = W0 * W1 * W2;
  static constexpr int kS0 = W1 * W2, kS1 = W2;
  static constexpr int kTab = W0 + W1 + W2;  // ints of the wrapped-cell table
  static __device__ __forceinline__ int at(int p0, int p1, int p2) {
    return p0 * kS0 + p1 * kS1 + p2;
  }
};

// The wrapped cell of each tile position, per dim (dim 0's W0 entries, then
// dim 1's, then dim 2's), for wrapped tiles: the modulo once per block, not
// per cell and sweep. NT: the block's threads.
template <class Tl, int NT = kNtTileThreads>
__device__ __forceinline__ void nt_tile_wraps(const NtGrid& g, const int (&org)[3], int* tab) {
  for (int j = (int)threadIdx.x; j < Tl::kTab; j += NT) {
    const int d = j < Tl::W0 ? 0 : (j < Tl::W0 + Tl::W1 ? 1 : 2);
    const int p = j - (d == 0 ? 0 : (d == 1 ? Tl::W0 : Tl::W0 + Tl::W1));
    const int h = d == 0 ? Tl::H0 : (d == 1 ? Tl::H1 : Tl::H2);
    tab[j] = nt_wrap(org[d] - h + p, g.n[d]);
  }
}

// the grid cell that tile position p stands for: wrapped (from the table)
// or as it is
template <class Tl, bool WRAP>
__device__ __forceinline__ void nt_tile_cell(const int (&org)[3], const int* tab, int p0, int p1,
                                             int p2, int& w0, int& w1, int& w2) {
  if (WRAP) {
    w0 = tab[p0];
    w1 = tab[Tl::W0 + p1];
    w2 = tab[Tl::W0 + Tl::W1 + p2];
  } else {
    w0 = org[0] - Tl::H0 + p0;
    w1 = org[1] - Tl::H1 + p1;
    w2 = org[2] - Tl::H2 + p2;
  }
}

// What a generated body sees of a tile: input k at an offset from tile
// position i, NIN inputs each in its own tile buffer. CHECK: a bounded apply
// in a wrapped tile, whose reads that leave the grid from the wrapped cell
// (w0, w1, w2) read 0.
template <class Tl, int NIN, bool CHECK>
struct NtTileAcc {
  const float* b[NIN];
  int i;
  int c0, c1, c2;  // logical coordinates, for index() bodies
  int w0, w1, w2;  // the wrapped cell (read only when CHECK)
  const int* n;    // grid extents (read only when CHECK)
  __device__ __forceinline__ float ld(int k, int o0, int o1, int o2) const {
    if (CHECK && !nt_in_grid(n, w0 + o0, w1 + o1, w2 + o2)) return 0.0f;
    return b[k][i + o0 * Tl::kS0 + o1 * Tl::kS1 + o2];
  }
};

// an apply's bounds, physical, rank-3 padded: cells with lo <= w < hi compute
struct NtBox {
  int lo[3];
  int hi[3];
};

// An apply's bounds given in logical coordinates, as a box of the grid's
// cells: shifted by the grid's logical origin g.lb, which is the run-time
// coordinate origin (the whole grid's lower bound, or a local block's global
// start), and clipped to the grid, so that no cell beyond a block computes.
__device__ __forceinline__ NtBox nt_box_at(const NtGrid& g, const NtBox& logical) {
  NtBox b;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    b.lo[d] = nt_min(nt_max(logical.lo[d] - g.lb[d], 0), g.n[d]);
    b.hi[d] = nt_min(nt_max(logical.hi[d] - g.lb[d], 0), g.n[d]);
  }
  return b;
}

__device__ __forceinline__ bool nt_in_box(const NtBox& b, int w0, int w1, int w2) {
  return w0 >= b.lo[0] && w0 < b.hi[0] && w1 >= b.lo[1] && w1 < b.hi[1] && w2 >= b.lo[2] &&
         w2 < b.hi[2];
}
