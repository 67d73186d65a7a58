// CG's vector work: the updates, dot products and scalar steps of one
// iteration of the generic CG loop (solvers/krylov.py's cg on one tensor,
// solvers/cg_vectors.py) in four launches.
//
// It replaces no TPU kernel: the JAX package's CG (neptune_tpu/solvers/
// krylov.py) runs its body inside lax.while_loop, where XLA fuses the vector
// work itself. Eagerly, one iteration beside its matvec and preconditioner
// is ~25 launches that move 26 grids (each axpy writes alpha * p out and
// reads it back, each dot its products, and ||r|| reads r once more). Here,
// in the loop's order:
//   K1 nt_cg_vec_dot_alpha  reads p, Ap           p.Ap; alpha = rz / safe(p.Ap)
//   K2 nt_cg_vec_update     reads x, p, r, Ap,    x += alpha p; r -= alpha Ap; r.r;
//                           writes x, r           ||r|| and the loop's flag
//   (M) z = M(r), unchanged
//   K3 nt_cg_vec_dot_beta   reads r, z            r.z; beta = r.z / safe(rz); rz = r.z
//   K4 nt_cg_vec_direction  reads z, p, writes p  p = z + beta p
// The scalar steps run in the last block of a reduction, so the scalars stay
// on the device (slots kNtVec*) and the host reads only the flag, once an
// iteration. Without a preconditioner z is r: K2's last block then takes
// K3's scalar steps too, with r.r as r.z, and K3 is not launched.
//
// Bound on the H100: bytes, 13 passes over a grid an iteration (2 + 6 + 2 +
// 3), 0.0797 ms each for a 322^3 float64 grid at 3.35 TB/s. The design keeps
// HBM busy with a pure stream: 16-byte loads and stores (two float64 or
// four float32 values), each thread issuing kNtVecUnroll of them per array
// before it computes, and a grid of as many blocks as are resident on every
// SM (nt_cg_vec_setup), striding over the grid.
//
// Arithmetic: the build passes --fmad=false, so an update rounds its product
// and its sum separately, as eager `y + alpha * x` does, and x, r and p are
// bitwise the plain versions' for the same alpha and beta. A dot product
// rounds each product to the element type, sums in float64 and rounds the
// total once (utils/tree.py's tdot_f64); only the order of the sum differs
// from torch.sum. It is fixed by the launch's blocks: each block writes its
// partial sum, the last block to finish (an integer ticket) sums the partials
// in index order and resets the ticket, so the same inputs give the same bits
// on every run. No float atomics.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

constexpr int kNtVecThreads = 256;
constexpr int kNtVecUnroll = 4;

// the scalar slots of a solve, in the element type
enum : int {
  kNtVecRz,        // r.z of the last iteration
  kNtVecAlpha,     // rz / safe(p.Ap)
  kNtVecBeta,      // r.z / safe(rz)
  kNtVecRnorm,     // ||r||
  kNtVecTarget,    // the loop runs while target < ||r|| <= divbound
  kNtVecDivbound,
  kNtVecPap,       // p.Ap
  kNtVecRr,        // r.r
  kNtVecSlots
};
// ctl[0]: the reductions' ticket (0 between launches); ctl[1]: the loop's flag

// 16 bytes of elements
template <class T>
struct NtPack {
  static constexpr int W = 16 / (int)sizeof(T);
  T v[W];
};

__device__ __forceinline__ NtPack<double> nt_vec_ld(const double* a, long long i) {
  const double2 t = reinterpret_cast<const double2*>(a)[i];
  return {{t.x, t.y}};
}
__device__ __forceinline__ NtPack<float> nt_vec_ld(const float* a, long long i) {
  const float4 t = reinterpret_cast<const float4*>(a)[i];
  return {{t.x, t.y, t.z, t.w}};
}
__device__ __forceinline__ void nt_vec_st(double* a, long long i, const NtPack<double>& v) {
  reinterpret_cast<double2*>(a)[i] = make_double2(v.v[0], v.v[1]);
}
__device__ __forceinline__ void nt_vec_st(float* a, long long i, const NtPack<float>& v) {
  reinterpret_cast<float4*>(a)[i] = make_float4(v.v[0], v.v[1], v.v[2], v.v[3]);
}

template <class T>
__device__ __forceinline__ T nt_vec_safe(T d) {
  return d == T(0) ? T(1) : d;
}

// a product rounded to T, as a float64 term of a dot product
template <class T>
__device__ __forceinline__ double nt_vec_term(T a, T b) {
  const T p = a * b;
  return (double)p;
}

// The block's sum of v, in a fixed order (lanes, then warps), in thread 0.
__device__ __forceinline__ double nt_vec_block_sum(double v, double* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kNtVecThreads / 32 ? warp_sums[lane] : 0.0;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

// The grid's sum of every thread's v. Returns true in thread 0 of the block
// that finishes last, whose v is then the total: every block's partial,
// summed in index order. That block resets the ticket for the next launch.
__device__ __forceinline__ bool nt_vec_grid_sum(double& v, double* part, int* ticket) {
  __shared__ double warp_sums[kNtVecThreads / 32];
  __shared__ bool last;
  v = nt_vec_block_sum(v, warp_sums);
  if (threadIdx.x == 0) {
    part[blockIdx.x] = v;
    __threadfence();  // the partial is visible before the ticket counts it
    last = atomicAdd(ticket, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return false;
  __threadfence();
  double s = 0.0;
  for (int i = threadIdx.x; i < (int)gridDim.x; i += kNtVecThreads) s += __ldcg(part + i);
  __syncthreads();  // warp_sums is free again
  s = nt_vec_block_sum(s, warp_sums);
  if (threadIdx.x != 0) return false;
  *ticket = 0;
  v = s;
  return true;
}

// The packs of an n-element grid, the first pack of this thread's first
// group, and the stride between its groups of kNtVecUnroll packs (each
// kNtVecThreads apart). The n % W elements after the last pack go to the
// first threads of the grid, one each (nt_vec_tail).
template <class T>
struct NtVecRange {
  long long packs, first, stride;
  __device__ __forceinline__ explicit NtVecRange(long long n)
      : packs(n / NtPack<T>::W),
        first((long long)blockIdx.x * kNtVecThreads * kNtVecUnroll + threadIdx.x),
        stride((long long)gridDim.x * kNtVecThreads * kNtVecUnroll) {}
};

// this thread's element past the last pack, or -1
template <class T>
__device__ __forceinline__ long long nt_vec_tail(long long n) {
  const long long i =
      n / NtPack<T>::W * NtPack<T>::W + (long long)blockIdx.x * kNtVecThreads + threadIdx.x;
  return i < n ? i : -1;
}

// K1: p.Ap; alpha = rz / safe(p.Ap)
template <class T>
__global__ void __launch_bounds__(kNtVecThreads)
    nt_cg_vec_dot_alpha_kernel(const T* __restrict__ p, const T* __restrict__ ap, long long n,
                               T* s, double* part, int* ctl) {
  constexpr int U = kNtVecUnroll, W = NtPack<T>::W;
  const NtVecRange<T> g(n);
  double acc = 0.0;
  for (long long base = g.first; base < g.packs; base += g.stride) {
    NtPack<T> a[U], b[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long i = base + (long long)u * kNtVecThreads;
      if (i < g.packs) {
        a[u] = nt_vec_ld(p, i);
        b[u] = nt_vec_ld(ap, i);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (base + (long long)u * kNtVecThreads < g.packs)
#pragma unroll
        for (int w = 0; w < W; ++w) acc += nt_vec_term(a[u].v[w], b[u].v[w]);
  }
  const long long t = nt_vec_tail<T>(n);
  if (t >= 0) acc += nt_vec_term(p[t], ap[t]);
  if (nt_vec_grid_sum(acc, part, ctl)) {
    const T pap = (T)acc;
    s[kNtVecPap] = pap;
    s[kNtVecAlpha] = s[kNtVecRz] / nt_vec_safe(pap);
  }
}

// K2: x += alpha p; r -= alpha Ap (as r + (-alpha) Ap); r.r; ||r|| and the
// flag. PLAIN (no preconditioner, z = r): also beta = r.r / safe(rz), rz = r.r.
template <class T, bool PLAIN>
__global__ void __launch_bounds__(kNtVecThreads)
    nt_cg_vec_update_kernel(T* __restrict__ x, const T* __restrict__ p, T* __restrict__ r,
                            const T* __restrict__ ap, long long n, T* s, double* part,
                            int* ctl) {
  constexpr int U = kNtVecUnroll, W = NtPack<T>::W;
  const T alpha = s[kNtVecAlpha], nalpha = -alpha;
  const NtVecRange<T> g(n);
  double acc = 0.0;
  for (long long base = g.first; base < g.packs; base += g.stride) {
    NtPack<T> xv[U], pv[U], rv[U], av[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long i = base + (long long)u * kNtVecThreads;
      if (i < g.packs) {
        xv[u] = nt_vec_ld(x, i);
        pv[u] = nt_vec_ld(p, i);
        rv[u] = nt_vec_ld(r, i);
        av[u] = nt_vec_ld(ap, i);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long i = base + (long long)u * kNtVecThreads;
      if (i < g.packs) {
#pragma unroll
        for (int w = 0; w < W; ++w) {
          const T ax = alpha * pv[u].v[w];
          xv[u].v[w] = xv[u].v[w] + ax;
          const T ar = nalpha * av[u].v[w];
          rv[u].v[w] = rv[u].v[w] + ar;
          acc += nt_vec_term(rv[u].v[w], rv[u].v[w]);
        }
        nt_vec_st(x, i, xv[u]);
        nt_vec_st(r, i, rv[u]);
      }
    }
  }
  const long long t = nt_vec_tail<T>(n);
  if (t >= 0) {
    const T ax = alpha * p[t];
    x[t] = x[t] + ax;
    const T ar = nalpha * ap[t];
    const T rt = r[t] + ar;
    r[t] = rt;
    acc += nt_vec_term(rt, rt);
  }
  if (nt_vec_grid_sum(acc, part, ctl)) {
    const T rr = (T)acc;
    const T rn = sqrt(rr);
    s[kNtVecRr] = rr;
    s[kNtVecRnorm] = rn;
    ctl[1] = rn > s[kNtVecTarget] && rn <= s[kNtVecDivbound];
    if (PLAIN) {
      s[kNtVecBeta] = rr / nt_vec_safe(s[kNtVecRz]);
      s[kNtVecRz] = rr;
    }
  }
}

// K3: r.z; beta = r.z / safe(rz); rz = r.z
template <class T>
__global__ void __launch_bounds__(kNtVecThreads)
    nt_cg_vec_dot_beta_kernel(const T* __restrict__ r, const T* __restrict__ z, long long n,
                              T* s, double* part, int* ctl) {
  constexpr int U = kNtVecUnroll, W = NtPack<T>::W;
  const NtVecRange<T> g(n);
  double acc = 0.0;
  for (long long base = g.first; base < g.packs; base += g.stride) {
    NtPack<T> a[U], b[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long i = base + (long long)u * kNtVecThreads;
      if (i < g.packs) {
        a[u] = nt_vec_ld(r, i);
        b[u] = nt_vec_ld(z, i);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (base + (long long)u * kNtVecThreads < g.packs)
#pragma unroll
        for (int w = 0; w < W; ++w) acc += nt_vec_term(a[u].v[w], b[u].v[w]);
  }
  const long long t = nt_vec_tail<T>(n);
  if (t >= 0) acc += nt_vec_term(r[t], z[t]);
  if (nt_vec_grid_sum(acc, part, ctl)) {
    const T rz = (T)acc;
    s[kNtVecBeta] = rz / nt_vec_safe(s[kNtVecRz]);
    s[kNtVecRz] = rz;
  }
}

// K4: p = z + beta p
template <class T>
__global__ void __launch_bounds__(kNtVecThreads)
    nt_cg_vec_direction_kernel(T* __restrict__ p, const T* __restrict__ z, long long n,
                               const T* s) {
  constexpr int U = kNtVecUnroll, W = NtPack<T>::W;
  const T beta = s[kNtVecBeta];
  const NtVecRange<T> g(n);
  for (long long base = g.first; base < g.packs; base += g.stride) {
    NtPack<T> pv[U], zv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long i = base + (long long)u * kNtVecThreads;
      if (i < g.packs) {
        pv[u] = nt_vec_ld(p, i);
        zv[u] = nt_vec_ld(z, i);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long i = base + (long long)u * kNtVecThreads;
      if (i < g.packs) {
#pragma unroll
        for (int w = 0; w < W; ++w) {
          const T bp = beta * pv[u].v[w];
          pv[u].v[w] = zv[u].v[w] + bp;
        }
        nt_vec_st(p, i, pv[u]);
      }
    }
  }
  const long long t = nt_vec_tail<T>(n);
  if (t >= 0) {
    const T bp = beta * p[t];
    p[t] = z[t] + bp;
  }
}

// the resident blocks of a kernel on every SM of the device
template <class K>
int nt_cg_vec_resident(K kernel, int sms, int* blocks) {
  int per_sm = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kNtVecThreads, 0);
  *blocks = per_sm * sms;
  return (int)err;
}

template <class T>
int nt_cg_vec_setup_t(int device, int* blocks) {
  int sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  int e = nt_cg_vec_resident(nt_cg_vec_dot_alpha_kernel<T>, sms, blocks + 0);
  if (!e) e = nt_cg_vec_resident(nt_cg_vec_update_kernel<T, false>, sms, blocks + 1);
  if (!e) e = nt_cg_vec_resident(nt_cg_vec_update_kernel<T, true>, sms, blocks + 2);
  if (!e) e = nt_cg_vec_resident(nt_cg_vec_dot_beta_kernel<T>, sms, blocks + 3);
  if (!e) e = nt_cg_vec_resident(nt_cg_vec_direction_kernel<T>, sms, blocks + 4);
  return e;
}

template <class K, class... A>
int nt_cg_vec_launch(K kernel, int blocks, void* stream, A... args) {
  kernel<<<blocks, kNtVecThreads, 0, static_cast<cudaStream_t>(stream)>>>(args...);
  return (int)cudaGetLastError();
}

// The C entries. `f64` picks the element type (float64, else float32);
// every pointer is 16-byte aligned and holds n elements; `blocks` is at
// most the step's count from nt_cg_vec_setup (blocks[5]: K1, K2, K2 without
// a preconditioner, K3, K4), and `part` holds that many doubles.
extern "C" int nt_cg_vec_setup(int device, int f64, int* blocks) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return f64 ? nt_cg_vec_setup_t<double>(device, blocks) : nt_cg_vec_setup_t<float>(device, blocks);
}

extern "C" int nt_cg_vec_dot_alpha(int device, int f64, const void* p, const void* ap,
                                   long long n, void* s, double* part, int* ctl, int blocks,
                                   void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (f64)
    return nt_cg_vec_launch(nt_cg_vec_dot_alpha_kernel<double>, blocks, stream, (const double*)p,
                     (const double*)ap, n, (double*)s, part, ctl);
  return nt_cg_vec_launch(nt_cg_vec_dot_alpha_kernel<float>, blocks, stream, (const float*)p,
                   (const float*)ap, n, (float*)s, part, ctl);
}

extern "C" int nt_cg_vec_update(int device, int f64, int plain, void* x, const void* p,
                                void* r, const void* ap, long long n, void* s, double* part,
                                int* ctl, int blocks, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (f64 && plain)
    return nt_cg_vec_launch(nt_cg_vec_update_kernel<double, true>, blocks, stream, (double*)x,
                     (const double*)p, (double*)r, (const double*)ap, n, (double*)s, part, ctl);
  if (f64)
    return nt_cg_vec_launch(nt_cg_vec_update_kernel<double, false>, blocks, stream, (double*)x,
                     (const double*)p, (double*)r, (const double*)ap, n, (double*)s, part, ctl);
  if (plain)
    return nt_cg_vec_launch(nt_cg_vec_update_kernel<float, true>, blocks, stream, (float*)x,
                     (const float*)p, (float*)r, (const float*)ap, n, (float*)s, part, ctl);
  return nt_cg_vec_launch(nt_cg_vec_update_kernel<float, false>, blocks, stream, (float*)x,
                   (const float*)p, (float*)r, (const float*)ap, n, (float*)s, part, ctl);
}

extern "C" int nt_cg_vec_dot_beta(int device, int f64, const void* r, const void* z,
                                  long long n, void* s, double* part, int* ctl, int blocks,
                                  void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (f64)
    return nt_cg_vec_launch(nt_cg_vec_dot_beta_kernel<double>, blocks, stream, (const double*)r,
                     (const double*)z, n, (double*)s, part, ctl);
  return nt_cg_vec_launch(nt_cg_vec_dot_beta_kernel<float>, blocks, stream, (const float*)r,
                   (const float*)z, n, (float*)s, part, ctl);
}

extern "C" int nt_cg_vec_direction(int device, int f64, void* p, const void* z, long long n,
                                   const void* s, int blocks, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (f64)
    return nt_cg_vec_launch(nt_cg_vec_direction_kernel<double>, blocks, stream, (double*)p,
                     (const double*)z, n, (const double*)s);
  return nt_cg_vec_launch(nt_cg_vec_direction_kernel<float>, blocks, stream, (float*)p,
                   (const float*)z, n, (const float*)s);
}
