// Code the two diag sources share (link_kernel.cu's diag_main /
// diag_staged, diag_wide_kernel.cu's diag_wide), and only they: the in-run
// PAPR statistic's time sample, the one-pass normalize, and the kernels'
// layout for their geometry entry points.
//
// The in-run PAPR: a sampled symbol's time block is its n IDFT samples (or
// F_tx's n distinct columns) behind the cyclic prefix, which repeats the
// last L = T - n of them; papr_sample folds time sample t in [L, T) into
// the statistic once for itself and once more for its prefix copy t - n
// where t >= n, and writes both places of the carry row.
//
// The one-pass normalize: normalize needs each tile's mean |e|^2 over every
// point of the tile before any of its decisions.  The chain kernel's front
// variant (kFront) runs the whole chain once (Philox, encode, channel,
// noise, equalizer, the noise-bump stages), writes e and the TX index of
// every bin of a slab of whole tiles to the scratch (bin i = (b - b_lo) * n
// + k: two f32 planes and a u16 plane, 10 bytes a bin), and one |e|^2
// partial a run of symbols in the same fixed layout and order as before;
// norm_factors (link_common.cuh) reduces a tile's partials; diag_demap
// reads the scratch back, multiplies by the tile's factor with the deferred
// slicer gain (norm_gain), dumps (kDump) and counts.  The floats it scales
// are the ones a second pass of the chain would recompute, so counts, dump
// and PAPR stay bit-equal to the two-pass chain.  The fold, lr, mm and wide
// dense chains keep link_common.cuh's staged_passes.
//
// A slab holds whole tiles (a tile's factor needs all of it) and at most
// the wrapper's cap of bins (link_kernel.onepass_slab), so the scratch stays
// below 1 GB at any width.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "link_common.cuh"

namespace ofdm {

// Time sample t in [T - n, T) of a sampled symbol's block, x = (xr, xi),
// into the PAPR peak and sum; where t >= n the prefix repeats it at t - n
// (its power enters the sum twice).  On the carry symbol x goes to the
// carry row's place t and, where repeated, t - n.
__device__ __forceinline__ void papr_sample(int n, int t, float xr, float xi, bool carry, float& pk, double& ps,
                                            float* carry_r, float* carry_i) {
  const float pw = xr * xr + xi * xi;
  const bool twice = t >= n;
  pk = fmaxf(pk, pw);
  ps += static_cast<double>(pw);
  if (twice) ps += static_cast<double>(pw);
  if (carry) {
    carry_r[t] = xr;
    carry_i[t] = xi;
    if (twice) {
      carry_r[t - n] = xr;
      carry_i[t - n] = xi;
    }
  }
}

// Registers, local bytes a thread, static shared memory and resident blocks
// an SM of kernel k at `threads` threads a block and `bytes` of dynamic
// shared memory (raising the kernel's limit past 48 KB), into out[0..4):
// the diag sources' ofdm_diag{,_wide}_geometry.
template <class K>
cudaError_t kernel_layout(K* k, int threads, size_t bytes, int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, k);
  if (err == cudaSuccess && bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  }
  int blocks = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, threads, bytes);
  if (err != cudaSuccess) return err;
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = blocks;
  return cudaSuccess;
}

// The scratch of one slab: e (re, im) and the TX index a bin (null planes
// in the plain builds, whose chains never normalize).
struct Scratch {
  float* er;
  float* ei;
  unsigned short* tx;
};

// Bin k of chunk symbol b into the slab's scratch (the front variant).
__device__ __forceinline__ void scratch_store(const Scratch& s, int b_lo, int n, int b, int k, int tx, float er,
                                              float ei) {
  const int i = (b - b_lo) * n + k;
  s.er[i] = er;
  s.ei[i] = ei;
  s.tx[i] = static_cast<unsigned short>(tx);
}

#if OFDM_STAGED
constexpr int kDemapThreads = 256;

// Bin i of the slab's scratch, in data units e (er, ei), with TX index tx:
// x its tile's norm_gain, the dump stage, the decision and popcount.
template <int kMode, bool kDump, class Link>
__device__ __forceinline__ void demap_bin(const Link& L, int b, int k, float er, float ei, int tx, uint32_t& be,
                                          uint32_t& se) {
  const float m = norm_gain<kMode>(L, k, L.st.norm_f[b / L.tile]);
  er = er * m;
  ei = ei * m;
  dump_bin<kMode, kDump>(L, b, k, er, ei);
  count_bin<kMode>(tx, er, ei, L.q, L.lanes, k, be, se);
}

// The counting pass of a normalized slab [b_lo, b_hi): demap_bin on each of
// its bins, then the block's counters (no PAPR: the front variant took
// it).  A grid-stride loop over groups of four consecutive bins, read as
// one 16-byte load of each e plane and an 8-byte load of the index plane
// (the planes are 16-byte aligned: scratch_ok), then the last count % 4
// bins one at a time.
template <int kMode, bool kDump, class Link>
__global__ void __launch_bounds__(kDemapThreads)
    diag_demap(Link L, int b_lo, int b_hi, Scratch s, unsigned long long* acc, double* psum) {
  uint32_t be = 0, se = 0;
  const int count = (b_hi - b_lo) * L.n;
  const int stride = gridDim.x * kDemapThreads;
  for (int q = blockIdx.x * kDemapThreads + threadIdx.x; q < count / 4; q += stride) {
    const float4 r = reinterpret_cast<const float4*>(s.er)[q];
    const float4 m = reinterpret_cast<const float4*>(s.ei)[q];
    const ushort4 t = reinterpret_cast<const ushort4*>(s.tx)[q];
    const float er[4] = {r.x, r.y, r.z, r.w};
    const float ei[4] = {m.x, m.y, m.z, m.w};
    const int tx[4] = {t.x, t.y, t.z, t.w};
    int bo = (4 * q) / L.n;
    int k = 4 * q - bo * L.n;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      demap_bin<kMode, kDump>(L, b_lo + bo, k, er[j], ei[j], tx[j], be, se);
      if (++k == L.n) {
        k = 0;
        ++bo;
      }
    }
  }
  for (int i = count / 4 * 4 + blockIdx.x * kDemapThreads + threadIdx.x; i < count; i += stride) {
    const int bo = i / L.n;
    demap_bin<kMode, kDump>(L, b_lo + bo, i - bo * L.n, s.er[i], s.ei[i], static_cast<int>(s.tx[i]), be, se);
  }
  flush_counters<kDemapThreads / 32>(be, se, 0.0f, 0.0, acc, psum);
}

// A normalized chunk in slabs of `slab` symbols (whole tiles): for each,
// front(b_lo, b_hi) runs the chain to the scratch and writes its run
// partials, norm_factors reduces the slab's tiles, diag_demap counts.
// `demap_grid` bounds the demap kernel's blocks.  Returns the first launch
// error.
template <int kMode, class Link, class Front>
cudaError_t onepass_slabs(const Link& L, int slab, const Scratch& s, int demap_grid, unsigned long long* acc,
                          double* psum, cudaStream_t stream, Front&& front) {
  auto* demap = (L.st.bits & kStageDump) ? &diag_demap<kMode, true, Link> : &diag_demap<kMode, false, Link>;
  for (int b_lo = 0; b_lo < L.chunk; b_lo += slab) {
    const int b_hi = L.chunk - b_lo > slab ? b_lo + slab : L.chunk;
    cudaError_t err = front(b_lo, b_hi);
    if (err != cudaSuccess) return err;
    const int tiles = (b_hi - b_lo + L.tile - 1) / L.tile;
    norm_factors<<<tiles, kNormThreads, 0, stream>>>(L.st.norm_part + b_lo / L.run, L.chunk - b_lo, L.tile,
                                                     L.run, L.n, L.st.norm_f + b_lo / L.tile);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int want = ((b_hi - b_lo) * L.n / 4 + kDemapThreads) / kDemapThreads;
    demap<<<want < demap_grid ? want : demap_grid, kDemapThreads, 0, stream>>>(L, b_lo, b_hi, s, acc, psum);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// Checks a one-pass entry point's scratch: the planes with normalize,
// 16-byte aligned (diag_demap's vector loads), a slab of whole tiles (a
// positive multiple of the tile, or the whole chunk).
inline bool scratch_ok(int bits, const Scratch& s, int slab, int tile, int chunk) {
  if (!(bits & kStageNormalize)) return true;
  const auto aligned = [](const void* p) { return p != nullptr && reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (!aligned(s.er) || !aligned(s.ei) || !aligned(s.tx) || slab < 1) return false;
  return slab % tile == 0 || slab >= chunk;
}
#endif

}  // namespace ofdm
