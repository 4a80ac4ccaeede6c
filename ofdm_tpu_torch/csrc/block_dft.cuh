// The block DFT of the wide chunk kernels (diag_wide's in-run IDFT; fold_wide
// and mm_wide at a width other than 256 J, where wide_dft.cuh runs the same
// butterflies staged): one symbol's orthonormal (I)DFT in a block's shared
// memory, all the block's threads together, __syncthreads between stages.
//
// The TPU kernel multiplies by dense (n, n) DFT matrices on the MXU; the
// JAX package's own XLA path splits every DFT past 256 points in two
// (ofdm_tpu/ops/dft.py::_split_factors, _apply_ct).  Here:
//  * n a power of two: radix-2 decimation in time, the input stored in
//    bit-reversed order (dft_slot), log2 n stages of n / 2 butterflies; the
//    butterfly (i0, i1 = i0 + h) of half-size h takes W_n^(pos * n / 2h):
//    t = w * x[i1], x[i0] = x[i0] + t, x[i1] = x[i0] - t.
//  * any other n: n = N1 * N2 (N1 the largest divisor up to sqrt n), both
//    sub-DFTs direct: A[a, k2] = sum_b x[a + N1 b] W_N2^(b k2) times
//    W_n^(a k2), then X[N2 k1 + k2] = sum_a A[a, k2] W_N1^(a k1).  A prime
//    n is one direct DFT (N1 = 1).
// Every twiddle is an entry of one table W_n^k (k < n; the host's float64
// values rounded to f32, read through the read-only cache), the inverse
// its conjugate.  Each sum runs in ascending order of rounded products and
// the orthonormal scale multiplies the result as the caller reads it
// (DftPlan::scale), so ofdm_tpu_torch/ops/dft.py::block_dft repeats the
// transform bit for bit under -fmad=false.
//
// Cost: (n / 2) log2 n butterflies (10 f32 operations each) on the radix-2
// path, n (N1 + N2 + 1) complex products on the split.

#pragma once

#include <cuda_runtime.h>

namespace ofdm {

// One block DFT's constants (ops/dft.py::DftPlan).
struct DftPlan {
  const float* twr;  // (n,) f32 cos(2 pi k / n)
  const float* twi;  // (n,) f32 -sin(2 pi k / n)
  int n;
  int n1;     // the split's factors (N1 <= N2)
  int n2;
  int log2n;  // >= 0: radix-2; -1: the split
  float scale;  // f32(1 / sqrt(n))
};

// Where input element m is stored before the transform runs: its
// bit-reversed index on the radix-2 path, m itself on the split.
__device__ __forceinline__ int dft_slot(const DftPlan& p, int m) {
  if (p.log2n <= 0) return m;
  return static_cast<int>(__brev(static_cast<unsigned>(m)) >> (32 - p.log2n));
}

// W_n^k, conjugated for the inverse.
__device__ __forceinline__ void dft_twiddle(const DftPlan& p, int k, bool inverse, float& wr, float& wi) {
  wr = __ldg(p.twr + k);
  const float s = __ldg(p.twi + k);
  wi = inverse ? -s : s;
}

// The unscaled (I)DFT of the n values in (ar, ai), each stored at its
// dft_slot; the result ends in (ar, ai) in natural order (the caller
// multiplies by p.scale as it reads).  (br, bi) is n complex of scratch
// for the split.  Every thread of the block calls it; it begins and ends
// with __syncthreads.
template <int kThreads>
__device__ void block_dft(const DftPlan& p, float* ar, float* ai, float* br, float* bi, bool inverse) {
  __syncthreads();
  const int t = threadIdx.x;
  const int n = p.n;
  if (p.log2n >= 0) {
    for (int h = 1; h < n; h <<= 1) {
      const int stride = n / (2 * h);
      for (int q = t; q < n / 2; q += kThreads) {
        const int pos = q & (h - 1);
        const int i0 = ((q - pos) << 1) + pos;
        const int i1 = i0 + h;
        float wr, wi;
        dft_twiddle(p, pos * stride, inverse, wr, wi);
        const float xr = ar[i1];
        const float xi = ai[i1];
        const float tr = wr * xr - wi * xi;
        const float ti = wr * xi + wi * xr;
        const float ur = ar[i0];
        const float ui = ai[i0];
        ar[i0] = ur + tr;
        ai[i0] = ui + ti;
        ar[i1] = ur - tr;
        ai[i1] = ui - ti;
      }
      __syncthreads();
    }
    return;
  }
  const int n1 = p.n1;
  const int n2 = p.n2;
  // A[a, k2] at a * N2 + k2, times W_n^(a k2).
  for (int o = t; o < n; o += kThreads) {
    const int a = o / n2;
    const int k2 = o - a * n2;
    float sr = 0.0f, si = 0.0f;
    int idx = 0;  // (b * k2) mod N2
    for (int b = 0; b < n2; ++b) {
      float wr, wi;
      dft_twiddle(p, idx * n1, inverse, wr, wi);
      const float xr = ar[a + n1 * b];
      const float xi = ai[a + n1 * b];
      sr = sr + (xr * wr - xi * wi);
      si = si + (xr * wi + xi * wr);
      idx += k2;
      if (idx >= n2) idx -= n2;
    }
    float wr, wi;
    dft_twiddle(p, a * k2, inverse, wr, wi);
    br[o] = sr * wr - si * wi;
    bi[o] = sr * wi + si * wr;
  }
  __syncthreads();
  // X[N2 k1 + k2].
  for (int o = t; o < n; o += kThreads) {
    const int k1 = o / n2;
    const int k2 = o - k1 * n2;
    float sr = 0.0f, si = 0.0f;
    int idx = 0;  // (a * k1) mod N1
    for (int a = 0; a < n1; ++a) {
      float wr, wi;
      dft_twiddle(p, idx * n2, inverse, wr, wi);
      const float xr = br[a * n2 + k2];
      const float xi = bi[a * n2 + k2];
      sr = sr + (xr * wr - xi * wi);
      si = si + (xr * wi + xi * wr);
      idx += k1;
      if (idx >= n1) idx -= n1;
    }
    ar[o] = sr;
    ai[o] = si;
  }
  __syncthreads();
}

}  // namespace ofdm
