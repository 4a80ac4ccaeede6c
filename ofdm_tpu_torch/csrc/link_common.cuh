// Device functions shared by the port's kernels: the Philox4x32-10 counter
// generator, the link's arithmetic chain (24-bit uniforms, quarter-range
// cos/sin, the constellation codec: Gray/zig-zag QAM encode and slicer, PSK
// on the cos/sin lattice with the rotation-search sector decision, and their
// per-subcarrier adaptive forms), the per-bin steps the chunk
// kernels run (tile sigma, noise, equalizer, error count, the block's
// counter flush), a dense product column (the diag kernel's in-run PAPR),
// and the _Spec stages (TX sqrt(P), post-EQ noise, 1/sqrt(P), per-tile
// unit power) with their normalization reduction.
//
// The stages are compiled only into a second build of each chunk source,
// with -DOFDM_STAGED=1, whose kernels take their `kStaged` template
// parameter true; the plain build's take it false, so every
// `if constexpr (kStaged)` block vanishes there and its kernels compile
// from the code they had.  The noise-bump stages of the fold, lr, mm and
// diag_wide mains live in a third build, with -DOFDM_BUMP=1 as well
// (kBumpBuild), for the same reason.
//
// Each function repeats, operation for operation, the plain PyTorch version
// in ofdm_tpu_torch/ops/{prng,link_kernel}.py.  The kernels are compiled
// with -fmad=false so no multiply-add pair is contracted into an FMA: the
// plain version rounds after every multiply, and so does this code.

#pragma once

#include <cstdint>
#include <type_traits>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#ifndef OFDM_STAGED
#define OFDM_STAGED 0
#endif
#ifndef OFDM_BUMP
#define OFDM_BUMP 0
#endif

namespace ofdm {

// Whether this build holds the staged kernels (-DOFDM_STAGED=1).
constexpr bool kStagedBuild = OFDM_STAGED != 0;
// Whether this staged build holds the noise-bump stages (-DOFDM_BUMP=1): the
// fold, lr, mm and diag_wide mains compiled with them (kBump) in a third
// build of their sources, so the staged build's mains keep the code they
// had and the two builds compile side by side.
constexpr bool kBumpBuild = OFDM_STAGED != 0 && OFDM_BUMP != 0;

// Philox4x32-10 (Salmon et al., SC'11; Random123's constants).  Counter
// (c.x, c.y, c.z, c.w), key (k.x, k.y).
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += 0x9E3779B9u;
    k.y += 0xBB67AE85u;
  }
  return c;
}

// u = ((w >> 8) & 0xFFFFFF) * 2^-24, floored at 2^-24: the Box-Muller
// radius sqrt(-2 ln u) then caps at 5.77.
__device__ __forceinline__ float uniform24_floored(uint32_t w) {
  const float u = static_cast<float>((w >> 8) & 0xFFFFFFu) * (1.0f / 16777216.0f);
  return fmaxf(u, 1.0f / 16777216.0f);
}

// (cos, sin) of 2*pi*u/2^24 for u in [0, 2^24): two quadrant bits, then
// degree-5 polynomials in t^2 on the quarter range (the same coefficients,
// rounded double -> float, as the plain version).
__device__ __forceinline__ void cossin_u24(uint32_t u, float& co, float& si) {
  const uint32_t q = u >> 22;
  const float t = static_cast<float>(u & 0x3FFFFFu) * (1.0f / 4194304.0f);
  const float z = t * t;
  float c = static_cast<float>(-2.3824535570835603e-05);
  c = c * z + static_cast<float>(0.0009177238850913491);
  c = c * z + static_cast<float>(-0.020862687553451876);
  c = c * z + static_cast<float>(0.253669322476019);
  c = c * z + static_cast<float>(-1.2337005342705918);
  c = c * z + static_cast<float>(0.9999999997799593);
  float s = static_cast<float>(-3.4318293237942273e-06);
  s = s * z + static_cast<float>(0.0001602546914451647);
  s = s * z + static_cast<float>(-0.004681657796259286);
  s = s * z + static_cast<float>(0.0796926037175787);
  s = s * z + static_cast<float>(-0.6459640955781804);
  s = s * z + static_cast<float>(1.5707963267681528);
  s = t * s;
  const bool swap = (q & 1u) != 0u;
  float c0 = swap ? s : c;
  float s0 = swap ? c : s;
  if (((q ^ (q >> 1)) & 1u) != 0u) c0 = -c0;
  if (q >= 2u) s0 = -s0;
  co = c0;
  si = s0;
}

// Square-QAM geometry and the slicer-units gain.
struct Qam {
  int order;  // M
  int m;      // sqrt(M)
  int logm;   // log2(m)
  int bits;   // log2(M)
  int gray;   // 1: Gray + zig-zag table, 0: natural order
  float scale;
};

// raw word -> (index, point): the reference table, computed arithmetically.
__device__ __forceinline__ int qam_encode(uint32_t raw, const Qam& q, float& sr, float& si) {
  const int tx = static_cast<int>(raw & static_cast<uint32_t>(q.order - 1));
  int p = tx;
  if (q.gray) {
    const int row = tx >> q.logm;
    const int col = tx & (q.m - 1);
    const int colz = (row & 1) ? (q.m - 1 - col) : col;
    const int g = (row << q.logm) | colz;
    p = g ^ (g >> 1);
  }
  const float c2 = static_cast<float>(p & (q.m - 1));
  const float r2 = static_cast<float>(p >> q.logm);
  const float mm1 = static_cast<float>(q.m - 1);
  sr = (2.0f * c2 - mm1) * q.scale;
  si = (mm1 - 2.0f * r2) * q.scale;
  return tx;
}

// Equalized point in slicer units -> index.  The clip happens in float
// before the int conversion: dead bins give gains near 1e10, and a
// float -> int conversion out of range is undefined.
__device__ __forceinline__ int qam_demap(float er, float ei, const Qam& q) {
  const float c0 = static_cast<float>(q.m - 1) * 0.5f;
  const float mf1 = static_cast<float>(q.m - 1);
  const int cc = static_cast<int>(fminf(fmaxf(rintf(er + c0), 0.0f), mf1));
  const int rr = static_cast<int>(fminf(fmaxf(rintf(c0 - ei), 0.0f), mf1));
  const int pp = rr * q.m + cc;
  if (!q.gray) return pp;
  int j = pp;
  for (int sh = 1; sh < q.bits; sh <<= 1) j ^= j >> sh;
  const int rowj = j >> q.logm;
  const int colj = j & (q.m - 1);
  const int colzj = (rowj & 1) ? (q.m - 1 - colj) : colj;
  return (rowj << q.logm) | colzj;
}

// --- the constellation codec in its four modes ------------------------------------
//
// pallas_link._Spec.mode.  A kernel is compiled for one mode, a template
// parameter beside its width, so no kernel branches on the mode at run time
// and the qam instantiation carries none of the other modes' code.
enum Mode : int { kQam = 0, kPsk = 1, kAqam = 2, kApsk = 3 };

__host__ __device__ constexpr bool adaptive(int mode) { return mode == kAqam || mode == kApsk; }

// The adaptive modes' lane rows, read by bin index k (link_kernel.Codec):
// aqam irow = [mask, m, log2 m], frow = [scale, slicer 0.5/scale]; apsk
// irow = [mask, order, log2 order], frow = [amplitude, cos(pi/M),
// sin(pi/M)].  Null for qam and psk, whose Qam fields are scalars (psk:
// order, bits = log2 M, gray; adaptive: bits = the static width).
struct Lanes {
  const int* irow;
  const float* frow;
  int n;  // row stride
};

// Prefix-XOR inverse Gray code unrolled to `width` bits.
__device__ __forceinline__ int inverse_gray(int g, int width) {
  for (int sh = 1; sh < width; sh <<= 1) g ^= g >> sh;
  return g;
}

// f32 cos / sin of pi / 2^(i+1), i < 12 (orders up to 4096): the rotation
// constants of the PSK sector search and its half-sector test at order
// 2^(i+1), rounded from the same doubles as pallas_link.psk_sector_arith.
__constant__ float kRotCos[12] = {
    0x1.1a6264p-54f, 0x1.6a09e6p-1f, 0x1.d906bcp-1f, 0x1.f6297cp-1f, 0x1.fd88dap-1f, 0x1.ff621ep-1f,
    0x1.ffd886p-1f,  0x1.fff622p-1f, 0x1.fffd88p-1f, 0x1.ffff62p-1f, 0x1.ffffd8p-1f, 0x1.fffff6p-1f};
__constant__ float kRotSin[12] = {
    0x1.0p+0f,       0x1.6a09e6p-1f, 0x1.87de2ap-2f, 0x1.8f8b84p-3f, 0x1.917a6cp-4f,  0x1.91f66p-5f,
    0x1.92156p-6f,   0x1.921d2p-7f,  0x1.921f1p-8f,  0x1.921f8cp-9f, 0x1.921faap-10f, 0x1.921fb2p-11f};

// round(angle(e) * M / 2pi) mod M without atan2 (pallas_link.psk_sector_arith):
// two sign tests, then a binary search that rotates the point back by a
// constant phasor at each step; the same f32 operations in the same order.
__device__ __forceinline__ int psk_sector(float er, float ei, int m, int logm) {
  int s = 0;
  if (ei < 0.0f) {
    s = m >> 1;
    er = -er;
    ei = -ei;
  }
  if (m >= 4 && er < 0.0f) {
    s += m >> 2;
    const float nr = ei;
    ei = -er;
    er = nr;
  }
  int i = 1;
  for (int step = m >> 3; step >= 1; step >>= 1, ++i) {
    const float ca = kRotCos[i];
    const float sa = kRotSin[i];
    const float ni = ei * ca - er * sa;
    if (ni >= 0.0f) {
      s += step;
      const float nr = er * ca + ei * sa;
      er = nr;
      ei = ni;
    }
  }
  const bool t = ei * kRotCos[logm - 1] - er * kRotSin[logm - 1] >= 0.0f;
  return (s + (t ? 1 : 0)) & (m - 1);
}

// psk_sector at a per-lane order m (1 on an inactive lane, whose sector
// masks to 0) with the lane's half-sector cos / sin, looping to the static
// width `bits` (pallas_link.psk_sector_arith_vec): a lane whose step has
// reached 0 stops accumulating and rotating.
__device__ __forceinline__ int psk_sector_lane(float er, float ei, int m, float cpm, float spm,
                                               int bits) {
  int s = 0;
  if (ei < 0.0f) {
    s = m >> 1;
    er = -er;
    ei = -ei;
  }
  if (bits >= 2 && er < 0.0f && m >= 4) {
    s += m >> 2;
    const float nr = ei;
    ei = -er;
    er = nr;
  }
  for (int shift = 3; shift <= bits; ++shift) {
    const int step = m >> shift;
    const float ca = kRotCos[shift - 2];
    const float sa = kRotSin[shift - 2];
    const float ni = ei * ca - er * sa;
    if (ni >= 0.0f && step >= 1) {
      s += step;
      const float nr = er * ca + ei * sa;
      er = nr;
      ei = ni;
    }
  }
  const bool t = ei * cpm - er * spm >= 0.0f;
  return (s + (t ? 1 : 0)) & (m - 1);
}

// The TX index of a raw word at bin k: the masked draw.
template <int kMode>
__device__ __forceinline__ int tx_index(uint32_t raw, const Qam& q, const Lanes& r, int k) {
  if constexpr (adaptive(kMode)) {
    return static_cast<int>(raw & static_cast<uint32_t>(__ldg(r.irow + k)));
  } else {
    return static_cast<int>(raw & static_cast<uint32_t>(q.order - 1));
  }
}

// raw word -> (index, point) of bin k (pallas_link._encode_tile).  PSK
// points lie on cossin_u24's lattice at angle p << (24 - log2 M), the
// polynomial pair of the noise phase; an inactive adaptive lane sends 0.
template <int kMode>
__device__ __forceinline__ int encode(uint32_t raw, const Qam& q, const Lanes& r, int k, float& sr,
                                      float& si) {
  if constexpr (kMode == kQam) {
    return qam_encode(raw, q, sr, si);
  } else if constexpr (kMode == kPsk) {
    const int tx = tx_index<kMode>(raw, q, r, k);
    const int p = q.gray ? inverse_gray(tx, q.bits) : tx;
    cossin_u24(static_cast<uint32_t>(p) << (24 - q.bits), sr, si);
    return tx;
  } else if constexpr (kMode == kAqam) {
    const int tx = tx_index<kMode>(raw, q, r, k);
    const int m = __ldg(r.irow + r.n + k);
    const int lm = __ldg(r.irow + 2 * r.n + k);
    const int row = tx >> lm;
    const int col = tx & (m - 1);
    const int colz = (row & 1) ? (m - 1 - col) : col;
    const int g = (row << lm) | colz;
    const int p = g ^ (g >> 1);
    const float mf = static_cast<float>(m);
    const float c2 = static_cast<float>(p & (m - 1));
    const float r2 = static_cast<float>(p >> lm);
    const float sc = __ldg(r.frow + k);
    sr = (2.0f * c2 - (mf - 1.0f)) * sc;
    si = ((mf - 1.0f) - 2.0f * r2) * sc;
    return tx;
  } else {
    const int tx = tx_index<kMode>(raw, q, r, k);
    const int lb = __ldg(r.irow + 2 * r.n + k);
    const int p = inverse_gray(tx, q.bits);
    float co, sn;
    cossin_u24(static_cast<uint32_t>(p) << (24 - lb), co, sn);
    const float amp = __ldg(r.frow + k);
    sr = co * amp;
    si = sn * amp;
    return tx;
  }
}

// Equalized point of bin k -> index (pallas_link._demap_tile): QAM in
// slicer units, PSK scale-free.
template <int kMode>
__device__ __forceinline__ int demap(float er, float ei, const Qam& q, const Lanes& r, int k) {
  if constexpr (kMode == kQam) {
    return qam_demap(er, ei, q);
  } else if constexpr (kMode == kPsk) {
    const int s = psk_sector(er, ei, q.order, q.bits);
    return q.gray ? (s ^ (s >> 1)) : s;
  } else if constexpr (kMode == kAqam) {
    const int m = __ldg(r.irow + r.n + k);
    const int lm = __ldg(r.irow + 2 * r.n + k);
    const float mf = static_cast<float>(m);
    const float c0 = (mf - 1.0f) * 0.5f;
    const int cc = static_cast<int>(fminf(fmaxf(rintf(er + c0), 0.0f), mf - 1.0f));
    const int rr = static_cast<int>(fminf(fmaxf(rintf(c0 - ei), 0.0f), mf - 1.0f));
    const int j = inverse_gray(rr * m + cc, q.bits);
    const int rowj = j >> lm;
    const int colj = j & (m - 1);
    const int colzj = (rowj & 1) ? (m - 1 - colj) : colj;
    return (rowj << lm) | colzj;
  } else {
    const int s = psk_sector_lane(er, ei, __ldg(r.irow + r.n + k), __ldg(r.frow + r.n + k),
                                  __ldg(r.frow + 2 * r.n + k), q.bits);
    return s ^ (s >> 1);
  }
}

// Calls f(std::integral_constant<int, mode>()) for a runtime mode, so a
// launcher instantiates its kernels once per mode.
template <class F>
cudaError_t with_mode(int mode, F&& f) {
  switch (mode) {
    case kQam: return f(std::integral_constant<int, kQam>());
    case kPsk: return f(std::integral_constant<int, kPsk>());
    case kAqam: return f(std::integral_constant<int, kAqam>());
    case kApsk: return f(std::integral_constant<int, kApsk>());
    default: return cudaErrorInvalidValue;
  }
}

// --- the per-bin chain both chunk kernels run ----------------------------------

// The three words of bin k of run symbol `sym`: counter (sym lo, sym hi, k, 0).
__device__ __forceinline__ uint4 symbol_words(unsigned long long sym, int k, uint2 key) {
  return philox4x32_10(
      make_uint4(static_cast<uint32_t>(sym), static_cast<uint32_t>(sym >> 32),
                 static_cast<uint32_t>(k), 0u),
      key);
}

// sigma of a tile from its measured-power partials, summed in order over the
// `count` elements of its slice; the mean is scaled by pw_scale (n/T on a
// zero-prefix lr link, else 1, which is exact).
__device__ __forceinline__ float tile_sigma(const float* partials, int groups, int count,
                                            float snr_lin, float pw_scale = 1.0f) {
  float tot = 0.0f;
  for (int g = 0; g < groups; ++g) tot = tot + partials[g];
  const float mp = (tot / static_cast<float>(count)) * pw_scale;
  return sqrtf(mp / snr_lin / 2.0f);
}

// A complex normal from two words: radius from w1's 24-bit uniform, phase
// from w2's.
__device__ __forceinline__ void box_muller(uint32_t w1, uint32_t w2, float& zr, float& zi) {
  const float u1 = uniform24_floored(w1);
  const float rad = sqrtf(-2.0f * logf(u1));
  float co, sn;
  cossin_u24((w2 >> 8) & 0xFFFFFFu, co, sn);
  zr = rad * co;
  zi = rad * sn;
}

// y += sigma * Box-Muller(w1, w2).
__device__ __forceinline__ void add_noise(uint32_t w1, uint32_t w2, float sigma, float& yr,
                                          float& yi) {
  float zr, zi;
  box_muller(w1, w2, zr, zi);
  yr = yr + sigma * zr;
  yi = yi + sigma * zi;
}

// y += sigma * (Box-Muller(w1, w2) + c): c is the colored part of a
// zero-prefix link's bin noise.
__device__ __forceinline__ void add_noise(uint32_t w1, uint32_t w2, float cr, float ci,
                                          float sigma, float& yr, float& yi) {
  float zr, zi;
  box_muller(w1, w2, zr, zi);
  zr = zr + cr;
  zi = zi + ci;
  yr = yr + sigma * zr;
  yi = yi + sigma * zi;
}

// Equalizer rows and mode of a link.
struct Equalizer {
  const float* hr;
  const float* hi;
  const float* habs2;
  const float* gr;  // ZF gain rows, slicer gain folded in
  const float* gi;
  float slicer;  // 0.5 / scale
  float cg;      // mean |h|^2
  int method;    // 0 ZF, 1 MMSE, 2 none
};

// MMSE noise variance of the warp's symbol (lane holds bins lane + 32 j):
// per-lane sum in j order, then an xor butterfly, so every lane has the
// same bits.  0 for the other equalizers.
template <int J>
__device__ __forceinline__ float mmse_nv(const Equalizer& eq, const float (&yr)[J],
                                         const float (&yi)[J], int lane, int n, float snr_lin) {
  if (eq.method != 1) return 0.0f;
  float p = 0.0f;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    if (lane + 32 * j < n) p = p + (yr[j] * yr[j] + yi[j] * yi[j]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) p = p + __shfl_xor_sync(0xFFFFFFFFu, p, off);
  const float sp = p / static_cast<float>(n);
  return sp / snr_lin / eq.cg;
}

// Sum of one value a thread over the block: an xor butterfly in each warp,
// then the warps' sums in warp order, so every thread gets the same bits
// (link_kernel.block_sum repeats it).  `wsum` holds kWarps floats of shared
// memory; every thread of the block must call it.
template <int kWarps>
__device__ __forceinline__ float block_sum(float v, float* wsum) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = v + __shfl_xor_sync(0xFFFFFFFFu, v, off);
  if ((threadIdx.x & 31) == 0) wsum[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.0f;
  for (int w = 0; w < kWarps; ++w) s = s + wsum[w];
  __syncthreads();
  return s;
}

// --- sums over a thread-block cluster ------------------------------------------

// out[i] = the sum over the cluster's blocks, in block-rank order, of each
// block's part[i] (its own shared memory, read through distributed shared
// memory), for i < cnt, in every block of the cluster: a symbol past one
// block's bins is held by a cluster of blocks, one slice each, and its sums
// are the slices' sums in slice order (link_kernel.block_sum's slice).  The
// first cluster barrier publishes every block's part, the second keeps part
// until every block has read it and publishes out.  Every thread of every
// block of the cluster must call it.
__device__ __forceinline__ void cluster_totals(float* part, float* out, int cnt, int blocks) {
  cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
  cl.sync();
  for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
    float s = 0.0f;
    for (int q = 0; q < blocks; ++q) s = s + cl.map_shared_rank(part, q)[i];
    out[i] = s;
  }
  cl.sync();
}

// Launches kernel<<<grid, threads, bytes, stream>>>(args...), as clusters of
// `cluster` blocks along the grid's dimension `dim` (0: x, 1: y) where
// cluster > 1 (cudaLaunchKernelEx with cudaLaunchAttributeClusterDimension),
// after raising the kernel's dynamic shared memory limit to `bytes`.
template <class... Params, class... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), dim3 grid, int threads, int bytes, int cluster, int dim,
                            cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  if (cluster <= 1) {
    kernel<<<grid, threads, bytes, stream>>>(args...);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = static_cast<size_t>(bytes);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = dim == 0 ? cluster : 1;
  attr[0].val.clusterDim.y = dim == 1 ? cluster : 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Bin k equalized into slicer units (the slicer gain: 0.5/scale for qam,
// 1 for PSK).  MMSE is tested first: in this order nvcc emits plain
// branches instead of a jump table, and diag_main runs faster on an H100
// (the headline link is MMSE).
__device__ __forceinline__ void equalize_bin(const Equalizer& eq, int k, float yr, float yi,
                                             float nv, float& er, float& ei) {
  if (eq.method == 1) {
    const float hr = __ldg(eq.hr + k);
    const float hi = __ldg(eq.hi + k);
    const float g = eq.slicer / (__ldg(eq.habs2 + k) + nv);
    er = (yr * hr + yi * hi) * g;
    ei = (yi * hr - yr * hi) * g;
  } else if (eq.method == 0) {
    const float gr = __ldg(eq.gr + k);
    const float gi = __ldg(eq.gi + k);
    er = yr * gr - yi * gi;
    ei = yi * gr + yr * gi;
  } else {
    er = yr * eq.slicer;
    ei = yi * eq.slicer;
  }
}

// equalize_bin in mode kMode: aqam's slicer gain is the lane's row (the ZF
// rows carry it folded in); every other mode takes the scalar.
template <int kMode>
__device__ __forceinline__ void equalize_bin(const Equalizer& eq, const Lanes& lanes, int k,
                                             float yr, float yi, float nv, float& er, float& ei) {
  if constexpr (kMode == kAqam) {
    Equalizer lane_eq = eq;
    lane_eq.slicer = __ldg(lanes.frow + lanes.n + k);
    equalize_bin(lane_eq, k, yr, yi, nv, er, ei);
  } else {
    equalize_bin(eq, k, yr, yi, nv, er, ei);
  }
}

// Slice bin k and add its bit and symbol errors against tx.
template <int kMode>
__device__ __forceinline__ void count_bin(int tx, float er, float ei, const Qam& q,
                                          const Lanes& lanes, int k, uint32_t& be, uint32_t& se) {
  const int x = tx ^ demap<kMode>(er, ei, q, lanes, k);
  be += static_cast<uint32_t>(__popc(x));
  se += x != 0 ? 1u : 0u;
}

// --- the _Spec stages (OFDM_STAGED builds) ------------------------------------------
//
// pallas_link._Spec's apply_power, normalize, post_noise, compensate and
// dump (pallas_link.py:1437-1443, 1826-1879): bits of Stages::bits.
enum StageBit : int {
  kStagePower = 1,
  kStageNormalize = 2,
  kStagePostNoise = 4,
  kStageCompensate = 8,
  kStageDump = 16
};

// The stage fields every chunk kernel's Link carries last.  rows: (R, n)
// per-lane rows of the chunk, [sqrt(P), 1/sqrt(P), post-EQ sigma] (R >= 1
// with apply_power, 3 with the noise-bump stages); phase 0 is the
// normalization pass (each warp or block writes the |e|^2 sum of its run
// of consecutive symbols to norm_part), phase 1 the counting pass, which
// reads each tile's factor from norm_f.  With kStageDump the counting pass
// writes the points of the chunk's first dump_rows symbols, in data units,
// to the (dump_rows, n) planes dump_r / dump_i (only the staged builds
// carry these fields, so the plain builds' kernels keep their parameters).
struct Stages {
  const float* rows;
  int bits;
  int phase;
  float* norm_part;  // a float a run
  float* norm_f;     // a float a tile
#if OFDM_STAGED
  float* dump_r;
  float* dump_i;
  int dump_rows;
#endif
};

// x sqrt(P) of bin k right after encode (the apply_power stage).
template <bool kStaged, class Link>
__device__ __forceinline__ void scale_tx(const Link& L, int k, float& sr, float& si) {
  if constexpr (kStaged) {
    if (L.st.bits & kStagePower) {
      const float p = __ldg(L.st.rows + k);
      sr = sr * p;
      si = si * p;
    }
  }
}

// Bin k equalized; under normalize the slicer gain is deferred past the
// normalization (defer_slicer, pallas_link.py:1772): the gain is 1 here,
// the raw ZF rows come from the host.  aqam on SC-FDE (`sc`) defers its
// lane row past the SC IDFT in any case (sc_slicer_bin): lane t's order
// demaps time sample t (link_kernel.deferred_lane_slicer).
template <int kMode, bool kStaged, class Link>
__device__ __forceinline__ void equalize_stage(const Link& L, int k, float yr, float yi, float nv,
                                               float& er, float& ei, bool sc = false) {
  bool unit_gain = false;
  if constexpr (kStaged) unit_gain = (L.st.bits & kStageNormalize) != 0;
  if constexpr (kMode == kAqam) unit_gain = unit_gain || sc;
  if constexpr (kStaged || kMode == kAqam) {
    if (unit_gain) {
      Equalizer unit = L.eq;
      unit.slicer = 1.0f;
      equalize_bin(unit, k, yr, yi, nv, er, ei);
      return;
    }
  }
  equalize_bin<kMode>(L.eq, L.lanes, k, yr, yi, nv, er, ei);
}

// aqam on SC-FDE without normalize: time sample k x the lane's slicer row
// 0.5/scale, after the SC IDFT and the noise-bump stages, just before the
// slicer (link_kernel.sc_slicer; under normalize norm_gain carries the
// row).  Nothing in the other modes.
template <int kMode, bool kStaged, class Link>
__device__ __forceinline__ void sc_slicer_bin(const Link& L, int k, float& er, float& ei) {
  if constexpr (kMode == kAqam) {
    bool normalize = false;
    if constexpr (kStaged) normalize = (L.st.bits & kStageNormalize) != 0;
    if (L.is_sc && !normalize) {
      const float s = __ldg(L.lanes.frow + L.lanes.n + k);
      er = er * s;
      ei = ei * s;
    }
  }
}

// e += (sigma * radius) * (cos, sin): the post-EQ noise of one bin from its
// two words, in the reference kernel's operation order (the post_noise stage).
__device__ __forceinline__ void post_noise(uint32_t w1, uint32_t w2, float sigma, float& er,
                                           float& ei) {
  const float u1 = uniform24_floored(w1);
  const float rad = sqrtf(-2.0f * logf(u1));
  float co, sn;
  cossin_u24((w2 >> 8) & 0xFFFFFFu, co, sn);
  const float sr = sigma * rad;
  er = er + sr * co;
  ei = ei + sr * sn;
}

// The noise-bump stages of lane k of run symbol `sym`, where the reference
// kernel has them (pallas_link.py:1824-1846): after the equalizer and the
// SC-FDE IDFT (so k is a time sample on SC-FDE), before the normalization.
// post_noise adds sigma rows[2][k] x Box-Muller of the words of Philox
// counter (sym lo, sym hi, k, 3); compensate multiplies by rows[1][k]
// (1/sqrt(P)).  Both passes of a normalized chunk call it, so the
// normalization energy sees the points the counting pass counts.  The
// fold, lr, mm and diag_wide mains take it as a template parameter (kBump),
// true in the OFDM_BUMP build only (kBumpBuild).
template <bool kStaged, class Link>
__device__ __forceinline__ void bump_stages(const Link& L, unsigned long long sym, int k, float& er,
                                            float& ei) {
  if constexpr (kStaged) {
    if (L.st.bits & kStagePostNoise) {
      const uint4 w = philox4x32_10(
          make_uint4(static_cast<uint32_t>(sym), static_cast<uint32_t>(sym >> 32), static_cast<uint32_t>(k), 3u),
          L.key);
      post_noise(w.y, w.z, __ldg(L.st.rows + 2 * L.n + k), er, ei);
    }
    if (L.st.bits & kStageCompensate) {
      const float c = __ldg(L.st.rows + L.n + k);
      er = er * c;
      ei = ei * c;
    }
  }
}

// The normalize stage's multiplier of bin k: the tile's factor f with the
// deferred slicer gain riding it (f * 0.5/scale for qam, f * the lane's row
// for aqam, f for PSK).
template <int kMode, class Link>
__device__ __forceinline__ float norm_gain(const Link& L, int k, float f) {
  if constexpr (kMode == kQam) {
    return f * L.eq.slicer;
  } else if constexpr (kMode == kAqam) {
    return f * __ldg(L.lanes.frow + L.lanes.n + k);
  } else {
    return f;
  }
}

// The dump stage (pallas_link.py:1863-1879): bin k of chunk symbol b, ready
// for the slicer, written in data units when b is one of the first
// dump_rows symbols: qam x f32(1 / slicer) (one rounded division, as the
// JAX stage's f64 reciprocal rounded to f32), aqam / the lane's slicer row,
// PSK raw.
// The counting pass calls it just before count_bin; it changes nothing else.
// kDump is a template parameter of the staged main kernels, instantiated
// both ways in the staged builds and chosen at launch from kStageDump, so
// a chunk without capture runs the staged code it had without the stage.
template <int kMode, bool kDump, class Link>
__device__ __forceinline__ void dump_bin(const Link& L, int b, int k, float er, float ei) {
#if OFDM_STAGED
  if constexpr (kDump) {
    if (b < L.st.dump_rows) {
      float dr = er, di = ei;
      if constexpr (kMode == kQam) {
        const float u = 1.0f / L.eq.slicer;
        dr = er * u;
        di = ei * u;
      } else if constexpr (kMode == kAqam) {
        const float s = __ldg(L.lanes.frow + L.lanes.n + k);
        dr = er / s;
        di = ei / s;
      }
      const long long i = static_cast<long long>(b) * L.n + k;
      L.st.dump_r[i] = dr;
      L.st.dump_i[i] = di;
    }
  }
#endif
}

// Sum of |e|^2 over a warp's symbol (lane holds bins lane + 32 j): per-lane
// sum in j order, then an xor butterfly, as mmse_nv sums |y|^2.
template <int J>
__device__ __forceinline__ float warp_energy(const float (&er)[J], const float (&ei)[J], int lane, int n) {
  float p = 0.0f;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    if (lane + 32 * j < n) p = p + (er[j] * er[j] + ei[j] * ei[j]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) p = p + __shfl_xor_sync(0xFFFFFFFFu, p, off);
  return p;
}

// --- a dense product column (the diag kernel's in-run PAPR: papr_columns) ----------

// out[t] = sum_k v[k] * M[k, t] over k < rows, k ascending (M row-major, `cols` wide).
__device__ __forceinline__ void cdot(const float* vr, const float* vi, const float* mr,
                                     const float* mi, int rows, int cols, int t, float& outr,
                                     float& outi) {
  float xr = 0.0f, xi = 0.0f;
  for (int k = 0; k < rows; ++k) {
    const float a = vr[k];
    const float c = vi[k];
    const float f_r = __ldg(mr + k * cols + t);
    const float f_i = __ldg(mi + k * cols + t);
    xr = xr + (a * f_r - c * f_i);
    xi = xi + (a * f_i + c * f_r);
  }
  outr = xr;
  outi = xi;
}

// Block sum of red[0..N) by a halving tree (red is overwritten); every
// thread of the block must call it.  The sum is red[0] afterwards.
template <int N>
__device__ __forceinline__ void tree_sum(float* red, int t) {
  for (int s = N / 2; s > 0; s >>= 1) {
    if (t < s) red[t] = red[t] + red[t + s];
    __syncthreads();
  }
}

// The closing step of the power kernels (power_partials, fold_power,
// lr_power), in the order their plain versions reproduce: thread t's
// partial acc, then the block's halving tree; thread 0 stores the sum in
// *out.  red holds N floats; every thread of the block must call it.
template <int N>
__device__ __forceinline__ void store_block_sum(float acc, float* red, int t, float* out) {
  red[t] = acc;
  __syncthreads();
  tree_sum<N>(red, t);
  if (t == 0) *out = red[0];
}

// A power block whose threads staged their |y|^2 in element order in
// red[0 .. kSteps * N): thread t sums elements j * N + t, j ascending, and
// the block sum goes to *out as store_block_sum makes it.
template <int N, int kSteps>
__device__ __forceinline__ void power_block_partial(float* red, int t, float* out) {
  __syncthreads();
  float acc = 0.0f;
  for (int j = 0; j < kSteps; ++j) acc = acc + red[j * N + t];
  __syncthreads();
  store_block_sum<N>(acc, red, t, out);
}

// The block's counters into acc = [bit errors, symbol errors, PAPR peak f32
// bits] and psum: warp shuffles, then one thread sums the warps and issues
// one atomic each.  The peak is an atomicMax on the f32 bit pattern
// (non-negative floats order like their bits); the sum is a double
// atomicAdd, so its last digits depend on block order.  Every thread of the
// block must call it.
template <int kWarps>
__device__ __forceinline__ void flush_counters(uint32_t be, uint32_t se, float pk, double ps,
                                               unsigned long long* acc, double* psum) {
  __shared__ unsigned long long red_be[kWarps];
  __shared__ unsigned long long red_se[kWarps];
  __shared__ float red_pk[kWarps];
  __shared__ double red_ps[kWarps];
  const unsigned full = 0xFFFFFFFFu;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned long long be64 = be, se64 = se;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    be64 += __shfl_xor_sync(full, be64, off);
    se64 += __shfl_xor_sync(full, se64, off);
    pk = fmaxf(pk, __shfl_xor_sync(full, pk, off));
    ps += __shfl_xor_sync(full, ps, off);
  }
  if (lane == 0) {
    red_be[warp] = be64;
    red_se[warp] = se64;
    red_pk[warp] = pk;
    red_ps[warp] = ps;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long tb = 0, ts = 0;
    float tp = 0.0f;
    double tps = 0.0;
    for (int w = 0; w < kWarps; ++w) {
      tb += red_be[w];
      ts += red_se[w];
      tp = fmaxf(tp, red_pk[w]);
      tps += red_ps[w];
    }
    atomicAdd(acc + 0, tb);
    atomicAdd(acc + 1, ts);
    atomicMax(acc + 2, static_cast<unsigned long long>(__float_as_uint(tp)));
    atomicAdd(psum, tps);
  }
}

// --- the normalization reduction and the staged launches ------------------------------

#if OFDM_STAGED
constexpr int kNormThreads = 256;

// Each tile's unit-power factor f = 1/sqrt(mean |e|^2), or 1 where that mean
// is <= 1e-10 (pallas_link.py:1853-1854), from its runs' partials: thread t
// sums partials t, t + 256, ... in order, then the block's halving tree;
// the mean is over the tile's tlen * n points.  One block a tile.
__global__ void __launch_bounds__(kNormThreads)
    norm_factors(const float* part, int chunk, int tile, int run, int n, float* f) {
  __shared__ float red[kNormThreads];
  const int t = threadIdx.x;
  const int b0 = blockIdx.x * tile;
  const int tlen = min(tile, chunk - b0);
  const int r0 = b0 / run;
  const int nr = (tlen + run - 1) / run;
  float acc = 0.0f;
  for (int j = t; j < nr; j += kNormThreads) acc = acc + part[r0 + j];
  red[t] = acc;
  __syncthreads();
  tree_sum<kNormThreads>(red, t);
  if (t == 0) {
    const float avg = red[0] / static_cast<float>(tlen * n);
    f[blockIdx.x] = avg > 1e-10f ? 1.0f / sqrtf(avg) : 1.0f;
  }
}

// A chunk's normalization between its two passes: `pass(0)` writes the run
// partials, norm_factors reduces them per tile, `pass(1)` counts.  Without
// normalize only pass(1) runs.  Returns the first launch error.
template <class Pass>
cudaError_t staged_passes(int bits, const float* part, float* f, int chunk, int tile, int run, int n,
                          cudaStream_t stream, Pass&& pass) {
  if (bits & kStageNormalize) {
    cudaError_t err = pass(0);
    if (err != cudaSuccess) return err;
    norm_factors<<<(chunk + tile - 1) / tile, kNormThreads, 0, stream>>>(part, chunk, tile, run, n, f);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return pass(1);
}
#endif

// Checks an entry point's stage arguments: none in a plain build; in a
// staged build the rows with apply_power or the noise-bump stages, the
// normalization scratch with normalize and the dump planes with dump; the
// noise-bump stages only where the entry point runs them (`post_ok`: the
// chunks of the builds that hold them, not the carry probes, which compute
// TX only).
inline bool stage_args_ok(const float* rows, int bits, const float* part, const float* f,
                          const float* dump_r, const float* dump_i, int dump_rows, bool post_ok) {
  if (!kStagedBuild) return bits == 0;
  if (bits & ~(kStagePower | kStageNormalize | kStagePostNoise | kStageCompensate | kStageDump)) return false;
  if ((bits & (kStagePostNoise | kStageCompensate)) && !post_ok) return false;
  if ((bits & (kStagePower | kStagePostNoise | kStageCompensate)) && rows == nullptr) return false;
  if ((bits & kStageNormalize) && (part == nullptr || f == nullptr)) return false;
  if ((bits & kStageDump) && (dump_r == nullptr || dump_i == nullptr || dump_rows < 1)) return false;
  return true;
}

// The Stages of an entry point's arguments (the dump fields in the staged
// builds only; the counting pass is phase 1).
inline Stages make_stages(const float* rows, int bits, float* part, float* f, float* dump_r, float* dump_i,
                          int dump_rows) {
  Stages st{rows, bits, 1, part, f};
#if OFDM_STAGED
  st.dump_r = dump_r;
  st.dump_i = dump_i;
  st.dump_rows = dump_rows;
#else
  (void)dump_r;
  (void)dump_i;
  (void)dump_rows;
#endif
  return st;
}

}  // namespace ofdm
