// Fused diag-mode chunk of the OFDM link: one Monte-Carlo chunk from random
// words to error counters, with nothing but the counters, the PAPR
// statistic and one carry row written to device memory.
//
// Replaces: ofdm_tpu/ops/pallas_link.py::_fn_for_spec -> kernel, in its
// conv="diag" form (cyclic prefix covering the channel order, so TX ->
// channel -> RX is diagonal), in each constellation mode: qam, psk, aqam and
// apsk (a template parameter, link_common.cuh's codec).  Per bin: Philox
// words -> encode -> [x sqrt(P)] -> y = s*d (d the diagonal of the
// unit-energy taps' response: the raw h_freq where the IR has unit energy)
// -> measured-power AWGN (Box-Muller, quarter-range polynomial phase) -> ZF
// / MMSE / no equalizer against the raw h_freq with the slicer gain folded
// in -> [post-EQ noise] -> [x 1/sqrt(P)] -> [x the tile's unit-power
// factor] -> slicer or PSK sector -> popcount(tx ^ rx).  Every pstride-th
// tile also takes the IDFT+CP time block for the PAPR max/sum: an in-warp
// radix-2 IDFT where n is a power of two, else the product with F_tx over
// its n distinct columns (the cyclic prefix's columns repeat the last ones).
//
// The bracketed _Spec stages (pallas_link.py:1437-1443, 1826-1862) exist
// only in the build with -DOFDM_STAGED=1, whose main kernel is diag_staged;
// the plain build's diag_main is the unstaged chain over an IR with unit
// energy (its channel rows are the equalizer's h rows).  A link over an IR
// without unit energy runs diag_staged with no stage bits.
//
// Bound on an H100: issue rate, not memory.  The kernel reads only the
// constant rows (a few KB, L1/L2 resident) and writes 3 counters, so the
// bytes bound is ~0 (a normalized chunk adds its scratch plane, 10 bytes a
// bin written and read once).  Each bin costs ~300 integer and fp32 instructions
// (Philox's 10 rounds alone are ~70; log, sqrt, two Horner chains, the MMSE
// divide and the slicer make up the rest), so the bound is
// instructions x bins / the card's fp32+int32 issue rate.
//
// Design for that bound:
//  * No random numbers are stored: one Philox4x32-10 call per bin gives the
//    TX word, u1 and u2.  The counter is (run symbol index lo, hi,
//    subcarrier, 0) under the run's two seed words, so the draw does not
//    depend on block shape, tile or chunking and the plain version
//    reproduces it bit for bit.
//  * Measured power is per tile over the tile's first `slice` symbols
//    (the reference's estimator contract).  Blocks carry nothing between
//    them, so a first kernel (power_partials) recomputes s*h for the slice
//    from Philox and writes fixed-order partial sums; the main kernel sums
//    a tile's partials in order when it reaches that tile.  The slice is
//    1/8 of a headline tile, so the first pass costs about that share.
//  * One warp per OFDM symbol (bins k = lane + 32 j, j < J = ceil(n/32),
//    n <= 256): the MMSE per-symbol mean is a per-lane sum plus an xor
//    butterfly, which leaves every lane with the same bits.
//  * Counters: per-thread 32-bit, warp shuffle and block sums, one 64-bit
//    atomicAdd per block.  The PAPR peak is an atomicMax on the f32 bit
//    pattern (non-negative floats order like their bits); the PAPR sum is
//    a double atomicAdd, so its last digits depend on block order.
//  * The PAPR statistic of a sampled symbol.  Where n is a power of two the
//    warp runs block_dft.cuh's radix-2 inverse transform on the symbol's s
//    (stored at its dft_slot in shared memory, __syncwarp between stages;
//    n/2 log2 n butterflies where the dense product took 8 n T operations)
//    and x = scale * the result, as the plain version's dft.block_dft.  At
//    any other n it multiplies by F_tx, whose column t < L (the cyclic
//    prefix, L = T - n) is bitwise its column t + n: it computes the n
//    columns [L, T) only, each a k-ascending sum of rounded terms (the
//    plain version's cmatmul).  Either way the prefix repeats the last L
//    samples, so their power enters the sum twice and the carry symbol's x
//    goes to both places of the carry row: the peak and the carry row are
//    those of the whole time block.
//  * normalize needs the mean |e|^2 over every point of a tile before any
//    of its decisions, after noise, equalizer and the post-EQ stages
//    (diag_common.cuh).  diag_staged's front variant runs the chain once,
//    writes e and the TX index to a scratch plane and one |e|^2 partial a
//    warp (each warp walks `run` consecutive symbols, a fixed layout:
//    per-symbol warp sum, then the run in order), and takes the PAPR
//    statistic; the shared norm_factors kernel reduces a tile's partials in
//    a fixed tree; diag_demap scales the scratch by its tile's factor and
//    counts.  The plain version (link_kernel.tile_norm) repeats every sum
//    bit for bit.  Without normalize the staged chunk is one kernel.

#include <cstdint>
#include <cuda_runtime.h>

#include "block_dft.cuh"
#include "diag_common.cuh"
#include "link_common.cuh"

// A named namespace, so profilers show the kernels' names.
namespace ofdm_link {

constexpr int kWarps = 8;          // warps per block of the main kernel
constexpr int kThreads = 32 * kWarps;
constexpr int kPowerThreads = 256;  // threads per block of power_partials
constexpr int kPowerSteps = 16;     // elements per thread of power_partials
constexpr int kMaxN = 256;

struct Link {
  ofdm::Equalizer eq;
  const float* fr;  // (n, T) IDFT + CP, row-major (n not a power of two)
  const float* fi;
  ofdm::DftPlan plan;  // the n-point IDFT where n is a power of two (log2n >= 0), else log2n = -1
  int n;
  int T;
  ofdm::Qam q;
  float snr_lin;
  int add_noise;
  unsigned long long sym0;  // run index of the chunk's first symbol
  int chunk;
  int tile;
  int slice;
  int groups;
  int pstride;
  int carry_sym;  // last symbol of the chunk's last sampled tile
  uint2 key;
  ofdm::Lanes lanes;  // the adaptive modes' lane rows
  const float* chr;   // (n,) the channel multiply's rows (diag_response)
  const float* chi;
  int run;            // consecutive symbols a warp of diag_staged walks
  ofdm::Stages st;    // the _Spec stages (OFDM_STAGED builds)
};

__device__ __forceinline__ uint4 words_for(const Link& L, int b, int k) {
  return ofdm::symbol_words(L.sym0 + static_cast<unsigned long long>(b), k, L.key);
}

// The PAPR statistic of a sampled symbol (the warp's s in shared memory):
// x = s @ F_tx over the n distinct columns [T - n, T), k ascending (the
// prefix column t - n is bitwise column t: papr_sample).
__device__ __forceinline__ void papr_columns(const Link& L, const float* sr, const float* si, int lane,
                                             bool carry, float& pk, double& ps, float* carry_r,
                                             float* carry_i) {
  for (int t = L.T - L.n + lane; t < L.T; t += 32) {
    float xr, xi;
    ofdm::cdot(sr, si, L.fr, L.fi, L.n, L.T, t, xr, xi);
    ofdm::papr_sample(L.n, t, xr, xi, carry, pk, ps, carry_r, carry_i);
  }
}

// The PAPR statistic of a sampled symbol where n is a power of two: the
// warp's radix-2 inverse transform of s, stored at its dft_slot in (ar, ai)
// (block_dft.cuh's butterflies in its order, a lane taking butterflies
// lane, lane + 32, ...), then x = scale * the result, IDFT sample m the
// block's time sample T - n + m (papr_sample).  Leaves (ar, ai)
// transformed.
__device__ __forceinline__ void papr_idft(const Link& L, float* ar, float* ai, int lane, bool carry, float& pk,
                                          double& ps, float* carry_r, float* carry_i) {
  const int n = L.n;
  for (int h = 1; h < n; h <<= 1) {
    const int stride = n / (2 * h);
    for (int q = lane; q < n / 2; q += 32) {
      const int pos = q & (h - 1);
      const int i0 = ((q - pos) << 1) + pos;
      const int i1 = i0 + h;
      float wr, wi;
      ofdm::dft_twiddle(L.plan, pos * stride, true, wr, wi);
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
    __syncwarp();
  }
  for (int m = lane; m < n; m += 32) {
    ofdm::papr_sample(n, L.T - n + m, ar[m] * L.plan.scale, ai[m] * L.plan.scale, carry, pk, ps, carry_r, carry_i);
  }
}

// A sampled symbol's PAPR statistic (papr_idft or papr_columns), between
// two __syncwarp: the warp's s is in (sr, si), each bin at its dft_slot.
__device__ __forceinline__ void papr_symbol(const Link& L, float* sr, float* si, int lane, bool carry, float& pk,
                                            double& ps, float* carry_r, float* carry_i) {
  __syncwarp();
  if (L.plan.log2n >= 0) {
    papr_idft(L, sr, si, lane, carry, pk, ps, carry_r, carry_i);
  } else {
    papr_columns(L, sr, si, lane, carry, pk, ps, carry_r, carry_i);
  }
  __syncwarp();
}

// Partial sums of |s*d|^2 over each tile's measured-power slice (s scaled
// under apply_power).  grid (tiles, groups); element e = g*4096 + j*256 + t
// of the tile's slice.
template <int kMode, bool kStaged>
__global__ void __launch_bounds__(kPowerThreads) power_partials(Link L, float* partials) {
  __shared__ float red[kPowerThreads];
  const int tile_id = blockIdx.x;
  const int g = blockIdx.y;
  const int t = threadIdx.x;
  const int b0 = tile_id * L.tile;
  const int tlen = min(L.tile, L.chunk - b0);
  const int count = min(L.slice, tlen) * L.n;
  float acc = 0.0f;
  for (int j = 0; j < kPowerSteps; ++j) {
    const int e = g * (kPowerSteps * kPowerThreads) + j * kPowerThreads + t;
    float p = 0.0f;
    if (e < count) {
      const int b = e / L.n;
      const int k = e - b * L.n;
      const uint4 w = words_for(L, b0 + b, k);
      float sr, si;
      ofdm::encode<kMode>(w.x, L.q, L.lanes, k, sr, si);
      ofdm::scale_tx<kStaged>(L, k, sr, si);
      const float* chr = kStaged ? L.chr : L.eq.hr;
      const float* chi = kStaged ? L.chi : L.eq.hi;
      const float hr = __ldg(chr + k);
      const float hi = __ldg(chi + k);
      const float yr = sr * hr - si * hi;
      const float yi = sr * hi + si * hr;
      p = yr * yr + yi * yi;
    }
    acc = acc + p;
  }
  ofdm::store_block_sum<kPowerThreads>(acc, red, t, partials + tile_id * L.groups + g);
}

// At most 64 registers (four blocks an SM): without the bound the in-run
// transform's code takes the instantiations past 128 subcarriers to 128
// (port_ab.py's severe_160sc cell against the parent commit).
template <int J, int kMode>
__global__ void __launch_bounds__(kThreads, 4)
    diag_main(Link L, const float* partials, unsigned long long* acc, double* psum,
              float* carry_r, float* carry_i) {
  __shared__ float s_sr[kWarps][kMaxN];
  __shared__ float s_si[kWarps][kMaxN];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = gridDim.x * kWarps;

  uint32_t be = 0, se = 0;
  float pk = 0.0f;
  double ps = 0.0;
  int cached_tile = -1;
  float sigma = 0.0f;

  for (int b = blockIdx.x * kWarps + warp; b < L.chunk; b += nw) {
    const int tile_id = b / L.tile;
    const bool sampled = (tile_id % L.pstride) == 0;
    if (L.add_noise && tile_id != cached_tile) {
      const int tlen = min(L.tile, L.chunk - tile_id * L.tile);
      sigma = ofdm::tile_sigma(partials + tile_id * L.groups, L.groups, min(L.slice, tlen) * L.n,
                               L.snr_lin);
      cached_tile = tile_id;
    }

    float yr[J], yi[J];
    int tx[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int k = lane + 32 * j;
      yr[j] = 0.0f;
      yi[j] = 0.0f;
      tx[j] = 0;
      if (k < L.n) {
        const uint4 w = words_for(L, b, k);
        float sr, si;
        tx[j] = ofdm::encode<kMode>(w.x, L.q, L.lanes, k, sr, si);
        if (sampled) {
          s_sr[warp][ofdm::dft_slot(L.plan, k)] = sr;
          s_si[warp][ofdm::dft_slot(L.plan, k)] = si;
        }
        const float hr = __ldg(L.eq.hr + k);
        const float hi = __ldg(L.eq.hi + k);
        yr[j] = sr * hr - si * hi;
        yi[j] = sr * hi + si * hr;
        if (L.add_noise) ofdm::add_noise(w.y, w.z, sigma, yr[j], yi[j]);
      }
    }

    const float nv = ofdm::mmse_nv<J>(L.eq, yr, yi, lane, L.n, L.snr_lin);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int k = lane + 32 * j;
      if (k < L.n) {
        float er, ei;
        ofdm::equalize_bin<kMode>(L.eq, L.lanes, k, yr[j], yi[j], nv, er, ei);
        ofdm::count_bin<kMode>(tx[j], er, ei, L.q, L.lanes, k, be, se);
      }
    }

    if (sampled) papr_symbol(L, s_sr[warp], s_si[warp], lane, b == L.carry_sym, pk, ps, carry_r, carry_i);
  }

  ofdm::flush_counters<kWarps>(be, se, pk, ps, acc, psum);
}

#if OFDM_STAGED
// The chain with the _Spec stages over chunk symbols [b_lo, b_hi), one warp
// per symbol walking `run` consecutive symbols (a fixed layout, so the
// normalization partials sum in a fixed order), with the PAPR statistic and
// the carry row of the sampled tiles.  The counting variant (kFront false;
// no normalize) dumps (kDump) and counts; the front variant of a normalized
// chunk writes e and the TX index of each bin to the slab's scratch and
// each warp's sum of |e|^2 over its run to norm_part.  At most 64 registers
// (four blocks an SM), as diag_main.
template <int J, int kMode, bool kDump, bool kFront>
__global__ void __launch_bounds__(kThreads, 4)
    diag_staged(Link L, int b_lo, int b_hi, const float* partials, unsigned long long* acc, double* psum,
                float* carry_r, float* carry_i, ofdm::Scratch scr) {
  __shared__ float s_sr[kWarps][kMaxN];
  __shared__ float s_si[kWarps][kMaxN];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* comp = L.st.rows + L.n;
  const float* nstd = L.st.rows + 2 * L.n;

  uint32_t be = 0, se = 0;
  float pk = 0.0f;
  double ps = 0.0;
  const long long first = b_lo + (static_cast<long long>(blockIdx.x) * kWarps + warp) * L.run;
  if (first < b_hi) {
    const int b0 = static_cast<int>(first);
    const int b1 = min(b0 + L.run, b_hi);
    int cached_tile = -1;
    float sigma = 0.0f, energy = 0.0f;
    for (int b = b0; b < b1; ++b) {
      const int tile_id = b / L.tile;
      if (L.add_noise && tile_id != cached_tile) {
        const int tlen = min(L.tile, L.chunk - tile_id * L.tile);
        sigma = ofdm::tile_sigma(partials + tile_id * L.groups, L.groups, min(L.slice, tlen) * L.n,
                                 L.snr_lin);
        cached_tile = tile_id;
      }
      const bool sampled = (tile_id % L.pstride) == 0;
      const unsigned long long sym = L.sym0 + static_cast<unsigned long long>(b);

      float yr[J], yi[J];
      int tx[J];
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int k = lane + 32 * j;
        yr[j] = 0.0f;
        yi[j] = 0.0f;
        tx[j] = 0;
        if (k < L.n) {
          const uint4 w = words_for(L, b, k);
          float sr, si;
          tx[j] = ofdm::encode<kMode>(w.x, L.q, L.lanes, k, sr, si);
          ofdm::scale_tx<true>(L, k, sr, si);
          if (sampled) {
            s_sr[warp][ofdm::dft_slot(L.plan, k)] = sr;
            s_si[warp][ofdm::dft_slot(L.plan, k)] = si;
          }
          const float hr = __ldg(L.chr + k);
          const float hi = __ldg(L.chi + k);
          yr[j] = sr * hr - si * hi;
          yi[j] = sr * hi + si * hr;
          if (L.add_noise) ofdm::add_noise(w.y, w.z, sigma, yr[j], yi[j]);
        }
      }

      const float nv = ofdm::mmse_nv<J>(L.eq, yr, yi, lane, L.n, L.snr_lin);
      float er[J], ei[J];
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int k = lane + 32 * j;
        er[j] = 0.0f;
        ei[j] = 0.0f;
        if (k < L.n) {
          ofdm::equalize_stage<kMode, true>(L, k, yr[j], yi[j], nv, er[j], ei[j]);
          if (L.st.bits & ofdm::kStagePostNoise) {
            const uint4 w = ofdm::philox4x32_10(
                make_uint4(static_cast<uint32_t>(sym), static_cast<uint32_t>(sym >> 32),
                           static_cast<uint32_t>(k), 3u),
                L.key);
            ofdm::post_noise(w.y, w.z, __ldg(nstd + k), er[j], ei[j]);
          }
          if (L.st.bits & ofdm::kStageCompensate) {
            const float c = __ldg(comp + k);
            er[j] = er[j] * c;
            ei[j] = ei[j] * c;
          }
        }
      }
      if constexpr (kFront) {
        energy = energy + ofdm::warp_energy<J>(er, ei, lane, L.n);
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int k = lane + 32 * j;
          if (k < L.n) ofdm::scratch_store(scr, b_lo, L.n, b, k, tx[j], er[j], ei[j]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int k = lane + 32 * j;
          if (k < L.n) {
            ofdm::dump_bin<kMode, kDump>(L, b, k, er[j], ei[j]);
            ofdm::count_bin<kMode>(tx[j], er[j], ei[j], L.q, L.lanes, k, be, se);
          }
        }
      }

      if (sampled) papr_symbol(L, s_sr[warp], s_si[warp], lane, b == L.carry_sym, pk, ps, carry_r, carry_i);
    }
    if (kFront && lane == 0) L.st.norm_part[b0 / L.run] = energy;
  }

  ofdm::flush_counters<kWarps>(be, se, pk, ps, acc, psum);
}

// The staged chunk at width J: under normalize in slabs of `slab` symbols
// (the front variant, norm_factors, diag_demap: diag_common.cuh), else
// diag_staged's counting variant once over the chunk (with the dump stage
// when its bit is set).
template <int J, int kMode>
cudaError_t staged_chunk(const Link& L, int slab, const ofdm::Scratch& scr, int demap_grid,
                         const float* partials, unsigned long long* acc, double* psum, float* cr, float* ci,
                         cudaStream_t stream) {
  const auto grid_of = [&](int syms) { return ((syms + L.run - 1) / L.run + kWarps - 1) / kWarps; };
  if (L.st.bits & ofdm::kStageNormalize) {
    return ofdm::onepass_slabs<kMode>(L, slab, scr, demap_grid, acc, psum, stream, [&](int b_lo, int b_hi) {
      diag_staged<J, kMode, false, true><<<grid_of(b_hi - b_lo), kThreads, 0, stream>>>(
          L, b_lo, b_hi, partials, acc, psum, cr, ci, scr);
      return cudaGetLastError();
    });
  }
  auto* kernel = (L.st.bits & ofdm::kStageDump) ? &diag_staged<J, kMode, true, false>
                                                : &diag_staged<J, kMode, false, false>;
  kernel<<<grid_of(L.chunk), kThreads, 0, stream>>>(L, 0, L.chunk, partials, acc, psum, cr, ci, scr);
  return cudaGetLastError();
}
#endif

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (count <= 0) count = 132;
  }
  return count;
}

// Calls f(std::integral_constant<int, J>()) for the bins a lane of width n.
template <class F>
cudaError_t with_width(int n, F&& f) {
  switch ((n + 31) / 32) {
    case 1: return f(std::integral_constant<int, 1>());
    case 2: return f(std::integral_constant<int, 2>());
    case 3: return f(std::integral_constant<int, 3>());
    case 4: return f(std::integral_constant<int, 4>());
    case 5: return f(std::integral_constant<int, 5>());
    case 6: return f(std::integral_constant<int, 6>());
    case 7: return f(std::integral_constant<int, 7>());
    default: return f(std::integral_constant<int, 8>());
  }
}

// power_partials (when noise is on) then diag_main, in mode kMode; in the
// OFDM_STAGED build the staged chunk (staged_chunk) instead of diag_main.
template <int kMode>
cudaError_t launch(const Link& L, int slab, float* scr_r, float* scr_i, unsigned short* scr_tx, float* partials,
                   unsigned long long* acc, double* psum, float* cr, float* ci, cudaStream_t stream) {
  const int tiles = (L.chunk + L.tile - 1) / L.tile;
  if (L.add_noise) {
    power_partials<kMode, ofdm::kStagedBuild><<<dim3(tiles, L.groups), kPowerThreads, 0, stream>>>(L, partials);
  }
#if OFDM_STAGED
  const ofdm::Scratch scr{scr_r, scr_i, scr_tx};
  return with_width(L.n, [&](auto j) {
    return staged_chunk<decltype(j)::value, kMode>(L, slab, scr, sm_count() * 8, partials, acc, psum, cr, ci,
                                                   stream);
  });
#else
  (void)slab;
  (void)scr_r;
  (void)scr_i;
  (void)scr_tx;
  const int want = (L.chunk + kWarps - 1) / kWarps;
  const int grid = want < sm_count() * 8 ? want : sm_count() * 8;
  return with_width(L.n, [&](auto j) {
    diag_main<decltype(j)::value, kMode><<<grid, kThreads, 0, stream>>>(L, partials, acc, psum, cr, ci);
    return cudaGetLastError();
  });
#endif
}

}  // namespace ofdm_link

using namespace ofdm_link;

extern "C" {

// One chunk: power_partials (when noise is on) then diag_main (the staged
// chunk in the OFDM_STAGED build), all on `stream`, in constellation mode
// `mode` (link_common.cuh::Mode; lane_i / lane_f the adaptive modes' lane
// rows).  acc = [bit errors, symbol errors, PAPR peak f32 bits] (int64,
// accumulated), psum = PAPR power sum (float64, accumulated).  rows /
// stages / norm_part / norm_f: the _Spec stages (link_common.cuh::Stages;
// stages must be 0 in the plain build, and chr / chi, the channel rows,
// the equalizer's h rows).  scr_r / scr_i / scr_tx / slab: a normalized
// chunk's scratch (diag_common.cuh; slab symbols a pass, whole tiles,
// slab * n bins each plane).  twr / twi / n1 / n2 / log2n / dft_scale: the
// IDFT plan (ops/dft.py::DftPlan) where n is a power of two, the in-run
// PAPR's transform (fr / fi may then be null); log2n = -1 elsewhere, where
// fr / fi hold F_tx.  txext must be 0 (diag_main takes its PAPR statistic
// in the run).  The arguments are ofdm_diag_wide_chunk's.  Returns the
// first CUDA error of the launches, 0 if none.
int ofdm_diag_chunk(const float* hr, const float* hi, const float* habs2, const float* gr,
                    const float* gi, const float* chr, const float* chi, const float* fr,
                    const float* fi, int n, int T, int mode,
                    int order, int m, int logm, int bits, int gray, float scale,
                    const int* lane_i, const float* lane_f, float slicer,
                    float snr_lin, float cg, int method, int add_noise,
                    unsigned long long sym0, int chunk, int tile, int slice, int groups,
                    int pstride, int carry_sym, int run, unsigned int key0, unsigned int key1,
                    float* partials, long long* acc, double* psum, float* carry_r,
                    float* carry_i, const float* rows, int stages, float* norm_part, float* norm_f,
                    float* dump_r, float* dump_i, int dump_rows, float* scr_r, float* scr_i,
                    unsigned short* scr_tx, int slab, const float* twr, const float* twi, int n1, int n2,
                    int log2n, float dft_scale, int txext, void* stream_ptr) {
  const bool papr_ok = log2n >= 0 ? (twr != nullptr && twi != nullptr && (1 << log2n) == n)
                                  : (fr != nullptr && fi != nullptr);
  if (n < 1 || n > kMaxN || T < n || T > 2 * n || chunk < 1 || tile < 1 || pstride < 1 || run < 1 || !papr_ok ||
      txext != 0 || tile % run != 0 || (ofdm::adaptive(mode) && (lane_i == nullptr || lane_f == nullptr)) ||
      !ofdm::stage_args_ok(rows, stages, norm_part, norm_f, dump_r, dump_i, dump_rows, true) ||
      (!ofdm::kStagedBuild && (chr != hr || chi != hi))) {
    return cudaErrorInvalidValue;
  }
#if OFDM_STAGED
  if (!ofdm::scratch_ok(stages, ofdm::Scratch{scr_r, scr_i, scr_tx}, slab, tile, chunk)) {
    return cudaErrorInvalidValue;
  }
#endif
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Link L;
  L.eq = ofdm::Equalizer{hr, hi, habs2, gr, gi, slicer, cg, method};
  L.fr = fr;
  L.fi = fi;
  L.plan = ofdm::DftPlan{twr, twi, n, n1, n2, log2n, dft_scale};
  L.n = n;
  L.T = T;
  L.q = ofdm::Qam{order, m, logm, bits, gray, scale};
  L.lanes = ofdm::Lanes{lane_i, lane_f, n};
  L.snr_lin = snr_lin;
  L.add_noise = add_noise;
  L.sym0 = sym0;
  L.chunk = chunk;
  L.tile = tile;
  L.slice = slice;
  L.groups = groups;
  L.pstride = pstride;
  L.carry_sym = carry_sym;
  L.key = make_uint2(key0, key1);
  L.chr = chr;
  L.chi = chi;
  L.run = run;
  L.st = ofdm::make_stages(rows, stages, norm_part, norm_f, dump_r, dump_i, dump_rows);

  unsigned long long* a = reinterpret_cast<unsigned long long*>(acc);
  return static_cast<int>(ofdm::with_mode(mode, [&](auto md) {
    return launch<decltype(md)::value>(L, slab, scr_r, scr_i, scr_tx, partials, a, psum, carry_r, carry_i,
                                       stream);
  }));
}

// The layout of this build's qam kernels at width n, as a chunk launches
// them: four ints (registers, local bytes a thread, static shared memory,
// resident blocks an SM) for each of power_partials, the main kernel
// (diag_main; diag_staged's counting variant in the staged build), the
// front variant and diag_demap (-1 where the build has none), into out[16].
int ofdm_diag_geometry(int n, int* out) {
  if (n < 1 || n > kMaxN) return cudaErrorInvalidValue;
  for (int i = 0; i < 16; ++i) out[i] = -1;
  return static_cast<int>(with_width(n, [&](auto j) {
    constexpr int J = decltype(j)::value;
    cudaError_t err = ofdm::kernel_layout(&power_partials<ofdm::kQam, ofdm::kStagedBuild>, kPowerThreads, 0, out);
#if OFDM_STAGED
    if (err == cudaSuccess) err = ofdm::kernel_layout(&diag_staged<J, ofdm::kQam, false, false>, kThreads, 0, out + 4);
    if (err == cudaSuccess) err = ofdm::kernel_layout(&diag_staged<J, ofdm::kQam, false, true>, kThreads, 0, out + 8);
    if (err == cudaSuccess) {
      err = ofdm::kernel_layout(&ofdm::diag_demap<ofdm::kQam, false, Link>, ofdm::kDemapThreads, 0, out + 12);
    }
#else
    if (err == cudaSuccess) err = ofdm::kernel_layout(&diag_main<J, ofdm::kQam>, kThreads, 0, out + 4);
#endif
    return err;
  }));
}

const char* ofdm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
