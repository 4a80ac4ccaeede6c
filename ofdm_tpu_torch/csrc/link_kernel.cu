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
// tile also runs the IDFT+CP product for the PAPR max/sum.
//
// The bracketed _Spec stages (pallas_link.py:1437-1443, 1826-1862) exist
// only in the build with -DOFDM_STAGED=1, whose main kernel is diag_staged;
// the plain build's diag_main is the unstaged chain over an IR with unit
// energy (its channel rows are the equalizer's h rows).  A link over an IR
// without unit energy runs diag_staged with no stage bits.
//
// Bound on an H100: issue rate, not memory.  The kernel reads only the
// constant rows (a few KB, L1/L2 resident) and writes 3 counters, so the
// bytes bound is ~0.  Each bin costs ~300 integer and fp32 instructions
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
//  * normalize needs the mean |e|^2 over every point of a tile before any
//    of its decisions, after noise, equalizer and the post-EQ stages.
//    diag_staged runs twice: phase 0 recomputes the chain to e and writes
//    one partial a warp (each warp walks `run` consecutive symbols, a
//    fixed layout: per-symbol warp sum, then the run in order), the shared
//    norm_factors kernel reduces a tile's partials in a fixed tree, and
//    phase 1 recomputes e, scales it by its tile's factor and counts.  The
//    pass costs about one more main pass; the plain version
//    (link_kernel.tile_norm) repeats every sum bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

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
  const float* fr;  // (n, T) IDFT + CP, row-major
  const float* fi;
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

template <int J, int kMode>
__global__ void __launch_bounds__(kThreads)
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
          s_sr[warp][k] = sr;
          s_si[warp][k] = si;
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

    if (sampled) {
      // PAPR: x = s @ F_tx over this symbol's n bins, T time samples.
      __syncwarp();
      for (int t = lane; t < L.T; t += 32) {
        float xr = 0.0f, xi = 0.0f;
        for (int k = 0; k < L.n; ++k) {
          const float a = s_sr[warp][k];
          const float c = s_si[warp][k];
          const float f_r = __ldg(L.fr + k * L.T + t);
          const float f_i = __ldg(L.fi + k * L.T + t);
          xr = xr + (a * f_r - c * f_i);
          xi = xi + (a * f_i + c * f_r);
        }
        const float pw = xr * xr + xi * xi;
        pk = fmaxf(pk, pw);
        ps += static_cast<double>(pw);
        if (b == L.carry_sym) {
          carry_r[t] = xr;
          carry_i[t] = xi;
        }
      }
      __syncwarp();
    }
  }

  ofdm::flush_counters<kWarps>(be, se, pk, ps, acc, psum);
}

#if OFDM_STAGED
// The chain with the _Spec stages, one warp per symbol walking `run`
// consecutive symbols (a fixed layout, so the normalization partials sum
// in a fixed order).  Phase 0 (normalize only) writes each warp's sum of
// |e|^2 over its run; phase 1 scales e by its tile's factor, counts, and
// takes the PAPR statistic and the carry row (and with kDump, the dump).
template <int J, int kMode, bool kDump>
__global__ void __launch_bounds__(kThreads)
    diag_staged(Link L, const float* partials, unsigned long long* acc, double* psum,
                float* carry_r, float* carry_i) {
  __shared__ float s_sr[kWarps][kMaxN];
  __shared__ float s_si[kWarps][kMaxN];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool counting = L.st.phase == 1;
  const bool normalize = (L.st.bits & ofdm::kStageNormalize) != 0;
  const float* comp = L.st.rows + L.n;
  const float* nstd = L.st.rows + 2 * L.n;

  uint32_t be = 0, se = 0;
  float pk = 0.0f;
  double ps = 0.0;
  const long long first = (static_cast<long long>(blockIdx.x) * kWarps + warp) * L.run;
  if (first < L.chunk) {
    const int b0 = static_cast<int>(first);
    const int b1 = min(b0 + L.run, L.chunk);
    int cached_tile = -1;
    float sigma = 0.0f, fn = 1.0f, energy = 0.0f;
    for (int b = b0; b < b1; ++b) {
      const int tile_id = b / L.tile;
      if (tile_id != cached_tile) {
        const int tlen = min(L.tile, L.chunk - tile_id * L.tile);
        if (L.add_noise) {
          sigma = ofdm::tile_sigma(partials + tile_id * L.groups, L.groups, min(L.slice, tlen) * L.n,
                                   L.snr_lin);
        }
        if (normalize && counting) fn = L.st.norm_f[tile_id];
        cached_tile = tile_id;
      }
      const bool sampled = counting && (tile_id % L.pstride) == 0;
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
            s_sr[warp][k] = sr;
            s_si[warp][k] = si;
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
      if (normalize && !counting) {
        energy = energy + ofdm::warp_energy<J>(er, ei, lane, L.n);
        continue;
      }
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int k = lane + 32 * j;
        if (k < L.n) {
          if (normalize) {
            const float m = ofdm::norm_gain<kMode>(L, k, fn);
            er[j] = er[j] * m;
            ei[j] = ei[j] * m;
          }
          ofdm::dump_bin<kMode, kDump>(L, b, k, er[j], ei[j]);
          ofdm::count_bin<kMode>(tx[j], er[j], ei[j], L.q, L.lanes, k, be, se);
        }
      }

      if (sampled) {
        // PAPR: x = s @ F_tx over this symbol's n (scaled) bins, T time samples.
        __syncwarp();
        for (int t = lane; t < L.T; t += 32) {
          float xr, xi;
          ofdm::cdot(s_sr[warp], s_si[warp], L.fr, L.fi, L.n, L.T, t, xr, xi);
          const float pw = xr * xr + xi * xi;
          pk = fmaxf(pk, pw);
          ps += static_cast<double>(pw);
          if (b == L.carry_sym) {
            carry_r[t] = xr;
            carry_i[t] = xi;
          }
        }
        __syncwarp();
      }
    }
    if (normalize && !counting && lane == 0) L.st.norm_part[b0 / L.run] = energy;
  }

  ofdm::flush_counters<kWarps>(be, se, pk, ps, acc, psum);
}

// One pass of diag_staged at width J, with the dump stage when its bit is set.
template <int J, int kMode>
cudaError_t staged_pass(const Link& P, int sgrid, const float* partials, unsigned long long* acc,
                        double* psum, float* cr, float* ci, cudaStream_t stream) {
  auto* kernel = (P.st.bits & ofdm::kStageDump) ? &diag_staged<J, kMode, true> : &diag_staged<J, kMode, false>;
  kernel<<<sgrid, kThreads, 0, stream>>>(P, partials, acc, psum, cr, ci);
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

// power_partials (when noise is on) then diag_main, in mode kMode; in the
// OFDM_STAGED build diag_staged instead of diag_main, under normalize twice
// around norm_factors.
template <int kMode>
cudaError_t launch(const Link& L, float* partials, unsigned long long* acc, double* psum, float* cr,
                   float* ci, cudaStream_t stream) {
  const int tiles = (L.chunk + L.tile - 1) / L.tile;
  if (L.add_noise) {
    power_partials<kMode, ofdm::kStagedBuild><<<dim3(tiles, L.groups), kPowerThreads, 0, stream>>>(L, partials);
  }
#if OFDM_STAGED
  const int warps = (L.chunk + L.run - 1) / L.run;
  const int sgrid = (warps + kWarps - 1) / kWarps;
  return ofdm::staged_passes(L.st.bits, L.st.norm_part, L.st.norm_f, L.chunk, L.tile, L.run, L.n, stream,
                             [&](int phase) {
    Link P = L;
    P.st.phase = phase;
    switch ((L.n + 31) / 32) {
      case 1: return staged_pass<1, kMode>(P, sgrid, partials, acc, psum, cr, ci, stream);
      case 2: return staged_pass<2, kMode>(P, sgrid, partials, acc, psum, cr, ci, stream);
      case 3: return staged_pass<3, kMode>(P, sgrid, partials, acc, psum, cr, ci, stream);
      case 4: return staged_pass<4, kMode>(P, sgrid, partials, acc, psum, cr, ci, stream);
      case 5: return staged_pass<5, kMode>(P, sgrid, partials, acc, psum, cr, ci, stream);
      case 6: return staged_pass<6, kMode>(P, sgrid, partials, acc, psum, cr, ci, stream);
      case 7: return staged_pass<7, kMode>(P, sgrid, partials, acc, psum, cr, ci, stream);
      default: return staged_pass<8, kMode>(P, sgrid, partials, acc, psum, cr, ci, stream);
    }
  });
#else
  const int want = (L.chunk + kWarps - 1) / kWarps;
  const int grid = want < sm_count() * 8 ? want : sm_count() * 8;
  switch ((L.n + 31) / 32) {
    case 1: diag_main<1, kMode><<<grid, kThreads, 0, stream>>>(L, partials, acc, psum, cr, ci); break;
    case 2: diag_main<2, kMode><<<grid, kThreads, 0, stream>>>(L, partials, acc, psum, cr, ci); break;
    case 3: diag_main<3, kMode><<<grid, kThreads, 0, stream>>>(L, partials, acc, psum, cr, ci); break;
    case 4: diag_main<4, kMode><<<grid, kThreads, 0, stream>>>(L, partials, acc, psum, cr, ci); break;
    case 5: diag_main<5, kMode><<<grid, kThreads, 0, stream>>>(L, partials, acc, psum, cr, ci); break;
    case 6: diag_main<6, kMode><<<grid, kThreads, 0, stream>>>(L, partials, acc, psum, cr, ci); break;
    case 7: diag_main<7, kMode><<<grid, kThreads, 0, stream>>>(L, partials, acc, psum, cr, ci); break;
    default: diag_main<8, kMode><<<grid, kThreads, 0, stream>>>(L, partials, acc, psum, cr, ci); break;
  }
  return cudaGetLastError();
#endif
}

}  // namespace ofdm_link

using namespace ofdm_link;

extern "C" {

// One chunk: power_partials (when noise is on) then diag_main (diag_staged
// in the OFDM_STAGED build), all on `stream`, in constellation mode `mode`
// (link_common.cuh::Mode; lane_i / lane_f the adaptive modes' lane rows).
// acc = [bit errors, symbol errors, PAPR peak f32 bits] (int64,
// accumulated), psum = PAPR power sum (float64, accumulated).  rows /
// stages / norm_part / norm_f: the _Spec stages (link_common.cuh::Stages;
// stages must be 0 in the plain build, and chr / chi, the channel rows,
// the equalizer's h rows).  Returns the first CUDA error of the launches, 0
// if none.
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
                    float* dump_r, float* dump_i, int dump_rows, void* stream_ptr) {
  if (n < 1 || n > kMaxN || chunk < 1 || tile < 1 || pstride < 1 || run < 1 || tile % run != 0 ||
      (ofdm::adaptive(mode) && (lane_i == nullptr || lane_f == nullptr)) ||
      !ofdm::stage_args_ok(rows, stages, norm_part, norm_f, dump_r, dump_i, dump_rows, true) ||
      (!ofdm::kStagedBuild && (chr != hr || chi != hi))) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Link L;
  L.eq = ofdm::Equalizer{hr, hi, habs2, gr, gi, slicer, cg, method};
  L.fr = fr;
  L.fi = fi;
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
    return launch<decltype(md)::value>(L, partials, a, psum, carry_r, carry_i, stream);
  }));
}

const char* ofdm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
