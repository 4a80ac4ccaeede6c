// Fused zero-prefix mm chunk past 256 subcarriers or 320 time samples: one
// Monte-Carlo chunk of a zero-prefix SC-FDE link (or a single-tap zero-prefix
// OFDM one, or one whose lr factorization fails) from random words to error
// counters, one block a symbol.
//
// Replaces: ofdm_tpu/ops/pallas_link.py::_fn_for_spec -> kernel (its
// pallas_call at :1986), in its conv="mm" / "mm4", fold=False form at the
// widths the warp-per-symbol mm kernels (mm_kernel.cu, n <= 256, T <= 320)
// do not hold: T <= 2048 wherever the reference's dense budget admits the
// link (link_kernel.mm_fits, pallas_link._plan :124-216), in each
// constellation mode (a template parameter, link_common.cuh's codec; on
// SC-FDE lane t's order demaps time sample t); and K3, its carry probe
// (:2218).  Per OFDM symbol b, the semantics of the TPU kernel's dense
// products, not their form (the mm chain's, mm_kernel.cu):
//   Philox words -> encode s_b [x sqrt(P)]
//   x_b  = TX block (SC-FDE: s_b; OFDM: block IDFT) with L = T - n zeros
//   PAPR max and sum over x_b[0:T), every symbol
//   y    = the K-tap stream convolution over [x_{b-1}[T-E:T) | x_b], all T
//          samples
//   AWGN per time sample, sigma = sqrt(mp / snr_lin / 2), mp the mean |y|^2
//   over all tile * T samples of b's tile, before noise; time sample t's
//   words from counter (b, t, 0)
//   r    = the overlap-add r[i] = y[i] + y[n + i] (i < L), y[i] beyond
//   Y    = block DFT of r (block_dft.cuh)
//   ZF / MMSE / none with the slicer gain folded in (aqam: the lane's row;
//   on SC-FDE deferred past the IDFT)
//   SC-FDE only: e = block IDFT of e
//   [post-EQ noise, x 1/sqrt(P): per time sample on SC-FDE]
//   [x the tile's unit-power factor, the slicer gain deferred to it]
//   aqam on SC-FDE without normalize: time sample t x lane t's slicer row
//   slicer or PSK sector -> popcount(tx ^ rx) into int64 counters.
// The bracketed _Spec stages exist only in the build with -DOFDM_STAGED=1
// (kStaged; link_common.cuh), the post-EQ noise and 1/sqrt(P) only in the
// one with -DOFDM_BUMP=1 as well (kBump).
//
// Bound on an H100: issue rate, not memory.  A symbol costs the per-sample
// Philox and Box-Muller chain on T samples, the encode and the per-bin
// equalizer, slicer and count on n bins, 8 T K operations of the
// convolution, the block transforms (10 (n / 2) log2 n each) and the PAPR;
// the measured power recomputes TX and the convolution of every symbol once
// more (mm_wide_front).
//
// Design:
//  * The measured power needs every sample of a tile before any of its
//    noise, so the chunk runs in two kernels; the second recomputes y
//    instead of reading it back (a 2^17-symbol chunk's y at T = 1031 would
//    be 1.1 GB).  mm_wide_front: one block per 4096 consecutive time samples
//    of a tile (e = s*T + t) computes the symbols that cover them (TX, the
//    convolution) and reduces |y|^2 in power_partials' fixed order (16
//    sequential steps a thread, a 256-way tree).  mm_wide_main: a block
//    walks `run` consecutive symbols through the whole chain; it sums its
//    tile's partials in order for sigma.
//  * One block of 256 threads a symbol: thread t holds time samples and bins
//    t + 256 j (j < J <= 8); the noisy y goes to shared memory for the
//    overlap-add; the MMSE mean and the normalization energy are block sums
//    in block_sum's fixed order (link_kernel.block_sum, 256 threads).
//  * The previous tail, the carry-in, normalize and the counters as in
//    fold_wide_kernel.cu.

#include <cstdint>
#include <cuda_runtime.h>

#include "wide_chain.cuh"

// A named namespace, so profilers show the kernels' names.
namespace ofdm_mm_wide {

using ofdm::kWideThreads;
using ofdm::kWideWarps;
using ofdm::WideBufs;
using ofdm::WideLink;

// One symbol up to y before noise: the TX block (tx, w1, w2 for the thread's
// time samples; the PAPR stats when `papr`; the carry row when carry_r is
// set), then the convolution at the thread's samples t = tid + 256 j < T.
// z's tail moves on for the next symbol once every thread has read z.
template <int J, int kMode, bool kStaged>
__device__ __forceinline__ void symbol_samples(const WideLink& L, const WideBufs& w, unsigned long long sym,
                                               int limit, bool papr, float& pk, double& ps, float* carry_r,
                                               float* carry_i, int (&tx)[J], uint32_t (&w1)[J], uint32_t (&w2)[J],
                                               float (&yr)[J], float (&yi)[J]) {
  ofdm::wide_tx<J, kMode, kStaged, true>(L, w, sym, limit, tx, w1, w2);
  if (papr) ofdm::wide_papr(L, w, pk, ps, carry_r, carry_i);
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int t = threadIdx.x + kWideThreads * j;
    yr[j] = 0.0f;
    yi[j] = 0.0f;
    if (t < L.T) ofdm::conv_at(L, w, t, yr[j], yi[j]);
  }
  __syncthreads();
  ofdm::wide_shift_tail(L, w);
}

// Partial sums of |y|^2 (before noise) over each tile's time samples, in
// power_partials' order.  grid (tiles, groups); block (tile, g) covers
// e = s*T + t in [g*4096, (g+1)*4096).
template <int J, int kMode, bool kStaged>
__global__ void __launch_bounds__(kWideThreads) mm_wide_front(WideLink L, float* partials) {
  extern __shared__ float smem[];
  float* red = smem;  // kWidePowerBlock floats, element order
  const WideBufs w = ofdm::wide_bufs(L.n, L.T, L.E, smem + ofdm::kWidePowerBlock);
  const int tile_id = blockIdx.x;
  const int g = blockIdx.y;
  const int t = threadIdx.x;
  const int b0 = tile_id * L.tile;
  const int tlen = min(L.tile, L.chunk - b0);
  const int count = min(L.slice, tlen) * L.T;
  const int e_lo = g * ofdm::kWidePowerBlock;
  const int e_hi = min(e_lo + ofdm::kWidePowerBlock, count);
  for (int i = t; i < ofdm::kWidePowerBlock; i += kWideThreads) red[i] = 0.0f;
  if (e_lo < e_hi) {
    const int s_lo = e_lo / L.T;
    const int s_hi = (e_hi - 1) / L.T + 1;
    ofdm::wide_prev<J, kMode, kStaged, true>(L, w, L.sym0 + static_cast<unsigned long long>(b0 + s_lo));
    float pk = 0.0f;
    double ps = 0.0;
    int tx[J];
    uint32_t w1[J], w2[J];
    float yr[J], yi[J];
    for (int s = s_lo; s < s_hi; ++s) {
      symbol_samples<J, kMode, kStaged>(L, w, L.sym0 + static_cast<unsigned long long>(b0 + s), L.n, false, pk,
                                        ps, nullptr, nullptr, tx, w1, w2, yr, yi);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int tt = t + kWideThreads * j;
        const int e = s * L.T + tt;
        if (tt < L.T && e >= e_lo && e < e_hi) red[e - e_lo] = yr[j] * yr[j] + yi[j] * yi[j];
      }
    }
  }
  ofdm::power_block_partial<kWideThreads, ofdm::kWidePowerSteps>(red, t, partials + tile_id * L.groups + g);
}

// The chain a symbol a block; with kStaged, the stages (phase 0 of a
// normalized link writes its run's |e|^2 partial instead of counting);
// kDump is the dump stage's launch-time variant, kBump the noise-bump
// stages (the OFDM_BUMP build).
template <int J, int kMode, bool kStaged, bool kDump = false, bool kBump = false>
__global__ void __launch_bounds__(kWideThreads, ofdm::kWideMinBlocks)
    mm_wide_main(WideLink L, const float* partials, unsigned long long* acc, double* psum, float* carry_r,
                 float* carry_i) {
  extern __shared__ float smem[];
  __shared__ float wsum[kWideWarps];
  const WideBufs w = ofdm::wide_bufs(L.n, L.T, L.E, smem);
  const int tid = threadIdx.x;

  uint32_t be = 0, se = 0;
  float pk = 0.0f;
  double ps = 0.0;

  const int b0 = static_cast<int>(static_cast<long long>(blockIdx.x) * L.run);
  const int b1 = min(b0 + L.run, L.chunk);
  const bool counting = !kStaged || L.st.phase == 1;
  const bool normalize = kStaged && (L.st.bits & ofdm::kStageNormalize) != 0;
  const bool sc = L.is_sc != 0;
  int cached_tile = -1;
  float sigma = 0.0f;
  int norm_tile = -1;
  float fn = 1.0f, energy = 0.0f;
  if (b0 < L.chunk) ofdm::wide_prev<J, kMode, kStaged, true>(L, w, L.sym0 + static_cast<unsigned long long>(b0));
  for (int b = b0; b < b1; ++b) {
    const int tile_id = b / L.tile;
    if (L.add_noise && tile_id != cached_tile) {
      const int tlen = min(L.tile, L.chunk - tile_id * L.tile);
      sigma = ofdm::tile_sigma(partials + tile_id * L.groups, L.groups, min(L.slice, tlen) * L.T, L.snr_lin);
      cached_tile = tile_id;
    }
    if constexpr (kStaged) {
      if (normalize && counting && tile_id != norm_tile) {
        fn = L.st.norm_f[tile_id];
        norm_tile = tile_id;
      }
    }
    const unsigned long long sym = L.sym0 + static_cast<unsigned long long>(b);
    const bool last = counting && b == L.chunk - 1;
    int tx[J];
    uint32_t w1[J], w2[J];
    float yr[J], yi[J];
    symbol_samples<J, kMode, kStaged>(L, w, sym, L.T, counting, pk, ps, last ? carry_r : nullptr,
                                      last ? carry_i : nullptr, tx, w1, w2, yr, yi);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int t = tid + kWideThreads * j;
      if (t < L.T) {
        if (L.add_noise) ofdm::add_noise(w1[j], w2[j], sigma, yr[j], yi[j]);
        w.yr[t] = yr[j];
        w.yi[t] = yi[j];
      }
    }
    __syncthreads();
    // The overlap-add of the zero-prefix tail onto the head (linops.rx_matrix).
    for (int i = tid; i < L.n; i += kWideThreads) {
      float rr = w.yr[i];
      float ri = w.yi[i];
      if (i < L.L) {
        rr = rr + w.yr[L.n + i];
        ri = ri + w.yi[L.n + i];
      }
      const int s = ofdm::dft_slot(L.dft, i);
      w.ar[s] = rr;
      w.ai[s] = ri;
    }
    ofdm::block_dft<kWideThreads>(L.dft, w.ar, w.ai, w.br, w.bi, false);
    float fr[J], fi[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int k = tid + kWideThreads * j;
      fr[j] = 0.0f;
      fi[j] = 0.0f;
      if (k < L.n) {
        fr[j] = w.ar[k] * L.dft.scale;
        fi[j] = w.ai[k] * L.dft.scale;
      }
    }
    const float nv = ofdm::mmse_nv_block<J, kWideWarps>(L.eq, fr, fi, L.n, L.snr_lin, wsum);
    float er[J], ei[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int k = tid + kWideThreads * j;
      er[j] = 0.0f;
      ei[j] = 0.0f;
      if (k < L.n) ofdm::equalize_stage<kMode, kStaged>(L, k, fr[j], fi[j], nv, er[j], ei[j], sc);
    }
    if (sc) {
      // SC-FDE: equalized bins -> time-domain symbols, the block IDFT.
      __syncthreads();  // every thread has read Y out of the DFT planes
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int k = tid + kWideThreads * j;
        if (k < L.n) {
          const int s = ofdm::dft_slot(L.dft, k);
          w.ar[s] = er[j];
          w.ai[s] = ei[j];
        }
      }
      ofdm::block_dft<kWideThreads>(L.dft, w.ar, w.ai, w.br, w.bi, true);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int k = tid + kWideThreads * j;
        if (k < L.n) {
          er[j] = w.ar[k] * L.dft.scale;
          ei[j] = w.ai[k] * L.dft.scale;
        }
      }
    }
    float p = 0.0f;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int k = tid + kWideThreads * j;
      if (k < L.n) {
        ofdm::bump_stages<kBump>(L, sym, k, er[j], ei[j]);
        if constexpr (kStaged) p = p + (er[j] * er[j] + ei[j] * ei[j]);
      }
    }
    if constexpr (kStaged) {
      if (normalize && !counting) {
        energy = energy + ofdm::block_sum<kWideWarps>(p, wsum);
        continue;
      }
    }
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int k = tid + kWideThreads * j;
      if (k < L.n) {
        if constexpr (kStaged) {
          if (normalize) {
            const float m = ofdm::norm_gain<kMode>(L, k, fn);
            er[j] = er[j] * m;
            ei[j] = ei[j] * m;
          }
        }
        ofdm::sc_slicer_bin<kMode, kStaged>(L, k, er[j], ei[j]);
        ofdm::dump_bin<kMode, kDump>(L, b, k, er[j], ei[j]);
        ofdm::count_bin<kMode>(tx[j], er[j], ei[j], L.q, L.lanes, k, be, se);
      }
    }
  }
  if constexpr (kStaged) {
    if (normalize && !counting && tid == 0 && b0 < L.chunk) L.st.norm_part[blockIdx.x] = energy;
  }
  ofdm::flush_counters<kWideWarps>(be, se, pk, ps, acc, psum);
}

template <class K>
cudaError_t allow_smem(K* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
}

// mm_wide_front (when noise is on) then mm_wide_main at J time samples a
// thread; in the OFDM_STAGED build mm_wide_main twice around norm_factors
// under normalize.
template <int J, int kMode>
cudaError_t launch(const WideLink& L, float* partials, unsigned long long* acc, double* psum, float* cr, float* ci,
                   cudaStream_t stream) {
  constexpr bool kS = ofdm::kStagedBuild;
  constexpr bool kB = ofdm::kBumpBuild;
  auto* main_kernel = &mm_wide_main<J, kMode, kS, false, kB>;
#if OFDM_STAGED
  if (L.st.bits & ofdm::kStageDump) main_kernel = &mm_wide_main<J, kMode, kS, true, kB>;
#endif
  const size_t main_bytes = sizeof(float) * ofdm::wide_floats(L.n, L.T, L.E, true);
  const size_t front_bytes = sizeof(float) * (ofdm::wide_floats(L.n, L.T, L.E, false) + ofdm::kWidePowerBlock);
  cudaError_t err = allow_smem(main_kernel, main_bytes);
  if (err != cudaSuccess) return err;
  if (L.add_noise) {
    err = allow_smem(&mm_wide_front<J, kMode, kS>, front_bytes);
    if (err != cudaSuccess) return err;
    const int tiles = (L.chunk + L.tile - 1) / L.tile;
    mm_wide_front<J, kMode, kS><<<dim3(tiles, L.groups), kWideThreads, front_bytes, stream>>>(L, partials);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int grid = (L.chunk + L.run - 1) / L.run;
#if OFDM_STAGED
  return ofdm::staged_passes(L.st.bits, L.st.norm_part, L.st.norm_f, L.chunk, L.tile, L.run, L.n, stream,
                             [&](int phase) {
    WideLink P = L;
    P.st.phase = phase;
    main_kernel<<<grid, kWideThreads, main_bytes, stream>>>(P, partials, acc, psum, cr, ci);
    return cudaGetLastError();
  });
#else
  main_kernel<<<grid, kWideThreads, main_bytes, stream>>>(L, partials, acc, psum, cr, ci);
  return cudaGetLastError();
#endif
}

template <int J, int kMode>
cudaError_t launch_probe(const WideLink& L, unsigned long long sym, float* cr, float* ci, float* tr, float* ti,
                         cudaStream_t stream) {
  auto* kernel = &ofdm::wide_probe<J, kMode, ofdm::kStagedBuild, true>;
  const size_t bytes = sizeof(float) * ofdm::wide_floats(L.n, L.T, L.E, false);
  const cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<1, kWideThreads, bytes, stream>>>(L, sym, cr, ci, tr, ti);
  return cudaGetLastError();
}

// Time samples a thread, rounded up to a compiled width: 2, 4 or 8.
template <int kMode>
cudaError_t launch_mode(const WideLink& L, float* partials, unsigned long long* acc, double* psum, float* cr,
                        float* ci, cudaStream_t stream) {
  const int slots = (L.T + kWideThreads - 1) / kWideThreads;
  if (slots <= 2) return launch<2, kMode>(L, partials, acc, psum, cr, ci, stream);
  if (slots <= 4) return launch<4, kMode>(L, partials, acc, psum, cr, ci, stream);
  return launch<8, kMode>(L, partials, acc, psum, cr, ci, stream);
}

template <int kMode>
cudaError_t probe_mode(const WideLink& L, unsigned long long sym, float* cr, float* ci, float* tr, float* ti,
                       cudaStream_t stream) {
  const int slots = (L.T + kWideThreads - 1) / kWideThreads;
  if (slots <= 2) return launch_probe<2, kMode>(L, sym, cr, ci, tr, ti, stream);
  if (slots <= 4) return launch_probe<4, kMode>(L, sym, cr, ci, tr, ti, stream);
  return launch_probe<8, kMode>(L, sym, cr, ci, tr, ti, stream);
}

}  // namespace ofdm_mm_wide

using namespace ofdm_mm_wide;

extern "C" {

// One chunk of a zero-prefix mm link at T <= 2048 (the wrapper sends n >
// 256 or T > 320): mm_wide_front (when noise is on) then mm_wide_main, all
// on `stream`; the arguments are ofdm_fold_wide_chunk's, with `slice` the
// tile (the measured power covers the whole tile) and `groups` its power
// blocks, ceil(tile * T / 4096).  Returns the first CUDA error of the
// launches, 0 if none.
int ofdm_mm_wide_chunk(const float* tpr, const float* tpi, const float* twr, const float* twi, const float* hr,
                       const float* hi, const float* habs2, const float* gr, const float* gi, int n, int T, int E,
                       int n1, int n2, int log2n, float dscale, int mode, int order, int m, int logm, int bits,
                       int gray, float scale, const int* lane_i, const float* lane_f, float slicer, float snr_lin,
                       float cg, int method, int add_noise, int is_sc, unsigned long long sym0, int chunk,
                       int tile, int slice, int groups, int run, unsigned int key0, unsigned int key1,
                       float* partials, long long* acc, double* psum, float* carry_r, float* carry_i,
                       const float* rows, int stages, float* norm_part, float* norm_f, float* dump_r,
                       float* dump_i, int dump_rows, const float* prev_r, const float* prev_i,
                       void* stream_ptr) {
  if (!ofdm::wide_shape_ok(n, T, E, n1, n2, log2n, twr, twi) || T > ofdm::kWideMaxN || tpr == nullptr ||
      tpi == nullptr || chunk < 1 || tile < 1 || slice != tile || groups < 1 || run < 1 || tile % run != 0 ||
      static_cast<long long>(groups) * ofdm::kWidePowerBlock < static_cast<long long>(tile) * T ||
      (prev_r == nullptr) != (prev_i == nullptr) ||
      (ofdm::adaptive(mode) && (lane_i == nullptr || lane_f == nullptr)) ||
      !ofdm::stage_args_ok(rows, stages, norm_part, norm_f, dump_r, dump_i, dump_rows, ofdm::kBumpBuild)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  WideLink L = ofdm::make_wide_link(tpr, tpi, twr, twi, ofdm::Equalizer{hr, hi, habs2, gr, gi, slicer, cg, method},
                                    n, T, E, n1, n2, log2n, dscale, ofdm::Qam{order, m, logm, bits, gray, scale},
                                    lane_i, lane_f, is_sc, key0, key1);
  L.snr_lin = snr_lin;
  L.add_noise = add_noise;
  L.sym0 = sym0;
  L.chunk = chunk;
  L.tile = tile;
  L.slice = slice;
  L.groups = groups;
  L.run = run;
  L.st = ofdm::make_stages(rows, stages, norm_part, norm_f, dump_r, dump_i, dump_rows);
  L.prev_r = prev_r;
  L.prev_i = prev_i;

  unsigned long long* a = reinterpret_cast<unsigned long long*>(acc);
  return static_cast<int>(ofdm::with_mode(mode, [&](auto md) {
    return launch_mode<decltype(md)::value>(L, partials, a, psum, carry_r, carry_i, stream);
  }));
}

// K3 of the wide mm chain: ofdm_fold_wide_probe's arguments and outputs
// (the zero-prefix TX block).  Returns the launch's CUDA error, 0 if none.
int ofdm_mm_wide_probe(const float* twr, const float* twi, int n, int T, int E, int n1, int n2, int log2n,
                       float dscale, int is_sc, int mode, int order, int m, int logm, int bits, int gray,
                       float scale, const int* lane_i, const float* lane_f, unsigned long long sym,
                       unsigned int key0, unsigned int key1, const float* rows, int stages, float* carry_r,
                       float* carry_i, float* tail_r, float* tail_i, void* stream_ptr) {
  if (!ofdm::wide_shape_ok(n, T, E, n1, n2, log2n, twr, twi) || T > ofdm::kWideMaxN ||
      (stages & ~ofdm::kStagePower) ||
      !ofdm::stage_args_ok(rows, stages, nullptr, nullptr, nullptr, nullptr, 0, false) ||
      (ofdm::adaptive(mode) && (lane_i == nullptr || lane_f == nullptr))) {
    return cudaErrorInvalidValue;
  }
  WideLink L = ofdm::make_wide_link(nullptr, nullptr, twr, twi, ofdm::Equalizer{}, n, T, E, n1, n2, log2n, dscale,
                                    ofdm::Qam{order, m, logm, bits, gray, scale}, lane_i, lane_f, is_sc, key0,
                                    key1);
  L.st = ofdm::make_stages(rows, stages, nullptr, nullptr, nullptr, nullptr, 0);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  return static_cast<int>(ofdm::with_mode(mode, [&](auto md) {
    return probe_mode<decltype(md)::value>(L, sym, carry_r, carry_i, tail_r, tail_i, stream);
  }));
}

const char* ofdm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
