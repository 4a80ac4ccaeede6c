// Fused fold-mode chunk past 256 subcarriers: one Monte-Carlo chunk of an
// SC-FDE link with a cyclic prefix or none (or an OFDM one whose lr
// factorization fails) from random words to error counters, one block a
// symbol, with nothing but the counters, the PAPR statistic and one carry
// row written to device memory.
//
// Replaces: ofdm_tpu/ops/pallas_link.py::_fn_for_spec -> kernel (its
// pallas_call at :1986), in its conv="mm" / "mm4", fold=True form at the
// widths the warp-per-symbol fold_main (fold_kernel.cu, n <= 256) does not
// hold: n = 257-2048 wherever the reference's dense budget admits the link
// (link_kernel.fold_fits, pallas_link._plan :124-216), in each
// constellation mode (a template parameter, link_common.cuh's codec; on
// SC-FDE lane t's order demaps time sample t); and K3, its carry probe
// (:2218).  Per OFDM symbol b, the semantics of the TPU kernel's dense
// products, not their form:
//   Philox words -> encode s_b [x sqrt(P)]
//   x_b  = TX block (SC-FDE: s_b; OFDM: block IDFT) with its cyclic prefix
//   PAPR max and sum over x_b[0:T), every symbol
//   y    = the K-tap stream convolution over [x_{b-1}[T-E:T) | x_b] at the
//          n samples after the guard
//   Y    = block DFT of y (wide_dft.cuh staged; block_dft.cuh at a split n)
//   AWGN per frequency bin, sigma = sqrt(mp / snr_lin / 2), mp the mean |Y|^2
//   over the first `slice` symbols of b's tile, before noise
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
// Bound on an H100: issue rate, not memory.  The chunk reads its taps,
// twiddles and equalizer rows (a few KB, L1 resident) and writes 3 counters
// and one row.  A symbol costs, at n = 1024 with 8 taps: the per-bin chain
// (Philox 100, encode 21, Box-Muller 72, MMSE 24, slicer 26, count 5
// operations), the 8 n K operations of the convolution, the two block
// transforms' 10 (n / 2) log2 n each and the 5 T of the PAPR: ~0.47M
// operations against the ~25M of the TPU's dense products.
//
// Design:
//  * One block of 256 threads a symbol (diag_wide's layout): thread t holds
//    bins k = t + 256 j (j < J <= 8); the MMSE mean and a symbol's
//    normalization energy are block sums in block_sum's fixed order, which
//    the plain version repeats (link_kernel.block_sum, 256 threads).  The
//    symbol's planes (two z = [tail | x] buffers, the transform's exchange
//    buffers and twiddles, the taps) live in shared memory (wide_chain.cuh),
//    43 KB at n = 1024.
//  * At n = 256 J the block transforms run staged (wide_dft.cuh): the
//    convolution's outputs enter the forward transform's first round in
//    registers, and a symbol takes 7 block barriers at 512 and 1024 sc
//    (SC-FDE, MMSE: TX 1, forward 2, the MMSE mean 1, the IDFT 3), 5 at
//    2048; block_dft.cuh's barrier a stage would make it 28 at 1024.
//  * A block walks `run` consecutive symbols, the previous tail in the
//    other z buffer; for its first symbol it recomputes symbol b-1's block
//    from Philox (or reads the carry-in), so nothing depends on block order,
//    launch geometry or chunking.
//  * Measured power: fold_wide_power, one block per 4096 slice elements
//    (e = b n + k), computes the symbols that cover them, lays |Y|^2 out in
//    shared memory in element order and reduces it in power_partials' fixed
//    order (16 sequential steps a thread, a 256-way tree); fold_wide_main sums
//    a tile's partials in order.
//  * normalize (staged build): fold_wide_main runs twice around norm_factors;
//    phase 0 writes one partial a block (its run's symbols' energies in
//    order), phase 1 scales and counts; both recompute the chain, the post-EQ
//    noise at the same Philox counter.
//  * Counters: per-thread 32-bit, warp and block sums, one 64-bit atomicAdd
//    a block; the PAPR peak an atomicMax on the f32 bits, the PAPR sum a
//    double atomicAdd (its last digits depend on block order).

#include <cstdint>
#include <cuda_runtime.h>

#include "wide_chain.cuh"

// A named namespace, so profilers show the kernels' names.
namespace ofdm_fold_wide {

using ofdm::kWideThreads;
using ofdm::kWideWarps;
using ofdm::WideBufs;
using ofdm::WideLink;

// One symbol up to Y before noise: the TX block (tx, w1, w2 for the thread's
// bins; the PAPR stats when `papr`; the carry row when carry_r is set), the
// convolution at the n post-guard samples, the block DFT; y holds the
// thread's bins of Y.  The staged transform takes the convolution's outputs
// in its first round's layout straight from registers.
template <int J, int kMode, bool kStaged>
__device__ __forceinline__ void symbol_bins(const WideLink& L, WideBufs& w, unsigned long long sym, bool papr,
                                            float& pk, double& ps, float* carry_r, float* carry_i, int (&tx)[J],
                                            uint32_t (&w1)[J], uint32_t (&w2)[J], float (&yr)[J], float (&yi)[J]) {
  ofdm::wide_tx<J, kMode, kStaged, false>(L, w, sym, tx, w1, w2);
  if (papr) ofdm::wide_papr(L, w, pk, ps, carry_r, carry_i);
  if (ofdm::wide_staged<J>(L.dft)) {
    ofdm::conv_slots<J, true>(L, w, L.L + static_cast<int>(__brev(threadIdx.x) >> 24), L.L + L.n, yr, yi);
    ofdm::staged_dft<J, false>(yr, yi, w.dft);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      yr[j] = yr[j] * L.dft.scale;
      yi[j] = yi[j] * L.dft.scale;
    }
  } else {
    ofdm::conv_slots<J, false>(L, w, L.L + static_cast<int>(threadIdx.x), L.L + L.n, yr, yi);
    ofdm::wide_transform<J, false>(L, w, yr, yi);
  }
}

// Partial sums of |Y|^2 (before noise) over each tile's measured-power
// slice, in power_partials' order.  grid (tiles, groups); block (tile, g)
// covers slice elements e = b*n + k in [g*4096, (g+1)*4096).
template <int J, int kMode, bool kStaged>
__global__ void __launch_bounds__(kWideThreads) fold_wide_power(WideLink L, float* partials) {
  extern __shared__ float2 smem2[];
  float* red = reinterpret_cast<float*>(smem2);  // kWidePowerBlock floats, element order
  WideBufs w = ofdm::wide_setup<J>(L, smem2 + ofdm::kWidePowerBlock / 2);
  const int tile_id = blockIdx.x;
  const int g = blockIdx.y;
  const int t = threadIdx.x;
  const int b0 = tile_id * L.tile;
  const int tlen = min(L.tile, L.chunk - b0);
  const int count = min(L.slice, tlen) * L.n;
  const int e_lo = g * ofdm::kWidePowerBlock;
  const int e_hi = min(e_lo + ofdm::kWidePowerBlock, count);
  for (int i = t; i < ofdm::kWidePowerBlock; i += kWideThreads) red[i] = 0.0f;
  if (e_lo < e_hi) {
    const int s_lo = e_lo / L.n;
    const int s_hi = (e_hi - 1) / L.n + 1;
    ofdm::wide_prev<J, kMode, kStaged, false>(L, w, L.sym0 + static_cast<unsigned long long>(b0 + s_lo));
    float pk = 0.0f;
    double ps = 0.0;
    int tx[J];
    uint32_t w1[J], w2[J];
    float yr[J], yi[J];
    for (int s = s_lo; s < s_hi; ++s) {
      symbol_bins<J, kMode, kStaged>(L, w, L.sym0 + static_cast<unsigned long long>(b0 + s), false, pk, ps,
                                     nullptr, nullptr, tx, w1, w2, yr, yi);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int k = t + kWideThreads * j;
        const int e = s * L.n + k;
        if (k < L.n && e >= e_lo && e < e_hi) red[e - e_lo] = yr[j] * yr[j] + yi[j] * yi[j];
      }
    }
  }
  ofdm::power_block_partial<kWideThreads, ofdm::kWidePowerSteps>(red, t, partials + tile_id * L.groups + g);
}

// The chain a symbol a block; with kStaged, the stages (phase 0 of a
// normalized link writes its run's |e|^2 partial instead of counting);
// kDump is the dump stage's launch-time variant, kBump the noise-bump
// stages (the OFDM_BUMP build).  Block barriers a symbol at n = 1024
// (SC-FDE, MMSE): the TX block's 1, the forward transform's 2, the MMSE
// mean's 1, the IDFT's 3.
template <int J, int kMode, bool kStaged, bool kDump = false, bool kBump = false>
__global__ void __launch_bounds__(kWideThreads, ofdm::wide_min_blocks(J))
    fold_wide_main(WideLink L, const float* partials, unsigned long long* acc, double* psum, float* carry_r,
                   float* carry_i) {
  extern __shared__ float2 smem2[];
  __shared__ float wsum[kWideWarps];
  __shared__ float wsum_e[kWideWarps];
  WideBufs w = ofdm::wide_setup<J>(L, smem2);
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
  if (b0 < L.chunk) ofdm::wide_prev<J, kMode, kStaged, false>(L, w, L.sym0 + static_cast<unsigned long long>(b0));
  for (int b = b0; b < b1; ++b) {
    const int tile_id = b / L.tile;
    if (L.add_noise && tile_id != cached_tile) {
      const int tlen = min(L.tile, L.chunk - tile_id * L.tile);
      sigma = ofdm::tile_sigma(partials + tile_id * L.groups, L.groups, min(L.slice, tlen) * L.n, L.snr_lin);
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
    symbol_bins<J, kMode, kStaged>(L, w, sym, counting, pk, ps, last ? carry_r : nullptr,
                                   last ? carry_i : nullptr, tx, w1, w2, yr, yi);
    if (L.add_noise) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        if (tid + kWideThreads * j < L.n) ofdm::add_noise(w1[j], w2[j], sigma, yr[j], yi[j]);
      }
    }
    const float nv = ofdm::wide_mmse_nv<J>(L, yr, yi, wsum);
    float er[J], ei[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int k = tid + kWideThreads * j;
      er[j] = 0.0f;
      ei[j] = 0.0f;
      if (k < L.n) ofdm::equalize_stage<kMode, kStaged>(L, k, yr[j], yi[j], nv, er[j], ei[j], sc);
    }
    // SC-FDE: equalized bins -> time-domain symbols, the block IDFT.
    if (sc) ofdm::wide_transform<J, true>(L, w, er, ei);
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
        energy = energy + ofdm::block_sum_once<kWideWarps>(p, wsum_e);
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
  if (bytes > ofdm::kWideMaxShared) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
}

template <int J>
size_t main_bytes(const WideLink& L) {
  return sizeof(float2) * ofdm::wide_float2s<J>(L.n, L.T, L.E, L.dft.log2n);
}

// fold_wide_power (when noise is on) then fold_wide_main at J bins a thread;
// in the OFDM_STAGED build fold_wide_main twice around norm_factors under
// normalize.
template <int J, int kMode>
cudaError_t launch(const WideLink& L, float* partials, unsigned long long* acc, double* psum, float* cr, float* ci,
                   cudaStream_t stream) {
  constexpr bool kS = ofdm::kStagedBuild;
  constexpr bool kB = ofdm::kBumpBuild;
  auto* main_kernel = &fold_wide_main<J, kMode, kS, false, kB>;
#if OFDM_STAGED
  if (L.st.bits & ofdm::kStageDump) main_kernel = &fold_wide_main<J, kMode, kS, true, kB>;
#endif
  const size_t mbytes = main_bytes<J>(L);
  const size_t power_bytes = mbytes + sizeof(float) * ofdm::kWidePowerBlock;
  cudaError_t err = allow_smem(main_kernel, mbytes);
  if (err != cudaSuccess) return err;
  if (L.add_noise) {
    err = allow_smem(&fold_wide_power<J, kMode, kS>, power_bytes);
    if (err != cudaSuccess) return err;
    const int tiles = (L.chunk + L.tile - 1) / L.tile;
    fold_wide_power<J, kMode, kS><<<dim3(tiles, L.groups), kWideThreads, power_bytes, stream>>>(L, partials);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int grid = (L.chunk + L.run - 1) / L.run;
#if OFDM_STAGED
  return ofdm::staged_passes(L.st.bits, L.st.norm_part, L.st.norm_f, L.chunk, L.tile, L.run, L.n, stream,
                             [&](int phase) {
    WideLink P = L;
    P.st.phase = phase;
    main_kernel<<<grid, kWideThreads, mbytes, stream>>>(P, partials, acc, psum, cr, ci);
    return cudaGetLastError();
  });
#else
  main_kernel<<<grid, kWideThreads, mbytes, stream>>>(L, partials, acc, psum, cr, ci);
  return cudaGetLastError();
#endif
}

template <int J, int kMode>
cudaError_t launch_probe(const WideLink& L, unsigned long long sym, float* cr, float* ci, float* tr, float* ti,
                         cudaStream_t stream) {
  auto* kernel = &ofdm::wide_probe<J, kMode, ofdm::kStagedBuild, false>;
  const size_t bytes = main_bytes<J>(L);
  const cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<1, kWideThreads, bytes, stream>>>(L, sym, cr, ci, tr, ti);
  return cudaGetLastError();
}

// Bins a thread, rounded up to a compiled width: 2, 4 or 8.
template <int kMode>
cudaError_t launch_mode(const WideLink& L, float* partials, unsigned long long* acc, double* psum, float* cr,
                        float* ci, cudaStream_t stream) {
  const int slots = ofdm::wide_slots(L.n);
  if (slots == 2) return launch<2, kMode>(L, partials, acc, psum, cr, ci, stream);
  if (slots == 4) return launch<4, kMode>(L, partials, acc, psum, cr, ci, stream);
  return launch<8, kMode>(L, partials, acc, psum, cr, ci, stream);
}

template <int kMode>
cudaError_t probe_mode(const WideLink& L, unsigned long long sym, float* cr, float* ci, float* tr, float* ti,
                       cudaStream_t stream) {
  const int slots = ofdm::wide_slots(L.n);
  if (slots == 2) return launch_probe<2, kMode>(L, sym, cr, ci, tr, ti, stream);
  if (slots == 4) return launch_probe<4, kMode>(L, sym, cr, ci, tr, ti, stream);
  return launch_probe<8, kMode>(L, sym, cr, ci, tr, ti, stream);
}

}  // namespace ofdm_fold_wide

using namespace ofdm_fold_wide;

extern "C" {

// One chunk of a fold link at n <= 2048 (the wrapper sends n > 256):
// fold_wide_power (when noise is on) then fold_wide_main, all on `stream`,
// in constellation mode `mode` (link_common.cuh::Mode; lane_i / lane_f the
// adaptive modes' lane rows).  tpr / tpi:
// the K = E + 1 unit-energy taps; twr / twi, n1, n2, log2n, dscale: the
// n-point DFT plan (ops/dft.py::DftPlan).  acc = [bit errors, symbol
// errors, PAPR peak f32 bits] (int64, accumulated), psum = PAPR power sum
// (float64, accumulated); carry = the chunk's last symbol's x[0:T).  rows /
// stages / norm_part / norm_f / dump: the _Spec stages
// (link_common.cuh::Stages; 0 in the plain build); prev: the carry-in, or
// null.  Returns the first CUDA error of the launches, 0 if none.
int ofdm_fold_wide_chunk(const float* tpr, const float* tpi, const float* twr, const float* twi, const float* hr,
                         const float* hi, const float* habs2, const float* gr, const float* gi, int n, int T, int E,
                         int n1, int n2, int log2n, float dscale, int mode, int order, int m, int logm, int bits,
                         int gray, float scale, const int* lane_i, const float* lane_f, float slicer, float snr_lin,
                         float cg, int method, int add_noise, int is_sc, unsigned long long sym0, int chunk,
                         int tile, int slice, int groups, int run, unsigned int key0, unsigned int key1,
                         float* partials, long long* acc, double* psum, float* carry_r, float* carry_i,
                         const float* rows, int stages, float* norm_part, float* norm_f, float* dump_r,
                         float* dump_i, int dump_rows, const float* prev_r, const float* prev_i,
                         void* stream_ptr) {
  if (!ofdm::wide_shape_ok(n, T, E, n1, n2, log2n, twr, twi) || tpr == nullptr || tpi == nullptr ||
      chunk < 1 || tile < 1 || slice < 1 || groups < 1 || run < 1 || tile % run != 0 ||
      static_cast<long long>(groups) * ofdm::kWidePowerBlock <
          static_cast<long long>(slice < tile ? slice : tile) * n ||
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

// K3 of the wide fold chain: run symbol `sym`'s carry row x[0:T) (carry_r /
// carry_i) and tail x[T-E:T) (tail_r / tail_i) through the chunk's TX stage
// in mode `mode` (apply_power only: `rows` and the stage bits), one block.
// Returns the launch's CUDA error, 0 if none.
int ofdm_fold_wide_probe(const float* twr, const float* twi, int n, int T, int E, int n1, int n2, int log2n,
                         float dscale, int is_sc, int mode, int order, int m, int logm, int bits, int gray,
                         float scale, const int* lane_i, const float* lane_f, unsigned long long sym,
                         unsigned int key0, unsigned int key1, const float* rows, int stages, float* carry_r,
                         float* carry_i, float* tail_r, float* tail_i, void* stream_ptr) {
  if (!ofdm::wide_shape_ok(n, T, E, n1, n2, log2n, twr, twi) || (stages & ~ofdm::kStagePower) ||
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

// The layout of the qam kernels at (n, T, E, log2n) into out[0..13): the
// slots a thread J, then fold_wide_main's (a chunk without a dump launches it),
// fold_wide_power's and wide_probe's registers, local bytes a thread, shared
// bytes a block and resident blocks an SM (ofdm_tpu_torch/ops/
// fold_kernel.py::wide_geometry).  Returns a CUDA error, 0 if none.
int ofdm_fold_wide_geometry(int n, int T, int E, int log2n, int* out) {
  if (n < 1 || n > ofdm::kWideMaxN || T < n || T - n > n || E < 0 || E > T) return cudaErrorInvalidValue;
  WideLink L{};
  L.n = n;
  L.T = T;
  L.E = E;
  L.L = T - n;
  L.dft.log2n = log2n;
  return static_cast<int>(ofdm::with_slots(n, [&](auto jc) {
    constexpr int J = decltype(jc)::value;
    constexpr bool kS = ofdm::kStagedBuild;
    constexpr bool kB = ofdm::kBumpBuild;
    out[0] = J;
    cudaError_t err = ofdm::wide_layout(&fold_wide_main<J, ofdm::kQam, kS, false, kB>, main_bytes<J>(L), out + 1);
    if (err == cudaSuccess) err = ofdm::wide_layout(&fold_wide_power<J, ofdm::kQam, kS>, main_bytes<J>(L) + sizeof(float) * ofdm::kWidePowerBlock, out + 5);
    if (err == cudaSuccess) {
      err = ofdm::wide_layout(&ofdm::wide_probe<J, ofdm::kQam, kS, false>, main_bytes<J>(L), out + 9);
    }
    return err;
  }));
}

const char* ofdm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
