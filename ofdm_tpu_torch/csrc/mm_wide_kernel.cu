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
//   Y    = block DFT of r (wide_dft.cuh staged; block_dft.cuh at a split n)
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
//    be 1.1 GB).  mm_wide_front: a block closes 8 power groups of 4096
//    consecutive time samples of a tile (e = s*T + t), walking the whole
//    symbols that cover them (TX and the convolution once a symbol, plus
//    its first symbol's predecessor), each symbol's |y|^2 row in shared
//    memory, in power_partials' fixed order (thread t adds its elements of
//    a group in ascending order, a 256-way tree closes the group).
//    mm_wide_main: a block walks `run` consecutive symbols through the whole
//    chain; it sums its tile's partials in order for sigma.
//  * One block of 256 threads a symbol: thread t holds head samples and
//    bins t + 256 j (J = ceil(n / 256) rounded up to 2, 4 or 8: 4 at 1024
//    sc, where slots counted from T would take 8) and computes the guard
//    sample n + i of each head slot i < L (L <= n) one at a time, its noise
//    and the overlap-add in registers; the MMSE mean and the normalization
//    energy are block sums in block_sum's fixed order
//    (link_kernel.block_sum, 256 threads).
//  * At n = 256 J the block transforms run staged (wide_dft.cuh): 8 block
//    barriers a symbol at 512 and 1024 sc (SC-FDE, MMSE: TX 1, the forward
//    transform from natural order 3, the MMSE mean 1, the IDFT 3);
//    block_dft.cuh's barrier a stage would make it 29 at 1024.
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

// Power groups (4096 time samples each) one mm_wide_front block closes.
constexpr int kFrontGroups = 8;

// One symbol's y before noise at the thread's head samples i = t + 256 j < n,
// after the TX block (tx, w1, w2 for the head samples; the PAPR stats when
// `papr`; the carry row when carry_r is set).
template <int J, int kMode, bool kStaged>
__device__ __forceinline__ void symbol_samples(const WideLink& L, WideBufs& w, unsigned long long sym, bool papr,
                                               float& pk, double& ps, float* carry_r, float* carry_i, int (&tx)[J],
                                               uint32_t (&w1)[J], uint32_t (&w2)[J], float (&yr)[J], float (&yi)[J]) {
  ofdm::wide_tx<J, kMode, kStaged, true>(L, w, sym, tx, w1, w2);
  if (papr) ofdm::wide_papr(L, w, pk, ps, carry_r, carry_i);
  ofdm::conv_slots<J, false>(L, w, static_cast<int>(threadIdx.x), L.n, yr, yi);
}

// y before noise at guard sample n + i (i < L), one sample at a time so the
// guard holds no slot arrays.
__device__ __forceinline__ void guard_sample(const WideLink& L, const WideBufs& w, int i, float& yr, float& yi) {
  float gr[1], gi[1];
  ofdm::conv_slots<1, false>(L, w, L.n + i, L.T, gr, gi);
  yr = gr[0];
  yi = gi[0];
}

// Partial sums of |y|^2 (before noise) over each tile's time samples, in
// power_partials' order (power_block_partial): group g's thread t adds the
// elements e = s*T + m = 4096 g + 256 j + t, j ascending, and the block's
// 256-way tree closes the group.  grid (tiles, ceil(groups / kFrontGroups));
// a block walks the whole symbols that cover its groups, each symbol's TX
// and convolution once (plus its first symbol's predecessor), and reads the
// elements out of the symbol's |y|^2 row in shared memory.
template <int J, int kMode, bool kStaged>
__global__ void __launch_bounds__(kWideThreads) mm_wide_front(WideLink L, float* partials) {
  extern __shared__ float2 smem2[];
  const int row_len = (L.T + 1) & ~1;
  float* row = reinterpret_cast<float*>(smem2);  // the symbol's |y|^2, T floats
  float* red = row + row_len;                     // the tree's kWideThreads floats
  WideBufs w = ofdm::wide_setup<J>(L, smem2 + (row_len + kWideThreads) / 2);
  const int tile_id = blockIdx.x;
  const int t = threadIdx.x;
  const int b0 = tile_id * L.tile;
  const int count = min(L.tile, L.chunk - b0) * L.T;
  const int g_lo = blockIdx.y * kFrontGroups;
  const int g_hi = min(g_lo + kFrontGroups, L.groups);
  const int e_lo = g_lo * ofdm::kWidePowerBlock;
  const int e_hi = min(g_hi * ofdm::kWidePowerBlock, count);
  float* out = partials + tile_id * L.groups;
  int g = g_lo;
  float acc = 0.0f;
  int e_next = g * ofdm::kWidePowerBlock + t;  // the thread's next element of group g
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
      symbol_samples<J, kMode, kStaged>(L, w, L.sym0 + static_cast<unsigned long long>(b0 + s), false, pk, ps,
                                        nullptr, nullptr, tx, w1, w2, yr, yi);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int i = t + kWideThreads * j;
        if (i < L.n) row[i] = yr[j] * yr[j] + yi[j] * yi[j];
        if (i < L.L) {
          float gr, gi;
          guard_sample(L, w, i, gr, gi);
          row[L.n + i] = gr * gr + gi * gi;
        }
      }
      __syncthreads();
      const int s_e0 = s * L.T;
      const int s_e1 = min(s_e0 + L.T, e_hi);
      while (g < g_hi) {
        const int g_end = min((g + 1) * ofdm::kWidePowerBlock, e_hi);
        for (const int stop = min(s_e1, g_end); e_next < stop; e_next += kWideThreads) acc = acc + row[e_next - s_e0];
        if (g_end > s_e1) break;  // the group goes on in the next symbol
        ofdm::store_block_sum<kWideThreads>(acc, red, t, out + g);
        acc = 0.0f;
        ++g;
        e_next = g * ofdm::kWidePowerBlock + t;
      }
    }
  }
  for (; g < g_hi; ++g) ofdm::store_block_sum<kWideThreads>(0.0f, red, t, out + g);  // groups past the tile
}

// The chain a symbol a block; with kStaged, the stages (phase 0 of a
// normalized link writes its run's |e|^2 partial instead of counting);
// kDump is the dump stage's launch-time variant, kBump the noise-bump
// stages (the OFDM_BUMP build).  Thread t holds head samples and bins t +
// 256 j (J = ceil(n / 256) rounded up to 2, 4 or 8) and the guard samples n
// + i, i < L, of its head slots: their noise from counter (sym, n + i, 0)
// and the overlap-add r[i] = y[i] + y[n + i] in registers.  Block barriers
// a symbol at n = 1024 (SC-FDE, MMSE): the TX block's 1, the forward
// transform's 3, the MMSE mean's 1, the IDFT's 3.
template <int J, int kMode, bool kStaged, bool kDump = false, bool kBump = false>
__global__ void __launch_bounds__(kWideThreads, ofdm::wide_min_blocks(J))
    mm_wide_main(WideLink L, const float* partials, unsigned long long* acc, double* psum, float* carry_r,
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
    symbol_samples<J, kMode, kStaged>(L, w, sym, counting, pk, ps, last ? carry_r : nullptr,
                                      last ? carry_i : nullptr, tx, w1, w2, yr, yi);
    // The noise, then the overlap-add of the zero-prefix tail onto the head
    // (linops.rx_matrix).
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int i = tid + kWideThreads * j;
      if (i < L.n && L.add_noise) ofdm::add_noise(w1[j], w2[j], sigma, yr[j], yi[j]);
      if (i < L.L) {
        float gr, gi;
        guard_sample(L, w, i, gr, gi);
        if (L.add_noise) {
          const uint4 wd = ofdm::symbol_words(sym, L.n + i, L.key);
          ofdm::add_noise(wd.y, wd.z, sigma, gr, gi);
        }
        yr[j] = yr[j] + gr;
        yi[j] = yi[j] + gi;
      }
    }
    ofdm::wide_transform<J, false>(L, w, yr, yi);
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

// mm_wide_front's extra: the |y|^2 row and the tree.
inline size_t front_extra(const WideLink& L) {
  return sizeof(float) * (((L.T + 1) & ~1) + kWideThreads);
}

// mm_wide_front (when noise is on) then mm_wide_main at J slots a thread;
// in the OFDM_STAGED build mm_wide_main twice around norm_factors under
// normalize.
template <int J, int kMode>
cudaError_t launch(const WideLink& L, float* partials, unsigned long long* acc, double* psum, float* cr, float* ci,
                   cudaStream_t stream) {
  constexpr bool kS = ofdm::kStagedBuild;
  constexpr bool kB = ofdm::kBumpBuild;
  auto* main_kernel = &mm_wide_main<J, kMode, kS, false, kB>;
#if OFDM_STAGED
  if (L.st.bits & ofdm::kStageDump) main_kernel = &mm_wide_main<J, kMode, kS, true, kB>;
#endif
  const size_t mbytes = main_bytes<J>(L);
  const size_t front_bytes = mbytes + front_extra(L);
  cudaError_t err = allow_smem(main_kernel, mbytes);
  if (err != cudaSuccess) return err;
  if (L.add_noise) {
    err = allow_smem(&mm_wide_front<J, kMode, kS>, front_bytes);
    if (err != cudaSuccess) return err;
    const int tiles = (L.chunk + L.tile - 1) / L.tile;
    const dim3 grid(tiles, (L.groups + kFrontGroups - 1) / kFrontGroups);
    mm_wide_front<J, kMode, kS><<<grid, kWideThreads, front_bytes, stream>>>(L, partials);
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
  auto* kernel = &ofdm::wide_probe<J, kMode, ofdm::kStagedBuild, true>;
  const size_t bytes = main_bytes<J>(L);
  const cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<1, kWideThreads, bytes, stream>>>(L, sym, cr, ci, tr, ti);
  return cudaGetLastError();
}

// Slots a thread from n, rounded up to a compiled width: 2, 4 or 8 (the
// guard's L <= n samples ride the head slots).
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

// The layout of the qam kernels at (n, T, E, log2n) into out[0..13): the
// slots a thread J, then mm_wide_main's (a chunk without a dump launches it),
// mm_wide_front's and wide_probe's registers, local bytes a thread, shared
// bytes a block and resident blocks an SM (ofdm_tpu_torch/ops/
// mm_kernel.py::wide_geometry).  Returns a CUDA error, 0 if none.
int ofdm_mm_wide_geometry(int n, int T, int E, int log2n, int* out) {
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
    cudaError_t err = ofdm::wide_layout(&mm_wide_main<J, ofdm::kQam, kS, false, kB>, main_bytes<J>(L), out + 1);
    if (err == cudaSuccess) err = ofdm::wide_layout(&mm_wide_front<J, ofdm::kQam, kS>, main_bytes<J>(L) + front_extra(L), out + 5);
    if (err == cudaSuccess) {
      err = ofdm::wide_layout(&ofdm::wide_probe<J, ofdm::kQam, kS, true>, main_bytes<J>(L), out + 9);
    }
    return err;
  }));
}

const char* ofdm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
