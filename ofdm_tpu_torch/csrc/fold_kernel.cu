// Fused fold-mode chunk of the OFDM / SC-FDE link: one Monte-Carlo chunk from
// random words to error counters, with nothing but the counters, the PAPR
// statistic and the carry row written to device memory.
//
// Replaces: ofdm_tpu/ops/pallas_link.py::_fn_for_spec -> kernel, in its
// conv="mm", fold=True form: SC-FDE with a cyclic prefix or none, and OFDM
// whose guard is shorter than the channel order; in each constellation mode
// (qam, psk, aqam, apsk: a template parameter, link_common.cuh's codec;
// on SC-FDE lane t's order demaps time sample t).  Per OFDM symbol b:
//   Philox words -> encode s_b [x sqrt(P)]
//   x_b  = s_b @ F_tx,ext                  (n -> T+E: IDFT/identity + guard,
//                                           the last E columns repeated)
//   PAPR max and sum over x_b[0:T)
//   act  = [x_b[0:T) | x_{b-1}[T:T+E)]     (the previous symbol's tail)
//   y    = act @ CM                        (T+E -> n: conv + guard strip + DFT)
//   AWGN per frequency bin, sigma = sqrt(mp / snr_lin / 2), mp the mean |y|^2
//   over the first `slice` symbols of b's tile, before noise
//   ZF / MMSE / none with the slicer gain 0.5/scale folded in (aqam: the
//   lane's row; on SC-FDE deferred past the IDFT)
//   SC-FDE only: e = e @ IDFT (n -> n)
//   [post-EQ noise, x 1/sqrt(P): per time sample on SC-FDE]
//   [x the tile's unit-power factor, the slicer gain deferred to it]
//   aqam on SC-FDE without normalize: time sample t x lane t's slicer row
//   slicer or PSK sector -> popcount(tx ^ rx) into int64 counters.
// The bracketed _Spec stages exist only in the build with -DOFDM_STAGED=1
// (the kernels' kStaged parameter; link_common.cuh), the post-EQ noise and
// 1/sqrt(P) only in the one with -DOFDM_BUMP=1 as well (kBump).
//
// Bound on an H100: issue rate, not memory.  The chunk reads its constant
// matrices (~100 KB at n = 64, L1/L2 resident) and writes 3 counters and one
// row.  Each symbol runs n(T+E) + (T+E)n (+ n^2 for SC-FDE) complex
// multiply-adds at 8 fp32 operations each (no FMA: -fmad=false), dense
// even where a matrix only copies (SC-FDE's F_tx,ext), plus the per-bin
// Philox / noise / equalizer / slicer chain it shares with the diag kernel
// (link_common.cuh).
//
// Design:
//  * The TPU grid runs in order and carries the last TX row from tile to tile;
//    CUDA blocks do not.  A warp walks `run` consecutive symbols and keeps the
//    previous symbol's tail in shared memory; for its first symbol it
//    recomputes symbol b-1's tail from Philox (encode, then the same k-ascending
//    product over the same F_tx,ext columns), which is bit-equal to the row a
//    carry would hold.  Symbol 0 of the run sees zeros.  So nothing depends on
//    block order, launch geometry or chunking.
//  * Measured power: a first kernel (fold_power) recomputes y for each tile's
//    slice (one block per 4096 slice elements), lays |y|^2 out in shared
//    memory in element order and reduces it in power_partials' fixed order
//    (16 sequential steps a thread, a 256-way tree); fold_main sums a tile's
//    partials in order.  The plain version reproduces sigma bit for bit.  At
//    tile 8192 and slice 1024 the pass costs ~12.5% of the products.
//  * One warp per symbol: lane owns bins k = lane + 32 j (j < J = ceil(n/32),
//    n <= 256), so the MMSE per-symbol mean is a per-lane sum plus an xor
//    butterfly, as in diag_main.  Each product output is a k-ascending sum of
//    rounded (a*f_r - c*f_i), (a*f_i + c*f_r) terms, as the plain version's
//    cmatmul; the matrices are read through the read-only cache.  The TX
//    stage, the tail recompute and the products are link_common.cuh's,
//    shared with the mm kernel.
//  * Counters: per-thread 32-bit, warp and block sums, one 64-bit atomicAdd
//    per block; PAPR peak an atomicMax on the f32 bits, PAPR sum a double
//    atomicAdd (its last digits depend on block order).
//  * normalize (staged build): fold_main runs twice around norm_factors, as
//    diag_staged does; phase 0 writes each warp's |e|^2 sum over its run of
//    symbols (after the SC IDFT and the noise-bump stages), phase 1 scales
//    and counts.  The post-EQ noise is drawn again in phase 1 at the same
//    Philox counter, so both passes see the same e.
//  * Carry-in (sharded contiguous streams): given a tail, the chunk's first
//    symbol reads it instead of recomputing its predecessor, in every pass
//    that recomputes one (fold_power, both passes of fold_main); other
//    first symbols of a warp still recompute under the chunk's key.  In the
//    plain build fold_main's read is a template variant (kPrev) chosen at
//    launch, so a chunk without a carry-in runs the code it had (a run-time
//    test there moved four qam widths' registers).
//  * The carry probe (fold_probe; pallas_link.py::_probe_fn_for_spec, K3):
//    one warp computes a chunk's last symbol through the same symbol_tx and
//    writes its carry row x[0:T) and tail x[T:T+E), bit-equal to the
//    chunk's carry and to the tail a following symbol reads.

#include <cstdint>
#include <cuda_runtime.h>

#include "link_common.cuh"

namespace ofdm_fold {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kPowerSteps = 16;
constexpr int kPowerBlock = kPowerSteps * kThreads;  // slice elements per fold_power block
constexpr int kMaxN = 256;

struct Link {
  const float* txr;  // (n, T+E) F_tx,ext, row-major
  const float* txi;
  const float* cmr;  // (T+E, n) conv + guard strip + DFT, row-major
  const float* cmi;
  const float* idr;  // (n, n) SC-FDE IDFT (unused for OFDM)
  const float* idi;
  ofdm::Equalizer eq;
  int n;
  int T;
  int E;
  ofdm::Qam q;
  float snr_lin;
  int add_noise;
  int is_sc;
  unsigned long long sym0;  // run index of the chunk's first symbol
  int chunk;
  int tile;
  int slice;
  int groups;
  int run;  // consecutive symbols a warp of fold_main walks
  uint2 key;
  ofdm::Lanes lanes;  // the adaptive modes' lane rows
  ofdm::Stages st;    // the _Spec stages (OFDM_STAGED builds)
  const float* prev_r;  // (E,) tail the chunk's first symbol reads, or null
  const float* prev_i;
};

using ofdm::WarpBufs;
using ofdm::warp_bufs;
using ofdm::warp_floats;

// One symbol up to y before noise: the TX stage (link_common.cuh::symbol_tx:
// s, tx/w1/w2 for the lane's bins, x into act, the PAPR stats when `papr`,
// the carry row when `carry_r` is set), then y = act @ CM, then the next
// tail moves into act.
template <int J, int kMode, bool kStaged>
__device__ __forceinline__ void symbol_y(const Link& L, const WarpBufs& w, unsigned long long sym,
                                         int lane, bool papr, float& pk, double& ps,
                                         float* carry_r, float* carry_i, int (&tx)[J],
                                         uint32_t (&w1)[J], uint32_t (&w2)[J], float (&yr)[J],
                                         float (&yi)[J]) {
  ofdm::symbol_tx<J, kMode, kStaged>(L, w, sym, lane, papr, pk, ps, carry_r, carry_i, tx, w1, w2);
  ofdm::row_product<J>(w.ar, w.ai, L.cmr, L.cmi, L.T + L.E, L.n, lane, yr, yi);
  ofdm::shift_tail(L, w, lane);
}

// Partial sums of |y|^2 (before noise) over each tile's measured-power slice,
// in power_partials' order.  grid (tiles, groups); block (tile, g) covers
// slice elements e = b*n + k in [g*4096, (g+1)*4096).
template <int J, int kMode, bool kStaged>
__global__ void __launch_bounds__(kThreads) fold_power(Link L, float* partials) {
  extern __shared__ float smem[];
  float* red = smem;  // kPowerBlock floats, element order
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const WarpBufs w =
      warp_bufs(L.n, L.T, L.E, smem + kPowerBlock + warp * warp_floats(L.n, L.T, L.E));
  const int tile_id = blockIdx.x;
  const int g = blockIdx.y;
  const int t = threadIdx.x;
  const int b0 = tile_id * L.tile;
  const int tlen = min(L.tile, L.chunk - b0);
  const int count = min(L.slice, tlen) * L.n;
  const int e_lo = g * kPowerBlock;
  const int e_hi = min(e_lo + kPowerBlock, count);
  for (int i = t; i < kPowerBlock; i += kThreads) red[i] = 0.0f;
  __syncthreads();
  if (e_lo < e_hi) {
    const int s_lo = e_lo / L.n;
    const int s_hi = (e_hi - 1) / L.n + 1;
    const int per = (s_hi - s_lo + kWarps - 1) / kWarps;
    const int w_lo = s_lo + warp * per;
    const int w_hi = min(w_lo + per, s_hi);
    if (w_lo < w_hi) {
      ofdm::prev_tail<kMode, kStaged>(L, w, L.sym0 + static_cast<unsigned long long>(b0 + w_lo), lane);
      float pk = 0.0f;
      double ps = 0.0;
      int tx[J];
      uint32_t w1[J], w2[J];
      float yr[J], yi[J];
      for (int s = w_lo; s < w_hi; ++s) {
        symbol_y<J, kMode, kStaged>(L, w, L.sym0 + static_cast<unsigned long long>(b0 + s), lane, false, pk,
                                    ps, nullptr, nullptr, tx, w1, w2, yr, yi);
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int k = lane + 32 * j;
          const int e = s * L.n + k;
          if (k < L.n && e >= e_lo && e < e_hi) red[e - e_lo] = yr[j] * yr[j] + yi[j] * yi[j];
        }
      }
    }
  }
  ofdm::power_block_partial<kThreads, kPowerSteps>(red, t, partials + tile_id * L.groups + g);
}

// The chain per symbol; with kStaged, the stages (phase 0 of a normalized
// link writes its run's |e|^2 partial instead of counting).
template <int J, int kMode, bool kStaged, bool kDump = false, bool kPrev = true, bool kBump = false>
__global__ void __launch_bounds__(kThreads)
    fold_main(Link L, const float* partials, unsigned long long* acc, double* psum,
              float* carry_r, float* carry_i) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // SC-FDE reuses a warp's s buffer for the equalized bins.
  const WarpBufs w = warp_bufs(L.n, L.T, L.E, smem + warp * warp_floats(L.n, L.T, L.E));

  uint32_t be = 0, se = 0;
  float pk = 0.0f;
  double ps = 0.0;

  const long long first = (static_cast<long long>(blockIdx.x) * kWarps + warp) * L.run;
  const bool counting = !kStaged || L.st.phase == 1;
  const bool normalize = kStaged && (L.st.bits & ofdm::kStageNormalize) != 0;
  if (first < L.chunk) {
    const int b0 = static_cast<int>(first);
    const int b1 = min(b0 + L.run, L.chunk);
    ofdm::prev_tail<kMode, kStaged, kPrev>(L, w, L.sym0 + static_cast<unsigned long long>(b0), lane);
    int cached_tile = -1;
    float sigma = 0.0f;
    int norm_tile = -1;
    float fn = 1.0f, energy = 0.0f;
    int tx[J];
    uint32_t w1[J], w2[J];
    float yr[J], yi[J];
    for (int b = b0; b < b1; ++b) {
      const int tile_id = b / L.tile;
      if (L.add_noise && tile_id != cached_tile) {
        const int tlen = min(L.tile, L.chunk - tile_id * L.tile);
        sigma = ofdm::tile_sigma(partials + tile_id * L.groups, L.groups, min(L.slice, tlen) * L.n,
                                 L.snr_lin);
        cached_tile = tile_id;
      }
      if constexpr (kStaged) {
        if (normalize && counting && tile_id != norm_tile) {
          fn = L.st.norm_f[tile_id];
          norm_tile = tile_id;
        }
      }
      const bool last = counting && b == L.chunk - 1;
      symbol_y<J, kMode, kStaged>(L, w, L.sym0 + static_cast<unsigned long long>(b), lane, counting, pk, ps,
                                  last ? carry_r : nullptr, last ? carry_i : nullptr, tx, w1, w2, yr, yi);
      if (L.add_noise) {
#pragma unroll
        for (int j = 0; j < J; ++j) {
          if (lane + 32 * j < L.n) ofdm::add_noise(w1[j], w2[j], sigma, yr[j], yi[j]);
        }
      }

      const float nv = ofdm::mmse_nv<J>(L.eq, yr, yi, lane, L.n, L.snr_lin);
      float er[J], ei[J];
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int k = lane + 32 * j;
        er[j] = 0.0f;
        ei[j] = 0.0f;
        if (k < L.n) ofdm::equalize_stage<kMode, kStaged>(L, k, yr[j], yi[j], nv, er[j], ei[j], L.is_sc);
      }

      if (L.is_sc) {
        // SC-FDE: equalized bins -> time-domain symbols, e @ IDFT.
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int k = lane + 32 * j;
          if (k < L.n) {
            w.sr[k] = er[j];
            w.si[k] = ei[j];
          }
        }
        __syncwarp();
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int k = lane + 32 * j;
          if (k < L.n) ofdm::cdot(w.sr, w.si, L.idr, L.idi, L.n, L.n, k, er[j], ei[j]);
        }
        __syncwarp();
      }

      if constexpr (kBump) {
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int k = lane + 32 * j;
          if (k < L.n) ofdm::bump_stages<true>(L, L.sym0 + static_cast<unsigned long long>(b), k, er[j], ei[j]);
        }
      }
      if constexpr (kStaged) {
        if (normalize) {
          if (!counting) {
            energy = energy + ofdm::warp_energy<J>(er, ei, lane, L.n);
            continue;
          }
#pragma unroll
          for (int j = 0; j < J; ++j) {
            const int k = lane + 32 * j;
            if (k < L.n) {
              const float m = ofdm::norm_gain<kMode>(L, k, fn);
              er[j] = er[j] * m;
              ei[j] = ei[j] * m;
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int k = lane + 32 * j;
        if (k < L.n) {
          ofdm::sc_slicer_bin<kMode, kStaged>(L, k, er[j], ei[j]);
          ofdm::dump_bin<kMode, kDump>(L, b, k, er[j], ei[j]);
          ofdm::count_bin<kMode>(tx[j], er[j], ei[j], L.q, L.lanes, k, be, se);
        }
      }
    }
    if constexpr (kStaged) {
      if (normalize && !counting && lane == 0) L.st.norm_part[b0 / L.run] = energy;
    }
  }

  ofdm::flush_counters<kWarps>(be, se, pk, ps, acc, psum);
}

// K3: symbol `sym`'s carry row x[0:T) and tail x[T:T+E) through the chunk's
// own TX stage (symbol_tx), one warp.
template <int J, int kMode, bool kStaged>
__global__ void __launch_bounds__(32)
    fold_probe(Link L, unsigned long long sym, float* carry_r, float* carry_i, float* tail_r, float* tail_i) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x;
  const WarpBufs w = warp_bufs(L.n, L.T, L.E, smem);
  float pk = 0.0f;
  double ps = 0.0;
  int tx[J];
  uint32_t w1[J], w2[J];
  ofdm::symbol_tx<J, kMode, kStaged>(L, w, sym, lane, false, pk, ps, carry_r, carry_i, tx, w1, w2);
  for (int t = lane; t < L.E; t += 32) {
    tail_r[t] = w.nr[t];
    tail_i[t] = w.ni[t];
  }
}

template <int J, int kMode>
cudaError_t launch_probe(const Link& L, unsigned long long sym, float* cr, float* ci, float* tr, float* ti,
                         cudaStream_t stream) {
  const size_t bytes = sizeof(float) * warp_floats(L.n, L.T, L.E);
  fold_probe<J, kMode, ofdm::kStagedBuild><<<1, 32, bytes, stream>>>(L, sym, cr, ci, tr, ti);
  return cudaGetLastError();
}

template <int J, int kMode>
cudaError_t launch(const Link& L, float* partials, unsigned long long* acc, double* psum,
                   float* cr, float* ci, cudaStream_t stream) {
  constexpr bool kS = ofdm::kStagedBuild;
  constexpr bool kB = ofdm::kBumpBuild;
  auto* main_kernel = &fold_main<J, kMode, kS, false, true, kB>;
#if OFDM_STAGED
  if (L.st.bits & ofdm::kStageDump) main_kernel = &fold_main<J, kMode, kS, true, true, kB>;
#else
  if (L.prev_r == nullptr) main_kernel = &fold_main<J, kMode, kS, false, false>;
#endif
  const int wf = warp_floats(L.n, L.T, L.E);
  const size_t main_bytes = sizeof(float) * kWarps * wf;
  const size_t power_bytes = sizeof(float) * (kPowerBlock + kWarps * wf);
  cudaError_t err = cudaFuncSetAttribute(main_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(main_bytes));
  if (err != cudaSuccess) return err;
  if (L.add_noise) {
    err = cudaFuncSetAttribute(fold_power<J, kMode, kS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(power_bytes));
    if (err != cudaSuccess) return err;
    const int tiles = (L.chunk + L.tile - 1) / L.tile;
    fold_power<J, kMode, kS><<<dim3(tiles, L.groups), kThreads, power_bytes, stream>>>(L, partials);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const long long warps = (static_cast<long long>(L.chunk) + L.run - 1) / L.run;
  const int grid = static_cast<int>((warps + kWarps - 1) / kWarps);
#if OFDM_STAGED
  return ofdm::staged_passes(L.st.bits, L.st.norm_part, L.st.norm_f, L.chunk, L.tile, L.run, L.n, stream,
                             [&](int phase) {
    Link P = L;
    P.st.phase = phase;
    main_kernel<<<grid, kThreads, main_bytes, stream>>>(P, partials, acc, psum, cr, ci);
    return cudaGetLastError();
  });
#else
  main_kernel<<<grid, kThreads, main_bytes, stream>>>(L, partials, acc, psum, cr, ci);
  return cudaGetLastError();
#endif
}

template <int kMode>
cudaError_t launch_mode(const Link& L, float* partials, unsigned long long* acc, double* psum,
                        float* cr, float* ci, cudaStream_t stream) {
  switch ((L.n + 31) / 32) {
    case 1: return launch<1, kMode>(L, partials, acc, psum, cr, ci, stream);
    case 2: return launch<2, kMode>(L, partials, acc, psum, cr, ci, stream);
    case 3: return launch<3, kMode>(L, partials, acc, psum, cr, ci, stream);
    case 4: return launch<4, kMode>(L, partials, acc, psum, cr, ci, stream);
    case 5: return launch<5, kMode>(L, partials, acc, psum, cr, ci, stream);
    case 6: return launch<6, kMode>(L, partials, acc, psum, cr, ci, stream);
    case 7: return launch<7, kMode>(L, partials, acc, psum, cr, ci, stream);
    default: return launch<8, kMode>(L, partials, acc, psum, cr, ci, stream);
  }
}

template <int kMode>
cudaError_t probe_mode(const Link& L, unsigned long long sym, float* cr, float* ci, float* tr, float* ti,
                       cudaStream_t stream) {
  switch ((L.n + 31) / 32) {
    case 1: return launch_probe<1, kMode>(L, sym, cr, ci, tr, ti, stream);
    case 2: return launch_probe<2, kMode>(L, sym, cr, ci, tr, ti, stream);
    case 3: return launch_probe<3, kMode>(L, sym, cr, ci, tr, ti, stream);
    case 4: return launch_probe<4, kMode>(L, sym, cr, ci, tr, ti, stream);
    case 5: return launch_probe<5, kMode>(L, sym, cr, ci, tr, ti, stream);
    case 6: return launch_probe<6, kMode>(L, sym, cr, ci, tr, ti, stream);
    case 7: return launch_probe<7, kMode>(L, sym, cr, ci, tr, ti, stream);
    default: return launch_probe<8, kMode>(L, sym, cr, ci, tr, ti, stream);
  }
}

}  // namespace ofdm_fold

using namespace ofdm_fold;

extern "C" {

// One chunk: fold_power (when noise is on) then fold_main, both on `stream`,
// in constellation mode `mode` (link_common.cuh::Mode; lane_i / lane_f the
// adaptive modes' lane rows).  acc = [bit
// errors, symbol errors, PAPR peak f32 bits] (int64, accumulated), psum =
// PAPR power sum (float64, accumulated); carry = the chunk's last symbol's
// x[0:T).  rows / stages / norm_part / norm_f: the _Spec stages
// (link_common.cuh::Stages; 0 in the plain build).  Returns the first CUDA
// error of the launches, 0 if none.
int ofdm_fold_chunk(const float* txr, const float* txi, const float* cmr, const float* cmi,
                    const float* idr, const float* idi, const float* hr, const float* hi,
                    const float* habs2, const float* gr, const float* gi, int n, int T, int E,
                    int mode, int order, int m, int logm, int bits, int gray, float scale,
                    const int* lane_i, const float* lane_f, float slicer,
                    float snr_lin, float cg, int method, int add_noise, int is_sc,
                    unsigned long long sym0, int chunk, int tile, int slice, int groups, int run,
                    unsigned int key0, unsigned int key1, float* partials, long long* acc,
                    double* psum, float* carry_r, float* carry_i, const float* rows, int stages,
                    float* norm_part, float* norm_f,
                    float* dump_r, float* dump_i, int dump_rows, const float* prev_r,
                    const float* prev_i, void* stream_ptr) {
  if (n < 1 || n > kMaxN || T < n || E < 0 || E > T || chunk < 1 || tile < 1 || slice < 1 ||
      (prev_r == nullptr) != (prev_i == nullptr) ||
      groups < 1 || run < 1 || tile % run != 0 || (is_sc && (idr == nullptr || idi == nullptr)) ||
      (ofdm::adaptive(mode) && (lane_i == nullptr || lane_f == nullptr)) ||
      !ofdm::stage_args_ok(rows, stages, norm_part, norm_f, dump_r, dump_i, dump_rows, ofdm::kBumpBuild)) {
    return cudaErrorInvalidValue;
  }
  if (sizeof(float) * (kPowerBlock + kWarps * warp_floats(n, T, E)) > 227 * 1024) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Link L;
  L.txr = txr;
  L.txi = txi;
  L.cmr = cmr;
  L.cmi = cmi;
  L.idr = idr;
  L.idi = idi;
  L.eq = ofdm::Equalizer{hr, hi, habs2, gr, gi, slicer, cg, method};
  L.n = n;
  L.T = T;
  L.E = E;
  L.q = ofdm::Qam{order, m, logm, bits, gray, scale};
  L.lanes = ofdm::Lanes{lane_i, lane_f, n};
  L.snr_lin = snr_lin;
  L.add_noise = add_noise;
  L.is_sc = is_sc;
  L.sym0 = sym0;
  L.chunk = chunk;
  L.tile = tile;
  L.slice = slice;
  L.groups = groups;
  L.run = run;
  L.key = make_uint2(key0, key1);
  L.st = ofdm::make_stages(rows, stages, norm_part, norm_f, dump_r, dump_i, dump_rows);
  L.prev_r = prev_r;
  L.prev_i = prev_i;

  unsigned long long* a = reinterpret_cast<unsigned long long*>(acc);
  return static_cast<int>(ofdm::with_mode(mode, [&](auto md) {
    return launch_mode<decltype(md)::value>(L, partials, a, psum, carry_r, carry_i, stream);
  }));
}

// K3, the carry probe: run symbol `sym`'s carry row x[0:T) (carry_r /
// carry_i) and tail x[T:T+E) (tail_r / tail_i), through the chunk's TX
// stage in mode `mode` (apply_power only: `rows` and the stage bits).  The
// chunk of run symbols [sym0, sym0 + chunk) returns symbol sym0 + chunk -
// 1's row as its carry.  Returns the launch's CUDA error, 0 if none.
int ofdm_fold_probe(const float* txr, const float* txi, int n, int T, int E, int mode, int order, int m,
                    int logm, int bits, int gray, float scale, const int* lane_i, const float* lane_f,
                    unsigned long long sym, unsigned int key0, unsigned int key1, const float* rows,
                    int stages, float* carry_r, float* carry_i, float* tail_r, float* tail_i,
                    void* stream_ptr) {
  if (n < 1 || n > kMaxN || T < n || E < 0 || E > T || (stages & ~ofdm::kStagePower) ||
      !ofdm::stage_args_ok(rows, stages, nullptr, nullptr, nullptr, nullptr, 0, false) ||
      (ofdm::adaptive(mode) && (lane_i == nullptr || lane_f == nullptr))) {
    return cudaErrorInvalidValue;
  }
  Link L{};
  L.txr = txr;
  L.txi = txi;
  L.n = n;
  L.T = T;
  L.E = E;
  L.q = ofdm::Qam{order, m, logm, bits, gray, scale};
  L.lanes = ofdm::Lanes{lane_i, lane_f, n};
  L.key = make_uint2(key0, key1);
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
