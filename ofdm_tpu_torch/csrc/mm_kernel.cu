// Fused zero-prefix mm chunk of the OFDM / SC-FDE link: one Monte-Carlo chunk
// from random words to error counters.
//
// Replaces: ofdm_tpu/ops/pallas_link.py::_fn_for_spec -> kernel, in its
// conv="mm", fold=False form: zero-prefix OFDM and SC-FDE, whose conv does
// not fold into the receiver; in each constellation mode (qam, psk, aqam,
// apsk: a template parameter, link_common.cuh's codec; on SC-FDE lane t's
// order demaps time sample t).  Per OFDM symbol b:
//   Philox words -> encode s_b [x sqrt(P)]
//   x_b  = s_b @ F_tx,ext                  (n -> T+E: IDFT/identity + zero
//                                           guard, the last E columns repeated)
//   PAPR max and sum over x_b[0:T)
//   act  = [x_b[0:T) | x_{b-1}[T:T+E)]     (the previous symbol's tail)
//   y    = act @ C                         (T+E -> T: the merged conv)
//   AWGN per time sample, sigma = sqrt(mp / snr_lin / 2), mp the mean |y|^2
//   over all tile * T samples of b's tile, before noise; time sample t's
//   words from counter (b, t, 0)
//   Y    = y @ R                           (T -> n: overlap-add + DFT)
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
// Bound on an H100: issue rate, not memory.  Each symbol runs n(T+E) +
// (T+E)T + Tn (+ n^2 for SC-FDE) complex multiply-adds at 8 fp32 operations
// each (no FMA: -fmad=false), dense even where a matrix is banded (C) or
// zero (the guard columns of F_tx,ext), plus the Philox / noise chain on T
// samples and the per-bin equalizer / slicer chain it shares with the other
// chunk kernels (link_common.cuh).  The chunk's y before noise goes through
// device memory once (8 bytes a time sample each way: ~70 MB a 2^17-symbol
// chunk at T = 67, ~0.04 ms at 3.35 TB/s).
//
// Design:
//  * The measured power needs every sample of a tile before any of its
//    noise, so the chunk runs in two kernels.  mm_front: one block per 4096
//    consecutive time samples of a tile (elements e = s*T + t); its warps
//    compute the symbols that cover them (TX, PAPR, conv), write y to the
//    chunk's scratch planes and reduce |y|^2 in power_partials' fixed order
//    (16 sequential steps a thread, a 256-way tree).  A symbol that straddles
//    two blocks is computed by both; its PAPR and the carry row come from the
//    block that holds its first sample.  mm_main: a warp walks `run`
//    consecutive symbols, sums its tile's partials in order for sigma, reads
//    y back, adds the noise and runs RX, equalizer and slicer.  The plain
//    version reproduces sigma bit for bit.
//  * The previous symbol's tail: CUDA blocks do not run in order, so each warp
//    of mm_front recomputes its first symbol's predecessor tail from Philox
//    (link_common.cuh::prev_tail), bit-equal to a carried row; symbol 0 of
//    the run sees zeros.  Nothing depends on block order, launch geometry or
//    chunking.
//  * One warp per symbol, three widths: lane owns time samples t = lane + 32 j
//    (j < J = the template, T <= 32 J) and bins k = lane + 32 j < n.  The
//    noisy y goes to the warp's shared buffer before the RX product reads it;
//    the MMSE per-symbol mean is a per-lane sum plus an xor butterfly.  Each
//    product output is a ascending sum of rounded (a*m_r - c*m_i),
//    (a*m_i + c*m_r) terms, as the plain version's cmatmul.
//  * Counters: per-thread 32-bit, warp and block sums, one 64-bit atomicAdd
//    per block; PAPR peak an atomicMax on the f32 bits, PAPR sum a double
//    atomicAdd (its last digits depend on block order).
//  * normalize (staged build): mm_main runs twice around norm_factors, as
//    diag_staged does; phase 0 writes each warp's |e|^2 sum over its run of
//    symbols, phase 1 scales and counts.  mm_front runs once.
//  * Carry-in (sharded contiguous streams): given a tail, the chunk's first
//    symbol reads it in mm_front instead of recomputing its predecessor
//    (mm_main reads y and recomputes no tail).
//  * The carry probe (mm_probe; pallas_link.py::_probe_fn_for_spec, K3):
//    one warp computes a chunk's last symbol through the same symbol_tx and
//    writes its carry row x[0:T) and tail x[T:T+E).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "link_common.cuh"

namespace ofdm_mm {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kPowerSteps = 16;
constexpr int kPowerBlock = kPowerSteps * kThreads;  // time samples per mm_front block
constexpr int kMaxN = 256;
constexpr int kMaxT = 320;

struct Link {
  const float* txr;  // (n, T+E) F_tx,ext, row-major
  const float* txi;
  const float* cvr;  // (T+E, T) merged conv, row-major
  const float* cvi;
  const float* rxr;  // (T, n) overlap-add + DFT, row-major
  const float* rxi;
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
  int groups;  // mm_front blocks a tile: ceil(tile * T / 4096)
  int run;     // consecutive symbols a warp of mm_main walks
  uint2 key;
  ofdm::Lanes lanes;  // the adaptive modes' lane rows
  ofdm::Stages st;    // the _Spec stages (OFDM_STAGED builds)
  const float* prev_r;  // (E,) tail the chunk's first symbol reads, or null
  const float* prev_i;
};

// y before noise of the chunk's symbols, over each tile's time samples
// e = s*T + t (tile-local s), and the power partials in power_partials'
// order.  grid (tiles, groups); block (tile, g) covers e in
// [g*4096, (g+1)*4096).
template <int J, int kMode, bool kStaged>
__global__ void __launch_bounds__(kThreads)
    mm_front(Link L, float* y_r, float* y_i, float* partials, unsigned long long* acc, double* psum,
             float* carry_r, float* carry_i) {
  extern __shared__ float smem[];
  float* red = smem;  // kPowerBlock floats, element order
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const ofdm::WarpBufs w =
      ofdm::warp_bufs(L.n, L.T, L.E, smem + kPowerBlock + warp * ofdm::warp_floats(L.n, L.T, L.E));
  const int tile_id = blockIdx.x;
  const int g = blockIdx.y;
  const int t = threadIdx.x;
  const int b0 = tile_id * L.tile;
  const int tlen = min(L.tile, L.chunk - b0);
  const int count = tlen * L.T;
  const int e_lo = g * kPowerBlock;
  const int e_hi = min(e_lo + kPowerBlock, count);
  for (int i = t; i < kPowerBlock; i += kThreads) red[i] = 0.0f;
  __syncthreads();
  float pk = 0.0f;
  double ps = 0.0;
  if (e_lo < e_hi) {
    const int s_lo = e_lo / L.T;
    const int s_hi = (e_hi - 1) / L.T + 1;
    const int per = (s_hi - s_lo + kWarps - 1) / kWarps;
    const int w_lo = s_lo + warp * per;
    const int w_hi = min(w_lo + per, s_hi);
    if (w_lo < w_hi) {
      ofdm::prev_tail<kMode, kStaged>(L, w, L.sym0 + static_cast<unsigned long long>(b0 + w_lo), lane);
      const long long base = static_cast<long long>(b0) * L.T;
      int tx[J];
      uint32_t w1[J], w2[J];
      float yr[J], yi[J];
      for (int s = w_lo; s < w_hi; ++s) {
        const bool own = s * L.T >= e_lo;  // the block holds the symbol's first sample
        const bool last = own && b0 + s == L.chunk - 1;
        ofdm::symbol_tx<J, kMode, kStaged>(L, w, L.sym0 + static_cast<unsigned long long>(b0 + s), lane, own,
                                           pk, ps, last ? carry_r : nullptr, last ? carry_i : nullptr, tx,
                                           w1, w2);
        ofdm::row_product<J>(w.ar, w.ai, L.cvr, L.cvi, L.T + L.E, L.T, lane, yr, yi);
        ofdm::shift_tail(L, w, lane);
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int tt = lane + 32 * j;
          const int e = s * L.T + tt;
          if (tt < L.T && e >= e_lo && e < e_hi) {
            red[e - e_lo] = yr[j] * yr[j] + yi[j] * yi[j];
            y_r[base + e] = yr[j];
            y_i[base + e] = yi[j];
          }
        }
      }
    }
  }
  ofdm::power_block_partial<kThreads, kPowerSteps>(red, t, partials + tile_id * L.groups + g);
  ofdm::flush_counters<kWarps>(0u, 0u, pk, ps, acc, psum);
}

// Floats of a warp's mm_main buffers: the noisy y (T complex) and, for
// SC-FDE, the equalized bins (n complex).
__host__ __device__ __forceinline__ int main_floats(int n, int T) { return 2 * (T + n); }

// With kStaged, the stages (phase 0 of a normalized link writes its run's
// |e|^2 partial instead of counting).
template <int J, int kMode, bool kStaged, bool kDump = false, bool kBump = false>
__global__ void __launch_bounds__(kThreads)
    mm_main(Link L, const float* y_r, const float* y_i, const float* partials,
            unsigned long long* acc, double* psum) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* ybr = smem + warp * main_floats(L.n, L.T);
  float* ybi = ybr + L.T;
  float* sbr = ybi + L.T;
  float* sbi = sbr + L.n;

  uint32_t be = 0, se = 0;
  const long long first = (static_cast<long long>(blockIdx.x) * kWarps + warp) * L.run;
  const bool counting = !kStaged || L.st.phase == 1;
  const bool normalize = kStaged && (L.st.bits & ofdm::kStageNormalize) != 0;
  if (first < L.chunk) {
    const int b0 = static_cast<int>(first);
    const int b1 = min(b0 + L.run, L.chunk);
    int cached_tile = -1;
    float sigma = 0.0f;
    int norm_tile = -1;
    float fn = 1.0f, energy = 0.0f;
    for (int b = b0; b < b1; ++b) {
      const int tile_id = b / L.tile;
      if (L.add_noise && tile_id != cached_tile) {
        const int tlen = min(L.tile, L.chunk - tile_id * L.tile);
        sigma = ofdm::tile_sigma(partials + tile_id * L.groups, L.groups, tlen * L.T, L.snr_lin);
        cached_tile = tile_id;
      }
      if constexpr (kStaged) {
        if (normalize && counting && tile_id != norm_tile) {
          fn = L.st.norm_f[tile_id];
          norm_tile = tile_id;
        }
      }
      const unsigned long long sym = L.sym0 + static_cast<unsigned long long>(b);
      const long long base = static_cast<long long>(b) * L.T;
      int tx[J];
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int t = lane + 32 * j;
        tx[j] = 0;
        if (t < L.T) {
          float yr = __ldg(y_r + base + t);
          float yi = __ldg(y_i + base + t);
          if (t < L.n || L.add_noise) {
            const uint4 wd = ofdm::symbol_words(sym, t, L.key);
            if (t < L.n) tx[j] = ofdm::tx_index<kMode>(wd.x, L.q, L.lanes, t);
            if (L.add_noise) ofdm::add_noise(wd.y, wd.z, sigma, yr, yi);
          }
          ybr[t] = yr;
          ybi[t] = yi;
        }
      }
      __syncwarp();
      float fr[J], fi[J];
      ofdm::row_product<J>(ybr, ybi, L.rxr, L.rxi, L.T, L.n, lane, fr, fi);

      const float nv = ofdm::mmse_nv<J>(L.eq, fr, fi, lane, L.n, L.snr_lin);
      float er[J], ei[J];
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int k = lane + 32 * j;
        er[j] = 0.0f;
        ei[j] = 0.0f;
        if (k < L.n) ofdm::equalize_stage<kMode, kStaged>(L, k, fr[j], fi[j], nv, er[j], ei[j], L.is_sc);
      }

      if (L.is_sc) {
        // SC-FDE: equalized bins -> time-domain symbols, e @ IDFT.
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int k = lane + 32 * j;
          if (k < L.n) {
            sbr[k] = er[j];
            sbi[k] = ei[j];
          }
        }
        __syncwarp();
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int k = lane + 32 * j;
          if (k < L.n) ofdm::cdot(sbr, sbi, L.idr, L.idi, L.n, L.n, k, er[j], ei[j]);
        }
      }

      if constexpr (kBump) {
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int k = lane + 32 * j;
          if (k < L.n) ofdm::bump_stages<true>(L, sym, k, er[j], ei[j]);
        }
      }
      if constexpr (kStaged) {
        if (normalize) {
          if (!counting) {
            energy = energy + ofdm::warp_energy<J>(er, ei, lane, L.n);
          } else {
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
      }
      if (counting) {
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
      __syncwarp();  // the next symbol rewrites the buffers
    }
    if constexpr (kStaged) {
      if (normalize && !counting && lane == 0) L.st.norm_part[b0 / L.run] = energy;
    }
  }

  ofdm::flush_counters<kWarps>(be, se, 0.0f, 0.0, acc, psum);
}

// K3: symbol `sym`'s carry row x[0:T) and tail x[T:T+E) through the chunk's
// own TX stage (symbol_tx), one warp.
template <int J, int kMode, bool kStaged>
__global__ void __launch_bounds__(32)
    mm_probe(Link L, unsigned long long sym, float* carry_r, float* carry_i, float* tail_r, float* tail_i) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x;
  const ofdm::WarpBufs w = ofdm::warp_bufs(L.n, L.T, L.E, smem);
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

template <int kMode>
cudaError_t probe_mode(const Link& L, unsigned long long sym, float* cr, float* ci, float* tr, float* ti,
                       cudaStream_t stream) {
  const size_t bytes = sizeof(float) * ofdm::warp_floats(L.n, L.T, L.E);
  constexpr bool kS = ofdm::kStagedBuild;
  switch ((L.n + 31) / 32) {
    case 1: mm_probe<1, kMode, kS><<<1, 32, bytes, stream>>>(L, sym, cr, ci, tr, ti); break;
    case 2: mm_probe<2, kMode, kS><<<1, 32, bytes, stream>>>(L, sym, cr, ci, tr, ti); break;
    case 3: mm_probe<3, kMode, kS><<<1, 32, bytes, stream>>>(L, sym, cr, ci, tr, ti); break;
    case 4: mm_probe<4, kMode, kS><<<1, 32, bytes, stream>>>(L, sym, cr, ci, tr, ti); break;
    default: mm_probe<8, kMode, kS><<<1, 32, bytes, stream>>>(L, sym, cr, ci, tr, ti); break;
  }
  return cudaGetLastError();
}

__host__ __forceinline__ size_t front_bytes(int n, int T, int E) {
  return sizeof(float) * (kPowerBlock + kWarps * ofdm::warp_floats(n, T, E));
}

template <int J, int kMode>
cudaError_t launch(const Link& L, float* y_r, float* y_i, float* partials, unsigned long long* acc,
                   double* psum, float* cr, float* ci, cudaStream_t stream) {
  constexpr bool kS = ofdm::kStagedBuild;
  constexpr bool kB = ofdm::kBumpBuild;
  auto* main_kernel = &mm_main<J, kMode, kS, false, kB>;
#if OFDM_STAGED
  if (L.st.bits & ofdm::kStageDump) main_kernel = &mm_main<J, kMode, kS, true, kB>;
#endif
  const size_t fbytes = front_bytes(L.n, L.T, L.E);
  const size_t mbytes = sizeof(float) * kWarps * main_floats(L.n, L.T);
  cudaError_t err = cudaFuncSetAttribute(mm_front<J, kMode, kS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(fbytes));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(main_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(mbytes));
  if (err != cudaSuccess) return err;
  const int tiles = (L.chunk + L.tile - 1) / L.tile;
  mm_front<J, kMode, kS><<<dim3(tiles, L.groups), kThreads, fbytes, stream>>>(L, y_r, y_i, partials, acc,
                                                                               psum, cr, ci);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long warps = (static_cast<long long>(L.chunk) + L.run - 1) / L.run;
  const int grid = static_cast<int>((warps + kWarps - 1) / kWarps);
#if OFDM_STAGED
  return ofdm::staged_passes(L.st.bits, L.st.norm_part, L.st.norm_f, L.chunk, L.tile, L.run, L.n, stream,
                             [&](int phase) {
    Link P = L;
    P.st.phase = phase;
    main_kernel<<<grid, kThreads, mbytes, stream>>>(P, y_r, y_i, partials, acc, psum);
    return cudaGetLastError();
  });
#else
  main_kernel<<<grid, kThreads, mbytes, stream>>>(L, y_r, y_i, partials, acc, psum);
  return cudaGetLastError();
#endif
}

// Time samples a lane holds, rounded up to a compiled width.
template <int kMode>
cudaError_t launch_mode(const Link& L, float* y_r, float* y_i, float* partials,
                        unsigned long long* acc, double* psum, float* cr, float* ci,
                        cudaStream_t stream) {
  const int jt = (L.T + 31) / 32;
  if (jt <= 2) return launch<2, kMode>(L, y_r, y_i, partials, acc, psum, cr, ci, stream);
  if (jt == 3) return launch<3, kMode>(L, y_r, y_i, partials, acc, psum, cr, ci, stream);
  if (jt == 4) return launch<4, kMode>(L, y_r, y_i, partials, acc, psum, cr, ci, stream);
  if (jt <= 6) return launch<6, kMode>(L, y_r, y_i, partials, acc, psum, cr, ci, stream);
  if (jt <= 8) return launch<8, kMode>(L, y_r, y_i, partials, acc, psum, cr, ci, stream);
  return launch<10, kMode>(L, y_r, y_i, partials, acc, psum, cr, ci, stream);
}

}  // namespace ofdm_mm

using namespace ofdm_mm;

extern "C" {

// One chunk: mm_front then mm_main, both on `stream`, in constellation mode
// `mode` (link_common.cuh::Mode; lane_i / lane_f the adaptive modes' lane
// rows).  acc = [bit errors,
// symbol errors, PAPR peak f32 bits] (int64, accumulated), psum = PAPR power
// sum (float64, accumulated); y = scratch planes of chunk * T floats;
// carry = the chunk's last symbol's x[0:T).  rows / stages / norm_part /
// norm_f: the _Spec stages (link_common.cuh::Stages; 0 in the plain build).
// Returns the first CUDA error of the launches, 0 if none.
int ofdm_mm_chunk(const float* txr, const float* txi, const float* cvr, const float* cvi,
                  const float* rxr, const float* rxi, const float* idr, const float* idi,
                  const float* hr, const float* hi, const float* habs2, const float* gr,
                  const float* gi, int n, int T, int E, int mode, int order, int m, int logm,
                  int bits, int gray, float scale, const int* lane_i, const float* lane_f,
                  float slicer, float snr_lin, float cg, int method,
                  int add_noise, int is_sc, unsigned long long sym0, int chunk, int tile,
                  int groups, int run, unsigned int key0, unsigned int key1, float* y_r,
                  float* y_i, float* partials, long long* acc, double* psum, float* carry_r,
                  float* carry_i, const float* rows, int stages, float* norm_part, float* norm_f,
                    float* dump_r, float* dump_i, int dump_rows, const float* prev_r,
                    const float* prev_i, void* stream_ptr) {
  if (n < 1 || n > kMaxN || T < n || T > kMaxT || E < 0 || E > T || chunk < 1 || tile < 1 ||
      (prev_r == nullptr) != (prev_i == nullptr) ||
      run < 1 || tile % run != 0 || static_cast<long long>(chunk) * T > INT_MAX ||
      !ofdm::stage_args_ok(rows, stages, norm_part, norm_f, dump_r, dump_i, dump_rows, ofdm::kBumpBuild) ||
      static_cast<long long>(groups) * kPowerBlock < static_cast<long long>(tile) * T ||
      (is_sc && (idr == nullptr || idi == nullptr)) ||
      (ofdm::adaptive(mode) && (lane_i == nullptr || lane_f == nullptr))) {
    return cudaErrorInvalidValue;
  }
  if (front_bytes(n, T, E) > 227 * 1024) return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Link L;
  L.txr = txr;
  L.txi = txi;
  L.cvr = cvr;
  L.cvi = cvi;
  L.rxr = rxr;
  L.rxi = rxi;
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
  L.groups = groups;
  L.run = run;
  L.key = make_uint2(key0, key1);
  L.st = ofdm::make_stages(rows, stages, norm_part, norm_f, dump_r, dump_i, dump_rows);
  L.prev_r = prev_r;
  L.prev_i = prev_i;

  unsigned long long* a = reinterpret_cast<unsigned long long*>(acc);
  return static_cast<int>(ofdm::with_mode(mode, [&](auto md) {
    return launch_mode<decltype(md)::value>(L, y_r, y_i, partials, a, psum, carry_r, carry_i, stream);
  }));
}

// K3, the carry probe: run symbol `sym`'s carry row x[0:T) (carry_r /
// carry_i) and tail x[T:T+E) (tail_r / tail_i), through the chunk's TX
// stage in mode `mode` (apply_power only: `rows` and the stage bits).  The
// chunk of run symbols [sym0, sym0 + chunk) returns symbol sym0 + chunk -
// 1's row as its carry.  Returns the launch's CUDA error, 0 if none.
int ofdm_mm_probe(const float* txr, const float* txi, int n, int T, int E, int mode, int order, int m,
                  int logm, int bits, int gray, float scale, const int* lane_i, const float* lane_f,
                  unsigned long long sym, unsigned int key0, unsigned int key1, const float* rows,
                  int stages, float* carry_r, float* carry_i, float* tail_r, float* tail_i,
                  void* stream_ptr) {
  if (n < 1 || n > kMaxN || T < n || T > kMaxT || E < 0 || E > T || (stages & ~ofdm::kStagePower) ||
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
