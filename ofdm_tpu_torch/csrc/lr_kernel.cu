// Fused lr-mode chunk of the OFDM link: one Monte-Carlo chunk from random
// words to error counters, with nothing but the counters, the PAPR
// statistic and the carry row written to device memory.
//
// Replaces: ofdm_tpu/ops/pallas_link.py::_fn_for_spec -> kernel, in its
// conv="lr" form, in each constellation mode (qam, psk, aqam, apsk: a
// template parameter, link_common.cuh's codec): OFDM links whose TX -> channel -> RX map is
// factored (ops/lowrank.py) into a diagonal D and two rank-E corrections —
// wide links with or without ISI, and zero-prefix links with their colored
// bin noise.  Per OFDM symbol b:
//   Philox words -> encode s_b [x sqrt(P)]
//   t_b  = s_b @ TailM                     (n -> E: the block's last E time samples)
//   y_b  = s_b * D + t_b @ Cr + t_{b-1} @ Cp
//   AWGN per frequency bin, sigma = sqrt(mp / snr_lin / 2), mp the mean |y|^2
//   over the first `slice` symbols of b's tile, before noise, times pw_scale;
//   a zero prefix adds the colored part sigma * g2 @ B^H (g2: r normals)
//   ZF / MMSE / none with the slicer gain 0.5/scale folded in
//   [post-EQ noise, x 1/sqrt(P)]
//   [x the tile's unit-power factor, the slicer gain deferred to it]
//   slicer or PSK sector -> popcount(tx ^ rx) into int64 counters.
// Below 512 subcarriers every pstride-th tile also runs x = s @ F_tx for the
// PAPR max and sum; from 512 (txext) the runner supplies the statistic,
// except under apply_power (the sampled batch is unscaled).  The bracketed
// _Spec stages exist only in the build with -DOFDM_STAGED=1 (the kernels'
// kStaged parameter; link_common.cuh), the post-EQ noise and
// 1/sqrt(P) only in the one with -DOFDM_BUMP=1 as well (kBump).
//
// Bound on an H100: issue rate, not memory.  The chunk reads its constant
// rows and skinny matrices (E x n each, 57 KB at n = 1024 and E = 7: L1/L2
// resident) and writes 3 counters and one row.  Each bin runs the per-bin
// chain it shares with the diag kernel (link_common.cuh: Philox, encode,
// Box-Muller, equalizer, slicer, ~250 operations) plus 8 operations a term
// of the two skinny products (E terms for t, 2E for the corrections) and,
// on a zero prefix, r terms of g2 @ B^H.
//
// Design:
//  * One block of 256 threads per symbol: thread t holds bins t + 256 j
//    (j < J, n <= 4096 so J <= 16).  Every block-wide sum — t's E outputs
//    and the MMSE mean — is per-thread partials in k order, an xor
//    butterfly in each warp and the 8 warps in order, a fixed order that the
//    plain version (link_kernel.block_sum) repeats, so counts agree exactly.
//  * The TPU grid runs in order and carries the last tail row from tile to
//    tile; CUDA blocks do not.  A block walks `run` consecutive symbols and
//    keeps the previous symbol's t in shared memory; for its first symbol it
//    recomputes t_{b-1} from Philox with the same operation order, which is
//    bit-equal to a carried row.  Run symbol 0 sees t_prev = 0.  So nothing
//    depends on block order, launch geometry or chunking.
//  * Measured power: a first kernel (lr_power) recomputes y for each tile's
//    slice (one block per 4096 slice elements) and reduces |y|^2 in
//    power_partials' fixed order; lr_main sums a tile's partials in order.
//  * The g2 draws of a zero-prefix symbol come from Philox counters
//    (b lo, b hi, j, 1), one thread each, shared through shared memory.
//  * Matrices are read through the read-only cache, (E, n) and (2E, n)
//    row-major so a warp reads consecutive words.
//  * Counters: per-thread 32-bit, warp and block sums, one 64-bit atomicAdd
//    per block; PAPR peak an atomicMax on the f32 bits, PAPR sum a double
//    atomicAdd (its last digits depend on block order).
//  * normalize (staged build): lr_main runs twice around norm_factors, as
//    diag_staged does; phase 0 writes each block's |e|^2 sum over its run of
//    symbols (each symbol's sum a block_sum), phase 1 scales and counts.
//  * Carry-in (sharded contiguous streams): given a t, the chunk's first
//    symbol reads it as t_prev instead of recomputing it, in every pass
//    that recomputes one (lr_power, both passes of lr_main).
//  * The carry probe (lr_probe; pallas_link.py::_probe_fn_for_spec, K3):
//    one block of the chunk's shape computes a chunk's last symbol's t
//    through the same encode and tail_of, and writes the (T,) carry row
//    (zeros but for the last E lanes) and t.

#include <cstdint>
#include <cuda_runtime.h>

#include "link_common.cuh"

// A named namespace, so profilers show the kernels' names.
namespace ofdm_lr {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kPowerSteps = 16;
constexpr int kPowerBlock = kPowerSteps * kThreads;  // slice elements per lr_power block
constexpr int kMaxN = 4096;
constexpr int kMaxE = 63;
constexpr int kMaxRank = 128;

struct Link {
  const float* tlr;  // (E, n) TailM transposed, row-major
  const float* tli;
  const float* ccr;  // (2E, n) [Cr; Cp], row-major
  const float* cci;
  const float* bhr;  // (rank, n) B^H (zero prefix with noise only)
  const float* bhi;
  const float* dr;  // (n,) D
  const float* di;
  const float* fr;  // (n, T) TX matrix (unused under txext)
  const float* fi;
  ofdm::Equalizer eq;
  int n;
  int T;
  int E;
  int rank;
  ofdm::Qam q;
  float snr_lin;
  float pw_scale;
  int add_noise;
  int txext;
  int pstride;
  unsigned long long sym0;  // run index of the chunk's first symbol
  int chunk;
  int tile;
  int slice;
  int groups;
  int run;  // consecutive symbols a block of lr_main walks
  uint2 key;
  ofdm::Lanes lanes;  // the adaptive modes' lane rows
  ofdm::Stages st;    // the _Spec stages (OFDM_STAGED builds)
  const float* prev_r;  // (E,) t the chunk's first symbol reads as t_prev, or null
  const float* prev_i;
};

// Block-shared scratch of both kernels.
struct Scratch {
  float wsum[kWarps * 2 * kMaxE];  // per-warp sums of t (re | im)
  float t[2][2 * kMaxE];           // this and the previous symbol's t (re | im)
  float g[2 * kMaxRank];           // g2 draws (re | im)
  float nv[kWarps];                // block_sum of the MMSE mean
};

// Symbol `sym`'s words and points for the thread's bins (scaled under
// apply_power).
template <int J, int kMode, bool kStaged>
__device__ __forceinline__ void encode(const Link& L, unsigned long long sym, int (&tx)[J],
                                       uint32_t (&w1)[J], uint32_t (&w2)[J], float (&sr)[J],
                                       float (&si)[J]) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int k = static_cast<int>(threadIdx.x) + kThreads * j;
    tx[j] = 0;
    w1[j] = 0u;
    w2[j] = 0u;
    sr[j] = 0.0f;
    si[j] = 0.0f;
    if (k < L.n) {
      const uint4 wd = ofdm::symbol_words(sym, k, L.key);
      tx[j] = ofdm::encode<kMode>(wd.x, L.q, L.lanes, k, sr[j], si[j]);
      ofdm::scale_tx<kStaged>(L, k, sr[j], si[j]);
      w1[j] = wd.y;
      w2[j] = wd.z;
    }
  }
}

// out = s @ TailM (re at [0, E), im at [E, 2E)): per-thread partials in k
// order, a warp butterfly, the warps in order.  Every thread of the block
// calls it; it leaves the block synchronized.
template <int J>
__device__ void tail_of(const Link& L, const float (&sr)[J], const float (&si)[J], Scratch& sh,
                        float* out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int E2 = 2 * L.E;
  for (int e = 0; e < L.E; ++e) {
    float pr = 0.0f, pi = 0.0f;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int k = static_cast<int>(threadIdx.x) + kThreads * j;
      if (k < L.n) {
        const float f_r = __ldg(L.tlr + e * L.n + k);
        const float f_i = __ldg(L.tli + e * L.n + k);
        pr = pr + (sr[j] * f_r - si[j] * f_i);
        pi = pi + (sr[j] * f_i + si[j] * f_r);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      pr = pr + __shfl_xor_sync(0xFFFFFFFFu, pr, off);
      pi = pi + __shfl_xor_sync(0xFFFFFFFFu, pi, off);
    }
    if (lane == 0) {
      sh.wsum[warp * E2 + e] = pr;
      sh.wsum[warp * E2 + L.E + e] = pi;
    }
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < E2) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s = s + sh.wsum[w * E2 + threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

// out = t of run symbol `sym - 1`, or zeros for the run's first symbol; the
// chunk's first symbol reads the caller's t instead when the Link carries
// one.  Leaves the block synchronized.
template <int J, int kMode, bool kStaged>
__device__ void prev_tail(const Link& L, unsigned long long sym, Scratch& sh, float* out) {
  if (L.prev_r != nullptr && sym == L.sym0) {
    const int e = static_cast<int>(threadIdx.x);
    if (e < L.E) out[e] = L.prev_r[e];
    else if (e < 2 * L.E) out[e] = L.prev_i[e - L.E];
    __syncthreads();
    return;
  }
  if (sym == 0) {
    if (static_cast<int>(threadIdx.x) < 2 * L.E) out[threadIdx.x] = 0.0f;
    __syncthreads();
    return;
  }
  int tx[J];
  uint32_t w1[J], w2[J];
  float sr[J], si[J];
  encode<J, kMode, kStaged>(L, sym - 1, tx, w1, w2, sr, si);
  tail_of<J>(L, sr, si, sh, out);
}

// y before noise: s * D + [t | tp] @ [Cr; Cp], the stacked product's rows in
// order (t's, then tp's).
template <int J>
__device__ __forceinline__ void symbol_y(const Link& L, const float (&sr)[J], const float (&si)[J],
                                         const float* t, const float* tp, float (&yr)[J],
                                         float (&yi)[J]) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int k = static_cast<int>(threadIdx.x) + kThreads * j;
    yr[j] = 0.0f;
    yi[j] = 0.0f;
    if (k < L.n) {
      float cr = 0.0f, ci = 0.0f;
      for (int e = 0; e < L.E; ++e) {
        const float a = t[e];
        const float c = t[L.E + e];
        const float m_r = __ldg(L.ccr + e * L.n + k);
        const float m_i = __ldg(L.cci + e * L.n + k);
        cr = cr + (a * m_r - c * m_i);
        ci = ci + (a * m_i + c * m_r);
      }
      for (int e = 0; e < L.E; ++e) {
        const float a = tp[e];
        const float c = tp[L.E + e];
        const float m_r = __ldg(L.ccr + (L.E + e) * L.n + k);
        const float m_i = __ldg(L.cci + (L.E + e) * L.n + k);
        cr = cr + (a * m_r - c * m_i);
        ci = ci + (a * m_i + c * m_r);
      }
      const float d_r = __ldg(L.dr + k);
      const float d_i = __ldg(L.di + k);
      yr[j] = (sr[j] * d_r - si[j] * d_i) + cr;
      yi[j] = (sr[j] * d_i + si[j] * d_r) + ci;
    }
  }
}

// Partial sums of |y|^2 (before noise) over each tile's measured-power slice,
// in power_partials' order.  grid (tiles, groups); block (tile, g) covers
// slice elements e = b*n + k in [g*4096, (g+1)*4096).
template <int J, int kMode, bool kStaged>
__global__ void __launch_bounds__(kThreads) lr_power(Link L, float* partials) {
  __shared__ float red[kPowerBlock];  // element order
  __shared__ Scratch sh;
  const int tid = threadIdx.x;
  const int tile_id = blockIdx.x;
  const int g = blockIdx.y;
  const int b0 = tile_id * L.tile;
  const int tlen = min(L.tile, L.chunk - b0);
  const int count = min(L.slice, tlen) * L.n;
  const int e_lo = g * kPowerBlock;
  const int e_hi = min(e_lo + kPowerBlock, count);
  for (int i = tid; i < kPowerBlock; i += kThreads) red[i] = 0.0f;
  __syncthreads();
  if (e_lo < e_hi) {
    const int s_lo = e_lo / L.n;
    const int s_hi = (e_hi - 1) / L.n + 1;
    prev_tail<J, kMode, kStaged>(L, L.sym0 + static_cast<unsigned long long>(b0 + s_lo), sh, sh.t[0]);
    int cur = 0;
    for (int s = s_lo; s < s_hi; ++s) {
      int tx[J];
      uint32_t w1[J], w2[J];
      float sr[J], si[J], yr[J], yi[J];
      encode<J, kMode, kStaged>(L, L.sym0 + static_cast<unsigned long long>(b0 + s), tx, w1, w2, sr, si);
      tail_of<J>(L, sr, si, sh, sh.t[cur ^ 1]);
      symbol_y<J>(L, sr, si, sh.t[cur ^ 1], sh.t[cur], yr, yi);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int k = tid + kThreads * j;
        const int e = s * L.n + k;
        if (k < L.n && e >= e_lo && e < e_hi) red[e - e_lo] = yr[j] * yr[j] + yi[j] * yi[j];
      }
      cur ^= 1;
    }
  }
  ofdm::power_block_partial<kThreads, kPowerSteps>(red, tid, partials + tile_id * L.groups + g);
}

// With kStaged, the stages (phase 0 of a normalized link writes its run's
// |e|^2 partial instead of counting); kDump is the dump stage's
// launch-time variant, kBump the noise-bump stages (the OFDM_BUMP build).
template <int J, int kMode, bool kStaged, bool kDump = false, bool kBump = false>
__global__ void __launch_bounds__(kThreads)
    lr_main(Link L, const float* partials, unsigned long long* acc, double* psum, float* carry_r,
            float* carry_i) {
  extern __shared__ float splane[];  // 2n floats: a sampled symbol's s (in-kernel PAPR only)
  __shared__ Scratch sh;
  const int tid = threadIdx.x;

  uint32_t be = 0, se = 0;
  float pk = 0.0f;
  double ps = 0.0;

  const int b0 = static_cast<int>(static_cast<long long>(blockIdx.x) * L.run);
  const int b1 = min(b0 + L.run, L.chunk);
  const bool counting = !kStaged || L.st.phase == 1;
  const bool normalize = kStaged && (L.st.bits & ofdm::kStageNormalize) != 0;
  prev_tail<J, kMode, kStaged>(L, L.sym0 + static_cast<unsigned long long>(b0), sh, sh.t[0]);
  int cur = 0;
  int cached_tile = -1;
  float sigma = 0.0f;
  int norm_tile = -1;
  float fn = 1.0f, energy = 0.0f;
  for (int b = b0; b < b1; ++b) {
    const int tile_id = b / L.tile;
    if (L.add_noise && tile_id != cached_tile) {
      const int tlen = min(L.tile, L.chunk - tile_id * L.tile);
      sigma = ofdm::tile_sigma(partials + tile_id * L.groups, L.groups, min(L.slice, tlen) * L.n,
                               L.snr_lin, L.pw_scale);
      cached_tile = tile_id;
    }
    if constexpr (kStaged) {
      if (normalize && counting && tile_id != norm_tile) {
        fn = L.st.norm_f[tile_id];
        norm_tile = tile_id;
      }
    }
    const unsigned long long sym = L.sym0 + static_cast<unsigned long long>(b);
    int tx[J];
    uint32_t w1[J], w2[J];
    float sr[J], si[J];
    encode<J, kMode, kStaged>(L, sym, tx, w1, w2, sr, si);
    float* t = sh.t[cur ^ 1];
    const float* tp = sh.t[cur];
    tail_of<J>(L, sr, si, sh, t);

    if (counting && !L.txext && tile_id % L.pstride == 0) {
      // PAPR: x = s @ F_tx over this symbol's n bins, T time samples.
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int k = tid + kThreads * j;
        if (k < L.n) {
          splane[k] = sr[j];
          splane[L.n + k] = si[j];
        }
      }
      __syncthreads();
      for (int c = tid; c < L.T; c += kThreads) {
        float xr = 0.0f, xi = 0.0f;
        for (int k = 0; k < L.n; ++k) {
          const float a = splane[k];
          const float cc = splane[L.n + k];
          const float f_r = __ldg(L.fr + k * L.T + c);
          const float f_i = __ldg(L.fi + k * L.T + c);
          xr = xr + (a * f_r - cc * f_i);
          xi = xi + (a * f_i + cc * f_r);
        }
        const float pw = xr * xr + xi * xi;
        pk = fmaxf(pk, pw);
        ps += static_cast<double>(pw);
      }
      __syncthreads();
    }

    float yr[J], yi[J];
    symbol_y<J>(L, sr, si, t, tp, yr, yi);
    if (L.add_noise) {
      if (L.rank > 0) {
        // colored part: g2 @ B^H, g2 from counters (b lo, b hi, j, 1)
        if (tid < L.rank) {
          const uint4 wd = ofdm::philox4x32_10(
              make_uint4(static_cast<uint32_t>(sym), static_cast<uint32_t>(sym >> 32),
                         static_cast<uint32_t>(tid), 1u),
              L.key);
          ofdm::box_muller(wd.y, wd.z, sh.g[tid], sh.g[L.rank + tid]);
        }
        __syncthreads();
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int k = tid + kThreads * j;
          if (k < L.n) {
            float cr = 0.0f, ci = 0.0f;
            for (int i = 0; i < L.rank; ++i) {
              const float a = sh.g[i];
              const float c = sh.g[L.rank + i];
              const float m_r = __ldg(L.bhr + i * L.n + k);
              const float m_i = __ldg(L.bhi + i * L.n + k);
              cr = cr + (a * m_r - c * m_i);
              ci = ci + (a * m_i + c * m_r);
            }
            ofdm::add_noise(w1[j], w2[j], cr, ci, sigma, yr[j], yi[j]);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < J; ++j) {
          if (tid + kThreads * j < L.n) ofdm::add_noise(w1[j], w2[j], sigma, yr[j], yi[j]);
        }
      }
    }

    const float nv = ofdm::mmse_nv_block<J, kWarps>(L.eq, yr, yi, L.n, L.snr_lin, sh.nv);
    if constexpr (kStaged) {
      float er[J], ei[J];
      float p = 0.0f;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int k = tid + kThreads * j;
        er[j] = 0.0f;
        ei[j] = 0.0f;
        if (k < L.n) {
          ofdm::equalize_stage<kMode, true>(L, k, yr[j], yi[j], nv, er[j], ei[j]);
          ofdm::bump_stages<kBump>(L, sym, k, er[j], ei[j]);
          p = p + (er[j] * er[j] + ei[j] * ei[j]);
        }
      }
      if (normalize && !counting) {
        energy = energy + ofdm::block_sum<kWarps>(p, sh.nv);
      } else {
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int k = tid + kThreads * j;
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
      }
    } else {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int k = tid + kThreads * j;
        if (k < L.n) {
          float er, ei;
          ofdm::equalize_bin<kMode>(L.eq, L.lanes, k, yr[j], yi[j], nv, er, ei);
          ofdm::count_bin<kMode>(tx[j], er, ei, L.q, L.lanes, k, be, se);
        }
      }
    }

    if (counting && b == L.chunk - 1) {
      // the JAX carry contract: (T,) zero but for the last E lanes, this t
      const int off = L.T - L.E;
      for (int c = tid; c < L.T; c += kThreads) {
        carry_r[c] = c >= off ? t[c - off] : 0.0f;
        carry_i[c] = c >= off ? t[L.E + c - off] : 0.0f;
      }
    }
    cur ^= 1;
    __syncthreads();  // t, tp and g are rewritten by the next symbol
  }
  if constexpr (kStaged) {
    if (normalize && !counting && tid == 0 && b0 < L.chunk) L.st.norm_part[blockIdx.x] = energy;
  }

  ofdm::flush_counters<kWarps>(be, se, pk, ps, acc, psum);
}

// K3: symbol `sym`'s t through the chunk's own encode and tail_of, one block
// of the chunk's shape (so the block sums run in lr_main's order): the (T,)
// carry row, zeros but for the last E lanes, and t.
template <int J, int kMode, bool kStaged>
__global__ void __launch_bounds__(kThreads)
    lr_probe(Link L, unsigned long long sym, float* carry_r, float* carry_i, float* tail_r, float* tail_i) {
  __shared__ Scratch sh;
  const int tid = threadIdx.x;
  int tx[J];
  uint32_t w1[J], w2[J];
  float sr[J], si[J];
  encode<J, kMode, kStaged>(L, sym, tx, w1, w2, sr, si);
  float* t = sh.t[0];
  tail_of<J>(L, sr, si, sh, t);
  const int off = L.T - L.E;
  for (int c = tid; c < L.T; c += kThreads) {
    carry_r[c] = c >= off ? t[c - off] : 0.0f;
    carry_i[c] = c >= off ? t[L.E + c - off] : 0.0f;
  }
  if (tid < L.E) {
    tail_r[tid] = t[tid];
    tail_i[tid] = t[L.E + tid];
  }
}

template <int kMode>
cudaError_t probe_mode(const Link& L, unsigned long long sym, float* cr, float* ci, float* tr, float* ti,
                       cudaStream_t stream) {
  constexpr bool kS = ofdm::kStagedBuild;
  const int bins = (L.n + kThreads - 1) / kThreads;
  if (bins <= 1) lr_probe<1, kMode, kS><<<1, kThreads, 0, stream>>>(L, sym, cr, ci, tr, ti);
  else if (bins <= 2) lr_probe<2, kMode, kS><<<1, kThreads, 0, stream>>>(L, sym, cr, ci, tr, ti);
  else if (bins <= 4) lr_probe<4, kMode, kS><<<1, kThreads, 0, stream>>>(L, sym, cr, ci, tr, ti);
  else if (bins <= 8) lr_probe<8, kMode, kS><<<1, kThreads, 0, stream>>>(L, sym, cr, ci, tr, ti);
  else lr_probe<16, kMode, kS><<<1, kThreads, 0, stream>>>(L, sym, cr, ci, tr, ti);
  return cudaGetLastError();
}

template <int J, int kMode>
cudaError_t launch(const Link& L, float* partials, unsigned long long* acc, double* psum,
                   float* cr, float* ci, cudaStream_t stream) {
  constexpr bool kS = ofdm::kStagedBuild;
  constexpr bool kB = ofdm::kBumpBuild;
  auto* main_kernel = &lr_main<J, kMode, kS, false, kB>;
#if OFDM_STAGED
  if (L.st.bits & ofdm::kStageDump) main_kernel = &lr_main<J, kMode, kS, true, kB>;
#endif
  if (L.add_noise) {
    const int tiles = (L.chunk + L.tile - 1) / L.tile;
    lr_power<J, kMode, kS><<<dim3(tiles, L.groups), kThreads, 0, stream>>>(L, partials);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const size_t plane_bytes = L.txext ? 0 : sizeof(float) * 2 * L.n;
  if (plane_bytes > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        main_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(plane_bytes));
    if (err != cudaSuccess) return err;
  }
  const int grid = (L.chunk + L.run - 1) / L.run;
#if OFDM_STAGED
  return ofdm::staged_passes(L.st.bits, L.st.norm_part, L.st.norm_f, L.chunk, L.tile, L.run, L.n, stream,
                             [&](int phase) {
    Link P = L;
    P.st.phase = phase;
    main_kernel<<<grid, kThreads, plane_bytes, stream>>>(P, partials, acc, psum, cr, ci);
    return cudaGetLastError();
  });
#else
  main_kernel<<<grid, kThreads, plane_bytes, stream>>>(L, partials, acc, psum, cr, ci);
  return cudaGetLastError();
#endif
}

template <int kMode>
cudaError_t launch_mode(const Link& L, float* partials, unsigned long long* acc, double* psum,
                        float* cr, float* ci, cudaStream_t stream) {
  const int bins = (L.n + kThreads - 1) / kThreads;  // bins a thread: 1 ... 16
  if (bins <= 1) return launch<1, kMode>(L, partials, acc, psum, cr, ci, stream);
  if (bins <= 2) return launch<2, kMode>(L, partials, acc, psum, cr, ci, stream);
  if (bins <= 4) return launch<4, kMode>(L, partials, acc, psum, cr, ci, stream);
  if (bins <= 8) return launch<8, kMode>(L, partials, acc, psum, cr, ci, stream);
  return launch<16, kMode>(L, partials, acc, psum, cr, ci, stream);
}

}  // namespace ofdm_lr

using namespace ofdm_lr;

extern "C" {

// One chunk: lr_power (when noise is on) then lr_main, both on `stream`, in
// constellation mode `mode` (link_common.cuh::Mode; lane_i / lane_f the
// adaptive modes' lane rows).  acc = [bit errors, symbol errors, PAPR peak f32 bits] (int64, accumulated),
// psum = PAPR power sum (float64, accumulated); carry = (T,) zeros but for the
// last E lanes, the chunk's last symbol's t.  rows / stages / norm_part /
// norm_f: the _Spec stages (link_common.cuh::Stages; 0 in the plain build).
// Returns the first CUDA error of the launches, 0 if none.
int ofdm_lr_chunk(const float* tlr, const float* tli, const float* ccr, const float* cci,
                  const float* bhr, const float* bhi, const float* dr, const float* di,
                  const float* fr, const float* fi, const float* hr, const float* hi,
                  const float* habs2, const float* gr, const float* gi, int n, int T, int E,
                  int rank, int mode, int order, int m, int logm, int bits, int gray, float scale,
                  const int* lane_i, const float* lane_f, float slicer, float snr_lin, float cg, float pw_scale, int method, int add_noise,
                  int txext, int pstride, unsigned long long sym0, int chunk, int tile, int slice,
                  int groups, int run, unsigned int key0, unsigned int key1, float* partials,
                  long long* acc, double* psum, float* carry_r, float* carry_i, const float* rows,
                  int stages, float* norm_part, float* norm_f,
                    float* dump_r, float* dump_i, int dump_rows, const float* prev_r,
                    const float* prev_i, void* stream_ptr) {
  if (n < 1 || n > kMaxN || T < n || E < 1 || E > kMaxE || E > T || rank < 0 ||
      (prev_r == nullptr) != (prev_i == nullptr) ||
      rank > kMaxRank || chunk < 1 || tile < 1 || slice < 1 || groups < 1 || run < 1 ||
      tile % run != 0 ||
      !ofdm::stage_args_ok(rows, stages, norm_part, norm_f, dump_r, dump_i, dump_rows, ofdm::kBumpBuild) ||
      pstride < 1 || (!txext && (fr == nullptr || fi == nullptr)) ||
      (add_noise && rank > 0 && (bhr == nullptr || bhi == nullptr)) ||
      (ofdm::adaptive(mode) && (lane_i == nullptr || lane_f == nullptr))) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Link L;
  L.tlr = tlr;
  L.tli = tli;
  L.ccr = ccr;
  L.cci = cci;
  L.bhr = bhr;
  L.bhi = bhi;
  L.dr = dr;
  L.di = di;
  L.fr = fr;
  L.fi = fi;
  L.eq = ofdm::Equalizer{hr, hi, habs2, gr, gi, slicer, cg, method};
  L.n = n;
  L.T = T;
  L.E = E;
  L.rank = add_noise ? rank : 0;
  L.q = ofdm::Qam{order, m, logm, bits, gray, scale};
  L.lanes = ofdm::Lanes{lane_i, lane_f, n};
  L.snr_lin = snr_lin;
  L.pw_scale = pw_scale;
  L.add_noise = add_noise;
  L.txext = txext;
  L.pstride = pstride;
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

// K3, the carry probe: run symbol `sym`'s (T,) carry row (carry_r /
// carry_i: zeros but for the last E lanes, its t) and t (tail_r / tail_i,
// E each), through the chunk's encode and tail_of in mode `mode`
// (apply_power only: `rows` and the stage bits).  The chunk of run symbols
// [sym0, sym0 + chunk) returns symbol sym0 + chunk - 1's row as its carry.
// Returns the launch's CUDA error, 0 if none.
int ofdm_lr_probe(const float* tlr, const float* tli, int n, int T, int E, int mode, int order, int m,
                  int logm, int bits, int gray, float scale, const int* lane_i, const float* lane_f,
                  unsigned long long sym, unsigned int key0, unsigned int key1, const float* rows,
                  int stages, float* carry_r, float* carry_i, float* tail_r, float* tail_i,
                  void* stream_ptr) {
  if (n < 1 || n > kMaxN || T < n || E < 1 || E > kMaxE || E > T || (stages & ~ofdm::kStagePower) ||
      !ofdm::stage_args_ok(rows, stages, nullptr, nullptr, nullptr, nullptr, 0, false) ||
      (ofdm::adaptive(mode) && (lane_i == nullptr || lane_f == nullptr))) {
    return cudaErrorInvalidValue;
  }
  Link L{};
  L.tlr = tlr;
  L.tli = tli;
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
