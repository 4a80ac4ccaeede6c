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
// Bound on an H100: issue rate, not memory.  Each symbol needs the nonzero
// terms of its products (F_tx,ext without its zero guard, C's band of E + 1
// taps, R, the SC-FDE IDFT) at 8 fp32 operations each (no FMA:
// -fmad=false), plus the Philox / noise chain on T samples and the per-bin
// equalizer / slicer chain it shares with the other chunk kernels
// (link_common.cuh).  The chunk's y before noise goes through device memory
// (8 bytes a time sample written, read twice: ~70 MB each way a 2^17-symbol
// chunk at T = 67, ~0.02 ms at 3.35 TB/s).
//
// Design (csrc/group_product.cuh):
//  * The measured power needs every sample of a tile before any of its
//    noise, so the chunk runs in three kernels.  mm_front: a warp walks
//    `run` consecutive symbols in groups of S (group_of(J)) through TX, the
//    PAPR statistic and the conv, and writes y to the chunk's scratch
//    planes.  mm_power: one block per 4096 consecutive time samples of a
//    tile (elements e = s*T + t) reads y and reduces |y|^2 in
//    power_partials' fixed order (16 sequential steps a thread, a 256-way
//    tree).  mm_main: a warp walks `run` symbols in groups, sums its tile's
//    partials in order for sigma, reads y back, adds the noise and runs RX,
//    equalizer and slicer.  The plain version reproduces sigma bit for bit.
//  * Each product runs over a group at once, lane l computing column 32 j + l
//    for the S symbols in registers over the matrix's listed terms only:
//    each element it loads serves S symbols, C's band runs E + 1 terms a
//    column (its tail rows apart) and the zero guard none.  The per-bin
//    chain runs a symbol at a time, lane l holding bins l + 32 j (j < J =
//    ceil(n/32)), so the MMSE per-symbol mean is a per-lane sum plus an xor
//    butterfly.  Each product output is an ascending sum of rounded
//    (a*m_r - c*m_i), (a*m_i + c*m_r) terms, as the plain version's cmatmul.
//  * The previous symbol's tail: CUDA blocks do not run in order, so each warp
//    of mm_front recomputes its first symbol's predecessor tail from Philox
//    (group_prev_tail), bit-equal to a carried row; symbol 0 of the run
//    sees zeros.  Nothing depends on block order, launch geometry or
//    chunking.
//  * A block holds 8 warps, fewer where a link's group buffers would pass
//    the 227 KB a block may hold (group_warps).
//  * Counters: per-thread 32-bit, warp and block sums, one 64-bit atomicAdd
//    per block; PAPR peak an atomicMax on the f32 bits, PAPR sum a double
//    atomicAdd (its last digits depend on block order).
//  * normalize (staged build): mm_main runs twice around norm_factors, as
//    diag_staged does; phase 0 writes each warp's |e|^2 sum over its run of
//    symbols, phase 1 scales and counts.  mm_front and mm_power run once.
//  * Carry-in (sharded contiguous streams): given a tail, the chunk's first
//    symbol reads it in mm_front instead of recomputing its predecessor
//    (mm_main reads y and recomputes no tail).
//  * The carry probe (mm_probe; pallas_link.py::_probe_fn_for_spec, K3):
//    one block computes a chunk's last symbol (group_product.cuh's
//    probe_block): its threads encode the n bins into shared memory, then
//    each computes its columns of x over the chunk's listed F_tx,ext terms
//    in the chunk's order (the zero guard runs none) and writes the carry
//    row x[0:T) and the tail x[T:T+E) coalesced, bit-equal to the chunk's.
//    Bound: one symbol's Philox, encode and nonzero TX terms, so latency,
//    not the card's rates: the block reads no dense matrix.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "group_product.cuh"
#include "link_common.cuh"

namespace ofdm_mm {

constexpr int kWarps = ofdm::kGroupWarps;
constexpr int kThreads = 32 * kWarps;
constexpr int kPowerThreads = 256;
constexpr int kPowerSteps = 16;
constexpr int kPowerBlock = kPowerSteps * kPowerThreads;  // time samples per mm_power block
constexpr int kMaxN = 256;
constexpr int kMaxT = 320;

struct Link {
  ofdm::Terms tx;  // the chunk's listed terms: F_tx,ext (n -> T+E)
  ofdm::Terms cv;  // merged conv (T+E -> T)
  ofdm::Terms rx;  // overlap-add + DFT (T -> n)
  ofdm::Terms id;  // SC-FDE IDFT (n -> n; unused for OFDM)
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
  int groups;  // mm_power blocks a tile: ceil(tile * T / 4096)
  int run;     // consecutive symbols a warp of mm_front and mm_main walks
  uint2 key;
  ofdm::Lanes lanes;  // the adaptive modes' lane rows
  ofdm::Stages st;    // the _Spec stages (OFDM_STAGED builds)
  const float* prev_r;  // (E,) tail the chunk's first symbol reads, or null
  const float* prev_i;
};

using ofdm::GroupBufs;

// y before noise of the chunk's symbols into the scratch planes (chunk * T
// floats each, element b*T + t), the PAPR stats, the carry row.
template <int J, int kMode, bool kStaged>
__global__ void __launch_bounds__(kThreads)
    mm_front(Link L, float* y_r, float* y_i, unsigned long long* acc, double* psum, float* carry_r,
             float* carry_i) {
  extern __shared__ float4 smem4[];
  constexpr int S = ofdm::group_of(J);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const GroupBufs g = ofdm::group_bufs(S, L.n, L.T, L.E,
                                       reinterpret_cast<float2*>(smem4) +
                                           warp * ofdm::group_pairs(S, L.n, L.T, L.E));
  float pk = 0.0f;
  double ps = 0.0;
  const long long first = (static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp) * L.run;
  if (first < L.chunk) {
    const int b0 = static_cast<int>(first);
    const int b1 = min(b0 + L.run, L.chunk);
    ofdm::group_prev_tail<S, kMode, kStaged, true>(L, L.tx, g, L.sym0 + static_cast<unsigned long long>(b0), lane);
    int tx[S][J];
    uint32_t w1[S][J], w2[S][J];
    for (int g0 = b0; g0 < b1; g0 += S) {
      const int cnt = min(S, b1 - g0);
      ofdm::encode_group<S, J, kMode, kStaged, false>(L, L.sym0 + static_cast<unsigned long long>(g0), cnt, g.sb,
                                                      lane, tx, w1, w2);
      __syncwarp();
      ofdm::tx_stage<S, ofdm::kAhead>(L, L.tx, g, cnt, L.chunk - 1 - g0, lane, true, pk, ps, carry_r, carry_i);
      __syncwarp();
      const long long base = static_cast<long long>(g0) * L.T;
      ofdm::group_product<S>(g.act, L.cv, lane, [&](int c, const float (&yr)[S], const float (&yi)[S]) {
        if (c < L.T) {
#pragma unroll
          for (int s = 0; s < S; ++s) {
            if (s < cnt) {
              y_r[base + s * L.T + c] = yr[s];
              y_i[base + s * L.T + c] = yi[s];
            }
          }
        }
      });
      __syncwarp();
      ofdm::next_tail<S>(L, g, lane);
    }
  }
  ofdm::flush_block(0u, 0u, pk, ps, acc, psum);
}

// The power partials of each tile's time samples e = s*T + t (tile-local s)
// in power_partials' order, from y before noise.  grid (tiles, groups);
// block (tile, g) covers e in [g*4096, (g+1)*4096).
__global__ void __launch_bounds__(kPowerThreads)
    mm_power(int chunk, int tile, int T, int groups, const float* y_r, const float* y_i, float* partials) {
  __shared__ float red[kPowerThreads];
  const int t = threadIdx.x;
  const int b0 = blockIdx.x * tile;
  const int count = min(tile, chunk - b0) * T;
  const int e_lo = blockIdx.y * kPowerBlock;
  const long long base = static_cast<long long>(b0) * T;
  float acc = 0.0f;
  for (int j = 0; j < kPowerSteps; ++j) {
    const int e = e_lo + j * kPowerThreads + t;
    float v = 0.0f;
    if (e < count) {
      const float yr = y_r[base + e];
      const float yi = y_i[base + e];
      v = yr * yr + yi * yi;
    }
    acc = acc + v;
  }
  ofdm::store_block_sum<kPowerThreads>(acc, red, t, partials + blockIdx.x * groups + blockIdx.y);
}

// With kStaged, the stages (phase 0 of a normalized link writes its run's
// |e|^2 partial instead of counting).
template <int J, int kMode, bool kStaged, bool kDump = false, bool kBump = false>
__global__ void __launch_bounds__(kThreads)
    mm_main(Link L, const float* y_r, const float* y_i, const float* partials,
            unsigned long long* acc, double* psum) {
  extern __shared__ float4 smem4[];
  constexpr int S = ofdm::group_of(J);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // The noisy y of the group (T rows), then the RX outputs (n rows); the
  // SC-FDE IDFT writes into the y rows.
  float2* yb = reinterpret_cast<float2*>(smem4) + warp * ofdm::group_pairs(S, L.n, L.T, L.E);
  float2* sb = yb + S * L.T;

  uint32_t be = 0, se = 0;
  const long long first = (static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp) * L.run;
  const bool counting = !kStaged || L.st.phase == 1;
  const bool normalize = kStaged && (L.st.bits & ofdm::kStageNormalize) != 0;
  if (first < L.chunk) {
    const int b0 = static_cast<int>(first);
    const int b1 = min(b0 + L.run, L.chunk);
    int cached_tile = -1;
    float sigma = 0.0f;
    int norm_tile = -1;
    float fn = 1.0f, energy = 0.0f;
    int tx[S][J];
    for (int g0 = b0; g0 < b1; g0 += S) {
      const int cnt = min(S, b1 - g0);
      // The group's noisy y into yb (zeros from cnt on) and its TX indices
      // into the register rows (row s ends as symbol s's).
#pragma unroll 1
      for (int s = 0; s < S; ++s) {
        ofdm::shift_rows(tx);
        const int b = g0 + s;
        const bool live = s < cnt;
        if (live && L.add_noise) {
          const int tile_id = b / L.tile;
          if (tile_id != cached_tile) {
            const int tlen = min(L.tile, L.chunk - tile_id * L.tile);
            sigma = ofdm::tile_sigma(partials + tile_id * L.groups, L.groups, tlen * L.T, L.snr_lin);
            cached_tile = tile_id;
          }
        }
        const unsigned long long sym = L.sym0 + static_cast<unsigned long long>(b);
        const long long base = static_cast<long long>(b) * L.T;
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int t = lane + 32 * j;
          tx[S - 1][j] = 0;
          if (t < L.T) {
            float yr = 0.0f, yi = 0.0f;
            if (live) {
              yr = __ldg(y_r + base + t);
              yi = __ldg(y_i + base + t);
              if (t < L.n || L.add_noise) {
                const uint4 wd = ofdm::symbol_words(sym, t, L.key);
                if (t < L.n) tx[S - 1][j] = ofdm::tx_index<kMode>(wd.x, L.q, L.lanes, t);
                if (L.add_noise) ofdm::add_noise(wd.y, wd.z, sigma, yr, yi);
              }
            }
            yb[t * S + s] = make_float2(yr, yi);
          }
        }
        for (int t = 32 * J + lane; t < L.T; t += 32) {  // time samples past the bins
          float yr = 0.0f, yi = 0.0f;
          if (live) {
            yr = __ldg(y_r + base + t);
            yi = __ldg(y_i + base + t);
            if (L.add_noise) {
              const uint4 wd = ofdm::symbol_words(sym, t, L.key);
              ofdm::add_noise(wd.y, wd.z, sigma, yr, yi);
            }
          }
          yb[t * S + s] = make_float2(yr, yi);
        }
      }
      __syncwarp();
      ofdm::group_product<S>(yb, L.rx, lane, [&](int c, const float (&fr)[S], const float (&fi)[S]) {
        if (c < L.n) {
#pragma unroll
          for (int s = 0; s < S; ++s) sb[c * S + s] = make_float2(fr[s], fi[s]);
        }
      });
      __syncwarp();
      // The equalizer a symbol at a time; on SC-FDE the equalized bins go
      // back to sb for the IDFT, else the chain ends here.
#pragma unroll 1
      for (int s = 0; s < cnt; ++s) {
        const int b = g0 + s;
        if constexpr (kStaged) {
          const int tile_id = b / L.tile;
          if (normalize && counting && tile_id != norm_tile) {
            fn = L.st.norm_f[tile_id];
            norm_tile = tile_id;
          }
        }
        float fr[J], fi[J];
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int k = lane + 32 * j;
          fr[j] = 0.0f;
          fi[j] = 0.0f;
          if (k < L.n) {
            const float2 v = sb[k * S + s];
            fr[j] = v.x;
            fi[j] = v.y;
          }
        }
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
#pragma unroll
          for (int j = 0; j < J; ++j) {
            const int k = lane + 32 * j;
            if (k < L.n) sb[k * S + s] = make_float2(er[j], ei[j]);
          }
        } else {
          ofdm::finish_symbol<J, kMode, kStaged, kDump, kBump>(L, b, lane, er, ei, tx[0], counting, normalize, fn,
                                                              energy, be, se);
          ofdm::shift_rows(tx);
        }
      }
      if (L.is_sc) {
        // SC-FDE: equalized bins -> time-domain symbols, e @ IDFT.
        __syncwarp();
        ofdm::group_product<S>(sb, L.id, lane, [&](int c, const float (&xr)[S], const float (&xi)[S]) {
          if (c < L.n) {
#pragma unroll
            for (int s = 0; s < S; ++s) yb[c * S + s] = make_float2(xr[s], xi[s]);
          }
        });
        __syncwarp();
#pragma unroll 1
        for (int s = 0; s < cnt; ++s) {
          const int b = g0 + s;
          if constexpr (kStaged) {
            const int tile_id = b / L.tile;
            if (normalize && counting && tile_id != norm_tile) {
              fn = L.st.norm_f[tile_id];
              norm_tile = tile_id;
            }
          }
          float er[J], ei[J];
#pragma unroll
          for (int j = 0; j < J; ++j) {
            const int k = lane + 32 * j;
            er[j] = 0.0f;
            ei[j] = 0.0f;
            if (k < L.n) {
              const float2 v = yb[k * S + s];
              er[j] = v.x;
              ei[j] = v.y;
            }
          }
          ofdm::finish_symbol<J, kMode, kStaged, kDump, kBump>(L, b, lane, er, ei, tx[0], counting, normalize, fn,
                                                              energy, be, se);
          ofdm::shift_rows(tx);
        }
      }
      __syncwarp();  // the next group rewrites the buffers
    }
    if constexpr (kStaged) {
      if (normalize && !counting && lane == 0) L.st.norm_part[b0 / L.run] = energy;
    }
  }

  ofdm::flush_block(be, se, 0.0f, 0.0, acc, psum);
}

// K3: symbol `sym`'s carry row x[0:T) and tail x[T:T+E) over the chunk's
// listed TX terms, one block (probe_block).
template <int kMode, bool kStaged>
__global__ void __launch_bounds__(ofdm::kProbeMaxThreads)
    mm_probe(Link L, unsigned long long sym, float* carry_r, float* carry_i, float* tail_r, float* tail_i) {
  ofdm::probe_block<kMode, kStaged>(L, L.tx, sym, carry_r, carry_i, tail_r, tail_i);
}

template <int kMode>
cudaError_t probe_mode(const Link& L, unsigned long long sym, float* cr, float* ci, float* tr, float* ti,
                       cudaStream_t stream) {
  mm_probe<kMode, ofdm::kStagedBuild><<<1, ofdm::probe_threads(L.T, L.E), 0, stream>>>(L, sym, cr, ci, tr, ti);
  return cudaGetLastError();
}

// Warps a block of mm_front and mm_main.
__host__ __device__ constexpr int block_warps(int J, int n, int T, int E) {
  return ofdm::group_warps(ofdm::group_bytes(J, n, T, E), 0);
}

// The qam mm_main as the chunk launches it without a dump.
template <int J>
auto* main_kernel_of() {
  return &mm_main<J, ofdm::kQam, ofdm::kStagedBuild, false, ofdm::kBumpBuild>;
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
  const int nw = block_warps(J, L.n, L.T, L.E);
  if (nw < 1) return cudaErrorInvalidValue;
  const size_t bytes = static_cast<size_t>(nw) * ofdm::group_bytes(J, L.n, L.T, L.E);
  cudaError_t err = cudaFuncSetAttribute(mm_front<J, kMode, kS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(main_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const long long warps = (static_cast<long long>(L.chunk) + L.run - 1) / L.run;
  const int grid = static_cast<int>((warps + nw - 1) / nw);
  mm_front<J, kMode, kS><<<grid, 32 * nw, bytes, stream>>>(L, y_r, y_i, acc, psum, cr, ci);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (L.add_noise) {
    const int tiles = (L.chunk + L.tile - 1) / L.tile;
    mm_power<<<dim3(tiles, L.groups), kPowerThreads, 0, stream>>>(L.chunk, L.tile, L.T, L.groups, y_r, y_i,
                                                                   partials);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
#if OFDM_STAGED
  return ofdm::staged_passes(L.st.bits, L.st.norm_part, L.st.norm_f, L.chunk, L.tile, L.run, L.n, stream,
                             [&](int phase) {
    Link P = L;
    P.st.phase = phase;
    main_kernel<<<grid, 32 * nw, bytes, stream>>>(P, y_r, y_i, partials, acc, psum);
    return cudaGetLastError();
  });
#else
  main_kernel<<<grid, 32 * nw, bytes, stream>>>(L, y_r, y_i, partials, acc, psum);
  return cudaGetLastError();
#endif
}

// The layout of the qam kernels at (n, T, E) as the chunk launches them
// (ofdm_mm_geometry's thirteen ints).
template <int J>
cudaError_t geometry_at(int n, int T, int E, int* out) {
  const int nw = block_warps(J, n, T, E);
  if (nw < 1) return cudaErrorInvalidValue;
  const int bytes = nw * ofdm::group_bytes(J, n, T, E);
  auto* mk = main_kernel_of<J>();
  auto* fk = &mm_front<J, ofdm::kQam, ofdm::kStagedBuild>;
  cudaFuncAttributes ma, fa;
  cudaError_t err = cudaFuncGetAttributes(&ma, mk);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, fk);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(mk, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(fk, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  int mblocks = 0, fblocks = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&mblocks, mk, 32 * nw, bytes);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fblocks, fk, 32 * nw, bytes);
  if (err != cudaSuccess) return err;
  const int v[13] = {J, ofdm::group_of(J), nw, bytes, ma.numRegs, static_cast<int>(ma.localSizeBytes),
                     static_cast<int>(ma.sharedSizeBytes), mblocks, nw, bytes, fa.numRegs,
                     static_cast<int>(fa.localSizeBytes), fblocks};
  for (int i = 0; i < 13; ++i) out[i] = v[i];
  return cudaSuccess;
}

// Bins a lane, rounded up to a compiled width.
template <class F>
cudaError_t with_width(int n, F&& f) {
  const int jn = (n + 31) / 32;
  if (jn <= 2) return f(std::integral_constant<int, 2>());
  if (jn == 3) return f(std::integral_constant<int, 3>());
  if (jn == 4) return f(std::integral_constant<int, 4>());
  if (jn <= 6) return f(std::integral_constant<int, 6>());
  return f(std::integral_constant<int, 8>());
}

}  // namespace ofdm_mm

using namespace ofdm_mm;

extern "C" {

// One chunk: mm_front, mm_power (when noise is on), then mm_main, all on
// `stream`, in constellation mode `mode` (link_common.cuh::Mode; lane_i /
// lane_f the adaptive modes' lane rows).  Each matrix comes as its listed
// terms (p, idx, chunks: group_product.cuh::Terms): F_tx,ext, the merged
// conv, R and, for SC-FDE, the IDFT.  acc = [bit errors, symbol errors,
// PAPR peak f32 bits] (int64, accumulated), psum = PAPR power sum (float64,
// accumulated); y = scratch planes of chunk * T floats; carry = the chunk's
// last symbol's x[0:T).  rows / stages / norm_part / norm_f: the _Spec
// stages (link_common.cuh::Stages; 0 in the plain build).  Returns the
// first CUDA error of the launches, 0 if none.
int ofdm_mm_chunk(const float* tx_p, const int* tx_idx, int tx_chunks, const float* cv_p, const int* cv_idx,
                  int cv_chunks, const float* rx_p, const int* rx_idx, int rx_chunks, const float* id_p,
                  const int* id_idx, int id_chunks,
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
  const int bin_chunks = (n + 31) / 32;
  if (n < 1 || n > kMaxN || T < n || T > kMaxT || E < 0 || E > T || chunk < 1 || tile < 1 ||
      (prev_r == nullptr) != (prev_i == nullptr) ||
      tx_p == nullptr || tx_idx == nullptr || cv_p == nullptr || cv_idx == nullptr || rx_p == nullptr ||
      rx_idx == nullptr || tx_chunks != (T + E + 31) / 32 || cv_chunks != (T + 31) / 32 ||
      rx_chunks != bin_chunks ||
      run < 1 || tile % run != 0 || static_cast<long long>(chunk) * T > INT_MAX ||
      !ofdm::stage_args_ok(rows, stages, norm_part, norm_f, dump_r, dump_i, dump_rows, ofdm::kBumpBuild) ||
      static_cast<long long>(groups) * kPowerBlock < static_cast<long long>(tile) * T ||
      (is_sc && (id_p == nullptr || id_idx == nullptr || id_chunks != bin_chunks)) ||
      (ofdm::adaptive(mode) && (lane_i == nullptr || lane_f == nullptr))) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Link L{};
  L.tx = ofdm::make_terms(tx_p, tx_idx, tx_chunks);
  L.cv = ofdm::make_terms(cv_p, cv_idx, cv_chunks);
  L.rx = ofdm::make_terms(rx_p, rx_idx, rx_chunks);
  if (is_sc) L.id = ofdm::make_terms(id_p, id_idx, id_chunks);
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
    return with_width(n, [&](auto jw) {
      return launch<decltype(jw)::value, decltype(md)::value>(L, y_r, y_i, partials, a, psum, carry_r, carry_i,
                                                               stream);
    });
  }));
}

// K3, the carry probe: run symbol `sym`'s carry row x[0:T) (carry_r /
// carry_i) and tail x[T:T+E) (tail_r / tail_i), over the chunk's listed
// F_tx,ext terms (tx_p, tx_idx, tx_chunks, as ofdm_mm_chunk takes them) in
// mode `mode` (apply_power only: `rows` and the stage bits).  The chunk of
// run symbols [sym0, sym0 + chunk) returns symbol sym0 + chunk - 1's row as
// its carry.  Returns the launch's CUDA error, 0 if none.
int ofdm_mm_probe(const float* tx_p, const int* tx_idx, int tx_chunks, int n, int T, int E, int mode, int order,
                  int m, int logm, int bits, int gray, float scale, const int* lane_i, const float* lane_f,
                  unsigned long long sym, unsigned int key0, unsigned int key1, const float* rows,
                  int stages, float* carry_r, float* carry_i, float* tail_r, float* tail_i,
                  void* stream_ptr) {
  if (n < 1 || n > kMaxN || T < n || T > kMaxT || E < 0 || E > T || (stages & ~ofdm::kStagePower) ||
      tx_p == nullptr || tx_idx == nullptr || tx_chunks != (T + E + 31) / 32 ||
      !ofdm::stage_args_ok(rows, stages, nullptr, nullptr, nullptr, nullptr, 0, false) ||
      (ofdm::adaptive(mode) && (lane_i == nullptr || lane_f == nullptr))) {
    return cudaErrorInvalidValue;
  }
  Link L{};
  L.tx = ofdm::make_terms(tx_p, tx_idx, tx_chunks);
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

// The layout of mm_main and mm_front at (n, T, E), the qam entry points of
// this build as a chunk without a dump launches them, into out: bins a
// lane (J), symbols a group (S), then mm_main's warps a block, dynamic
// shared memory a block (bytes), registers, local bytes a thread, static
// shared memory and resident blocks an SM, then mm_front's warps, dynamic
// shared memory, registers, local bytes and resident blocks.  Returns the
// CUDA error of a layout the card cannot give, 0 if none.
int ofdm_mm_geometry(int n, int T, int E, int* out) {
  if (n < 1 || n > kMaxN || T < n || T > kMaxT || E < 0 || E > T || out == nullptr) return cudaErrorInvalidValue;
  return static_cast<int>(with_width(n, [&](auto jw) { return geometry_at<decltype(jw)::value>(n, T, E, out); }));
}

const char* ofdm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
