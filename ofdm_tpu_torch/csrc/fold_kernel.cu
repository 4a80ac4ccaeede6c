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
// matrices (~70 KB of listed terms at n = 64, L1/L2 resident) and writes 3
// counters and one row.  Each symbol needs the nonzero terms of its
// products (SC-FDE's F_tx,ext only copies; CM and the IDFT are dense) at 8
// fp32 operations each (no FMA: -fmad=false), plus the per-bin Philox /
// noise / equalizer / slicer chain it shares with the diag kernel
// (link_common.cuh).
//
// Design (csrc/group_product.cuh):
//  * The TPU grid runs in order and carries the last TX row from tile to tile;
//    CUDA blocks do not.  A warp walks `run` consecutive symbols and keeps the
//    previous symbol's tail in shared memory; for its first symbol it
//    recomputes symbol b-1's tail from Philox (encode, then the listed terms
//    of the tail columns in the product's order), which is bit-equal to the
//    row a carry would hold.  Symbol 0 of the run sees zeros.  So nothing
//    depends on block order, launch geometry or chunking.
//  * A warp takes its run in groups of S symbols (group_of(J)): encode into
//    the group buffer, then each product over the whole group, lane l
//    computing column 32 j + l for the S symbols in registers, over the
//    matrix's listed terms only (the nonzero rows of each column, in
//    ascending order): each element it loads serves S symbols, and no term
//    of a zero element runs.  The group's TX indices and noise words stay in
//    registers.  Between the products the per-bin chain runs a symbol at a
//    time, lane l holding bins l + 32 j (j < J = ceil(n/32), n <= 256), so
//    the MMSE per-symbol mean is a per-lane sum plus an xor butterfly, as in
//    diag_main.  Each product output is a k-ascending sum of rounded
//    (a*f_r - c*f_i), (a*f_i + c*f_r) terms, as the plain version's cmatmul.
//  * Measured power: a first kernel (fold_power) recomputes y for each tile's
//    slice (one block per 4096 slice elements, its warps in groups as
//    fold_main), lays |y|^2 out in shared memory in element order and
//    reduces it in power_partials' fixed order (16 sequential steps a
//    thread, a 256-way tree); fold_main sums a tile's partials in order.
//    The plain version reproduces sigma bit for bit.  At tile 8192 and slice
//    1024 the pass recomputes 12.5% of the symbols.
//  * A block holds 8 warps, fewer where a link's group buffers would pass
//    the 227 KB a block may hold (group_warps).
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
//    launch, so a chunk without a carry-in runs the code it had.
//  * The carry probe (fold_probe; pallas_link.py::_probe_fn_for_spec, K3):
//    one block computes a chunk's last symbol (group_product.cuh's
//    probe_block): its threads encode the n bins into shared memory, then
//    each computes its columns of x over the chunk's listed F_tx,ext terms
//    in the chunk's order and writes the carry row x[0:T) and the tail
//    x[T:T+E) coalesced, bit-equal to the chunk's carry and to the tail a
//    following symbol reads.  Bound: one symbol's Philox and encode and
//    the nonzero TX terms (none at SC-FDE, whose TX stage copies), so
//    latency, not the card's rates: the block reads no dense matrix and
//    launches no more threads than the columns need.

#include <cstdint>
#include <cuda_runtime.h>

#include "group_product.cuh"
#include "link_common.cuh"

namespace ofdm_fold {

constexpr int kWarps = ofdm::kGroupWarps;
constexpr int kThreads = 32 * kWarps;
constexpr int kPowerSteps = 16;
constexpr int kPowerBlock = kPowerSteps * 256;  // slice elements per fold_power block
constexpr int kMaxN = 256;

struct Link {
  ofdm::Terms tx;  // the chunk's listed terms: F_tx,ext (n -> T+E)
  ofdm::Terms cm;  // conv + guard strip + DFT (T+E -> n)
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
  int slice;
  int groups;
  int run;  // consecutive symbols a warp of fold_main walks
  uint2 key;
  ofdm::Lanes lanes;  // the adaptive modes' lane rows
  ofdm::Stages st;    // the _Spec stages (OFDM_STAGED builds)
  const float* prev_r;  // (E,) tail the chunk's first symbol reads, or null
  const float* prev_i;
};

using ofdm::GroupBufs;

// Matrix elements a lane of fold's products loads ahead: one a term up to
// 64 subcarriers, where the matrices stay in L1 and the loads hit, 4 past
// them, where they stream from L2.
__host__ __device__ constexpr int ahead_of(int J) { return J <= 2 ? 1 : 4; }

// A group of S symbols up to y before noise: the TX stage (x into act, the
// tails, the PAPR stats and carry row when asked), then y = act @ CM into
// sink(c, yr, yi) for each bin c < n, then the group's last tail moves to
// slot 0 for the next group.  The group's points are in sb.
template <int S, int D, class Sink>
__device__ __forceinline__ void group_y(const Link& L, const GroupBufs& g, int cnt, int last, int lane, bool papr,
                                        float& pk, double& ps, float* carry_r, float* carry_i, Sink&& sink) {
  ofdm::tx_stage<S, D>(L, L.tx, g, cnt, last, lane, papr, pk, ps, carry_r, carry_i);
  __syncwarp();
  ofdm::group_product<S, D>(g.act, L.cm, lane, [&](int c, const float (&yr)[S], const float (&yi)[S]) {
    if (c < L.n) sink(c, yr, yi);
  });
  __syncwarp();
  ofdm::next_tail<S>(L, g, lane);
}

// Partial sums of |y|^2 (before noise) over each tile's measured-power slice,
// in power_partials' order.  grid (tiles, groups); block (tile, g) covers
// slice elements e = b*n + k in [g*4096, (g+1)*4096).
template <int J, int kMode, bool kStaged>
__global__ void __launch_bounds__(kThreads) fold_power(Link L, float* partials) {
  extern __shared__ float4 smem4[];
  constexpr int S = ofdm::group_of(J);
  float* red = reinterpret_cast<float*>(smem4);  // kPowerBlock floats, element order
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const GroupBufs g = ofdm::group_bufs(S, L.n, L.T, L.E,
                                       reinterpret_cast<float2*>(red + kPowerBlock) +
                                           warp * ofdm::group_pairs(S, L.n, L.T, L.E));
  const int tile_id = blockIdx.x;
  const int blk = blockIdx.y;
  const int b0 = tile_id * L.tile;
  const int tlen = min(L.tile, L.chunk - b0);
  const int count = min(L.slice, tlen) * L.n;
  const int e_lo = blk * kPowerBlock;
  const int e_hi = min(e_lo + kPowerBlock, count);
  for (int i = threadIdx.x; i < kPowerBlock; i += blockDim.x) red[i] = 0.0f;
  __syncthreads();
  if (e_lo < e_hi) {
    const int s_lo = e_lo / L.n;
    const int s_hi = (e_hi - 1) / L.n + 1;
    const int per = (s_hi - s_lo + nw - 1) / nw;
    const int w_lo = s_lo + warp * per;
    const int w_hi = min(w_lo + per, s_hi);
    if (w_lo < w_hi) {
      const unsigned long long base = L.sym0 + static_cast<unsigned long long>(b0);
      ofdm::group_prev_tail<S, kMode, kStaged, true>(L, L.tx, g, base + static_cast<unsigned long long>(w_lo), lane);
      float pk = 0.0f;
      double ps = 0.0;
      int tx[S][J];
      uint32_t w1[S][J], w2[S][J];
      for (int g0 = w_lo; g0 < w_hi; g0 += S) {
        const int cnt = min(S, w_hi - g0);
        ofdm::encode_group<S, J, kMode, kStaged, false>(L, base + static_cast<unsigned long long>(g0), cnt, g.sb,
                                                        lane, tx, w1, w2);
        __syncwarp();
        group_y<S, ahead_of(J)>(L, g, cnt, -1, lane, false, pk, ps, nullptr, nullptr,
                   [&](int c, const float (&yr)[S], const float (&yi)[S]) {
#pragma unroll
          for (int s = 0; s < S; ++s) {
            const int e = (g0 + s) * L.n + c;
            if (s < cnt && e >= e_lo && e < e_hi) red[e - e_lo] = yr[s] * yr[s] + yi[s] * yi[s];
          }
        });
        __syncwarp();
      }
    }
  }
  ofdm::power_partial_any(red, partials + tile_id * L.groups + blk);
}

// The chain per symbol; with kStaged, the stages (phase 0 of a normalized
// link writes its run's |e|^2 partial instead of counting).
template <int J, int kMode, bool kStaged, bool kDump = false, bool kPrev = true, bool kBump = false>
__global__ void __launch_bounds__(kThreads)
    fold_main(Link L, const float* partials, unsigned long long* acc, double* psum,
              float* carry_r, float* carry_i) {
  extern __shared__ float4 smem4[];
  constexpr int S = ofdm::group_of(J);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const GroupBufs g = ofdm::group_bufs(S, L.n, L.T, L.E,
                                       reinterpret_cast<float2*>(smem4) +
                                           warp * ofdm::group_pairs(S, L.n, L.T, L.E));

  uint32_t be = 0, se = 0;
  float pk = 0.0f;
  double ps = 0.0;

  const long long first = (static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp) * L.run;
  const bool counting = !kStaged || L.st.phase == 1;
  const bool normalize = kStaged && (L.st.bits & ofdm::kStageNormalize) != 0;
  if (first < L.chunk) {
    const int b0 = static_cast<int>(first);
    const int b1 = min(b0 + L.run, L.chunk);
    ofdm::group_prev_tail<S, kMode, kStaged, kPrev>(L, L.tx, g, L.sym0 + static_cast<unsigned long long>(b0), lane);
    int cached_tile = -1;
    float sigma = 0.0f;
    int norm_tile = -1;
    float fn = 1.0f, energy = 0.0f;
    int tx[S][J];
    uint32_t w1[S][J], w2[S][J];
    for (int g0 = b0; g0 < b1; g0 += S) {
      const int cnt = min(S, b1 - g0);
      ofdm::encode_group<S, J, kMode, kStaged, true>(L, L.sym0 + static_cast<unsigned long long>(g0), cnt, g.sb,
                                                     lane, tx, w1, w2);
      __syncwarp();
      group_y<S, ahead_of(J)>(L, g, cnt, L.chunk - 1 - g0, lane, counting, pk, ps, counting ? carry_r : nullptr,
                 counting ? carry_i : nullptr, [&](int c, const float (&yr)[S], const float (&yi)[S]) {
#pragma unroll
        for (int s = 0; s < S; ++s) g.sb[c * S + s] = make_float2(yr[s], yi[s]);
      });
      // Noise and the equalizer a symbol at a time; on SC-FDE the equalized
      // bins go back to sb for the IDFT, else the chain ends here.
#pragma unroll 1
      for (int s = 0; s < cnt; ++s) {
        const int b = g0 + s;
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
        float yr[J], yi[J];
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int k = lane + 32 * j;
          yr[j] = 0.0f;
          yi[j] = 0.0f;
          if (k < L.n) {
            const float2 v = g.sb[k * S + s];
            yr[j] = v.x;
            yi[j] = v.y;
            if (L.add_noise) ofdm::add_noise(w1[0][j], w2[0][j], sigma, yr[j], yi[j]);
          }
        }
        ofdm::shift_rows(w1);
        ofdm::shift_rows(w2);
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
#pragma unroll
          for (int j = 0; j < J; ++j) {
            const int k = lane + 32 * j;
            if (k < L.n) g.sb[k * S + s] = make_float2(er[j], ei[j]);
          }
        } else {
          ofdm::finish_symbol<J, kMode, kStaged, kDump, kBump>(L, b, lane, er, ei, tx[0], counting, normalize, fn,
                                                              energy, be, se);
          ofdm::shift_rows(tx);
        }
      }
      if (L.is_sc) {
        // SC-FDE: equalized bins -> time-domain symbols, e @ IDFT, into the
        // act rows below n (the tail rows hold the next group's tail).
        __syncwarp();
        ofdm::group_product<S, ahead_of(J)>(g.sb, L.id, lane, [&](int c, const float (&xr)[S], const float (&xi)[S]) {
          if (c < L.n) {
#pragma unroll
            for (int s = 0; s < S; ++s) g.act[c * S + s] = make_float2(xr[s], xi[s]);
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
              const float2 v = g.act[k * S + s];
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

  ofdm::flush_block(be, se, pk, ps, acc, psum);
}

// K3: symbol `sym`'s carry row x[0:T) and tail x[T:T+E) over the chunk's
// listed TX terms, one block (probe_block).
template <int kMode, bool kStaged>
__global__ void __launch_bounds__(ofdm::kProbeMaxThreads)
    fold_probe(Link L, unsigned long long sym, float* carry_r, float* carry_i, float* tail_r, float* tail_i) {
  ofdm::probe_block<kMode, kStaged>(L, L.tx, sym, carry_r, carry_i, tail_r, tail_i);
}

template <int kMode>
cudaError_t launch_probe(const Link& L, unsigned long long sym, float* cr, float* ci, float* tr, float* ti,
                         cudaStream_t stream) {
  fold_probe<kMode, ofdm::kStagedBuild><<<1, ofdm::probe_threads(L.T, L.E), 0, stream>>>(L, sym, cr, ci, tr, ti);
  return cudaGetLastError();
}

// Warps a block of fold_main and of fold_power (beside its 16 KB of |y|^2).
__host__ __device__ constexpr int main_warps(int J, int n, int T, int E) {
  return ofdm::group_warps(ofdm::group_bytes(J, n, T, E), 0);
}
__host__ __device__ constexpr int power_warps(int J, int n, int T, int E) {
  return ofdm::group_warps(ofdm::group_bytes(J, n, T, E), static_cast<int>(sizeof(float)) * kPowerBlock);
}

// The qam fold_main as the chunk launches it without a carry-in or dump.
template <int J>
auto* main_kernel_of() {
  if constexpr (ofdm::kStagedBuild) {
    return &fold_main<J, ofdm::kQam, true, false, true, ofdm::kBumpBuild>;
  } else {
    return &fold_main<J, ofdm::kQam, false, false, false>;
  }
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
  const int wb = ofdm::group_bytes(J, L.n, L.T, L.E);
  const int mw = main_warps(J, L.n, L.T, L.E);
  const int pw = power_warps(J, L.n, L.T, L.E);
  if (mw < 1 || pw < 1) return cudaErrorInvalidValue;
  const size_t main_bytes = static_cast<size_t>(mw) * wb;
  const size_t power_bytes = sizeof(float) * kPowerBlock + static_cast<size_t>(pw) * wb;
  cudaError_t err = cudaFuncSetAttribute(main_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(main_bytes));
  if (err != cudaSuccess) return err;
  if (L.add_noise) {
    err = cudaFuncSetAttribute(fold_power<J, kMode, kS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(power_bytes));
    if (err != cudaSuccess) return err;
    const int tiles = (L.chunk + L.tile - 1) / L.tile;
    fold_power<J, kMode, kS><<<dim3(tiles, L.groups), 32 * pw, power_bytes, stream>>>(L, partials);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const long long warps = (static_cast<long long>(L.chunk) + L.run - 1) / L.run;
  const int grid = static_cast<int>((warps + mw - 1) / mw);
#if OFDM_STAGED
  return ofdm::staged_passes(L.st.bits, L.st.norm_part, L.st.norm_f, L.chunk, L.tile, L.run, L.n, stream,
                             [&](int phase) {
    Link P = L;
    P.st.phase = phase;
    main_kernel<<<grid, 32 * mw, main_bytes, stream>>>(P, partials, acc, psum, cr, ci);
    return cudaGetLastError();
  });
#else
  main_kernel<<<grid, 32 * mw, main_bytes, stream>>>(L, partials, acc, psum, cr, ci);
  return cudaGetLastError();
#endif
}

// The layout of the qam kernels at (n, T, E) as the chunk launches them
// (ofdm_fold_geometry's thirteen ints).
template <int J>
cudaError_t geometry_at(int n, int T, int E, int* out) {
  const int wb = ofdm::group_bytes(J, n, T, E);
  const int mw = main_warps(J, n, T, E);
  const int pw = power_warps(J, n, T, E);
  if (mw < 1 || pw < 1) return cudaErrorInvalidValue;
  const int mbytes = mw * wb;
  const int pbytes = static_cast<int>(sizeof(float)) * kPowerBlock + pw * wb;
  auto* mk = main_kernel_of<J>();
  auto* pk = &fold_power<J, ofdm::kQam, ofdm::kStagedBuild>;
  cudaFuncAttributes ma, pa;
  cudaError_t err = cudaFuncGetAttributes(&ma, mk);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&pa, pk);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(mk, cudaFuncAttributeMaxDynamicSharedMemorySize, mbytes);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(pk, cudaFuncAttributeMaxDynamicSharedMemorySize, pbytes);
  int mblocks = 0, pblocks = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&mblocks, mk, 32 * mw, mbytes);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&pblocks, pk, 32 * pw, pbytes);
  if (err != cudaSuccess) return err;
  const int v[13] = {J, ofdm::group_of(J), mw, mbytes, ma.numRegs, static_cast<int>(ma.localSizeBytes),
                     static_cast<int>(ma.sharedSizeBytes), mblocks, pw, pbytes, pa.numRegs,
                     static_cast<int>(pa.localSizeBytes), pblocks};
  for (int i = 0; i < 13; ++i) out[i] = v[i];
  return cudaSuccess;
}

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

}  // namespace ofdm_fold

using namespace ofdm_fold;

extern "C" {

// One chunk: fold_power (when noise is on) then fold_main, both on `stream`,
// in constellation mode `mode` (link_common.cuh::Mode; lane_i / lane_f the
// adaptive modes' lane rows).  Each matrix comes as its listed terms (p, idx,
// chunks: group_product.cuh::Terms): F_tx,ext, CM and, for SC-FDE, the
// IDFT.  acc = [bit errors, symbol errors, PAPR peak f32 bits] (int64,
// accumulated), psum = PAPR power sum (float64, accumulated); carry = the
// chunk's last symbol's x[0:T).  rows / stages / norm_part / norm_f: the
// _Spec stages (link_common.cuh::Stages; 0 in the plain build).  Returns the
// first CUDA error of the launches, 0 if none.
int ofdm_fold_chunk(const float* tx_p, const int* tx_idx, int tx_chunks, const float* cm_p, const int* cm_idx,
                    int cm_chunks, const float* id_p, const int* id_idx, int id_chunks,
                    const float* hr, const float* hi,
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
  const int bin_chunks = (n + 31) / 32;
  if (n < 1 || n > kMaxN || T < n || E < 0 || E > T || chunk < 1 || tile < 1 || slice < 1 ||
      (prev_r == nullptr) != (prev_i == nullptr) || tx_p == nullptr || tx_idx == nullptr || cm_p == nullptr ||
      cm_idx == nullptr || tx_chunks != (T + E + 31) / 32 || cm_chunks != bin_chunks ||
      groups < 1 || run < 1 || tile % run != 0 ||
      (is_sc && (id_p == nullptr || id_idx == nullptr || id_chunks != bin_chunks)) ||
      (ofdm::adaptive(mode) && (lane_i == nullptr || lane_f == nullptr)) ||
      !ofdm::stage_args_ok(rows, stages, norm_part, norm_f, dump_r, dump_i, dump_rows, ofdm::kBumpBuild)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Link L{};
  L.tx = ofdm::make_terms(tx_p, tx_idx, tx_chunks);
  L.cm = ofdm::make_terms(cm_p, cm_idx, cm_chunks);
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
  L.slice = slice;
  L.groups = groups;
  L.run = run;
  L.key = make_uint2(key0, key1);
  L.st = ofdm::make_stages(rows, stages, norm_part, norm_f, dump_r, dump_i, dump_rows);
  L.prev_r = prev_r;
  L.prev_i = prev_i;

  unsigned long long* a = reinterpret_cast<unsigned long long*>(acc);
  return static_cast<int>(ofdm::with_mode(mode, [&](auto md) {
    return with_width(n, [&](auto jw) {
      return launch<decltype(jw)::value, decltype(md)::value>(L, partials, a, psum, carry_r, carry_i, stream);
    });
  }));
}

// K3, the carry probe: run symbol `sym`'s carry row x[0:T) (carry_r /
// carry_i) and tail x[T:T+E) (tail_r / tail_i), over the chunk's listed
// F_tx,ext terms (tx_p, tx_idx, tx_chunks, as ofdm_fold_chunk takes them)
// in mode `mode` (apply_power only: `rows` and the stage bits).  The chunk
// of run symbols [sym0, sym0 + chunk) returns symbol sym0 + chunk - 1's row
// as its carry.  Returns the launch's CUDA error, 0 if none.
int ofdm_fold_probe(const float* tx_p, const int* tx_idx, int tx_chunks, int n, int T, int E, int mode,
                    int order, int m, int logm, int bits, int gray, float scale, const int* lane_i,
                    const float* lane_f, unsigned long long sym, unsigned int key0, unsigned int key1,
                    const float* rows, int stages, float* carry_r, float* carry_i, float* tail_r, float* tail_i,
                    void* stream_ptr) {
  if (n < 1 || n > kMaxN || T < n || E < 0 || E > T || (stages & ~ofdm::kStagePower) ||
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
    return launch_probe<decltype(md)::value>(L, sym, carry_r, carry_i, tail_r, tail_i, stream);
  }));
}

// The layout of fold_main and fold_power at (n, T, E), the qam entry points
// of this build as a chunk without a carry-in or dump launches them, into
// out: bins a lane (J), symbols a group (S), then fold_main's warps a block,
// dynamic shared memory a block (bytes), registers, local bytes a thread,
// static shared memory and resident blocks an SM, then fold_power's warps,
// dynamic shared memory, registers, local bytes and resident blocks.
// Returns the CUDA error of a layout the card cannot give, 0 if none.
int ofdm_fold_geometry(int n, int T, int E, int* out) {
  if (n < 1 || n > kMaxN || T < n || E < 0 || E > T || out == nullptr) return cudaErrorInvalidValue;
  return static_cast<int>(with_width(n, [&](auto jw) { return geometry_at<decltype(jw)::value>(n, T, E, out); }));
}

const char* ofdm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
