// Fused diag-mode chunk past 256 subcarriers: one Monte-Carlo chunk of an
// ISI-free link from random words to error counters, one block a symbol,
// with nothing but the counters, the PAPR statistic and one carry row
// written to device memory.
//
// Replaces: ofdm_tpu/ops/pallas_link.py::_fn_for_spec -> kernel, in its
// conv="diag" form, at the widths the warp-per-symbol diag_main
// (link_kernel.cu, n <= 256) does not hold: ISI-free OFDM links at 257-512
// subcarriers and single-tap channels at any width the reference's diag
// budget admits (plan_for, pallas_link.py:272-300; up to 4096 here), in
// each constellation mode (a template parameter, link_common.cuh's codec).
// Per bin, the chain of link_kernel.cu: Philox words -> encode -> [x sqrt(P)]
// -> y = s*d -> AWGN with the tile's measured power -> ZF / MMSE / none ->
// [post-EQ noise] -> [x 1/sqrt(P)] -> [x the tile's unit-power factor] ->
// slicer or PSK sector -> popcount(tx ^ rx).  Every pstride-th tile also
// runs the IDFT+CP product for the PAPR max and sum, except under txext
// (from 512 subcarriers without apply_power; pallas_link.py:882-887), where
// the runner's sampled TX batch supplies the statistic.  The bracketed
// _Spec stages exist only in the build with -DOFDM_STAGED=1 (the kernel's
// kStaged parameter; link_common.cuh), the post-EQ noise and
// 1/sqrt(P) only in the one with -DOFDM_BUMP=1 as well (kBump).
//
// Bound on an H100: issue rate, not memory.  The chunk reads its constant
// rows (a few KB a row) and, on sampled tiles, the (n, T) IDFT+CP matrix
// from L2; it writes 3 counters and one row.  Each bin costs the ~250 fp32
// and integer operations of the diag chain (Philox, encode, Box-Muller,
// equalizer, slicer); a sampled symbol adds 8 n T operations of the PAPR
// product (4.2M at 512 subcarriers and CP 1.0), on 1/pstride of the tiles.
//
// Design:
//  * One block of 256 threads a symbol (lr_main's layout): thread t holds
//    bins t + 256 j (j < J <= 16).  A block walks `run` consecutive
//    symbols.  The MMSE per-symbol mean and a symbol's normalization energy
//    are block sums in a fixed order (per thread in j order, a butterfly in
//    each warp, the warps in order: link_common.cuh::block_sum), which the
//    plain version repeats (link_kernel.block_sum, link_kernel.diag_layout).
//  * Measured power: wide_power, power_partials' fixed order (16 sequential
//    steps a thread, a 256-way tree) over each tile's first `slice`
//    symbols; the main kernel sums a tile's partials in order.
//  * The in-run PAPR product: a sampled symbol's s goes to shared memory
//    (2n floats, dynamic), and the block's threads stride over the T
//    outputs, each a k-ascending sum of rounded terms (the plain version's
//    cmatmul) over the matrix read through the read-only cache: neighbouring
//    threads read neighbouring columns, and the matrix (n T complex, 4 MB at
//    512 subcarriers) streams from L2, never staged whole.
//  * normalize (staged build): the kernel runs twice around norm_factors, as
//    diag_staged does; phase 0 writes one partial a block (its run's
//    symbols' energies in order), phase 1 scales and counts.  Both passes
//    recompute the chain, the post-EQ noise at the same Philox counter.
//  * Counters: per-thread 32-bit, warp and block sums, one 64-bit atomicAdd
//    per block; the PAPR peak an atomicMax on the f32 bits, the PAPR sum a
//    double atomicAdd (its last digits depend on block order).

#include <cstdint>
#include <cuda_runtime.h>

#include "link_common.cuh"

// A named namespace, so profilers show the kernels' names.
namespace ofdm_diag_wide {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kPowerSteps = 16;  // elements per thread of wide_power
constexpr int kMinN = 257;
constexpr int kMaxN = 4096;

struct Link {
  ofdm::Equalizer eq;
  const float* fr;  // (n, T) IDFT + CP, row-major (null under txext)
  const float* fi;
  const float* chr;  // (n,) the channel multiply's rows (diag_response)
  const float* chi;
  int n;
  int T;
  ofdm::Qam q;
  float snr_lin;
  int add_noise;
  int txext;
  unsigned long long sym0;  // run index of the chunk's first symbol
  int chunk;
  int tile;
  int slice;
  int groups;
  int pstride;
  int carry_sym;  // last symbol of the chunk's last sampled tile
  int run;        // consecutive symbols a block walks
  uint2 key;
  ofdm::Lanes lanes;  // the adaptive modes' lane rows
  ofdm::Stages st;    // the _Spec stages (OFDM_STAGED builds)
};

// Partial sums of |s*d|^2 over each tile's measured-power slice (s scaled
// under apply_power), in link_kernel.cu::power_partials' order.  grid
// (tiles, groups); element e = g*4096 + j*256 + t of the tile's slice.
template <int kMode, bool kStaged>
__global__ void __launch_bounds__(kThreads) wide_power(Link L, float* partials) {
  __shared__ float red[kThreads];
  const int tile_id = blockIdx.x;
  const int g = blockIdx.y;
  const int t = threadIdx.x;
  const int b0 = tile_id * L.tile;
  const int tlen = min(L.tile, L.chunk - b0);
  const int count = min(L.slice, tlen) * L.n;
  float acc = 0.0f;
  for (int j = 0; j < kPowerSteps; ++j) {
    const int e = g * (kPowerSteps * kThreads) + j * kThreads + t;
    float p = 0.0f;
    if (e < count) {
      const int b = e / L.n;
      const int k = e - b * L.n;
      const uint4 w = ofdm::symbol_words(L.sym0 + static_cast<unsigned long long>(b0 + b), k, L.key);
      float sr, si;
      ofdm::encode<kMode>(w.x, L.q, L.lanes, k, sr, si);
      ofdm::scale_tx<kStaged>(L, k, sr, si);
      const float hr = __ldg(L.chr + k);
      const float hi = __ldg(L.chi + k);
      const float yr = sr * hr - si * hi;
      const float yi = sr * hi + si * hr;
      p = yr * yr + yi * yi;
    }
    acc = acc + p;
  }
  ofdm::store_block_sum<kThreads>(acc, red, t, partials + tile_id * L.groups + g);
}

// The chain a symbol a block; with kStaged, the stages (phase 0 of a
// normalized link writes its run's |e|^2 partial instead of counting);
// kDump is the dump stage's launch-time variant, kBump the noise-bump
// stages (the OFDM_BUMP build).
template <int J, int kMode, bool kStaged, bool kDump = false, bool kBump = false>
__global__ void __launch_bounds__(kThreads)
    diag_wide(Link L, const float* partials, unsigned long long* acc, double* psum, float* carry_r,
              float* carry_i) {
  extern __shared__ float splane[];  // 2n floats: a sampled symbol's s (in-run PAPR only)
  __shared__ float wsum[kWarps];
  const int tid = threadIdx.x;

  uint32_t be = 0, se = 0;
  float pk = 0.0f;
  double ps = 0.0;

  const int b0 = static_cast<int>(static_cast<long long>(blockIdx.x) * L.run);
  const int b1 = min(b0 + L.run, L.chunk);
  const bool counting = !kStaged || L.st.phase == 1;
  const bool normalize = kStaged && (L.st.bits & ofdm::kStageNormalize) != 0;
  int cached_tile = -1;
  float sigma = 0.0f;
  int norm_tile = -1;
  float fn = 1.0f, energy = 0.0f;
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
    const bool sampled = counting && !L.txext && (tile_id % L.pstride) == 0;
    const unsigned long long sym = L.sym0 + static_cast<unsigned long long>(b);

    float yr[J], yi[J];
    int tx[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int k = tid + kThreads * j;
      yr[j] = 0.0f;
      yi[j] = 0.0f;
      tx[j] = 0;
      if (k < L.n) {
        const uint4 w = ofdm::symbol_words(sym, k, L.key);
        float sr, si;
        tx[j] = ofdm::encode<kMode>(w.x, L.q, L.lanes, k, sr, si);
        ofdm::scale_tx<kStaged>(L, k, sr, si);
        if (sampled) {
          splane[k] = sr;
          splane[L.n + k] = si;
        }
        const float hr = __ldg(L.chr + k);
        const float hi = __ldg(L.chi + k);
        yr[j] = sr * hr - si * hi;
        yi[j] = sr * hi + si * hr;
        if (L.add_noise) ofdm::add_noise(w.y, w.z, sigma, yr[j], yi[j]);
      }
    }

    const float nv = ofdm::mmse_nv_block<J, kWarps>(L.eq, yr, yi, L.n, L.snr_lin, wsum);
    float er[J], ei[J];
    float p = 0.0f;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int k = tid + kThreads * j;
      er[j] = 0.0f;
      ei[j] = 0.0f;
      if (k < L.n) {
        ofdm::equalize_stage<kMode, kStaged>(L, k, yr[j], yi[j], nv, er[j], ei[j]);
        ofdm::bump_stages<kBump>(L, sym, k, er[j], ei[j]);
        if constexpr (kStaged) p = p + (er[j] * er[j] + ei[j] * ei[j]);
      }
    }
    if constexpr (kStaged) {
      if (normalize && !counting) {
        energy = energy + ofdm::block_sum<kWarps>(p, wsum);
        continue;
      }
    }
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int k = tid + kThreads * j;
      if (k < L.n) {
        if constexpr (kStaged) {
          if (normalize) {
            const float m = ofdm::norm_gain<kMode>(L, k, fn);
            er[j] = er[j] * m;
            ei[j] = ei[j] * m;
          }
        }
        ofdm::dump_bin<kMode, kDump>(L, b, k, er[j], ei[j]);
        ofdm::count_bin<kMode>(tx[j], er[j], ei[j], L.q, L.lanes, k, be, se);
      }
    }

    if (sampled) {
      // PAPR: x = s @ F_tx over this symbol's n (scaled) bins, T time samples.
      __syncthreads();
      for (int c = tid; c < L.T; c += kThreads) {
        float xr, xi;
        ofdm::cdot(splane, splane + L.n, L.fr, L.fi, L.n, L.T, c, xr, xi);
        const float pw = xr * xr + xi * xi;
        pk = fmaxf(pk, pw);
        ps += static_cast<double>(pw);
        if (b == L.carry_sym) {
          carry_r[c] = xr;
          carry_i[c] = xi;
        }
      }
      __syncthreads();  // splane is rewritten by the next sampled symbol
    }
  }
  if (counting && L.txext && blockIdx.x == 0) {
    // no time plane in the chunk: the carry row is zeros (no diag symbol reads it)
    for (int c = tid; c < L.T; c += kThreads) {
      carry_r[c] = 0.0f;
      carry_i[c] = 0.0f;
    }
  }
  if constexpr (kStaged) {
    if (normalize && !counting && tid == 0 && b0 < L.chunk) L.st.norm_part[blockIdx.x] = energy;
  }

  ofdm::flush_counters<kWarps>(be, se, pk, ps, acc, psum);
}

// wide_power (when noise is on) then diag_wide at J bins a thread; in the
// OFDM_STAGED build diag_wide twice around norm_factors under normalize.
template <int J, int kMode>
cudaError_t launch(const Link& L, float* partials, unsigned long long* acc, double* psum, float* cr, float* ci,
                   cudaStream_t stream) {
  constexpr bool kS = ofdm::kStagedBuild;
  constexpr bool kB = ofdm::kBumpBuild;
  auto* main_kernel = &diag_wide<J, kMode, kS, false, kB>;
#if OFDM_STAGED
  if (L.st.bits & ofdm::kStageDump) main_kernel = &diag_wide<J, kMode, kS, true, kB>;
#endif
  if (L.add_noise) {
    const int tiles = (L.chunk + L.tile - 1) / L.tile;
    wide_power<kMode, kS><<<dim3(tiles, L.groups), kThreads, 0, stream>>>(L, partials);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const size_t plane_bytes = L.txext ? 0 : sizeof(float) * 2 * L.n;  // <= 32 KB
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
cudaError_t launch_mode(const Link& L, float* partials, unsigned long long* acc, double* psum, float* cr,
                        float* ci, cudaStream_t stream) {
  const int bins = (L.n + kThreads - 1) / kThreads;  // bins a thread: 2 ... 16
  if (bins <= 2) return launch<2, kMode>(L, partials, acc, psum, cr, ci, stream);
  if (bins <= 4) return launch<4, kMode>(L, partials, acc, psum, cr, ci, stream);
  if (bins <= 8) return launch<8, kMode>(L, partials, acc, psum, cr, ci, stream);
  return launch<16, kMode>(L, partials, acc, psum, cr, ci, stream);
}

}  // namespace ofdm_diag_wide

using namespace ofdm_diag_wide;

extern "C" {

// One chunk of a diag link at 257 <= n <= 4096: wide_power (when noise is
// on) then diag_wide, all on `stream`, in constellation mode `mode`
// (link_common.cuh::Mode; lane_i / lane_f the adaptive modes' lane rows).
// The arguments are link_kernel.cu's ofdm_diag_chunk's (chr / chi, the
// channel rows, read in both builds), then txext: 1 when the runner supplies
// the PAPR statistic (fr / fi may then be null; the carry row is zeros).
// acc = [bit errors, symbol errors, PAPR peak f32 bits] (int64,
// accumulated), psum = PAPR power sum (float64, accumulated).  rows /
// stages / norm_part / norm_f / dump: the _Spec stages
// (link_common.cuh::Stages; stages must be 0 in the plain build).  Returns
// the first CUDA error of the launches, 0 if none.
int ofdm_diag_wide_chunk(const float* hr, const float* hi, const float* habs2, const float* gr,
                         const float* gi, const float* chr, const float* chi, const float* fr,
                         const float* fi, int n, int T, int mode,
                         int order, int m, int logm, int bits, int gray, float scale,
                         const int* lane_i, const float* lane_f, float slicer,
                         float snr_lin, float cg, int method, int add_noise,
                         unsigned long long sym0, int chunk, int tile, int slice, int groups,
                         int pstride, int carry_sym, int run, unsigned int key0, unsigned int key1,
                         float* partials, long long* acc, double* psum, float* carry_r,
                         float* carry_i, const float* rows, int stages, float* norm_part, float* norm_f,
                         float* dump_r, float* dump_i, int dump_rows, int txext, void* stream_ptr) {
  if (n < kMinN || n > kMaxN || T < n || chunk < 1 || tile < 1 || slice < 1 || groups < 1 || pstride < 1 ||
      run < 1 || tile % run != 0 || chr == nullptr || chi == nullptr ||
      (!txext && (fr == nullptr || fi == nullptr)) ||
      (ofdm::adaptive(mode) && (lane_i == nullptr || lane_f == nullptr)) ||
      !ofdm::stage_args_ok(rows, stages, norm_part, norm_f, dump_r, dump_i, dump_rows, ofdm::kBumpBuild)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Link L;
  L.eq = ofdm::Equalizer{hr, hi, habs2, gr, gi, slicer, cg, method};
  L.fr = fr;
  L.fi = fi;
  L.chr = chr;
  L.chi = chi;
  L.n = n;
  L.T = T;
  L.q = ofdm::Qam{order, m, logm, bits, gray, scale};
  L.snr_lin = snr_lin;
  L.add_noise = add_noise;
  L.txext = txext;
  L.sym0 = sym0;
  L.chunk = chunk;
  L.tile = tile;
  L.slice = slice;
  L.groups = groups;
  L.pstride = pstride;
  L.carry_sym = carry_sym;
  L.run = run;
  L.key = make_uint2(key0, key1);
  L.lanes = ofdm::Lanes{lane_i, lane_f, n};
  L.st = ofdm::make_stages(rows, stages, norm_part, norm_f, dump_r, dump_i, dump_rows);

  unsigned long long* a = reinterpret_cast<unsigned long long*>(acc);
  return static_cast<int>(ofdm::with_mode(mode, [&](auto md) {
    return launch_mode<decltype(md)::value>(L, partials, a, psum, carry_r, carry_i, stream);
  }));
}

const char* ofdm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
