// Fused diag-mode chunk past 256 subcarriers: one Monte-Carlo chunk of an
// ISI-free link from random words to error counters, one block a symbol,
// with nothing but the counters, the PAPR statistic and one carry row
// written to device memory.
//
// Replaces: ofdm_tpu/ops/pallas_link.py::_fn_for_spec -> kernel, in its
// conv="diag" form, at the widths the warp-per-symbol diag_main
// (link_kernel.cu, n <= 256) does not hold: ISI-free OFDM links at 257-512
// subcarriers and single-tap channels at any width the reference's diag
// budget admits (plan_for, pallas_link.py:272-300; up to 32768 here: the
// 8K, 16K and 32K FFT modes of DVB-T2 and ATSC 3.0 under txext), in
// each constellation mode (a template parameter, link_common.cuh's codec).
// Per bin, the chain of link_kernel.cu: Philox words -> encode -> [x sqrt(P)]
// -> y = s*d -> AWGN with the tile's measured power -> ZF / MMSE / none ->
// [post-EQ noise] -> [x 1/sqrt(P)] -> [x the tile's unit-power factor] ->
// slicer or PSK sector -> popcount(tx ^ rx).  Every pstride-th tile also
// runs the block IDFT (block_dft.cuh) for the PAPR max and sum, except under txext
// (from 512 subcarriers without apply_power; pallas_link.py:882-887), where
// the runner's sampled TX batch supplies the statistic.  The bracketed
// _Spec stages exist only in the build with -DOFDM_STAGED=1 (the kernel's
// kStaged parameter; link_common.cuh), the post-EQ noise and
// 1/sqrt(P) only in the one with -DOFDM_BUMP=1 as well (kBump).
//
// Bound on an H100: issue rate, not memory.  The chunk reads its constant
// rows (a few KB a row) and the IDFT's twiddles; it writes 3 counters and
// one row (a normalized chunk adds its scratch plane, 10 bytes a bin
// written and read once).  Each bin costs the ~250 fp32 and integer
// operations of the diag chain (Philox, encode, Box-Muller, equalizer,
// slicer); a sampled symbol adds the n-point block IDFT ((n/2) log2 n
// butterflies, 23K operations at 512 subcarriers; the dense (n, T) product
// it replaced took 4.2M), on 1/pstride of the tiles.
//
// Design:
//  * One block of 256 threads a symbol (lr_main's layout): thread t holds
//    bins t + 256 j (j < J <= 16).  A block walks `run` consecutive
//    symbols.  The MMSE per-symbol mean and a symbol's normalization energy
//    are block sums in a fixed order (per thread in j order, a butterfly in
//    each warp, the warps in order: link_common.cuh::block_sum), which the
//    plain version repeats (link_kernel.block_sum, link_kernel.diag_layout).
//    Past 4096 subcarriers (txext only: no in-run transform) a symbol is
//    held by a thread-block cluster of C = ceil(n / 4096) blocks (up to 8,
//    the portable cluster size), block r holding the 4096-bin slice from
//    r x 4096 in the same layout; each block's slice sum goes to its shared
//    memory and every block adds the C of them in rank order through
//    distributed shared memory (link_common.cuh::cluster_totals), the order
//    of block_sum's slice.  The cluster steps are a template variant
//    (kCluster, at 16 bins a thread only): the kernels of up to 4096
//    subcarriers hold no cluster code.
//  * Measured power: wide_power, power_partials' fixed order (16 sequential
//    steps a thread, a 256-way tree) over each tile's first `slice`
//    symbols; the main kernel sums a tile's partials in order.
//  * The in-run PAPR: a sampled symbol's s goes to shared memory at its
//    dft_slot, the block's threads run block_dft.cuh's inverse transform
//    (the plan of ops/dft.py::dft_plan, any n), and x = scale * the result.
//    The cyclic prefix repeats the last L = T - n samples, so sample m >= n
//    - L enters the PAPR sum twice and both places of the carry row; the
//    peak and the carry row are those of the whole time block.  The plain
//    version (link_kernel.wide_tx) runs the same transform in the same
//    order, so the two agree bit for bit.  A sampled symbol costs about a
//    fifth more than another, so the blocks that walk sampled tiles set no
//    tail of their own.
//  * normalize (staged build; diag_common.cuh): the front variant runs the
//    chain once, writes e and the TX index of each bin to the scratch and
//    one |e|^2 partial a block (its run's symbols' energies in order),
//    norm_factors reduces a tile's partials, diag_demap scales and counts.
//  * Counters: per-thread 32-bit, warp and block sums, one 64-bit atomicAdd
//    per block; the PAPR peak an atomicMax on the f32 bits, the PAPR sum a
//    double atomicAdd (its last digits depend on block order).

#include <cstdint>
#include <cuda_runtime.h>

#include "block_dft.cuh"
#include "diag_common.cuh"
#include "link_common.cuh"

// A named namespace, so profilers show the kernels' names.
namespace ofdm_diag_wide {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kPowerSteps = 16;  // elements per thread of wide_power
constexpr int kMinN = 257;
constexpr int kSliceBins = 4096;  // bins a block holds (16 a thread)
constexpr int kMaxN = 8 * kSliceBins;  // a cluster of at most 8 blocks a symbol

// Blocks a symbol: 1 up to 4096 bins, else a cluster of ceil(n / 4096).
__host__ __device__ constexpr int cluster_of(int n) { return (n + kSliceBins - 1) / kSliceBins; }

struct Link {
  ofdm::Equalizer eq;
  ofdm::DftPlan plan;  // the n-point IDFT of the in-run PAPR (twiddles null under txext)
  const float* chr;    // (n,) the channel multiply's rows (diag_response)
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
  int C;          // blocks a symbol (cluster_of(n))
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

// Blocks an SM the plain build's diag_wide keeps to at J bins a thread:
// 40, 48, 128 and 80 registers at 2, 4, 8 and 16 bins, the layout before
// the in-run transform, whose code would take 48, 122, 184 and 117 (the
// txext variant at 8 and 16; port_ab.py's OFDM-CY1.0-512 and
// flat_fading_cp_{1024,2048,4096}sc cells).
__host__ __device__ constexpr int plain_blocks(int J) { return J <= 2 ? 6 : J <= 4 ? 5 : J <= 8 ? 2 : 3; }

// Shared floats of the in-run PAPR's block IDFT: (ar, ai), and the split's
// (br, bi) where n is not a power of two.
__host__ __device__ __forceinline__ int plane_floats(const ofdm::DftPlan& p) {
  return (p.log2n >= 0 ? 2 : 4) * p.n;
}

// The PAPR statistic of a sampled symbol whose s the block stored at its
// dft_slot in (ar, ai): the block IDFT, x = scale * the result, IDFT
// sample m the block's time sample T - n + m (papr_sample).  Every thread
// of the block calls it; it ends with __syncthreads, so the plane may be
// rewritten.
__device__ __forceinline__ void papr_idft(const Link& L, float* plane, bool carry, float& pk, double& ps,
                                          float* carry_r, float* carry_i) {
  const int n = L.n;
  float* ar = plane;
  float* ai = plane + n;
  ofdm::block_dft<kThreads>(L.plan, ar, ai, plane + 2 * n, plane + 3 * n, true);
  for (int m = threadIdx.x; m < n; m += kThreads) {
    ofdm::papr_sample(n, L.T - n + m, ar[m] * L.plan.scale, ai[m] * L.plan.scale, carry, pk, ps, carry_r, carry_i);
  }
  __syncthreads();
}

// A symbol's sum of one value a thread: block_sum, and with kCluster the
// cluster's blocks' sums in rank order (cpart: two floats of shared
// memory).  Every thread of the block (of the cluster) must call it.
template <bool kCluster>
__device__ __forceinline__ float symbol_sum(const Link& L, float v, float* wsum, float* cpart) {
  const float s = ofdm::block_sum<kWarps>(v, wsum);
  if constexpr (kCluster) {
    if (threadIdx.x == 0) cpart[0] = s;
    ofdm::cluster_totals(cpart, cpart + 1, 1, L.C);
    return cpart[1];
  } else {
    return s;
  }
}

// The chain over chunk symbols [b_lo, b_hi), a symbol a block (a cluster
// of C blocks past 4096 bins, one slice each), each block walking `run`
// consecutive symbols; with kStaged, the stages; kDump is the dump stage's
// launch-time variant, kBump the noise-bump stages (the
// OFDM_BUMP build).  The counting variant counts; the front variant of a
// normalized chunk (kFront) writes e and the TX index of each bin to the
// slab's scratch and its run's |e|^2 partial instead.  kTxext, the plain
// build's launch-time variant for a txext chunk, holds no in-run time
// block; kCluster, a symbol a cluster of L.C blocks.  The plain build's
// chain keeps to plain_blocks(J) blocks an SM.
template <int J, int kMode, bool kStaged, bool kDump = false, bool kBump = false, bool kFront = false,
          bool kTxext = false, bool kCluster = false>
__global__ void __launch_bounds__(kThreads, kStaged ? 1 : plain_blocks(J))
    diag_wide(Link L, int b_lo, int b_hi, const float* partials, unsigned long long* acc, double* psum,
              float* carry_r, float* carry_i, ofdm::Scratch scr) {
  extern __shared__ float splane[];  // plane_floats: a sampled symbol's IDFT (in-run PAPR only)
  __shared__ float wsum[kWarps];
  __shared__ float cpart[2];
  const int tid = threadIdx.x;
  const int base = kCluster ? static_cast<int>(blockIdx.x % L.C) * kSliceBins : 0;

  uint32_t be = 0, se = 0;
  float pk = 0.0f;
  double ps = 0.0;

  const int run_id = kCluster ? static_cast<int>(blockIdx.x) / L.C : static_cast<int>(blockIdx.x);
  const int b0 = static_cast<int>(b_lo + static_cast<long long>(run_id) * L.run);
  const int b1 = min(b0 + L.run, b_hi);
  int cached_tile = -1;
  float sigma = 0.0f, energy = 0.0f;
  for (int b = b0; b < b1; ++b) {
    const int tile_id = b / L.tile;
    if (L.add_noise && tile_id != cached_tile) {
      const int tlen = min(L.tile, L.chunk - tile_id * L.tile);
      sigma = ofdm::tile_sigma(partials + tile_id * L.groups, L.groups, min(L.slice, tlen) * L.n, L.snr_lin);
      cached_tile = tile_id;
    }
    const bool sampled = !kTxext && !L.txext && (tile_id % L.pstride) == 0;
    const unsigned long long sym = L.sym0 + static_cast<unsigned long long>(b);

    float yr[J], yi[J];
    int tx[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int k = base + tid + kThreads * j;
      yr[j] = 0.0f;
      yi[j] = 0.0f;
      tx[j] = 0;
      if (k < L.n) {
        const uint4 w = ofdm::symbol_words(sym, k, L.key);
        float sr, si;
        tx[j] = ofdm::encode<kMode>(w.x, L.q, L.lanes, k, sr, si);
        ofdm::scale_tx<kStaged>(L, k, sr, si);
        if (sampled) {
          const int slot = ofdm::dft_slot(L.plan, k);
          splane[slot] = sr;
          splane[L.n + slot] = si;
        }
        const float hr = __ldg(L.chr + k);
        const float hi = __ldg(L.chi + k);
        yr[j] = sr * hr - si * hi;
        yi[j] = sr * hi + si * hr;
        if (L.add_noise) ofdm::add_noise(w.y, w.z, sigma, yr[j], yi[j]);
      }
    }

    // the MMSE mean: per-thread sum in j order, the block sum, the slices in order
    float nv = 0.0f;
    if (L.eq.method == 1) {
      float p = 0.0f;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        if (base + tid + kThreads * j < L.n) p = p + (yr[j] * yr[j] + yi[j] * yi[j]);
      }
      const float sp = symbol_sum<kCluster>(L, p, wsum, cpart) / static_cast<float>(L.n);
      nv = sp / L.snr_lin / L.eq.cg;
    }
    float er[J], ei[J];
    float p = 0.0f;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int k = base + tid + kThreads * j;
      er[j] = 0.0f;
      ei[j] = 0.0f;
      if (k < L.n) {
        ofdm::equalize_stage<kMode, kStaged>(L, k, yr[j], yi[j], nv, er[j], ei[j]);
        ofdm::bump_stages<kBump>(L, sym, k, er[j], ei[j]);
        if constexpr (kFront) p = p + (er[j] * er[j] + ei[j] * ei[j]);
      }
    }
    if constexpr (kFront) {
      energy = energy + symbol_sum<kCluster>(L, p, wsum, cpart);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int k = base + tid + kThreads * j;
        if (k < L.n) ofdm::scratch_store(scr, b_lo, L.n, b, k, tx[j], er[j], ei[j]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int k = base + tid + kThreads * j;
        if (k < L.n) {
          ofdm::dump_bin<kMode, kDump>(L, b, k, er[j], ei[j]);
          ofdm::count_bin<kMode>(tx[j], er[j], ei[j], L.q, L.lanes, k, be, se);
        }
      }
    }

    if (sampled) papr_idft(L, splane, b == L.carry_sym, pk, ps, carry_r, carry_i);
  }
  if (L.txext && blockIdx.x == 0 && b_lo == 0) {
    // no time plane in the chunk: the carry row is zeros (no diag symbol reads it)
    for (int c = tid; c < L.T; c += kThreads) {
      carry_r[c] = 0.0f;
      carry_i[c] = 0.0f;
    }
  }
  if (kFront && tid == 0 && base == 0 && b0 < b_hi) L.st.norm_part[b0 / L.run] = energy;

  ofdm::flush_counters<kWarps>(be, se, pk, ps, acc, psum);
}

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

// Dynamic shared bytes of a chunk's main kernels: the in-run PAPR's plane.
size_t plane_bytes(const Link& L) {
  return L.txext ? 0 : sizeof(float) * static_cast<size_t>(plane_floats(L.plan));  // <= 64 KB
}

// Launches `kernel` over chunk symbols [b_lo, b_hi), a block a run, with the
// plane's dynamic shared memory (raising the kernel's limit past 48 KB).
template <class K>
cudaError_t launch_main(K* kernel, const Link& L, int b_lo, int b_hi, const float* partials,
                        unsigned long long* acc, double* psum, float* cr, float* ci, const ofdm::Scratch& scr,
                        cudaStream_t stream) {
  const size_t bytes = plane_bytes(L);
  if (bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  const int grid = (b_hi - b_lo + L.run - 1) / L.run;
  if (L.C > 1) {
    // a cluster of C blocks a symbol along x (txext: no dynamic shared memory)
    return ofdm::launch_clusters(kernel, dim3(grid * L.C), kThreads, static_cast<int>(bytes), L.C, 0, stream, L,
                                 b_lo, b_hi, partials, acc, psum, cr, ci, scr);
  }
  kernel<<<grid, kThreads, bytes, stream>>>(L, b_lo, b_hi, partials, acc, psum, cr, ci, scr);
  return cudaGetLastError();
}

// wide_power (when noise is on) then diag_wide at J bins a thread, as
// clusters of L.C blocks a symbol with kCl; in the OFDM_STAGED build under
// normalize the one-pass slabs (diag_common.cuh).
template <int J, int kMode, bool kCl>
cudaError_t launch_at(const Link& L, int slab, const ofdm::Scratch& scr, float* partials, unsigned long long* acc,
                      double* psum, float* cr, float* ci, cudaStream_t stream) {
  constexpr bool kS = ofdm::kStagedBuild;
  constexpr bool kB = ofdm::kBumpBuild;
  auto* main_kernel = &diag_wide<J, kMode, kS, false, kB, false, false, kCl>;
  if (L.add_noise) {
    const int tiles = (L.chunk + L.tile - 1) / L.tile;
    wide_power<kMode, kS><<<dim3(tiles, L.groups), kThreads, 0, stream>>>(L, partials);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
#if OFDM_STAGED
  if (L.st.bits & ofdm::kStageNormalize) {
    return ofdm::onepass_slabs<kMode>(L, slab, scr, sm_count() * 8, acc, psum, stream, [&](int b_lo, int b_hi) {
      return launch_main(&diag_wide<J, kMode, kS, false, kB, true, false, kCl>, L, b_lo, b_hi, partials, acc, psum,
                         cr, ci, scr, stream);
    });
  }
  if (L.st.bits & ofdm::kStageDump) main_kernel = &diag_wide<J, kMode, kS, true, kB, false, false, kCl>;
#else
  (void)slab;
  if (L.txext) main_kernel = &diag_wide<J, kMode, false, false, false, false, true, kCl>;
#endif
  return launch_main(main_kernel, L, 0, L.chunk, partials, acc, psum, cr, ci, scr, stream);
}

template <int J, int kMode>
cudaError_t launch(const Link& L, int slab, const ofdm::Scratch& scr, float* partials, unsigned long long* acc,
                   double* psum, float* cr, float* ci, cudaStream_t stream) {
  if constexpr (J == 16) {  // past 4096 bins: clusters
    if (L.C > 1) return launch_at<J, kMode, true>(L, slab, scr, partials, acc, psum, cr, ci, stream);
  }
  return launch_at<J, kMode, false>(L, slab, scr, partials, acc, psum, cr, ci, stream);
}

// Calls f(std::integral_constant<int, J>()) for the bins a thread of width n.
template <class F>
cudaError_t with_width(int n, F&& f) {
  const int bins = ((n < kSliceBins ? n : kSliceBins) + kThreads - 1) / kThreads;  // bins a thread: 2 ... 16
  if (bins <= 2) return f(std::integral_constant<int, 2>());
  if (bins <= 4) return f(std::integral_constant<int, 4>());
  if (bins <= 8) return f(std::integral_constant<int, 8>());
  return f(std::integral_constant<int, 16>());
}

}  // namespace ofdm_diag_wide

using namespace ofdm_diag_wide;

extern "C" {

// One chunk of a diag link at 257 <= n <= 32768 (past 4096 under txext, as
// clusters of ceil(n / 4096) blocks a symbol): wide_power (when noise is
// on) then diag_wide, all on `stream`, in constellation mode `mode`
// (link_common.cuh::Mode; lane_i / lane_f the adaptive modes' lane rows).
// The arguments are link_kernel.cu's ofdm_diag_chunk's: fr / fi unused
// (the in-run PAPR takes the block IDFT of the plan twr / twi / n1 / n2 /
// log2n / dft_scale, ops/dft.py::DftPlan; the twiddles null under txext),
// txext 1 when the runner supplies the PAPR statistic (the carry row is
// then zeros).  acc = [bit errors, symbol errors, PAPR peak f32 bits]
// (int64, accumulated), psum = PAPR power sum (float64, accumulated).
// rows / stages / norm_part / norm_f / dump: the _Spec stages
// (link_common.cuh::Stages; stages must be 0 in the plain build); scr_r /
// scr_i / scr_tx / slab: a normalized chunk's scratch (diag_common.cuh).
// Returns the first CUDA error of the launches, 0 if none.
int ofdm_diag_wide_chunk(const float* hr, const float* hi, const float* habs2, const float* gr,
                         const float* gi, const float* chr, const float* chi, const float* /* fr */,
                         const float* /* fi */, int n, int T, int mode,
                         int order, int m, int logm, int bits, int gray, float scale,
                         const int* lane_i, const float* lane_f, float slicer,
                         float snr_lin, float cg, int method, int add_noise,
                         unsigned long long sym0, int chunk, int tile, int slice, int groups,
                         int pstride, int carry_sym, int run, unsigned int key0, unsigned int key1,
                         float* partials, long long* acc, double* psum, float* carry_r,
                         float* carry_i, const float* rows, int stages, float* norm_part, float* norm_f,
                         float* dump_r, float* dump_i, int dump_rows, float* scr_r, float* scr_i,
                         unsigned short* scr_tx, int slab, const float* twr, const float* twi, int n1, int n2,
                         int log2n, float dft_scale, int txext, void* stream_ptr) {
  const bool plan_ok = txext || (twr != nullptr && twi != nullptr && n1 >= 1 && n1 * n2 == n &&
                                 (log2n < 0 || (1 << log2n) == n));
  if (n < kMinN || n > kMaxN || (n > kSliceBins && !txext) || T < n || T > 2 * n || chunk < 1 || tile < 1 ||
      slice < 1 || groups < 1 || pstride < 1 || run < 1 || tile % run != 0 || chr == nullptr || chi == nullptr || !plan_ok ||
      (ofdm::adaptive(mode) && (lane_i == nullptr || lane_f == nullptr)) ||
      !ofdm::stage_args_ok(rows, stages, norm_part, norm_f, dump_r, dump_i, dump_rows, ofdm::kBumpBuild)) {
    return cudaErrorInvalidValue;
  }
  const ofdm::Scratch scr{scr_r, scr_i, scr_tx};
#if OFDM_STAGED
  if (!ofdm::scratch_ok(stages, scr, slab, tile, chunk)) return cudaErrorInvalidValue;
#endif
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Link L;
  L.eq = ofdm::Equalizer{hr, hi, habs2, gr, gi, slicer, cg, method};
  L.plan = ofdm::DftPlan{twr, twi, n, n1, n2, log2n, dft_scale};
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
  L.C = cluster_of(n);
  L.key = make_uint2(key0, key1);
  L.lanes = ofdm::Lanes{lane_i, lane_f, n};
  L.st = ofdm::make_stages(rows, stages, norm_part, norm_f, dump_r, dump_i, dump_rows);

  unsigned long long* a = reinterpret_cast<unsigned long long*>(acc);
  return static_cast<int>(ofdm::with_mode(mode, [&](auto md) {
    return with_width(n, [&](auto j) {
      return launch<decltype(j)::value, decltype(md)::value>(L, slab, scr, partials, a, psum, carry_r, carry_i,
                                                             stream);
    });
  }));
}

// The layout of this build's qam kernels at width n with the in-run PAPR's
// plane (log2n >= 0: radix-2, else the split), as a chunk launches them:
// four ints (registers, local bytes a thread, static shared memory,
// resident blocks an SM) for each of wide_power, diag_wide's counting
// variant, its front variant and diag_demap (-1 where the build has none),
// into out[16].
int ofdm_diag_wide_geometry(int n, int log2n, int* out) {
  if (n < kMinN || n > kMaxN) return cudaErrorInvalidValue;
  for (int i = 0; i < 16; ++i) out[i] = -1;
  const size_t bytes = sizeof(float) * static_cast<size_t>((log2n >= 0 ? 2 : 4) * n);
  return static_cast<int>(with_width(n, [&](auto j) {
    constexpr int J = decltype(j)::value;
    constexpr bool kS = ofdm::kStagedBuild;
    constexpr bool kB = ofdm::kBumpBuild;
    cudaError_t err = ofdm::kernel_layout(&wide_power<ofdm::kQam, kS>, kThreads, 0, out);
    if (err == cudaSuccess) {
      err = ofdm::kernel_layout(&diag_wide<J, ofdm::kQam, kS, false, kB>, kThreads, bytes, out + 4);
    }
#if OFDM_STAGED
    if (err == cudaSuccess) {
      err = ofdm::kernel_layout(&diag_wide<J, ofdm::kQam, kS, false, kB, true>, kThreads, bytes, out + 8);
    }
    if (err == cudaSuccess) {
      err = ofdm::kernel_layout(&ofdm::diag_demap<ofdm::kQam, false, Link>, ofdm::kDemapThreads, 0, out + 12);
    }
#endif
    return err;
  }));
}

const char* ofdm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
