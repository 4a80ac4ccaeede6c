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
// rows and skinny matrices (E x n each, 57 KB at n = 1024 and E = 7) and
// writes 3 counters and one row.  Each bin runs the per-bin chain it shares
// with the diag kernel (link_common.cuh: Philox, encode, Box-Muller,
// equalizer, slicer, ~250 operations) plus 8 operations a term of the two
// skinny products (E terms for t, 2E for the corrections) and, on a zero
// prefix, r terms of g2 @ B^H.  A layout that reads every factor element
// once a symbol streams ~190-240 bytes a bin and symbol from L2 at 1024
// subcarriers and is bound by L2 instead (its time grows linearly with E).
//
// Design:
//  * One block of 256 threads walks `run` consecutive symbols in groups of
//    M (group_of(J): 4 up to 512 subcarriers, 8 to 1024, 4 to 2048, 2 to
//    4096); thread t holds bins t + 256 j (j < J, n <= 4096 so J <= 16).
//    Past 4096 subcarriers (8K / 16K / 32K FFTs) a symbol is held by a
//    thread-block cluster of C = ceil(n / 4096) blocks (2 to 8: within the
//    portable cluster size), block r holding the 4096-bin slice from r x 4096
//    in the same layout (J = 16; the last slice may be short, its missing
//    bins skipped as n's are at any width).  The blocks of a cluster walk
//    the same run.
//    Within a group a thread loads each factor element of its bins once —
//    TailM[e, k], [Cr; Cp][r, k], B^H[i, k], D[k], the equalizer rows — and
//    applies it to all M symbols, so the factors stream once a group and
//    not once a symbol.
//  * Only the rows the host lists are read (Link's row table, ascending;
//    lr_kernel.row_table): the nonzero rows of TailM and B^H, and the rows
//    of [Cr; Cp] that are nonzero and multiply a lane of t that is not
//    identically zero.  t is kept for the listed lanes only, so its slots,
//    and a block's shared memory, grow with the nonzero tail lanes and not
//    with E.  Under
//    -fmad=false a skipped term is a*0 - c*0 = +-0, which leaves every sum
//    unchanged, and t's skipped lanes are exactly +0 (the slots start at
//    zero), so the result is bit-equal to the product over all rows.  A
//    link with an all-zero TailM (a zero prefix covering the channel) runs
//    no tail pass and no correction.
//  * The group's points live in registers, s[M][J] complex (an encode loop
//    over the symbols that shifts the rows down, so every register index is
//    static); the Box-Muller normals (drawn right after encode: they depend
//    only on the words), the TX indices and then y live in the thread's own
//    slots of dynamic shared memory.
//  * Every block-wide sum keeps the order of one symbol a block: t's E
//    outputs and the MMSE mean are per-thread partials in k order, an xor
//    butterfly in each warp and the 8 warps in order, which the plain
//    version (link_kernel.block_sum) repeats, so counts agree exactly.  The
//    group's tail sums run in passes of at most kTailPass listed lanes (M x
//    2 x 64 sums sharing one pair of barriers), and its M means share one
//    barrier.  In a cluster each block's slice sums go to its shared
//    memory, a cluster barrier publishes them, and every block adds the C
//    slices' sums in block-rank order through distributed shared memory
//    (link_common.cuh::cluster_totals); the plain version takes the same
//    slices in the same order (block_sum's slice), and a block that holds a
//    whole symbol takes no cluster step, so every link of up to 4096
//    subcarriers keeps its bits.  Only the kernels of 16 bins a thread
//    hold the cluster code (diag_wide instead instantiates it apart:
//    beside its one-block code it cost 8.6% at 4096 subcarriers).
//  * The TPU grid runs in order and carries the last tail row from tile to
//    tile; CUDA blocks do not.  A block keeps the previous symbol's t in
//    slot 0 of its t slots (the last slot moves there as the next group's
//    sums land); for its first symbol it recomputes t_{b-1} from Philox
//    with the same operation order, which is bit-equal to a carried row.
//    Run symbol 0 sees t_prev = 0.  So nothing depends on block order,
//    launch geometry or chunking.
//  * Measured power: a first kernel (lr_power) recomputes y for each tile's
//    slice (one block per 4096 slice elements, in groups of group_power(J)
//    symbols; past 4096 bins one block per 4096-bin slice of a symbol, a
//    short last slice's missing elements zero) and reduces |y|^2 in
//    power_partials' fixed order; lr_main sums a tile's partials in order
//    (a run lies in one tile).
//  * The g2 draws of a zero-prefix group come from Philox counters (b lo,
//    b hi, i, 1), one thread each, shared through shared memory, in rounds
//    of at most kG2Round listed rows of B^H: one round (up to 128 rows) is
//    drawn once a group, more are drawn again for each j, between barriers,
//    so the shared memory stays bounded at any noise rank.  A bin's colored
//    part sums the rows in the same ascending order either way.
//  * Matrices are read through the read-only cache, (E, n) and (2E, n)
//    row-major so a warp reads consecutive words.
//  * Counters: per-thread 32-bit, warp and block sums, one 64-bit atomicAdd
//    per block; PAPR peak an atomicMax on the f32 bits, PAPR sum a double
//    atomicAdd (its last digits depend on block order).
//  * normalize (staged build): lr_main runs twice around norm_factors, as
//    diag_staged does; phase 0 writes each block's |e|^2 sum over its run of
//    symbols (each symbol's sum a block sum, added in symbol order), phase 1
//    scales and counts.
//  * Carry-in (sharded contiguous streams): given a t (this link's: its
//    lanes of zero TailM rows are zero), the chunk's first symbol reads it
//    as t_prev instead of recomputing it, in every pass that recomputes one
//    (lr_power, both passes of lr_main).
//  * The carry probe (lr_probe; pallas_link.py::_probe_fn_for_spec, K3):
//    one block (a cluster past 4096 subcarriers) of the chunk's shape
//    computes a chunk's last symbol's t through the same encode and tail
//    pass, and writes the (T,) carry row (zeros but for the last E lanes)
//    and t.

#include <cstdint>
#include <cuda_runtime.h>

#include "link_common.cuh"

// A named namespace, so profilers show the kernels' names.
namespace ofdm_lr {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kPowerSteps = 16;
constexpr int kPowerBlock = kPowerSteps * kThreads;  // slice elements per lr_power block
constexpr int kSliceBins = 4096;                     // bins a block holds (16 a thread)
constexpr int kMaxCluster = 8;                       // the portable cluster size
constexpr int kMaxN = kSliceBins * kMaxCluster;
constexpr int kTailPass = 64;  // listed tail lanes a pass of tails_group sums
constexpr int kG2Round = 128;  // listed rows of B^H whose g2 draws a round holds

// Symbols a group of lr_main holds at J bins a thread (M x J <= 32 points a
// thread), and of lr_power (whose block covers 4096 / n symbols); both
// divide the run of 16 (ofdm_lr_geometry reports them).
// Up to 512 subcarriers lr_main keeps 4 symbols a group in 64 registers, so
// 4 blocks share an SM; from 513 it takes 128 registers and 2 blocks (the
// faster of the layouts timed on an H100, PERF.md §6).
__host__ __device__ constexpr int group_of(int J) { return J <= 2 ? 4 : 32 / J; }
__host__ __device__ constexpr int group_power(int J) { return J <= 2 ? 8 : 16 / J; }
__host__ __device__ constexpr int min_blocks(int J) { return J <= 2 ? 4 : 2; }

// Blocks a symbol: 1 up to 4096 bins, else a cluster of ceil(n / 4096).
__host__ __device__ constexpr int cluster_of(int n) { return (n + kSliceBins - 1) / kSliceBins; }

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
  int rank;  // B^H's rows; 0 without noise, so no g2 draw runs then
  int C;     // blocks a symbol (cluster_of(n))
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
  // The rows the kernels read (lr_kernel.row_table, ascending): TailM's nt
  // listed rows (t is kept in their places only), each lane's place among
  // them or -1 (E), the ncc rows of [Cr; Cp] that can add a nonzero term with
  // the offset of each one's t from its symbol's t_prev slots, B^H's nbh
  // listed rows.
  const int* tail_rows;
  const int* tail_slot;
  const int* cc_rows;
  const int* cc_off;
  const int* bh_rows;
  int nt;
  int ncc;
  int nbh;  // 0 without noise
};

// Whether a symbol is held by a cluster of blocks: only at 16 bins a thread
// (past 4096 bins), so the kernels of fewer bins a thread hold no cluster code.
template <int J>
__device__ __forceinline__ bool clustered(const Link& L) {
  if constexpr (J == 16) {
    return L.C > 1;
  } else {
    return false;
  }
}

// link_common.cuh::cluster_totals, compiled where a cluster can hold a symbol.
template <int J>
__device__ __forceinline__ void cluster_sums(const Link& L, float* part, float* out, int cnt) {
  if constexpr (J == 16) ofdm::cluster_totals(part, out, cnt, L.C);
}

// Floats of the cluster scratch of a block at M symbols a group and np tail
// lanes a pass (the slice sums, then the totals), 0 at one block a symbol.
__host__ __device__ constexpr int cluster_floats(int M, int np, int C) {
  return C > 1 ? 2 * (2 * M * np > M ? 2 * M * np : M) : 0;
}

// Dynamic shared memory of lr_main in floats, in this order: the t slots
// (M + 1 symbols x nt, float2), a round of g2 draws (M x R, float2), the
// thread's slots (M x J x 256: the normals then y as float2, the TX index),
// the per-warp tail sums (8 x M x 2 x np, np = min(nt, kTailPass)), the
// per-warp MMSE and energy sums (8 x M each), the cluster scratch, and a
// sampled symbol's s (2n, in-kernel PAPR only).  ofdm_lr_geometry reports it.
__host__ __device__ constexpr int main_smem_floats(int M, int J, int n, int nt, int R, int C, int txext) {
  return 2 * (M + 1) * nt + 2 * M * R + 3 * M * J * kThreads + kWarps * M * 2 * (nt < kTailPass ? nt : kTailPass) +
         2 * kWarps * M + cluster_floats(M, nt < kTailPass ? nt : kTailPass, C) + (txext ? 0 : 2 * n);
}

// lr_power's and lr_probe's: the t slots, the per-warp tail sums and the
// cluster scratch.
__host__ __device__ constexpr int tail_smem_floats(int M, int nt, int C) {
  return 2 * (M + 1) * nt + kWarps * M * 2 * (nt < kTailPass ? nt : kTailPass) +
         cluster_floats(M, nt < kTailPass ? nt : kTailPass, C);
}

// Symbols [first, first + cnt) of a group: sr / si[m][j] the points of the
// thread's bins base + tid + 256 j (zeros from cnt on), scaled under
// apply_power.  With kWords, each (m, j) slot also gets the TX index and,
// with noise, the Box-Muller normals of the bin's words.  The loop over
// symbols shifts the rows down and fills the last, so every register index
// is static.  The rows start at zero: a shift that reads a row never
// written is undefined, and nvcc then dropped the shift at 4 bins a thread.
template <int J, int M, int kMode, bool kStaged, bool kWords>
__device__ __forceinline__ void encode_group(const Link& L, int base, unsigned long long first, int cnt,
                                             float (&sr)[M][J], float (&si)[M][J], float2* zs, int* txs) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      sr[m][j] = 0.0f;
      si[m][j] = 0.0f;
    }
  }
#pragma unroll 1
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int i = 0; i + 1 < M; ++i) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        sr[i][j] = sr[i + 1][j];
        si[i][j] = si[i + 1][j];
      }
    }
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int k = base + tid + kThreads * j;
      float a = 0.0f, c = 0.0f;
      if (m < cnt && k < L.n) {
        const uint4 wd = ofdm::symbol_words(first + static_cast<unsigned long long>(m), k, L.key);
        const int tx = ofdm::encode<kMode>(wd.x, L.q, L.lanes, k, a, c);
        ofdm::scale_tx<kStaged>(L, k, a, c);
        if constexpr (kWords) {
          const int slot = (m * J + j) * kThreads + tid;
          txs[slot] = tx;
          float zr = 0.0f, zi = 0.0f;
          if (L.add_noise) ofdm::box_muller(wd.y, wd.z, zr, zi);
          zs[slot] = make_float2(zr, zi);
        }
      }
      sr[M - 1][j] = a;
      si[M - 1][j] = c;
    }
  }
}

// t of the group's symbols m < cnt into out[m * nt + p] (re, im) for the
// listed tail lanes p, in passes of at most kTailPass lanes: per-thread
// partials in k order, a warp butterfly, the warps in order, and in a
// cluster the blocks' slice sums in rank order (`cpart`: the cluster
// scratch).  With `moved`, out[(M - 1) * nt + p] first moves to moved[p]
// (the previous group's last t becomes this group's t_prev).  Every thread
// of the block (of the cluster) calls it; it leaves the block synchronized.
template <int J, int M>
__device__ __forceinline__ void tails_group(const Link& L, int base, const float (&sr)[M][J],
                                            const float (&si)[M][J], int cnt, float* wsum, float* cpart,
                                            float2* out, float2* moved) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int p0 = 0; p0 < L.nt; p0 += kTailPass) {
    const int np = min(kTailPass, L.nt - p0);
    const int W = 2 * np;
    for (int p = p0; p < p0 + np; ++p) {
      const int e = __ldg(L.tail_rows + p);
      float pr[M], pi[M];
#pragma unroll
      for (int m = 0; m < M; ++m) {
        pr[m] = 0.0f;
        pi[m] = 0.0f;
      }
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int k = base + tid + kThreads * j;
        if (k < L.n) {
          const float f_r = __ldg(L.tlr + e * L.n + k);
          const float f_i = __ldg(L.tli + e * L.n + k);
#pragma unroll
          for (int m = 0; m < M; ++m) {
            pr[m] = pr[m] + (sr[m][j] * f_r - si[m][j] * f_i);
            pi[m] = pi[m] + (sr[m][j] * f_i + si[m][j] * f_r);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < M; ++m) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          pr[m] = pr[m] + __shfl_xor_sync(0xFFFFFFFFu, pr[m], off);
          pi[m] = pi[m] + __shfl_xor_sync(0xFFFFFFFFu, pi[m], off);
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int m = 0; m < M; ++m) {
          wsum[(warp * M + m) * W + (p - p0)] = pr[m];
          wsum[(warp * M + m) * W + np + (p - p0)] = pi[m];
        }
      }
    }
    __syncthreads();
    const float* sums = cpart;
    if (clustered<J>(L)) {
      for (int o = tid; o < M * W; o += kThreads) {
        const int m = o / W;
        float s = 0.0f;
        for (int w = 0; w < kWarps; ++w) s = s + wsum[(w * M + m) * W + (o - m * W)];
        cpart[o] = s;
      }
      cluster_sums<J>(L, cpart, cpart + M * W, M * W);
      sums = cpart + M * W;
    }
    for (int o = tid; o < M * W; o += kThreads) {
      const int m = o / W;
      const int c = o - m * W;
      float* dst = reinterpret_cast<float*>(out + m * L.nt + p0 + (c < np ? c : c - np)) + (c < np ? 0 : 1);
      if (moved != nullptr && m == M - 1) {
        reinterpret_cast<float*>(moved + p0 + (c < np ? c : c - np))[c < np ? 0 : 1] = *dst;
      }
      if (m < cnt) {
        float s;
        if (clustered<J>(L)) {
          s = sums[o];
        } else {
          s = 0.0f;
          for (int w = 0; w < kWarps; ++w) s = s + wsum[(w * M + m) * W + c];
        }
        *dst = s;
      }
    }
    __syncthreads();
  }
}

// out[p] = t of run symbol `sym - 1` for the listed tail lanes, the t slots
// of the run's first symbol (zero-initialized and synchronized by the
// caller); they stay zero for the run's first symbol and when TailM is all
// zero.  The chunk's first symbol reads the caller's t instead when the
// Link carries one.  Leaves the block synchronized.
template <int J, int kMode, bool kStaged>
__device__ void prev_tail(const Link& L, int base, unsigned long long sym, float* wsum, float* cpart, float2* out) {
  if (L.nt == 0) return;
  if (L.prev_r != nullptr && sym == L.sym0) {
    for (int p = threadIdx.x; p < L.nt; p += kThreads) {
      const int e = __ldg(L.tail_rows + p);
      out[p] = make_float2(L.prev_r[e], L.prev_i[e]);
    }
    __syncthreads();
    return;
  }
  if (sym == 0) return;
  float sr[1][J], si[1][J];
  encode_group<J, 1, kMode, kStaged, false>(L, base, sym - 1, 1, sr, si, nullptr, nullptr);
  tails_group<J, 1>(L, base, sr, si, 1, wsum, cpart, out, nullptr);
}

// cr / ci[m] = [t | tp] @ [Cr; Cp] at bin k for the group's symbols, over
// the listed rows in order (t's, then tp's): ts holds the t slots, symbol m
// at slot m + 1, its t_prev at slot m.
template <int M>
__device__ __forceinline__ void corrections(const Link& L, int k, const float2* ts, float (&cr)[M],
                                            float (&ci)[M]) {
#pragma unroll
  for (int m = 0; m < M; ++m) {
    cr[m] = 0.0f;
    ci[m] = 0.0f;
  }
  for (int i = 0; i < L.ncc; ++i) {
    const int r = __ldg(L.cc_rows + i);
    const float m_r = __ldg(L.ccr + r * L.n + k);
    const float m_i = __ldg(L.cci + r * L.n + k);
    const float2* tv = ts + __ldg(L.cc_off + i);
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const float2 t = tv[m * L.nt];
      cr[m] = cr[m] + (t.x * m_r - t.y * m_i);
      ci[m] = ci[m] + (t.x * m_i + t.y * m_r);
    }
  }
}

// The bin offset of this block's slice: 0 at one block a symbol, else its
// rank in the cluster times 4096 (the cluster's blocks are consecutive along
// grid dimension `dim`).
template <int J>
__device__ __forceinline__ int slice_base(const Link& L, int dim) {
  return clustered<J>(L) ? static_cast<int>((dim == 0 ? blockIdx.x : blockIdx.y) % L.C) * kSliceBins : 0;
}

// Partial sums of |y|^2 (before noise) over each tile's measured-power slice,
// in power_partials' order.  grid (tiles, groups); block (tile, g) covers
// slice elements e = b*n + k in [g*4096, (g+1)*4096), its symbols in groups
// of group_power(J); past 4096 bins it covers slice g % C of symbol g / C
// (the rest of its 4096 elements zero when that slice is short), and the
// blocks of a symbol form a cluster along y.
template <int J, int kMode, bool kStaged>
__global__ void __launch_bounds__(kThreads) lr_power(Link L, float* partials) {
  constexpr int M = group_power(J);
  __shared__ float red[kPowerBlock];  // element order
  extern __shared__ float dyn[];
  float2* ts = reinterpret_cast<float2*>(dyn);
  const int np = min(L.nt, kTailPass);
  float* wsum = dyn + 2 * (M + 1) * L.nt;
  float* cpart = wsum + kWarps * M * 2 * np;
  const int tid = threadIdx.x;
  const int tile_id = blockIdx.x;
  const int g = blockIdx.y;
  const int base = slice_base<J>(L, 1);
  const int b0 = tile_id * L.tile;
  const int tlen = min(L.tile, L.chunk - b0);
  const int count = min(L.slice, tlen) * L.n;
  int e_lo = g * kPowerBlock;
  int e_hi = min(e_lo + kPowerBlock, count);
  if (clustered<J>(L)) {  // slice g % C of symbol g / C: g x 4096 when C x 4096 = n
    const int s = g / L.C;
    e_lo = s * L.n + base;
    e_hi = s < min(L.slice, tlen) ? s * L.n + min(base + kSliceBins, L.n) : e_lo;
  }
  for (int i = tid; i < kPowerBlock; i += kThreads) red[i] = 0.0f;
  for (int i = tid; i < (M + 1) * L.nt; i += kThreads) ts[i] = make_float2(0.0f, 0.0f);
  __syncthreads();
  if (e_lo < e_hi) {  // the same for every block of a cluster: a symbol's slices
    const int s_lo = e_lo / L.n;
    const int s_hi = (e_hi - 1) / L.n + 1;
    prev_tail<J, kMode, kStaged>(L, base, L.sym0 + static_cast<unsigned long long>(b0 + s_lo), wsum, cpart, ts);
    for (int g0 = s_lo; g0 < s_hi; g0 += M) {
      const int cnt = min(M, s_hi - g0);
      float sr[M][J], si[M][J];
      encode_group<J, M, kMode, kStaged, false>(L, base, L.sym0 + static_cast<unsigned long long>(b0 + g0), cnt,
                                                sr, si, nullptr, nullptr);
      if (L.nt > 0) tails_group<J, M>(L, base, sr, si, cnt, wsum, cpart, ts + L.nt, g0 > s_lo ? ts : nullptr);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int k = base + tid + kThreads * j;
        if (k < L.n) {
          float cr[M], ci[M];
          corrections<M>(L, k, ts, cr, ci);
          const float d_r = __ldg(L.dr + k);
          const float d_i = __ldg(L.di + k);
#pragma unroll
          for (int m = 0; m < M; ++m) {
            const float yr = (sr[m][j] * d_r - si[m][j] * d_i) + cr[m];
            const float yi = (sr[m][j] * d_i + si[m][j] * d_r) + ci[m];
            const int e = (g0 + m) * L.n + k;
            if (m < cnt && e >= e_lo && e < e_hi) red[e - e_lo] = yr * yr + yi * yi;
          }
        }
      }
      __syncthreads();  // the t slots are rewritten by the next group
    }
  }
  ofdm::power_block_partial<kThreads, kPowerSteps>(red, tid, partials + tile_id * L.groups + g);
}

// The per-warp sums of one value a symbol (v[m], the thread's partials)
// into sums[warp * M + m]: an xor butterfly in each warp.  Every thread of
// the block calls it; the caller synchronizes before reading.
template <int M>
__device__ __forceinline__ void warp_sums(float (&v)[M], float* sums) {
#pragma unroll
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[m] = v[m] + __shfl_xor_sync(0xFFFFFFFFu, v[m], off);
  }
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int m = 0; m < M; ++m) sums[(threadIdx.x >> 5) * M + m] = v[m];
  }
}

// The block sum of symbol m from warp_sums' output: the warps in order.
template <int M>
__device__ __forceinline__ float warps_in_order(const float* sums, int m) {
  float s = 0.0f;
  for (int w = 0; w < kWarps; ++w) s = s + sums[w * M + m];
  return s;
}

// In a cluster, the M symbols' sums from warp_sums' output (synchronized):
// each block's slice sums, then the slices in rank order, into
// cpart[M .. 2M) of every block (the cluster scratch).  Every thread of the
// cluster calls it.
template <int J, int M>
__device__ __forceinline__ const float* symbol_totals(const Link& L, const float* sums, float* cpart) {
  if (threadIdx.x < M) cpart[threadIdx.x] = warps_in_order<M>(sums, threadIdx.x);
  cluster_sums<J>(L, cpart, cpart + M, M);
  return cpart + M;
}

// g2 of listed rows [r0, r0 + rn) of B^H for the group's symbols m < cnt
// into gs[m * R + (i - r0)]: counters (b lo, b hi, row, 1), one thread each.
__device__ __forceinline__ void draw_g2(const Link& L, unsigned long long first, int cnt, int r0, int rn, int R,
                                        float2* gs) {
  for (int o = threadIdx.x; o < cnt * rn; o += kThreads) {
    const int m = o / rn;
    const int i = o - m * rn;
    const unsigned long long sym = first + static_cast<unsigned long long>(m);
    const uint4 wd = ofdm::philox4x32_10(
        make_uint4(static_cast<uint32_t>(sym), static_cast<uint32_t>(sym >> 32),
                   static_cast<uint32_t>(__ldg(L.bh_rows + r0 + i)), 1u),
        L.key);
    float zr, zi;
    ofdm::box_muller(wd.y, wd.z, zr, zi);
    gs[m * R + i] = make_float2(zr, zi);
  }
}

// With kStaged, the stages (phase 0 of a normalized link writes its run's
// |e|^2 partial instead of counting); kDump is the dump stage's
// launch-time variant, kBump the noise-bump stages (the OFDM_BUMP build).
// grid: runs (x C past 4096 bins: a run's blocks form a cluster along x).
template <int J, int kMode, bool kStaged, bool kDump = false, bool kBump = false>
__global__ void __launch_bounds__(kThreads, min_blocks(J))
    lr_main(Link L, const float* partials, unsigned long long* acc, double* psum, float* carry_r,
            float* carry_i) {
  constexpr int M = group_of(J);
  const int R = min(L.nbh, kG2Round);
  const int np = min(L.nt, kTailPass);
  extern __shared__ float dyn[];
  float2* ts = reinterpret_cast<float2*>(dyn);
  float2* gs = ts + (M + 1) * L.nt;
  float2* zs = gs + M * R;  // the thread's slots: normals, then y
  int* txs = reinterpret_cast<int*>(zs + M * J * kThreads);
  float* wsum = reinterpret_cast<float*>(txs + M * J * kThreads);
  float* nvs = wsum + kWarps * M * 2 * np;
  float* es = nvs + kWarps * M;
  float* cpart = es + kWarps * M;
  float* splane = cpart + cluster_floats(M, np, L.C);  // 2n floats: a sampled symbol's s (in-kernel PAPR only)
  const int tid = threadIdx.x;
  const int run_id = clustered<J>(L) ? static_cast<int>(blockIdx.x) / L.C : static_cast<int>(blockIdx.x);
  const int base = slice_base<J>(L, 0);

  uint32_t be = 0, se = 0;
  float pk = 0.0f;
  double ps = 0.0;

  const int b0 = static_cast<int>(static_cast<long long>(run_id) * L.run);
  const int b1 = min(b0 + L.run, L.chunk);
  const bool counting = !kStaged || L.st.phase == 1;
  const bool normalize = kStaged && (L.st.bits & ofdm::kStageNormalize) != 0;
  // tile % run == 0: the run lies in one tile
  const int tile_id = b0 / L.tile;
  float sigma = 0.0f;
  if (L.add_noise) {
    const int tlen = min(L.tile, L.chunk - tile_id * L.tile);
    sigma = ofdm::tile_sigma(partials + tile_id * L.groups, L.groups, min(L.slice, tlen) * L.n, L.snr_lin,
                             L.pw_scale);
  }
  float fn = 1.0f, energy = 0.0f;
  if constexpr (kStaged) {
    if (normalize && counting) fn = L.st.norm_f[tile_id];
  }
  const bool papr = counting && !L.txext && tile_id % L.pstride == 0;  // one block a symbol only
  for (int i = tid; i < (M + 1) * L.nt; i += kThreads) ts[i] = make_float2(0.0f, 0.0f);
  __syncthreads();
  prev_tail<J, kMode, kStaged>(L, base, L.sym0 + static_cast<unsigned long long>(b0), wsum, cpart, ts);

  for (int g0 = b0; g0 < b1; g0 += M) {
    const int cnt = min(M, b1 - g0);
    const unsigned long long first = L.sym0 + static_cast<unsigned long long>(g0);
    float sr[M][J], si[M][J];
    encode_group<J, M, kMode, kStaged, true>(L, base, first, cnt, sr, si, zs, txs);
    if (L.nt > 0) tails_group<J, M>(L, base, sr, si, cnt, wsum, cpart, ts + L.nt, g0 > b0 ? ts : nullptr);

    if (papr) {
      // PAPR: x = s @ F_tx over each symbol's n bins, T time samples.
#pragma unroll
      for (int m = 0; m < M; ++m) {
        if (m < cnt) {
#pragma unroll
          for (int j = 0; j < J; ++j) {
            const int k = tid + kThreads * j;
            if (k < L.n) {
              splane[k] = sr[m][j];
              splane[L.n + k] = si[m][j];
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
      }
    }

    // g2 of the group's symbols, B^H's listed rows: one round drawn here,
    // more rounds drawn again for each j below
    const bool one_round = L.nbh <= kG2Round;
    if (L.rank > 0 && one_round && L.nbh > 0) {
      draw_g2(L, first, cnt, 0, L.nbh, R, gs);
      __syncthreads();
    }

    // y = s * D + corrections (+ noise) into the thread's slots; the MMSE
    // partials in j order
    float pn[M];
#pragma unroll
    for (int m = 0; m < M; ++m) pn[m] = 0.0f;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int k = base + tid + kThreads * j;
      const bool in = k < L.n;
      float yr[M], yi[M];
#pragma unroll
      for (int m = 0; m < M; ++m) {
        yr[m] = 0.0f;
        yi[m] = 0.0f;
      }
      if (in) {
        corrections<M>(L, k, ts, yr, yi);
        const float d_r = __ldg(L.dr + k);
        const float d_i = __ldg(L.di + k);
#pragma unroll
        for (int m = 0; m < M; ++m) {
          yr[m] = (sr[m][j] * d_r - si[m][j] * d_i) + yr[m];
          yi[m] = (sr[m][j] * d_i + si[m][j] * d_r) + yi[m];
        }
      }
      if (L.add_noise) {
        if (L.rank > 0) {
          // colored part: g2 @ B^H over the listed rows, in rounds
          float cr[M], ci[M];
#pragma unroll
          for (int m = 0; m < M; ++m) {
            cr[m] = 0.0f;
            ci[m] = 0.0f;
          }
          for (int r0 = 0; r0 < L.nbh; r0 += kG2Round) {
            const int rn = min(kG2Round, L.nbh - r0);
            if (!one_round) {
              __syncthreads();  // the previous round's draws are read
              draw_g2(L, first, cnt, r0, rn, R, gs);
              __syncthreads();
            }
            if (in) {
              for (int i = 0; i < rn; ++i) {
                const int row = __ldg(L.bh_rows + r0 + i);
                const float m_r = __ldg(L.bhr + row * L.n + k);
                const float m_i = __ldg(L.bhi + row * L.n + k);
#pragma unroll
                for (int m = 0; m < M; ++m) {
                  const float2 gv = gs[m * R + i];
                  cr[m] = cr[m] + (gv.x * m_r - gv.y * m_i);
                  ci[m] = ci[m] + (gv.x * m_i + gv.y * m_r);
                }
              }
            }
          }
          if (in) {
#pragma unroll
            for (int m = 0; m < M; ++m) {
              const float2 z = zs[(m * J + j) * kThreads + tid];
              const float zr = z.x + cr[m];
              const float zi = z.y + ci[m];
              yr[m] = yr[m] + sigma * zr;
              yi[m] = yi[m] + sigma * zi;
            }
          }
        } else if (in) {
#pragma unroll
          for (int m = 0; m < M; ++m) {
            const float2 z = zs[(m * J + j) * kThreads + tid];
            yr[m] = yr[m] + sigma * z.x;
            yi[m] = yi[m] + sigma * z.y;
          }
        }
      }
      if (in) {
#pragma unroll
        for (int m = 0; m < M; ++m) {
          pn[m] = pn[m] + (yr[m] * yr[m] + yi[m] * yi[m]);
          zs[(m * J + j) * kThreads + tid] = make_float2(yr[m], yi[m]);
        }
      }
    }
    float nv[M];
#pragma unroll
    for (int m = 0; m < M; ++m) nv[m] = 0.0f;
    if (L.eq.method == 1) {
      warp_sums<M>(pn, nvs);
      __syncthreads();
      const float* tot = clustered<J>(L) ? symbol_totals<J, M>(L, nvs, cpart) : nullptr;
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const float sp = (tot != nullptr ? tot[m] : warps_in_order<M>(nvs, m)) / static_cast<float>(L.n);
        nv[m] = sp / L.snr_lin / L.eq.cg;
      }
    }

    if constexpr (kStaged) {
      float p[M];
#pragma unroll
      for (int m = 0; m < M; ++m) p[m] = 0.0f;
#pragma unroll 1
      for (int j = 0; j < J; ++j) {
        const int k = base + tid + kThreads * j;
        if (k < L.n) {
#pragma unroll
          for (int m = 0; m < M; ++m) {
            if (m < cnt) {
              const int slot = (m * J + j) * kThreads + tid;
              const float2 y = zs[slot];
              float er, ei;
              ofdm::equalize_stage<kMode, true>(L, k, y.x, y.y, nv[m], er, ei);
              ofdm::bump_stages<kBump>(L, first + static_cast<unsigned long long>(m), k, er, ei);
              p[m] = p[m] + (er * er + ei * ei);
              if (!normalize || counting) {
                if (normalize) {
                  const float g = ofdm::norm_gain<kMode>(L, k, fn);
                  er = er * g;
                  ei = ei * g;
                }
                ofdm::dump_bin<kMode, kDump>(L, g0 + m, k, er, ei);
                ofdm::count_bin<kMode>(txs[slot], er, ei, L.q, L.lanes, k, be, se);
              }
            }
          }
        }
      }
      if (normalize && !counting) {
        warp_sums<M>(p, es);
        __syncthreads();
        if (clustered<J>(L)) {
          const float* tot = symbol_totals<J, M>(L, es, cpart);
          if (tid == 0) {
            for (int m = 0; m < cnt; ++m) energy = energy + tot[m];
          }
        } else if (tid == 0) {
          for (int m = 0; m < cnt; ++m) energy = energy + warps_in_order<M>(es, m);
        }
      }
    } else {
#pragma unroll 1
      for (int j = 0; j < J; ++j) {
        const int k = base + tid + kThreads * j;
        if (k < L.n) {
#pragma unroll
          for (int m = 0; m < M; ++m) {
            if (m < cnt) {
              const int slot = (m * J + j) * kThreads + tid;
              const float2 y = zs[slot];
              float er, ei;
              ofdm::equalize_bin<kMode>(L.eq, L.lanes, k, y.x, y.y, nv[m], er, ei);
              ofdm::count_bin<kMode>(txs[slot], er, ei, L.q, L.lanes, k, be, se);
            }
          }
        }
      }
    }

    if (counting && base == 0 && g0 <= L.chunk - 1 && L.chunk - 1 < g0 + cnt) {
      // the JAX carry contract: (T,) zero but for the last E lanes, this t
      const float2* t = ts + (L.chunk - g0) * L.nt;  // slot m + 1 of m = chunk - 1 - g0
      const int off = L.T - L.E;
      for (int c = tid; c < L.T; c += kThreads) {
        const int p = c >= off ? __ldg(L.tail_slot + c - off) : -1;
        carry_r[c] = p >= 0 ? t[p].x : 0.0f;
        carry_i[c] = p >= 0 ? t[p].y : 0.0f;
      }
    }
    __syncthreads();  // the t slots, g2 and the per-warp sums are rewritten by the next group
  }
  if constexpr (kStaged) {
    if (normalize && !counting && tid == 0 && base == 0 && b0 < L.chunk) L.st.norm_part[run_id] = energy;
  }

  ofdm::flush_counters<kWarps>(be, se, pk, ps, acc, psum);
}

// K3: symbol `sym`'s t through the chunk's own encode and tail pass, one
// block (a cluster of C past 4096 bins) of the chunk's shape, so the block
// sums run in lr_main's order: the (T,) carry row, zeros but for the last E
// lanes, and t (E lanes, zero where TailM's row is).
template <int J, int kMode, bool kStaged>
__global__ void __launch_bounds__(kThreads)
    lr_probe(Link L, unsigned long long sym, float* carry_r, float* carry_i, float* tail_r, float* tail_i) {
  extern __shared__ float dyn[];
  float2* t = reinterpret_cast<float2*>(dyn);
  float* wsum = dyn + 2 * 2 * L.nt;
  float* cpart = wsum + kWarps * 2 * min(L.nt, kTailPass);
  const int tid = threadIdx.x;
  const int base = slice_base<J>(L, 0);
  for (int i = tid; i < L.nt; i += kThreads) t[i] = make_float2(0.0f, 0.0f);
  __syncthreads();
  if (L.nt > 0) {
    float sr[1][J], si[1][J];
    encode_group<J, 1, kMode, kStaged, false>(L, base, sym, 1, sr, si, nullptr, nullptr);
    tails_group<J, 1>(L, base, sr, si, 1, wsum, cpart, t, nullptr);
  }
  if (base != 0) return;
  const int off = L.T - L.E;
  for (int c = tid; c < L.T; c += kThreads) {
    const int p = c >= off ? __ldg(L.tail_slot + c - off) : -1;
    carry_r[c] = p >= 0 ? t[p].x : 0.0f;
    carry_i[c] = p >= 0 ? t[p].y : 0.0f;
  }
  for (int e = tid; e < L.E; e += kThreads) {
    const int p = __ldg(L.tail_slot + e);
    tail_r[e] = p >= 0 ? t[p].x : 0.0f;
    tail_i[e] = p >= 0 ? t[p].y : 0.0f;
  }
}

template <int J, int kMode>
cudaError_t probe_at(const Link& L, unsigned long long sym, float* cr, float* ci, float* tr, float* ti,
                     cudaStream_t stream) {
  const int bytes = static_cast<int>(sizeof(float)) * tail_smem_floats(1, L.nt, L.C);
  return ofdm::launch_clusters(&lr_probe<J, kMode, ofdm::kStagedBuild>, dim3(L.C), kThreads, bytes, L.C, 0, stream,
                               L, sym, cr, ci, tr, ti);
}

// Bins a thread of a block's slice: 1 ... 16.
inline int bins_of(int n) { return ((n < kSliceBins ? n : kSliceBins) + kThreads - 1) / kThreads; }

template <int kMode>
cudaError_t probe_mode(const Link& L, unsigned long long sym, float* cr, float* ci, float* tr, float* ti,
                       cudaStream_t stream) {
  const int bins = bins_of(L.n);
  if (bins <= 1) return probe_at<1, kMode>(L, sym, cr, ci, tr, ti, stream);
  if (bins <= 2) return probe_at<2, kMode>(L, sym, cr, ci, tr, ti, stream);
  if (bins <= 4) return probe_at<4, kMode>(L, sym, cr, ci, tr, ti, stream);
  if (bins <= 8) return probe_at<8, kMode>(L, sym, cr, ci, tr, ti, stream);
  return probe_at<16, kMode>(L, sym, cr, ci, tr, ti, stream);
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
  const int fsize = static_cast<int>(sizeof(float));
  if (L.add_noise) {
    const int tiles = (L.chunk + L.tile - 1) / L.tile;
    const cudaError_t err = ofdm::launch_clusters(&lr_power<J, kMode, kS>, dim3(tiles, L.groups), kThreads,
                                                  fsize * tail_smem_floats(group_power(J), L.nt, L.C), L.C, 1,
                                                  stream, L, partials);
    if (err != cudaSuccess) return err;
  }
  const int bytes = fsize * main_smem_floats(group_of(J), J, L.n, L.nt, min(L.nbh, kG2Round), L.C, L.txext);
  const dim3 grid(((L.chunk + L.run - 1) / L.run) * L.C);
#if OFDM_STAGED
  return ofdm::staged_passes(L.st.bits, L.st.norm_part, L.st.norm_f, L.chunk, L.tile, L.run, L.n, stream,
                             [&](int phase) {
    Link P = L;
    P.st.phase = phase;
    return ofdm::launch_clusters(main_kernel, grid, kThreads, bytes, L.C, 0, stream, P, partials, acc, psum, cr,
                                 ci);
  });
#else
  return ofdm::launch_clusters(main_kernel, grid, kThreads, bytes, L.C, 0, stream, L, partials, acc, psum, cr, ci);
#endif
}

template <int kMode>
cudaError_t launch_mode(const Link& L, float* partials, unsigned long long* acc, double* psum,
                        float* cr, float* ci, cudaStream_t stream) {
  const int bins = bins_of(L.n);
  if (bins <= 1) return launch<1, kMode>(L, partials, acc, psum, cr, ci, stream);
  if (bins <= 2) return launch<2, kMode>(L, partials, acc, psum, cr, ci, stream);
  if (bins <= 4) return launch<4, kMode>(L, partials, acc, psum, cr, ci, stream);
  if (bins <= 8) return launch<8, kMode>(L, partials, acc, psum, cr, ci, stream);
  return launch<16, kMode>(L, partials, acc, psum, cr, ci, stream);
}

// lr_main's layout at J bins a thread, from its qam entry point of this
// build as the chunk launches it: out = [J, M, lr_power's group, dynamic
// shared bytes a block, registers a thread, local bytes a thread (spills
// and stack), static shared bytes, resident blocks an SM].
template <int J>
cudaError_t geometry_at(int n, int nt, int nbh, int txext, int* out) {
  auto* kernel = &lr_main<J, ofdm::kQam, ofdm::kStagedBuild, false, ofdm::kBumpBuild>;
  const int bytes = static_cast<int>(sizeof(float)) *
                    main_smem_floats(group_of(J), J, n, nt, nbh < kG2Round ? nbh : kG2Round, cluster_of(n), txext);
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  int blocks = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, bytes);
  if (err != cudaSuccess) return err;
  const int v[8] = {J, group_of(J), group_power(J), bytes, a.numRegs, static_cast<int>(a.localSizeBytes),
                    static_cast<int>(a.sharedSizeBytes), blocks};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return cudaSuccess;
}

inline bool width_ok(int n) { return n >= 1 && n <= kMaxN; }

}  // namespace ofdm_lr

using namespace ofdm_lr;

extern "C" {

// One chunk: lr_power (when noise is on) then lr_main, both on `stream`, in
// constellation mode `mode` (link_common.cuh::Mode; lane_i / lane_f the
// adaptive modes' lane rows); past 4096 subcarriers (txext only) as
// clusters of ceil(n / 4096) blocks.  acc = [bit errors, symbol
// errors, PAPR peak f32 bits] (int64, accumulated), psum = PAPR power sum
// (float64, accumulated); carry = (T,) zeros but for the last E lanes, the
// chunk's last symbol's t.  rows / stages / norm_part / norm_f: the _Spec
// stages (link_common.cuh::Stages; 0 in the plain build).  table / nt / ncc
// / nbh: the row table (lr_kernel.row_table, on the device) and its counts
// of TailM, [Cr; Cp] and B^H rows.  Returns the first CUDA error of the
// launches, 0 if none.
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
                    const float* prev_i, const int* table, int nt, int ncc, int nbh, void* stream_ptr) {
  if (!width_ok(n) || T < n || E < 1 || E > T || rank < 0 || (n > kSliceBins && !txext) ||
      (prev_r == nullptr) != (prev_i == nullptr) || table == nullptr || nt < 0 || nt > E || ncc < 0 ||
      ncc > 2 * E || nbh < 0 || nbh > rank ||
      chunk < 1 || tile < 1 || slice < 1 || groups < 1 || run < 1 ||
      tile % run != 0 || run % group_of(bins_of(n)) != 0 || groups % cluster_of(n) != 0 ||
      !ofdm::stage_args_ok(rows, stages, norm_part, norm_f, dump_r, dump_i, dump_rows, ofdm::kBumpBuild) ||
      pstride < 1 || (!txext && (fr == nullptr || fi == nullptr)) ||
      (add_noise && nbh > 0 && (bhr == nullptr || bhi == nullptr)) ||
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
  L.C = cluster_of(n);
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
  L.tail_rows = table;
  L.tail_slot = table + nt;
  L.cc_rows = table + nt + E;
  L.cc_off = table + nt + E + ncc;
  L.bh_rows = table + nt + E + 2 * ncc;
  L.nt = nt;
  L.ncc = ncc;
  L.nbh = L.rank > 0 ? nbh : 0;

  unsigned long long* a = reinterpret_cast<unsigned long long*>(acc);
  return static_cast<int>(ofdm::with_mode(mode, [&](auto md) {
    return launch_mode<decltype(md)::value>(L, partials, a, psum, carry_r, carry_i, stream);
  }));
}

// K3, the carry probe: run symbol `sym`'s (T,) carry row (carry_r /
// carry_i: zeros but for the last E lanes, its t) and t (tail_r / tail_i,
// E each), through the chunk's encode and tail pass in mode `mode`
// (apply_power only: `rows` and the stage bits) over TailM's listed rows
// (the row table's first nt entries, then each lane's place among them).
// The chunk of run symbols [sym0, sym0 + chunk) returns symbol sym0 + chunk
// - 1's row as its carry.  Returns the launch's CUDA error, 0 if none.
int ofdm_lr_probe(const float* tlr, const float* tli, int n, int T, int E, int mode, int order, int m,
                  int logm, int bits, int gray, float scale, const int* lane_i, const float* lane_f,
                  unsigned long long sym, unsigned int key0, unsigned int key1, const float* rows,
                  int stages, float* carry_r, float* carry_i, float* tail_r, float* tail_i,
                  const int* table, int nt, void* stream_ptr) {
  if (!width_ok(n) || T < n || E < 1 || E > T || (stages & ~ofdm::kStagePower) || table == nullptr || nt < 0 ||
      nt > E || !ofdm::stage_args_ok(rows, stages, nullptr, nullptr, nullptr, nullptr, 0, false) ||
      (ofdm::adaptive(mode) && (lane_i == nullptr || lane_f == nullptr))) {
    return cudaErrorInvalidValue;
  }
  Link L{};
  L.tlr = tlr;
  L.tli = tli;
  L.n = n;
  L.T = T;
  L.E = E;
  L.C = cluster_of(n);
  L.q = ofdm::Qam{order, m, logm, bits, gray, scale};
  L.lanes = ofdm::Lanes{lane_i, lane_f, n};
  L.key = make_uint2(key0, key1);
  L.st = ofdm::make_stages(rows, stages, nullptr, nullptr, nullptr, nullptr, 0);
  L.tail_rows = table;
  L.tail_slot = table + nt;
  L.nt = nt;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  return static_cast<int>(ofdm::with_mode(mode, [&](auto md) {
    return probe_mode<decltype(md)::value>(L, sym, carry_r, carry_i, tail_r, tail_i, stream);
  }));
}

// lr_main's layout on a link of n bins with nt listed tail lanes and nbh
// listed rows of B^H (0 without noise) (geometry_at's eight ints into out).
// A layout whose shared memory the card cannot give a block returns the
// CUDA error of setting it.  Returns 0 if none.
int ofdm_lr_geometry(int n, int nt, int nbh, int txext, int* out) {
  if (!width_ok(n) || nt < 0 || nbh < 0 || out == nullptr || (n > kSliceBins && !txext)) {
    return cudaErrorInvalidValue;
  }
  const int bins = bins_of(n);
  if (bins <= 1) return static_cast<int>(geometry_at<1>(n, nt, nbh, txext, out));
  if (bins <= 2) return static_cast<int>(geometry_at<2>(n, nt, nbh, txext, out));
  if (bins <= 4) return static_cast<int>(geometry_at<4>(n, nt, nbh, txext, out));
  if (bins <= 8) return static_cast<int>(geometry_at<8>(n, nt, nbh, txext, out));
  return static_cast<int>(geometry_at<16>(n, nt, nbh, txext, out));
}

const char* ofdm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
