// The symbol pipeline the wide dense chunk kernels share (fold_wide_kernel.cu,
// mm_wide_kernel.cu): one block of 256 threads a symbol, the symbol's
// planes in shared memory.
//
// In place of the TPU kernel's dense products (x = s @ F_tx,ext, y = act @
// CM or act @ C, Y = y @ R, e @ IDFT; pallas_link.py "mm" / "mm4"):
//   TX     SC-FDE copies s into its block; OFDM takes the block IDFT; then
//          the guard of L = T - n samples: a cyclic prefix repeats the last
//          L, a zero prefix appends L zeros (linops.tx_matrix's rows)
//   conv   the direct K-tap stream convolution over z = [the previous
//          symbol's tail x[T-E:T) | x], K = E + 1 unit-energy taps, each
//          output a k-ascending sum of rounded terms
//          (linops.conv_matrix_merged's rows, ops/link_kernel.py::stream_conv)
// The block transforms run staged (wide_dft.cuh) at n = 256 J, through
// block_dft.cuh at any other n.  The plain versions
// (ops/link_kernel.py::wide_tx, wide_stream, stream_conv; ops/dft.py::
// block_dft) repeat every operation in order.
//
// A block walks `run` consecutive symbols.  z is double-buffered: symbol b
// writes its block into one buffer and copies symbol b-1's tail out of the
// other, so a symbol's TX waits for no reader of the previous one.  For its
// first symbol a block recomputes symbol b-1's TX block from Philox (or
// reads the carry-in of a sharded stream, or zeros for the run's symbol 0),
// as the narrow chains do (group_prev_tail, lr's prev_tail).  The taps and the staged
// twiddles are loaded into shared memory once a block.
//
// Shared memory a block (float2 entries): two z buffers of E + T samples
// (sample a at a + a/16), two exchange buffers and the twiddle table of the
// staged transform (wide_dft.cuh; the unstaged transform's planes alias the
// exchange buffers), the K taps.

#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "block_dft.cuh"
#include "link_common.cuh"
#include "wide_dft.cuh"

namespace ofdm {

constexpr int kWideWarps = 8;
constexpr int kWideThreads = 32 * kWideWarps;
constexpr int kWideMaxN = 2048;  // up to 8 slots a thread
constexpr int kWidePowerSteps = 16;
constexpr int kWidePowerBlock = kWidePowerSteps * kWideThreads;  // elements per power block
// Blocks of a main kernel a multiprocessor keeps resident (its
// __launch_bounds__) at J slots a thread: five at 2 (48 registers), four
// at 4 and 8 (64), the fastest of 3-5 on an H100 (port_ab.py
// --bounds-study, which builds the wide sources with OFDM_WIDE_MIN_BLOCKS
// set for every J).
__host__ __device__ constexpr int wide_min_blocks(int J) {
#ifdef OFDM_WIDE_MIN_BLOCKS
  return J > 0 ? OFDM_WIDE_MIN_BLOCKS : 0;
#else
  return J == 2 ? 5 : 4;
#endif
}

// Everything a wide chunk reads.  Thread t holds the slots i = t + 256 j
// (j < J): bins on fold_wide, time samples (and the guard samples n + i) on
// mm_wide.
struct WideLink {
  Equalizer eq;
  const float* tpr;  // (K,) unit-energy taps, K = E + 1
  const float* tpi;
  DftPlan dft;
  int n;
  int T;
  int E;  // previous-symbol tail samples (linops.ext_width)
  int L;  // guard samples, T - n
  Qam q;
  float snr_lin;
  int add_noise;
  int is_sc;
  unsigned long long sym0;  // run index of the chunk's first symbol
  int chunk;
  int tile;
  int slice;   // symbols of a tile in the measured power (mm_wide: the tile)
  int groups;  // power blocks a tile
  int run;     // consecutive symbols a block walks
  uint2 key;
  Lanes lanes;  // the adaptive modes' lane rows
  Stages st;    // the _Spec stages (OFDM_STAGED builds)
  const float* prev_r;  // (E,) tail the chunk's first symbol reads, or null
  const float* prev_i;
};

// Where z sample a lives in a z buffer.
__host__ __device__ __forceinline__ int zaddr(int a) { return a + (a >> 4); }
__host__ __device__ __forceinline__ int wide_zlen(int T, int E) { return zaddr(E + T - 1) + 1; }

// Whether a link's transform runs staged at J slots a thread.
template <int J>
__host__ __device__ __forceinline__ bool wide_staged(const DftPlan& p) {
  return p.log2n == stage_log2n(J);
}

// float2 entries of a block's shared planes at J slots a thread.
template <int J>
__host__ __device__ __forceinline__ int wide_float2s(int n, int T, int E, int log2n) {
  const int tw = log2n == stage_log2n(J) ? 256 * J : 0;
  return 2 * wide_zlen(T, E) + 2 * stage_buf_len(256 * J) + tw + (E + 1);
}

// A block's shared planes.
struct WideBufs {
  float2* zc;  // the current symbol's z = [tail | x]
  float2* zp;  // the previous symbol's
  const float2* taps;
  WideDft dft;
  float* ar;  // the unstaged transform's planes (n floats each)
  float* ai;
  float* br;
  float* bi;

  __device__ __forceinline__ void swap_z() {
    float2* t = zc;
    zc = zp;
    zp = t;
  }
};

// Carve the planes out of `base`, stage the taps (and the twiddles when the
// transform runs staged), and synchronize.
template <int J>
__device__ __forceinline__ WideBufs wide_setup(const WideLink& L, float2* base) {
  WideBufs w;
  const int zl = wide_zlen(L.T, L.E);
  const int bl = stage_buf_len(256 * J);
  w.zc = base;
  w.zp = base + zl;
  float2* x0 = base + 2 * zl;
  float2* x1 = x0 + bl;
  float2* tw = x1 + bl;
  const bool staged = wide_staged<J>(L.dft);
  float2* taps = tw + (staged ? 256 * J : 0);
  w.dft.cur = x0;
  w.dft.nxt = x1;
  w.dft.tw = tw;
  w.taps = taps;
  w.ar = reinterpret_cast<float*>(x0);
  w.ai = w.ar + L.n;
  w.br = reinterpret_cast<float*>(x1);
  w.bi = w.br + L.n;
  if (L.tpr != nullptr) {
    for (int k = threadIdx.x; k <= L.E; k += kWideThreads) taps[k] = make_float2(__ldg(L.tpr + k), __ldg(L.tpi + k));
  }
  if (staged) stage_twiddles(L.dft, tw);
  __syncthreads();
  return w;
}

// The scaled (I)DFT of the n values held in natural order (slot j of
// thread t: index t + 256 j), in place; slots past n read 0 afterwards.
template <int J, bool kInv>
__device__ __forceinline__ void wide_transform(const WideLink& L, WideBufs& w, float (&xr)[J], float (&xi)[J]) {
  const int n = L.n;
  if (wide_staged<J>(L.dft)) {
    staged_dft_natural<J, kInv>(xr, xi, w.dft);
  } else {
    __syncthreads();  // the planes' last readers are done
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int k = threadIdx.x + kWideThreads * j;
      if (k < n) {
        const int s = dft_slot(L.dft, k);
        w.ar[s] = xr[j];
        w.ai[s] = xi[j];
      }
    }
    block_dft<kWideThreads>(L.dft, w.ar, w.ai, w.br, w.bi, kInv);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int k = threadIdx.x + kWideThreads * j;
      xr[j] = k < n ? w.ar[k] : 0.0f;
      xi[j] = k < n ? w.ai[k] : 0.0f;
    }
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    xr[j] = xr[j] * L.dft.scale;
    xi[j] = xi[j] * L.dft.scale;
  }
}

// y[j] = sum_k h[k] z[E + m - k], k ascending, at samples m = m0 + 256 o
// < count (0 elsewhere), o = j, or stage_slot_rev(J, j) for the staged
// transform's first round (kRev): each tap read once for the J outputs,
// each z a float2.
template <int J, bool kRev>
__device__ __forceinline__ void conv_slots(const WideLink& L, const WideBufs& w, int m0, int count, float (&yr)[J],
                                           float (&yi)[J]) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    yr[j] = 0.0f;
    yi[j] = 0.0f;
  }
  if (m0 >= count) return;
  for (int k = 0; k <= L.E; ++k) {
    const float2 h = w.taps[k];
    const float2* zk = w.zc + zaddr(L.E + m0 - k);  // sample + 256 o at + 272 o
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int o = kRev ? stage_slot_rev(J, j) : j;
      if (m0 + 256 * o < count) {
        const float2 v = zk[272 * o];
        yr[j] = yr[j] + (v.x * h.x - v.y * h.y);
        yi[j] = yi[j] + (v.x * h.y + v.y * h.x);
      }
    }
  }
}

// Symbol `sym`'s TX block x into zc[E, E + T), after swapping the z buffers,
// and the previous symbol's tail zp[T, T + E) into zc[0, E).  Bin i = t +
// 256 j < n draws Philox counter (sym, i, 0): its word 0 encodes s[i]
// (tx[j], scaled under apply_power), w1 / w2 keep words 1 and 2 (the noise
// of bin or time sample i).  Ends with __syncthreads.
template <int J, int kMode, bool kStaged, bool kZp>
__device__ void wide_tx(const WideLink& L, WideBufs& w, unsigned long long sym, int (&tx)[J], uint32_t (&w1)[J],
                        uint32_t (&w2)[J]) {
  w.swap_z();
  const int n = L.n;
  const int head = kZp ? 0 : L.L;  // x[head + k] = t[k]
  for (int e = threadIdx.x; e < L.E; e += kWideThreads) w.zc[zaddr(e)] = w.zp[zaddr(L.T + e)];
  float sr[J], si[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int i = static_cast<int>(threadIdx.x) + kWideThreads * j;
    tx[j] = 0;
    w1[j] = 0u;
    w2[j] = 0u;
    sr[j] = 0.0f;
    si[j] = 0.0f;
    if (i < n) {
      const uint4 wd = symbol_words(sym, i, L.key);
      w1[j] = wd.y;
      w2[j] = wd.z;
      tx[j] = encode<kMode>(wd.x, L.q, L.lanes, i, sr[j], si[j]);
      scale_tx<kStaged>(L, i, sr[j], si[j]);
    }
  }
  if (L.is_sc == 0) wide_transform<J, true>(L, w, sr, si);
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int i = static_cast<int>(threadIdx.x) + kWideThreads * j;
    if (i < n) {
      const float2 v = make_float2(sr[j], si[j]);
      w.zc[zaddr(L.E + head + i)] = v;
      if (!kZp && i >= n - L.L) w.zc[zaddr(L.E + i - (n - L.L))] = v;
    }
  }
  if (kZp) {
    for (int m = n + static_cast<int>(threadIdx.x); m < L.T; m += kWideThreads) {
      w.zc[zaddr(L.E + m)] = make_float2(0.0f, 0.0f);
    }
  }
  __syncthreads();
}

// PAPR max and sum over x[0:T) of the block in zc; the carry row when
// carry_r is set.
__device__ __forceinline__ void wide_papr(const WideLink& L, const WideBufs& w, float& pk, double& ps,
                                          float* carry_r, float* carry_i) {
  for (int m = threadIdx.x; m < L.T; m += kWideThreads) {
    const float2 x = w.zc[zaddr(L.E + m)];
    const float pw = x.x * x.x + x.y * x.y;
    pk = fmaxf(pk, pw);
    ps += static_cast<double>(pw);
    if (carry_r != nullptr) {
      carry_r[m] = x.x;
      carry_i[m] = x.y;
    }
  }
}

// The tail symbol `sym` reads, into zc[T, T + E) for wide_tx to copy: the
// carry-in for the chunk's first symbol when the link carries one, zeros
// for the run's symbol 0, else symbol sym - 1's block, recomputed.  Ends
// with __syncthreads.
template <int J, int kMode, bool kStaged, bool kZp>
__device__ void wide_prev(const WideLink& L, WideBufs& w, unsigned long long sym) {
  if (L.E == 0) return;
  if (L.prev_r != nullptr && sym == L.sym0) {
    for (int e = threadIdx.x; e < L.E; e += kWideThreads) w.zc[zaddr(L.T + e)] = make_float2(L.prev_r[e], L.prev_i[e]);
  } else if (sym == 0) {
    for (int e = threadIdx.x; e < L.E; e += kWideThreads) w.zc[zaddr(L.T + e)] = make_float2(0.0f, 0.0f);
  } else {
    int tx[J];
    uint32_t w1[J], w2[J];
    wide_tx<J, kMode, kStaged, kZp>(L, w, sym - 1, tx, w1, w2);
  }
  __syncthreads();
}

// Sum of one value a thread over the block in block_sum's order
// (link_common.cuh), without its closing barrier: the caller makes sure a
// __syncthreads separates this call's reads of `wsum` from the next write.
template <int kWarps>
__device__ __forceinline__ float block_sum_once(float v, float* wsum) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = v + __shfl_xor_sync(0xFFFFFFFFu, v, off);
  if ((threadIdx.x & 31) == 0) wsum[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.0f;
  for (int w = 0; w < kWarps; ++w) s = s + wsum[w];
  return s;
}

// The MMSE mean of a symbol a block (per-thread sum in j order, then the
// block sum) on block_sum_once: the wide mains call it once a symbol, and
// the symbol's TX ends with a barrier.
template <int J>
__device__ __forceinline__ float wide_mmse_nv(const WideLink& L, const float (&yr)[J], const float (&yi)[J],
                                              float* wsum) {
  if (L.eq.method != 1) return 0.0f;
  float p = 0.0f;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    if (static_cast<int>(threadIdx.x) + kWideThreads * j < L.n) p = p + (yr[j] * yr[j] + yi[j] * yi[j]);
  }
  const float sp = block_sum_once<kWideWarps>(p, wsum) / static_cast<float>(L.n);
  return sp / L.snr_lin / L.eq.cg;
}

// K3 of a wide chain: symbol `sym`'s carry row x[0:T) and tail x[T-E:T)
// through the chunk's TX stage, one block.
template <int J, int kMode, bool kStaged, bool kZp>
__global__ void __launch_bounds__(kWideThreads)
    wide_probe(WideLink L, unsigned long long sym, float* carry_r, float* carry_i, float* tail_r, float* tail_i) {
  extern __shared__ float2 smem2[];
  WideBufs w = wide_setup<J>(L, smem2);
  int tx[J];
  uint32_t w1[J], w2[J];
  wide_tx<J, kMode, kStaged, kZp>(L, w, sym, tx, w1, w2);
  for (int m = threadIdx.x; m < L.T; m += kWideThreads) {
    const float2 x = w.zc[zaddr(L.E + m)];
    carry_r[m] = x.x;
    carry_i[m] = x.y;
  }
  for (int e = threadIdx.x; e < L.E; e += kWideThreads) {
    const float2 x = w.zc[zaddr(L.T + e)];
    tail_r[e] = x.x;
    tail_i[e] = x.y;
  }
}

// The link of a wide entry point's arguments (the stage fields and the
// carry-in set by the caller).
inline WideLink make_wide_link(const float* tpr, const float* tpi, const float* twr, const float* twi,
                               const Equalizer& eq, int n, int T, int E, int n1, int n2, int log2n,
                               float dscale, const Qam& q, const int* lane_i, const float* lane_f,
                               int is_sc, unsigned int key0, unsigned int key1) {
  WideLink L{};
  L.eq = eq;
  L.tpr = tpr;
  L.tpi = tpi;
  L.dft = DftPlan{twr, twi, n, n1, n2, log2n, dscale};
  L.n = n;
  L.T = T;
  L.E = E;
  L.L = T - n;
  L.q = q;
  L.is_sc = is_sc;
  L.key = make_uint2(key0, key1);
  L.lanes = Lanes{lane_i, lane_f, n};
  return L;
}

// Whether a wide link's shape arguments are ones the kernels take: 1 <= n
// <= kWideMaxN, n <= T <= n + n, 0 <= E <= T, the DFT split consistent.
inline bool wide_shape_ok(int n, int T, int E, int n1, int n2, int log2n, const float* twr, const float* twi) {
  if (n < 1 || n > kWideMaxN || T < n || T - n > n || E < 0 || E > T || twr == nullptr || twi == nullptr) {
    return false;
  }
  if (log2n >= 0) return log2n < 31 && (1 << log2n) == n;
  return log2n == -1 && n1 >= 1 && n2 >= 1 && n1 * n2 == n;
}

// Slots a thread at n bins, rounded up to a compiled width: 2, 4 or 8.
inline int wide_slots(int n) {
  const int s = (n + kWideThreads - 1) / kWideThreads;
  return s <= 2 ? 2 : (s <= 4 ? 4 : 8);
}

// The largest dynamic shared memory a block may ask for on the card.
constexpr size_t kWideMaxShared = 227 * 1024;

// A wide kernel's layout with `bytes` of dynamic shared memory into
// out[0..4): registers, local bytes a thread, shared bytes a block (static
// and dynamic), resident blocks an SM.
template <class K>
cudaError_t wide_layout(K* k, size_t bytes, int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, k);
  if (err == cudaSuccess && bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  }
  int blocks = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, kWideThreads, bytes);
  if (err != cudaSuccess) return err;
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes + bytes);
  out[3] = blocks;
  return cudaSuccess;
}

// f(std::integral_constant<int, J>) at the compiled width of n bins.
template <class F>
cudaError_t with_slots(int n, F&& f) {
  const int s = wide_slots(n);
  if (s == 2) return f(std::integral_constant<int, 2>());
  if (s == 4) return f(std::integral_constant<int, 4>());
  return f(std::integral_constant<int, 8>());
}

}  // namespace ofdm
