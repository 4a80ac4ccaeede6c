// The symbol pipeline the wide dense chunk kernels share (fold_wide_kernel.cu,
// mm_wide_kernel.cu): one block of 256 threads a symbol, the symbol's
// planes in shared memory.
//
// In place of the TPU kernel's dense products (x = s @ F_tx,ext, y = act @
// CM or act @ C, Y = y @ R, e @ IDFT; pallas_link.py "mm" / "mm4"):
//   TX     SC-FDE copies s into its block; OFDM takes the block IDFT
//          (block_dft.cuh); then the guard of L = T - n samples: a cyclic
//          prefix repeats the last L, a zero prefix appends L zeros
//          (linops.tx_matrix's rows)
//   conv   the direct K-tap stream convolution over z = [the previous
//          symbol's tail x[T-E:T) | x], K = E + 1 unit-energy taps, each
//          output a k-ascending sum of rounded terms
//          (linops.conv_matrix_merged's rows, ops/link_kernel.py::stream_conv)
// The plain versions (ops/link_kernel.py::wide_tx, wide_stream,
// stream_conv; ops/dft.py::block_dft) repeat every operation in order.
//
// A block walks `run` consecutive symbols and keeps the previous symbol's
// tail in shared memory; for its first symbol it recomputes symbol b-1's TX
// block from Philox (or reads the carry-in of a sharded stream, or zeros for
// the run's symbol 0), as the warp-per-symbol chains do (prev_tail).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "block_dft.cuh"
#include "link_common.cuh"

namespace ofdm {

constexpr int kWideWarps = 8;
constexpr int kWideThreads = 32 * kWideWarps;
constexpr int kWideMaxN = 2048;  // up to 8 bins a thread
constexpr int kWidePowerSteps = 16;
constexpr int kWidePowerBlock = kWidePowerSteps * kWideThreads;  // elements per power block
// Blocks of a main kernel a multiprocessor keeps resident (its
// __launch_bounds__): four, which caps a thread at 64 registers.  On an
// H100 that ran 1.12-1.17x faster at 1024 subcarriers than the 128
// registers ptxas picks unbounded (two blocks): a symbol's ~15 barriers
// want more blocks to hide them, even where 8 slots a thread then spill
// (mm_wide at T = 1031).
constexpr int kWideMinBlocks = 4;

// Everything a wide chunk reads.  Thread t holds the slots i = t + 256 j
// (j < J): bins on fold_wide, time samples on mm_wide.
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

// A block's shared planes: z = [tail | x] (E + T complex), the DFT's data
// and scratch (n complex each) and, on mm_wide, the noisy time samples (T
// complex).
struct WideBufs {
  float* zr;
  float* zi;
  float* ar;
  float* ai;
  float* br;
  float* bi;
  float* yr;
  float* yi;
};

__host__ __device__ __forceinline__ int wide_floats(int n, int T, int E, bool ybuf) {
  return 2 * (E + T) + 4 * n + (ybuf ? 2 * T : 0);
}

__device__ __forceinline__ WideBufs wide_bufs(int n, int T, int E, float* base) {
  WideBufs w;
  w.zr = base;
  w.zi = w.zr + E + T;
  w.ar = w.zi + E + T;
  w.ai = w.ar + n;
  w.br = w.ai + n;
  w.bi = w.br + n;
  w.yr = w.bi + n;
  w.yi = w.yr + T;
  return w;
}

// Symbol `sym`'s TX block x into z[E, E + T).  Slot i = t + 256 j < limit
// draws Philox counter (sym, i, 0): below n its word 0 encodes s[i] (tx[j],
// scaled under apply_power), and w1 / w2 keep words 1 and 2 (the noise of
// bin or time sample i).  Starts and ends with __syncthreads.
template <int J, int kMode, bool kStaged, bool kZp>
__device__ void wide_tx(const WideLink& L, const WideBufs& w, unsigned long long sym, int limit, int (&tx)[J],
                        uint32_t (&w1)[J], uint32_t (&w2)[J]) {
  __syncthreads();
  const int n = L.n;
  const int head = kZp ? 0 : L.L;  // x[head + k] = t[k]
  const bool sc = L.is_sc != 0;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int i = static_cast<int>(threadIdx.x) + kWideThreads * j;
    tx[j] = 0;
    w1[j] = 0u;
    w2[j] = 0u;
    if (i < limit) {
      const uint4 wd = symbol_words(sym, i, L.key);
      w1[j] = wd.y;
      w2[j] = wd.z;
      if (i < n) {
        float sr, si;
        tx[j] = encode<kMode>(wd.x, L.q, L.lanes, i, sr, si);
        scale_tx<kStaged>(L, i, sr, si);
        if (sc) {
          w.zr[L.E + head + i] = sr;
          w.zi[L.E + head + i] = si;
          if (!kZp && i >= n - L.L) {
            w.zr[L.E + i - (n - L.L)] = sr;
            w.zi[L.E + i - (n - L.L)] = si;
          }
        } else {
          const int s = dft_slot(L.dft, i);
          w.ar[s] = sr;
          w.ai[s] = si;
        }
      }
    }
  }
  if (kZp) {
    for (int m = n + static_cast<int>(threadIdx.x); m < L.T; m += kWideThreads) {
      w.zr[L.E + m] = 0.0f;
      w.zi[L.E + m] = 0.0f;
    }
  }
  if (!sc) {
    block_dft<kWideThreads>(L.dft, w.ar, w.ai, w.br, w.bi, true);
    for (int k = threadIdx.x; k < n; k += kWideThreads) {
      const float vr = w.ar[k] * L.dft.scale;
      const float vi = w.ai[k] * L.dft.scale;
      w.zr[L.E + head + k] = vr;
      w.zi[L.E + head + k] = vi;
      if (!kZp && k >= n - L.L) {
        w.zr[L.E + k - (n - L.L)] = vr;
        w.zi[L.E + k - (n - L.L)] = vi;
      }
    }
  }
  __syncthreads();
}

// PAPR max and sum over x[0:T) of the block in z; the carry row when
// carry_r is set.
__device__ __forceinline__ void wide_papr(const WideLink& L, const WideBufs& w, float& pk, double& ps,
                                          float* carry_r, float* carry_i) {
  for (int m = threadIdx.x; m < L.T; m += kWideThreads) {
    const float xr = w.zr[L.E + m];
    const float xi = w.zi[L.E + m];
    const float pw = xr * xr + xi * xi;
    pk = fmaxf(pk, pw);
    ps += static_cast<double>(pw);
    if (carry_r != nullptr) {
      carry_r[m] = xr;
      carry_i[m] = xi;
    }
  }
}

// y[m] = sum_k h[k] z[E + m - k], k ascending.
__device__ __forceinline__ void conv_at(const WideLink& L, const WideBufs& w, int m, float& yr, float& yi) {
  float sr = 0.0f, si = 0.0f;
  for (int k = 0; k <= L.E; ++k) {
    const float a = w.zr[L.E + m - k];
    const float c = w.zi[L.E + m - k];
    const float hr = __ldg(L.tpr + k);
    const float hi = __ldg(L.tpi + k);
    sr = sr + (a * hr - c * hi);
    si = si + (a * hi + c * hr);
  }
  yr = sr;
  yi = si;
}

// z[0, E) <- z[T, T + E): this symbol's tail, which the next reads.  The
// caller synchronizes after the convolution has read z and before the next
// symbol's TX writes it (wide_tx starts with __syncthreads).
__device__ __forceinline__ void wide_shift_tail(const WideLink& L, const WideBufs& w) {
  for (int e = threadIdx.x; e < L.E; e += kWideThreads) {
    w.zr[e] = w.zr[L.T + e];
    w.zi[e] = w.zi[L.T + e];
  }
}

// z[0, E) <- the tail symbol `sym` reads: the carry-in for the chunk's first
// symbol when the link carries one, zeros for the run's symbol 0, else symbol
// sym - 1's, recomputed.  Ends with __syncthreads.
template <int J, int kMode, bool kStaged, bool kZp>
__device__ void wide_prev(const WideLink& L, const WideBufs& w, unsigned long long sym) {
  if (L.E == 0) return;
  if (L.prev_r != nullptr && sym == L.sym0) {
    for (int e = threadIdx.x; e < L.E; e += kWideThreads) {
      w.zr[e] = L.prev_r[e];
      w.zi[e] = L.prev_i[e];
    }
  } else if (sym == 0) {
    for (int e = threadIdx.x; e < L.E; e += kWideThreads) {
      w.zr[e] = 0.0f;
      w.zi[e] = 0.0f;
    }
  } else {
    int tx[J];
    uint32_t w1[J], w2[J];
    wide_tx<J, kMode, kStaged, kZp>(L, w, sym - 1, L.n, tx, w1, w2);
    wide_shift_tail(L, w);
  }
  __syncthreads();
}

// K3 of a wide chain: symbol `sym`'s carry row x[0:T) and tail x[T-E:T)
// through the chunk's TX stage, one block.
template <int J, int kMode, bool kStaged, bool kZp>
__global__ void __launch_bounds__(kWideThreads)
    wide_probe(WideLink L, unsigned long long sym, float* carry_r, float* carry_i, float* tail_r, float* tail_i) {
  extern __shared__ float smem[];
  const WideBufs w = wide_bufs(L.n, L.T, L.E, smem);
  int tx[J];
  uint32_t w1[J], w2[J];
  wide_tx<J, kMode, kStaged, kZp>(L, w, sym, L.n, tx, w1, w2);
  for (int m = threadIdx.x; m < L.T; m += kWideThreads) {
    carry_r[m] = w.zr[L.E + m];
    carry_i[m] = w.zi[L.E + m];
  }
  for (int e = threadIdx.x; e < L.E; e += kWideThreads) {
    tail_r[e] = w.zr[L.T + e];
    tail_i[e] = w.zi[L.T + e];
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

}  // namespace ofdm
