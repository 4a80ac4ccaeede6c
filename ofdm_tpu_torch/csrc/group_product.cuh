// The grouped, listed-term design of the narrow dense chunk kernels (fold,
// mm; csrc/{fold,mm}_kernel.cu include it, nothing else does, so the other
// chunk kernels compile from the code they had).
//
// A warp walks its run of consecutive symbols in groups of S
// (group_of(J)).  A group's activations sit in the warp's shared memory as
// float2 rows [k][S] (row k holds input k of the S symbols; S is even, so a
// row loads 16 bytes at a time), and each complex product runs over the
// group at once: lane l computes output column c = 32 j + l of chunk j for
// all S symbols in registers, so each matrix element it loads is applied to
// S symbols, and lanes read one row of the group's inputs together (a
// broadcast where the chunk's columns share their rows: every dense matrix).
//
// The products read only a matrix's listed terms (ops/terms.py::term_list):
// each column's nonzero rows, split at gaps of 16 rows or more into
// clusters; the q-th clusters of a chunk's 32 columns form its segment q,
// whose lanes run `trip` terms from their own first row lo.  An element of
// the window outside the lane's cluster is packed as zero.  Each output is
// then a sum over its nonzero rows in ascending order, each term
// (a*m_r - c*m_i), (a*m_i + c*m_r) rounded before it is added (-fmad=false),
// starting at +0, as the plain version's cmatmul; the terms cmatmul adds
// that this skips are a*0 - c*0 = +-0 (the inputs are finite), and a sum
// that starts at +0 is never -0 under round-to-nearest, so adding +-0
// changes no bit.  A copy column (one element, 1 + 0i) gives 0 + a; a
// column without terms gives +0, as cmatmul does.
//
// The per-symbol chain (noise, equalizer, SC-FDE slicer row, stages,
// counts) runs as before, one symbol at a time, lane l holding bins
// l + 32 j: the MMSE mean and the normalization energy keep their order.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "link_common.cuh"

namespace ofdm {

constexpr int kGroupWarps = 8;  // warps a block at most: each walks its own runs
constexpr int kMaxBlockSmem = 227 * 1024;
// Matrix elements a lane loads ahead of the terms that use them, at most;
// term_list pads the packed elements with as many zero rows, so the loads
// past a segment's last term stay inside the array.
constexpr int kAhead = 4;

// Symbols a group holds at J bins a lane: 4 up to 64 subcarriers, 2 beyond,
// where the TX indices and noise words of the group's symbols ([S][J] each,
// in registers) and the wider rows take more room.
__host__ __device__ constexpr int group_of(int J) { return J <= 2 ? 4 : 2; }

// A matrix's listed terms, as term_list packs them (device memory): chunk
// j (output columns 32 j ... 32 j + 31) runs segments seg[j] ... seg[j+1]
// - 1; segment q reads rows lo[32 q + lane] + i for i < off[q+1] - off[q],
// its elements at p[32 (off[q] + i) + lane], kAhead zero rows after the
// last.  idx = seg (chunks + 1) | off (segments + 1) | lo (32 segments);
// the segments' count seg[chunks] is read on the device (terms_lo).
struct Terms {
  const float2* p;
  const int* seg;
  int chunks;
};

__host__ __device__ __forceinline__ Terms make_terms(const float* p, const int* idx, int chunks) {
  return Terms{reinterpret_cast<const float2*>(p), idx, chunks};
}

__device__ __forceinline__ const int* terms_off(const Terms& m) { return m.seg + m.chunks + 1; }
__device__ __forceinline__ const int* terms_lo(const Terms& m) {
  return terms_off(m) + __ldg(m.seg + m.chunks) + 1;
}

// The S inputs of one row of a group buffer (S even: 16-byte loads).
template <int S>
__device__ __forceinline__ void load_row(const float2* a, float (&ar)[S], float (&ai)[S]) {
  static_assert(S % 2 == 0, "group rows are loaded two symbols at a time");
#pragma unroll
  for (int s = 0; s < S; s += 2) {
    const float4 v = *reinterpret_cast<const float4*>(a + s);
    ar[s] = v.x;
    ai[s] = v.y;
    ar[s + 1] = v.z;
    ai[s + 1] = v.w;
  }
}

// out[s][c] = sum_k in[k][s] * M[k, c] over M's listed terms, for the S
// symbols of the group buffer `in` ([rows][S] float2): for each chunk j,
// sink(c, xr, xi) gets the lane's column c = 32 j + lane (c may lie past
// the matrix, with zeros).  A lane loads D <= kAhead matrix elements at a
// time before it uses them (D = 1: one a term, the loop unrolled twice).
template <int S, int D = kAhead, class Sink>
__device__ __forceinline__ void group_product(const float2* in, const Terms& m, int lane, Sink&& sink) {
  const int* off = terms_off(m);
  const int* lo = terms_lo(m);
#pragma unroll 1
  for (int j = 0; j < m.chunks; ++j) {
    float xr[S], xi[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      xr[s] = 0.0f;
      xi[s] = 0.0f;
    }
    const int q1 = __ldg(m.seg + j + 1);
#pragma unroll 1
    for (int q = __ldg(m.seg + j); q < q1; ++q) {
      const int r0 = __ldg(off + q);
      const int trip = __ldg(off + q + 1) - r0;
      const float2* p = m.p + 32 * r0 + lane;
      const float2* a = in + S * __ldg(lo + 32 * q + lane);
      if constexpr (D == 1) {
#pragma unroll 2
        for (int i = 0; i < trip; ++i) {
          const float2 w = __ldg(p + 32 * i);
          float ar[S], ai[S];
          load_row<S>(a + S * i, ar, ai);
#pragma unroll
          for (int s = 0; s < S; ++s) {
            xr[s] = xr[s] + (ar[s] * w.x - ai[s] * w.y);
            xi[s] = xi[s] + (ar[s] * w.y + ai[s] * w.x);
          }
        }
      } else {
#pragma unroll 1
        for (int i0 = 0; i0 < trip; i0 += D) {
          float2 w[D];
#pragma unroll
          for (int d = 0; d < D; ++d) w[d] = __ldg(p + 32 * (i0 + d));
#pragma unroll
          for (int d = 0; d < D; ++d) {
            if (i0 + d < trip) {
              float ar[S], ai[S];
              load_row<S>(a + S * (i0 + d), ar, ai);
#pragma unroll
              for (int s = 0; s < S; ++s) {
                xr[s] = xr[s] + (ar[s] * w[d].x - ai[s] * w[d].y);
                xi[s] = xi[s] + (ar[s] * w[d].y + ai[s] * w[d].x);
              }
            }
          }
        }
      }
    }
    sink(32 * j + lane, xr, xi);
  }
}

// Column c of the product for the one input vector at v (rows `stride`
// float2 apart): group_product's terms in its order, so the two agree bit
// for bit.
__device__ __forceinline__ float2 column_dot(const float2* v, int stride, const Terms& m, int c) {
  const int j = c >> 5;
  const int l = c & 31;
  const int* off = terms_off(m);
  const int* lo = terms_lo(m);
  float xr = 0.0f, xi = 0.0f;
  const int q1 = __ldg(m.seg + j + 1);
  for (int q = __ldg(m.seg + j); q < q1; ++q) {
    const int r0 = __ldg(off + q);
    const int trip = __ldg(off + q + 1) - r0;
    const float2* p = m.p + 32 * r0 + l;
    const float2* a = v + stride * __ldg(lo + 32 * q + l);
    for (int i = 0; i < trip; ++i) {
      const float2 w = __ldg(p + 32 * i);
      const float2 x = a[stride * i];
      xr = xr + (x.x * w.x - x.y * w.y);
      xi = xi + (x.x * w.y + x.y * w.x);
    }
  }
  return make_float2(xr, xi);
}

// --- K3, the carry probe of the narrow fold and mm chains ---------------------------
//
// One block computes run symbol `sym`'s x = s @ F_tx,ext: its threads
// encode the n bins into shared memory (the Philox words at (sym, k),
// encode, x sqrt(P) under apply_power: the functions encode_group runs),
// then thread t computes columns t, t + blockDim.x, ... of x over the
// chunk's listed terms, column_dot's terms in its order, so column c < T
// is bit-equal to the chunk's carry row and column T <= c < T+E to the
// tail the next symbol reads.  Neighbouring threads write neighbouring
// columns.
//
// A column's terms are one chain of dependent adds (a dense column's up to
// 256), so what can overlap are its loads, each a round trip of ~0.5 us
// for a lone block on an H100: a thread loads a segment's matrix elements
// kProbeBatch at a time, and loads its first column's first batch (with
// the indices that locate it) before the bins are encoded, which hides
// one round trip behind the Philox draws.  Loads past a segment's trip are
// predicated off and their terms use a zero element and the segment's last
// input: a +-0 term, which leaves a sum begun at +0 unchanged (it is never
// -0 under round-to-nearest), as group_product.cuh's packed zeros do.

constexpr int kProbeMaxN = 256;
constexpr int kProbeMaxThreads = 256;
constexpr int kProbeBatch = 32;

// Threads of a probe's block: 128 while the symbol's T+E columns (and so
// its n <= T bins) fit one a thread, so the product runs as one pass of
// four warps; past that 256, at most three columns a thread of the narrow
// chains' widest symbol (T+E <= 640).
__host__ __device__ constexpr int probe_threads(int T, int E) { return T + E <= 128 ? 128 : kProbeMaxThreads; }

// Where column c's terms start: its chunk's segments [q, q1) and the first
// one's packed row r0, trip and the lane's first input row lo (q == q1: a
// column without terms; c past the matrix: none either).
struct ProbeHead {
  int q, q1, r0, trip, lo;
};

__device__ __forceinline__ ProbeHead probe_head(const Terms& m, int c, int cols) {
  ProbeHead h{0, 0, 0, 0, 0};
  if (c < cols) {
    h.q = __ldg(m.seg + (c >> 5));
    h.q1 = __ldg(m.seg + (c >> 5) + 1);
    if (h.q < h.q1) {
      h.r0 = __ldg(terms_off(m) + h.q);
      h.trip = __ldg(terms_off(m) + h.q + 1) - h.r0;
      h.lo = __ldg(terms_lo(m) + 32 * h.q + (c & 31));
    }
  }
  return h;
}

// The first kProbeBatch elements of column c's first segment (zero past its trip).
__device__ __forceinline__ void probe_first(const Terms& m, int c, const ProbeHead& h, float2 (&w)[kProbeBatch]) {
  const float2* p = m.p + 32 * h.r0 + (c & 31);
#pragma unroll
  for (int d = 0; d < kProbeBatch; ++d) w[d] = d < h.trip ? __ldg(p + 32 * d) : make_float2(0.0f, 0.0f);
}

// The terms i0 ... trip - 1 of a segment (inputs a[i], elements p[32 i]):
// batches of kProbeBatch, then of 4 with the last one's tail predicated off.
__device__ __forceinline__ void probe_segment(const float2* a, const float2* p, int trip, int i0, float& xr,
                                              float& xi) {
  for (; i0 + kProbeBatch <= trip; i0 += kProbeBatch) {
    float2 w[kProbeBatch];
#pragma unroll
    for (int d = 0; d < kProbeBatch; ++d) w[d] = __ldg(p + 32 * (i0 + d));
#pragma unroll
    for (int d = 0; d < kProbeBatch; ++d) {
      const float2 x = a[i0 + d];
      xr = xr + (x.x * w[d].x - x.y * w[d].y);
      xi = xi + (x.x * w[d].y + x.y * w[d].x);
    }
  }
  for (; i0 < trip; i0 += 4) {
    float2 w[4], x[4];
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const bool in = i0 + d < trip;
      w[d] = in ? __ldg(p + 32 * (i0 + d)) : make_float2(0.0f, 0.0f);
      x[d] = a[in ? i0 + d : trip - 1];
    }
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      xr = xr + (x[d].x * w[d].x - x[d].y * w[d].y);
      xi = xi + (x[d].x * w[d].y + x[d].y * w[d].x);
    }
  }
}

// Column c of x = s @ M from its head and its first batch w.
__device__ __forceinline__ float2 probe_column(const float2* s, const Terms& m, int c, const ProbeHead& h,
                                               const float2 (&w)[kProbeBatch]) {
  float xr = 0.0f, xi = 0.0f;
  if (h.q < h.q1) {
    const float2* a = s + h.lo;
    const int n0 = h.trip < kProbeBatch ? h.trip : kProbeBatch;
#pragma unroll
    for (int d0 = 0; d0 < kProbeBatch; d0 += 4) {
      if (d0 < n0) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 x = a[d0 + e < h.trip ? d0 + e : h.trip - 1];
          xr = xr + (x.x * w[d0 + e].x - x.y * w[d0 + e].y);
          xi = xi + (x.x * w[d0 + e].y + x.y * w[d0 + e].x);
        }
      }
    }
    const int l = c & 31;
    probe_segment(a, m.p + 32 * h.r0 + l, h.trip, kProbeBatch, xr, xi);
    for (int q = h.q + 1; q < h.q1; ++q) {
      const int r0 = __ldg(terms_off(m) + q);
      probe_segment(s + __ldg(terms_lo(m) + 32 * q + l), m.p + 32 * r0 + l, __ldg(terms_off(m) + q + 1) - r0, 0,
                    xr, xi);
    }
  }
  return make_float2(xr, xi);
}

template <int kMode, bool kStaged, class Link>
__device__ __forceinline__ void probe_block(const Link& L, const Terms& tx, unsigned long long sym, float* carry_r,
                                            float* carry_i, float* tail_r, float* tail_i) {
  __shared__ float2 sb[kProbeMaxN];
  const int cols = L.T + L.E;
  ProbeHead h = probe_head(tx, threadIdx.x, cols);
  float2 w[kProbeBatch];
  probe_first(tx, threadIdx.x, h, w);
  for (int k = threadIdx.x; k < L.n; k += blockDim.x) {
    const uint4 wd = symbol_words(sym, k, L.key);
    float sr, si;
    encode<kMode>(wd.x, L.q, L.lanes, k, sr, si);
    scale_tx<kStaged>(L, k, sr, si);
    sb[k] = make_float2(sr, si);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < cols; c += blockDim.x) {
    if (c != static_cast<int>(threadIdx.x)) {
      h = probe_head(tx, c, cols);
      probe_first(tx, c, h, w);
    }
    const float2 x = probe_column(sb, tx, c, h, w);
    if (c < L.T) {
      carry_r[c] = x.x;
      carry_i[c] = x.y;
    } else {
      tail_r[c - L.T] = x.x;
      tail_i[c - L.T] = x.y;
    }
  }
}

// A warp's group buffers (float2): act [T+E][S] = the group's x[0:T) and
// in rows T ... T+E-1 each symbol's predecessor tail; sb [n][S] the group's
// points, then a product's outputs; nt [E] the tail of the group's last
// symbol, for the next group.
struct GroupBufs {
  float2* act;
  float2* sb;
  float2* nt;
};

// float2 slots of a warp's group buffers (rounded to 16 bytes): act, sb
// (n rows) and nt for the TX and channel stages; mm_main's noisy y (T rows)
// and outputs (n rows) fit in the same count.
__host__ __device__ constexpr int group_pairs(int S, int n, int T, int E) {
  return (S * (T + E) + S * n + E + 1) / 2 * 2;
}

// Bytes of a warp's group buffers at J bins a lane.
__host__ __device__ constexpr int group_bytes(int J, int n, int T, int E) {
  return static_cast<int>(sizeof(float2)) * group_pairs(group_of(J), n, T, E);
}

__device__ __forceinline__ GroupBufs group_bufs(int S, int n, int T, int E, float2* base) {
  GroupBufs g;
  g.act = base;
  g.sb = base + S * (T + E);
  g.nt = g.sb + S * n;
  return g;
}

// Warps a block of a kernel whose warps take `pair_bytes` of group buffers
// each beside `fixed` bytes: 8, or as many as the 227 KB a block may hold
// (0 when not even one fits).
__host__ __device__ constexpr int group_warps(int pair_bytes, int fixed) {
  return (kMaxBlockSmem - fixed) / pair_bytes < kGroupWarps ? (kMaxBlockSmem - fixed) / pair_bytes : kGroupWarps;
}

// Register rows [S][J]: row i <- row i + 1 (static indices; the last row
// keeps its values).
template <int S, int J, class V>
__device__ __forceinline__ void shift_rows(V (&r)[S][J]) {
#pragma unroll
  for (int i = 0; i + 1 < S; ++i) {
#pragma unroll
    for (int j = 0; j < J; ++j) r[i][j] = r[i + 1][j];
  }
}

// Symbols first + s (s < cnt) of a group into sb ([n][S]): the points of
// the lane's bins k = lane + 32 j (x sqrt(P) under apply_power; zeros from
// cnt on) and, with kWords, each symbol's TX indices and noise words in
// register rows tx / w1 / w2 [S][J] (the loop shifts the rows down and
// fills the last, so row s ends as symbol s's).
template <int S, int J, int kMode, bool kStaged, bool kWords, class Link>
__device__ __forceinline__ void encode_group(const Link& L, unsigned long long first, int cnt, float2* sb,
                                             int lane, int (&tx)[S][J], uint32_t (&w1)[S][J],
                                             uint32_t (&w2)[S][J]) {
#pragma unroll 1
  for (int s = 0; s < S; ++s) {
    if constexpr (kWords) {
      shift_rows(tx);
      shift_rows(w1);
      shift_rows(w2);
    }
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int k = lane + 32 * j;
      if constexpr (kWords) {
        tx[S - 1][j] = 0;
        w1[S - 1][j] = 0u;
        w2[S - 1][j] = 0u;
      }
      if (k < L.n) {
        float sr = 0.0f, si = 0.0f;
        if (s < cnt) {
          const uint4 wd = symbol_words(first + static_cast<unsigned long long>(s), k, L.key);
          const int t = encode<kMode>(wd.x, L.q, L.lanes, k, sr, si);
          scale_tx<kStaged>(L, k, sr, si);
          if constexpr (kWords) {
            tx[S - 1][j] = t;
            w1[S - 1][j] = wd.y;
            w2[S - 1][j] = wd.z;
          }
        }
        sb[k * S + s] = make_float2(sr, si);
      }
    }
  }
}

// act[T + t][0] (slot 0 of the tail rows) <- run symbol sym - 1's tail
// x[T:T+E): the carry-in when sym is the chunk's first symbol and the Link
// carries one (kPrev), zeros for run symbol 0, else its encode (scaled
// under apply_power) and the TX columns T ... T+E-1 by column_dot, the
// terms the group product gives a symbol's successor.  sb is scratch.
// Leaves the warp synchronized.
template <int S, int kMode, bool kStaged, bool kPrev, class Link>
__device__ void group_prev_tail(const Link& L, const Terms& tx, const GroupBufs& g, unsigned long long sym,
                                int lane) {
  if (L.E == 0) return;
  if (kPrev && L.prev_r != nullptr && sym == L.sym0) {
    for (int t = lane; t < L.E; t += 32) g.act[(L.T + t) * S] = make_float2(L.prev_r[t], L.prev_i[t]);
    __syncwarp();
    return;
  }
  if (sym == 0) {
    for (int t = lane; t < L.E; t += 32) g.act[(L.T + t) * S] = make_float2(0.0f, 0.0f);
    __syncwarp();
    return;
  }
  for (int k = lane; k < L.n; k += 32) {
    const uint4 wd = symbol_words(sym - 1, k, L.key);
    float sr, si;
    encode<kMode>(wd.x, L.q, L.lanes, k, sr, si);
    scale_tx<kStaged>(L, k, sr, si);
    g.sb[k * S] = make_float2(sr, si);
  }
  __syncwarp();
  for (int t = lane; t < L.E; t += 32) g.act[(L.T + t) * S] = column_dot(g.sb, S, tx, L.T + t);
  __syncwarp();
}

// The TX stage of a group whose points sit in sb: x = s @ F_tx,ext over the
// listed terms, x[0:T) into act, each symbol's tail into its successor's
// tail slot (the last slot's into nt).  With `papr`, the PAPR stats of the
// group's first cnt symbols; with carry_r, the row of the chunk's last
// symbol (chunk slot `last` of the group, if it holds it).
template <int S, int D, class Link>
__device__ __forceinline__ void tx_stage(const Link& L, const Terms& tx, const GroupBufs& g, int cnt, int last,
                                         int lane, bool papr, float& pk, double& ps, float* carry_r,
                                         float* carry_i) {
  const int T = L.T;
  const int TE = L.T + L.E;
  group_product<S, D>(g.sb, tx, lane, [&](int c, const float (&xr)[S], const float (&xi)[S]) {
    if (c < T) {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        g.act[c * S + s] = make_float2(xr[s], xi[s]);
        if (papr && s < cnt) {
          const float pw = xr[s] * xr[s] + xi[s] * xi[s];
          pk = fmaxf(pk, pw);
          ps += static_cast<double>(pw);
        }
        if (carry_r != nullptr && s == last) {
          carry_r[c] = xr[s];
          carry_i[c] = xi[s];
        }
      }
    } else if (c < TE) {
#pragma unroll
      for (int s = 0; s + 1 < S; ++s) g.act[c * S + s + 1] = make_float2(xr[s], xi[s]);
      g.nt[c - T] = make_float2(xr[S - 1], xi[S - 1]);
    }
  });
}

// After the channel product has read act: the group's last tail into slot
// 0 of the tail rows, for the next group.
template <int S, class Link>
__device__ __forceinline__ void next_tail(const Link& L, const GroupBufs& g, int lane) {
  for (int t = lane; t < L.E; t += 32) g.act[(L.T + t) * S] = g.nt[t];
}

// One symbol's chain from its equalized points (SC-FDE: after the IDFT) to
// the counters, as the warp-per-symbol kernels ran it: the noise-bump
// stages (kBump), the normalization (phase 0 adds the symbol's |e|^2 to
// `energy` and stops), the aqam SC-FDE slicer row, the dump, the count.
template <int J, int kMode, bool kStaged, bool kDump, bool kBump, class Link>
__device__ __forceinline__ void finish_symbol(const Link& L, int b, int lane, float (&er)[J], float (&ei)[J],
                                              const int (&tx)[J], bool counting, bool normalize, float fn,
                                              float& energy, uint32_t& be, uint32_t& se) {
  if constexpr (kBump) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int k = lane + 32 * j;
      if (k < L.n) bump_stages<true>(L, L.sym0 + static_cast<unsigned long long>(b), k, er[j], ei[j]);
    }
  }
  if constexpr (kStaged) {
    if (normalize) {
      if (!counting) {
        energy = energy + warp_energy<J>(er, ei, lane, L.n);
        return;
      }
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int k = lane + 32 * j;
        if (k < L.n) {
          const float m = norm_gain<kMode>(L, k, fn);
          er[j] = er[j] * m;
          ei[j] = ei[j] * m;
        }
      }
    }
  }
  if (!counting) return;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int k = lane + 32 * j;
    if (k < L.n) {
      sc_slicer_bin<kMode, kStaged>(L, k, er[j], ei[j]);
      dump_bin<kMode, kDump>(L, b, k, er[j], ei[j]);
      count_bin<kMode>(tx[j], er[j], ei[j], L.q, L.lanes, k, be, se);
    }
  }
}

// flush_counters for a block of blockDim.x / 32 <= 8 warps.
__device__ __forceinline__ void flush_block(uint32_t be, uint32_t se, float pk, double ps, unsigned long long* acc,
                                            double* psum) {
  __shared__ unsigned long long red_be[kGroupWarps];
  __shared__ unsigned long long red_se[kGroupWarps];
  __shared__ float red_pk[kGroupWarps];
  __shared__ double red_ps[kGroupWarps];
  const unsigned full = 0xFFFFFFFFu;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned long long be64 = be, se64 = se;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    be64 += __shfl_xor_sync(full, be64, off);
    se64 += __shfl_xor_sync(full, se64, off);
    pk = fmaxf(pk, __shfl_xor_sync(full, pk, off));
    ps += __shfl_xor_sync(full, ps, off);
  }
  if (lane == 0) {
    red_be[warp] = be64;
    red_se[warp] = se64;
    red_pk[warp] = pk;
    red_ps[warp] = ps;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long tb = 0, ts = 0;
    float tp = 0.0f;
    double tps = 0.0;
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
      tb += red_be[w];
      ts += red_se[w];
      tp = fmaxf(tp, red_pk[w]);
      tps += red_ps[w];
    }
    atomicAdd(acc + 0, tb);
    atomicAdd(acc + 1, ts);
    atomicMax(acc + 2, static_cast<unsigned long long>(__float_as_uint(tp)));
    atomicAdd(psum, tps);
  }
}

// power_block_partial<256, 16> for a block of any size: red holds a power
// block's 4096 |y|^2 in element order (zeros past its count); virtual
// thread v < 256 sums elements 256 j + v, j ascending, then the 256-way
// halving tree; thread 0 stores the sum in *out.  Every thread of the block
// must call it.
__device__ __forceinline__ void power_partial_any(float* red, float* out) {
  const int t = threadIdx.x;
  const int nt = blockDim.x;
  __syncthreads();
  for (int v = t; v < 256; v += nt) {
    float acc = 0.0f;
    for (int j = 0; j < 16; ++j) acc = acc + red[j * 256 + v];
    red[v] = acc;
  }
  __syncthreads();
  for (int s = 128; s > 0; s >>= 1) {
    for (int v = t; v < s; v += nt) red[v] = red[v] + red[v + s];
    __syncthreads();
  }
  if (t == 0) *out = red[0];
}

}  // namespace ofdm
