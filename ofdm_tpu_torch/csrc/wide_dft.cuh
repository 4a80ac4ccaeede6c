// The staged block transform of the wide dense chains (fold_wide, mm_wide,
// through wide_chain.cuh): block_dft.cuh's radix-2 butterflies at n = 256 J
// (512, 1024, 2048) with the same operands, twiddle entries and order within
// each butterfly, grouped so that a symbol's transform takes two or three
// block barriers instead of one a stage.
//
// Thread t (lane l = t & 31, warp w = t >> 5) holds J = 2^r elements in
// registers.  A round is a layout: bit b of q = t | (j << 8) (lane bits 0-4,
// warp bits 5-7, slot bits 8..) sets position bit kStagePerm[round][b] of
// the element thread t holds in slot j (positions are block_dft's: the
// input m stored at its bit-reversed index).  A round runs, in registers,
// the stages (h = 2^s) whose position bit s is a slot bit, in order.
// Between rounds the elements move through shared memory: under __syncwarp
// where the warp bits keep their position bits (the warp keeps its
// elements), under __syncthreads elsewhere.  A radix-2 butterfly computes
// the same floats whichever thread runs it, provided its inputs are the
// previous stage's outputs, so the result is block_dft's bit for bit.  The
// first round holds position (t << r) | j, so a thread's input m is
// brev8(t) + 256 brev_r(j); the last is the identity, so thread t ends with
// bins t + 256 j: the layout of the per-bin chain and of every block sum.
// ofdm_tpu_torch/ops/dft.py::STAGE_PERMS holds the same tables and
// staged_block_dft applies them in torch.
//
// Block barriers a transform: 2 at n = 512 and 1024, 1 at 2048, plus one
// when the input arrives in natural order (thread t holding inputs t + 256 j:
// the SC-FDE IDFT's equalized bins, OFDM's encoded bins, mm's overlap-add),
// which moves it to the first round's layout.
//
// Shared memory: two float2 exchange buffers (position p at p + p/16 +
// p/256, which keeps the exchanges' 64-bit accesses at or near one
// wavefront a half-warp) used in turn, so a block exchange never writes
// what another warp may still read; and the twiddles a stage uses, W_n^(pos
// n / 2h) for stage h, at (h - 1) + pos, staged once a block.

#pragma once

#include <cuda_runtime.h>

#include "block_dft.cuh"

namespace ofdm {

constexpr int kStageThreads = 256;

// log2 n and the number of rounds of the J-slot schedule (n = 256 J).
__host__ __device__ constexpr int stage_log2n(int J) { return J == 2 ? 9 : (J == 4 ? 10 : 11); }
__host__ __device__ constexpr int stage_rounds(int J) { return J == 2 ? 9 : (J == 4 ? 6 : 4); }

// kStagePerm[round][b]: the position bit that bit b of q = t | (j << 8) sets.
__host__ __device__ constexpr int stage_perm(int J, int R, int b) {
  // kStagePerm 512
  constexpr int p512[9][9] = {
      {1, 2, 3, 4, 5, 6, 7, 8, 0},
      {2, 3, 4, 5, 0, 6, 7, 8, 1},
      {0, 1, 3, 4, 5, 6, 7, 8, 2},
      {0, 1, 2, 4, 5, 6, 7, 8, 3},
      {0, 1, 2, 3, 5, 6, 7, 8, 4},
      {0, 1, 2, 3, 4, 6, 7, 8, 5},
      {3, 4, 5, 7, 8, 0, 1, 2, 6},
      {3, 4, 5, 6, 8, 0, 1, 2, 7},
      {0, 1, 2, 3, 4, 5, 6, 7, 8},
  };
  // kStagePerm 1024
  constexpr int p1024[6][10] = {
      {2, 3, 4, 5, 6, 7, 8, 9, 0, 1},
      {4, 5, 6, 0, 1, 7, 8, 9, 2, 3},
      {0, 1, 2, 3, 6, 7, 8, 9, 4, 5},
      {0, 1, 2, 3, 4, 7, 8, 9, 5, 6},
      {0, 1, 2, 3, 4, 5, 6, 9, 7, 8},
      {0, 1, 2, 3, 4, 5, 6, 7, 8, 9},
  };
  // kStagePerm 2048
  constexpr int p2048[4][11] = {
      {3, 4, 5, 6, 7, 8, 9, 10, 0, 1, 2},
      {6, 7, 0, 1, 2, 8, 9, 10, 3, 4, 5},
      {0, 1, 2, 3, 4, 8, 9, 10, 5, 6, 7},
      {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10},
  };
  return J == 2 ? p512[R][b] : (J == 4 ? p1024[R][b] : p2048[R][b]);
}

__host__ __device__ constexpr int stage_slot_bits(int J) { return stage_log2n(J) - 8; }

// The slot bit of round R whose position bit is s, or -1.
__host__ __device__ constexpr int stage_slot_bit(int J, int R, int s) {
  for (int jb = 0; jb < stage_slot_bits(J); ++jb) {
    if (stage_perm(J, R, 8 + jb) == s) return jb;
  }
  return -1;
}

// The first stage round R runs and the one after its last.
__host__ __device__ constexpr int stage_first(int J, int R) {
  int s = 0;
  for (int r = 0; r < R; ++r) {
    while (s < stage_log2n(J) && stage_slot_bit(J, r, s) >= 0) ++s;
  }
  return s;
}
__host__ __device__ constexpr int stage_end(int J, int R) {
  int s = stage_first(J, R);
  while (s < stage_log2n(J) && stage_slot_bit(J, R, s) >= 0) ++s;
  return s;
}

// Whether the move from round R to R + 1 stays inside each warp.
__host__ __device__ constexpr bool stage_warp_local(int J, int R) {
  for (int b = 5; b < 8; ++b) {
    if (stage_perm(J, R, b) != stage_perm(J, R + 1, b)) return false;
  }
  return true;
}

// Slot j's share of round R's position (its bits are disjoint from t's).
__host__ __device__ constexpr int stage_slot_pos(int J, int R, int j) {
  int p = 0;
  for (int jb = 0; jb < stage_slot_bits(J); ++jb) p |= ((j >> jb) & 1) << stage_perm(J, R, 8 + jb);
  return p;
}

// Thread t's share of round R's position as runs of consecutive bits.
struct StageRuns {
  int n;
  int src[8];
  int len[8];
  int dst[8];
};

__host__ __device__ constexpr StageRuns stage_runs(int J, int R) {
  StageRuns r{};
  for (int b = 0; b < 8; ++b) {
    const int d = stage_perm(J, R, b);
    if (r.n > 0 && r.src[r.n - 1] + r.len[r.n - 1] == b && r.dst[r.n - 1] + r.len[r.n - 1] == d) {
      ++r.len[r.n - 1];
    } else {
      r.src[r.n] = b;
      r.len[r.n] = 1;
      r.dst[r.n] = d;
      ++r.n;
    }
  }
  return r;
}

template <int J, int R>
__device__ __forceinline__ int stage_thread_pos(int t) {
  constexpr StageRuns r = stage_runs(J, R);
  int p = 0;
#pragma unroll
  for (int k = 0; k < r.n; ++k) p |= ((t >> r.src[k]) & ((1 << r.len[k]) - 1)) << r.dst[k];
  return p;
}

// Where position p lives in an exchange buffer; additive over disjoint bits,
// so a slot's share is an immediate offset.
__host__ __device__ constexpr int stage_addr(int p) { return p + (p >> 4) + (p >> 8); }

// float2 entries of one exchange buffer and of the twiddle table at n = 256 J.
__host__ __device__ constexpr int stage_buf_len(int n) { return stage_addr(n - 1) + 1; }

// The exchange buffers (used in turn by the block exchanges) and the
// staged twiddles of one block.
struct WideDft {
  float2* cur;
  float2* nxt;
  const float2* tw;

  __device__ __forceinline__ void toggle() {
    float2* t = cur;
    cur = nxt;
    nxt = t;
  }
};

// Stage the twiddle table: entry (h - 1) + pos = W_n^(pos n / 2h), from the
// plan's rows.  The caller synchronizes before the first transform.
__device__ __forceinline__ void stage_twiddles(const DftPlan& p, float2* tw) {
  for (int i = threadIdx.x; i < p.n - 1; i += kStageThreads) {
    const int s = 31 - __clz(i + 1);
    const int pos = i + 1 - (1 << s);
    const int k = pos << (p.log2n - 1 - s);
    tw[i] = make_float2(__ldg(p.twr + k), __ldg(p.twi + k));
  }
}

// Stage S of round R on the thread's elements: block_dft's butterfly on the
// slot pairs (j, j | 2^jb) of slot bit jb, twiddle entry (2^S - 1) + pos.
template <int J, int R, int S, bool kInv>
__device__ __forceinline__ void stage_butterflies(float (&xr)[J], float (&xi)[J], const float2* tw, int pt) {
  constexpr int jb = stage_slot_bit(J, R, S);
  constexpr int mask = (1 << S) - 1;
  const float2* row = tw + mask + (pt & mask);
#pragma unroll
  for (int j = 0; j < J; ++j) {
    if (j & (1 << jb)) continue;
    const int j1 = j | (1 << jb);
    const float2 w = row[stage_slot_pos(J, R, j) & mask];
    const float wr = w.x;
    const float wi = kInv ? -w.y : w.y;
    const float tr = wr * xr[j1] - wi * xi[j1];
    const float ti = wr * xi[j1] + wi * xr[j1];
    const float ur = xr[j];
    const float ui = xi[j];
    xr[j] = ur + tr;
    xi[j] = ui + ti;
    xr[j1] = ur - tr;
    xi[j1] = ui - ti;
  }
}

template <int J, int R, int S, bool kInv>
__device__ __forceinline__ void stage_run(float (&xr)[J], float (&xi)[J], const float2* tw, int pt) {
  if constexpr (S < stage_end(J, R)) {
    stage_butterflies<J, R, S, kInv>(xr, xi, tw, pt);
    stage_run<J, R, S + 1, kInv>(xr, xi, tw, pt);
  }
}

// Round R's elements (thread share pw) -> round R + 1's (pr).
template <int J, int R>
__device__ __forceinline__ void stage_exchange(float (&xr)[J], float (&xi)[J], WideDft& d, int pw, int pr) {
  constexpr bool kWarp = stage_warp_local(J, R);
  if constexpr (kWarp) {
    __syncwarp();  // the warp has read what it wrote here last
  } else {
    d.toggle();
  }
  float2* buf = d.cur;
  const int aw = stage_addr(pw);
#pragma unroll
  for (int j = 0; j < J; ++j) buf[aw + stage_addr(stage_slot_pos(J, R, j))] = make_float2(xr[j], xi[j]);
  if constexpr (kWarp) {
    __syncwarp();
  } else {
    __syncthreads();
  }
  const int ar = stage_addr(pr);
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const float2 v = buf[ar + stage_addr(stage_slot_pos(J, R + 1, j))];
    xr[j] = v.x;
    xi[j] = v.y;
  }
}

template <int J, int R, bool kInv>
__device__ __forceinline__ void stage_rounds_from(float (&xr)[J], float (&xi)[J], WideDft& d) {
  const int pt = stage_thread_pos<J, R>(threadIdx.x);
  stage_run<J, R, stage_first(J, R), kInv>(xr, xi, d.tw, pt);
  if constexpr (R + 1 < stage_rounds(J)) {
    stage_exchange<J, R>(xr, xi, d, pt, stage_thread_pos<J, R + 1>(threadIdx.x));
    stage_rounds_from<J, R + 1, kInv>(xr, xi, d);
  }
}

// The unscaled (I)DFT of n = 256 J values held in round 0's layout (thread
// t's slot j: input brev8(t) + 256 brev_r(j)); ends with X[t + 256 j] in
// slot j.  Every thread of the block calls it, after a __syncthreads that
// follows the previous transform's last read of the buffers.
template <int J, bool kInv>
__device__ __forceinline__ void staged_dft(float (&xr)[J], float (&xi)[J], WideDft& d) {
  d.toggle();  // round 0's warp exchanges: the buffer the last block exchange did not write
  stage_rounds_from<J, 0, kInv>(xr, xi, d);
}

// j with its r = log2 J bits reversed: round 0's slot j holds input
// brev8(t) + 256 stage_slot_rev(j), and input t + 256 j sits at position
// brev_N(t) | stage_slot_rev(j).
__host__ __device__ constexpr int stage_slot_rev(int J, int j) {
  int rj = 0;
  for (int b = 0; b < stage_slot_bits(J); ++b) rj |= ((j >> b) & 1) << (stage_slot_bits(J) - 1 - b);
  return rj;
}

// The same from inputs in natural order (thread t's slot j: input t + 256
// j): one block exchange into round 0's layout first.  Every thread of the
// block calls it.
template <int J, bool kInv>
__device__ __forceinline__ void staged_dft_natural(float (&xr)[J], float (&xi)[J], WideDft& d) {
  d.toggle();
  float2* buf = d.cur;
  const int aw = stage_addr(static_cast<int>(__brev(threadIdx.x) >> (32 - stage_log2n(J))));
#pragma unroll
  for (int j = 0; j < J; ++j) buf[aw + stage_addr(stage_slot_rev(J, j))] = make_float2(xr[j], xi[j]);
  __syncthreads();
  const int ar = stage_addr(stage_thread_pos<J, 0>(threadIdx.x));
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const float2 v = buf[ar + stage_addr(stage_slot_pos(J, 0, j))];
    xr[j] = v.x;
    xi[j] = v.y;
  }
  stage_rounds_from<J, 0, kInv>(xr, xi, d);
}

}  // namespace ofdm
