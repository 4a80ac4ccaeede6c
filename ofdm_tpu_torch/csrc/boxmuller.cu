// Standalone samplers of the link kernel's random chain.
//
// ofdm_boxmuller replaces ofdm_tpu/ops/pallas_link.py::boxmuller_sample:
// (z0, z1) N(0,1) planes from the fused kernel's exact noise chain (24-bit
// u1 floored at 2^-24, radius sqrt(-2 ln u1), phase from the quarter-range
// polynomial pair), which the noise-moment gate tests.  One Philox call per
// element, counter = (element index lo, hi, 0, 0) under the two seed words;
// words 1 and 2 play u1 and u2, as in the link kernel.
//
// ofdm_philox fills (count, 4) words for counters (i lo, i hi, c2, c3).
// It replaces ofdm_tpu/ops/prng.py::_pallas_u32 (uniform uint32 words,
// prng.random_u32) and holds the device Philox against its plain version
// bit for bit.  It writes 16 bytes a counter and spends ~100 int32
// instructions on it, so on an H100 it is bound by its writes.
//
// ofdm_philox_plane is ofdm_philox's plane form: element (r, c) of a
// (rows, cols) plane is word 0 of counter ((sym0+r) lo, hi, c, c3), the TX
// word of the chunk kernels at c3 = 0 (the eager chain's TX draw).  It
// writes 4 bytes for ~100 int32 instructions: bound by issue rate.
//
// ofdm_normal_pair replaces ofdm_tpu/ops/prng.py::_normal_kernel /
// _pallas_normal_pair (normal_planes): element (r, c) takes words 1 and 2
// of counter ((sym0+r) lo, hi, c, c3) and returns z0 = r cos(theta), z1 =
// r sin(theta) with r = sqrt(-2 ln u1), u1 24 bits floored at 2^-24, theta
// = 2 pi u2, through the library's logf, sqrtf and sincosf (K5's math, not
// the link kernels' quarter-range polynomials).  Like every library of the
// port it builds with -fmad=false, so the multiplies round as in the plain
// PyTorch version; sincosf and logf differ from PyTorch's by ulps.  It
// writes 8 bytes per element for ~100 Philox and ~40 math instructions
// (sincosf's reduction included): issue-bound like ofdm_boxmuller.
//
// Bound on an H100: ofdm_boxmuller writes 8 bytes per element and spends
// ~130 instructions on it (Philox, log, sqrt, two Horner chains): in its
// static SASS 71 on the integer pipe (Philox's multiplies and xors), 46
// fp32, a MUFU.  The integer pipe's 64 lanes a clock an SM bound it, not
// its writes (~0.018 against ~0.010 ms at the gate's 2^22 elements).  Design: one
// wave, the grid sized to the blocks the card holds resident at once
// (occupancy x SMs), so no block waits for a second wave; a thread takes 4
// consecutive elements a step (a quad) and runs their four Philox chains
// round by round together (philox_x4: the chains are independent, so each
// round's multiplies of the four overlap instead of one chain's ten rounds
// waiting on each other, and the key schedule is shared); it writes z0 and
// z1 of the quad as one 16-byte store each, neighbouring threads on
// neighbouring quads.  The count % 4 elements past the last quad take one
// thread each (the scalar tail).  Each element keeps its counter and its
// math (boxmuller_element), so every output bit is the one-element-a-thread
// loop's.  The other samplers keep a grid-stride loop over elements with
// coalesced stores; no kernel here uses shared memory.

#include <cstdint>
#include <cuda_runtime.h>

#include "link_common.cuh"

// A named namespace, so profilers show the kernels' names.
namespace ofdm_sampler {

constexpr int kBmThreads = 256;  // ofdm_boxmuller's block
constexpr int kBmStep = 4;        // consecutive elements a thread takes a step: one float4 store a plane

// philox4x32_10 on N counters at once, round by round (the same rounds and
// key schedule, so each result equals philox4x32_10's).
template <int N>
__device__ __forceinline__ void philox_x4(uint4 (&c)[N], uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const uint32_t hi0 = __umulhi(0xD2511F53u, c[e].x);
      const uint32_t lo0 = 0xD2511F53u * c[e].x;
      const uint32_t hi1 = __umulhi(0xCD9E8D57u, c[e].z);
      const uint32_t lo1 = 0xCD9E8D57u * c[e].z;
      c[e] = make_uint4(hi1 ^ c[e].y ^ k.x, lo1, hi0 ^ c[e].w ^ k.y, lo0);
    }
    k.x += 0x9E3779B9u;
    k.y += 0xBB67AE85u;
  }
}

// One element's (z0, z1) from its Philox words: u1 from word 1, the phase
// from word 2.
__device__ __forceinline__ void boxmuller_element(const uint4& w, float& z0, float& z1) {
  const float u1 = ofdm::uniform24_floored(w.y);
  const float rad = sqrtf(-2.0f * logf(u1));
  float co, si;
  ofdm::cossin_u24((w.z >> 8) & 0xFFFFFFu, co, si);
  z0 = rad * co;
  z1 = rad * si;
}

// Thread g of the grid's P threads takes quads g, g + P, ... (quad q =
// elements 4q ... 4q + 3, counters (4q + e lo, hi, 0, 0); 4q + 3 never
// carries into hi), then element 4 * quads + g when that is below count.
// z0 and z1 are 16-byte aligned (the entry point checks).
__global__ void __launch_bounds__(kBmThreads)
    boxmuller_kernel(float* z0, float* z1, long long count, uint2 key) {
  const long long threads = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long quads = count / kBmStep;
  for (long long q = g; q < quads; q += threads) {
    const long long i = kBmStep * q;
    uint4 w[kBmStep];
#pragma unroll
    for (int e = 0; e < kBmStep; ++e) {
      w[e] = make_uint4(static_cast<uint32_t>(i) + static_cast<uint32_t>(e), static_cast<uint32_t>(i >> 32), 0u, 0u);
    }
    philox_x4<kBmStep>(w, key);
    float a[kBmStep], b[kBmStep];
#pragma unroll
    for (int e = 0; e < kBmStep; ++e) boxmuller_element(w[e], a[e], b[e]);
    reinterpret_cast<float4*>(z0)[q] = make_float4(a[0], a[1], a[2], a[3]);
    reinterpret_cast<float4*>(z1)[q] = make_float4(b[0], b[1], b[2], b[3]);
  }
  const long long i = kBmStep * quads + g;
  if (i < count) {
    const uint4 w = ofdm::philox4x32_10(
        make_uint4(static_cast<uint32_t>(i), static_cast<uint32_t>(i >> 32), 0u, 0u), key);
    boxmuller_element(w, z0[i], z1[i]);
  }
}

__global__ void philox_kernel(uint4* out, long long count, uint32_t c2, uint32_t c3, uint2 key) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < count;
       i += stride) {
    out[i] = ofdm::philox4x32_10(
        make_uint4(static_cast<uint32_t>(i), static_cast<uint32_t>(i >> 32), c2, c3), key);
  }
}

__global__ void philox_plane_kernel(uint32_t* out, long long rows, int cols,
                                    unsigned long long sym0, uint32_t c3, uint2 key) {
  const long long count = rows * cols;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < count;
       i += stride) {
    const long long r = i / cols;
    const unsigned long long b = sym0 + static_cast<unsigned long long>(r);
    const uint32_t c = static_cast<uint32_t>(i - r * cols);
    out[i] = ofdm::philox4x32_10(
                 make_uint4(static_cast<uint32_t>(b), static_cast<uint32_t>(b >> 32), c, c3), key)
                 .x;
  }
}

__global__ void normal_pair_kernel(float* z0, float* z1, long long rows, int cols,
                                   unsigned long long sym0, uint32_t c3, uint2 key) {
  const float kTwoPi = 6.28318530717958647692f;
  const long long count = rows * cols;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < count;
       i += stride) {
    const long long r = i / cols;
    const unsigned long long b = sym0 + static_cast<unsigned long long>(r);
    const uint32_t c = static_cast<uint32_t>(i - r * cols);
    const uint4 w = ofdm::philox4x32_10(
        make_uint4(static_cast<uint32_t>(b), static_cast<uint32_t>(b >> 32), c, c3), key);
    const float u1 = ofdm::uniform24_floored(w.y);
    const float u2 = static_cast<float>((w.z >> 8) & 0xFFFFFFu) * (1.0f / 16777216.0f);
    const float rad = sqrtf(-2.0f * logf(u1));
    float sn, co;
    sincosf(kTwoPi * u2, &sn, &co);
    z0[i] = rad * co;
    z1[i] = rad * sn;
  }
}

int grid_for(long long count) {
  const long long want = (count + 255) / 256;
  return static_cast<int>(want < 132 * 16 ? want : 132 * 16);
}

// ofdm_boxmuller's grid: its quads' blocks, at most one wave (the blocks
// resident at once on the current device's SMs, read once a device).
cudaError_t boxmuller_grid(long long count, int* grid) {
  static int resident[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, boxmuller_kernel, kBmThreads, 0);
    }
    if (err != cudaSuccess) return err;
    if (sms * per_sm < 1) return cudaErrorInvalidConfiguration;
    resident[dev] = sms * per_sm;
  }
  const long long want = (count / kBmStep + kBmThreads - 1) / kBmThreads;
  *grid = static_cast<int>(want < 1 ? 1 : (want < resident[dev] ? want : resident[dev]));
  return cudaSuccess;
}

}  // namespace ofdm_sampler

using namespace ofdm_sampler;

extern "C" {

// The (count,) N(0,1) planes z0, z1 (16-byte aligned) of elements 0 ...
// count - 1.
int ofdm_boxmuller(float* z0, float* z1, long long count, unsigned int key0, unsigned int key1,
                   void* stream_ptr) {
  if (count < 1 || ((reinterpret_cast<uintptr_t>(z0) | reinterpret_cast<uintptr_t>(z1)) & 15u) != 0) {
    return cudaErrorInvalidValue;
  }
  int grid = 0;
  const cudaError_t err = boxmuller_grid(count, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  boxmuller_kernel<<<grid, kBmThreads, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      z0, z1, count, make_uint2(key0, key1));
  return static_cast<int>(cudaGetLastError());
}

// ofdm_boxmuller's launch: its grid for `count` elements on the current
// device, threads a block, elements a thread a step, registers a thread,
// local bytes a thread and resident blocks an SM, into out[0..6).
int ofdm_boxmuller_geometry(long long count, int* out) {
  if (count < 1 || out == nullptr) return cudaErrorInvalidValue;
  int grid = 0, per_sm = 0;
  cudaFuncAttributes fa;
  cudaError_t err = boxmuller_grid(count, &grid);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, boxmuller_kernel);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, boxmuller_kernel, kBmThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int v[6] = {grid, kBmThreads, kBmStep, fa.numRegs, static_cast<int>(fa.localSizeBytes), per_sm};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return cudaSuccess;
}

int ofdm_philox(unsigned int* out, long long count, unsigned int c2, unsigned int c3,
                unsigned int key0, unsigned int key1, void* stream_ptr) {
  if (count < 1) return cudaErrorInvalidValue;
  philox_kernel<<<grid_for(count), 256, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      reinterpret_cast<uint4*>(out), count, c2, c3, make_uint2(key0, key1));
  return static_cast<int>(cudaGetLastError());
}

// Word 0 of counters ((sym0+r) lo, hi, c, c3) into the (rows, cols) plane out.
int ofdm_philox_plane(unsigned int* out, long long rows, int cols, unsigned long long sym0, unsigned int c3,
                      unsigned int key0, unsigned int key1, void* stream_ptr) {
  if (rows < 1 || cols < 1) return cudaErrorInvalidValue;
  philox_plane_kernel<<<grid_for(rows * cols), 256, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      out, rows, cols, sym0, c3, make_uint2(key0, key1));
  return static_cast<int>(cudaGetLastError());
}

// The (rows, cols) N(0,1) planes z0, z1 from words 1 and 2 of counters
// ((sym0+r) lo, hi, c, c3).
int ofdm_normal_pair(float* z0, float* z1, long long rows, int cols, unsigned long long sym0, unsigned int c3,
                     unsigned int key0, unsigned int key1, void* stream_ptr) {
  if (rows < 1 || cols < 1) return cudaErrorInvalidValue;
  normal_pair_kernel<<<grid_for(rows * cols), 256, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      z0, z1, rows, cols, sym0, c3, make_uint2(key0, key1));
  return static_cast<int>(cudaGetLastError());
}

const char* ofdm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
