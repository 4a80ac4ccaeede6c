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
// ~150 fp32/int32 instructions on it (Philox, log, sqrt, two Horner
// chains), so it is bound by issue rate, not by its writes.  Design: a
// grid-stride loop over elements with coalesced stores; no shared memory.

#include <cstdint>
#include <cuda_runtime.h>

#include "link_common.cuh"

// A named namespace, so profilers show the kernels' names.
namespace ofdm_sampler {

__global__ void boxmuller_kernel(float* z0, float* z1, long long count, uint2 key) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < count;
       i += stride) {
    const uint4 w = ofdm::philox4x32_10(
        make_uint4(static_cast<uint32_t>(i), static_cast<uint32_t>(i >> 32), 0u, 0u), key);
    const float u1 = ofdm::uniform24_floored(w.y);
    const float rad = sqrtf(-2.0f * logf(u1));
    float co, si;
    ofdm::cossin_u24((w.z >> 8) & 0xFFFFFFu, co, si);
    z0[i] = rad * co;
    z1[i] = rad * si;
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

}  // namespace ofdm_sampler

using namespace ofdm_sampler;

extern "C" {

int ofdm_boxmuller(float* z0, float* z1, long long count, unsigned int key0, unsigned int key1,
                   void* stream_ptr) {
  if (count < 1) return cudaErrorInvalidValue;
  boxmuller_kernel<<<grid_for(count), 256, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      z0, z1, count, make_uint2(key0, key1));
  return static_cast<int>(cudaGetLastError());
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
