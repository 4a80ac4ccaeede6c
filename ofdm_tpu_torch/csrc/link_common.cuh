// Device functions shared by the port's kernels: the Philox4x32-10 counter
// generator and the link's arithmetic chain (24-bit uniforms, quarter-range
// cos/sin, Gray/zig-zag QAM encode and slicer).
//
// Each function repeats, operation for operation, the plain PyTorch version
// in ofdm_tpu_torch/ops/{prng,link_kernel}.py.  The kernels are compiled
// with -fmad=false so no multiply-add pair is contracted into an FMA: the
// plain version rounds after every multiply, and so does this code.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ofdm {

// Philox4x32-10 (Salmon et al., SC'11; Random123's constants).  Counter
// (c.x, c.y, c.z, c.w), key (k.x, k.y).
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += 0x9E3779B9u;
    k.y += 0xBB67AE85u;
  }
  return c;
}

// u = ((w >> 8) & 0xFFFFFF) * 2^-24, floored at 2^-24: the Box-Muller
// radius sqrt(-2 ln u) then caps at 5.77.
__device__ __forceinline__ float uniform24_floored(uint32_t w) {
  const float u = static_cast<float>((w >> 8) & 0xFFFFFFu) * (1.0f / 16777216.0f);
  return fmaxf(u, 1.0f / 16777216.0f);
}

// (cos, sin) of 2*pi*u/2^24 for u in [0, 2^24): two quadrant bits, then
// degree-5 polynomials in t^2 on the quarter range (the same coefficients,
// rounded double -> float, as the plain version).
__device__ __forceinline__ void cossin_u24(uint32_t u, float& co, float& si) {
  const uint32_t q = u >> 22;
  const float t = static_cast<float>(u & 0x3FFFFFu) * (1.0f / 4194304.0f);
  const float z = t * t;
  float c = static_cast<float>(-2.3824535570835603e-05);
  c = c * z + static_cast<float>(0.0009177238850913491);
  c = c * z + static_cast<float>(-0.020862687553451876);
  c = c * z + static_cast<float>(0.253669322476019);
  c = c * z + static_cast<float>(-1.2337005342705918);
  c = c * z + static_cast<float>(0.9999999997799593);
  float s = static_cast<float>(-3.4318293237942273e-06);
  s = s * z + static_cast<float>(0.0001602546914451647);
  s = s * z + static_cast<float>(-0.004681657796259286);
  s = s * z + static_cast<float>(0.0796926037175787);
  s = s * z + static_cast<float>(-0.6459640955781804);
  s = s * z + static_cast<float>(1.5707963267681528);
  s = t * s;
  const bool swap = (q & 1u) != 0u;
  float c0 = swap ? s : c;
  float s0 = swap ? c : s;
  if (((q ^ (q >> 1)) & 1u) != 0u) c0 = -c0;
  if (q >= 2u) s0 = -s0;
  co = c0;
  si = s0;
}

// Square-QAM geometry and the slicer-units gain.
struct Qam {
  int order;  // M
  int m;      // sqrt(M)
  int logm;   // log2(m)
  int bits;   // log2(M)
  int gray;   // 1: Gray + zig-zag table, 0: natural order
  float scale;
};

// raw word -> (index, point): the reference table, computed arithmetically.
__device__ __forceinline__ int qam_encode(uint32_t raw, const Qam& q, float& sr, float& si) {
  const int tx = static_cast<int>(raw & static_cast<uint32_t>(q.order - 1));
  int p = tx;
  if (q.gray) {
    const int row = tx >> q.logm;
    const int col = tx & (q.m - 1);
    const int colz = (row & 1) ? (q.m - 1 - col) : col;
    const int g = (row << q.logm) | colz;
    p = g ^ (g >> 1);
  }
  const float c2 = static_cast<float>(p & (q.m - 1));
  const float r2 = static_cast<float>(p >> q.logm);
  const float mm1 = static_cast<float>(q.m - 1);
  sr = (2.0f * c2 - mm1) * q.scale;
  si = (mm1 - 2.0f * r2) * q.scale;
  return tx;
}

// Equalized point in slicer units -> index.  The clip happens in float
// before the int conversion: dead bins give gains near 1e10, and a
// float -> int conversion out of range is undefined.
__device__ __forceinline__ int qam_demap(float er, float ei, const Qam& q) {
  const float c0 = static_cast<float>(q.m - 1) * 0.5f;
  const float mf1 = static_cast<float>(q.m - 1);
  const int cc = static_cast<int>(fminf(fmaxf(rintf(er + c0), 0.0f), mf1));
  const int rr = static_cast<int>(fminf(fmaxf(rintf(c0 - ei), 0.0f), mf1));
  const int pp = rr * q.m + cc;
  if (!q.gray) return pp;
  int j = pp;
  for (int sh = 1; sh < q.bits; sh <<= 1) j ^= j >> sh;
  const int rowj = j >> q.logm;
  const int colj = j & (q.m - 1);
  const int colzj = (rowj & 1) ? (q.m - 1 - colj) : colj;
  return (rowj << q.logm) | colzj;
}

}  // namespace ofdm
