"""The yardstick's frozen numbers: the card's peaks and the operations a
bin of the link's chain needs.

Peaks, NVIDIA H100 SXM data sheet: 67 TFLOP/s float32 outside the tensor
cores counts an FMA as two, so one operation a lane a clock is half of it
(132 SMs x 128 lanes x 1.98 GHz); HBM3 3.35 TB/s.

Operations a bin, counted from csrc/link_kernel.cu when the diag chain was
first timed (chip_smoke.py's OPS_PER_BIN): Philox4x32-10 = 10 rounds x (2
mulhi + 2 mul + 4 xor + 2 key adds); the QAM encode (zig-zag, Gray, int to
float, affine); y = s * h; Box-Muller (uniform, log ~20, sqrt ~8, two
degree-5 polynomials and the quadrant select); MMSE (|y|^2, the symbol's
sum, the divide ~10, the equalizer; ZF: the complex multiply, 6); the
slicer (round, clip, convert, inverse Gray, zig-zag); popcount and
counters.  Per measured-power sample: |y|^2 and its sum, 4; per PAPR time
sample: |x|^2, its max and its sum, 5.  A radix-2 butterfly of an n-point
transform is 10 operations, its scale 2 a point; a term of a complex
product 8.  What an implementation recomputes is not counted.
"""

PEAK_OPS = 67e12 / 2
PEAK_BYTES = 3.35e12

OPS_PER_BIN = {
    "philox": 100,
    "encode": 21,
    "channel": 6,
    "noise": 72,
    "mmse": 24,
    "zf": 6,
    "demap": 26,
    "count": 5,
}
POWER_SUM_OPS = 4
PAPR_OPS = 5
BUTTERFLY_OPS = 10
SCALE_OPS = 2
PRODUCT_TERM_OPS = 8
