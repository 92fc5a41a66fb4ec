// Unnormalized Walsh–Hadamard transform along one axis of a batch, with an
// optional row scale fused into the load: Y = H_L · diag(s) · X per slab.
//
// Replaces the Pallas kernels src/repro/kernels/fwht.py:30 (_fwht_kernel) and
// :43 (_fwht_kernel_scaled); the row scale is the nullable `scale` pointer.
//
// The input is viewed as (B, a, L, c): B problems, a slabs per problem, the
// transformed axis of length L, and c contiguous columns. Element
// (bb, i, l, j) is read at bb·x_batch_stride + (i·L + l)·c + j (a batch stride
// of 0 shares one input across the batch) and written contiguously. The
// wrapper (../fwht.py) composes one launch per factor of the radix split
// H_n = (H_a ⊗ I_b)(I_a ⊗ H_b): the first launch transforms the inner factor
// with the scale fused in, the next transforms the outer factor in place.
// Each launch runs a contiguous block of the one-pass butterfly's stages in
// the same order, so the composition is bitwise the one-pass transform.
//
// What bounds it: at the SRHT shape class (B=16, n=16384, d=256) each pass
// reads and writes 256 MiB, about 0.16 ms per pass at 3.35 TB/s; its
// B·d·n·log2(n) = 0.94 G adds are negligible. So it is bound by bytes.
//
// Design: a Pallas tile on the TPU holds a (16384, 128) column tile (8 MiB)
// in VMEM; a Hopper block has at most 227 KB of shared memory, fewer than
// four fp32 columns of that length. So each block holds an (L × 32) tile,
// L ≤ 1024 (128 KB), loads it once with coalesced 128-byte rows, runs all
// log2(L) stages in shared memory, and writes it once. Longer axes take the
// radix split: two passes, so the transform moves each byte twice instead of
// the ideal once.

#include <cuda_runtime.h>

namespace {

constexpr int TC = 32;    // columns per tile: one warp-wide 128-byte row
constexpr int NT = 256;   // threads per block

__global__ void __launch_bounds__(NT)
fwht_axis_kernel(const float* x, float* y, const float* __restrict__ scale,
                 int a, int L, int log2L, int c, long long x_batch_stride) {
  extern __shared__ float tile[];   // [L][TC]

  const int j0 = blockIdx.x * TC;
  const int i = blockIdx.y;
  const int bb = blockIdx.z;
  const int t = threadIdx.x % TC;
  const int r0 = threadIdx.x / TC;
  const int rstep = NT / TC;
  const int col = j0 + t;
  const bool live = col < c;

  // x and y may be the same buffer (in-place pass): every element of this
  // block's tile is read before the first write, and tiles are disjoint.
  const float* xin = x + (long long)bb * x_batch_stride + (long long)i * L * c;
  float* yout = y + ((long long)bb * a + i) * (long long)L * c;
  const float* s = scale ? scale + ((long long)bb * a + i) * L : nullptr;

  for (int l = r0; l < L; l += rstep) {
    float v = live ? xin[(long long)l * c + col] : 0.0f;
    if (s) v = __fmul_rn(v, s[l]);
    tile[l * TC + t] = v;
  }
  __syncthreads();

  const int half = L >> 1;
  for (int lh = 0; lh < log2L; ++lh) {
    const int h = 1 << lh;
    for (int p = r0; p < half; p += rstep) {
      const int lo = ((p >> lh) << (lh + 1)) + (p & (h - 1));
      const int hi = lo + h;
      const float u = tile[lo * TC + t];
      const float w = tile[hi * TC + t];
      tile[lo * TC + t] = u + w;
      tile[hi * TC + t] = u - w;
    }
    __syncthreads();
  }

  if (live)
    for (int l = r0; l < L; l += rstep) yout[(long long)l * c + col] = tile[l * TC + t];
}

}  // namespace

// Y (B, a·L·c) fp32 = per-slab H_L · diag(s) · X. `scale` is (B, a·L) fp32 or
// null; L is a power of two no larger than 1024. Returns cudaGetLastError()
// after the launch; the caller raises on a nonzero code.
extern "C" int fwht_axis_launch(const float* x, float* y, const float* scale,
                                int B, int a, int L, int c,
                                long long x_batch_stride, void* stream) {
  int log2L = 0;
  while ((1 << log2L) < L) ++log2L;
  const size_t smem = (size_t)L * TC * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fwht_axis_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((c + TC - 1) / TC, a, B);
  fwht_axis_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      x, y, scale, a, L, log2L, c, x_batch_stride);
  return (int)cudaGetLastError();
}
