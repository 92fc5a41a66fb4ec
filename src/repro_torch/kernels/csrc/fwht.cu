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
//
// Compute dtypes (../precision.py): the bf16 and int8 modes keep a bf16
// tile (`Tile` = __nv_bfloat16): the element is rounded to bf16 on load (an
// int8 code converts exactly), multiplied by the bf16 row scale exactly in
// fp32 and rounded to bf16, and every butterfly add or subtract is taken in
// fp32 and rounded to bf16, which is the exact bf16 operation (24 ≥ 2·8+2
// bits, so the double rounding is innocuous). The output is bf16, which
// halves the (B, n, d) stack. A 2-byte tile fits L ≤ 2048 (128 KB); at
// n = 16384 the radix split is still two passes of 128.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TC = 32;    // columns per tile: one warp-wide row
constexpr int NT = 256;   // threads per block

// in_kind of fwht_axis_launch
enum InKind { IN_F32 = 0, IN_BF16 = 1, IN_I8 = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }

// an fp32 result rounded to the tile's type
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// x and scale elements of type In and Tile; the tile, the butterflies and
// the output in Tile (fp32, or bf16 with every operation rounded to bf16)
template <typename In, typename Tile>
__global__ void __launch_bounds__(NT)
fwht_axis_kernel(const In* x, Tile* y, const Tile* __restrict__ scale,
                 int a, int L, int log2L, int c, long long x_batch_stride) {
  extern __shared__ __align__(16) unsigned char smem[];
  Tile* tile = reinterpret_cast<Tile*>(smem);   // [L][TC]

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
  const In* xin = x + (long long)bb * x_batch_stride + (long long)i * L * c;
  Tile* yout = y + ((long long)bb * a + i) * (long long)L * c;
  const Tile* s = scale ? scale + ((long long)bb * a + i) * L : nullptr;

  for (int l = r0; l < L; l += rstep) {
    Tile v = from_f32<Tile>(live ? to_f32(xin[(long long)l * c + col]) : 0.0f);
    if (s) v = from_f32<Tile>(__fmul_rn(to_f32(v), to_f32(s[l])));
    tile[l * TC + t] = v;
  }
  __syncthreads();

  const int half = L >> 1;
  for (int lh = 0; lh < log2L; ++lh) {
    const int h = 1 << lh;
    for (int p = r0; p < half; p += rstep) {
      const int lo = ((p >> lh) << (lh + 1)) + (p & (h - 1));
      const int hi = lo + h;
      const float u = to_f32(tile[lo * TC + t]);
      const float w = to_f32(tile[hi * TC + t]);
      tile[lo * TC + t] = from_f32<Tile>(__fadd_rn(u, w));
      tile[hi * TC + t] = from_f32<Tile>(__fsub_rn(u, w));
    }
    __syncthreads();
  }

  if (live)
    for (int l = r0; l < L; l += rstep) yout[(long long)l * c + col] = tile[l * TC + t];
}

template <typename In, typename Tile>
int launch(const void* x, void* y, const void* scale, int B, int a, int L, int c,
           long long x_batch_stride, cudaStream_t stream) {
  int log2L = 0;
  while ((1 << log2L) < L) ++log2L;
  const size_t smem = (size_t)L * TC * sizeof(Tile);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fwht_axis_kernel<In, Tile>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((c + TC - 1) / TC, a, B);
  fwht_axis_kernel<In, Tile><<<grid, NT, smem, stream>>>(
      static_cast<const In*>(x), static_cast<Tile*>(y),
      static_cast<const Tile*>(scale), a, L, log2L, c, x_batch_stride);
  return (int)cudaGetLastError();
}

}  // namespace

// Y (B, a·L·c) = per-slab H_L · diag(s) · X. X holds fp32, bf16 or int8
// elements (`in_kind`, an InKind); with `bf16_tile` 0 the tile, the scale
// and Y are fp32 (X must be fp32), with 1 they are bf16. `scale` is
// (B, a·L) or null; L is a power of two with L·32·sizeof(tile element) no
// larger than a block's shared memory. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for an unsupported combination); the caller
// raises on a nonzero code.
extern "C" int fwht_axis_launch(const void* x, void* y, const void* scale,
                                int B, int a, int L, int c,
                                long long x_batch_stride, int in_kind,
                                int bf16_tile, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!bf16_tile)
    return in_kind == IN_F32
               ? launch<float, float>(x, y, scale, B, a, L, c, x_batch_stride, s)
               : (int)cudaErrorInvalidValue;
  switch (in_kind) {
    case IN_F32:
      return launch<float, __nv_bfloat16>(x, y, scale, B, a, L, c, x_batch_stride, s);
    case IN_BF16:
      return launch<__nv_bfloat16, __nv_bfloat16>(x, y, scale, B, a, L, c,
                                                 x_batch_stride, s);
    case IN_I8:
      return launch<int8_t, __nv_bfloat16>(x, y, scale, B, a, L, c, x_batch_stride, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
