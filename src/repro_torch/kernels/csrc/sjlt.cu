// s = 1 SJLT sketch of a batch: (SA)_b[r] = Σ_{i : rows_b[i] = r} signs_b[i]·A_b[i].
//
// Replaces the Pallas kernels src/repro/kernels/sjlt.py:140
// (_sjlt_kernel_batched) and, as its B = 1 shared-A case, :72 (_sjlt_kernel).
// The TPU kernels build a signed one-hot (m × block) matrix in VMEM and
// multiply it on the MXU, because a scatter is serial there. On Hopper the
// sketch is a segment sum and is written as one: no one-hot, no matmul.
//
// Inputs: A (n, d) shared (a_batch_stride = 0) or (B, n, d) per problem,
// stored as fp32, bf16 or int8 codes (`a_kind`); rows (B, n) int32 targets,
// of which those outside [0, M) drop out (the reference's padding); signs
// (B, n) fp32, pre-folded with w^{1/2} and int8 scales and, in the bf16 and
// int8 modes, already rounded to bf16 by the wrapper (../sjlt.py). In those
// modes the kernel rounds an fp32 A element to bf16 on load, so every
// product of two bf16 values is exact in fp32.
//
// Determinism: each output row sums its source rows in one fixed order,
// increasing i, starting from 0.0, with a separately rounded product and add
// (__fmul_rn, __fadd_rn: no FMA contraction) and no atomics. Repeats are
// bitwise, and the order is that of a sequential index_add_.
//
// What bounds it: at the top class (B = 16, n = 4096, d = 256, M = 512,
// per-problem fp32 A) it must read 64 MiB of A and write 8 MiB of SA,
// about 0.0225 ms at 3.35 TB/s; its B·n·d adds are negligible. So it is
// bound by bytes.
//
// Design: one CTA per (d-tile of 256 columns, tile of R = 32 output rows,
// problem b). It scans that problem's n targets in rounds of CH: each warp
// takes a contiguous segment of the round, finds the targets inside its row
// tile with a warp ballot, and compacts them, in increasing i, into its own
// list in shared memory. Taking the warps' lists in warp order then visits
// the matches in increasing i with no block-wide prefix sum. Every thread
// owns two columns of the CTA's (32 × 256) fp32 accumulator tile in shared
// memory, so the adds need no synchronization; a thread loads the A values
// of UNROLL matches before it adds them, to keep loads in flight. Every A
// row is read by exactly one CTA per d-tile, with coalesced row loads; the
// target scan rereads 16 KB per problem and row tile, from L2. SA is
// written once.

#include <cstdint>
#include <cuda_runtime.h>

#include "a_stream.cuh"

namespace {

constexpr int R = 32;          // output rows per CTA (the low 5 bits of a list entry)
constexpr int NT = 128;        // threads per CTA
constexpr int NW = NT / 32;    // warps
constexpr int CPT = 2;         // columns per thread
constexpr int DT = NT * CPT;   // columns per CTA
constexpr int CH = 1024;       // targets scanned per round
constexpr int SEG = CH / NW;   // targets per warp per round
constexpr int UNROLL = 8;      // matches whose A values are loaded together

template <int K>
__global__ void __launch_bounds__(NT)
sjlt_kernel(const typename AElem<K>::T* __restrict__ A, long long a_batch_stride,
            const int* __restrict__ rows, const float* __restrict__ signs,
            float* __restrict__ out, int n, int d, int M) {
  __shared__ float acc[R][DT];
  __shared__ int list_e[CH];       // (i << 5) | local row, per warp segment
  __shared__ float list_s[CH];     // the match's sign
  __shared__ int count[NW];

  const int b = blockIdx.z;
  const int r0 = blockIdx.y * R;
  const int d0 = blockIdx.x * DT;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const typename AElem<K>::T* Ab = A + (long long)b * a_batch_stride;
  const int* rb = rows + (long long)b * n;
  const float* sb = signs + (long long)b * n;

#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int k = 0; k < CPT; ++k) acc[r][tid + k * NT] = 0.0f;

  bool col_live[CPT];
#pragma unroll
  for (int k = 0; k < CPT; ++k) col_live[k] = d0 + tid + k * NT < d;

  for (int c0 = 0; c0 < n; c0 += CH) {
    // compaction: warp `warp` lists the hits of targets [c0 + warp·SEG, +SEG)
    int cnt = 0;
    const int base = warp * SEG;
    for (int j = 0; j < SEG; j += 32) {
      const int i = c0 + base + j + lane;
      const int t = i < n ? rb[i] : -1;
      const bool hit = (unsigned)(t - r0) < (unsigned)R && t < M;
      const unsigned mask = __ballot_sync(0xffffffffu, hit);
      if (hit) {
        const int pos = base + cnt + __popc(mask & ((1u << lane) - 1u));
        list_e[pos] = (i << 5) | (t - r0);
        list_s[pos] = sb[i];
      }
      cnt += __popc(mask);
    }
    if (lane == 0) count[warp] = cnt;
    __syncthreads();

    // accumulation: the warps' lists in warp order, so increasing i
    for (int w = 0; w < NW; ++w) {
      const int cw = count[w];
      const int* le = list_e + w * SEG;
      const float* ls = list_s + w * SEG;
      int j = 0;
      for (; j + UNROLL <= cw; j += UNROLL) {
        float v[UNROLL][CPT];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const long long row = le[j + u] >> 5;
#pragma unroll
          for (int k = 0; k < CPT; ++k)
            v[u][k] = col_live[k] ? AElem<K>::load(Ab + row * d + d0 + tid + k * NT) : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int r = le[j + u] & (R - 1);
          const float s = ls[j + u];
#pragma unroll
          for (int k = 0; k < CPT; ++k)
            acc[r][tid + k * NT] = __fadd_rn(acc[r][tid + k * NT], __fmul_rn(s, v[u][k]));
        }
      }
      for (; j < cw; ++j) {
        const long long row = le[j] >> 5;
        const int r = le[j] & (R - 1);
        const float s = ls[j];
#pragma unroll
        for (int k = 0; k < CPT; ++k) {
          const float v = col_live[k] ? AElem<K>::load(Ab + row * d + d0 + tid + k * NT) : 0.0f;
          acc[r][tid + k * NT] = __fadd_rn(acc[r][tid + k * NT], __fmul_rn(s, v));
        }
      }
    }
    __syncthreads();   // the lists are rewritten by the next round
  }

  float* ob = out + ((long long)b * M + r0) * d;
  for (int r = 0; r < R && r0 + r < M; ++r)
#pragma unroll
    for (int k = 0; k < CPT; ++k)
      if (col_live[k]) ob[(long long)r * d + d0 + tid + k * NT] = acc[r][tid + k * NT];
}

template <int K>
void launch(const void* A, long long a_batch_stride, const int* rows,
            const float* signs, float* out, int B, int n, int d, int M,
            cudaStream_t stream) {
  const dim3 grid((d + DT - 1) / DT, (M + R - 1) / R, B);
  sjlt_kernel<K><<<grid, NT, 0, stream>>>(
      static_cast<const typename AElem<K>::T*>(A), a_batch_stride, rows, signs,
      out, n, d, M);
}

}  // namespace

// SA (B, M, d) fp32 from A (per problem: a_batch_stride = n·d; shared: 0),
// rows (B, n) int32 and signs (B, n) fp32. `a_kind` is an AKind
// (a_stream.cuh). n must be below 2^26 (list entries pack i << 5). Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for an unknown
// a_kind or too large an n); the caller raises on a nonzero code.
extern "C" int sjlt_launch(const void* A, long long a_batch_stride,
                           const int* rows, const float* signs, float* out,
                           int B, int n, int d, int M, int a_kind, void* stream) {
  if (n >= (1 << 26)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  DISPATCH_A_KIND(a_kind, A, a_batch_stride, rows, signs, out, B, n, d, M, s)
  return (int)cudaGetLastError();
}
