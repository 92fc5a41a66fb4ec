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
// A sketch pass is two passes, both written here (no library sort, scan or
// matmul), on the caller's stream, through a workspace of int32 words that
// the wrapper allocates: entries (B, n) of (i, sign) pairs | offsets (B, M+1) |
// the multi-chunk form's counts (B, M+1, C).
//
// 1. Bucket pass, once per problem: a stable counting sort of the targets.
//    offsets[b, 0..M] is the exclusive prefix of the in-range target counts
//    (offsets[b, M] their total); entries[b, ·] holds the source indices
//    grouped by target, increasing i within a group, each with its sign
//    beside it in one 8-byte entry (the "order" and "order_s" of the bucket
//    layout); the dropped targets follow as group M, also in increasing i,
//    so the indices are a permutation. Positions come from stable ranks,
//    never from the order of an atomic: a warp owns a contiguous segment of
//    i and walks it in rounds of 32; one ballot per bit of the target
//    groups a round's lanes by target (__match_any_sync was slower here:
//    PERF.md), a lane's rank is the popcount of the lower lanes of its
//    group, and the group's lowest lane adds the group to the warp's own
//    count of that target. The base of
//    (target t, segment w) is the exclusive prefix of the counts in t-major
//    order (segments in order within a target), taken in a fixed order.
//    - cluster form (chunk = 0; n ≤ 16384 and its counts fit shared
//      memory): a cluster of 8 blocks of 8 warps per problem, one launch.
//      Each block holds its slice of the targets and their signs and its
//      (M+1) × 8 counts in shared memory; it stores its per-target totals
//      into every block of the cluster (distributed shared memory), and
//      after one cluster barrier each block takes the prefix over targets
//      and the blocks before it from its own copy, and scatters its slice.
//      (One block of 32 warps per problem, tried first, was slower: one SM
//      did every round and every scattered store; PERF.md.)
//    - multi-chunk form (chunk > 0): segments of `chunk` targets, one warp
//      each, with their counts in the workspace, zeroed by a memset; three
//      launches: count, scan (one block per problem), scatter.
// 2. Segment sum: one warp per (problem b, output row r, slice of 32·E
//    columns), E columns a lane in registers. It reads its bucket's entries
//    coalesced, broadcasts them by __shfl_sync, keeps U source rows' loads
//    in flight (vector loads of VEC elements) and adds them in increasing i
//    from +0.0, with a separately rounded product and add (__fmul_rn,
//    __fadd_rn: no FMA contraction); it writes its slice of SA once, so an
//    empty bucket writes +0.0. The slice is the widest (up to 256 columns)
//    that still gives B·M·slices ≥ SEG_TARGET_WARPS warps, so the card has
//    work at B = 1 too. A row's sum is never split along i: the order is
//    that of a sequential index_add_, and repeats are bitwise. It is
//    launched as a programmatic dependent of the bucket pass (the bucket
//    blocks let it launch at once, and it waits with griddepcontrol.wait
//    before it reads a bucket), so its launch overlaps the bucket pass.
//
// So a pass makes two launches (cluster form), or a memset and four.
//
// What bounds it: at the top class (B = 16, n = 4096, d = 256, M = 512,
// per-problem fp32 A) the segment sum must read 64 MiB of A and write 8 MiB
// of SA, about 0.0225 ms at 3.35 TB/s; each in-range A row is read once per
// problem (once per slice, each slice its own columns), dropped rows never.
// Its B·n·d adds are negligible. The bucket pass moves 16 bytes a target; at
// B ≤ 16 its latency (a launch, two walks and a cluster barrier), not its
// bytes, is its time; at B = 1 it is most of the pass.

#include <cstdint>
#include <cstring>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "a_stream.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int CL_K = 8;                  // blocks (one cluster) per problem in the cluster form
constexpr int CL_NT = 256;               // threads of each
constexpr int CL_NW = CL_NT / 32;        // its warps, one segment each
constexpr int CL_ST = CL_NW + 1;         // row stride of its (target, warp) counts
constexpr int CL_MAX_N = 16384;          // largest n of the cluster form
constexpr size_t SMEM_MAX = 232448 - 1024;   // dynamic shared memory of a cluster-form block:
                                             // the 227 KB a block may use, less its static part
constexpr int LOAD_IT = 4;               // targets a thread loads at once
constexpr int SCAN_NT = 1024;            // threads of a multi-chunk scan block
constexpr int SCAN_IT = 16;              // counts a thread of it takes per tile
constexpr int CHUNK_WARPS = 8;           // warps per block of the multi-chunk count and scatter
constexpr int SEG_NT = 256;              // threads of a segment-sum block
constexpr int SEG_WARPS = SEG_NT / 32;
constexpr long long SEG_TARGET_WARPS = 4096;   // segment-sum warps that keep 132 SMs busy

// Measurement builds only (launch/anatomy.py): SJLT_OMIT 1 leaves out the
// segment sum; 2 and 3 also cut the cluster-form bucket blocks short: they
// return at once (2) or after their scan (3); 4 leaves out the bucket pass,
// so the segment sum reads the buckets an earlier launch left in the
// workspace. Their results are wrong and are not looked at.
#ifndef SJLT_OMIT
#define SJLT_OMIT 0
#endif

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// The lanes of this warp whose key equals this lane's, from one ballot per
// key bit (keys below 2^bits): __match_any_sync in `bits` ballots.
__device__ __forceinline__ unsigned match_key(unsigned key, int bits) {
  unsigned peers = FULL;
  for (int b = 0; b < bits; ++b) {
    const unsigned bit = (key >> b) & 1u;
    const unsigned set = __ballot_sync(FULL, bit);
    peers &= bit ? set : ~set;
  }
  return peers;
}

// One warp's walk over the targets i ∈ [lo, hi) of a problem, in rounds of
// 32, in increasing i; tgt[i - off] is target i and signs[i - off] its sign.
// count[t·st] is the warp's own count of target t (M for a dropped one).
// Without SCATTER it counts. With SCATTER count[] holds the bases: target i
// goes to base + (earlier i of its target in the segment), and the entry
// there receives i and its sign.
template <bool SCATTER>
__device__ __forceinline__ void walk(const int* tgt, int off, int lo, int hi, int M,
                                     int* count, int st, const float* signs, int2* ent) {
  const int lane = threadIdx.x & 31;
  const unsigned below = lanemask_lt();
  const int bits = 32 - __clz(M + 1);              // keys 0..M + 1, M + 1 for no target
  for (int j = lo; j < hi; j += 32) {
    const int i = j + lane;
    int t = M + 1;                                 // lanes past hi take no part
    if (i < hi) {
      t = tgt[i - off];
      if ((unsigned)t >= (unsigned)M) t = M;
    }
    const unsigned peers = match_key(t, bits);
    const int rank = __popc(peers & below);
    int* c = count + (long long)(t > M ? 0 : t) * st;
    if (SCATTER && t <= M) ent[*c + rank] = make_int2(i, __float_as_int(signs[i - off]));
    __syncwarp();                                  // every base read before it moves
    if (t <= M && rank == 0) *c += __popc(peers);
    __syncwarp();
  }
}

// Exclusive prefix of x over the NT threads of the block, in thread order;
// *total receives the block's sum.
template <int NT>
__device__ __forceinline__ int block_scan(int x, int* total) {
  __shared__ int part[NT / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) part[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int y = lane < NT / 32 ? part[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int z = __shfl_up_sync(FULL, y, o);
      if (lane >= o) y += z;
    }
    if (lane < NT / 32) part[lane] = y;
  }
  __syncthreads();
  *total = part[NT / 32 - 1];
  const int excl = (warp ? part[warp - 1] : 0) + incl - x;
  __syncthreads();                                 // part is rewritten by the next scan
  return excl;
}

// Exclusive prefix, in place, of the counts h[t·st + w] (t < rows, w < cols),
// in t-major order, by one block of SCAN_NT threads in a fixed order;
// offsets[t] receives the prefix at (t, 0). A thread takes SCAN_IT
// consecutive counts per tile and steps through (t, w) without dividing.
__device__ void scan_counts(int* h, int rows, int cols, int st, int* offsets) {
  const int total = rows * cols;
  int carry = 0;
  for (int base = 0; base < total; base += SCAN_NT * SCAN_IT) {
    const int f0 = base + threadIdx.x * SCAN_IT;
    const int t0 = f0 / cols, w0 = f0 - t0 * cols;
    int v[SCAN_IT];
    int sum = 0;
    int t = t0, w = w0;
#pragma unroll
    for (int k = 0; k < SCAN_IT; ++k) {
      v[k] = f0 + k < total ? h[t * st + w] : 0;
      sum += v[k];
      if (++w == cols) w = 0, ++t;
    }
    int tile;
    int run = carry + block_scan<SCAN_NT>(sum, &tile);
    t = t0, w = w0;
#pragma unroll
    for (int k = 0; k < SCAN_IT; ++k) {
      if (f0 + k < total) {
        h[t * st + w] = run;
        if (w == 0) offsets[t] = run;
        run += v[k];
      }
      if (++w == cols) w = 0, ++t;
    }
    carry += tile;
  }
}

// cluster form: the CL_K blocks of cluster b sort problem b's n ≤ CL_MAX_N
// targets, block c the warp segments c·CL_NW .. c·CL_NW + CL_NW - 1
__global__ void __cluster_dims__(CL_K, 1, 1) __launch_bounds__(CL_NT)
bucket_cluster(const int* __restrict__ rows, const float* __restrict__ signs, int n, int M,
               int* __restrict__ offsets, int2* __restrict__ ent) {
  asm volatile("griddepcontrol.launch_dependents;");   // the segment sum may launch now
  if (SJLT_OMIT == 2) return;
  // split barrier around the loads: every block of the cluster has started
  // before any block stores into its shared memory
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.block_rank();
  const int b = blockIdx.x / CL_K;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int seg = ((n + CL_K * CL_NW - 1) / (CL_K * CL_NW) + 31) & ~31;
  const int lo0 = min(n, c * CL_NW * seg), hi0 = min(n, lo0 + CL_NW * seg);
  extern __shared__ int smem[];
  int* count = smem;                               // (M + 1) × CL_ST
  int* tots = count + (M + 1) * CL_ST;             // (CL_K, M + 1): every block's count
  int* all = tots + CL_K * (M + 1);                // per target: the problem's count
  int* before = all + (M + 1);                     // per target: the blocks' before this one
  int* tgt = before + (M + 1);                     // this block's targets
  float* sgn = reinterpret_cast<float*>(tgt + CL_NW * seg);   // and their signs
  const long long pb = (long long)b * n;
  for (int k0 = lo0; k0 < hi0; k0 += LOAD_IT * CL_NT) {   // LOAD_IT loads of each in flight
    int tv[LOAD_IT];
    float sv[LOAD_IT];
#pragma unroll
    for (int q = 0; q < LOAD_IT; ++q) {
      const int k = k0 + q * CL_NT + tid;
      if (k < hi0) tv[q] = rows[pb + k], sv[q] = signs[pb + k];
    }
#pragma unroll
    for (int q = 0; q < LOAD_IT; ++q) {
      const int k = k0 + q * CL_NT + tid;
      if (k < hi0) tgt[k - lo0] = tv[q], sgn[k - lo0] = sv[q];
    }
  }
  for (int k = tid; k < (M + 1) * CL_ST; k += CL_NT) count[k] = 0;
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  __syncthreads();
  const int lo = min(hi0, lo0 + warp * seg), hi = min(hi0, lo + seg);
  walk<false>(tgt, lo0, lo, hi, M, count + warp, CL_ST, nullptr, nullptr);
  __syncthreads();
  for (int t = tid; t <= M; t += CL_NT) {          // this block's prefix over its warps
    int run = 0;
#pragma unroll
    for (int w = 0; w < CL_NW; ++w) {
      const int h = count[t * CL_ST + w];
      count[t * CL_ST + w] = run;
      run += h;
    }
#pragma unroll
    for (int r = 0; r < CL_K; ++r)                 // its count, into every block of the cluster
      cluster.map_shared_rank(tots, r)[c * (M + 1) + t] = run;
  }
  cluster.sync();                                  // every block holds every block's counts
  const int tpt = (M + CL_NT) / CL_NT;             // targets per thread, contiguous
  const int t0 = min(M + 1, tid * tpt), t1 = min(M + 1, t0 + tpt);
  int mine = 0;
  for (int t = t0; t < t1; ++t) {
    int a = 0, bf = 0;
#pragma unroll
    for (int r = 0; r < CL_K; ++r) {
      const int v = tots[r * (M + 1) + t];
      a += v;
      bf += r < c ? v : 0;
    }
    all[t] = a;
    before[t] = bf;
    mine += a;
  }
  int total;
  int run = block_scan<CL_NT>(mine, &total);
  for (int t = t0; t < t1; ++t) {
    const int base = run + before[t];
#pragma unroll
    for (int w = 0; w < CL_NW; ++w) count[t * CL_ST + w] += base;
    if (c == 0) offsets[(long long)b * (M + 1) + t] = run;
    run += all[t];
  }
  __syncthreads();
  if (SJLT_OMIT == 3) return;
  walk<true>(tgt, lo0, lo, hi, M, count + warp, CL_ST, sgn, ent + pb);
}

// multi-chunk form: warp c of problem blockIdx.y counts (or scatters) its chunk
template <bool SCATTER>
__global__ void __launch_bounds__(CHUNK_WARPS * 32)
bucket_chunks(const int* __restrict__ rows, const float* __restrict__ signs, int n, int M,
              int chunk, int C, int* counts, int2* __restrict__ ent) {
  const int b = blockIdx.y;
  const int c = blockIdx.x * CHUNK_WARPS + (threadIdx.x >> 5);
  if (c >= C) return;                              // whole warps
  const long long pb = (long long)b * n;
  const int lo = c * chunk;
  walk<SCATTER>(rows + pb, 0, lo, min(n, lo + chunk), M,
                counts + (long long)b * (M + 1) * C + c, C, signs + pb, ent + pb);
}

__global__ void __launch_bounds__(SCAN_NT)
bucket_scan(int* counts, int M, int C, int* offsets) {
  const int b = blockIdx.x;
  scan_counts(counts + (long long)b * (M + 1) * C, M + 1, C, C, offsets + (long long)b * (M + 1));
}

template <int BYTES> struct RawOf;
template <> struct RawOf<1> { using T = uint8_t; };
template <> struct RawOf<2> { using T = uint16_t; };
template <> struct RawOf<4> { using T = uint32_t; };
template <> struct RawOf<8> { using T = uint2; };
template <> struct RawOf<16> { using T = uint4; };

// VEC consecutive elements of A at p (aligned to their size) as fp32, in one load
template <int K, int VEC>
__device__ __forceinline__ void load_vec(const typename AElem<K>::T* p, float* v) {
  using T = typename AElem<K>::T;
  using R = typename RawOf<sizeof(T) * VEC>::T;
  const R raw = *reinterpret_cast<const R*>(p);
  T x[VEC];
  memcpy(x, &raw, sizeof raw);
#pragma unroll
  for (int k = 0; k < VEC; ++k) v[k] = AElem<K>::load(&x[k]);
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  if constexpr (VEC == 1) {
    *p = v[0];
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int q = 0; q < VEC; q += 4)
      *reinterpret_cast<float4*>(p + q) = make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]);
  }
}

// warp (b, r, slice): SA_b[r, slice] = Σ over bucket r of problem b, in order
template <int K, int E, int VEC>
__global__ void __launch_bounds__(SEG_NT, 4)
segment_sum(const typename AElem<K>::T* __restrict__ A, long long a_batch_stride,
            const int* __restrict__ offsets, const int2* __restrict__ ent,
            float* __restrict__ out, int n, int d, int M, int slices, long long warps) {
  constexpr int NV = E / VEC;          // loads of VEC columns a lane per source row
  constexpr int U = E >= 8 ? 4 : 8;    // source rows whose loads are in flight together
  const long long gw = (long long)blockIdx.x * SEG_WARPS + (threadIdx.x >> 5);
  if (gw >= warps) return;             // whole warps
  const int lane = threadIdx.x & 31;
  asm volatile("griddepcontrol.wait;" ::: "memory");   // the bucket pass has finished
  const int s = (int)(gw % slices);
  const long long br = gw / slices;    // b·M + r
  const int b = (int)(br / M);
  const int col = s * 32 * E + lane * VEC;   // load k: columns col + k·32·VEC + [0, VEC)
  const typename AElem<K>::T* Ab = A + (long long)b * a_batch_stride;
  const long long pb = (long long)b * n;
  const int beg = offsets[br + b], end = offsets[br + b + 1];   // row b has M + 1 entries
  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.0f;
  for (int base = beg; base < end; base += 32) {
    const int cnt = min(32, end - base);
    const int2 entry = lane < cnt ? ent[pb + base + lane] : make_int2(0, 0);
    const int my_i = entry.x;
    const float my_s = __int_as_float(entry.y);
    for (int j = 0; j < cnt; j += U) {
      float v[U][E];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long row = __shfl_sync(FULL, my_i, (j + u) & 31);
#pragma unroll
        for (int k = 0; k < NV; ++k) {
          const int c = col + k * 32 * VEC;
          if (j + u < cnt && c < d) {
            load_vec<K, VEC>(Ab + row * d + c, &v[u][k * VEC]);
          } else {
#pragma unroll
            for (int q = 0; q < VEC; ++q) v[u][k * VEC + q] = 0.0f;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float sg = __shfl_sync(FULL, my_s, (j + u) & 31);
        if (j + u < cnt) {
#pragma unroll
          for (int e = 0; e < E; ++e) acc[e] = __fadd_rn(acc[e], __fmul_rn(sg, v[u][e]));
        }
      }
    }
  }
  float* o = out + br * d;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int c = col + k * 32 * VEC;
    if (c < d) store_vec<VEC>(o + c, &acc[k * VEC]);
  }
}

// The arguments of a segment sum's launch
struct SegArgs {
  const void* A;
  long long a_batch_stride;
  const int* offsets;
  const int2* ent;
  float* out;
  int B, n, d, M;
  cudaStream_t stream;
};

template <int K, int E, int VEC>
void launch_segment(const SegArgs& a) {
  const int slices = (a.d + 32 * E - 1) / (32 * E);
  const long long warps = (long long)a.B * a.M * slices;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((warps + SEG_WARPS - 1) / SEG_WARPS));
  cfg.blockDim = dim3(SEG_NT);
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;   // overlaps its launch
  attr[0].val.programmaticStreamSerializationAllowed = 1;            // with the bucket pass
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, segment_sum<K, E, VEC>,
                     static_cast<const typename AElem<K>::T*>(a.A), a.a_batch_stride,
                     a.offsets, a.ent, a.out, a.n, a.d, a.M, slices, warps);
}

template <int K, int E>
void launch_vec(int vec, const SegArgs& a) {
  constexpr int MAX_VEC = 16 / (int)sizeof(typename AElem<K>::T);
  if constexpr (E >= 8 && MAX_VEC >= 8)
    if (vec == 8) return launch_segment<K, E, 8>(a);
  if constexpr (E >= 4)
    if (vec == 4) return launch_segment<K, E, 4>(a);
  if constexpr (E >= 2)
    if (vec == 2) return launch_segment<K, E, 2>(a);
  launch_segment<K, E, 1>(a);
}

// The segment sum of kind K: the slice width 32·E and the vector width VEC
// (the widest load that d, A and out keep aligned) are chosen here.
template <int K>
void launch(const void* A, long long a_batch_stride, const int* offsets, const int2* ent,
            float* out, int B, int n, int d, int M, cudaStream_t stream) {
  constexpr int esize = (int)sizeof(typename AElem<K>::T);
  int e = 1;
  while (e < 8 && 32 * e < d) e <<= 1;
  while (e > 1 && (long long)B * M * ((d + 32 * e - 1) / (32 * e)) < SEG_TARGET_WARPS) e >>= 1;
  int vec = e < 16 / esize ? e : 16 / esize;
  while (vec > 1 && (d % vec || reinterpret_cast<uintptr_t>(A) % (vec * esize) ||
                     reinterpret_cast<uintptr_t>(out) % (4 * (vec < 4 ? vec : 4))))
    vec >>= 1;
  const SegArgs a{A, a_batch_stride, offsets, ent, out, B, n, d, M, stream};
  switch (e) {
    case 8: launch_vec<K, 8>(vec, a); break;
    case 4: launch_vec<K, 4>(vec, a); break;
    case 2: launch_vec<K, 2>(vec, a); break;
    default: launch_vec<K, 1>(vec, a);
  }
}

}  // namespace

// SA (B, M, d) fp32 from A (per problem: a_batch_stride = n·d; shared: 0),
// rows (B, n) int32 and signs (B, n) fp32, through the workspace `ws`
// (layout above; ../sjlt.py sizes it). `chunk` selects the bucket pass's
// form: 0 for a cluster of blocks per problem, else the targets per warp of the
// multi-chunk form (a multiple of 32; ../sjlt.py's bucket_chunk picks it).
// `a_kind` is an AKind (a_stream.cuh). Returns cudaGetLastError() after the
// launches, or cudaErrorInvalidValue for an argument the kernels do not
// take (unknown a_kind, n ≥ 2^26, a cluster form that does not fit); the
// caller raises on a nonzero code.
extern "C" int sjlt_launch(const void* A, long long a_batch_stride, const int* rows,
                           const float* signs, float* out, int* ws, int B, int n, int d,
                           int M, int chunk, int a_kind, void* stream) {
  if (a_kind < A_F32 || a_kind > A_I8 || B < 0 || B > 65535 || n < 0 || n >= (1 << 26) ||
      d < 0 || M < 1 || chunk < 0 || chunk % 32)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || d == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int2* ent = reinterpret_cast<int2*>(ws);
  int* offsets = ws + 2LL * B * n;
  if (SJLT_OMIT == 4) {
  } else if (chunk == 0) {
    const int seg = ((n + CL_K * CL_NW - 1) / (CL_K * CL_NW) + 31) & ~31;
    const size_t smem =
        sizeof(int) * ((size_t)(M + 1) * (CL_ST + CL_K + 2) + 2 * (size_t)CL_NW * seg);
    if (n > CL_MAX_N || smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
    static bool attr_set = false;
    if (!attr_set) {
      const cudaError_t e = cudaFuncSetAttribute(
          bucket_cluster, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_MAX);
      if (e != cudaSuccess) return (int)e;
      attr_set = true;
    }
    bucket_cluster<<<B * CL_K, CL_NT, smem, s>>>(rows, signs, n, M, offsets, ent);
  } else {
    const int C = n > 0 ? (n + chunk - 1) / chunk : 1;
    if ((long long)(M + 1) * C >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    int* counts = offsets + (long long)B * (M + 1);
    cudaError_t e = cudaMemsetAsync(counts, 0, sizeof(int) * (size_t)B * (M + 1) * C, s);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((C + CHUNK_WARPS - 1) / CHUNK_WARPS, B);
    bucket_chunks<false><<<grid, CHUNK_WARPS * 32, 0, s>>>(rows, signs, n, M, chunk, C, counts,
                                                          ent);
    bucket_scan<<<B, SCAN_NT, 0, s>>>(counts, M, C, offsets);
    bucket_chunks<true><<<grid, CHUNK_WARPS * 32, 0, s>>>(rows, signs, n, M, chunk, C, counts,
                                                         ent);
  }
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || (SJLT_OMIT >= 1 && SJLT_OMIT <= 3)) return (int)e;
  DISPATCH_A_KIND(a_kind, A, a_batch_stride, offsets, ent, out, B, n, d, M, s)
  return (int)cudaGetLastError();
}
