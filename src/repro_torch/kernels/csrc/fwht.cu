// Unnormalized Walsh–Hadamard transform along one axis of a batch, with an
// optional row scale fused into the load: Y = H_L · diag(s) · X per slab.
//
// Replaces the Pallas kernels src/repro/kernels/fwht.py:30 (_fwht_kernel) and
// :43 (_fwht_kernel_scaled); the row scale is the nullable `scale` pointer.
//
// The input is viewed as (B, a, L, c): B problems, a slabs per problem, the
// transformed axis of length L, and c contiguous columns. Element
// (bb, i, l, j) is read at bb·x_batch_stride + (i·L + l)·c + j (a batch stride
// of 0 shares one input across the batch) and written contiguously. One
// launch transforms L ≤ 16384 (the capacity derived below); the wrapper
// (../fwht.py) composes one launch per factor of the radix split
// H_n = (H_a ⊗ I_b)(I_a ⊗ H_b) beyond it, the first launch with the scale
// fused in, the next in place.
//
// What bounds it: at the SRHT shape class (B=16, n=16384, d=256) one pass
// reads and writes 256 MiB in fp32, about 0.16 ms at 3.35 TB/s; its
// B·d·n·log2(n) = 0.94 G adds are negligible. So it is bound by bytes, and
// the design moves each byte once. What it reaches is set by its access
// pattern: each block reads and writes 32 bytes of every row of its slab,
// and its load, butterfly and store phases run in turn (two blocks an SM
// overlap them); launch/anatomy.py times it without its adds (FWHT_OMIT)
// beside a contiguous copy of the same bytes.
//
// Design: a Pallas tile on the TPU holds a (16384, 128) column tile (8 MiB)
// in VMEM; a Hopper block has at most 227 KB of shared memory. A thread
// block cluster of up to 8 blocks pools its blocks' shared memory. Each
// block holds a contiguous slab of ≤ 2048 rows × 32 bytes of columns (8 fp32
// or 16 bf16 columns: 64 KB), so a cluster holds 8 × 2048 = 16384 rows of
// one column group, the whole axis, in one launch, and two blocks share an
// SM, so one block's loads and stores overlap the other's butterflies (with
// 64-byte rows a 128 KB block has an SM to itself and its phases run in
// turn; 64-byte rows over 16-block clusters of 1024-row slabs fit fewer
// clusters on the card; both measured slower). Stage h of the one-pass
// butterfly pairs the rows whose index differs in bit log2(h), and the
// stages run lowest bit first. The low log2(slab) bits lie inside a block's
// slab, the top log2(cluster) bits select the block. So:
//   1. each of the block's 512 threads takes 2^R rows (R ≤ 3) that differ
//      in the round's bits times 16 bytes of columns (one group a thread at
//      a full slab), runs the round's R stages in registers on packed
//      values, and writes them back: rounds of 3 stages, one __syncthreads
//      each. The first round reads the input (the scale fused in), so the
//      slab is loaded once, with every thread's loads in flight together;
//      with one block per cluster the last round writes Y;
//   2. after a cluster barrier, each block gathers its 1/cluster share of
//      the rows r + slab·k (k over the cluster's blocks) through distributed
//      shared memory, runs the top log2(cluster) stages in registers and
//      writes Y; a second cluster barrier, signalled as soon as a block's
//      reads are done and waited on after its stores, keeps every slab
//      alive until all reads are done.
// Every stage applies the same fp32 (or bf16-rounded) add and subtract to
// the same pairs in the same stage order as the one-pass butterfly, so the
// result is bitwise the plain version's.
//
// Compute dtypes (../precision.py): the bf16 and int8 modes keep a bf16
// tile (`Tile` = __nv_bfloat16): the element is rounded to bf16 on load (an
// int8 code converts exactly), multiplied by the bf16 row scale exactly in
// fp32 and rounded to bf16, and every butterfly is a bf16x2 add and
// subtract rounded once to bf16: what the plain version's fp32 add rounded
// to bf16 gives (24 ≥ 2·8+2 bits, so its double rounding is innocuous). The
// output is bf16, which halves the (B, n, d) stack.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// Measurement builds only (launch/anatomy.py): FWHT_OMIT 1 leaves the
// butterflies' adds out, so the kernel only moves the data, in the same
// pattern; a normal build leaves it 0.
#ifndef FWHT_OMIT
#define FWHT_OMIT 0
#endif

constexpr int ROW_BYTES = 32;               // bytes of columns per block
constexpr int VPR = ROW_BYTES / 16;         // 16-byte vectors per slab row
constexpr int LG_MAX_SLAB = 11;             // 2048 rows · 32 B = 64 KB
constexpr int LG_MAX_CLUSTER = 3;           // 8 blocks: the portable limit
constexpr int ROUND_BITS = 3;               // stages per register round
// threads per block: one group of a round a thread at a full slab (512);
// 1024 threads an SM leave each 64 registers
constexpr int NT = (VPR << LG_MAX_SLAB) >> ROUND_BITS;

// in_kind of fwht_axis_launch
enum InKind { IN_F32 = 0, IN_BF16 = 1, IN_I8 = 2 };

// A tile element type: VEC elements per 16-byte vector, which registers
// hold packed; `round` is the rounding every stored value goes through
template <typename Tile> struct TileT;
template <> struct TileT<float> {
  static constexpr int VEC = 4;
  static __device__ __forceinline__ float round(float v) { return v; }
};
template <> struct TileT<__nv_bfloat16> {
  static constexpr int VEC = 8;
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }
// two values that are exactly bf16 (low 16 bits zero) in one word
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return (__float_as_uint(lo) >> 16) | (__float_as_uint(hi) & 0xFFFF0000u);
}

// One butterfly on every element of two packed vectors: (u, w) <- (u+w, u-w)
__device__ __forceinline__ void bfly_word(float, uint32_t& u, uint32_t& w) {
  const float a = __uint_as_float(u), b = __uint_as_float(w);
  u = __float_as_uint(__fadd_rn(a, b));
  w = __float_as_uint(__fsub_rn(a, b));
}
// two bf16 lanes at once, each sum and difference rounded once to bf16
__device__ __forceinline__ void bfly_word(__nv_bfloat16, uint32_t& u, uint32_t& w) {
  uint32_t sum, dif;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(sum) : "r"(u), "r"(w));
  asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(dif) : "r"(u), "r"(w));
  u = sum;
  w = dif;
}
template <typename Tile>
__device__ __forceinline__ void bfly(uint4& u, uint4& w) {
  if (FWHT_OMIT) return;
  bfly_word(Tile(), u.x, w.x);
  bfly_word(Tile(), u.y, w.y);
  bfly_word(Tile(), u.z, w.z);
  bfly_word(Tile(), u.w, w.w);
}

// VEC tile values (rounded, as floats) -> one packed vector
__device__ __forceinline__ uint4 pack(const float (&v)[4]) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
}
__device__ __forceinline__ uint4 pack(const float (&v)[8]) {
  return make_uint4(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]),
                    bf16_pair(v[4], v[5]), bf16_pair(v[6], v[7]));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }

// VEC input elements from an address aligned to their size
__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load_vec(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) { v[2 * k] = bf16_lo(w[k]); v[2 * k + 1] = bf16_hi(w[k]); }
}
__device__ __forceinline__ void load_vec(const int8_t* p, float (&v)[8]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[k] = (float)(int8_t)(u.x >> (8 * k));
    v[4 + k] = (float)(int8_t)(u.y >> (8 * k));
  }
}

// Cluster primitives (PTX): the block's rank, a shared address mapped into
// another block of the cluster, a 16-byte load from it, and the full
// cluster barrier.
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t map_to_rank(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}
__device__ __forceinline__ uint4 ld_cluster(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// What a block works on: its problem, slab and column group, and how the
// columns may be accessed.
template <typename In, typename Tile>
struct Slab {
  static constexpr int VEC = TileT<Tile>::VEC;
  const In* x;         // row 0 of this slab group's input (L rows of c)
  Tile* y;             // row 0 of its output
  const Tile* s;       // its L row scales, or null
  uint4* tile;         // this block's rows, [slab][VPR] vectors
  int c, j0, row0;     // columns, first column, first row (of L) held here
  bool vec_ok;         // c % VEC == 0 and aligned pointers: vector access

  // vector v of input row l (of L), rounded to the tile and scaled
  __device__ __forceinline__ uint4 load_input(int l, int v) const {
    const int col = j0 + v * VEC;
    float out[VEC];
    if (vec_ok) {
      if (col < c) {
        load_vec(x + (long long)l * c + col, out);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) out[e] = 0.0f;
      }
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        out[e] = col + e < c ? to_f32(x[(long long)l * c + col + e]) : 0.0f;
    }
    const float sl = s ? to_f32(s[l]) : 1.0f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      out[e] = TileT<Tile>::round(out[e]);
      if (s) out[e] = TileT<Tile>::round(__fmul_rn(out[e], sl));
    }
    return pack(out);
  }

  __device__ __forceinline__ void store_output(int l, int v, uint4 val) const {
    const int col = j0 + v * VEC;
    Tile* p = y + (long long)l * c + col;
    if (vec_ok) {
      if (col < c) *reinterpret_cast<uint4*>(p) = val;
    } else {
      const Tile* t = reinterpret_cast<const Tile*>(&val);
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        if (col + e < c) p[e] = t[e];
    }
  }
};

// Stages [0, R) of a group of 2^R rows whose index bits are the group's
// register index: the one-pass butterfly restricted to these rows.
template <int R, typename Tile>
__device__ __forceinline__ void butterfly(uint4 (&val)[1 << R]) {
#pragma unroll
  for (int lh = 0; lh < R; ++lh) {
#pragma unroll
    for (int e = 0; e < (1 << R); ++e)
      if (!(e & (1 << lh))) bfly<Tile>(val[e], val[e + (1 << lh)]);
  }
}

// Stages [b, b+R) on this block's slab: each group is 2^R slab rows that
// differ in bits [b, b+R) times one 16-byte vector of columns. The source
// is the input (first round) or the slab, the destination the slab or Y.
template <int R, typename In, typename Tile>
__device__ void local_round(const Slab<In, Tile>& sl, int lg_slab, int b, bool from_input,
                            bool to_output) {
  const int groups = (1 << (lg_slab - R)) * VPR;
  for (int gi = threadIdx.x; gi < groups; gi += NT) {
    const int v = gi % VPR;
    const int p = gi / VPR;
    const int base = ((p >> b) << (b + R)) | (p & ((1 << b) - 1));
    uint4 val[1 << R];
#pragma unroll
    for (int e = 0; e < (1 << R); ++e) {
      const int r = base + (e << b);
      val[e] = from_input ? sl.load_input(sl.row0 + r, v) : sl.tile[r * VPR + v];
    }
    butterfly<R, Tile>(val);
#pragma unroll
    for (int e = 0; e < (1 << R); ++e) {
      const int r = base + (e << b);
      if (to_output) sl.store_output(sl.row0 + r, v, val[e]);
      else sl.tile[r * VPR + v] = val[e];
    }
  }
}

// The top RC stages across the cluster's 2^RC slabs: this block's share of
// the (slab row, vector) groups, read from every block through distributed
// shared memory and written to Y. With a cluster every slab is full, so a
// thread has 2^(3-RC) groups of 2^RC vectors, 8 vectors in all: it reads
// them all before it signals the cluster barrier that lets the other blocks
// exit, and its stores overlap the wait.
template <int RC, typename In, typename Tile>
__device__ void cluster_round(const Slab<In, Tile>& sl, uint32_t rank) {
  constexpr int SHARE = (VPR << LG_MAX_SLAB) >> RC;
  constexpr int GROUPS = SHARE / NT;
  static_assert(GROUPS * NT == SHARE, "whole groups a thread");
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(sl.tile);
  uint4 val[GROUPS][1 << RC];
#pragma unroll
  for (int j = 0; j < GROUPS; ++j) {
    const int g = (int)rank * SHARE + threadIdx.x + j * NT;   // row g / VPR, vector g % VPR
#pragma unroll
    for (int k = 0; k < (1 << RC); ++k) val[j][k] = ld_cluster(map_to_rank(base + 16u * g, k));
  }
  cluster_arrive();   // done with the other blocks' slabs
#pragma unroll
  for (int j = 0; j < GROUPS; ++j) {
    const int g = (int)rank * SHARE + threadIdx.x + j * NT;
    butterfly<RC, Tile>(val[j]);
#pragma unroll
    for (int k = 0; k < (1 << RC); ++k)
      sl.store_output((k << LG_MAX_SLAB) + g / VPR, g % VPR, val[j][k]);
  }
  cluster_wait();     // no block exits while another still reads its slab
}

template <typename In, typename Tile>
__global__ void __launch_bounds__(NT, 1024 / NT)
fwht_axis_kernel(const In* x, Tile* y, const Tile* __restrict__ scale, int a, int L,
                 int c, long long x_batch_stride, int lg_slab, int lg_cluster, int vec_ok) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int TC = TileT<Tile>::VEC * VPR;   // columns per block
  // the first round reads at most 128 bytes of input a thread (8 rows of
  // 16 bytes; 4 rows of 32 when fp32 input fills a bf16 tile)
  constexpr int R0 = sizeof(In) * TileT<Tile>::VEC > 16 ? 2 : ROUND_BITS;

  const uint32_t rank = lg_cluster ? cluster_rank() : 0u;
  const int i = blockIdx.y;
  const int bb = blockIdx.z;
  // x and y may be the same buffer (in-place pass): a cluster reads its
  // whole column tile before the cluster barrier that precedes its first
  // write, and the clusters' tiles are disjoint.
  Slab<In, Tile> sl;
  sl.x = x + (long long)bb * x_batch_stride + (long long)i * L * c;
  sl.y = y + ((long long)bb * a + i) * (long long)L * c;
  sl.s = scale ? scale + ((long long)bb * a + i) * L : nullptr;
  sl.tile = reinterpret_cast<uint4*>(smem);
  sl.c = c;
  sl.j0 = (blockIdx.x >> lg_cluster) * TC;
  sl.row0 = (int)rank << lg_slab;
  sl.vec_ok = vec_ok != 0;

  for (int b = 0;;) {
    const int R = min(b == 0 ? R0 : ROUND_BITS, lg_slab - b);
    const bool last = b + R == lg_slab;
    const bool to_output = last && lg_cluster == 0;
    switch (R) {
      case 0: local_round<0>(sl, lg_slab, b, b == 0, to_output); break;
      case 1: local_round<1>(sl, lg_slab, b, b == 0, to_output); break;
      case 2: local_round<2>(sl, lg_slab, b, b == 0, to_output); break;
      default: local_round<3>(sl, lg_slab, b, b == 0, to_output); break;
    }
    if (last) break;
    b += R;
    __syncthreads();
  }
  if (lg_cluster == 0) return;
  cluster_arrive();   // every slab complete and visible to the cluster
  cluster_wait();
  switch (lg_cluster) {
    case 1: cluster_round<1>(sl, rank); break;
    case 2: cluster_round<2>(sl, rank); break;
    default: cluster_round<3>(sl, rank); break;
  }
}

int log2_exact(int v) {
  int lg = 0;
  while ((1 << lg) < v) ++lg;
  return lg;
}

// Cluster shape of a launch over an axis of L rows: (log2 slab, log2 cluster)
void plan(int L, int* lg_slab, int* lg_cluster) {
  const int lg = log2_exact(L);
  *lg_cluster = lg > LG_MAX_SLAB ? lg - LG_MAX_SLAB : 0;
  *lg_slab = lg - *lg_cluster;
}

template <typename In, typename Tile>
cudaLaunchConfig_t config(cudaLaunchAttribute* attr, int B, int a, int c, int lg_slab,
                          int lg_cluster, cudaStream_t stream) {
  constexpr int TC = TileT<Tile>::VEC * VPR;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((c + TC - 1) / TC) << lg_cluster, a, B);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = (size_t)ROW_BYTES << lg_slab;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 1u << lg_cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// How many clusters of 2^lg_cluster blocks fit on the card at once (0: the
// launch cannot run), or a negative cudaError_t.
template <typename In, typename Tile>
int active_clusters(int lg_cluster) {
  const auto kern = fwht_axis_kernel<In, Tile>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, ROW_BYTES << LG_MAX_SLAB);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = config<In, Tile>(&attr, 1, 1, 1, LG_MAX_SLAB, lg_cluster, 0);
  cfg.gridDim = dim3(1u << lg_cluster);
  int count = 0;
  err = cudaOccupancyMaxActiveClusters(&count, kern, &cfg);
  return err == cudaSuccess ? count : -(int)err;
}

template <typename In, typename Tile>
int launch(const void* x, void* y, const void* scale, int B, int a, int L, int c,
           long long x_batch_stride, cudaStream_t stream) {
  int lg_slab, lg_cluster;
  plan(L, &lg_slab, &lg_cluster);
  if (lg_cluster > LG_MAX_CLUSTER) return (int)cudaErrorInvalidValue;
  // checked once per cluster size: a launch whose cluster the card cannot
  // place is refused rather than queued
  static int clusters[LG_MAX_CLUSTER + 1] = {0, 0, 0, 0};
  if (clusters[lg_cluster] <= 0) {
    clusters[lg_cluster] = active_clusters<In, Tile>(lg_cluster);
    if (clusters[lg_cluster] < 0) return -clusters[lg_cluster];
    if (clusters[lg_cluster] == 0) return (int)cudaErrorInvalidConfiguration;
  }
  constexpr int VEC = TileT<Tile>::VEC;
  const int vec_ok = c % VEC == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(y) % 16 == 0;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      config<In, Tile>(&attr, B, a, c, lg_slab, lg_cluster, stream);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, fwht_axis_kernel<In, Tile>, static_cast<const In*>(x), static_cast<Tile*>(y),
      static_cast<const Tile*>(scale), a, L, c, x_batch_stride, lg_slab, lg_cluster, vec_ok);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Runs CALL(In, Tile) for the supported (in_kind, bf16_tile) combinations,
// returning its result; cudaErrorInvalidValue for any other.
#define FWHT_DISPATCH(in_kind, bf16_tile, CALL)                          \
  if (!(bf16_tile))                                                     \
    return (in_kind) == IN_F32 ? CALL(float, float) : (int)cudaErrorInvalidValue; \
  switch (in_kind) {                                                    \
    case IN_F32: return CALL(float, __nv_bfloat16);                     \
    case IN_BF16: return CALL(__nv_bfloat16, __nv_bfloat16);            \
    case IN_I8: return CALL(int8_t, __nv_bfloat16);                     \
    default: return (int)cudaErrorInvalidValue;                         \
  }

}  // namespace

// Y (B, a·L·c) = per-slab H_L · diag(s) · X. X holds fp32, bf16 or int8
// elements (`in_kind`, an InKind); with `bf16_tile` 0 the tile, the scale
// and Y are fp32 (X must be fp32), with 1 they are bf16. `scale` is
// (B, a·L) or null; L is a power of two ≤ 16384. Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for an unsupported combination,
// cudaErrorInvalidConfiguration if the card cannot place the launch's
// cluster); the caller raises on a nonzero code.
extern "C" int fwht_axis_launch(const void* x, void* y, const void* scale,
                                int B, int a, int L, int c,
                                long long x_batch_stride, int in_kind,
                                int bf16_tile, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH(In, Tile) launch<In, Tile>(x, y, scale, B, a, L, c, x_batch_stride, s)
  FWHT_DISPATCH(in_kind, bf16_tile, LAUNCH)
#undef LAUNCH
}

// The number of clusters a launch over an axis of L rows can keep on the
// card at once (1 for L ≤ 2048, which needs no cluster), or a negative
// cudaError_t.
extern "C" int fwht_active_clusters(int L, int in_kind, int bf16_tile) {
  int lg_slab, lg_cluster;
  plan(L, &lg_slab, &lg_cluster);
  if (lg_cluster > LG_MAX_CLUSTER) return -(int)cudaErrorInvalidValue;
#define QUERY(In, Tile) active_clusters<In, Tile>(lg_cluster)
  FWHT_DISPATCH(in_kind, bf16_tile, QUERY)
#undef QUERY
}
