// How a sketch kernel reads its A stream, shared by gaussian_sa.cu and
// sjlt.cu: the `a_kind` argument of their launch functions (and of
// ../_build.py's a_kind). A is stored as fp32, bf16 or int8 codes; in the
// bf16 and int8 modes every element is a bf16 value held in fp32, so a
// product with another bf16 value is exact in fp32.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>

enum AKind { A_F32 = 0, A_F32_ROUND_BF16 = 1, A_BF16 = 2, A_I8 = 3 };

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int K> struct AElem;
template <> struct AElem<A_F32> {
  using T = float;
  static __device__ __forceinline__ float load(const T* p) { return *p; }
};
template <> struct AElem<A_F32_ROUND_BF16> {
  using T = float;
  static __device__ __forceinline__ float load(const T* p) { return round_bf16(*p); }
};
template <> struct AElem<A_BF16> {
  using T = __nv_bfloat16;
  static __device__ __forceinline__ float load(const T* p) { return __bfloat162float(*p); }
};
template <> struct AElem<A_I8> {
  using T = int8_t;
  static __device__ __forceinline__ float load(const T* p) { return (float)*p; }
};

// Calls launch<K>(args...) for the runtime a_kind; cudaErrorInvalidValue
// for an unknown one.
#define DISPATCH_A_KIND(a_kind, ...)                                   \
  switch (a_kind) {                                                   \
    case A_F32: launch<A_F32>(__VA_ARGS__); break;                    \
    case A_F32_ROUND_BF16: launch<A_F32_ROUND_BF16>(__VA_ARGS__); break; \
    case A_BF16: launch<A_BF16>(__VA_ARGS__); break;                  \
    case A_I8: launch<A_I8>(__VA_ARGS__); break;                      \
    default: return (int)cudaErrorInvalidValue;                       \
  }
