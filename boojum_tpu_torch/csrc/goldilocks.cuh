// Goldilocks field GF(p), p = 2^64 - 2^32 + 1, and GF(p^2) = GF(p)[w]/(w^2 - 7),
// as device functions shared by every kernel of the port.
//
// One element is one 64-bit word, always canonical (in [0, p)). Hopper has a
// 64-bit integer multiply, so a product is a*b (low word) plus __umul64hi
// (high word), reduced with 2^64 = 2^32 - 1 and 2^96 = -1 (mod p): with
// x = hi*2^64 + lo and hi = hh*2^32 + hl, x = lo - hh + hl*(2^32 - 1). The
// results are the same words as the plain PyTorch versions in
// field/goldilocks.py.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace gl {

constexpr uint64_t P = 0xFFFFFFFF00000001ull;
constexpr uint64_t EPS = 0xFFFFFFFFull;  // 2^64 mod p
constexpr uint64_t HALF = 0x7FFFFFFF80000001ull;  // (p + 1) / 2

__device__ __forceinline__ uint64_t add(uint64_t a, uint64_t b) {
  uint64_t s = a + b;
  if (s < a) s += EPS;  // carry: 2^64 = eps (mod p)
  if (s >= P) s -= P;
  return s;
}

__device__ __forceinline__ uint64_t sub(uint64_t a, uint64_t b) {
  uint64_t d = a - b;
  if (a < b) d -= EPS;  // borrow: -2^64 = -eps (mod p)
  return d;
}

__device__ __forceinline__ uint64_t neg(uint64_t a) { return a ? P - a : 0; }

__device__ __forceinline__ uint64_t reduce128(uint64_t hi, uint64_t lo) {
  const uint64_t hi_hi = hi >> 32;
  const uint64_t hi_lo = hi & EPS;
  uint64_t t0 = lo - hi_hi;
  if (lo < hi_hi) t0 -= EPS;
  const uint64_t t1 = hi_lo * EPS;  // < 2^64
  uint64_t t2 = t0 + t1;
  if (t2 < t0) t2 += EPS;
  if (t2 >= P) t2 -= P;
  return t2;
}

__device__ __forceinline__ uint64_t mul(uint64_t a, uint64_t b) {
  return reduce128(__umul64hi(a, b), a * b);
}

__device__ __forceinline__ uint64_t dbl(uint64_t a) { return add(a, a); }

struct Ext {
  uint64_t c0, c1;
};

__device__ __forceinline__ Ext ext_add(Ext a, Ext b) {
  return {add(a.c0, b.c0), add(a.c1, b.c1)};
}

__device__ __forceinline__ Ext ext_sub(Ext a, Ext b) {
  return {sub(a.c0, b.c0), sub(a.c1, b.c1)};
}

__device__ __forceinline__ Ext ext_mul(Ext a, Ext b) {
  // (a0 + a1 w)(b0 + b1 w) = a0 b0 + 7 a1 b1 + (a0 b1 + a1 b0) w
  const uint64_t v0 = mul(a.c0, b.c0);
  const uint64_t v1 = mul(a.c1, b.c1);
  return {add(v0, mul(v1, 7)), add(mul(a.c0, b.c1), mul(a.c1, b.c0))};
}

__device__ __forceinline__ Ext ext_mul_base(Ext a, uint64_t b) {
  return {mul(a.c0, b), mul(a.c1, b)};
}

}  // namespace gl
