// Goldilocks field GF(p), p = 2^64 - 2^32 + 1, and GF(p^2) = GF(p)[w]/(w^2 - 7),
// as device functions shared by every kernel of the port.
//
// One element is one 64-bit word, canonical (in [0, p)) wherever it is
// stored; the _lazy forms, for chains inside a kernel, return any word below
// 2^64 that is congruent to the result and say what they accept. Hopper has a
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

// a + b for canonical a, b, by an explicit carry chain: a + b < 2p, so
// whether it carried out of 64 bits (then a + b - 2^64 + eps < p) or landed
// in [p, 2^64) (then a + b - p = a + b + eps mod 2^64), adding eps once
// gives the canonical sum.
__device__ __forceinline__ uint64_t add(uint64_t a, uint64_t b) {
  uint32_t s0, s1, c;
  asm("add.cc.u32 %0, %3, %5;\n\t"
      "addc.cc.u32 %1, %4, %6;\n\t"
      "addc.u32 %2, 0, 0;"
      : "=r"(s0), "=r"(s1), "=r"(c)
      : "r"(uint32_t(a)), "r"(uint32_t(a >> 32)), "r"(uint32_t(b)), "r"(uint32_t(b >> 32)));
  const bool wrap = c | ((s1 == 0xFFFFFFFFu) & (s0 != 0u));
  return ((uint64_t(s1) << 32) | s0) + (wrap ? EPS : 0);
}

// a - b for canonical a, b: on a borrow the true value is d - 2^64 = d - eps
// (mod p), i.e. d + p mod 2^64, which is canonical.
__device__ __forceinline__ uint64_t sub(uint64_t a, uint64_t b) {
  uint32_t d0, d1, bw;
  asm("sub.cc.u32 %0, %3, %5;\n\t"
      "subc.cc.u32 %1, %4, %6;\n\t"
      "subc.u32 %2, 0, 0;"
      : "=r"(d0), "=r"(d1), "=r"(bw)
      : "r"(uint32_t(a)), "r"(uint32_t(a >> 32)), "r"(uint32_t(b)), "r"(uint32_t(b >> 32)));
  // bw is all ones on a borrow: add p = (2^32 - 1) * 2^32 + 1
  asm("add.cc.u32 %0, %0, %2;\n\t"
      "addc.u32 %1, %1, %3;"
      : "+r"(d0), "+r"(d1)
      : "r"(bw & 1u), "r"(bw));
  return (uint64_t(d1) << 32) | d0;
}

__device__ __forceinline__ uint64_t neg(uint64_t a) { return a ? P - a : 0; }

// lo + hi_lo*2^64 + hi_hi*2^96 = lo + hi_lo*eps - hi_hi (mod p), for hi_lo
// < 2^32 and hi_hi < 2^63, lazy.
__device__ __forceinline__ uint64_t fold_lazy(uint64_t hi_hi, uint64_t hi_lo, uint64_t lo) {
  uint64_t t0 = lo - hi_hi;
  if (lo < hi_hi) t0 -= EPS;  // borrow: -2^64 = -eps, and t0 >= 2^64 - hi_hi > eps
  const uint64_t t1 = hi_lo * EPS;  // < 2^64
  uint64_t t2 = t0 + t1;
  if (t2 < t0) t2 += EPS;  // t0 + t1 - 2^64 < t1 <= 2^64 - 2^33 + 1: no second carry
  return t2;
}

// hi*2^64 + lo reduced to a word < 2^64 that need not be canonical (lazy):
// any later multiply, wide sum or reduce accepts it.
__device__ __forceinline__ uint64_t reduce128_lazy(uint64_t hi, uint64_t lo) {
  return fold_lazy(hi >> 32, hi & EPS, lo);
}

// A sum of 128-bit products and words, lo + hi*2^64 + k*2^128 (k counts
// the carries out of 128 bits: fewer than 2^31 terms), reduced once:
// 2^128 = -2^32 (mod p), so k joins hi's top half.
struct Acc {
  uint64_t lo, hi;
  uint32_t k;
};

__device__ __forceinline__ Acc prod(uint64_t a, uint64_t b) {
  return {a * b, __umul64hi(a, b), 0u};
}

// a + (lo + hi*2^64)
__device__ __forceinline__ Acc acc_add(Acc a, uint64_t lo, uint64_t hi) {
  Acc r;
  asm("add.cc.u64 %0, %3, %6;\n\t"
      "addc.cc.u64 %1, %4, %7;\n\t"
      "addc.u32 %2, %5, 0;"
      : "=l"(r.lo), "=l"(r.hi), "=r"(r.k)
      : "l"(a.lo), "l"(a.hi), "r"(a.k), "l"(lo), "l"(hi));
  return r;
}

__device__ __forceinline__ Acc acc_mac(Acc a, uint64_t x, uint64_t y) {
  return acc_add(a, x * y, __umul64hi(x, y));
}

__device__ __forceinline__ Acc acc_sum(Acc a, Acc b) {
  Acc r = acc_add(a, b.lo, b.hi);
  r.k += b.k;
  return r;
}

__device__ __forceinline__ uint64_t reduce_acc_lazy(Acc a) {
  return fold_lazy((a.hi >> 32) + (uint64_t(a.k) << 32), a.hi & EPS, a.lo);
}

__device__ __forceinline__ uint64_t canonical(uint64_t a) { return a >= P ? a - P : a; }

__device__ __forceinline__ uint64_t reduce128(uint64_t hi, uint64_t lo) {
  return canonical(reduce128_lazy(hi, lo));
}

__device__ __forceinline__ uint64_t mul(uint64_t a, uint64_t b) {
  return reduce128(__umul64hi(a, b), a * b);
}

__device__ __forceinline__ uint64_t dbl(uint64_t a) { return add(a, a); }

// a * b for any a, b < 2^64, lazy.
__device__ __forceinline__ uint64_t mul_lazy(uint64_t a, uint64_t b) {
  return reduce128_lazy(__umul64hi(a, b), a * b);
}

// a + b for any a, b < 2^64, lazy: a carry out of 64 bits drops 2^64 = eps
// (mod p), so eps goes back in; that can carry once more, and then the word
// is below eps - 1, so a second eps cannot.
__device__ __forceinline__ uint64_t add_lazy(uint64_t a, uint64_t b) {
  uint64_t s = a + b;
  if (s < a) {
    s += EPS;
    if (s < EPS) s += EPS;
  }
  return s;
}

// a - b for any a, b < 2^64, lazy: a borrow adds 2^64 = eps (mod p), so eps
// comes off; that borrows once more only when b - a > p (b not canonical),
// and then the word is at least 2^64 - eps, so a second eps cannot.
__device__ __forceinline__ uint64_t sub_lazy(uint64_t a, uint64_t b) {
  uint64_t d = a - b;
  if (a < b) {
    const uint64_t e = d - EPS;
    d = d < EPS ? e - EPS : e;
  }
  return d;
}

// A 96-bit accumulator w0 + w1*2^32 + w2*2^64, for sums of words < 2^64 with
// small coefficients that are reduced once at the end.
struct W {
  uint32_t w0, w1, w2;
};

__device__ __forceinline__ W wide(uint64_t a) {
  return {uint32_t(a), uint32_t(a >> 32), 0u};
}

__device__ __forceinline__ W wadd(W a, W b) {
  W r;
  asm("add.cc.u32 %0, %3, %6;\n\t"
      "addc.cc.u32 %1, %4, %7;\n\t"
      "addc.u32 %2, %5, %8;"
      : "=r"(r.w0), "=r"(r.w1), "=r"(r.w2)
      : "r"(a.w0), "r"(a.w1), "r"(a.w2), "r"(b.w0), "r"(b.w1), "r"(b.w2));
  return r;
}

// a * 2^D as a wide value, 0 <= D < 32.
template <int D>
__device__ __forceinline__ W wshl(uint64_t a) {
  if constexpr (D == 0) {
    return wide(a);
  } else {
    const uint64_t lo = a << D;
    return {uint32_t(lo), uint32_t(lo >> 32), uint32_t(a >> (64 - D))};
  }
}

// a * c as a wide value, c < 2^32: a c = lo + hi*2^32 with lo = a_lo c and
// hi = a_hi c, and (lo >> 32) + hi <= 2^32 - 1 + (2^32 - 1)^2 < 2^64.
__device__ __forceinline__ W wmul32(uint64_t a, uint32_t c) {
  const uint64_t lo = uint64_t(uint32_t(a)) * c;
  const uint64_t mid = (lo >> 32) + (a >> 32) * c;
  return {uint32_t(lo), uint32_t(mid), uint32_t(mid >> 32)};
}

// w (any w2) reduced lazily: w = lo + w2*2^64 = lo + w2*eps (mod p), and
// w2*eps <= (2^32 - 1)^2 = 2^64 - 2^33 + 1, so one carry fix-up keeps it
// below 2^64.
__device__ __forceinline__ uint64_t reduce_w_lazy(W w) {
  const uint64_t lo = uint64_t(w.w0) | (uint64_t(w.w1) << 32);
  const uint64_t t = (uint64_t(w.w2) << 32) - w.w2;
  uint64_t s = lo + t;
  if (s < lo) s += EPS;
  return s;
}

__device__ __forceinline__ uint64_t reduce_w(W w) { return canonical(reduce_w_lazy(w)); }

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

// a * b for any words below 2^64, lazy. c1 = a0 b1 + a1 b0: the two 128-bit
// products summed and reduced once. c0 = a0 b0 + 7 a1 b1: a1 b1 reduced
// first, 7 times it (below 2^67) added to the 128-bit a0 b0.
__device__ __forceinline__ Ext ext_mul_lazy(Ext a, Ext b) {
  const W s = wmul32(mul_lazy(a.c1, b.c1), 7);
  const Acc e0 = acc_add(prod(a.c0, b.c0), uint64_t(s.w0) | (uint64_t(s.w1) << 32), s.w2);
  const Acc e1 = acc_mac(prod(a.c0, b.c1), a.c1, b.c0);
  return {reduce_acc_lazy(e0), reduce_acc_lazy(e1)};
}

}  // namespace gl
