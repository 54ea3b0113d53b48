// Width-16 BabyBear Poseidon2 (B8): the bare permutation, the Merkle leaf
// sponge and the 2-to-1 node compression, p = 2^31 - 2^27 + 1.
//
// Replaces the Pallas kernel boojum_tpu/hashes/poseidon2_bb.py _perm_kernel
// (launched by poseidon2_permutation_bb_pallas): the permutation of (N, 16)
// canonical u32 states, with the external matrix circ(2*M4, M4, M4, M4)
// first, 4 full rounds, 13 partial rounds (internal matrix all-ones +
// diag(d)) and 4 full rounds, S-box x^7. The JAX package drives every leaf
// sponge and node compression of its BabyBear prover through that kernel,
// one launch per 8-word chunk; here the leaf sponge absorbs all its chunks
// in one launch and the node compression is a launch of its own.
//
// The TPU kernel works in Montgomery form on 16-bit-split products because
// Mosaic has no 64-bit datapath. Hopper multiplies 32x32 -> 64 in one
// instruction, so a Montgomery product here is three multiply-adds and a
// conditional subtract: x = a*b, t = lo(x) * (-1/p mod 2^32),
// r = hi(x + t*p) < 2p, r - p if r >= p. A state enters Montgomery form on
// load (a product by 2^64 mod p) and leaves it on store (a product by 1);
// the round constants and the diagonal are stored in Montgomery form.
//
// What bounds it on the H100: 32-bit integer operations. A permutation is
// 804 field multiplies (4 for each of 8 * 16 + 13 S-boxes, 16 for each of 13
// internal layers, one a word each into and out of Montgomery form) and
// 1300 adds: about 2400 multiply-adds on the FMA pipe and 4200 adds and
// mins on the ALU pipe, which is the busier, while a leaf moves 4 bytes a
// column and a node 96 bytes. The design keeps one state's 16 words in registers
// for a whole sponge, reads a column-major (B, N) stack so that neighbouring
// threads read neighbouring words, reads a paired oracle (leaf j absorbs its
// columns at j and at j + N/2) in place instead of a concatenated copy, and
// keeps the round constants in __constant__ memory, where every thread of a
// warp reads the same word at once.
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr uint32_t kP = 2013265921u;

constexpr uint32_t inv_mod_2_32(uint32_t p) {
  uint32_t x = p;  // Newton's iteration doubles the correct low bits
  for (int i = 0; i < 5; ++i) x *= 2u - p * x;
  return x;
}
constexpr uint32_t kMu = 0u - inv_mod_2_32(kP);  // -1/p mod 2^32
static_assert(kP * inv_mod_2_32(kP) == 1u, "p^-1 mod 2^32");
constexpr uint32_t kR2 = uint32_t(((uint64_t(1) << 32) % kP) * ((uint64_t(1) << 32) % kP) % kP);

constexpr int kWidth = 16;
constexpr int kRate = 8;
constexpr int kDigest = 8;
constexpr int kPartial = 13;
constexpr int kConstants = 8 * kWidth + kPartial + kWidth;

// external round constants (8 x 16), internal ones (13), diagonal (16),
// all in Montgomery form
__constant__ uint32_t kC[kConstants];

__device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
  const uint32_t s = a + b;  // < 2p < 2^32
  return min(s, s - kP);
}

__device__ __forceinline__ uint32_t mont(uint32_t a, uint32_t b) {
  const uint64_t x = uint64_t(a) * b;
  const uint32_t t = uint32_t(x) * kMu;
  const uint32_t r = uint32_t((x + uint64_t(t) * kP) >> 32);
  return min(r, r - kP);
}

__device__ __forceinline__ uint32_t sbox7(uint32_t x) {
  const uint32_t x2 = mont(x, x);
  const uint32_t x3 = mont(x2, x);
  const uint32_t x4 = mont(x2, x2);
  return mont(x4, x3);
}

// M4 = [[5,7,1,3],[4,6,1,1],[1,3,5,7],[1,1,4,6]] by an add/double chain.
__device__ __forceinline__ void block_m4(uint32_t* x) {
  const uint32_t t0 = add(x[0], x[1]);
  const uint32_t t1 = add(x[2], x[3]);
  const uint32_t t2 = add(add(x[1], x[1]), t1);
  const uint32_t t3 = add(add(x[3], x[3]), t0);
  const uint32_t t1d = add(t1, t1);
  const uint32_t t4 = add(add(t1d, t1d), t3);
  const uint32_t t0d = add(t0, t0);
  const uint32_t t5 = add(add(t0d, t0d), t2);
  x[0] = add(t3, t5);
  x[1] = t5;
  x[2] = add(t2, t4);
  x[3] = t4;
}

// circ(2*M4, M4, M4, M4)
__device__ __forceinline__ void external_mds(uint32_t* s) {
#pragma unroll
  for (int b = 0; b < 4; ++b) block_m4(s + 4 * b);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t sum = add(add(s[i], s[4 + i]), add(s[8 + i], s[12 + i]));
#pragma unroll
    for (int b = 0; b < 4; ++b) s[4 * b + i] = add(s[4 * b + i], sum);
  }
}

__device__ __forceinline__ void full_round(uint32_t* s, int r) {
#pragma unroll
  for (int i = 0; i < kWidth; ++i) s[i] = sbox7(add(s[i], kC[r * kWidth + i]));
  external_mds(s);
}

__device__ __forceinline__ void partial_round(uint32_t* s, int r) {
  s[0] = sbox7(add(s[0], kC[8 * kWidth + r]));
  uint32_t total = s[0];
#pragma unroll
  for (int i = 1; i < kWidth; ++i) total = add(total, s[i]);
#pragma unroll
  for (int i = 0; i < kWidth; ++i)
    s[i] = add(mont(s[i], kC[8 * kWidth + kPartial + i]), total);
}

// on Montgomery-form words
__device__ void permute(uint32_t* s) {
  external_mds(s);
  for (int r = 0; r < 4; ++r) full_round(s, r);
  for (int r = 0; r < kPartial; ++r) partial_round(s, r);
  for (int r = 4; r < 8; ++r) full_round(s, r);
}

__device__ __forceinline__ uint32_t to_mont(uint32_t x) { return mont(x, kR2); }
__device__ __forceinline__ uint32_t from_mont(uint32_t x) { return mont(x, 1u); }

// One thread per state: permute in[r] into out[r] ((N, 16) row-major).
__global__ void permute_bb(const uint32_t* __restrict__ in, size_t N,
                           uint32_t* __restrict__ out) {
  const size_t r = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= N) return;
  uint32_t s[kWidth];
#pragma unroll
  for (int i = 0; i < kWidth; ++i) s[i] = to_mont(in[r * kWidth + i]);
  permute(s);
#pragma unroll
  for (int i = 0; i < kWidth; ++i) out[r * kWidth + i] = from_mont(s[i]);
}

// One thread per leaf r < M: absorb, eight words a permutation with the last
// chunk zero-padded, the B * halves words
//   cols[c * col_stride + h * half_offset + r], h < halves, c < B
// in that order (h outer), then write the first 8 state words.
__global__ void leaf_bb(const uint32_t* __restrict__ cols, int B, int halves,
                        size_t col_stride, size_t half_offset, size_t M,
                        uint32_t* __restrict__ out) {
  const size_t r = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= M) return;
  const int total = B * halves;
  uint32_t s[kWidth];
#pragma unroll
  for (int i = 0; i < kWidth; ++i) s[i] = 0;
  for (int c0 = 0; c0 < total; c0 += kRate) {
#pragma unroll
    for (int j = 0; j < kRate; ++j) {
      const int c = c0 + j;
      uint32_t v = 0;
      if (c < total) {
        const int h = c / B;
        v = cols[size_t(c - h * B) * col_stride + size_t(h) * half_offset + r];
      }
      s[j] = to_mont(v);
    }
    permute(s);
  }
#pragma unroll
  for (int k = 0; k < kDigest; ++k) out[r * kDigest + k] = from_mont(s[k]);
}

// One thread per parent i < M: permute left[i] ‖ right[i] (rows `ls` and
// `rs` words apart) and keep the first 8 words.
__global__ void node_bb(const uint32_t* __restrict__ left, size_t ls,
                        const uint32_t* __restrict__ right, size_t rs, size_t M,
                        uint32_t* __restrict__ out) {
  const size_t i = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= M) return;
  uint32_t s[kWidth];
#pragma unroll
  for (int k = 0; k < kDigest; ++k) {
    s[k] = to_mont(left[i * ls + k]);
    s[kDigest + k] = to_mont(right[i * rs + k]);
  }
  permute(s);
#pragma unroll
  for (int k = 0; k < kDigest; ++k) out[i * kDigest + k] = from_mont(s[k]);
}

constexpr int kThreads = 128;

unsigned grid(long long n) { return unsigned((size_t(n) + kThreads - 1) / kThreads); }

}  // namespace

// The Montgomery-form constants: 8 * 16 external, 13 internal, 16 diagonal.
extern "C" cudaError_t bt_poseidon2_bb_set_constants(const uint32_t* words, int count) {
  if (count != kConstants) return cudaErrorInvalidValue;
  return cudaMemcpyToSymbol(kC, words, sizeof(kC));
}

extern "C" cudaError_t bt_poseidon2_bb_permute(const uint32_t* in, long long N,
                                               uint32_t* out, cudaStream_t stream) {
  if (N <= 0) return cudaSuccess;
  permute_bb<<<grid(N), kThreads, 0, stream>>>(in, size_t(N), out);
  return cudaGetLastError();
}

extern "C" cudaError_t bt_poseidon2_bb_leaf(const uint32_t* cols, int B, int halves,
                                            long long col_stride, long long half_offset,
                                            long long M, uint32_t* out,
                                            cudaStream_t stream) {
  if (M <= 0) return cudaSuccess;
  leaf_bb<<<grid(M), kThreads, 0, stream>>>(cols, B, halves, size_t(col_stride),
                                            size_t(half_offset), size_t(M), out);
  return cudaGetLastError();
}

extern "C" cudaError_t bt_poseidon2_bb_node(const uint32_t* left, long long ls,
                                            const uint32_t* right, long long rs,
                                            long long M, uint32_t* out,
                                            cudaStream_t stream) {
  if (M <= 0) return cudaSuccess;
  node_bb<<<grid(M), kThreads, 0, stream>>>(left, size_t(ls), right, size_t(rs),
                                            size_t(M), out);
  return cudaGetLastError();
}
