// Width-12 Goldilocks Poseidon2: Merkle leaf hashes and 2-to-1 node hashes
// (B5), and the bare permutation with the streamed commit's absorb (B4).
//
// B5 replaces the Pallas kernel boojum_tpu/hashes/pallas_poseidon2.py
// _sponge_kernel (via _sponge_planes): an overwrite-mode sponge, rate 8,
// capacity 4, the last chunk zero-padded, a 4-word digest. B4 replaces
// _perm_kernel (via _permute_planes): the permutation of a batch of (N, 12)
// states, which the JAX package's streamed commit drives through
// prover/streaming.py _sponge_absorb8 (overwrite the rate with 8 leaf columns,
// permute). The TPU kernels work on (lo, hi) u32 planes laid out (L, R, 128)
// because the TPU vector unit has no 64-bit multiply; here one thread holds
// one state's 12 words in registers and multiplies 64-bit words directly.
//
// What bounds it on the H100: integer operations. A permutation is 736 field
// multiplies (4 for each of the 8*12 + 22 S-boxes, 12 for each of the 22
// internal layers) and several hundred adds; a leaf of 16 words reads 128
// bytes for two permutations, and a bare permutation reads and writes 192,
// so the multiply rate, not memory, is the limit. The design keeps the whole
// state in registers, reads a column-major (B, N) stack so that neighbouring
// threads read neighbouring words, and keeps the round constants and the
// internal diagonal in __constant__ memory, where every thread of a warp
// reads the same word at once.
//
// The absorb fuses what the JAX package runs as one permutation launch per 8
// columns: one launch takes a whole (b, N) column block, loads the carried
// state once, absorbs the block's chunks in order with the state
// in registers and stores the state once, so the carried (N, 12) state
// crosses device memory once a block, not once a chunk.
#include "goldilocks.cuh"

namespace {

__constant__ uint64_t kRC[30 * 12];
__constant__ uint64_t kDiag[12];

__device__ __forceinline__ uint64_t sbox7(uint64_t x) {
  const uint64_t x2 = gl::mul(x, x);
  const uint64_t x3 = gl::mul(x2, x);
  const uint64_t x4 = gl::mul(x2, x2);
  return gl::mul(x4, x3);
}

// M4 = [[5,7,1,3],[4,6,1,1],[1,3,5,7],[1,1,4,6]] by an add/double chain.
__device__ __forceinline__ void block_m4(uint64_t* x) {
  const uint64_t t0 = gl::add(x[0], x[1]);
  const uint64_t t1 = gl::add(x[2], x[3]);
  const uint64_t t2 = gl::add(gl::dbl(x[1]), t1);
  const uint64_t t3 = gl::add(gl::dbl(x[3]), t0);
  const uint64_t t4 = gl::add(gl::dbl(gl::dbl(t1)), t3);
  const uint64_t t5 = gl::add(gl::dbl(gl::dbl(t0)), t2);
  x[0] = gl::add(t3, t5);
  x[1] = t5;
  x[2] = gl::add(t2, t4);
  x[3] = t4;
}

// circ(2*M4, M4, M4)
__device__ __forceinline__ void external_mds(uint64_t* s) {
  block_m4(s);
  block_m4(s + 4);
  block_m4(s + 8);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint64_t sum = gl::add(gl::add(s[i], s[4 + i]), s[8 + i]);
    s[i] = gl::add(s[i], sum);
    s[4 + i] = gl::add(s[4 + i], sum);
    s[8 + i] = gl::add(s[8 + i], sum);
  }
}

// all-ones + diag(d)
__device__ __forceinline__ void internal_mds(uint64_t* s) {
  uint64_t total = s[0];
#pragma unroll
  for (int i = 1; i < 12; ++i) total = gl::add(total, s[i]);
#pragma unroll
  for (int i = 0; i < 12; ++i) s[i] = gl::add(gl::mul(s[i], kDiag[i]), total);
}

__device__ __forceinline__ void full_round(uint64_t* s, int r) {
#pragma unroll
  for (int i = 0; i < 12; ++i) s[i] = sbox7(gl::add(s[i], kRC[r * 12 + i]));
  external_mds(s);
}

__device__ void permute(uint64_t* s) {
  external_mds(s);
  for (int r = 0; r < 4; ++r) full_round(s, r);
  for (int r = 4; r < 26; ++r) {
    s[0] = sbox7(gl::add(s[0], kRC[r * 12]));
    internal_mds(s);
  }
  for (int r = 26; r < 30; ++r) full_round(s, r);
}

// One thread per leaf: absorb the leaf's B words (column-major stack, column
// c of leaf r at cols[c * N + r]) eight at a time, zero-padding the last
// chunk; write the first four state words.
__global__ void leaf_hash(const uint64_t* __restrict__ cols, int B, size_t N,
                          uint64_t* __restrict__ out) {
  const size_t r = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= N) return;
  uint64_t s[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) s[i] = 0;
  for (int c0 = 0; c0 < B; c0 += 8) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      s[j] = (c0 + j < B) ? cols[size_t(c0 + j) * N + r] : 0;
    permute(s);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) out[r * 4 + k] = s[k];
}

// One thread per parent: hash children 2i and 2i+1 of an (2M, 4) layer.
__global__ void node_hash(const uint64_t* __restrict__ in, size_t M,
                          uint64_t* __restrict__ out) {
  const size_t i = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= M) return;
  uint64_t s[12];
#pragma unroll
  for (int k = 0; k < 8; ++k) s[k] = in[i * 8 + k];
#pragma unroll
  for (int k = 8; k < 12; ++k) s[k] = 0;
  permute(s);
#pragma unroll
  for (int k = 0; k < 4; ++k) out[i * 4 + k] = s[k];
}

// One thread per state: permute in[r] into out[r] ((N, 12) row-major, two
// separate buffers).
__global__ void permute_batch(const uint64_t* __restrict__ in, size_t N,
                              uint64_t* __restrict__ out) {
  const size_t r = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= N) return;
  uint64_t s[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) s[i] = in[r * 12 + i];
  permute(s);
#pragma unroll
  for (int i = 0; i < 12; ++i) out[r * 12 + i] = s[i];
}

// One thread per carried state (N, 12), updated in place: for each chunk of 8
// columns of the (b, N) column-major block, overwrite the rate (words 0..7)
// with the chunk, zero past column b, and permute.
__global__ void absorb_block(uint64_t* __restrict__ state,
                             const uint64_t* __restrict__ cols, int b,
                             size_t N) {
  const size_t r = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= N) return;
  uint64_t s[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) s[i] = state[r * 12 + i];
  for (int c0 = 0; c0 < b; c0 += 8) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      s[j] = (c0 + j < b) ? cols[size_t(c0 + j) * N + r] : 0;
    permute(s);
  }
#pragma unroll
  for (int i = 0; i < 12; ++i) state[r * 12 + i] = s[i];
}

constexpr int kThreads = 128;

}  // namespace

// Round constants (30 x 12) and the internal diagonal (12), host arrays;
// copied to the current device's constant memory.
extern "C" cudaError_t bt_poseidon2_set_constants(const uint64_t* rc,
                                                  const uint64_t* diag) {
  cudaError_t e = cudaMemcpyToSymbol(kRC, rc, sizeof(kRC));
  if (e != cudaSuccess) return e;
  return cudaMemcpyToSymbol(kDiag, diag, sizeof(kDiag));
}

extern "C" cudaError_t bt_poseidon2_leaf_hash(const uint64_t* cols, int B,
                                              long long N, uint64_t* out,
                                              cudaStream_t stream) {
  const unsigned blocks = unsigned((size_t(N) + kThreads - 1) / kThreads);
  leaf_hash<<<blocks, kThreads, 0, stream>>>(cols, B, size_t(N), out);
  return cudaGetLastError();
}

extern "C" cudaError_t bt_poseidon2_node_hash(const uint64_t* in, long long M,
                                              uint64_t* out,
                                              cudaStream_t stream) {
  const unsigned blocks = unsigned((size_t(M) + kThreads - 1) / kThreads);
  node_hash<<<blocks, kThreads, 0, stream>>>(in, size_t(M), out);
  return cudaGetLastError();
}

extern "C" cudaError_t bt_poseidon2_permute(const uint64_t* in, long long N,
                                            uint64_t* out,
                                            cudaStream_t stream) {
  const unsigned blocks = unsigned((size_t(N) + kThreads - 1) / kThreads);
  permute_batch<<<blocks, kThreads, 0, stream>>>(in, size_t(N), out);
  return cudaGetLastError();
}

extern "C" cudaError_t bt_poseidon2_absorb(uint64_t* state,
                                           const uint64_t* cols, int b,
                                           long long N, cudaStream_t stream) {
  const unsigned blocks = unsigned((size_t(N) + kThreads - 1) / kThreads);
  absorb_block<<<blocks, kThreads, 0, stream>>>(state, cols, b, size_t(N));
  return cudaGetLastError();
}
