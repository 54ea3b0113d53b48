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
// What bounds it on the H100: integer operations. A permutation makes 472
// general products (4 for each of the 8*12 + 22 S-boxes); a leaf of 16
// words reads 128 bytes for two permutations and a bare permutation reads
// and writes 192, so the issue rate, not memory, is the limit. The design
// spends it on the products alone:
// - the internal layer (all-ones + diag(2^d), 22 times) multiplies by
//   powers of two whose exponents kDiagLog bakes in: s_i * 2^d_i is a shift
//   into a 96-bit accumulator (s_i * 2^14 + the state's sum < 2^78 + 12 *
//   2^64), and each word is reduced once;
// - the external layer circ(2*M4, M4, M4) is M4 (x_b + t), t the sum of
//   the three blocks, on 96-bit accumulators (below 16 * 4 * 2^64 = 2^70),
//   reduced once per word instead of a chain of canonicalising adds;
// - values stay below 2^64 but need not be canonical (lazy) between
//   operations inside the permutation: the S-box products, the layers'
//   outputs, and the round constant, which each layer adds into its
//   accumulator before the reduction. Only the last layer's output, the
//   state a kernel stores, is made canonical.
// The state is read from a column-major (B, N) stack, so that neighbouring
// threads read neighbouring words; the round constants sit in __constant__
// memory, where every thread of a warp reads the same word at once.
//
// The absorb fuses what the JAX package runs as one permutation launch per 8
// columns: one launch takes a whole (b, N) column block, loads the carried
// state once, absorbs the block's chunks in order with the state
// in registers and stores the state once, so the carried (N, 12) state
// crosses device memory once a block, not once a chunk.
#include "goldilocks.cuh"

namespace {

__constant__ uint64_t kRC[30 * 12];

// The internal diagonal M_I_DIAGONAL (hashes/poseidon2_params.py) is
// 2^kDiagLog[i].
constexpr int kDiagLog[12] = {4, 14, 11, 8, 0, 5, 2, 9, 13, 6, 3, 12};

// x^7 for any x < 2^64; lazy.
__device__ __forceinline__ uint64_t sbox7(uint64_t x) {
  const uint64_t x2 = gl::mul_lazy(x, x);
  const uint64_t x3 = gl::mul_lazy(x2, x);
  const uint64_t x4 = gl::mul_lazy(x2, x2);
  return gl::mul_lazy(x4, x3);
}

// What a layer adds to its outputs before reducing them: the next full
// round's constants (all lanes), the next partial round's (lane 0), or none,
// when the output is the permutation's and must be canonical.
enum Next { kFull, kLane0, kNone };

template <Next N>
__device__ __forceinline__ uint64_t finish(gl::W y, int next, int i) {
  if (N == kFull || (N == kLane0 && i == 0)) y = gl::wadd(y, gl::wide(kRC[next * 12 + i]));
  return N == kNone ? gl::reduce_w(y) : gl::reduce_w_lazy(y);
}

// M4 = [[5,7,1,3],[4,6,1,1],[1,3,5,7],[1,1,4,6]] by an add/double chain.
__device__ __forceinline__ void block_m4(gl::W* x) {
  const gl::W t0 = gl::wadd(x[0], x[1]);
  const gl::W t1 = gl::wadd(x[2], x[3]);
  const gl::W t2 = gl::wadd(gl::wadd(x[1], x[1]), t1);
  const gl::W t3 = gl::wadd(gl::wadd(x[3], x[3]), t0);
  const gl::W t1x2 = gl::wadd(t1, t1), t0x2 = gl::wadd(t0, t0);
  const gl::W t4 = gl::wadd(gl::wadd(t1x2, t1x2), t3);
  const gl::W t5 = gl::wadd(gl::wadd(t0x2, t0x2), t2);
  x[0] = gl::wadd(t3, t5);
  x[1] = t5;
  x[2] = gl::wadd(t2, t4);
  x[3] = t4;
}

// circ(2*M4, M4, M4) = M4 (x_b + t) on block b, t = x_0 + x_1 + x_2; then
// the constants of round `next` (see Next) and one reduction a word.
template <Next N>
__device__ __forceinline__ void external_mds(uint64_t* s, int next) {
  gl::W z[12];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const gl::W t = gl::wadd(gl::wadd(gl::wide(s[i]), gl::wide(s[4 + i])), gl::wide(s[8 + i]));
#pragma unroll
    for (int b = 0; b < 3; ++b) z[4 * b + i] = gl::wadd(gl::wide(s[4 * b + i]), t);
  }
#pragma unroll
  for (int b = 0; b < 3; ++b) block_m4(z + 4 * b);
#pragma unroll
  for (int i = 0; i < 12; ++i) s[i] = finish<N>(z[i], next, i);
}

// all-ones + diag(2^d): s_i * 2^d_i + sum(s), then round `next`'s constants.
template <int I>
__device__ __forceinline__ gl::W shifted(uint64_t v) {
  return gl::wshl<kDiagLog[I]>(v);
}

template <Next N>
__device__ __forceinline__ void internal_mds(uint64_t* s, int next) {
  gl::W total = gl::wide(s[0]);
#pragma unroll
  for (int i = 1; i < 12; ++i) total = gl::wadd(total, gl::wide(s[i]));
  const gl::W y[12] = {
      gl::wadd(shifted<0>(s[0]), total), gl::wadd(shifted<1>(s[1]), total),
      gl::wadd(shifted<2>(s[2]), total), gl::wadd(shifted<3>(s[3]), total),
      gl::wadd(shifted<4>(s[4]), total), gl::wadd(shifted<5>(s[5]), total),
      gl::wadd(shifted<6>(s[6]), total), gl::wadd(shifted<7>(s[7]), total),
      gl::wadd(shifted<8>(s[8]), total), gl::wadd(shifted<9>(s[9]), total),
      gl::wadd(shifted<10>(s[10]), total), gl::wadd(shifted<11>(s[11]), total)};
#pragma unroll
  for (int i = 0; i < 12; ++i) s[i] = finish<N>(y[i], next, i);
}

__device__ __forceinline__ void sbox_all(uint64_t* s) {
#pragma unroll
  for (int i = 0; i < 12; ++i) s[i] = sbox7(s[i]);
}

// s canonical in, canonical out. Each layer adds the next round's
// constants, so a round is its S-boxes and its linear layer.
__device__ void permute(uint64_t* s) {
  external_mds<kFull>(s, 0);
  for (int r = 0; r < 3; ++r) {
    sbox_all(s);
    external_mds<kFull>(s, r + 1);
  }
  sbox_all(s);
  external_mds<kLane0>(s, 4);
  for (int r = 4; r < 25; ++r) {
    s[0] = sbox7(s[0]);
    internal_mds<kLane0>(s, r + 1);
  }
  s[0] = sbox7(s[0]);
  internal_mds<kFull>(s, 26);
  for (int r = 26; r < 29; ++r) {
    sbox_all(s);
    external_mds<kFull>(s, r + 1);
  }
  sbox_all(s);
  external_mds<kNone>(s, 0);
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

// Round constants (30 x 12), a host array; copied to the current device's
// constant memory.
extern "C" cudaError_t bt_poseidon2_set_constants(const uint64_t* rc) {
  return cudaMemcpyToSymbol(kRC, rc, sizeof(kRC));
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
