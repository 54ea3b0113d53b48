// Radix-2 NTT over Goldilocks for a batch of rows, sizes 2^1 .. 2^30.
//
// Replaces the Pallas kernels of boojum_tpu/ntt/mxu_ntt.py: _fwd_kernel
// (forward NTT, natural in, bit-reversed out), _inv_kernel (inverse NTT,
// bit-reversed in, natural out, times 1/n) and _fwd_scaled_kernel (coset LDE:
// coefficient rows times coset scale rows, then the forward NTT). The TPU
// kernels are four-step int8-digit matmuls because the TPU has a matrix
// unit and no 64-bit multiply; Hopper multiplies 64-bit words directly, so
// this is the plain butterfly network of ntt.py's dif_stages / dit_stages.
//
// What bounds it on the H100: integer operations. A butterfly is one field
// multiply and two adds, about 24 32-bit integer instructions, and a 2^20
// transform runs 20 stages of them: some 240 instructions per word, which
// is read once and written once (16 bytes). That is about three times the
// card's ratio of integer issue rate (64 per SM per clock) to memory rate,
// so the multiplies, not the bytes, set the least time. The design keeps
// the last 11 stages of the forward transform (the first 11 of the inverse)
// in shared memory: a block loads a tile of 2048 contiguous words once, runs
// those stages there, and writes it back. The wider stages are one global
// pass each, which adds memory traffic on top of the arithmetic. The coset
// scale of the LDE is folded into the first pass and the 1/n of the inverse
// into the last, so neither costs a pass of its own.
//
// Layout: rows of n words, row-major. Forward: input row r / L (scaled by
// scale row r % L when a scale is given) lands in output row r, so a (B, n)
// coefficient stack with an (L, n) scale gives the (B, L, n) LDE. Twiddle
// tables hold omega^i (inverse: omega^-i) for i < n/2.
#include "goldilocks.cuh"

namespace {

constexpr int kLogTile = 11;
constexpr int kTailThreads = 256;
constexpr int kStageThreads = 256;

__device__ __forceinline__ uint64_t load_scaled(const uint64_t* in,
                                                const uint64_t* scale, int L,
                                                size_t row, int log_n,
                                                size_t i) {
  const size_t n = size_t(1) << log_n;
  uint64_t v = in[(row / L) * n + i];
  if (scale) v = gl::mul(v, scale[(row % L) * n + i]);
  return v;
}

// One forward (DIF) stage s over every row: blocks of n >> s words, the
// butterfly pairs half a block apart, twiddle omega^(j << s).
__global__ void dif_stage(const uint64_t* in, uint64_t* out,
                          const uint64_t* scale, int L,
                          const uint64_t* __restrict__ tw, int log_n, int s,
                          size_t rows) {
  const size_t t = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= (rows << (log_n - 1))) return;
  const size_t n = size_t(1) << log_n;
  const size_t row = t >> (log_n - 1);
  const size_t k = t & ((n >> 1) - 1);
  const int log_half = log_n - s - 1;
  const size_t j = k & ((size_t(1) << log_half) - 1);
  const size_t i0 = ((k >> log_half) << (log_half + 1)) + j;
  const size_t i1 = i0 + (size_t(1) << log_half);
  const uint64_t u = load_scaled(in, scale, L, row, log_n, i0);
  const uint64_t v = load_scaled(in, scale, L, row, log_n, i1);
  out[row * n + i0] = gl::add(u, v);
  out[row * n + i1] = gl::mul(gl::sub(u, v), tw[j << s]);
}

// The last log_t forward stages, one tile of 2^log_t words per block.
__global__ void dif_tail(const uint64_t* in, uint64_t* out,
                         const uint64_t* scale, int L,
                         const uint64_t* __restrict__ tw, int log_n,
                         int log_t) {
  extern __shared__ uint64_t sm[];
  const int T = 1 << log_t;
  uint64_t* x = sm;
  uint64_t* w = sm + T;  // omega_T^m for m < T/2
  const size_t n = size_t(1) << log_n;
  const size_t tiles_per_row = n >> log_t;
  const size_t row = blockIdx.x / tiles_per_row;
  const size_t off = (blockIdx.x % tiles_per_row) << log_t;
  for (int i = threadIdx.x; i < T; i += blockDim.x)
    x[i] = load_scaled(in, scale, L, row, log_n, off + i);
  for (int m = threadIdx.x; m < T / 2; m += blockDim.x)
    w[m] = tw[size_t(m) << (log_n - log_t)];
  __syncthreads();
  for (int st = 0; st < log_t; ++st) {
    const int log_half = log_t - st - 1;
    for (int k = threadIdx.x; k < T / 2; k += blockDim.x) {
      const int j = k & ((1 << log_half) - 1);
      const int i0 = ((k >> log_half) << (log_half + 1)) + j;
      const int i1 = i0 + (1 << log_half);
      const uint64_t u = x[i0], v = x[i1];
      x[i0] = gl::add(u, v);
      x[i1] = gl::mul(gl::sub(u, v), w[j << st]);
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < T; i += blockDim.x)
    out[row * n + off + i] = x[i];
}

// The first log_t inverse (DIT) stages, one tile per block; times post when
// these are the only stages.
__global__ void dit_head(const uint64_t* in, uint64_t* out,
                         const uint64_t* __restrict__ itw, int log_n,
                         int log_t, int has_post, uint64_t post) {
  extern __shared__ uint64_t sm[];
  const int T = 1 << log_t;
  uint64_t* x = sm;
  uint64_t* w = sm + T;
  const size_t base = size_t(blockIdx.x) << log_t;
  for (int i = threadIdx.x; i < T; i += blockDim.x) x[i] = in[base + i];
  for (int m = threadIdx.x; m < T / 2; m += blockDim.x)
    w[m] = itw[size_t(m) << (log_n - log_t)];
  __syncthreads();
  for (int st = 0; st < log_t; ++st) {
    for (int k = threadIdx.x; k < T / 2; k += blockDim.x) {
      const int j = k & ((1 << st) - 1);
      const int i0 = ((k >> st) << (st + 1)) + j;
      const int i1 = i0 + (1 << st);
      const uint64_t u = x[i0];
      const uint64_t wv = gl::mul(x[i1], w[j << (log_t - st - 1)]);
      x[i0] = gl::add(u, wv);
      x[i1] = gl::sub(u, wv);
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < T; i += blockDim.x)
    out[base + i] = has_post ? gl::mul(x[i], post) : x[i];
}

// One inverse (DIT) stage s: blocks of 2 << s words, twiddle
// omega^-(j << (log_n - s - 1)).
__global__ void dit_stage(uint64_t* x, const uint64_t* __restrict__ itw,
                          int log_n, int s, size_t rows, int has_post,
                          uint64_t post) {
  const size_t t = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= (rows << (log_n - 1))) return;
  const size_t n = size_t(1) << log_n;
  const size_t row = t >> (log_n - 1);
  const size_t k = t & ((n >> 1) - 1);
  const size_t j = k & ((size_t(1) << s) - 1);
  const size_t i0 = row * n + ((k >> s) << (s + 1)) + j;
  const size_t i1 = i0 + (size_t(1) << s);
  const uint64_t u = x[i0];
  const uint64_t wv = gl::mul(x[i1], itw[j << (log_n - s - 1)]);
  uint64_t top = gl::add(u, wv), bot = gl::sub(u, wv);
  if (has_post) {
    top = gl::mul(top, post);
    bot = gl::mul(bot, post);
  }
  x[i0] = top;
  x[i1] = bot;
}

unsigned blocks_for(size_t threads, int per_block) {
  return unsigned((threads + per_block - 1) / per_block);
}

size_t tail_smem(int log_t) { return (size_t(3) << log_t) / 2 * 8; }

}  // namespace

// out (rows, n) = NTT of input rows r / L, each scaled by scale row r % L
// when scale is not null. in and out may be the same buffer only when L = 1.
extern "C" cudaError_t bt_ntt_forward(const uint64_t* in, uint64_t* out,
                                      const uint64_t* scale, int L,
                                      const uint64_t* tw, int log_n,
                                      long long rows, cudaStream_t stream) {
  const int log_t = log_n < kLogTile ? log_n : kLogTile;
  const size_t r = size_t(rows);
  const uint64_t* src = in;
  for (int s = 0; s < log_n - log_t; ++s) {
    dif_stage<<<blocks_for(r << (log_n - 1), kStageThreads), kStageThreads, 0,
                stream>>>(src, out, scale, L, tw, log_n, s, r);
    src = out;
    scale = nullptr;
    L = 1;
  }
  const unsigned tiles = unsigned(r << (log_n - log_t));
  dif_tail<<<tiles, kTailThreads, tail_smem(log_t), stream>>>(
      src, out, scale, L, tw, log_n, log_t);
  return cudaGetLastError();
}

// out (rows, n) = inverse NTT of the bit-reversed input rows, times n_inv.
extern "C" cudaError_t bt_ntt_inverse(const uint64_t* in, uint64_t* out,
                                      const uint64_t* itw, int log_n,
                                      long long rows, uint64_t n_inv,
                                      cudaStream_t stream) {
  const int log_t = log_n < kLogTile ? log_n : kLogTile;
  const size_t r = size_t(rows);
  const unsigned tiles = unsigned(r << (log_n - log_t));
  dit_head<<<tiles, kTailThreads, tail_smem(log_t), stream>>>(
      in, out, itw, log_n, log_t, log_t == log_n, n_inv);
  for (int s = log_t; s < log_n; ++s) {
    dit_stage<<<blocks_for(r << (log_n - 1), kStageThreads), kStageThreads, 0,
                stream>>>(out, itw, log_n, s, r, s == log_n - 1, n_inv);
  }
  return cudaGetLastError();
}
