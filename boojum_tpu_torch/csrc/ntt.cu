// Radix-2 NTT over Goldilocks for a batch of rows: forward sizes 2^1 .. 2^31,
// inverse 2^1 .. 2^30.
//
// Replaces the Pallas kernels of boojum_tpu/ntt/mxu_ntt.py: _fwd_kernel
// (forward NTT, natural in, bit-reversed out), _inv_kernel (inverse NTT,
// bit-reversed in, natural out, times 1/n) and _fwd_scaled_kernel (coset LDE:
// coefficient rows times coset scale rows, then the forward NTT). The TPU
// kernels are four-step int8-digit matmuls because the TPU has a matrix
// unit and no 64-bit multiply; Hopper multiplies 64-bit words directly, so
// the butterflies are the radix-2 network of ntt.py's dif_stages /
// dit_stages.
//
// The forward transform (B1, B3) runs in passes over device memory, each a
// batch of sub-transforms held on chip (the four-step / Bailey split). With
// n = 2^log_n and a plan of pass sizes K_1 + ... + K_P = log_n (chosen by
// ntt.py forward_pass_plan), pass p transforms index bits
// [lo, lo + K_p), lo = K_{p+1} + ... + K_P: for every value of the other
// bits, the 2^K_p points 2^lo words apart form one natural-order DIF
// sub-transform with output bit-reversed in place. A pass with lo > 0
// (strided) then multiplies the point at position q of column c (c < 2^lo)
// by omega_M^(c * bitrev(q)), M = 2^(lo + K_p): the four-step twiddle, read
// from a table laid out like the data (post). The last pass (lo = 0) takes
// contiguous blocks of 2^K_P words. Strided passes hold K <= 10, the last
// pass K <= 11, so the plan makes 1 pass up to 2^11, 2 passes up to 2^21
// (2^20: 9 + 11) and 3 passes up to 2^31. The values equal those of the
// stage-by-stage network, so the output words are the same.
//
// Inside a pass a block holds one tile in shared memory: 8 adjacent columns
// of a strided sub-transform (a warp loads and stores 64-byte runs), or
// consecutive last-pass sub-transforms filling 2^11 words. A thread holds 8
// words in registers and runs up to 3 stages on them between shared-memory
// exchanges, so a 2^11-point sub-transform takes 3 exchanges. The first
// round loads straight from device memory and the last stores straight to
// it; the sub-transform twiddles omega_{2^K}^j sit in shared memory, copied
// from a contiguous table (heap[2^(K-1) + j]). The LDE (B3) loads each input
// tile once and emits its L scaled cosets from it: the coset scale is
// multiplied in at the first pass's load.
//
// What bounds it on the H100: integer operations on the ALU pipe, once the
// passes are this few. Every word runs log_n / 2 butterflies, each a
// canonical multiply, add and subtract (gl::mul, gl::add, gl::sub), plus a
// four-step twiddle per strided pass and the coset scale; the products by 1
// of each sub-transform's last three stages are left out. Each pass reads
// and writes every word once. chip_smoke.py prices the work and gives the
// bound.
//
// The inverse (B2) keeps the stage-at-a-time design: the first 11 stages in
// shared memory, one tile of 2048 contiguous words per block, then one
// global pass per wider stage, the 1/n folded into the last.
//
// Layout: rows of n words, row-major. Forward: input row r / L (scaled by
// scale row r % L when a scale is given) lands in output row r, so a (B, n)
// coefficient stack with an (L, n) scale gives the (B, L, n) LDE. The
// inverse twiddle table holds omega^-i for i < n/2.
#include "goldilocks.cuh"

namespace {

// ---------------------------------------------------------------------------
// Forward passes
// ---------------------------------------------------------------------------

constexpr int kWords = 8;       // words a thread holds
constexpr int kMaxLast = 11;    // the last pass: 2^11-point sub-transforms
constexpr int kMaxStrided = 10;
constexpr int kLogLanes = 3;    // a strided tile: 8 adjacent columns

// A bank-spreading bijection on tile indices (within each aligned 128-word
// block; linear over GF(2), so it distributes over the | of disjoint bit
// fields): bits 0-3 take bits 3-6. With the round layouts below, the 16
// threads of a half-warp reach 16 different 8-byte bank pairs.
__device__ __forceinline__ uint32_t swz(uint32_t i) { return i ^ ((i >> 3) & 15u); }

// Tile geometry of a pass of K bits. A tile index is (position << 3) | lane
// in a strided pass and (sub-transform << K) | position in the last pass.
template <int K, bool STRIDED>
struct Geo {
  static constexpr int kLogW = STRIDED ? kLogLanes : (K < kMaxLast ? kMaxLast - K : 0);
  static constexpr int kS = K + kLogW;                  // log2 words a tile
  static constexpr int kThreads = (1 << kS) / kWords;
  static constexpr int kTB = STRIDED ? kLogLanes : 0;   // tile bit of position bit 0
  static constexpr int kFirst = K % 3 ? K % 3 : 3;      // position bits of round 1
  // Blocks an SM, capping registers: two strided blocks of up to 512
  // threads (64 registers; at 1024 threads the cap would spill), four
  // 256-thread last-pass blocks of up to 8 bits. Each measured faster on
  // the H100 than the compiler's choice; the last pass above 8 bits was not.
  static constexpr int kMinBlocks = STRIDED ? (K <= 9 ? 2 : 1) : (K <= 8 ? 4 : 1);
};

// The tile index of element e of a round on position bits [C, C + RB): the
// thread's group number u fills the other bits, lowest first.
template <int TB, int C, int RB>
__device__ __forceinline__ uint32_t tidx(uint32_t u, uint32_t e) {
  constexpr int lo = TB + C;
  return (u & ((1u << lo) - 1)) | (e << lo) | ((u >> lo) << (lo + RB));
}

// DIF stages on position bits C + RB - 1 .. C of the groups a thread holds:
// x[j * 2^RB + e] has round bits e in group j, and plo[j] holds the group's
// position bits below C. The pair (i0, i0 + 2^b) takes omega_{2^(b+1)}^(i0
// mod 2^b) = tsub[(i0 mod 2^b) << (K - 1 - b)]; in the last round (C = 0)
// that exponent is known at compile time, and where it is 0 (7 of the 12
// pairs) the product by 1 is left out.
template <int K, int C, int RB>
__device__ __forceinline__ void dif_round(uint64_t (&x)[kWords],
                                          const uint32_t (&plo)[kWords >> RB],
                                          const uint64_t* tsub) {
#pragma unroll
  for (int j = 0; j < (kWords >> RB); ++j) {
#pragma unroll
    for (int b = C + RB - 1; b >= C; --b) {
      const int h = 1 << (b - C);
#pragma unroll
      for (int e = 0; e < (1 << RB); ++e) {
        if (e & h) continue;
        const int a = j * (1 << RB) + e;
        const uint64_t u = x[a], v = x[a + h];
        const uint32_t m = plo[j] + (uint32_t(e & (h - 1)) << C);
        x[a] = gl::add(u, v);
        if (C == 0 && (e & (h - 1)) == 0)
          x[a + h] = gl::sub(u, v);
        else
          x[a + h] = gl::mul(gl::sub(u, v), tsub[m << (K - 1 - b)]);
      }
    }
  }
}

// Where tile element i of a block lies: its row and its offset in the row;
// false past the last row.
template <int K, bool STRIDED>
struct Locator {
  size_t block_row;   // strided: the block's row
  size_t base;        // strided: the tile's first word in its row
  size_t first_sub;   // last pass: the block's first sub-transform
  int log_n, lo;
  size_t rows;

  __device__ __forceinline__ Locator(int log_n_, int lo_, size_t rows_)
      : log_n(log_n_), lo(lo_), rows(rows_) {
    if (STRIDED) {
      const int log_tiles = log_n - K - kLogLanes;        // tiles per row
      block_row = size_t(blockIdx.x) >> log_tiles;
      const size_t t = size_t(blockIdx.x) & ((size_t(1) << log_tiles) - 1);
      const int log_groups = lo - kLogLanes;              // column groups
      const size_t hi = t >> log_groups;
      base = (hi << (lo + K)) + ((t & ((size_t(1) << log_groups) - 1)) << kLogLanes);
    } else {
      first_sub = size_t(blockIdx.x) << Geo<K, STRIDED>::kLogW;
    }
  }

  __device__ __forceinline__ bool at(uint32_t i, size_t& row, size_t& off) const {
    if (STRIDED) {
      row = block_row;
      off = base + (size_t(i >> kLogLanes) << lo) + (i & ((1u << kLogLanes) - 1));
      return true;
    }
    const size_t sub = first_sub + (i >> K);
    row = sub >> (log_n - K);
    off = ((sub & ((size_t(1) << (log_n - K)) - 1)) << K) + (i & ((1u << K) - 1));
    return row < rows;
  }
};

template <int K, bool STRIDED, int C, int RB>
__device__ __forceinline__ void group_lows(uint32_t t, uint32_t (&plo)[kWords >> RB]) {
  using G = Geo<K, STRIDED>;
#pragma unroll
  for (int j = 0; j < (kWords >> RB); ++j)
    plo[j] = ((t + j * G::kThreads) >> G::kTB) & ((1u << C) - 1);
}

template <int K, bool STRIDED, int C, int RB>
__device__ __forceinline__ void to_tile(const uint64_t (&x)[kWords], uint64_t* tile,
                                        uint32_t t) {
  using G = Geo<K, STRIDED>;
#pragma unroll
  for (int j = 0; j < (kWords >> RB); ++j)
#pragma unroll
    for (int e = 0; e < (1 << RB); ++e)
      tile[swz(tidx<G::kTB, C, RB>(t + j * G::kThreads, e))] = x[j * (1 << RB) + e];
}

template <int K, bool STRIDED, int C, int RB>
__device__ __forceinline__ void from_tile(uint64_t (&x)[kWords], const uint64_t* tile,
                                          uint32_t t) {
  using G = Geo<K, STRIDED>;
#pragma unroll
  for (int j = 0; j < (kWords >> RB); ++j)
#pragma unroll
    for (int e = 0; e < (1 << RB); ++e)
      x[j * (1 << RB) + e] = tile[swz(tidx<G::kTB, C, RB>(t + j * G::kThreads, e))];
}

// x holds a finished round on position bits [C, C + RB); run the rounds
// below it, 3 bits each, exchanging through the tile.
template <int K, bool STRIDED, int C, int RB>
__device__ __forceinline__ void lower_rounds(uint64_t (&x)[kWords], uint64_t* tile,
                                             const uint64_t* tsub, uint32_t t) {
  if constexpr (C > 0) {
    to_tile<K, STRIDED, C, RB>(x, tile, t);
    __syncthreads();
    from_tile<K, STRIDED, C - 3, 3>(x, tile, t);
    uint32_t plo[kWords >> 3];
    group_lows<K, STRIDED, C - 3, 3>(t, plo);
    dif_round<K, C - 3, 3>(x, plo, tsub);
    lower_rounds<K, STRIDED, C - 3, 3>(x, tile, tsub, t);
  }
}

// One forward pass of K position bits over `rows` rows of n words (see the
// header). The first pass reads `in` (scaled by `scale` row c for coset c
// when given) and writes L rows per input row; later passes have L = 1 and
// work in place on out.
template <int K, bool STRIDED>
__global__ void __launch_bounds__(Geo<K, STRIDED>::kThreads, Geo<K, STRIDED>::kMinBlocks)
dif_pass(const uint64_t* in, uint64_t* out, const uint64_t* scale, int L,
         const uint64_t* __restrict__ heap, const uint64_t* __restrict__ post,
         int log_n, int lo, size_t rows) {
  using G = Geo<K, STRIDED>;
  constexpr int C1 = K - G::kFirst, R1 = G::kFirst;
  constexpr int RL = K < 3 ? K : 3;  // bits of the last round (C = 0)
  extern __shared__ uint64_t sm[];
  uint64_t* tile = sm;
  uint64_t* tsub = sm + (1 << G::kS);
  const uint32_t t = threadIdx.x;
  const size_t n = size_t(1) << log_n;
  for (uint32_t m = t; m < (1u << (K - 1)); m += G::kThreads)
    tsub[m] = heap[(1u << (K - 1)) + m];
  const Locator<K, STRIDED> loc(log_n, lo, rows);

  uint64_t raw[kWords];
#pragma unroll
  for (int j = 0; j < (kWords >> R1); ++j)
#pragma unroll
    for (int e = 0; e < (1 << R1); ++e) {
      size_t row, off;
      const bool ok = loc.at(tidx<G::kTB, C1, R1>(t + j * G::kThreads, e), row, off);
      raw[j * (1 << R1) + e] = ok ? in[row * n + off] : 0;
    }
  uint32_t plo1[kWords >> R1];
  group_lows<K, STRIDED, C1, R1>(t, plo1);
  __syncthreads();  // tsub

  for (int c = 0; c < L; ++c) {
    if (c) __syncthreads();  // the last coset's final reads of the tile
    uint64_t x[kWords];
#pragma unroll
    for (int j = 0; j < (kWords >> R1); ++j)
#pragma unroll
      for (int e = 0; e < (1 << R1); ++e) {
        const int a = j * (1 << R1) + e;
        x[a] = raw[a];
        if (scale) {
          size_t row, off;
          loc.at(tidx<G::kTB, C1, R1>(t + j * G::kThreads, e), row, off);
          x[a] = gl::mul(raw[a], scale[size_t(c) * n + off]);
        }
      }
    dif_round<K, C1, R1>(x, plo1, tsub);
    lower_rounds<K, STRIDED, C1, R1>(x, tile, tsub, t);
    // x holds the round on position bits [0, RL)
#pragma unroll
    for (int j = 0; j < (kWords >> RL); ++j) {
      const uint32_t u = t + j * G::kThreads;
      if constexpr (STRIDED) {
        const size_t mask = (size_t(1) << (lo + K)) - 1;
#pragma unroll
        for (int e = 0; e < (1 << RL); ++e) {
          size_t row, off;
          loc.at(tidx<G::kTB, 0, RL>(u, e), row, off);
          out[(row * L + c) * n + off] = gl::mul(x[j * (1 << RL) + e], post[off & mask]);
        }
      } else {
        // the group's 2^RL words are consecutive: 16-byte stores
        size_t row, off;
        if (!loc.at(tidx<0, 0, RL>(u, 0), row, off)) continue;
        uint64_t* dst = out + (row * L + c) * n + off;
#pragma unroll
        for (int e = 0; e < (1 << RL); e += 2)
          reinterpret_cast<ulonglong2*>(dst)[e / 2] =
              make_ulonglong2(x[j * (1 << RL) + e], x[j * (1 << RL) + e + 1]);
      }
    }
  }
}

template <int K, bool STRIDED>
cudaError_t launch_pass(const uint64_t* in, uint64_t* out, const uint64_t* scale,
                        int L, const uint64_t* heap, const uint64_t* post, int log_n,
                        int lo, size_t rows, cudaStream_t stream) {
  using G = Geo<K, STRIDED>;
  const size_t smem = ((size_t(1) << G::kS) + (size_t(1) << (K - 1))) * 8;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        dif_pass<K, STRIDED>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return e;
  }
  const size_t subs = rows << (log_n - K);  // sub-transforms (strided: columns)
  const size_t blocks = STRIDED ? subs >> kLogLanes
                                : (subs + (size_t(1) << G::kLogW) - 1) >> G::kLogW;
  dif_pass<K, STRIDED><<<unsigned(blocks), G::kThreads, smem, stream>>>(
      in, out, scale, L, heap, post, log_n, lo, rows);
  return cudaGetLastError();
}

template <bool STRIDED, int K = 1>
cudaError_t dispatch_pass(int k, const uint64_t* in, uint64_t* out, const uint64_t* scale,
                          int L, const uint64_t* heap, const uint64_t* post, int log_n,
                          int lo, size_t rows, cudaStream_t stream) {
  if constexpr (K > (STRIDED ? kMaxStrided : kMaxLast)) {
    return cudaErrorInvalidValue;
  } else {
    if (k == K)
      return launch_pass<K, STRIDED>(in, out, scale, L, heap, post, log_n, lo, rows,
                                     stream);
    return dispatch_pass<STRIDED, K + 1>(k, in, out, scale, L, heap, post, log_n, lo,
                                         rows, stream);
  }
}

// ---------------------------------------------------------------------------
// Inverse
// ---------------------------------------------------------------------------

constexpr int kLogTile = 11;
constexpr int kTailThreads = 256;
constexpr int kStageThreads = 256;

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
// when scale is not null, in the passes of `plan` (num_passes sizes, first
// to last; see the header). heap[2^(K-1) + j] = omega_{2^K}^j for every pass
// size K; post holds the strided passes' twiddle tables one after another
// (2^(lo + K) words each). in and out may be the same buffer only when L = 1.
extern "C" cudaError_t bt_ntt_forward(const uint64_t* in, uint64_t* out,
                                      const uint64_t* scale, int L,
                                      const uint64_t* heap, const uint64_t* post,
                                      const int* plan, int num_passes, int log_n,
                                      long long rows, cudaStream_t stream) {
  if (L < 1 || rows % L || num_passes < 1) return cudaErrorInvalidValue;
  int bits = 0;
  for (int p = 0; p < num_passes; ++p) {
    const int k = plan[p];
    bits += k;
    const int lo = log_n - bits;
    const bool ok = lo > 0 ? (k >= 1 && k <= kMaxStrided && lo >= kLogLanes)
                           : (lo == 0 && k >= 1 && k <= kMaxLast);
    if (!ok) return cudaErrorInvalidValue;
  }
  const size_t rows_in = size_t(rows) / L;
  const uint64_t* src = in;
  int lo = log_n;
  for (int p = 0; p < num_passes; ++p) {
    const int k = plan[p];
    lo -= k;
    const bool first = p == 0;
    const cudaError_t e =
        lo > 0 ? dispatch_pass<true>(k, src, out, first ? scale : nullptr, first ? L : 1,
                                     heap, post, log_n, lo, first ? rows_in : size_t(rows),
                                     stream)
               : dispatch_pass<false>(k, src, out, first ? scale : nullptr,
                                      first ? L : 1, heap, post, log_n, 0,
                                      first ? rows_in : size_t(rows), stream);
    if (e != cudaSuccess) return e;
    if (lo > 0) post += size_t(1) << (lo + k);
    src = out;
  }
  return cudaSuccess;
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
