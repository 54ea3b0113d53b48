// Radix-2 NTT over Goldilocks for a batch of rows, sizes 2^1 .. 2^31.
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
// The inverse (B2) runs the same passes in mirror order (ntt.py
// inverse_pass_plan, the forward plan reversed: 2^20 is 11 + 9). A DIT
// network with bit-reversed input is the inverse of the DIF network, pass
// for pass: pass p transforms index bits [lo, lo + K_p), lo = K_1 + ... +
// K_(p-1), so the first pass takes contiguous sub-transforms of 2^K_1 words
// on the low bits, and each later (strided) pass first undoes the forward
// pass's four-step twiddle, multiplying the point at position q of column c
// by omega_M^-(c * bitrev(q)) at its load (table pre, laid out like the
// data), then runs the DIT stages of its 2^K_p points (the pair (i0, i0 +
// 2^b) takes omega_{2^(b+1)}^-(i0 mod 2^b) on the odd element before its add
// and subtract). The rounds are the forward's in reverse order, on the same
// tile layouts: the first round (C = 0) loads from device memory and leaves
// out its products by 1, the last stores. 1/n rides in the last pass: in its
// table when it is strided (no extra multiply), as one multiply at the store
// when the transform is one pass. Each DIT stage of a sub-transform is twice
// the inverse of the DIF stage with the inverse twiddle, so the passes give
// n times the inverse of the forward transform before the 1/n: the words of
// ntt.py's ifft_plain.
//
// Layout: rows of n words, row-major. Forward: input row r / L (scaled by
// scale row r % L when a scale is given) lands in output row r, so a (B, n)
// coefficient stack with an (L, n) scale gives the (B, L, n) LDE.
#include "goldilocks.cuh"

namespace {

// ---------------------------------------------------------------------------
// Passes (the forward and the inverse share the tile machinery)
// ---------------------------------------------------------------------------

constexpr int kWords = 8;       // words a thread holds
constexpr int kMaxLast = 11;    // the last pass: 2^11-point sub-transforms
constexpr int kMaxStrided = 10;
constexpr int kLogLanes = 3;    // a strided tile: 8 adjacent columns

// What one pass launch reads (on the host; the kernels take its fields as
// parameters, the tables __restrict__, so their loads may move past stores).
struct PassArgs {
  const uint64_t* in;      // the pass's input rows (later passes: out, in place)
  uint64_t* out;
  const uint64_t* scale;   // forward, first pass: coset scale rows (null: none)
  int L;                   // forward, first pass: output rows an input row makes
  const uint64_t* heap;    // heap[2^(K-1) + j]: the sub-transform's twiddles
  const uint64_t* table;   // strided: the four-step table (forward post, inverse pre)
  uint64_t n_inv;          // inverse, a single pass: 1/n at the store (0: none)
  int log_n, lo;
  size_t rows;             // the pass's input rows
};

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

// DIT stages on position bits C .. C + RB - 1 of the groups a thread holds
// (dif_round's layout): the pair (i0, i0 + 2^b) multiplies its odd element
// by omega_{2^(b+1)}^-(i0 mod 2^b) = tsub[(i0 mod 2^b) << (K - 1 - b)], tsub
// the inverse roots, then adds and subtracts. In the first round (C = 0)
// that exponent is known at compile time, and where it is 0 (7 of the 12
// pairs) the product by 1 is left out.
template <int K, int C, int RB>
__device__ __forceinline__ void dit_round(uint64_t (&x)[kWords],
                                          const uint32_t (&plo)[kWords >> RB],
                                          const uint64_t* tsub) {
#pragma unroll
  for (int j = 0; j < (kWords >> RB); ++j) {
#pragma unroll
    for (int b = C; b < C + RB; ++b) {
      const int h = 1 << (b - C);
#pragma unroll
      for (int e = 0; e < (1 << RB); ++e) {
        if (e & h) continue;
        const int a = j * (1 << RB) + e;
        const uint32_t m = plo[j] + (uint32_t(e & (h - 1)) << C);
        const uint64_t u = x[a];
        const uint64_t v = (C == 0 && (e & (h - 1)) == 0)
                               ? x[a + h]
                               : gl::mul(x[a + h], tsub[m << (K - 1 - b)]);
        x[a] = gl::add(u, v);
        x[a + h] = gl::sub(u, v);
      }
    }
  }
}

// x holds a finished round on position bits [C, C + RB); run the rounds
// above it, 3 bits each and the rest last (the forward's rounds in reverse
// order), exchanging through the tile.
template <int K, bool STRIDED, int C, int RB>
__device__ __forceinline__ void upper_rounds(uint64_t (&x)[kWords], uint64_t* tile,
                                             const uint64_t* tsub, uint32_t t) {
  constexpr int C2 = C + RB;
  if constexpr (C2 < K) {
    constexpr int R2 = K - C2 < 3 ? K - C2 : 3;
    to_tile<K, STRIDED, C, RB>(x, tile, t);
    __syncthreads();
    from_tile<K, STRIDED, C2, R2>(x, tile, t);
    uint32_t plo[kWords >> R2];
    group_lows<K, STRIDED, C2, R2>(t, plo);
    dit_round<K, C2, R2>(x, plo, tsub);
    upper_rounds<K, STRIDED, C2, R2>(x, tile, tsub, t);
  }
}

// One inverse pass of K position bits (see the header): the first pass
// (contiguous) reads in, later (strided) passes work in place on out and
// multiply in their pre table at the load.
template <int K, bool STRIDED>
__global__ void __launch_bounds__(Geo<K, STRIDED>::kThreads, Geo<K, STRIDED>::kMinBlocks)
dit_pass(const uint64_t* in, uint64_t* out, const uint64_t* __restrict__ heap,
         const uint64_t* __restrict__ pre, uint64_t n_inv, int log_n, int lo, size_t rows) {
  using G = Geo<K, STRIDED>;
  constexpr int R0 = K < 3 ? K : 3;                 // the first round, C = 0
  constexpr int CL = K - G::kFirst, RL = G::kFirst;  // the last round
  extern __shared__ uint64_t sm[];
  uint64_t* tile = sm;
  uint64_t* tsub = sm + (1 << G::kS);
  const uint32_t t = threadIdx.x;
  const size_t n = size_t(1) << log_n;
  for (uint32_t m = t; m < (1u << (K - 1)); m += G::kThreads)
    tsub[m] = heap[(1u << (K - 1)) + m];
  const Locator<K, STRIDED> loc(log_n, lo, rows);

  uint64_t x[kWords];
#pragma unroll
  for (int j = 0; j < (kWords >> R0); ++j) {
    const uint32_t u = t + j * G::kThreads;
    if constexpr (STRIDED) {
      const size_t mask = (size_t(1) << (lo + K)) - 1;
#pragma unroll
      for (int e = 0; e < (1 << R0); ++e) {
        size_t row, off;
        loc.at(tidx<G::kTB, 0, R0>(u, e), row, off);
        x[j * (1 << R0) + e] = gl::mul(in[row * n + off], pre[off & mask]);
      }
    } else {
      // the group's 2^R0 words are consecutive: 16-byte loads (the wrapper
      // hands in a 16-byte aligned buffer)
      size_t row, off;
      const bool ok = loc.at(tidx<0, 0, R0>(u, 0), row, off);
      const ulonglong2* src = reinterpret_cast<const ulonglong2*>(in + row * n + off);
#pragma unroll
      for (int e = 0; e < (1 << R0); e += 2) {
        const ulonglong2 v = ok ? src[e / 2] : make_ulonglong2(0, 0);
        x[j * (1 << R0) + e] = v.x;
        x[j * (1 << R0) + e + 1] = v.y;
      }
    }
  }
  uint32_t plo0[kWords >> R0];
  group_lows<K, STRIDED, 0, R0>(t, plo0);
  __syncthreads();  // tsub
  dit_round<K, 0, R0>(x, plo0, tsub);
  upper_rounds<K, STRIDED, 0, R0>(x, tile, tsub, t);
  // x holds the round on position bits [CL, CL + RL); threads of a warp
  // store consecutive words (strided: 64-byte runs)
#pragma unroll
  for (int j = 0; j < (kWords >> RL); ++j)
#pragma unroll
    for (int e = 0; e < (1 << RL); ++e) {
      size_t row, off;
      if (!loc.at(tidx<G::kTB, CL, RL>(t + j * G::kThreads, e), row, off)) continue;
      const uint64_t v = x[j * (1 << RL) + e];
      out[row * n + off] = n_inv ? gl::mul(v, n_inv) : v;
    }
}

template <bool INV, int K, bool STRIDED>
cudaError_t launch_pass(const PassArgs& a, cudaStream_t stream) {
  using G = Geo<K, STRIDED>;
  const size_t smem = ((size_t(1) << G::kS) + (size_t(1) << (K - 1))) * 8;
  if (smem > 48 * 1024) {
    cudaError_t e;
    if constexpr (INV)
      e = cudaFuncSetAttribute(dit_pass<K, STRIDED>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    else
      e = cudaFuncSetAttribute(dif_pass<K, STRIDED>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return e;
  }
  const size_t subs = a.rows << (a.log_n - K);  // sub-transforms (strided: columns)
  const unsigned blocks = unsigned(STRIDED ? subs >> kLogLanes
                                           : (subs + (size_t(1) << G::kLogW) - 1) >> G::kLogW);
  if constexpr (INV)
    dit_pass<K, STRIDED><<<blocks, G::kThreads, smem, stream>>>(
        a.in, a.out, a.heap, a.table, a.n_inv, a.log_n, a.lo, a.rows);
  else
    dif_pass<K, STRIDED><<<blocks, G::kThreads, smem, stream>>>(
        a.in, a.out, a.scale, a.L, a.heap, a.table, a.log_n, a.lo, a.rows);
  return cudaGetLastError();
}

template <bool INV, bool STRIDED, int K = 1>
cudaError_t dispatch_pass(int k, const PassArgs& a, cudaStream_t stream) {
  if constexpr (K > (STRIDED ? kMaxStrided : kMaxLast)) {
    return cudaErrorInvalidValue;
  } else {
    if (k == K) return launch_pass<INV, K, STRIDED>(a, stream);
    return dispatch_pass<INV, STRIDED, K + 1>(k, a, stream);
  }
}

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
    const PassArgs a{src, out, first ? scale : nullptr, first ? L : 1, heap, post, 0,
                     log_n, lo, first ? rows_in : size_t(rows)};
    const cudaError_t e = lo > 0 ? dispatch_pass<false, true>(k, a, stream)
                                 : dispatch_pass<false, false>(k, a, stream);
    if (e != cudaSuccess) return e;
    if (lo > 0) post += size_t(1) << (lo + k);
    src = out;
  }
  return cudaSuccess;
}

// out (rows, n) = inverse NTT of the bit-reversed input rows, times n_inv,
// in the passes of `plan` (num_passes sizes, first: the low bits, to last;
// see the header). heap[2^(K-1) + j] = omega_{2^K}^-j for every pass size K;
// pre holds the strided passes' tables one after another (2^(lo + K) words
// each, the last times n_inv). in must be 16-byte aligned; in and out may be
// the same buffer.
extern "C" cudaError_t bt_ntt_inverse(const uint64_t* in, uint64_t* out,
                                      const uint64_t* heap, const uint64_t* pre,
                                      const int* plan, int num_passes, int log_n,
                                      long long rows, uint64_t n_inv,
                                      cudaStream_t stream) {
  if (num_passes < 1 || (reinterpret_cast<uintptr_t>(in) & 15)) return cudaErrorInvalidValue;
  int lo = 0;
  for (int p = 0; p < num_passes; ++p) {
    const int k = plan[p];
    const bool ok = p == 0 ? (k >= 1 && k <= kMaxLast)
                           : (k >= 1 && k <= kMaxStrided && lo >= kLogLanes);
    if (!ok) return cudaErrorInvalidValue;
    lo += k;
  }
  if (lo != log_n) return cudaErrorInvalidValue;
  lo = 0;
  for (int p = 0; p < num_passes; ++p) {
    const int k = plan[p];
    const PassArgs a{p == 0 ? in : out, out, nullptr, 1, heap, pre,
                     num_passes == 1 ? n_inv : 0, log_n, lo, size_t(rows)};
    const cudaError_t e = lo > 0 ? dispatch_pass<true, true>(k, a, stream)
                                 : dispatch_pass<true, false>(k, a, stream);
    if (e != cudaSuccess) return e;
    if (lo > 0) pre += size_t(1) << (lo + k);
    lo += k;
  }
  return cudaSuccess;
}
