// The FRI fold of one committed oracle over GF(p^2): all k rounds of its
// schedule entry in one launch.
//
// Replaces the Pallas kernel boojum_tpu/prover/pallas_sweep.py _fold_body
// (via fri_fold), which boojum_tpu/prover/fri.py _fri_fold_fn(k) composes k
// times for one schedule entry. With the fold pair (x, -x) adjacent in the
// bit-reversed codeword, one round is
//   f'(x^2) = (f(x) + f(-x))/2 + ch * (f(x) - f(-x)) / (2x),
// and the rounds of an entry take the sub-challenges ch, ch^2, ch^4, ...
//
// Design: a thread folds the 2^K contiguous points of one output through all
// K rounds in registers, so no round between the first and the last touches
// device memory. It reads the entry's first-round 1/x table at its 2^(K-1)
// pairs once; round r + 1's 1/x is the square of every other entry of round
// r's (the pair (x, -x) at positions (2m, 2m + 1) folds to x^2 at position
// m), one product a pair and no table read. The fold is linear in the
// values, so the K products by 1/2 become one product by 2^-K at the store:
// the words are the same. A pair (a, b) costs four reductions: with 7 * ch1
// from the host, each component of (a - b) * ch is one sum of two 128-bit
// products, and a and b join the 128-bit product of that by 1/x before its
// reduction. Values stay lazy (any word below 2^64) between rounds, and
// each output is made canonical once, by its product by 2^-K; the stored
// words are canonical, so the first round subtracts with the carry chain.
// A thread's 2^K points and 2^(K-1) table words are 16-byte loads; a warp's
// loads of one component cover 32 * 2^K contiguous words.
//
// What bounds it on the H100: device memory, with the integer pipes close
// behind. The first oracle of the 2^20 fma prove (K = 3, 2^22 points) moves
// 88 MiB, 0.0275 ms at the card's memory rate; its arithmetic is about 790
// ALU-pipe instructions an output (SASS: scripts/torch_kernel_sass.py),
// 0.0245 ms at the card's integer issue rate. Both stay in flight together:
// each thread issues all its loads before its first product, and the
// threads are independent.
//
// A launch takes K <= kMaxK = 3 rounds, the longest entry fold_schedule
// gives; the wrapper (prover/fri.py fold_oracle) splits a longer entry into
// launches of kMaxK. A later launch of a split entry reads the entry's first
// table at stride 2^tab_shift and squares each word tab_shift times.
#include "goldilocks.cuh"

namespace {

constexpr int kMaxK = 3;  // prover/fri.py MAX_FOLD_K

// Threads a block, timed in turns against 64 and 256 on the H100.
constexpr int kThreads = 128;

struct Subs {
  uint64_t c0[kMaxK], c1[kMaxK], c1x7[kMaxK];  // c1x7 = 7 * c1 mod p
};

// 2^n words from p (16-byte aligned, n >= 1) into v, by 16-byte loads
template <int n>
__device__ __forceinline__ void load_words(const uint64_t* __restrict__ p,
                                           uint64_t (&v)[1 << n]) {
  const ulonglong2* q = reinterpret_cast<const ulonglong2*>(p);
#pragma unroll
  for (int j = 0; j < (1 << (n - 1)); ++j) {
    const ulonglong2 w = q[j];
    v[2 * j] = w.x;
    v[2 * j + 1] = w.y;
  }
}

// kStrided: a later launch of a split entry (tab_shift > 0). Apart from
// that, the code is straight: its SASS is one output's instructions.
template <int K, bool kStrided>
__global__ void __launch_bounds__(kThreads)
    fold_oracle(const uint64_t* __restrict__ c0, const uint64_t* __restrict__ c1,
                size_t n_out, const uint64_t* __restrict__ inv_x, int tab_shift,
                Subs subs, uint64_t scale, uint64_t* __restrict__ o0,
                uint64_t* __restrict__ o1) {
  constexpr int kPairs = 1 << (K - 1);  // the first round's pairs a thread
  const size_t i = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_out) return;
  uint64_t x0[2 * kPairs], x1[2 * kPairs], t[kPairs];
  load_words<K>(c0 + (i << K), x0);
  load_words<K>(c1 + (i << K), x1);
  if constexpr (!kStrided) {
    if constexpr (K == 1) {
      t[0] = inv_x[i];
    } else {
      load_words<K - 1>(inv_x + i * kPairs, t);
    }
  } else {
#pragma unroll
    for (int m = 0; m < kPairs; ++m) {
      uint64_t v = inv_x[(i * kPairs + m) << tab_shift];
      for (int s = 0; s < tab_shift; ++s) v = gl::mul_lazy(v, v);
      t[m] = v;
    }
  }
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const uint64_t ch0 = subs.c0[r], ch1 = subs.c1[r], ch1x7 = subs.c1x7[r];
#pragma unroll
    for (int m = 0; m < (kPairs >> r); ++m) {
      const uint64_t a0 = x0[2 * m], b0 = x0[2 * m + 1];
      const uint64_t a1 = x1[2 * m], b1 = x1[2 * m + 1];
      const uint64_t d0 = r == 0 ? gl::sub(a0, b0) : gl::sub_lazy(a0, b0);
      const uint64_t d1 = r == 0 ? gl::sub(a1, b1) : gl::sub_lazy(a1, b1);
      // g = (a - b) * ch = (d0 ch0 + 7 d1 ch1) + (d0 ch1 + d1 ch0) w
      const uint64_t g0 = gl::reduce_acc_lazy(gl::acc_mac(gl::prod(d0, ch0), d1, ch1x7));
      const uint64_t g1 = gl::reduce_acc_lazy(gl::acc_mac(gl::prod(d0, ch1), d1, ch0));
      // a + b + g / x
      x0[m] = gl::reduce_acc_lazy(gl::acc_add(gl::acc_add(gl::prod(t[m], g0), a0, 0), b0, 0));
      x1[m] = gl::reduce_acc_lazy(gl::acc_add(gl::acc_add(gl::prod(t[m], g1), a1, 0), b1, 0));
    }
#pragma unroll
    for (int m = 0; m < (kPairs >> (r + 1)); ++m) t[m] = gl::mul_lazy(t[2 * m], t[2 * m]);
  }
  o0[i] = gl::mul(x0[0], scale);
  o1[i] = gl::mul(x1[0], scale);
}

template <int K>
cudaError_t launch(const uint64_t* c0, const uint64_t* c1, size_t n_out,
                   const uint64_t* inv_x, int tab_shift, const Subs& subs,
                   uint64_t scale, uint64_t* o0, uint64_t* o1, cudaStream_t stream) {
  const unsigned blocks = unsigned((n_out + kThreads - 1) / kThreads);
  if (tab_shift == 0) {
    fold_oracle<K, false><<<blocks, kThreads, 0, stream>>>(c0, c1, n_out, inv_x, 0, subs,
                                                           scale, o0, o1);
  } else {
    fold_oracle<K, true><<<blocks, kThreads, 0, stream>>>(c0, c1, n_out, inv_x, tab_shift,
                                                          subs, scale, o0, o1);
  }
  return cudaGetLastError();
}

}  // namespace

// k rounds (1 <= k <= kMaxK) from n_out * 2^k points of (c0, c1) to n_out
// of (o0, o1); subs holds the k sub-challenges as word triples (c0, c1,
// 7 * c1 mod p), scale is 2^-k.
extern "C" cudaError_t bt_fri_fold_oracle(const uint64_t* c0, const uint64_t* c1,
                                          long long n_out, int k, const uint64_t* inv_x,
                                          int tab_shift, const uint64_t* subs,
                                          uint64_t scale, uint64_t* o0, uint64_t* o1,
                                          cudaStream_t stream) {
  if (k < 1 || k > kMaxK || n_out < 1) return cudaErrorInvalidValue;
  Subs s{};
  for (int r = 0; r < k; ++r) {
    s.c0[r] = subs[3 * r];
    s.c1[r] = subs[3 * r + 1];
    s.c1x7[r] = subs[3 * r + 2];
  }
  const size_t n = size_t(n_out);
  switch (k) {
    case 1: return launch<1>(c0, c1, n, inv_x, tab_shift, s, scale, o0, o1, stream);
    case 2: return launch<2>(c0, c1, n, inv_x, tab_shift, s, scale, o0, o1, stream);
    default: return launch<3>(c0, c1, n, inv_x, tab_shift, s, scale, o0, o1, stream);
  }
}
