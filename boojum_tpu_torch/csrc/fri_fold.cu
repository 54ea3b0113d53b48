// One FRI fold round over GF(p^2) on a bit-reversed codeword.
//
// Replaces the Pallas kernel boojum_tpu/prover/pallas_sweep.py _fold_body
// (via fri_fold / fri_fold_planes): with the fold pair (x, -x) adjacent,
//   f'(x^2) = (f(x) + f(-x))/2 + ch * (f(x) - f(-x)) / (2x),
// computed as ((a + b) + (a - b) * (1/x) * ch) * (1/2), the same operation
// order as prover/fri.py _fold_once_jit. The TPU kernel splits every word
// into u32 planes; here each thread folds one pair with 64-bit words.
//
// What bounds it on the H100: device memory. Each output reads 40 bytes
// (two ext values and 1/x) and writes 16 for 7 field multiplies, about 2.5
// 32-bit integer instructions per byte, half the card's ratio of integer
// issue rate to memory rate. The design is one coalesced elementwise pass
// per round: neighbouring threads read neighbouring pairs, nothing is staged.
#include "goldilocks.cuh"

namespace {

__global__ void fold(const uint64_t* __restrict__ c0,
                     const uint64_t* __restrict__ c1, size_t n_out,
                     uint64_t ch0, uint64_t ch1,
                     const uint64_t* __restrict__ inv_x,
                     uint64_t* __restrict__ o0, uint64_t* __restrict__ o1) {
  const size_t i = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_out) return;
  const gl::Ext a{c0[2 * i], c1[2 * i]};
  const gl::Ext b{c0[2 * i + 1], c1[2 * i + 1]};
  const gl::Ext s = gl::ext_add(a, b);
  const gl::Ext d_over_x = gl::ext_mul_base(gl::ext_sub(a, b), inv_x[i]);
  const gl::Ext t = gl::ext_add(s, gl::ext_mul(d_over_x, gl::Ext{ch0, ch1}));
  o0[i] = gl::mul(t.c0, gl::HALF);
  o1[i] = gl::mul(t.c1, gl::HALF);
}

constexpr int kThreads = 256;

}  // namespace

extern "C" cudaError_t bt_fri_fold(const uint64_t* c0, const uint64_t* c1,
                                   long long n_out, uint64_t ch0, uint64_t ch1,
                                   const uint64_t* inv_x, uint64_t* o0,
                                   uint64_t* o1, cudaStream_t stream) {
  const unsigned blocks = unsigned((size_t(n_out) + kThreads - 1) / kThreads);
  fold<<<blocks, kThreads, 0, stream>>>(c0, c1, size_t(n_out), ch0, ch1,
                                        inv_x, o0, o1);
  return cudaGetLastError();
}
