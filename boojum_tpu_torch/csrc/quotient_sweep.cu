// Per-coset quotient terms: gate constraints, the copy permutation and the
// specialized-column lookup argument, in GF(p^2), times 1/Z_H.
//
// Replaces the Pallas kernel boojum_tpu/prover/pallas_sweep.py
// build_coset_terms (body assembled by _tiled_ext_call): the gate part
// (_gate_terms, packed-op replay _scan_replay), the copy-permutation part
// (_cp_terms) and the specialized lookup part (_lookup_terms); its general
// lookup mode is not ported. The TPU
// kernel traces every gate into the kernel body on (lo, hi) u32 planes; here
// one thread evaluates one coset row with 64-bit words, replaying each
// gate's captured op program from a table, so a new gate or a new
// challenge needs no rebuild.
//
// What bounds it on the H100: integer operations. A row reads 8 bytes from
// each of the 55 coset columns and tables (16 witness, 22 setup, 12 stage-2,
// 2 shifted z, x, L0, 1/Z_H) and writes 16, about 460 bytes, and at the
// fma-chain widths does some 6,500 32-bit integer instructions (the gate
// programs, the GF(p^2) chunk products and the alpha weights, as
// chip_smoke.py counts them): about 14 per byte, nearly three times the
// card's ratio of integer issue rate to memory rate. The table and the
// challenge powers are read by every thread at the same address and stay in
// cache. The interpreter keeps its slots in a small per-thread array. The
// lookup terms share the row's stage-2 reads and the one 1/Z_H multiply, so
// they run in the same launch: per sub-argument i,
// A_i·(Σ_j γ'^j·w_{i,j} + γ'^w·tid + β') - 1, then for the table
// B·(Σ_j γ'^j·t_j + γ'^w·t_id + β') - M, where β' + γ'^w·tid is computed
// once per row. At the sha256 widths (92 copy columns, 8 sub-arguments of
// width 4) the row reads 93 witness, 106 setup and 46 stage-2 words.
//
// Program table (int32), per gate with quotient terms, in gate order:
//   path_len, path bits..., reps, principal_width, const_off, num_slots,
//   num_loads, (slot, kind 0=copy 2=constant, index)...,
//   num_consts, (slot, index into kvals)...,
//   num_ops, (opcode 0=add 1=sub 2=mul 3=neg 4=double, dst, a, b)...,
//   num_terms, term slots...
// preceded by the gate count. Kind 1 (a witness column) is refused by the
// encoder on the host until witness columns are ported. Scalar table
// (uint64): beta (2), gamma (2), the non-residues (Ct), then the alpha powers
// as c0 (T) and c1 (T); with lookups (R > 0) then beta' (2) and the powers
// gamma'^0..gamma'^width as (c0, c1) pairs.
//
// Operands: wit rows [general copy (Cg) | lookup copy (R·width) | M]; setup
// rows [sigma (Ct) | constants (num_consts, the table id last) | table
// columns (width + 1)]; s2 rows [z | partials | A_i pairs | B pair].
#include "goldilocks.cuh"

namespace {

constexpr int kMaxSlots = 32;
constexpr int kThreads = 128;

using gl::Ext;

__global__ void sweep(const uint64_t* __restrict__ wit,
                      const uint64_t* __restrict__ setup,
                      const uint64_t* __restrict__ s2,
                      const uint64_t* __restrict__ zs,
                      const uint64_t* __restrict__ xs,
                      const uint64_t* __restrict__ l0,
                      const uint64_t* __restrict__ zhinv,
                      const uint64_t* __restrict__ table,
                      const int* __restrict__ prog,
                      const uint64_t* __restrict__ kvals, int Cg, int Ct,
                      int num_consts, int chunk_deg, int num_alpha, int R,
                      int width, size_t n,
                      uint64_t* __restrict__ out0,
                      uint64_t* __restrict__ out1) {
  const size_t row = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const Ext beta{table[0], table[1]};
  const Ext gamma{table[2], table[3]};
  const uint64_t* ks = table + 4;
  const uint64_t* a0 = ks + Ct;
  const uint64_t* a1 = a0 + num_alpha;
  const uint64_t* consts = setup + size_t(Ct) * n;  // constant columns
  Ext acc{0, 0};
  int t = 0;  // alpha power index

  // ---- gate terms ----
  uint64_t slot[kMaxSlots];
  int pc = 0;
  const int num_gates = prog[pc++];
  for (int g = 0; g < num_gates; ++g) {
    const int path_len = prog[pc++];
    uint64_t sel = 1;
    for (int b = 0; b < path_len; ++b) {
      const uint64_t cb = consts[size_t(b) * n + row];
      sel = gl::mul(sel, prog[pc++] ? cb : gl::sub(1, cb));
    }
    const int reps = prog[pc++];
    const int pw = prog[pc++];
    const int const_off = prog[pc++];
    pc++;  // num_slots, checked on the host
    const int body = pc;
    Ext gate_acc{0, 0};
    for (int inst = 0; inst < reps; ++inst) {
      pc = body;
      const int num_loads = prog[pc++];
      for (int i = 0; i < num_loads; ++i, pc += 3) {
        const int idx = prog[pc + 2];
        const size_t col = prog[pc + 1] == 0 ? size_t(inst * pw + idx)
                                             : size_t(const_off + idx);
        const uint64_t* base = prog[pc + 1] == 0 ? wit : consts;
        slot[prog[pc]] = base[col * n + row];
      }
      const int num_consts = prog[pc++];
      for (int i = 0; i < num_consts; ++i, pc += 2)
        slot[prog[pc]] = kvals[prog[pc + 1]];
      const int num_ops = prog[pc++];
      for (int i = 0; i < num_ops; ++i, pc += 4) {
        const uint64_t x = slot[prog[pc + 2]], y = slot[prog[pc + 3]];
        uint64_t r;
        switch (prog[pc]) {
          case 0: r = gl::add(x, y); break;
          case 1: r = gl::sub(x, y); break;
          case 2: r = gl::mul(x, y); break;
          case 3: r = gl::neg(x); break;
          default: r = gl::dbl(x); break;
        }
        slot[prog[pc + 1]] = r;
      }
      const int num_terms = prog[pc++];
      for (int i = 0; i < num_terms; ++i, ++t) {
        const uint64_t term = slot[prog[pc++]];
        gate_acc = gl::ext_add(gate_acc, Ext{gl::mul(term, a0[t]),
                                             gl::mul(term, a1[t])});
      }
    }
    acc = gl::ext_add(acc, gl::ext_mul_base(gate_acc, sel));
  }

  // ---- copy-permutation terms ----
  const Ext z{s2[row], s2[n + row]};
  const Ext z_shift{zs[row], zs[n + row]};
  const uint64_t x = xs[row];
  const Ext zm1{gl::sub(z.c0, 1), z.c1};
  acc = gl::ext_add(acc, gl::ext_mul(gl::ext_mul_base(zm1, l0[row]),
                                     Ext{a0[t], a1[t]}));
  ++t;
  const int num_chunks = (Ct + chunk_deg - 1) / chunk_deg;
  Ext prev = z;  // rhs of chunk j: z, then partial j-1
  for (int j = 0; j < num_chunks; ++j) {
    Ext num_p{1, 0}, den_p{1, 0};
    const int end = min(Ct, (j + 1) * chunk_deg);
    for (int col = j * chunk_deg; col < end; ++col) {
      const uint64_t w = wit[size_t(col) * n + row];
      const uint64_t kx = gl::mul(x, ks[col]);
      const Ext num{gl::add(gl::add(w, gl::mul(kx, beta.c0)), gamma.c0),
                    gl::add(gl::mul(kx, beta.c1), gamma.c1)};
      const uint64_t s = setup[size_t(col) * n + row];
      const Ext den{gl::add(gl::add(w, gl::mul(s, beta.c0)), gamma.c0),
                    gl::add(gl::mul(s, beta.c1), gamma.c1)};
      num_p = col == j * chunk_deg ? num : gl::ext_mul(num_p, num);
      den_p = col == j * chunk_deg ? den : gl::ext_mul(den_p, den);
    }
    const Ext lhs = j + 1 < num_chunks
                        ? Ext{s2[size_t(2 + 2 * j) * n + row],
                              s2[size_t(3 + 2 * j) * n + row]}
                        : z_shift;
    const Ext term = gl::ext_sub(gl::ext_mul(lhs, den_p),
                                 gl::ext_mul(prev, num_p));
    acc = gl::ext_add(acc, gl::ext_mul(term, Ext{a0[t], a1[t]}));
    ++t;
    prev = lhs;
  }

  // ---- lookup terms (specialized columns) ----
  if (R > 0) {
    const uint64_t* lk = a1 + num_alpha;  // beta', then gamma'^j pairs
    const uint64_t* gp = lk + 2;
    const Ext lbeta{lk[0], lk[1]};
    const size_t ab = size_t(2 * num_chunks);  // first A row of s2
    const uint64_t tid = consts[size_t(num_consts - 1) * n + row];
    const Ext base =
        gl::ext_add(lbeta, gl::ext_mul_base(Ext{gp[2 * width], gp[2 * width + 1]}, tid));
    for (int i = 0; i < R; ++i, ++t) {
      Ext den = base;
      for (int j = 0; j < width; ++j) {
        const uint64_t v = wit[size_t(Cg + i * width + j) * n + row];
        den = gl::ext_add(den, gl::ext_mul_base(Ext{gp[2 * j], gp[2 * j + 1]}, v));
      }
      const Ext a{s2[(ab + 2 * i) * n + row], s2[(ab + 2 * i + 1) * n + row]};
      Ext term = gl::ext_mul(a, den);
      term.c0 = gl::sub(term.c0, 1);
      acc = gl::ext_add(acc, gl::ext_mul(term, Ext{a0[t], a1[t]}));
    }
    const uint64_t* tab = consts + size_t(num_consts) * n;  // table columns
    Ext den = lbeta;
    for (int j = 0; j <= width; ++j) {
      const uint64_t v = tab[size_t(j) * n + row];
      den = gl::ext_add(den, gl::ext_mul_base(Ext{gp[2 * j], gp[2 * j + 1]}, v));
    }
    const Ext b{s2[(ab + 2 * R) * n + row], s2[(ab + 2 * R + 1) * n + row]};
    Ext term = gl::ext_mul(b, den);
    term.c0 = gl::sub(term.c0, wit[size_t(Ct) * n + row]);
    acc = gl::ext_add(acc, gl::ext_mul(term, Ext{a0[t], a1[t]}));
  }
  out0[row] = gl::mul(acc.c0, zhinv[row]);
  out1[row] = gl::mul(acc.c1, zhinv[row]);
}

}  // namespace

extern "C" cudaError_t bt_quotient_sweep(
    const uint64_t* wit, const uint64_t* setup, const uint64_t* s2,
    const uint64_t* zs, const uint64_t* xs, const uint64_t* l0,
    const uint64_t* zhinv, const uint64_t* table, const int* prog,
    const uint64_t* kvals, int Cg, int Ct, int num_consts, int chunk_deg,
    int num_alpha, int R, int width, long long n, uint64_t* out0,
    uint64_t* out1, cudaStream_t stream) {
  const unsigned blocks = unsigned((size_t(n) + kThreads - 1) / kThreads);
  sweep<<<blocks, kThreads, 0, stream>>>(wit, setup, s2, zs, xs, l0, zhinv,
                                         table, prog, kvals, Cg, Ct,
                                         num_consts, chunk_deg, num_alpha, R,
                                         width, size_t(n), out0, out1);
  return cudaGetLastError();
}
