// Per-coset quotient terms: gate constraints, the copy permutation and the
// lookup argument (specialized or general-purpose columns), in GF(p^2),
// times 1/Z_H.
//
// Replaces the Pallas kernel boojum_tpu/prover/pallas_sweep.py
// build_coset_terms (body assembled by _tiled_ext_call): the gate part
// (_gate_terms, packed-op replay _scan_replay), the copy-permutation part
// (_cp_terms) and the lookup part (_lookup_terms, both modes), and its
// standalone entries cp_quotient, lookup_quotient, lookup_quotient_general
// and gate_terms_fn, which are this launch with the other parts switched
// off and no 1/Z_H. The TPU kernel traces every gate into the kernel body on
// (lo, hi) u32 planes; here one thread evaluates one coset row with 64-bit
// words, replaying each gate's captured op program from a table, so a new
// gate or a new challenge needs no rebuild.
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
// A_i·(Σ_j γ'^j·w_{i,j} + γ'^w·tid + β') - sel, then for the table
// B·(Σ_j γ'^j·t_j + γ'^w·t_id + β') - M, where β' + γ'^w·tid and sel are
// computed once per row. sel is 1 in specialized mode (empty path) and the
// lookup-marker gate's selector over the constant columns in general mode,
// the same product the gate part forms for a gate's selector.
//
// Program table (int32): first the lookup header
//   R, width, first tuple column, table-id constant column, sel path_len,
//   sel path bits...
// (R = 0: no lookup terms), then the gate count and, per gate with quotient
// terms, in gate order:
//   path_len, path bits..., reps, num_slots,
//   num_loads, (slot, block 0=cols 1=constants, base, stride)...,
//   num_consts, (slot, index into kvals)...,
//   num_ops, (opcode 0=add 1=sub 2=mul 3=neg 4=double, dst, a, b)...,
//   num_terms, term slots...
// Scalar table (uint64): beta (2), gamma (2), the non-residues (Ct), then
// the alpha powers as c0 (T) and c1 (T); with lookups then beta' (2) and the
// powers gamma'^0..gamma'^width as (c0, c1) pairs.
//
// A load of instance inst reads column base + inst·stride of its block: a
// copy cell has stride principal_width, a witness cell base Ct + index and
// stride witness_width, a constant base const_off + index and stride 0.
//
// Operands, each a block of rows of stride n: cols (the witness oracle's
// first rows: the Ct copy columns, the lookup tuples among them, then the
// witness columns), multiplicities, sigma (Ct), constants, table columns
// (width + 1), stage 2 [z | partials], [A_i pairs | B pair], the shifted z,
// x, L0 and 1/Z_H (null: no multiply). Parts: 1 gates, 2 copy permutation,
// 4 lookups; a part's alpha powers follow the enabled parts before it.
#include "goldilocks.cuh"

namespace {

constexpr int kMaxSlots = 32;
constexpr int kThreads = 128;
constexpr int kGates = 1, kCopyPermutation = 2, kLookups = 4;

using gl::Ext;

struct Operands {
  const uint64_t *cols, *mult, *sigma, *consts, *tables, *s2, *lk, *zs, *xs, *l0,
      *zhinv;
};

// product over the path bits of c_b or 1 - c_b
__device__ __forceinline__ uint64_t selector(const int* prog, int len,
                                             const uint64_t* consts, size_t n,
                                             size_t row) {
  uint64_t sel = 1;
  for (int b = 0; b < len; ++b) {
    const uint64_t cb = consts[size_t(b) * n + row];
    sel = gl::mul(sel, prog[b] ? cb : gl::sub(1, cb));
  }
  return sel;
}

__global__ void sweep(Operands o, const uint64_t* __restrict__ table,
                      const int* __restrict__ prog,
                      const uint64_t* __restrict__ kvals, int Ct,
                      int chunk_deg, int num_alpha, int parts, size_t n,
                      uint64_t* __restrict__ out0,
                      uint64_t* __restrict__ out1) {
  const size_t row = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const Ext beta{table[0], table[1]};
  const Ext gamma{table[2], table[3]};
  const uint64_t* ks = table + 4;
  const uint64_t* a0 = ks + Ct;
  const uint64_t* a1 = a0 + num_alpha;
  Ext acc{0, 0};
  int t = 0;  // alpha power index

  // ---- lookup header ----
  int pc = 0;
  const int R = prog[pc++];
  const int width = prog[pc++];
  const int col_base = prog[pc++];
  const int tid_const = prog[pc++];
  const int sel_len = prog[pc++];
  const int* sel_path = prog + pc;
  pc += sel_len;

  // ---- gate terms ----
  const int num_gates = prog[pc++];
  uint64_t slot[kMaxSlots];
  for (int g = 0; g < ((parts & kGates) ? num_gates : 0); ++g) {
    const int path_len = prog[pc++];
    const uint64_t sel = selector(prog + pc, path_len, o.consts, n, row);
    pc += path_len;
    const int reps = prog[pc++];
    pc++;  // num_slots, checked on the host
    const int body = pc;
    Ext gate_acc{0, 0};
    for (int inst = 0; inst < reps; ++inst) {
      pc = body;
      const int num_loads = prog[pc++];
      for (int i = 0; i < num_loads; ++i, pc += 4) {
        const uint64_t* block = prog[pc + 1] ? o.consts : o.cols;
        const int col = prog[pc + 2] + inst * prog[pc + 3];
        slot[prog[pc]] = block[size_t(col) * n + row];
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
  if (parts & kCopyPermutation) {
    const Ext z{o.s2[row], o.s2[n + row]};
    const uint64_t x = o.xs[row];
    const Ext zm1{gl::sub(z.c0, 1), z.c1};
    acc = gl::ext_add(acc, gl::ext_mul(gl::ext_mul_base(zm1, o.l0[row]),
                                       Ext{a0[t], a1[t]}));
    ++t;
    const int num_chunks = (Ct + chunk_deg - 1) / chunk_deg;
    Ext prev = z;  // rhs of chunk j: z, then partial j-1
    for (int j = 0; j < num_chunks; ++j) {
      Ext num_p{1, 0}, den_p{1, 0};
      const int end = min(Ct, (j + 1) * chunk_deg);
      for (int col = j * chunk_deg; col < end; ++col) {
        const uint64_t w = o.cols[size_t(col) * n + row];
        const uint64_t kx = gl::mul(x, ks[col]);
        const Ext num{gl::add(gl::add(w, gl::mul(kx, beta.c0)), gamma.c0),
                      gl::add(gl::mul(kx, beta.c1), gamma.c1)};
        const uint64_t s = o.sigma[size_t(col) * n + row];
        const Ext den{gl::add(gl::add(w, gl::mul(s, beta.c0)), gamma.c0),
                      gl::add(gl::mul(s, beta.c1), gamma.c1)};
        num_p = col == j * chunk_deg ? num : gl::ext_mul(num_p, num);
        den_p = col == j * chunk_deg ? den : gl::ext_mul(den_p, den);
      }
      const Ext lhs = j + 1 < num_chunks
                          ? Ext{o.s2[size_t(2 + 2 * j) * n + row],
                                o.s2[size_t(3 + 2 * j) * n + row]}
                          : Ext{o.zs[row], o.zs[n + row]};
      const Ext term = gl::ext_sub(gl::ext_mul(lhs, den_p),
                                   gl::ext_mul(prev, num_p));
      acc = gl::ext_add(acc, gl::ext_mul(term, Ext{a0[t], a1[t]}));
      ++t;
      prev = lhs;
    }
  }

  // ---- lookup terms ----
  if ((parts & kLookups) && R > 0) {
    const uint64_t* lk = a1 + num_alpha;  // beta', then gamma'^j pairs
    const uint64_t* gp = lk + 2;
    const Ext lbeta{lk[0], lk[1]};
    const uint64_t sel = selector(sel_path, sel_len, o.consts, n, row);
    const uint64_t tid = o.consts[size_t(tid_const) * n + row];
    const Ext base =
        gl::ext_add(lbeta, gl::ext_mul_base(Ext{gp[2 * width], gp[2 * width + 1]}, tid));
    for (int i = 0; i < R; ++i, ++t) {
      Ext den = base;
      for (int j = 0; j < width; ++j) {
        const uint64_t v = o.cols[size_t(col_base + i * width + j) * n + row];
        den = gl::ext_add(den, gl::ext_mul_base(Ext{gp[2 * j], gp[2 * j + 1]}, v));
      }
      const Ext a{o.lk[size_t(2 * i) * n + row], o.lk[size_t(2 * i + 1) * n + row]};
      Ext term = gl::ext_mul(a, den);
      term.c0 = gl::sub(term.c0, sel);
      acc = gl::ext_add(acc, gl::ext_mul(term, Ext{a0[t], a1[t]}));
    }
    Ext den = lbeta;
    for (int j = 0; j <= width; ++j) {
      const uint64_t v = o.tables[size_t(j) * n + row];
      den = gl::ext_add(den, gl::ext_mul_base(Ext{gp[2 * j], gp[2 * j + 1]}, v));
    }
    const Ext b{o.lk[size_t(2 * R) * n + row], o.lk[size_t(2 * R + 1) * n + row]};
    Ext term = gl::ext_mul(b, den);
    term.c0 = gl::sub(term.c0, o.mult[row]);
    acc = gl::ext_add(acc, gl::ext_mul(term, Ext{a0[t], a1[t]}));
  }
  if (o.zhinv != nullptr) {
    acc = gl::ext_mul_base(acc, o.zhinv[row]);
  }
  out0[row] = acc.c0;
  out1[row] = acc.c1;
}

}  // namespace

extern "C" cudaError_t bt_quotient_sweep(
    const uint64_t* cols, const uint64_t* mult, const uint64_t* sigma,
    const uint64_t* consts, const uint64_t* tables, const uint64_t* s2,
    const uint64_t* lk, const uint64_t* zs, const uint64_t* xs,
    const uint64_t* l0, const uint64_t* zhinv, const uint64_t* table,
    const int* prog, const uint64_t* kvals, int Ct, int chunk_deg,
    int num_alpha, int parts, long long n, uint64_t* out0, uint64_t* out1,
    cudaStream_t stream) {
  const Operands o{cols, mult, sigma, consts, tables, s2, lk, zs, xs, l0, zhinv};
  const unsigned blocks = unsigned((size_t(n) + kThreads - 1) / kThreads);
  sweep<<<blocks, kThreads, 0, stream>>>(o, table, prog, kvals, Ct, chunk_deg,
                                         num_alpha, parts, size_t(n), out0, out1);
  return cudaGetLastError();
}
