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
// (lo, hi) u32 planes; here a thread evaluates R coset rows (or a share of
// one) with 64-bit words, replaying each gate's captured op program from a table, so a new
// gate or a new challenge needs no rebuild.
//
// What bounds it on the H100: integer operations. A row reads 8 bytes from
// each of the 55 coset columns and tables (16 witness, 22 setup, 12 stage-2,
// 2 shifted z, x, L0, 1/Z_H) and writes 16, about 460 bytes, and at the
// fma-chain widths does some 350 field products, most of them the copy
// permutation's GF(p^2) chunk products: several times the card's ratio of
// integer issue rate to memory rate (chip_smoke.py counts the plain
// version's operations and prices them). What the design does about it:
// - the arithmetic is lazy within goldilocks.cuh's contracts: every value
//   between operations is a word below 2^64 congruent to the result, each
//   product's 128 bits summed unreduced where it joins a sum (each gate's
//   Σ term·α^t, the lookup aggregates Σ γ'^j·v_j, the linear parts of num
//   and den, every α-weighted term, the GF(p^2) products' coefficients) and
//   the sum reduced once; only the outputs are made canonical;
// - the scalar table carries entries that save products: β·k_i per copy
//   column (num = w + γ + (β·k_i)·x) and 7·α^t.c1, so an α-weighted GF(p^2)
//   term is four products with no multiply by the non-residue;
// - the block copies the constants and the scalar table into shared memory
//   once, and the program too where it is at most kSmemProgBytes; a longer
//   program (a 130-column hash gate's, 41-225 KB) is read from global
//   memory through the read-only cache, every thread of a warp reading the
//   same word. A thread takes R rows, so one decoded op of a gate program
//   does R independent field operations, on slots kept in shared memory,
//   slot-major (a warp's accesses are consecutive words, free of bank
//   conflicts; slots in local memory measured no faster and cost LDL/STL
//   traffic);
// - each term is folded into its gate's sum by an instruction of its own
//   as soon as its value exists, so finished terms hold no slots (a
//   Poseidon2 row's 118 terms would otherwise hold 118);
// - what sets its pace is how many warps hide the latency of the products'
//   dependent chains: the launch caps registers at 80 (24 warps an SM) with
//   2 rows a thread where there are gates, at 64 without (looser caps spill
//   less but measured slower); where the rows are
//   too few to fill the card (2^16), 2 sub-threads share a row, each taking
//   every other gate instance, chunk and lookup term.
// The lookup terms share the row's stage-2 reads and the one 1/Z_H multiply,
// so they run in the same launch: per sub-argument i,
// A_i·(Σ_j γ'^j·w_{i,j} + γ'^w·tid + β') - sel, then for the table
// B·(Σ_j γ'^j·t_j + γ'^w·t_id + β') - M. sel is 1 in specialized mode (empty
// path) and the lookup-marker gate's selector over the constant columns in
// general mode, the same product the gate part forms for a gate's selector.
//
// Program table (int32): first the lookup header
//   R, width, first tuple column, table-id constant column, sel path_len,
//   sel path bits...
// (R = 0: no lookup terms), then the gate count and, per gate with quotient
// terms, in gate order:
//   path_len, path bits..., reps, num_slots,
//   num_instructions, (opcode, dst, a, b)...,
//   num_terms
// with opcodes 0=add 1=sub 2=mul 3=neg 4=double over slots a and b, 5 and 6
// a load of column a + instance·b of cols or of the constants, 7 the
// constant kvals[a] (each distinct constant once), 8 term dst of the
// instance, slot a times its alpha power added to the gate's sum. Slots
// are reused by liveness (quotient_sweep.py schedule_program): a load or a
// constant comes just before its first use, a term is folded just after
// its value is made and a result may take a dead operand's slot, so a
// gate's slots are the most values it holds at once (14 for a 12×12
// matrix gate, 16 and 24 for the flattened Poseidon2 and Poseidon gates),
// not its SSA values (480; 2,036 and 9,230).
// Scalar table (uint64): beta (2), gamma (2), the non-residues (Ct), then
// the alpha powers as c0 (T) and c1 (T); with lookups then beta' (2) and the
// powers gamma'^0..gamma'^width as (c0, c1) pairs; then the kernel's own
// entries, which no plain version reads: (beta.c0·k_i, beta.c1·k_i) per copy
// column and 7·alpha^t.c1 (T).
//
// A load of instance inst reads column base + inst·stride: a copy cell has
// stride principal_width, a witness cell base Ct + index and stride
// witness_width, a constant base const_off + index and stride 0.
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
// a longer program is read from global memory (quotient_sweep.py
// SMEM_PROG_BYTES)
constexpr int kSmemProgBytes = 32 * 1024;
constexpr int kGates = 1, kCopyPermutation = 2, kLookups = 4;
// instructions past the five ops: loads from cols or constants, a constant,
// a term folded into the gate's sum
constexpr int kLoadCols = 5, kLoadConsts = 6, kConst = 7, kTerm = 8;

using gl::Ext;

struct Operands {
  const uint64_t *cols, *mult, *sigma, *consts, *tables, *s2, *lk, *zs, *xs, *l0,
      *zhinv;
};

// The launch's counts.
struct Counts {
  int table_len, prog_len, num_kvals, Ct, chunk_deg, num_alpha, parts, num_slots;
  size_t n;
};

// A GF(p^2) sum of products, each coefficient an accumulator of 128-bit
// products (gl::Acc) reduced once.
struct ExtA {
  gl::Acc c0, c1;
};

__device__ __forceinline__ ExtA ext_word(uint64_t c0, uint64_t c1) {
  return {{c0, 0, 0}, {c1, 0, 0}};
}

__device__ __forceinline__ Ext reduce(ExtA a) {
  return {gl::reduce_acc_lazy(a.c0), gl::reduce_acc_lazy(a.c1)};
}

__device__ __forceinline__ void add_into(ExtA& acc, const ExtA& x) {
  acc.c0 = gl::acc_sum(acc.c0, x.c0);
  acc.c1 = gl::acc_sum(acc.c1, x.c1);
}

// acc += v·(g0 + g1 w) for a base-field v: two products.
__device__ __forceinline__ void mac_base(ExtA& acc, uint64_t v, uint64_t g0, uint64_t g1) {
  acc.c0 = gl::acc_mac(acc.c0, v, g0);
  acc.c1 = gl::acc_mac(acc.c1, v, g1);
}

// acc += x·(a0 + a1 w) with a1x7 = 7·a1: x0 a0 + 7 x1 a1 and x0 a1 + x1 a0,
// four products.
__device__ __forceinline__ void mac_ext(ExtA& acc, Ext x, uint64_t a0, uint64_t a1,
                                        uint64_t a1x7) {
  acc.c0 = gl::acc_mac(gl::acc_mac(acc.c0, x.c0, a0), x.c1, a1x7);
  acc.c1 = gl::acc_mac(gl::acc_mac(acc.c1, x.c0, a1), x.c1, a0);
}

// product over the path bits of c_b or 1 - c_b (constants are canonical),
// lazy
__device__ __forceinline__ uint64_t selector(const int* path, int len,
                                             const uint64_t* consts, size_t n,
                                             size_t row) {
  uint64_t sel = 1;
  for (int b = 0; b < len; ++b) {
    const uint64_t cb = consts[size_t(b) * n + row];
    sel = gl::mul_lazy(sel, path[b] ? cb : gl::sub(1, cb));
  }
  return sel;
}

// One launch: a block of T threads takes R·T/S rows; S sub-threads share a
// row (sub-thread sub = t / (T/S), so a warp is one sub-thread of 32 or more
// rows), each taking every S-th gate instance, copy-permutation chunk and
// lookup term, and sub-thread 0 sums their partial terms. A thread's gate
// slots (slot s of its row k at (s R + k) T + t) live in shared memory. B
// blocks an SM bound the registers a thread may take. P: the program is
// copied into shared memory (else read from global memory).
template <int R, int T, int S, int B, bool P>
__global__ void __launch_bounds__(T, B)
sweep(const Operands o, const uint64_t* __restrict__ table_g, const int* __restrict__ prog_g,
      const uint64_t* __restrict__ kvals_g, const Counts c, uint64_t* __restrict__ out0,
      uint64_t* __restrict__ out1) {
  constexpr int L = T / S;  // rows of a sub-thread's group in one pass
  extern __shared__ uint64_t sm[];
  const uint32_t t = threadIdx.x;
  const int sub = t / L;
  const uint32_t lane = t % L;
  uint64_t* table = sm;
  uint64_t* kvals = table + c.table_len;
  uint64_t* slot = kvals + c.num_kvals + t;  // this thread's slots
  uint64_t* part = kvals + c.num_kvals + c.num_slots * R * T;  // S > 1: 2 R T words
  int* prog_s = reinterpret_cast<int*>(part + (S > 1 ? 2 * R * T : 0));
  for (int i = t; i < c.table_len; i += T) table[i] = table_g[i];
  for (int i = t; i < c.num_kvals; i += T) kvals[i] = kvals_g[i];
  if constexpr (P)
    for (int i = t; i < c.prog_len; i += T) prog_s[i] = prog_g[i];
  __syncthreads();
  const int* prog = P ? prog_s : prog_g;

  const size_t n = c.n;
  // the thread's rows first + k L; past the end a thread repeats the last
  // row and stores nothing
  const size_t first = size_t(blockIdx.x) * (R * L) + lane;
  const auto row_of = [&](int k) {
    const size_t r = first + size_t(k) * L;
    return r < n ? r : n - 1;
  };
  size_t row[R];
#pragma unroll
  for (int k = 0; k < R; ++k) row[k] = row_of(k);

  const int Ct = c.Ct;
  const int num_alpha = c.num_alpha;
  const uint64_t* a0 = table + 4 + Ct;  // after beta, gamma, the non-residues
  const uint64_t* a1 = a0 + num_alpha;
  const uint64_t* lk = a1 + num_alpha;  // beta', then the gamma'^j pairs

  // ---- lookup header ----
  int pc = 0;
  const int R_lk = prog[pc++];
  const int width = prog[pc++];
  const int col_base = prog[pc++];
  const int tid_const = prog[pc++];
  const int sel_len = prog[pc++];
  const int* sel_path = prog + pc;
  pc += sel_len;
  const bool lookups = (c.parts & kLookups) && R_lk > 0;
  const uint64_t* bk = lk + (lookups ? 2 + 2 * (width + 1) : 0);  // kernel entries
  const uint64_t* a1x7 = bk + 2 * Ct;

  ExtA acc[R];
#pragma unroll
  for (int k = 0; k < R; ++k) acc[k] = ExtA{};
  int ta = 0;  // alpha power index

  // ---- gate terms: one decoded op, R rows ----
  const int num_gates = (c.parts & kGates) ? prog[pc] : 0;
  ++pc;
  int inst_no = 0;  // instances so far, over all gates: sub-thread inst_no % S
  for (int g = 0; g < num_gates; ++g) {
    const int path_len = prog[pc++];
    const int* path = prog + pc;
    pc += path_len;
    const int reps = prog[pc++];
    pc++;  // num_slots, checked on the host
    // the body every instance replays: its instructions, then its term count
    const int ins = pc + 1, num_ins = prog[pc];
    const int num_terms = prog[ins + 4 * num_ins];
    pc = ins + 4 * num_ins + 1;
    ExtA gacc[R];
#pragma unroll
    for (int k = 0; k < R; ++k) gacc[k] = ExtA{};
    for (int inst = 0; inst < reps; ++inst, ta += num_terms) {
      if (S > 1 && inst_no++ % S != sub) continue;
      for (int i = 0; i < num_ins; ++i) {
        const int* od = prog + ins + 4 * i;
        int op, dst, sa, sb;
        if constexpr (P) {
          op = od[0], dst = od[1], sa = od[2], sb = od[3];
        } else {
          op = __ldg(od), dst = __ldg(od + 1), sa = __ldg(od + 2), sb = __ldg(od + 3);
        }
        if (op == kTerm) {  // term dst of this instance, from slot sa
          const uint64_t w0 = a0[ta + dst], w1 = a1[ta + dst];
#pragma unroll
          for (int k = 0; k < R; ++k) mac_base(gacc[k], slot[(sa * R + k) * T], w0, w1);
          continue;
        }
        if (op >= kLoadCols) {  // a load or a constant, at its first use
          if (op == kConst) {
            const uint64_t v = kvals[sa];
#pragma unroll
            for (int k = 0; k < R; ++k) slot[(dst * R + k) * T] = v;
          } else {
            const uint64_t* src =
                (op == kLoadConsts ? o.consts : o.cols) + size_t(sa + inst * sb) * n;
#pragma unroll
            for (int k = 0; k < R; ++k) slot[(dst * R + k) * T] = src[row[k]];
          }
          continue;
        }
        uint64_t x[R], y[R];
#pragma unroll
        for (int k = 0; k < R; ++k) {
          x[k] = slot[(sa * R + k) * T];
          y[k] = slot[(sb * R + k) * T];
        }
        // every slot value is a word below 2^64 (lazy); each op takes any
        switch (op) {
          case 0:
#pragma unroll
            for (int k = 0; k < R; ++k) x[k] = gl::add_lazy(x[k], y[k]);
            break;
          case 1:
#pragma unroll
            for (int k = 0; k < R; ++k) x[k] = gl::sub_lazy(x[k], y[k]);
            break;
          case 2:
#pragma unroll
            for (int k = 0; k < R; ++k) x[k] = gl::mul_lazy(x[k], y[k]);
            break;
          case 3:
#pragma unroll
            for (int k = 0; k < R; ++k) x[k] = gl::sub_lazy(0, x[k]);
            break;
          default:
#pragma unroll
            for (int k = 0; k < R; ++k) x[k] = gl::add_lazy(x[k], x[k]);
            break;
        }
#pragma unroll
        for (int k = 0; k < R; ++k) slot[(dst * R + k) * T] = x[k];
      }
    }
#pragma unroll
    for (int k = 0; k < R; ++k) {
      if (path_len) {
        const uint64_t sel = selector(path, path_len, o.consts, n, row[k]);
        const Ext ga = reduce(gacc[k]);
        mac_base(acc[k], sel, ga.c0, ga.c1);
      } else {
        add_into(acc[k], gacc[k]);
      }
    }
  }

  // ---- copy-permutation and lookup terms: one row at a time, into cacc ----
  const auto add_to = [&](int k, const ExtA& x) {
#pragma unroll
    for (int kk = 0; kk < R; ++kk)
      if (kk == k) add_into(acc[kk], x);
  };
  const int ta_cp = ta;
  const int num_chunks = (Ct + c.chunk_deg - 1) / c.chunk_deg;
  if (c.parts & kCopyPermutation) {
    const uint64_t b0 = table[0], b1 = table[1], g0 = table[2], g1 = table[3];
#pragma unroll 1
    for (int k = 0; k < R; ++k) {
      const size_t r = row_of(k);
      ExtA cacc = ExtA{};
      const Ext z{o.s2[r], o.s2[n + r]};
      const uint64_t x = o.xs[r];
      if (sub == 0) {
        const uint64_t l0 = o.l0[r];
        const Ext l0z{gl::mul_lazy(gl::sub(z.c0, 1), l0), gl::mul_lazy(z.c1, l0)};
        mac_ext(cacc, l0z, a0[ta_cp], a1[ta_cp], a1x7[ta_cp]);
      }
      Ext prev = z;  // rhs of chunk j: z, then partial j-1
      for (int j = sub; j < num_chunks; j += S) {
        if (S > 1 && j > 0)
          prev = Ext{o.s2[size_t(2 * j) * n + r], o.s2[size_t(2 * j + 1) * n + r]};
        Ext num_p{0, 0}, den_p{0, 0};
        const int start = j * c.chunk_deg;
        const int end = min(Ct, start + c.chunk_deg);
        for (int col = start; col < end; ++col) {
          const uint64_t w = o.cols[size_t(col) * n + r];
          const uint64_t s = o.sigma[size_t(col) * n + r];
          // num = w + gamma + (beta k)·x, den = w + gamma + beta·sigma:
          // each coefficient a product and at most two words, reduced once
          const gl::Acc wg = gl::acc_add({w, 0, 0}, g0, 0);
          const Ext num{gl::reduce_acc_lazy(gl::acc_sum(gl::prod(bk[2 * col], x), wg)),
                        gl::reduce_acc_lazy(gl::acc_add(gl::prod(bk[2 * col + 1], x), g1, 0))};
          const Ext den{gl::reduce_acc_lazy(gl::acc_sum(gl::prod(b0, s), wg)),
                        gl::reduce_acc_lazy(gl::acc_add(gl::prod(b1, s), g1, 0))};
          num_p = col == start ? num : gl::ext_mul_lazy(num_p, num);
          den_p = col == start ? den : gl::ext_mul_lazy(den_p, den);
        }
        const Ext lhs = j + 1 < num_chunks
                            ? Ext{o.s2[size_t(2 + 2 * j) * n + r],
                                  o.s2[size_t(3 + 2 * j) * n + r]}
                            : Ext{o.zs[r], o.zs[n + r]};
        const Ext u = gl::ext_mul_lazy(lhs, den_p), v = gl::ext_mul_lazy(prev, num_p);
        const int tj = ta_cp + 1 + j;
        mac_ext(cacc, Ext{gl::sub_lazy(u.c0, v.c0), gl::sub_lazy(u.c1, v.c1)}, a0[tj],
                a1[tj], a1x7[tj]);
        prev = lhs;
      }
      add_to(k, cacc);
    }
    ta += 1 + num_chunks;
  }

  // ---- lookup terms: sub-arguments i, then the table (i = R_lk) ----
  if (lookups) {
    const uint64_t* gp = lk + 2;
#pragma unroll 1
    for (int k = 0; k < R; ++k) {
      const size_t r = row_of(k);
      ExtA cacc = ExtA{};
      const uint64_t sel = selector(sel_path, sel_len, o.consts, n, r);
      const uint64_t tid = o.consts[size_t(tid_const) * n + r];
      ExtA base = ext_word(lk[0], lk[1]);  // beta' + gamma'^w·tid
      mac_base(base, tid, gp[2 * width], gp[2 * width + 1]);
      for (int i = sub; i < R_lk; i += S) {
        ExtA den = base;
        for (int j = 0; j < width; ++j)
          mac_base(den, o.cols[size_t(col_base + i * width + j) * n + r], gp[2 * j],
                   gp[2 * j + 1]);
        const Ext a{o.lk[size_t(2 * i) * n + r], o.lk[size_t(2 * i + 1) * n + r]};
        Ext term = gl::ext_mul_lazy(a, reduce(den));
        term.c0 = gl::sub_lazy(term.c0, sel);
        mac_ext(cacc, term, a0[ta + i], a1[ta + i], a1x7[ta + i]);
      }
      if (R_lk % S == sub) {
        ExtA den = ext_word(lk[0], lk[1]);
        for (int j = 0; j <= width; ++j)
          mac_base(den, o.tables[size_t(j) * n + r], gp[2 * j], gp[2 * j + 1]);
        const Ext b{o.lk[size_t(2 * R_lk) * n + r], o.lk[size_t(2 * R_lk + 1) * n + r]};
        Ext term = gl::ext_mul_lazy(b, reduce(den));
        term.c0 = gl::sub_lazy(term.c0, o.mult[r]);
        const int tb = ta + R_lk;
        mac_ext(cacc, term, a0[tb], a1[tb], a1x7[tb]);
      }
      add_to(k, cacc);
    }
  }

  // ---- sub-thread 0 sums the partial terms, times 1/Z_H ----
  Ext v[R];
#pragma unroll
  for (int k = 0; k < R; ++k) v[k] = reduce(acc[k]);
  if constexpr (S > 1) {
#pragma unroll
    for (int k = 0; k < R; ++k) {
      part[(2 * k) * T + t] = v[k].c0;
      part[(2 * k + 1) * T + t] = v[k].c1;
    }
    __syncthreads();
    if (sub) return;
#pragma unroll
    for (int k = 0; k < R; ++k)
#pragma unroll
      for (int q = 1; q < S; ++q) {
        v[k].c0 = gl::add_lazy(v[k].c0, part[(2 * k) * T + q * L + lane]);
        v[k].c1 = gl::add_lazy(v[k].c1, part[(2 * k + 1) * T + q * L + lane]);
      }
  }
#pragma unroll
  for (int k = 0; k < R; ++k) {
    if (first + size_t(k) * L >= n) continue;
    const size_t r = row[k];
    if (o.zhinv != nullptr) {
      const uint64_t zh = o.zhinv[r];
      v[k] = {gl::mul_lazy(v[k].c0, zh), gl::mul_lazy(v[k].c1, zh)};
    }
    out0[r] = gl::canonical(v[k].c0);
    out1[r] = gl::canonical(v[k].c1);
  }
}

template <int R, int T, int S, int B, bool P>
cudaError_t launch_p(const Operands& o, const uint64_t* table, const int* prog,
                     const uint64_t* kvals, const Counts& c, uint64_t* out0, uint64_t* out1,
                     cudaStream_t stream) {
  const size_t smem = size_t(c.table_len + c.num_kvals) * 8 + size_t(c.num_slots) * R * T * 8 +
                      (S > 1 ? size_t(2) * R * T * 8 : 0) + (P ? size_t(c.prog_len) * 4 : 0);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sweep<R, T, S, B, P>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return e;
  }
  const unsigned blocks = unsigned((c.n + R * T / S - 1) / (R * T / S));
  sweep<R, T, S, B, P><<<blocks, T, smem, stream>>>(o, table, prog, kvals, c, out0, out1);
  return cudaGetLastError();
}

template <int R, int T, int S, int B>
cudaError_t launch(const Operands& o, const uint64_t* table, const int* prog,
                   const uint64_t* kvals, const Counts& c, uint64_t* out0, uint64_t* out1,
                   cudaStream_t stream) {
  if (size_t(c.prog_len) * 4 <= size_t(kSmemProgBytes))
    return launch_p<R, T, S, B, true>(o, table, prog, kvals, c, out0, out1, stream);
  return launch_p<R, T, S, B, false>(o, table, prog, kvals, c, out0, out1, stream);
}

}  // namespace

// The terms of one launch into out0, out1 (n words each). rows_per_thread
// R, threads T and sub-threads a row S pick one of the launch geometries
// below, each with the blocks an SM B its registers must allow.
extern "C" cudaError_t bt_quotient_sweep(
    const uint64_t* cols, const uint64_t* mult, const uint64_t* sigma,
    const uint64_t* consts, const uint64_t* tables, const uint64_t* s2,
    const uint64_t* lk, const uint64_t* zs, const uint64_t* xs,
    const uint64_t* l0, const uint64_t* zhinv, const uint64_t* table, int table_len,
    const int* prog, int prog_len, const uint64_t* kvals, int num_kvals, int Ct,
    int chunk_deg, int num_alpha, int parts, int num_slots, long long n,
    int rows_per_thread, int threads, int split, uint64_t* out0, uint64_t* out1,
    cudaStream_t stream) {
  if (n < 1 || num_slots < 0 || num_slots > kMaxSlots || chunk_deg < 1)
    return cudaErrorInvalidValue;
  const Operands o{cols, mult, sigma, consts, tables, s2, lk, zs, xs, l0, zhinv};
  const Counts c{table_len, prog_len, num_kvals, Ct, chunk_deg, num_alpha, parts,
                 num_slots, size_t(n)};
#define BT_SWEEP(R, T, S, B)                                              \
  if (rows_per_thread == R && threads == T && split == S)                 \
    return launch<R, T, S, B>(o, table, prog, kvals, c, out0, out1, stream);
  // quotient_sweep.py's launch_geometry picks one: with gates at 2^20 rows
  // (80 registers), without (64), and below 2^18 rows, rows split (64)
  BT_SWEEP(2, 256, 1, 3) BT_SWEEP(1, 128, 1, 8) BT_SWEEP(1, 256, 2, 4)
#undef BT_SWEEP
  return cudaErrorInvalidValue;
}
