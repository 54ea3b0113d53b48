// Native witness-resolution engine: a typed-op tape over a value arena.
//
// The port's copy of the JAX package's native/resolver.cpp (era-boojum's
// compiled resolver runtime, src/dag/resolvers/mt/). Synthesis records one
// tape entry for each high-volume resolution that has a typed descriptor
// (FMA, reductions, chunk splits, u32 carry ops, lookups, whole Poseidon2
// permutations); Python runs the tape through `execute_stream` in batches.
// Python closures stay the general path for anything untyped. The ops are
// the JAX package's; the tape is one stream of words instead of its seven
// arrays, and the engine marks each output resolved in the caller's state
// bytes.
//
// Field: Goldilocks p = 2^64 - 2^32 + 1. Every value is canonical (< p).
// The arena interleaves places: variable k at 2k, witness k at 2k + 1.
//
// Built by boojum_tpu_torch/native/__init__.py with
// g++ -O2 -shared -fPIC into boojum_tpu_torch/_build/.

#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

using u64 = uint64_t;
using u32 = uint32_t;
using i64 = int64_t;
using u128 = unsigned __int128;

static const u64 P = 0xFFFFFFFF00000001ull;
static const u64 EPS = 0xFFFFFFFFull; // 2^64 mod p

static inline u64 mod_add(u64 a, u64 b) {
  u64 s = a + b;
  // a,b < p so s wraps at most once; wrapped value is s - 2^64 = s + EPS - p...
  // canonical fixup: if overflow or s >= p, subtract p.
  if (s < a) s += EPS; // s = a + b - 2^64 ; + EPS == a + b - p
  if (s >= P) s -= P;
  return s;
}

static inline u64 mod_sub(u64 a, u64 b) {
  return (a >= b) ? (a - b) : (a + (P - b));
}

static inline u64 mod_mul(u64 a, u64 b) {
  u128 w = (u128)a * (u128)b;
  u64 lo = (u64)w;
  u64 hi = (u64)(w >> 64);
  u64 hi_hi = hi >> 32;
  u64 hi_lo = hi & 0xFFFFFFFFull;
  u64 t0 = lo - hi_hi;
  if (lo < hi_hi) t0 -= EPS; // borrow
  u64 t1 = hi_lo * EPS;
  u64 t2 = t0 + t1;
  if (t2 < t0) t2 += EPS;
  if (t2 >= P) t2 -= P;
  return t2;
}

// ---------------------------------------------------------------------------
// Lookup tables
// ---------------------------------------------------------------------------

struct Table {
  int width = 0;
  int num_keys = 0;
  i64 rows = 0;
  std::vector<u64> content;              // rows * width
  std::unordered_map<u64, i64> index;    // hashed key -> row
  std::vector<u32> multiplicities;       // per row
};

static std::vector<Table> g_tables; // id - 1 indexes

static inline u64 key_hash(const u64 *key, int num_keys) {
  // FNV-1a style over the key words; collisions resolved by verify below
  u64 h = 1469598103934665603ull;
  for (int i = 0; i < num_keys; i++) {
    h ^= key[i];
    h *= 1099511628211ull;
  }
  return h;
}

extern "C" int register_table(i64 table_id, const u64 *content, i64 rows,
                              int width, int num_keys) {
  if (table_id < 1) return -1;
  if (num_keys < 0 || num_keys > 8 || width < num_keys || width > 16)
    return -2; // key buffer in the op interpreter is u64[8]
  if ((i64)g_tables.size() < table_id) g_tables.resize(table_id);
  Table &t = g_tables[table_id - 1];
  t.width = width;
  t.num_keys = num_keys;
  t.rows = rows;
  t.content.assign(content, content + rows * width);
  t.index.clear();
  t.index.reserve(rows * 2);
  t.multiplicities.assign(rows, 0);
  for (i64 r = 0; r < rows; r++) {
    u64 h = key_hash(content + r * width, num_keys);
    // assume distinct keys (asserted python-side at table construction)
    t.index.emplace(h, r);
  }
  return 0;
}

static inline i64 table_find(const Table &t, const u64 *key) {
  u64 h = key_hash(key, t.num_keys);
  auto it = t.index.find(h);
  if (it == t.index.end()) return -1;
  i64 r = it->second;
  for (int j = 0; j < t.num_keys; j++)
    if (t.content[r * t.width + j] != key[j]) return -1;
  return r;
}

extern "C" const u32 *table_multiplicities(i64 table_id, i64 *rows_out) {
  Table &t = g_tables[table_id - 1];
  *rows_out = t.rows;
  return t.multiplicities.data();
}

// Free a table's content, index and counters; its slot is never reused.
extern "C" void release_table(i64 table_id) {
  if (table_id < 1 || table_id > (i64)g_tables.size()) return;
  g_tables[table_id - 1] = Table();
}

// ---------------------------------------------------------------------------
// Poseidon2 (width 12, x^7) — constants registered from Python
// ---------------------------------------------------------------------------

static u64 g_rc[30][12];
static u64 g_diag[12];
static bool g_p2_ready = false;

extern "C" void register_poseidon2(const u64 *rc /*30*12*/, const u64 *diag) {
  std::memcpy(g_rc, rc, sizeof(g_rc));
  std::memcpy(g_diag, diag, sizeof(g_diag));
  g_p2_ready = true;
}

static inline u64 pow7(u64 x) {
  u64 x2 = mod_mul(x, x);
  u64 x3 = mod_mul(x2, x);
  return mod_mul(mod_mul(x2, x2), x3);
}

static void ext_mds(u64 *s) {
  // circ(2*M4, M4, M4) via the add/double chain
  u64 blocks[3][4];
  for (int b = 0; b < 3; b++) {
    u64 x0 = s[4 * b], x1 = s[4 * b + 1], x2 = s[4 * b + 2], x3 = s[4 * b + 3];
    u64 t0 = mod_add(x0, x1);
    u64 t1 = mod_add(x2, x3);
    u64 t2 = mod_add(mod_add(x1, x1), t1);
    u64 t3 = mod_add(mod_add(x3, x3), t0);
    u64 t4 = mod_add(mod_add(mod_add(t1, t1), mod_add(t1, t1)), t3);
    u64 t5 = mod_add(mod_add(mod_add(t0, t0), mod_add(t0, t0)), t2);
    blocks[b][0] = mod_add(t3, t5);
    blocks[b][1] = t5;
    blocks[b][2] = mod_add(t2, t4);
    blocks[b][3] = t4;
  }
  u64 sums[4];
  for (int i = 0; i < 4; i++)
    sums[i] = mod_add(mod_add(blocks[0][i], blocks[1][i]), blocks[2][i]);
  for (int b = 0; b < 3; b++)
    for (int i = 0; i < 4; i++) s[4 * b + i] = mod_add(blocks[b][i], sums[i]);
}

static void int_mds(u64 *s) {
  u64 total = 0;
  for (int i = 0; i < 12; i++) total = mod_add(total, s[i]);
  for (int i = 0; i < 12; i++)
    s[i] = mod_add(mod_mul(s[i], g_diag[i]), total);
}

// Full flat permutation trace: outs[0..12) final state, aux[0..106) the
// degree-reset values, in the same order as
// boojum_tpu_torch/cs/gates/poseidon2_flat.py::flat_permutation.
static void poseidon2_flat(const u64 *in, u64 *out12, u64 *aux106) {
  u64 s[12];
  std::memcpy(s, in, sizeof(s));
  int ax = 0;
  ext_mds(s);
  for (int r = 0; r < 4; r++) {
    if (r != 0)
      for (int i = 0; i < 12; i++) aux106[ax++] = s[i];
    for (int i = 0; i < 12; i++) s[i] = pow7(mod_add(s[i], g_rc[r][i]));
    ext_mds(s);
  }
  for (int p = 0; p < 22; p++) {
    u64 s0 = mod_add(s[0], g_rc[4 + p][0]);
    aux106[ax++] = s0;
    s[0] = pow7(s0);
    int_mds(s);
  }
  for (int r = 0; r < 4; r++) {
    for (int i = 0; i < 12; i++) aux106[ax++] = s[i];
    for (int i = 0; i < 12; i++) s[i] = pow7(mod_add(s[i], g_rc[26 + r][i]));
    ext_mds(s);
  }
  std::memcpy(out12, s, sizeof(s));
}

// ---------------------------------------------------------------------------
// Tape execution
// ---------------------------------------------------------------------------

enum OpKind : i64 {
  OP_CONST = 0,
  OP_FMA = 1,         // params c0, c1; ins a, b, c; out d = c0*a*b + c1*c
  OP_REDUCTION = 2,   // params coeffs[k]; ins k; out = sum c_i v_i
  OP_SPLIT = 3,       // params bits, count; in x; outs chunks LE
  OP_U32_ADD = 4,     // params shift_bits; ins a, b, cin; outs c, cout
  OP_U32_SUB = 5,     // ins a, b, bin; outs c, bout
  OP_TRIADD = 6,      // ins a, b, c; outs low, high
  OP_U32_FMA = 7,     // ins a,b,c,cin; outs alo,ahi,blo,bhi,low,high,k
  OP_BYTE_TRIADD = 8, // ins 12 bytes; outs 4 bytes + carry
  OP_POSEIDON2 = 9,   // ins 12; outs 12 + 106
  OP_LOOKUP = 10,     // params table_id; ins num_keys; outs num_values (read-only)
  OP_LOOKUP_BUMP = 11 // params table_id; ins width (full tuple); no outs; owns the multiplicity counter
};

// Runs one op over the arena. Returns 0, or 1 when it fails (lookup miss,
// oversized key, unregistered table, unknown kind).
static int run_op(u64 *values, i64 kind, const u64 *pp, const i64 *ins,
                  i64 n_in, const i64 *outs, i64 n_out) {
  switch (kind) {
    case OP_CONST:
      values[outs[0]] = pp[0];
      break;
    case OP_FMA: {
      u64 a = values[ins[0]], b = values[ins[1]], c = values[ins[2]];
      values[outs[0]] = mod_add(mod_mul(pp[0], mod_mul(a, b)),
                                mod_mul(pp[1], c));
      break;
    }
    case OP_REDUCTION: {
      u64 acc = 0;
      for (i64 j = 0; j < n_in; j++)
        acc = mod_add(acc, mod_mul(pp[j], values[ins[j]]));
      values[outs[0]] = acc;
      break;
    }
    case OP_SPLIT: {
      u64 x = values[ins[0]];
      u64 bits = pp[0];
      u64 mask = (bits >= 64) ? ~0ull : ((1ull << bits) - 1);
      for (i64 j = 0; j < n_out; j++) {
        values[outs[j]] = x & mask;
        x >>= bits;
      }
      break;
    }
    case OP_U32_ADD: {
      u64 s = values[ins[0]] + values[ins[1]] + values[ins[2]];
      u64 w = pp[0];
      values[outs[0]] = s & ((1ull << w) - 1);
      values[outs[1]] = s >> w;
      break;
    }
    case OP_U32_SUB: {
      i64 d = (i64)values[ins[0]] - (i64)values[ins[1]] - (i64)values[ins[2]];
      if (d < 0) {
        values[outs[0]] = (u64)(d + (1ll << 32));
        values[outs[1]] = 1;
      } else {
        values[outs[0]] = (u64)d;
        values[outs[1]] = 0;
      }
      break;
    }
    case OP_TRIADD: {
      u64 s = values[ins[0]] + values[ins[1]] + values[ins[2]];
      values[outs[0]] = s & 0xFFFFFFFFull;
      values[outs[1]] = s >> 32;
      break;
    }
    case OP_U32_FMA: {
      u64 a = values[ins[0]], b = values[ins[1]];
      u64 c = values[ins[2]], cin = values[ins[3]];
      u64 s = a * b + c + cin; // < 2^64, no overflow for u32 operands
      u64 alo = a & 0xFFFF, ahi = a >> 16;
      u64 blo = b & 0xFFFF, bhi = b >> 16;
      u64 part = alo * blo + c + cin + ((alo * bhi + ahi * blo) << 16);
      values[outs[0]] = alo;
      values[outs[1]] = ahi;
      values[outs[2]] = blo;
      values[outs[3]] = bhi;
      values[outs[4]] = s & 0xFFFFFFFFull;
      values[outs[5]] = s >> 32;
      values[outs[6]] = part >> 32;
      break;
    }
    case OP_BYTE_TRIADD: {
      u64 s = 0;
      for (int g = 0; g < 3; g++)
        for (int j = 0; j < 4; j++)
          s += values[ins[4 * g + j]] << (8 * j);
      for (int j = 0; j < 4; j++) values[outs[j]] = (s >> (8 * j)) & 0xFF;
      values[outs[4]] = s >> 32;
      break;
    }
    case OP_POSEIDON2: {
      if (!g_p2_ready) return 1;
      u64 in[12];
      for (int i = 0; i < 12; i++) in[i] = values[ins[i]];
      u64 out12[12], aux[106];
      poseidon2_flat(in, out12, aux);
      for (int i = 0; i < 12; i++) values[outs[i]] = out12[i];
      for (int i = 0; i < 106; i++) values[outs[12 + i]] = aux[i];
      break;
    }
    case OP_LOOKUP: {
      i64 tid = (i64)pp[0];
      if (tid < 1 || tid > (i64)g_tables.size()) return 1;
      Table &t = g_tables[tid - 1];
      if (n_in > 8) return 1;
      u64 key[8];
      for (i64 j = 0; j < n_in; j++) key[j] = values[ins[j]];
      i64 r = table_find(t, key);
      if (r < 0) return 1;
      for (i64 j = 0; j < n_out; j++)
        values[outs[j]] = t.content[r * t.width + t.num_keys + j];
      break;
    }
    case OP_LOOKUP_BUMP: {
      i64 tid = (i64)pp[0];
      if (tid < 1 || tid > (i64)g_tables.size()) return 1;
      Table &t = g_tables[tid - 1];
      if (t.num_keys > 8 || (i64)t.num_keys > n_in) return 1;
      u64 key[8];
      for (int j = 0; j < t.num_keys; j++) key[j] = values[ins[j]];
      i64 r = table_find(t, key);
      if (r < 0) return 1;
      // verify value part matches (same check as LookupTable.row_index)
      for (int j = t.num_keys; j < t.width && j < (int)n_in; j++)
        if (t.content[r * t.width + j] != values[ins[j]]) return 1;
      t.multiplicities[r] += 1;
      break;
    }
    default:
      return 1;
  }
  return 0;
}

// Runs a batch of ops, each encoded in the stream as
//   kind, n_params, params..., n_in, in places..., n_out, out places...
// (the JAX package's engine takes the same ops as seven arrays). Each
// output's state byte is set to 1 (resolved) after its value is written,
// with release ordering, so a reader that sees the byte sees the value.
// Returns 0, or -(w + 1) where word w holds the failing op's kind; the ops
// before it have run.
extern "C" i64 execute_stream(u64 *values, unsigned char *state,
                              const u64 *stream, i64 n_words) {
  i64 w = 0;
  while (w < n_words) {
    const i64 at = w;
    const i64 kind = (i64)stream[w++];
    const i64 n_params = (i64)stream[w++];
    const u64 *pp = stream + w;
    w += n_params;
    const i64 n_in = (i64)stream[w++];
    const i64 *ins = (const i64 *)(stream + w);
    w += n_in;
    const i64 n_out = (i64)stream[w++];
    const i64 *outs = (const i64 *)(stream + w);
    w += n_out;
    if (run_op(values, kind, pp, ins, n_in, outs, n_out)) return -(at + 1);
    for (i64 j = 0; j < n_out; j++)
      __atomic_store_n(state + outs[j], (unsigned char)1, __ATOMIC_RELEASE);
  }
  return 0;
}
