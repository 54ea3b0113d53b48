"""sha256 circuit gadget, as in the JAX package's gadgets/sha256.py
(era-boojum gadgets/sha256: mod.rs sha256, round_function.rs).

Words are u32 variables; all bitwise structure goes through width-4 lookups
over 4-bit-chunk tables (TriXor4, Ch4, Maj4, Split4BitChunk); a rotation is
a 9-piece decomposition, a chunk renumbering and one chunk merged through
the split table; u32 range checks ride the TriXor4 table. Variables,
gates and lookups are created in the JAX package's order, so the two
packages synthesize the same assembly.
"""

from __future__ import annotations

from ..cs.gates.simple import FmaGate, ReductionGate
from .chunk_utils import range_check_chunks_batched
from .tables import ch4_table, maj4_table, split4bit_table, trixor4_table

SHA256_ROUNDS = 64
SHA256_BLOCK_SIZE = 64
SHA256_DIGEST_SIZE = 32

INITIAL_STATE = [
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
]

ROUND_CONSTANTS = [
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
]

MASK4 = 0xF


def register_sha256_tables(cs):
    """Add the five SHA tables if not present; returns their ids."""
    ids = {}
    for name, build in (
        ("trixor4", trixor4_table),
        ("ch4", ch4_table),
        ("maj4", maj4_table),
        ("split4bit_at1", lambda: split4bit_table(1)),
        ("split4bit_at2", lambda: split4bit_table(2)),
    ):
        ids[name] = cs.ensure_table(name, build)
    return ids


class _Sha256Ctx:
    """Per-circuit handles: table ids + shared constants."""

    def __init__(self, cs):
        # sha256 words are u32 variables, one field element each: a field
        # below 2^32 (BabyBear) cannot hold them
        cs.require_field_bits(32, "sha256 gadget")
        ids = register_sha256_tables(cs)
        self.cs = cs
        self.trixor = ids["trixor4"]
        self.ch = ids["ch4"]
        self.maj = ids["maj4"]
        self.split = {1: ids["split4bit_at1"], 2: ids["split4bit_at2"]}
        self.zero = cs.zero_var()
        self.one = cs.one_var()

    # -- chunk helpers ------------------------------------------------------

    def tri_xor_many(self, a, b, c):
        """Per-chunk TriXor4 lookups (round_function.rs:620 tri_xor_many)."""
        cs = self.cs
        return [cs.perform_lookup(self.trixor, [x, y, z])[0]
                for x, y, z in zip(a, b, c)]

    def ch_many(self, a, b, c):
        cs = self.cs
        return [cs.perform_lookup(self.ch, [x, y, z])[0]
                for x, y, z in zip(a, b, c)]

    def maj_many(self, a, b, c):
        cs = self.cs
        return [cs.perform_lookup(self.maj, [x, y, z])[0]
                for x, y, z in zip(a, b, c)]

    def range_check_chunks(self, chunks):
        """Batch 4-bit membership checks through TriXor4, 3 chunks a pop
        (round_function.rs:153 'range check small pieces')."""
        range_check_chunks_batched(self.cs, chunks, self.trixor)

    def merge_4bit_chunk(self, low, high, split_at, swap_output):
        """Merge two sub-4-bit pieces via Split4BitChunk (round_function.rs:566)."""
        cs = self.cs
        merged = cs.alloc_multiple_variables_without_values(2)

        def resolve(vals, s=split_at):
            lo, hi = vals
            return [lo | (hi << s), hi | (lo << (4 - s))]

        cs.set_values_with_dependencies([low, high], merged, resolve)
        # table row: (x, x & mask, x >> s, reversed)
        cs.enforce_lookup(
            self.split[split_at], [merged[0], low, high, merged[1]]
        )
        return merged[1] if swap_output else merged[0]

    # -- u32 (de)composition ------------------------------------------------

    def u32_to_chunks(self, v):
        """Decompose a u32 var into 8 LE 4-bit chunks + enforce recomposition
        (round_function.rs:352 uint32_into_4bit_chunks). Chunks are NOT
        range-checked here (callers batch that through lookups)."""
        cs = self.cs
        chunks = cs.alloc_multiple_variables_without_values(8)

        def resolve(vals):
            x = vals[0]
            return [(x >> (4 * i)) & MASK4 for i in range(8)]

        cs.set_values_with_dependencies([v], chunks, resolve)
        self._enforce_u32_from_chunks(chunks, v)
        return chunks

    def _enforce_u32_from_chunks(self, chunks, v):
        cs = self.cs
        to_u16 = [1, 1 << 4, 1 << 8, 1 << 12]
        low = ReductionGate.reduce(cs, chunks[:4], to_u16)
        high = ReductionGate.reduce(cs, chunks[4:], to_u16)
        FmaGate.enforce_fma(cs, self.one, high, low, v, 1 << 16, 1)

    def u32_from_chunks(self, chunks):
        """8 LE 4-bit chunks -> u32 var (round_function.rs:326)."""
        cs = self.cs
        to_u16 = [1, 1 << 4, 1 << 8, 1 << 12]
        low = ReductionGate.reduce(cs, chunks[:4], to_u16)
        high = ReductionGate.reduce(cs, chunks[4:], to_u16)
        return FmaGate.fma(cs, self.one, high, low, 1 << 16, 1)

    def split_and_rotate(self, v, rotation):
        """Right-rotation by chunk renumbering (round_function.rs:417):
        decompose as |rm|4|4|4|4|4|4|4|4-rm| pieces, enforce recomposition,
        merge the boundary pieces through the split table, renumber."""
        cs = self.cs
        rm = rotation % 4
        assert rm != 0
        aligned = cs.alloc_multiple_variables_without_values(7)
        dec_low = cs.alloc_variable_without_value()
        dec_high = cs.alloc_variable_without_value()

        def resolve(vals, rm=rm):
            x = vals[0]
            out = [x & ((1 << rm) - 1)]
            x >>= rm
            for _ in range(7):
                out.append(x & MASK4)
                x >>= 4
            out.append(x)  # < 2^(4-rm)
            return out

        cs.set_values_with_dependencies(
            [v], [dec_low] + aligned + [dec_high], resolve
        )
        # recomposition: v = dec_low + sum aligned_i·2^(rm+4i) + dec_high·2^(rm+28)
        shift = 0
        coeffs = []
        for i in range(4):
            coeffs.append(1 << shift)
            shift += rm if i == 0 else 4
        t = ReductionGate.reduce(cs, [dec_low] + aligned[:3], coeffs)
        coeffs = [1]
        for _ in range(3):
            coeffs.append(1 << shift)
            shift += 4
        t = ReductionGate.reduce(cs, [t] + aligned[3:6], coeffs)
        coeffs = [1, 1 << shift, 1 << (shift + 4), 0]
        ReductionGate.enforce_reduce(
            cs, [t, aligned[6], dec_high, self.zero], coeffs, v
        )
        # merge boundary pieces into one aligned chunk
        if rm == 1:
            merged = self.merge_4bit_chunk(dec_low, dec_high, 1, True)
        elif rm == 2:
            merged = self.merge_4bit_chunk(dec_high, dec_low, 2, False)
        else:  # rm == 3
            merged = self.merge_4bit_chunk(dec_high, dec_low, 1, False)
        full = rotation // 4
        result = [None] * 8
        for i, el in enumerate(aligned):
            result[(8 - full + i) % 8] = el
        result[(8 - full - 1) % 8] = merged
        return result, dec_low, dec_high

    # -- range checks -------------------------------------------------------

    def split_36_unchecked(self, v):
        """v = low + 2^32·high with no range enforcement yet
        (round_function.rs:771)."""
        cs = self.cs
        low = cs.alloc_variable_without_value()
        high = cs.alloc_variable_without_value()

        def resolve(vals):
            return [vals[0] & 0xFFFFFFFF, vals[0] >> 32]

        cs.set_values_with_dependencies([v], [low, high], resolve)
        FmaGate.enforce_fma(cs, self.one, high, low, v, 1 << 32, 1)
        return low, high

    def range_check_36(self, v):
        """Split a ≤36-bit value into 9 checked 4-bit chunks; returns the u32
        part (round_function.rs:692)."""
        cs = self.cs
        chunks = cs.alloc_multiple_variables_without_values(9)

        def resolve(vals):
            x = vals[0]
            return [(x >> (4 * i)) & MASK4 for i in range(9)]

        cs.set_values_with_dependencies([v], chunks, resolve)
        to_u16 = [1, 1 << 4, 1 << 8, 1 << 12]
        low = ReductionGate.reduce(cs, chunks[:4], to_u16)
        high = ReductionGate.reduce(cs, chunks[4:8], to_u16)
        u32_part = FmaGate.fma(cs, self.one, high, low, 1 << 16, 1)
        FmaGate.enforce_fma(cs, self.one, chunks[8], u32_part, v, 1 << 32, 1)
        self.tri_xor_many([chunks[0]], [chunks[1]], [chunks[2]])
        self.tri_xor_many([chunks[3]], [chunks[4]], [chunks[5]])
        self.tri_xor_many([chunks[6]], [chunks[7]], [chunks[8]])
        return u32_part, chunks

    def range_check_u32(self, v):
        """Full u32 decomposition + 4-bit checks (round_function.rs:678);
        returns the 8 chunks."""
        chunks = self.u32_to_chunks(v)
        self.tri_xor_many([chunks[0]], [chunks[1]], [chunks[2]])
        self.tri_xor_many([chunks[3]], [chunks[4]], [chunks[5]])
        self.tri_xor_many([chunks[6]], [chunks[7]], [chunks[0]])
        return chunks


def round_function(ctx: _Sha256Ctx, state, message_block, last_round):
    """One SHA-256 compression round over 16 message words
    (round_function.rs:53). state: list of 8 u32 vars, updated in place.
    Returns the 64 LE 4-bit digest chunks when last_round."""
    cs = ctx.cs
    zero = ctx.zero
    expanded = list(message_block) + [None] * (SHA256_ROUNDS - 16)
    unconstrained = []

    for idx in range(16, SHA256_ROUNDS):
        t0 = expanded[idx - 15]
        t0_rot7, _low7, t0_rot7_high = ctx.split_and_rotate(t0, 7)
        t0_rot18, _, _ = ctx.split_and_rotate(t0, 18)
        t0_shift3 = [t0_rot7[(7 + i) % 8] for i in range(7)] + [t0_rot7_high]
        s0_chunks = ctx.tri_xor_many(t0_rot7, t0_rot18, t0_shift3)

        t1 = expanded[idx - 2]
        t1_rot17, _, _ = ctx.split_and_rotate(t1, 17)
        t1_rot19, _, _ = ctx.split_and_rotate(t1, 19)
        t1_rot10, _, t1_rot10_high = ctx.split_and_rotate(t1, 10)
        t1_shift10 = list(t1_rot10)
        t1_shift10[7] = zero
        t1_shift10[6] = zero
        t1_shift10[5] = t1_rot10_high
        s1_chunks = ctx.tri_xor_many(t1_rot17, t1_rot19, t1_shift10)

        s0 = ctx.u32_from_chunks(s0_chunks)
        s1 = ctx.u32_from_chunks(s1_chunks)
        word = ReductionGate.reduce(
            cs, [s0, s1, expanded[idx - 7], expanded[idx - 16]], [1, 1, 1, 1]
        )
        if idx + 2 >= SHA256_ROUNDS:
            u32_part, _ = ctx.range_check_36(word)
        else:
            u32_part, high = ctx.split_36_unchecked(word)
            unconstrained.append(high)
        expanded[idx] = u32_part

    ctx.range_check_chunks(unconstrained)

    a, b, c, d, e, f, g, h = state

    for rnd in range(SHA256_ROUNDS):
        e_rot6, _, _ = ctx.split_and_rotate(e, 6)
        e_rot11, _, _ = ctx.split_and_rotate(e, 11)
        e_rot25, _, _ = ctx.split_and_rotate(e, 25)
        s1 = ctx.u32_from_chunks(ctx.tri_xor_many(e_rot6, e_rot11, e_rot25))

        e_dec = ctx.u32_to_chunks(e)
        f_dec = ctx.u32_to_chunks(f)
        g_dec = ctx.u32_to_chunks(g)
        ch = ctx.u32_from_chunks(ctx.ch_many(e_dec, f_dec, g_dec))

        rc = cs.allocate_constant(ROUND_CONSTANTS[rnd])
        tmp1 = ReductionGate.reduce(cs, [h, s1, ch, rc], [1, 1, 1, 1])
        tmp1 = FmaGate.fma(cs, ctx.one, tmp1, expanded[rnd], 1, 1)
        t = FmaGate.fma(cs, ctx.one, tmp1, d, 1, 1)
        new_e, _ = ctx.range_check_36(t)

        a_rot2, _, _ = ctx.split_and_rotate(a, 2)
        a_rot13, _, _ = ctx.split_and_rotate(a, 13)
        a_rot22 = [a_rot2[(i + 5) % 8] for i in range(8)]
        s0 = ctx.u32_from_chunks(ctx.tri_xor_many(a_rot2, a_rot13, a_rot22))

        a_dec = ctx.u32_to_chunks(a)
        b_dec = ctx.u32_to_chunks(b)
        c_dec = ctx.u32_to_chunks(c)
        maj = ctx.u32_from_chunks(ctx.maj_many(a_dec, b_dec, c_dec))

        t = ReductionGate.reduce(cs, [s0, maj, tmp1, zero], [1, 1, 1, 0])
        new_a, _ = ctx.range_check_36(t)

        h, g, f, e = g, f, e, new_e
        d, c, b, a = c, b, a, new_a

    # fold into state (mod 2^32), range checking d & h fully
    final_d_dec = final_h_dec = None
    unchecked = []
    for i, src in enumerate([a, b, c, d, e, f, g, h]):
        tmp = FmaGate.fma(cs, ctx.one, state[i], src, 1, 1)
        tmp, high = ctx.split_36_unchecked(tmp)
        unchecked.append(high)
        if i == 3:
            final_d_dec = ctx.range_check_u32(tmp)
        if i == 7:
            final_h_dec = ctx.range_check_u32(tmp)
        state[i] = tmp
    ctx.range_check_chunks(unchecked)

    if not last_round:
        return None
    le_chunks = []
    to_check = []
    for i, el in enumerate(state):
        if i == 3:
            dec = final_d_dec
        elif i == 7:
            dec = final_h_dec
        else:
            dec = ctx.u32_to_chunks(el)
            to_check.extend(dec)
        le_chunks.extend(dec)
    ctx.range_check_chunks(to_check)
    return le_chunks


def allocate_u8_input(cs, data: bytes):
    """Allocate input bytes as range-checked u8 variables (the reference
    bench allocates checked UInt8 witnesses, sha256/mod.rs:330)."""
    ctx = _Sha256Ctx(cs)
    out = []
    chunks_to_check = []
    for byte in data:
        v = cs.alloc_variable_with_value(byte)
        lo = cs.alloc_variable_with_value(byte & MASK4)
        hi = cs.alloc_variable_with_value(byte >> 4)
        FmaGate.enforce_fma(cs, ctx.one, hi, lo, v, 1 << 4, 1)
        chunks_to_check.extend([lo, hi])
        out.append(v)
    ctx.range_check_chunks(chunks_to_check)
    return out


def sha256(cs, input_bytes):
    """Hash a list of u8 variables; returns 32 u8 digest variables
    (reference sha256/mod.rs:35)."""
    ctx = _Sha256Ctx(cs)
    msg = list(input_bytes)
    ln = len(msg)
    last = ln % SHA256_BLOCK_SIZE
    if last <= SHA256_BLOCK_SIZE - 1 - 8:
        zeros = SHA256_BLOCK_SIZE - 1 - 8 - last
    else:
        zeros = 2 * SHA256_BLOCK_SIZE - 1 - 8 - last
    msg.append(cs.allocate_constant(0x80))
    zero_byte = cs.allocate_constant(0x00)
    msg.extend([zero_byte] * zeros)
    for byte in (ln * 8).to_bytes(8, "big"):
        msg.append(cs.allocate_constant(byte))
    assert len(msg) % SHA256_BLOCK_SIZE == 0
    num_blocks = len(msg) // SHA256_BLOCK_SIZE

    state = [cs.allocate_constant(v) for v in INITIAL_STATE]
    final_chunks = None
    for blk in range(num_blocks):
        block = msg[blk * SHA256_BLOCK_SIZE : (blk + 1) * SHA256_BLOCK_SIZE]
        words = []
        for i in range(16):
            b0, b1, b2, b3 = block[4 * i : 4 * i + 4]
            words.append(
                ReductionGate.reduce(
                    cs, [b0, b1, b2, b3],
                    [1 << 24, 1 << 16, 1 << 8, 1],
                )
            )
        final_chunks = round_function(
            ctx, state, words, blk == num_blocks - 1
        )

    # chunks -> bytes, big-endian within each word (sha256/mod.rs:88)
    output = []
    for w in range(8):
        word_chunks = final_chunks[8 * w : 8 * w + 8]
        word_bytes = []
        for k in range(4):
            low, high = word_chunks[2 * k], word_chunks[2 * k + 1]
            word_bytes.append(FmaGate.fma(cs, ctx.one, high, low, 1 << 4, 1))
        output.extend(reversed(word_bytes))
    return output


def sha256_digest_bytes(cs, digest_vars) -> bytes:
    """Read back the digest witness values as bytes."""
    return bytes(cs.get_value(v) for v in digest_vars)
