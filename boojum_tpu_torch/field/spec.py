"""FieldSpec: the protocol constants of each field the port proves over.

The same records as the JAX package's field/spec.py. Goldilocks is the
port's main field; BabyBear (p = 2^31 - 2^27 + 1) holds one element in a
32-bit word, and draws its challenges from the degree-4 extension
GF(p^4) = GF(p)[w]/(w^4 - 11), because 31-bit challenges are unsound.
The caller names the field (`ConstraintSystem(..., field=...)`); the port
reads no environment variable for it.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    name: str
    p: int
    two_adicity: int
    multiplicative_generator: int
    radix2_subgroup_generator: int  # primitive 2^two_adicity-th root of 1
    ext_degree: int  # extension degree challenges are drawn over
    ext_nonresidue: int  # GF(p^d) = GF(p)[x]/(x^d - ext_nonresidue)
    elem_bytes: int  # bytes of one base element as the JAX package stores it
    challenge_bits: int  # bits of one transcript challenge word
    digest_elems: int  # base elements per Merkle digest
    sponge_width: int  # Poseidon2 state width
    sponge_rate: int

    @property
    def half(self) -> int:
        """(p + 1) / 2, the inverse of 2."""
        return (self.p + 1) // 2

    def omega(self, log_n: int) -> int:
        """Primitive 2^log_n-th root of unity."""
        if log_n > self.two_adicity:
            raise ValueError(f"no 2^{log_n}-th root of unity in {self.name}")
        w = self.radix2_subgroup_generator
        for _ in range(self.two_adicity - log_n):
            w = (w * w) % self.p
        return w


GOLDILOCKS = FieldSpec(
    name="goldilocks",
    p=0xFFFFFFFF00000001,
    two_adicity=32,
    multiplicative_generator=7,
    radix2_subgroup_generator=0x185629DCDA58878C,
    ext_degree=2,
    ext_nonresidue=7,
    elem_bytes=8,
    challenge_bits=64,
    digest_elems=4,
    sponge_width=12,
    sponge_rate=8,
)

_BB_P = (1 << 31) - (1 << 27) + 1  # 2013265921

BABYBEAR = FieldSpec(
    name="babybear",
    p=_BB_P,
    two_adicity=27,
    multiplicative_generator=31,
    radix2_subgroup_generator=pow(31, (_BB_P - 1) >> 27, _BB_P),
    ext_degree=4,
    ext_nonresidue=11,  # x^4 - 11 is irreducible over GF(p)
    elem_bytes=4,
    challenge_bits=31,
    digest_elems=8,
    sponge_width=16,
    sponge_rate=8,
)

SPECS = {s.name: s for s in (GOLDILOCKS, BABYBEAR)}


def spec_of(field: str) -> FieldSpec:
    if field not in SPECS:
        raise ValueError(f"unknown field {field!r} (want one of {sorted(SPECS)})")
    return SPECS[field]
