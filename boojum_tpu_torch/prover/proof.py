"""Proof object (era-boojum Proof). `to_json` emits the same JSON text as the
JAX package's prover/proof.py for the same proof."""

from __future__ import annotations

import json
from dataclasses import dataclass, field


@dataclass
class OracleQuery:
    """Leaf values + Merkle path for one oracle at one query index."""

    leaf_values: list  # flat list of ints (column values at the point)
    path: list  # list of 4-tuples


@dataclass
class SingleRoundQueries:
    witness: OracleQuery
    stage2: OracleQuery
    quotient: OracleQuery
    setup: OracleQuery
    fri: list  # OracleQuery per committed FRI round (pair leaves)


@dataclass
class Proof:
    public_inputs: list
    witness_cap: list
    stage2_cap: list
    quotient_cap: list
    values_at_z: list  # [(c0, c1)] in canonical column order
    values_at_z_omega: list  # [(c0, c1)] for the grand-product poly cols
    values_at_0: list  # [(c0, c1)] for lookup A/B polys
    fri_caps: list  # caps per committed FRI round
    final_fri_monomials: list  # [(c0, c1)]
    queries: list  # SingleRoundQueries per query
    pow_challenge: int = 0
    config: dict = field(default_factory=dict)

    def to_json(self) -> str:
        def enc(o):
            if isinstance(o, (OracleQuery, SingleRoundQueries)):
                return o.__dict__
            if isinstance(o, tuple):
                return list(o)
            raise TypeError(type(o))

        return json.dumps(self.__dict__, default=enc)

    @staticmethod
    def from_json(s: str) -> "Proof":
        d = json.loads(s)

        def dec_q(q):
            return OracleQuery(
                leaf_values=[int(v) for v in q["leaf_values"]],
                path=[tuple(int(x) for x in p) for p in q["path"]],
            )

        queries = [
            SingleRoundQueries(
                witness=dec_q(r["witness"]),
                stage2=dec_q(r["stage2"]),
                quotient=dec_q(r["quotient"]),
                setup=dec_q(r["setup"]),
                fri=[dec_q(f) for f in r["fri"]],
            )
            for r in d["queries"]
        ]
        caps = lambda c: [tuple(int(x) for x in t) for t in c]
        return Proof(
            public_inputs=[int(v) for v in d["public_inputs"]],
            witness_cap=caps(d["witness_cap"]),
            stage2_cap=caps(d["stage2_cap"]),
            quotient_cap=caps(d["quotient_cap"]),
            values_at_z=[tuple(int(x) for x in v) for v in d["values_at_z"]],
            values_at_z_omega=[
                tuple(int(x) for x in v) for v in d["values_at_z_omega"]
            ],
            values_at_0=[tuple(int(x) for x in v) for v in d["values_at_0"]],
            fri_caps=[caps(c) for c in d["fri_caps"]],
            final_fri_monomials=[
                tuple(int(x) for x in v) for v in d["final_fri_monomials"]
            ],
            queries=queries,
            pow_challenge=int(d.get("pow_challenge", 0)),
            config=d.get("config", {}),
        )
