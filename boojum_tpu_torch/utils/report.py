"""Fiat-Shamir checkpoint log.

The prover reports (round, label, values) at every transcript step; the log
keeps a blake2s digest over the 8-byte little-endian words of the values,
the same digest as the JAX package's utils/report.py, so two provers'
streams compare entry for entry.
"""

import hashlib


def _flatten_ints(values):
    out = []
    stack = [values]
    while stack:
        v = stack.pop()
        if isinstance(v, (list, tuple)):
            stack.extend(reversed(v))
        else:
            out.append(int(v))
    return out


def digest_of(values) -> str:
    h = hashlib.blake2s()
    for v in _flatten_ints(values):
        h.update((v & ((1 << 64) - 1)).to_bytes(8, "little"))
    return h.hexdigest()


class CheckpointLog:
    def __init__(self):
        self.entries: list[dict] = []

    def add(self, round_: int, label: str, values):
        self.entries.append(
            {
                "seq": len(self.entries),
                "round": int(round_),
                "label": label,
                "digest": digest_of(values),
            }
        )

    def stream(self) -> list:
        """(round, label, digest) per entry."""
        return [(e["round"], e["label"], e["digest"]) for e in self.entries]
