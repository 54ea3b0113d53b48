"""Lookup tables: dense (rows, width) content plus a key -> row index map.

Same tables and ids as the JAX package's cs/lookup_table.py: ids are
handed out by the constraint system from 1, so id 0 never matches the zero
padding of the table-id setup column.
"""

from __future__ import annotations

import numpy as np

from ..field import gl


class LookupTable:
    def __init__(self, name: str, num_keys: int, num_values: int, rows):
        """rows: tuples of ints, each num_keys + num_values wide."""
        self.name = name
        self.num_keys = num_keys
        self.num_values = num_values
        self.width = num_keys + num_values
        content = np.array([[int(v) % gl.P for v in row] for row in rows],
                           dtype=np.uint64)
        if content.ndim != 2 or content.shape[1] != self.width:
            raise ValueError(f"table {name}: rows must have width {self.width}")
        self.content = content
        self._index = {
            tuple(int(v) for v in row[:num_keys]): i for i, row in enumerate(content)
        }
        if len(self._index) != len(content):
            raise ValueError(f"table {name}: duplicate keys")
        self._rows = [tuple(int(v) for v in row) for row in content]

    def __len__(self):
        return len(self.content)

    def row_index(self, vals) -> int:
        """Row of a full (keys + values) tuple; the keys alone also do."""
        idx = self._index[tuple(int(v) for v in vals[: self.num_keys])]
        if len(vals) > self.num_keys and tuple(vals) != self._rows[idx]:
            raise ValueError(f"table {self.name}: tuple {tuple(vals)} is not a row")
        return idx

    def lookup_values(self, keys) -> tuple:
        return self._rows[self._index[tuple(int(k) for k in keys)]][self.num_keys :]


def binop_table(name: str, op) -> LookupTable:
    """(a, b) -> op(a, b) over bytes; 65536 rows."""
    a = np.arange(256, dtype=np.uint64).repeat(256)
    b = np.tile(np.arange(256, dtype=np.uint64), 256)
    return LookupTable(name, 2, 1, np.stack([a, b, op(a, b)], axis=1))


def and8_table() -> LookupTable:
    return binop_table("and8", lambda a, b: a & b)


def xor8_table() -> LookupTable:
    return binop_table("xor8", lambda a, b: a ^ b)


def or8_table() -> LookupTable:
    return binop_table("or8", lambda a, b: a | b)


def range_check_table(bits: int, name: str | None = None) -> LookupTable:
    """[0, 2^bits) membership as (x, 0) pairs, so the table stacks with
    width-2 tables."""
    n = 1 << bits
    x = np.arange(n, dtype=np.uint64)
    return LookupTable(name or f"range_{bits}", 1, 1,
                       np.stack([x, np.zeros(n, dtype=np.uint64)], axis=1))
