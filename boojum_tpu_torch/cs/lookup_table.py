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
        self._sorted_keys = None  # (keys as sorted byte strings, their rows)

    def __len__(self):
        return len(self.content)

    def row_index(self, vals) -> int:
        """Row of a full (keys + values) tuple; the keys alone also do."""
        # ints and numpy words hash alike: the keys index the map as they come
        idx = self._index[tuple(vals[: self.num_keys])]
        if len(vals) > self.num_keys and tuple(vals) != self._rows[idx]:
            raise ValueError(f"table {self.name}: tuple {tuple(vals)} is not a row")
        return idx

    def lookup_values(self, keys) -> tuple:
        return self._rows[self._index[tuple(keys)]][self.num_keys :]

    def rows_of(self, tuples: np.ndarray) -> np.ndarray:
        """Rows of the columns of `tuples` ((keys [+ values], m) words), all
        at once; raises ValueError unless every one is a row."""
        k = self.num_keys
        key_bytes = np.dtype((np.void, 8 * k))
        if self._sorted_keys is None:
            keys = np.ascontiguousarray(self.content[:, :k]).view(key_bytes).ravel()
            order = np.argsort(keys, kind="stable")
            self._sorted_keys = (keys[order], order)
        table_keys, order = self._sorted_keys
        query = np.ascontiguousarray(tuples[:k].T, dtype=np.uint64).view(key_bytes).ravel()
        pos = np.minimum(np.searchsorted(table_keys, query), len(table_keys) - 1)
        rows = order[pos]
        if not (table_keys[pos] == query).all() or not np.array_equal(
                self.content[rows, k:tuples.shape[0]], tuples[k:].T):
            raise ValueError(f"table {self.name}: a tuple is not a row")
        return rows


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
