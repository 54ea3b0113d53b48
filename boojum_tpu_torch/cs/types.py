"""CS data model: geometry.

Places are plain ints with the JAX package's tag bit: variable k is 2k
(witness places, 2k + 1, are not ported), and -1 marks a vacant cell.
"""

from dataclasses import dataclass


@dataclass(frozen=True)
class CSGeometry:
    """Trace shape (era-boojum CSGeometry)."""

    num_columns_under_copy_permutation: int
    num_witness_columns: int
    num_constant_columns: int
    max_allowed_constraint_degree: int
