"""CS data model: geometry and lookup parameters.

Places are plain ints with the JAX package's tag bit: variable k is 2k,
witness k (a witness-column value) is 2k + 1, and -1 marks a vacant cell.
"""

from dataclasses import dataclass


@dataclass(frozen=True)
class CSGeometry:
    """Trace shape (era-boojum CSGeometry)."""

    num_columns_under_copy_permutation: int
    num_witness_columns: int
    num_constant_columns: int
    max_allowed_constraint_degree: int


@dataclass(frozen=True)
class LookupParameters:
    """Lookup configuration (era-boojum LookupParameters).

    width: key and value columns per sub-argument (the table id excluded);
    num_repetitions: sub-arguments per row in specialized mode;
    share_table_id: the table id is one shared constant column per row;
    use_specialized_columns: dedicated lookup columns rather than tuples on
    marker rows of the general columns (general mode, where the
    sub-arguments are the general columns // width).
    """

    width: int = 0
    num_repetitions: int = 0
    share_table_id: bool = True
    use_specialized_columns: bool = True

    @property
    def is_enabled(self) -> bool:
        if not self.use_specialized_columns:
            return self.width > 0
        return self.num_repetitions > 0

    @property
    def specialized_columns_per_subargument(self) -> int:
        return self.width + (0 if self.share_table_id else 1)


@dataclass(frozen=True)
class CSConfig:
    """What a synthesis run does (era-boojum's config bundles):
    evaluate_witness: resolve witness values (off for setup-only synthesis,
    whose resolver stores nothing)."""

    evaluate_witness: bool = True


DEV_CS_CONFIG = CSConfig(evaluate_witness=True)
SETUP_CS_CONFIG = CSConfig(evaluate_witness=False)
