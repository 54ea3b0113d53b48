"""The column layout of the four oracles, in one place.

Setup, prover, quotient sweep and verifier all read the row of every column
from an `OracleLayout`, built from the geometry, the lookup parameters and,
in general mode, the lookup-marker gate's selector path. The order is the
JAX package's (its prover.py module docstring):

- witness: [general copy (Cg) | lookup copy (R·width, specialized mode) |
  witness columns (W) | multiplicities (1, with lookups)];
- setup: [sigma over every copy column (Ct) | constants (the geometry's,
  then the table-id column in specialized mode) | stacked table columns
  (width + 1, with lookups)];
- stage 2: [z | partial products | A_i (R) | B], each an ext polynomial as
  its (c0, c1) column pair;
- quotient: [q_0 c0, q_0 c1, ...], 2·Q columns.

Lookups come in two modes. Specialized: R = num_repetitions sub-arguments
over dedicated copy columns after the general ones, the table id in its own
setup column. General: the tuples sit in the general copy columns on
lookup-marker rows, R = Cg // width, and the table id is the marker's gate
constant, in constant column len(marker path).
"""

from __future__ import annotations

from dataclasses import dataclass


def chunk_columns(num_cols: int, max_degree: int):
    """Copy columns in contiguous chunks of at most max_degree columns."""
    w = max(1, max_degree)
    return [list(range(i, min(i + w, num_cols))) for i in range(0, num_cols, w)]


@dataclass(frozen=True)
class OracleLayout:
    Cg: int  # general copy columns
    W: int  # witness columns
    num_geometry_consts: int  # the geometry's constant columns
    max_degree: int  # copy-permutation chunk width
    mode: str = "none"  # none | specialized | general
    width: int = 0  # lookup tuple width
    R: int = 0  # lookup sub-arguments
    marker_path: tuple = ()  # general mode: the marker gate's selector path

    @classmethod
    def build(cls, geometry, lookup_params=None, gates=(), selector_paths=()):
        """The layout of a circuit. `lookup_params` is None, or disabled,
        without lookups; general mode needs the gates and their selector
        paths to find the marker's path."""
        base = dict(Cg=geometry.num_columns_under_copy_permutation,
                    W=geometry.num_witness_columns,
                    num_geometry_consts=geometry.num_constant_columns,
                    max_degree=geometry.max_allowed_constraint_degree)
        lp = lookup_params
        if lp is None or not lp.is_enabled:
            return cls(**base)
        if lp.use_specialized_columns:
            return cls(**base, mode="specialized", width=lp.width, R=lp.num_repetitions)
        marker = next((i for i, g in enumerate(gates) if g.is_lookup_marker), None)
        if marker is None:
            raise ValueError("general-mode lookups need the lookup-marker gate")
        return cls(**base, mode="general", width=lp.width, R=base["Cg"] // lp.width,
                   marker_path=tuple(int(b) for b in selector_paths[marker]))

    @classmethod
    def for_assembly(cls, assembly, selector_paths):
        lp = assembly.lookup_params if assembly.lookups_enabled else None
        return cls.build(assembly.geometry, lp, assembly.gates, selector_paths)

    @property
    def lookups(self) -> bool:
        return self.mode != "none"

    @property
    def specialized(self) -> bool:
        return self.mode == "specialized"

    # -- witness oracle -----------------------------------------------------

    @property
    def Ct(self) -> int:
        """Every column under the copy permutation."""
        return self.Cg + (self.R * self.width if self.specialized else 0)

    @property
    def wit_col(self) -> int:
        """First witness column."""
        return self.Ct

    @property
    def mult_row(self) -> int:
        """The multiplicity column (with lookups)."""
        return self.Ct + self.W

    @property
    def num_wit_rows(self) -> int:
        return self.Ct + self.W + (1 if self.lookups else 0)

    @property
    def lookup_col_base(self) -> int:
        """First copy column of sub-argument 0's tuple."""
        return self.Cg if self.specialized else 0

    # -- setup oracle -------------------------------------------------------

    @property
    def K(self) -> int:
        """Constant columns, the table-id column included."""
        return self.num_geometry_consts + (1 if self.specialized else 0)

    @property
    def tid_const(self) -> int:
        """The table id's column among the constant columns."""
        return self.K - 1 if self.specialized else len(self.marker_path)

    @property
    def table_row(self) -> int:
        """First stacked table column of the setup oracle."""
        return self.Ct + self.K

    @property
    def num_table_rows(self) -> int:
        return self.width + 1 if self.lookups else 0

    @property
    def num_setup_rows(self) -> int:
        return self.Ct + self.K + self.num_table_rows

    # -- stage-2 oracle -----------------------------------------------------

    @property
    def chunks(self):
        return chunk_columns(self.Ct, self.max_degree)

    @property
    def num_chunks(self) -> int:
        return len(self.chunks)

    @property
    def ab_row(self) -> int:
        """Stage-2 row of A_0's c0; B's c0 is at ab_row + 2R."""
        return 2 * self.num_chunks

    @property
    def num_s2_rows(self) -> int:
        return self.ab_row + (2 * (self.R + 1) if self.lookups else 0)

    @property
    def num_values_at_0(self) -> int:
        """A_i and B are opened at 0."""
        return self.R + 1 if self.lookups else 0

    def streamed_columns_estimate(self, quotient_degree: int, lde_factor: int) -> int:
        """The column count the prover's stream decision weighs: the JAX
        package's estimate (its prover.py _prove_impl), with stage 2 as
        2·chunks + 2·R + 2·M and the quotient as 2·(quotient_degree, or
        the LDE factor where that is 0), so both packages decide alike."""
        M = 1 if self.lookups else 0
        s2_est = 2 * self.num_chunks + 2 * self.R + 2 * M
        q_est = quotient_degree or lde_factor
        return (self.Ct + self.W + M) + self.num_setup_rows + s2_est + 2 * q_est

    def num_columns(self, quotient_degree: int) -> int:
        """Columns over the four oracles: the values opened at z."""
        return (self.num_wit_rows + self.num_setup_rows + self.num_s2_rows
                + 2 * quotient_degree)
