"""Gate framework: the evaluator contract and row views.

A gate declares its geometry (copy columns per instance, constants per row,
quotient terms, degree) and one `evaluate(ops, row, dst)` over the field-like
ops contract (cs/field_like.py). That one definition drives the verifier
at z (GF(p^2) scalars) and, through symbolic capture (cs/gate_capture.py),
the op program that the quotient-sweep kernel and its plain version replay;
over host ints and tensors it checks the captured program.
"""

from __future__ import annotations


class RowView:
    """One gate instance's cells: v(i) copy column, w(i) witness column,
    c(i) gate constant."""

    def __init__(self, var_get, wit_get, const_get):
        self.v = var_get
        self.w = wit_get
        self.c = const_get


class TermsCollector:
    def __init__(self):
        self.terms = []

    def push(self, value):
        self.terms.append(value)


class Gate:
    """Base gate. Subclasses set the class attributes and evaluate()."""

    name: str = "?"
    principal_width: int = 0  # copy columns per instance
    witness_width: int = 0  # witness columns per instance
    num_constants: int = 0  # constant columns consumed per row
    num_terms: int = 0  # quotient terms per instance
    max_degree: int = 0  # max constraint degree over the trace polys
    is_lookup_marker: bool = False  # rows carry general-mode lookup tuples

    _inst = None

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        cls._inst = None  # each gate class caches an instance of its own

    @classmethod
    def instance(cls):
        inst = cls._inst
        if inst is None:
            inst = cls._inst = cls()
        return inst

    def evaluate(self, ops, row: RowView, dst: TermsCollector):
        raise NotImplementedError

    def num_repetitions(self, geometry) -> int:
        """Instances packed into one general-purpose row."""
        if self.principal_width == 0:
            return 1
        per_copy = geometry.num_columns_under_copy_permutation // self.principal_width
        if self.witness_width:
            per_wit = geometry.num_witness_columns // self.witness_width
            per_copy = min(per_copy, per_wit)
        return per_copy

    def padding_instance(self, cs, constants=()) -> list:
        """Variable places filling one vacant instance so its terms vanish."""
        zero = cs.zero_var()
        return [zero] * self.principal_width

    def __repr__(self):
        return f"<gate {self.name}>"
