"""The port's gates against boojum_tpu's: the same
captured op program (the table the quotient-sweep kernel replays), the same
terms over host ints, and the captured program replayed over word tensors
equal to the gate's own evaluation (tolerance 0: exact field elements)."""

import numpy as np
import pytest

from boojum_tpu.cs import field_like as jfl
from boojum_tpu.cs.gate_capture import capture_gate_program as jcapture
from boojum_tpu.cs.gates import base as jbase
from boojum_tpu.cs.gates import simple as jsimple
from boojum_tpu_torch.cs import field_like as tfl
from boojum_tpu_torch.cs.gate_capture import capture_gate_program
from boojum_tpu_torch.cs.gates import GATES_BY_NAME
from boojum_tpu_torch.cs.gates.base import Gate, RowView, TermsCollector
from boojum_tpu_torch.cs.types import CSGeometry
from boojum_tpu_torch.prover import quotient_sweep as qs
from torch_port_util import BOUNDARY, rand_words, to_np, to_t

JAX_GATES = {
    "fma": jsimple.FmaGate, "constant": jsimple.ConstantsAllocatorGate,
    "nop": jsimple.NopGate, "public_input": jsimple.PublicInputGate,
    "reduction4": jsimple.ReductionGate, "zero_check_wit": jsimple.ZeroCheckWitnessGate,
    "lookup_marker": jsimple.LookupMarkerGate,
}


@pytest.mark.parametrize("name", sorted(JAX_GATES))
def test_gate_shape_and_captured_program_match_jax(name):
    gate, jgate = GATES_BY_NAME[name].instance(), JAX_GATES[name].instance()
    for attr in ("principal_width", "witness_width", "num_constants", "num_terms",
                 "max_degree"):
        assert getattr(gate, attr) == getattr(jgate, attr), attr
    got, want = capture_gate_program(gate), jcapture(jgate)
    fields = ("loads", "consts", "ops", "terms", "num_slots")
    assert {f: getattr(got, f) for f in fields} == {f: getattr(want, f) for f in fields}


def _cells(rng, n):
    return {k: [int(v) for v in rand_words(rng, n)] for k in ("v", "w", "c")}


@pytest.mark.parametrize("name", sorted(JAX_GATES))
@pytest.mark.parametrize("seed", [0, 1])
def test_gate_terms_over_host_ints_match_jax(name, seed):
    cells = _cells(np.random.default_rng(seed), 8)
    cells["v"][:3] = [int(b) for b in BOUNDARY[seed * 3 : seed * 3 + 3]]
    gate, jgate = GATES_BY_NAME[name].instance(), JAX_GATES[name].instance()
    got, want = TermsCollector(), jbase.TermsCollector()
    gate.evaluate(tfl.ScalarOps, RowView(cells["v"].__getitem__, cells["w"].__getitem__,
                                         cells["c"].__getitem__), got)
    jgate.evaluate(jfl.ScalarOps, jbase.RowView(cells["v"].__getitem__,
                                                cells["w"].__getitem__,
                                                cells["c"].__getitem__), want)
    assert [int(t) for t in got.terms] == [int(t) for t in want.terms]


@pytest.mark.parametrize("name", sorted(JAX_GATES))
def test_captured_program_replays_gate_over_tensors(name):
    rng = np.random.default_rng(7)
    v, w, c = rand_words(rng, 8, 64), rand_words(rng, 8, 64), rand_words(rng, 8, 64)
    row = RowView(lambda i: to_t(v[i]), lambda i: to_t(w[i]), lambda i: to_t(c[i]))
    gate = GATES_BY_NAME[name].instance()
    direct = TermsCollector()
    gate.evaluate(tfl.TensorOps, row, direct)
    replayed = capture_gate_program(gate).evaluate(tfl.TensorOps, row)
    assert len(replayed) == len(direct.terms) == gate.num_terms
    for a, b in zip(replayed, direct.terms):
        np.testing.assert_array_equal(to_np(a), to_np(b))


class _WitnessGate(Gate):
    """A gate reading one witness column past its own."""

    name = "uses_witness"
    principal_width = 1
    witness_width = 1
    num_terms = 1
    max_degree = 1

    def evaluate(self, ops, row, dst):
        dst.push(ops.sub(row.v(0), row.w(1)))


class _WideConstGate(Gate):
    """A gate reading one constant column past the geometry's."""

    name = "wide_const"
    principal_width = 1
    num_constants = 6
    num_terms = 1
    max_degree = 1

    def evaluate(self, ops, row, dst):
        dst.push(ops.sub(row.v(0), row.c(5)))


@pytest.mark.parametrize("gate,error", [
    (_WitnessGate, ValueError), (_WideConstGate, ValueError),
])
def test_sweep_plan_rejects_loads_outside_the_ported_columns(gate, error):
    """The encoder refuses what the kernel could only read out of bounds, so
    the CPU and the card both raise before any sweep runs."""
    geometry = CSGeometry(16, 1, 6, 3)
    with pytest.raises(error):
        qs.SweepPlan([gate.instance()], [[0]], geometry, 16, "cpu")
