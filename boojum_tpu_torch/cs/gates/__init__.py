from .base import Gate, RowView, TermsCollector
from .ext_fma import ExtFmaGate
from .poseidon2_flat import Poseidon2FlattenedGate
from .poseidon_flat import PoseidonFlattenedGate
from .simple import (
    BooleanConstraintGate,
    BoundedGateWrapper,
    ConditionalSwapGate,
    ConstantsAllocatorGate,
    DotProductGate,
    ExplicitConstantsAllocatorGate,
    FmaGate,
    LookupMarkerGate,
    MatrixMultiplicationGate,
    NopGate,
    ParallelSelectionGate,
    PublicInputGate,
    QuadraticCombinationGate,
    ReductionByPowersGate,
    ReductionGate,
    SelectionGate,
    SimpleNonlinearityGate,
    ZeroCheckGate,
    ZeroCheckWitnessGate,
)
from .simple import GATES_BY_NAME as _SIMPLE
from .u32 import (
    ByteTriAddGate,
    U32AddGate,
    U32FmaGate,
    U32SubGate,
    U32TriAddCarryAsChunkGate,
    UIntXAddGate,
)
from .u32 import GATES_BY_NAME as _U32

# every gate a name alone identifies (the parametrised ones: compat.port_gate)
GATES_BY_NAME = {**_SIMPLE, **_U32, **{g.name: g for g in (
    ExtFmaGate, Poseidon2FlattenedGate, PoseidonFlattenedGate)}}
