from .base import Gate, RowView, TermsCollector
from .simple import (
    GATES_BY_NAME,
    ConstantsAllocatorGate,
    FmaGate,
    LookupMarkerGate,
    NopGate,
    PublicInputGate,
    ReductionGate,
    ZeroCheckWitnessGate,
)
