from .resolver import (
    NativeTapeResolver,
    NullResolver,
    PlaybackResolver,
    WitnessResolver,
    make_resolver,
)
