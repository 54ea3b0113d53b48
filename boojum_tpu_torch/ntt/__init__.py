"""NTT / LDE over Goldilocks (kernels B1-B3)."""

from .ntt import (
    bitreverse_indices,
    distribute_powers,
    eval_monomial_at_ext_point,
    ext_powers_device,
    fft_natural_to_bitreversed,
    get_ntt_context,
    ifft_bitreversed_to_natural,
    lde_from_monomial,
    lde_scale_rows,
    monomial_from_values,
    powers_device,
)
