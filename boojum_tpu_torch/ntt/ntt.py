"""Radix-2 NTT and coset LDE over Goldilocks, batched across rows.

Domain conventions, as in the JAX package's ntt/ntt.py:
- forward: natural input -> bit-reversed output (DIF);
- inverse: bit-reversed input -> natural output (DIT), including 1/n;
- LDE storage (..., lde_factor, n): the coset axis is indexed by the
  bit-reversed coset index and each coset is bit-reversed inside, so
  flattening the last two axes gives the full domain {g·w_N^i} in
  bit-reversed order of i and FRI fold pairs are adjacent.

Kernels B1-B3 (csrc/ntt.cu, replacing boojum_tpu/ntt/mxu_ntt.py
_fwd_kernel, _inv_kernel and _fwd_scaled_kernel) carry
`fft_natural_to_bitreversed`, `ifft_bitreversed_to_natural` and
`lde_from_monomial`: a CUDA tensor launches the kernel at every size, a CPU
tensor runs the plain butterfly stages below, which mirror the JAX
package's dif_stages / dit_stages. The forward kernel runs in the passes
of `forward_pass_plan`, with the twiddle tables `_forward_tables` builds;
the inverse in those of `inverse_pass_plan`, the same passes in mirror
order, with `_inverse_tables`.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from .. import kernels as K
from ..field import extension as ext
from ..field import gl
from ..field import goldilocks as gf


@lru_cache(maxsize=8)
def _bitreverse(log_n: int, device: str) -> torch.Tensor:
    idx = torch.arange(1 << log_n, dtype=torch.int64, device=device)
    rev = torch.zeros_like(idx)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


def bitreverse_indices(log_n: int, device="cpu") -> torch.Tensor:
    """perm[i] = bitreverse(i, log_n), an int64 tensor built on `device`
    (cached; do not write to it)."""
    return _bitreverse(log_n, str(torch.device(device)))


class NTTContext:
    """Twiddle tables for size-2^log_n transforms on one device."""

    def __init__(self, log_n: int, device: torch.device):
        if not 0 < log_n <= gl.TWO_ADICITY:
            raise ValueError(f"log_n {log_n} out of range")
        self.log_n = log_n
        self.n = 1 << log_n
        self.omega = gl.omega(log_n)
        self.omega_inv = gl.inv(self.omega)
        self.n_inv = gl.inv(self.n)
        self.tw = gf.powers(self.omega, self.n // 2, device)
        self.itw = gf.powers(self.omega_inv, self.n // 2, device)


@lru_cache(maxsize=32)
def _ntt_context(log_n: int, device: str) -> NTTContext:
    return NTTContext(log_n, torch.device(device))


def get_ntt_context(log_n: int, device) -> NTTContext:
    return _ntt_context(log_n, str(torch.device(device)))


def _log2(n: int) -> int:
    log_n = n.bit_length() - 1
    if n < 2 or 1 << log_n != n:
        raise ValueError(f"transform size {n} is not a power of two >= 2")
    return log_n


# ---------------------------------------------------------------------------
# Plain versions (the CPU path and the kernels' reference)
# ---------------------------------------------------------------------------


def dif_stages_plain(a: torch.Tensor, ctx: NTTContext) -> torch.Tensor:
    n = ctx.n
    lead = a.shape[:-1]
    for s in range(ctx.log_n):
        block = n >> s
        half = block >> 1
        tw = ctx.tw[:: n // block][:half]
        x = a.reshape(lead + (n // block, 2, half))
        u, v = x[..., 0, :], x[..., 1, :]
        a = torch.stack([gf.add(u, v), gf.mul(gf.sub(u, v), tw)], dim=-2)
        a = a.reshape(lead + (n,))
    return a


def dit_stages_plain(a: torch.Tensor, ctx: NTTContext) -> torch.Tensor:
    n = ctx.n
    lead = a.shape[:-1]
    for s in range(ctx.log_n):
        block = 2 << s
        half = block >> 1
        tw = ctx.itw[:: n // block][:half]
        x = a.reshape(lead + (n // block, 2, half))
        u = x[..., 0, :]
        wv = gf.mul(x[..., 1, :], tw)
        a = torch.stack([gf.add(u, wv), gf.sub(u, wv)], dim=-2)
        a = a.reshape(lead + (n,))
    return a


def fft_plain(a, scale_row=None):
    ctx = get_ntt_context(_log2(a.shape[-1]), a.device)
    if scale_row is not None:
        a = gf.mul(a, scale_row)
    return dif_stages_plain(a, ctx)


def ifft_plain(a):
    ctx = get_ntt_context(_log2(a.shape[-1]), a.device)
    return gf.mul(dit_stages_plain(a, ctx), ctx.n_inv)


def lde_plain(coeffs, scale):
    return fft_plain(coeffs[..., None, :], scale)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


# The kernels' passes (csrc/ntt.cu): strided passes of at most 10 index
# bits, a pass of at most 11 over contiguous words (the forward's last, the
# inverse's first).
MAX_STRIDED_PASS = 10
MAX_LAST_PASS = 11


def forward_pass_plan(log_n: int) -> tuple[int, ...]:
    """Index bits of each pass of the forward kernel, first (the top bits)
    to last: one pass up to 2^11, two up to 2^21 (2^20: 9 + 11), three up
    to 2^31; the last pass at most 11 bits, the others at most 10 and as
    even as those limits allow."""
    if log_n <= MAX_LAST_PASS:
        return (log_n,)
    passes = 2 if log_n <= MAX_LAST_PASS + MAX_STRIDED_PASS else (
        1 + -(-(log_n - MAX_LAST_PASS) // MAX_STRIDED_PASS))
    last = min(MAX_LAST_PASS, max(-(-log_n // passes), log_n - 9 * (passes - 1)))
    rest, m = log_n - last, passes - 1
    return tuple(rest // m + (i < rest % m) for i in range(m)) + (last,)


def inverse_pass_plan(log_n: int) -> tuple[int, ...]:
    """Index bits of each pass of the inverse kernel, first (the low bits,
    contiguous sub-transforms) to last: the forward plan reversed, so one
    pass up to 2^11, two up to 2^21 (2^20: 11 + 9), three up to 2^31."""
    return forward_pass_plan(log_n)[::-1]


def _four_step_twiddles(ctx: NTTContext, lo: int, k: int, inverse: bool = False):
    """The twiddles a strided pass of k bits over columns 2^lo words apart
    multiplies in, laid out like the data of one 2^(lo + k) block: entry
    q * 2^lo + c = omega_M^(c * bitrev_k(q)), M = 2^(lo + k), at the forward
    pass's store; its inverse, omega_M^-(c * bitrev_k(q)), at the inverse
    pass's load."""
    dev = ctx.tw.device
    rev = bitreverse_indices(k, dev)
    cols = torch.arange(1 << lo, dtype=torch.int64, device=dev)
    e = (rev[:, None] * cols[None, :]) % (1 << (lo + k))
    y = (e << (ctx.log_n - lo - k)).reshape(-1)  # omega_n^(+-y), y < n
    half = ctx.n // 2
    w = (ctx.itw if inverse else ctx.tw)[y % half]
    return torch.where(y >= half, gf.neg(w), w)


@lru_cache(maxsize=8)
def _forward_tables(log_n: int, device: str):
    """(plan, heap, post) of the forward kernel at size 2^log_n: heap[2^(k-1)
    + j] = omega_{2^k}^j for each pass size k; post the strided passes'
    four-step twiddles, one table after another."""
    ctx = get_ntt_context(log_n, device)
    plan = forward_pass_plan(log_n)
    heap = torch.zeros(1 << MAX_LAST_PASS, dtype=torch.int64, device=ctx.tw.device)
    for k in set(plan):
        heap[1 << (k - 1) : 1 << k] = ctx.tw[:: 1 << (log_n - k)][: 1 << (k - 1)]
    posts, lo = [], log_n
    for k in plan[:-1]:
        lo -= k
        posts.append(_four_step_twiddles(ctx, lo, k))
    post = torch.cat(posts) if posts else heap[:1]
    return plan, heap, post


@lru_cache(maxsize=8)
def _inverse_tables(log_n: int, device: str):
    """(plan, heap, pre, the plan as a C int array, 1/n) of the inverse
    kernel at size 2^log_n: heap[2^(k-1) + j] = omega_{2^k}^-j for each pass
    size k; pre the strided passes' inverse four-step twiddles, one table
    after another, the last times 1/n."""
    ctx = get_ntt_context(log_n, device)
    plan = inverse_pass_plan(log_n)
    heap = torch.zeros(1 << MAX_LAST_PASS, dtype=torch.int64, device=ctx.itw.device)
    for k in set(plan):
        heap[1 << (k - 1) : 1 << k] = ctx.itw[:: 1 << (log_n - k)][: 1 << (k - 1)]
    pres, lo = [], plan[0]
    for i, k in enumerate(plan[1:], start=2):
        pre = _four_step_twiddles(ctx, lo, k, inverse=True)
        pres.append(gf.mul(pre, ctx.n_inv) if i == len(plan) else pre)
        lo += k
    pre = torch.cat(pres) if pres else heap[:1]
    return plan, heap, pre, K.int_array(plan), ctx.n_inv


def _forward_launch(name, src, scale, L, log_n, rows_out):
    dev = src.device
    plan, heap, post = _forward_tables(log_n, str(dev))
    out = torch.empty((rows_out, 1 << log_n), dtype=torch.int64, device=dev)
    lib = K.library("ntt")
    with torch.cuda.device(dev):
        K.count(name)
        K.check(
            lib.bt_ntt_forward(
                K.ptr(src), K.ptr(out), K.ptr(scale), L, K.ptr(heap), K.ptr(post),
                K.int_array(plan), len(plan), log_n, rows_out, K.stream(dev),
            ),
            name,
        )
    return out


def fft_natural_to_bitreversed(a: torch.Tensor, scale_row=None) -> torch.Tensor:
    """Forward NTT along the last axis, bit-reversed output (kernel B1).
    With `scale_row` (n words) every row is first multiplied by it, which
    evaluates monomials over one coset."""
    K.require(a, "fft input")
    n = a.shape[-1]
    log_n = _log2(n)
    if scale_row is not None:
        K.require(scale_row, "fft scale row", (n,))
        K.same_device(a, scale_row)
    dev = K.same_device(a)
    if dev.type == "cpu":
        return fft_plain(a, scale_row)
    rows = a.numel() // n
    out = _forward_launch(
        "ntt_forward", a.reshape(rows, n), scale_row, 1, log_n, rows
    )
    return out.reshape(a.shape)


def ifft_bitreversed_to_natural(a: torch.Tensor) -> torch.Tensor:
    """Inverse NTT along the last axis (bit-reversed in, natural out,
    times 1/n) (kernel B2, in the passes of `inverse_pass_plan`)."""
    K.require(a, "ifft input")
    n = a.shape[-1]
    log_n = _log2(n)
    dev = K.same_device(a)
    if dev.type == "cpu":
        return ifft_plain(a)
    rows = a.numel() // n
    plan, heap, pre, c_plan, n_inv = _inverse_tables(log_n, str(dev))
    # the first pass loads 16 bytes at a time
    src = a if a.data_ptr() % 16 == 0 else a.clone()
    out = torch.empty_like(a)
    lib = K.library("ntt")
    with torch.cuda.device(dev):
        K.count("ntt_inverse")
        K.check(
            lib.bt_ntt_inverse(
                K.ptr(src), K.ptr(out), K.ptr(heap), K.ptr(pre), c_plan, len(plan),
                log_n, rows, n_inv, K.stream(dev),
            ),
            "ntt_inverse",
        )
    return out


@lru_cache(maxsize=16)
def _lde_scale(log_n: int, lde_factor: int, device: str):
    """(lde, n) matrix of shift_j^i, rows in bit-reversed coset order."""
    n = 1 << log_n
    log_lde = _log2(lde_factor) if lde_factor > 1 else 0
    w_full = gl.omega(log_n + log_lde)
    shifts = [
        gl.mul(gl.MULTIPLICATIVE_GENERATOR, gl.pow_(w_full, j))
        for j in bitreverse_indices(log_lde).tolist()
    ]
    return torch.stack([gf.powers(s, n, device) for s in shifts])


def lde_scale_rows(log_n: int, lde_factor: int, device) -> torch.Tensor:
    """Row c scales monomials onto LDE coset c (bit-reversed coset order) of
    the domain g·<w_{n·lde_factor}>, g the multiplicative generator."""
    return _lde_scale(log_n, lde_factor, str(torch.device(device)))


def lde_from_monomial(coeffs: torch.Tensor, lde_factor: int) -> torch.Tensor:
    """Monomial rows (B, n) -> coset evaluations (B, lde_factor, n)
    (kernel B3: the coset scale is fused into the transform's first pass)."""
    K.require(coeffs, "lde coefficients")
    if coeffs.dim() != 2:
        raise ValueError("lde_from_monomial expects a (B, n) stack")
    B, n = coeffs.shape
    log_n = _log2(n)
    dev = K.same_device(coeffs)
    scale = lde_scale_rows(log_n, lde_factor, dev)
    if dev.type == "cpu":
        return lde_plain(coeffs, scale)
    out = _forward_launch("ntt_lde", coeffs, scale, lde_factor, log_n,
                          B * lde_factor)
    return out.reshape(B, lde_factor, n)


def clear_tables() -> None:
    """Drop the cached twiddle, coset-scale and pass tables, which hold device
    memory (a 2^23-point LDE into 8 cosets caches 640 MiB)."""
    for cached in (_ntt_context, _forward_tables, _inverse_tables, _lde_scale, _powers_dev):
        cached.cache_clear()


# ---------------------------------------------------------------------------
# Plain PyTorch helpers around the transforms
# ---------------------------------------------------------------------------


@lru_cache(maxsize=16)
def _powers_dev(base: int, count: int, device: str) -> torch.Tensor:
    return gf.powers(base, count, device)


def powers_device(base: int, count: int, device) -> torch.Tensor:
    """[1, b, ..., b^(count-1)] on a device (cached)."""
    return _powers_dev(int(base) % gl.P, count, str(torch.device(device)))


def distribute_powers(a: torch.Tensor, base: int) -> torch.Tensor:
    """a[..., i] *= base^i."""
    return gf.mul(a, powers_device(base, a.shape[-1], a.device))


def monomial_from_values(values: torch.Tensor) -> torch.Tensor:
    """Values over H in natural order -> monomial coefficients."""
    log_n = _log2(values.shape[-1])
    brev = bitreverse_indices(log_n, values.device)
    return ifft_bitreversed_to_natural(values[..., brev].contiguous())


def ext_powers_device(z, count: int, device):
    """[1, z, ..., z^(count-1)] of a host ext scalar as a tensor pair,
    by log-doubling on the device."""
    p0 = torch.ones(1, dtype=torch.int64, device=device)
    p1 = torch.zeros(1, dtype=torch.int64, device=device)
    step = (int(z[0]), int(z[1]))
    cur = 1
    while cur < count:
        n0, n1 = ext.mul((p0, p1), step)
        p0 = torch.cat([p0, n0])
        p1 = torch.cat([p1, n1])
        step = ext.sqr_s(step)
        cur *= 2
    return p0[:count], p1[:count]


def eval_monomial_at_ext_point(coeffs: torch.Tensor, z):
    """Evaluate base-field monomial rows (..., n) at the ext point z;
    returns an ext pair of shape (...)."""
    z_pows = ext_powers_device(z, coeffs.shape[-1], coeffs.device)
    return (gf.modsum(gf.mul(coeffs, z_pows[0])),
            gf.modsum(gf.mul(coeffs, z_pows[1])))
