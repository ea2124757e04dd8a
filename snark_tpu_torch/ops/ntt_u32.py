"""The reference's legacy radix-2 NTT plan, on the port's kernels.

Counterpart of `snark_tpu/ops/ntt.py:37-151` (`NttPlan(params, n,
coset=True)`, `get_ntt_plan`): `fft`, `ifft`, `coset_fft`, `coset_ifft`
and `z_on_coset` over the domain of size n of a scalar field, natural
order in and out, Montgomery form, arkworks' conventions (out[i] = p(ω^i),
the coset over the field's multiplicative generator g). Elements keep the
reference's layout (..., n, L16): 16-bit limbs, or f32 digits under
SNARK_TPU_FIELD_IMPL=f32 (`fields.field_impl`); leading dimensions are a
batch of independent transforms. They are converted to the kernels' words
at the boundary (`fields/device.py` `to_words`; R is the same), and every
transform runs on `ops/ntt.py` `ntt_rows` (the rows bit-reversed, then K3
`ntt_pass` launches, one for n up to 2^11 and `pass_split`'s for more):

* fft: `ntt_rows` with the powers of ω;
* ifft: `ntt_rows` with the powers of ω^-1 and its 1/n scale (K4);
* coset_fft: the scale by g^i (K4 `field_ew`), then fft;
* coset_ifft: the inverse transform without its 1/n, then one K4 product
  by g^-i / n (the reference's 1/n and coset unscale in one).
"""

from __future__ import annotations

import functools

import torch

from ..fields import field_impl, get_compute_field
from ..fields.limbs import field_of
from ..fields.params import FieldParams
from .ntt import _powers, field_ew, ntt_rows


class NttPlan:
    """Twiddles and coset vectors of one (field, n) pair on one device."""

    def __init__(self, params: FieldParams, n: int, coset: bool = True, device="cuda"):
        if n < 2 or n & (n - 1):
            raise ValueError(f"n = {n} is not a power of two >= 2")
        self.params = params
        self.n = n
        self.log_n = n.bit_length() - 1
        self.device = torch.device(device)
        self.df = get_compute_field(params, device, field_impl())
        f = self.field = field_of(params)
        p = params.modulus
        omega = params.root_of_unity(n)
        self.fwd_tw = f.tensor(_powers(omega, n // 2, p), device)
        self.inv_tw = f.tensor(_powers(pow(omega, -1, p), n // 2, p), device)
        self.n_inv = f.const(pow(n, -1, p), device)
        if coset:
            g = params.generator
            self.coset_scale = f.tensor(_powers(g, n, p), device)  # g^i
            # g^-i / n: the inverse transform's 1/n and the unscale
            self.coset_unscale_n = f.tensor(_powers(pow(g, -1, p), n, p, pow(n, -1, p)), device)
        else:
            self.coset_scale = self.coset_unscale_n = None

    # ----- on the kernels' words: (B·n, L), B a power of two -----------------
    def _rows(self, table: torch.Tensor, rows: int) -> torch.Tensor:
        return table if rows == 1 else table.repeat(rows, 1)

    def fft_words(self, x: torch.Tensor) -> torch.Tensor:
        return ntt_rows(x, self.n, self.fwd_tw, field=self.field)

    def ifft_words(self, x: torch.Tensor, scale: bool = True) -> torch.Tensor:
        return ntt_rows(x, self.n, self.inv_tw, self.n_inv if scale else None, self.field)

    def coset_fft_words(self, x: torch.Tensor) -> torch.Tensor:
        scale = self._rows(self.coset_scale, x.shape[0] // self.n)
        return self.fft_words(field_ew("mul", x, scale, field=self.field))

    def coset_ifft_words(self, x: torch.Tensor) -> torch.Tensor:
        unscale = self._rows(self.coset_unscale_n, x.shape[0] // self.n)
        return field_ew("mul", self.ifft_words(x, scale=False), unscale, field=self.field)

    # ----- the reference's layout ------------------------------------------
    def _apply(self, fn, x: torch.Tensor) -> torch.Tensor:
        """fn on the words of x's rows, the batch padded with zero rows to a
        power of two (K3 takes a power-of-two vector)."""
        if x.shape[-2] != self.n:
            raise ValueError(f"want (..., {self.n}, L), got {tuple(x.shape)}")
        w = self.df.to_words(x.reshape(-1, x.shape[-1]))
        rows = w.shape[0] // self.n
        pad = (1 << (rows - 1).bit_length()) - rows
        if pad:
            w = torch.cat([w, w.new_zeros((pad * self.n, w.shape[1]))])
        y = fn(w.contiguous())[: rows * self.n]
        return self.df.from_words(y).reshape(x.shape)

    def fft(self, coeffs: torch.Tensor) -> torch.Tensor:
        """Evaluations over H in natural order: out[i] = p(ω^i)."""
        return self._apply(self.fft_words, coeffs)

    def ifft(self, evals: torch.Tensor) -> torch.Tensor:
        return self._apply(self.ifft_words, evals)

    def coset_fft(self, coeffs: torch.Tensor) -> torch.Tensor:
        """Evaluations over g·H (arkworks `coset_fft`)."""
        return self._apply(self.coset_fft_words, coeffs)

    def coset_ifft(self, evals: torch.Tensor) -> torch.Tensor:
        return self._apply(self.coset_ifft_words, evals)

    def z_on_coset(self) -> int:
        """Z_H(g) = g^n − 1, the vanishing polynomial on the coset (the same
        at every point of g·H)."""
        p = self.params.modulus
        return (pow(self.params.generator, self.n, p) - 1) % p


@functools.lru_cache(maxsize=None)
def _plan(params: FieldParams, n: int, coset: bool, device: str, impl: str) -> NttPlan:
    return NttPlan(params, n, coset, device)


def get_ntt_plan(params: FieldParams, n: int, coset: bool = True, device="cuda") -> NttPlan:
    """One plan per field, size, device and field layout."""
    return _plan(params, n, coset, str(torch.device(device)), field_impl())
