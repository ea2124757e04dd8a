"""The setup's QAP instance map on the device: the values of every
variable's u, v and w polynomials at the toxic τ.

Counterpart of the JAX package's `groth16/qap_device.py` (`powers_device`,
`batch_inverse_device`, `lagrange_coeffs_device`, `_coo_eval`,
`evaluate_uvw_device`, `combine_uvw_device`; `from_mont_chunked` is
`ops/ntt.py` `from_mont`), with the same values. Elements are (n, L) int32
limbs of a scalar field in the port's format (`fields/limbs.py`:
Montgomery, R = 2^256, canonical). Every product and sum of a vector is a
K4 (`ops/ntt.py` `field_ew`) launch; the one subtraction, τ − ω^j, runs
as word ops. The reference's masked Hillis-Steele scans were a choice for
XLA's compiler; here the powers double (x[2^k : 2^(k+1)] = x[:2^k] ·
base^(2^k)), the batch inverse is a product tree, and a column's sum is
a tree over that column's entries alone.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields.limbs import Field, from_words, sub_words, to_words
from ..ops.msm_affine import tree_inverse
from ..ops.ntt import field_ew
from .qap import domain_size_for


def powers_device(field: Field, base: int, n: int, device, scale: int = 1) -> torch.Tensor:
    """(scale·base^j) for j < n -> (n, L) Montgomery limbs: ceil(log2 n)
    K4 products, each doubling the vector."""
    p = field.p
    x = field.tensor([scale % p], device)
    step = base % p
    while x.shape[0] < n:
        x = torch.cat([x, field_ew("mul", x, field.const(step, device), field=field)])
        step = step * step % p
    return x[:n]


def batch_inverse(x: torch.Tensor, field: Field) -> torch.Tensor:
    """Inverses of (n, L) nonzero Montgomery elements: `tree_inverse` on
    K4 products, the root inverted on the host. 3·ceil(log2 n) K4
    launches."""

    def inv_root(r):
        (root,) = field.decode(r)
        if root == 0:
            raise ZeroDivisionError("batch_inverse of a vector that holds zero")
        return field.tensor([pow(root, -1, field.p)], r.device)

    return tree_inverse(x, lambda a, b: field_ew("mul", a, b, field=field), inv_root,
                        field.tensor([1], x.device))


def lagrange_coeffs_device(field: Field, n: int, tau: int, device) -> torch.Tensor:
    """L_j(τ) = (Z(τ)/n)·ω^j/(τ − ω^j) over the radix-2 domain of size n ->
    (n, L) Montgomery limbs. Where τ lies on the domain (Z(τ) = 0), the
    closed form L_j(τ) = [ω^j = τ], as the reference's host path gives."""
    p = field.p
    pows = powers_device(field, field.params.root_of_unity(n), n, device)
    tau_m = field.const(tau % p, device)
    z_tau = (pow(tau, n, p) - 1) % p
    if z_tau == 0:
        hit = (pows == tau_m).all(dim=1)
        return torch.where(hit[:, None], field.const(1, device), torch.zeros_like(pows))
    diffs = from_words(sub_words(to_words(tau_m).expand(n, -1), to_words(pows), field)).contiguous()
    zn = field.const(z_tau * pow(n, -1, p) % p, device)
    return field_ew("mul", field_ew("mul", pows, zn, field=field), batch_inverse(diffs, field),
                    field=field)


def segment_sums(field: Field, x: torch.Tensor, seg: np.ndarray, num_segments: int) -> torch.Tensor:
    """Sums of (nnz, L) elements per segment, the segments given by the
    sorted (nnz,) ints seg -> (num_segments, L), zero where a segment has
    no entry. A tree within each segment: at stride s, the entry at
    offset o ≡ 0 (mod 2s) absorbs the one at o + s (one K4 add over those
    entries alone); ceil(log2) of the longest segment's length steps."""
    nnz = len(seg)
    first = np.searchsorted(seg, seg, side="left")
    seg_len = np.searchsorted(seg, seg, side="right") - first
    off = np.arange(nnz, dtype=np.int64) - first
    x = x.clone()
    s = 1
    while nnz and s < int(seg_len.max()):
        at = np.nonzero((off % (2 * s) == 0) & (off + s < seg_len))[0]
        at_t = torch.as_tensor(at, device=x.device)
        x[at_t] = field_ew("add", x[at_t], x[at_t + s], field=field)
        s *= 2
    out = torch.zeros((num_segments, field.limbs), dtype=torch.int32, device=x.device)
    starts = np.nonzero(off == 0)[0]
    out[torch.as_tensor(seg[starts], device=x.device)] = x[torch.as_tensor(starts, device=x.device)]
    return out


def coo_eval(field: Field, values_m, indptr, col, cid, lag, num_vars: int) -> torch.Tensor:
    """Σ over a matrix's entries of values[cid]·lag[row], per column ->
    (num_vars, L): one K4 product over the entries, then the column sums."""
    nnz = len(col)
    if nnz == 0:
        return torch.zeros((num_vars, field.limbs), dtype=torch.int32, device=lag.device)
    rows = np.repeat(np.arange(len(indptr) - 1, dtype=np.int64), np.diff(indptr))
    order = np.argsort(col, kind="stable")
    dev = lag.device
    contrib = field_ew(
        "mul",
        values_m[torch.as_tensor(np.asarray(cid, np.int64)[order], device=dev)],
        lag[torch.as_tensor(rows[order], device=dev)],
        field=field,
    )
    return segment_sums(field, contrib, np.asarray(col, np.int64)[order], num_vars)


def evaluate_uvw_device(field: Field, coo_abc, values: list[int], num_constraints: int,
                        num_instance: int, num_variables: int, tau: int, device):
    """(u_i(τ), v_i(τ), w_i(τ)) per variable as (m, L) Montgomery limbs,
    and Z(τ) as a host int. coo_abc is a circuit's [(indptr, col, cid)]
    for A, B, C and values its interner (id len(values) the literal
    zero). u includes the input-consistency rows of the libsnark
    reduction: A gets row num_constraints + i with a 1 at column i."""
    n = domain_size_for(num_constraints, num_instance)
    lag = lagrange_coeffs_device(field, n, tau, device)
    values_m = field.tensor(list(values) + [0], device)
    uvw = []
    for mi, (indptr, col, cid) in enumerate(coo_abc):
        if mi == 0:
            indptr = np.concatenate([indptr, indptr[-1] + 1 + np.arange(num_instance)])
            col = np.concatenate([col, np.arange(num_instance, dtype=np.int32)])
            cid = np.concatenate([cid, np.zeros(num_instance, np.int32)])  # id 0: ONE
        uvw.append(coo_eval(field, values_m, indptr, col, cid, lag, num_variables))
    z_tau = (pow(tau, n, field.p) - 1) % field.p
    return uvw[0], uvw[1], uvw[2], z_tau


def combine_uvw_device(field: Field, u, v, w, beta: int, alpha: int, gamma_inv: int,
                       delta_inv: int, num_instance: int):
    """s = β·u + α·v + w -> (s[:ni]·γ⁻¹ for gamma_abc, s[ni:]·δ⁻¹ for l)."""
    dev = u.device

    def mul(x, c):
        return field_ew("mul", x, field.const(c, dev), field=field)

    s = field_ew("add", field_ew("add", mul(u, beta), mul(v, alpha), field=field), w,
                 field=field)
    return mul(s[:num_instance], gamma_inv), mul(s[num_instance:], delta_inv)
