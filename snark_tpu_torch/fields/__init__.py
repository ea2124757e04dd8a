"""Field arithmetic: parameters, host mirror, torch limb fields, towers."""

from .params import (
    BN254,
    BN254_FQ,
    BN254_FR,
    BLS12_381,
    BLS12_381_FQ,
    BLS12_381_FR,
    LIMB_BITS,
    LIMB_MASK,
    CurveParams,
    FieldParams,
    get_curve,
    get_field,
)
from .host import Fp, FpElem
from .towers import Fq2, Fq6, Fq12, make_tower


def field_impl() -> str:
    """The field layout of the legacy device API (`ops/curve_u32.py`,
    `ops/msm_u32.py`, `ops/ntt_u32.py`), read as the reference reads it:
    SNARK_TPU_FIELD_IMPL, "u32" unless it says "f32"."""
    import os

    return "u32" if os.environ.get("SNARK_TPU_FIELD_IMPL", "u32") == "u32" else "f32"


def get_compute_field(params: FieldParams, device="cuda", impl: str = "u32"):
    """The torch field layer for `params` on `device`, one of the
    reference's two interchangeable backends (which it picks with the
    SNARK_TPU_FIELD_IMPL variable; the port takes the choice as an
    argument): "u32" (the default) gives `fields/device.py` `DeviceField`
    (16-bit limbs in int32 lanes), "f32" `fields/device_f32.py`
    `DeviceFieldF32` (base-2^8 digits in float32). Each getter keeps one
    object per field and device."""
    if impl == "u32":
        from .device import get_device_field

        return get_device_field(params, device)
    if impl == "f32":
        from .device_f32 import get_device_field_f32

        return get_device_field_f32(params, device)
    raise ValueError(f"no field implementation {impl!r}: choose 'u32' or 'f32'")


__all__ = [
    "BN254",
    "BN254_FQ",
    "BN254_FR",
    "BLS12_381",
    "BLS12_381_FQ",
    "BLS12_381_FR",
    "LIMB_BITS",
    "LIMB_MASK",
    "CurveParams",
    "FieldParams",
    "Fp",
    "FpElem",
    "Fq2",
    "Fq6",
    "Fq12",
    "get_compute_field",
    "get_curve",
    "field_impl",
    "get_field",
    "make_tower",
]
