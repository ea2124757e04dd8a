"""Port field core (`snark_tpu_torch/fields/limbs.py`, `csrc/field.cuh`)
against the JAX package's field core, plus the port's import guard.

Inputs come from numpy seeds and go through both packages; results are
compared exactly as integers mod p.
"""

import ast
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from snark_tpu.fields import BN254 as J_BN254
from snark_tpu.fields.host import Fp
from snark_tpu.ops.pallas_field_v3 import get_plane_field_v3, make_mont_mul_v3, sweep3

from snark_tpu_torch.fields.limbs import (
    FQ,
    FR,
    add_plain,
    mont_mul_plain,
    pack16_to_u32,
    sub_plain,
)
from snark_tpu_torch.fields.params import BN254

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "snark_tpu_torch")
FIELDS = {"fr": (J_BN254.fr, FR), "fq": (J_BN254.fq, FQ)}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Keep the plain versions' thread pool small beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def rand_vals(p, n, seed):
    rng = np.random.RandomState(seed)
    return [int.from_bytes(rng.bytes(64), "little") % p for _ in range(n)]


def jax_mont_mul(params, av, bv):
    f = Fp(params)
    mm = make_mont_mul_v3(params, tile=128, interpret=True)
    out = mm(jnp.asarray(f.to_mont_limbs_array(av)), jnp.asarray(f.to_mont_limbs_array(bv)))
    return f.from_mont_limbs_array(np.asarray(out))


def port_mont_mul(field, av, bv):
    return field.decode(mont_mul_plain(field.tensor(av, "cpu"), field.tensor(bv, "cpu"), field))


@pytest.mark.parametrize("name", list(FIELDS))
def test_mont_mul_matches_jax(name):
    params, field = FIELDS[name]
    av, bv = rand_vals(params.modulus, 128, 1), rand_vals(params.modulus, 128, 2)
    got = port_mont_mul(field, av, bv)
    assert got == jax_mont_mul(params, av, bv)
    assert got == [a * b % params.modulus for a, b in zip(av, bv)]


@pytest.mark.parametrize("name", list(FIELDS))
def test_mont_mul_edge_values(name):
    params, field = FIELDS[name]
    p = params.modulus
    av = [0, 1, p - 1, p - 1, 1, 2**255 % p, (p - 1) // 2]
    bv = [5, 1, p - 1, 1, p - 1, 2**255 % p, 2]
    av += [0] * (128 - len(av))
    bv += [0] * (128 - len(bv))
    got = port_mont_mul(field, av, bv)
    assert got == jax_mont_mul(params, av, bv)
    assert got == [a * b % p for a, b in zip(av, bv)]


def test_lazy_composition_chain():
    """mul -> add -> sub -> mul, as the JAX package's lazy plane chain
    (tests/test_pallas_v3.py); the port keeps every value reduced."""
    params = J_BN254.fr
    p = params.modulus
    pf = get_plane_field_v3(params)
    n = 64
    av, bv, cv = (rand_vals(p, n, s) for s in (3, 4, 5))
    f = Fp(params)

    def planes(vals):
        limbs = f.to_mont_limbs_array(vals)
        lo = (limbs & 0xFF).astype(np.float32)
        hi = ((limbs >> 8) & 0xFF).astype(np.float32)
        return jnp.asarray(np.stack([lo, hi], -1).reshape(n, pf.R8).T)

    class Ref:
        def __init__(self, shape):
            self.a = np.zeros(shape, np.float32)
            self.shape = shape

        def __getitem__(self, k):
            return jnp.array(self.a[k])

        def __setitem__(self, k, v):
            self.a[k] = np.asarray(v)

    A, B, C = (planes(v) for v in (av, bv, cv))
    t_ref = Ref((2 * pf.R8, n))
    cs = jnp.asarray(pf.CARRY_SCALE)
    x = pf.mont_mul(A, B, t_ref, cs)
    z = sweep3(pf.sub(pf.add(x, C), B, jnp.asarray(pf.P2_COL)))
    w = np.asarray(pf.mont_mul(z, A, t_ref, cs), dtype=np.int64)
    rinv = pow(params.r, -1, p)
    jax_out = [
        int(sum(int(d) << (8 * i) for i, d in enumerate(col))) * rinv % p for col in w.T
    ]

    a, b, c = (FR.tensor(v, "cpu") for v in (av, bv, cv))
    port = mont_mul_plain(sub_plain(add_plain(mont_mul_plain(a, b, FR), c, FR), b, FR), a, FR)
    assert FR.decode(port) == jax_out == [((x * y + z - y) * x) % p for x, y, z in zip(av, bv, cv)]
    # the port's values are canonical limbs (< p), not lazy representatives
    raw = FR.decode(port, mont=False)
    assert all(v < p for v in raw)


@pytest.mark.parametrize("name", list(FIELDS))
def test_add_sub_wraparound(name):
    params, field = FIELDS[name]
    p = params.modulus
    av = [0, p - 1, p - 1, 1, 0] + rand_vals(p, 59, 6)
    bv = [0, 1, p - 1, p - 1, p - 1] + rand_vals(p, 59, 7)
    a, b = field.tensor(av, "cpu"), field.tensor(bv, "cpu")
    assert field.decode(add_plain(a, b, field)) == [(x + y) % p for x, y in zip(av, bv)]
    assert field.decode(sub_plain(a, b, field)) == [(x - y) % p for x, y in zip(av, bv)]


@pytest.mark.parametrize("impl", ["u32", "f32"])
def test_get_compute_field_backends(impl):
    """`get_compute_field` gives each backend's cached field, and both
    cube the same values as the host field; an unknown name raises."""
    from snark_tpu_torch.fields import get_compute_field
    from snark_tpu_torch.fields.device import get_device_field
    from snark_tpu_torch.fields.device_f32 import get_device_field_f32

    getter = {"u32": get_device_field, "f32": get_device_field_f32}[impl]
    field = get_compute_field(BN254.fr, "cpu", impl)
    assert field is getter(BN254.fr, "cpu")
    p = J_BN254.fr.modulus
    vals = [0, 1, p - 1] + rand_vals(p, 13, 8)
    assert field.to_host_ints(field.pow_const(field.array(vals), 3)) == [pow(v, 3, p) for v in vals]
    with pytest.raises(ValueError, match="no field implementation"):
        get_compute_field(BN254.fr, "cpu", "u16")


def test_csr_limb_repack_matches_jax():
    """The reference's 16-bit-limb Montgomery coefficients (R = 2^256) are
    the port's limbs after a repack, with no change of value."""
    f = Fp(J_BN254.fr)
    vals = rand_vals(J_BN254.fr.modulus, 32, 8)
    packed = pack16_to_u32(f.to_mont_limbs_array(vals))
    assert np.array_equal(packed, FR.encode(vals))
    assert FR.decode(packed) == vals


def _cuda_constants():
    src = ""
    for name in sorted(os.listdir(os.path.join(PORT, "csrc"))):
        with open(os.path.join(PORT, "csrc", name)) as fh:
            src += fh.read()

    def array(name):
        body = re.search(name + r"\[\d+\] = \{([^}]*)\}", src).group(1)
        words = [int(w.strip().rstrip("u"), 16) for w in body.split(",") if w.strip()]
        return sum(w << (32 * i) for i, w in enumerate(words[:8])), words

    def scalar(struct):
        block = src[src.index("struct " + struct) :]
        return int(re.search(r"kN0 = (0x[0-9a-f]+)u", block).group(1), 16)

    return array, scalar


def _curve_consts_block(params):
    """The body of curve.cuh's CurveConsts<params> specialisation."""
    with open(os.path.join(PORT, "csrc", "curve.cuh")) as fh:
        src = fh.read()
    block = src[src.index(f"struct CurveConsts<{params}> {{") :]
    return block[: block.index("};")]


def test_cuda_constants_match_params():
    array, scalar = _cuda_constants()
    r, q = BN254.fr.modulus, BN254.fq.modulus
    assert array("kFrP")[0] == r and array("kFqP")[0] == q
    assert scalar("FrParams") == FR.n0 and scalar("FqParams") == FQ.n0
    assert array("kFqP2")[0] == 2 * q  # the lazy bound of Fq
    assert array("kMontToRow")[0] == (1 << 272) % q
    assert array("kOneMont")[0] == FQ.one
    assert array("kQMinus2")[0] == q - 2
    # G1's 3b is an integer the kernels multiply by with additions
    consts = _curve_consts_block("FqParams")
    assert int(re.search(r"kB3G1 = (\d+);", consts).group(1)) == 3 * BN254.b
    assert "kB3G2Small = false;" in consts
    words = array("kB3G2")[1]
    b3 = [sum(w << (32 * i) for i, w in enumerate(words[8 * c : 8 * c + 8])) for c in (0, 1)]
    assert b3 == [FQ.to_mont(3 * v) for v in BN254.b2]


def _port_sources():
    for dirpath, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")
    yield os.path.join(ROOT, "tests", "test_torch_prove_small.py")  # chip_smoke.py imports it


def test_port_imports_no_jax():
    """No module of the port, and neither chip_smoke.py nor the test module
    it imports, imports jax or the JAX package; the walk reaches every module, the field layer, K9-K17,
    bench_field, bench_vpu_peak, bench_reduce_parts, bench_bisect_mul, the
    relations layer, the circuits, the utilities, the SNARK trait layer,
    the batched prover, the configuration runner, the legacy device API
    (curve, MSM and NTT plans, the witness map, the legacy distributed MSM
    and NTT), configuration 4's single-card modules, the entry, the
    profilers, the remaining scripts and the examples among them."""
    walked = {os.path.relpath(path, ROOT) for path in _port_sources()}
    relations = ("__init__", "assignment", "constraint_system", "constraint_system_ref",
                 "error", "field_interner", "gadgets", "instance_outliner", "lc_map",
                 "linear_combination", "matrix", "native", "predicate", "sr1cs", "trace",
                 "variable")
    for mod in ("fields/device.py", "fields/device_f32.py", "ops/mont16.py", "ops/curve.py",
                "bench_field.py", "ops/plane_field_v3.py", "ops/vpu_peak.py",
                "bench_vpu_peak.py", "ops/mul_parts.py", "bench_reduce_parts.py",
                "bench_bisect_mul.py", *(f"relations/{m}.py" for m in relations),
                "models/__init__.py", "models/circuits.py", "utils/__init__.py",
                "utils/rng.py", "utils/timing.py", "fields/__init__.py", "snark/__init__.py",
                "snark/api.py", "snark/universal.py", "snark/serialize.py",
                "groth16/groth16.py", "parallel/__init__.py", "parallel/batch.py",
                "run_configs.py", "parallel/mesh.py", "parallel/launch.py",
                "parallel/plane_dist.py", "dryrun.py", "ops/__init__.py", "ops/curve_u32.py",
                "ops/msm_u32.py", "ops/ntt_u32.py", "groth16/qap.py", "groth16/__init__.py",
                "parallel/dist_msm.py", "parallel/dist_ntt.py", "config4_e2e.py",
                "config4_shards.py", "entry.py", "toolkit.py", "profile_setup.py",
                "profile_msm.py", "profile_scan_parts.py", "profile_affine_stages.py",
                "profile_affine_front.py", "profile_prover_msms.py", "bench_affine_msm.py",
                "bench_scan_overlap.py", "bench_gather.py", "bench_synth.py", "run_suite.py",
                "gen_vectors.py", "examples/__init__.py", "examples/satisfiable.py",
                "examples/non_satisfiable.py", "examples/bench_synthesis.py"):
        assert os.path.join("snark_tpu_torch", mod) in walked, mod
    bad = []
    for path in _port_sources():
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                if name.split(".")[0] in ("jax", "jaxlib", "snark_tpu"):
                    bad.append(f"{os.path.relpath(path, ROOT)}: {name}")
    assert not bad, bad
