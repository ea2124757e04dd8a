// Native LC-inlining engine: the constraint-synthesis hot loop in C++.
//
// The reference's biggest host-side pass is inline_all_lcs
// (relations/src/gr1cs/constraint_system.rs:717-758) — its two examples/
// bench*.rs exist to measure exactly this at 2^23 constraints. Python-level
// list manipulation caps that pass at ~10-20k rows/s; this engine runs the
// identical algorithm (single ordered pass, substitute symbolic-LC
// references with already-inlined rows, scale by the referencing
// coefficient, sort + merge per row) over the columnar CSR arrays with
// 4x64-bit Montgomery coefficient arithmetic.
//
// The port's copy holds the inline pass only.
//
// ABI (ctypes): plain C functions, caller-owned numpy buffers in, an opaque
// result handle out (two-phase fetch because output nnz is data-dependent).
//
// Variable encoding matches relations/variable.py: 3-bit tag in bits
// 63..61 of a u64; tag 4 = symbolic LC; payload = low 61 bits.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

typedef unsigned __int128 u128;

namespace {

struct Fp4 {
    uint64_t v[4];
};

struct FieldCtx {
    Fp4 p;        // modulus
    uint64_t np0; // -p^{-1} mod 2^64
    Fp4 r2;       // R^2 mod p, R = 2^256
    Fp4 one_m;    // R mod p (1 in Montgomery form)
};

inline bool geq(const Fp4 &a, const Fp4 &b) {
    for (int i = 3; i >= 0; --i) {
        if (a.v[i] != b.v[i]) return a.v[i] > b.v[i];
    }
    return true;
}

inline void sub_in_place(Fp4 &a, const Fp4 &b) {
    u128 borrow = 0;
    for (int i = 0; i < 4; ++i) {
        u128 d = (u128)a.v[i] - b.v[i] - borrow;
        a.v[i] = (uint64_t)d;
        borrow = (d >> 64) ? 1 : 0;
    }
}

inline void add_mod(Fp4 &a, const Fp4 &b, const FieldCtx &f) {
    u128 carry = 0;
    for (int i = 0; i < 4; ++i) {
        u128 s = (u128)a.v[i] + b.v[i] + carry;
        a.v[i] = (uint64_t)s;
        carry = s >> 64;
    }
    if (carry || geq(a, f.p)) sub_in_place(a, f.p);
}

// CIOS Montgomery multiplication, 4 limbs.
inline Fp4 mont_mul(const Fp4 &a, const Fp4 &b, const FieldCtx &f) {
    uint64_t t[6] = {0, 0, 0, 0, 0, 0};
    for (int i = 0; i < 4; ++i) {
        u128 carry = 0;
        for (int j = 0; j < 4; ++j) {
            u128 cur = (u128)t[j] + (u128)a.v[i] * b.v[j] + carry;
            t[j] = (uint64_t)cur;
            carry = cur >> 64;
        }
        u128 cur = (u128)t[4] + carry;
        t[4] = (uint64_t)cur;
        t[5] = (uint64_t)(cur >> 64);

        uint64_t m = t[0] * f.np0;
        carry = ((u128)t[0] + (u128)m * f.p.v[0]) >> 64;
        for (int j = 1; j < 4; ++j) {
            u128 c2 = (u128)t[j] + (u128)m * f.p.v[j] + carry;
            t[j - 1] = (uint64_t)c2;
            carry = c2 >> 64;
        }
        cur = (u128)t[4] + carry;
        t[3] = (uint64_t)cur;
        t[4] = t[5] + (uint64_t)(cur >> 64);
        t[5] = 0;
    }
    Fp4 r{{t[0], t[1], t[2], t[3]}};
    if (t[4] || geq(r, f.p)) sub_in_place(r, f.p);
    return r;
}

constexpr uint64_t TAG_SHIFT = 61;
constexpr uint64_t TAG_LC = 4;

inline bool is_lc(uint64_t var) { return (var >> TAG_SHIFT) == TAG_LC; }
inline uint64_t payload(uint64_t var) {
    return var & ((1ULL << TAG_SHIFT) - 1);
}

struct InlineResult {
    std::vector<int64_t> offsets;
    std::vector<uint64_t> vars;
    std::vector<Fp4> coeffs; // Montgomery form internally, canonical on fetch
};

struct Term {
    uint64_t var;
    Fp4 coeff;
};

} // namespace

extern "C" {

// Initialize a field context from the modulus (4x64 LE limbs).
void lc_field_init(FieldCtx *ctx, const uint64_t p[4]) {
    std::memcpy(ctx->p.v, p, 32);
    // np0 = -p^{-1} mod 2^64 via Newton iteration
    uint64_t inv = 1;
    for (int i = 0; i < 6; ++i) inv *= 2 - p[0] * inv;
    ctx->np0 = (uint64_t)(0 - inv);
    // r2 = (2^256)^2 mod p by repeated doubling: start with R mod p
    Fp4 r{{0, 0, 0, 0}};
    // R mod p: compute 2^256 mod p by doubling 1, 256 times
    Fp4 x{{1, 0, 0, 0}};
    for (int i = 0; i < 256; ++i) add_mod(x, x, *ctx);
    ctx->one_m = x; // R mod p
    r = x;
    for (int i = 0; i < 256; ++i) add_mod(r, r, *ctx);
    // r is now 2^512 mod p? No: doubling R mod p 256 times gives R*2^256
    // mod p = R^2 mod p. Correct.
    ctx->r2 = r;
}

// Run the inline pass.
//   n            number of LCs
//   offsets      (n+1) int64 CSR offsets
//   vars         (nnz) u64 variable handles
//   coeff_ids    (nnz) u32 interner ids
//   num_values   number of distinct coefficient values
//   values       (num_values x 4) u64 LE canonical coefficients
// Returns an opaque handle (or nullptr on error).
void *lc_inline_run(const FieldCtx *ctx, int64_t n, const int64_t *offsets,
                    const uint64_t *vars, const uint32_t *coeff_ids,
                    int64_t num_values, const uint64_t *values) {
    const FieldCtx &f = *ctx;
    // intern table -> Montgomery form
    std::vector<Fp4> vals_m((size_t)num_values);
    for (int64_t i = 0; i < num_values; ++i) {
        Fp4 v;
        std::memcpy(v.v, values + 4 * i, 32);
        vals_m[(size_t)i] = mont_mul(v, f.r2, f);
    }
    const Fp4 one_m = f.one_m;

    auto *res = new InlineResult();
    res->offsets.reserve((size_t)n + 1);
    res->offsets.push_back(0);
    res->vars.reserve((size_t)(offsets[n] * 2));
    res->coeffs.reserve((size_t)(offsets[n] * 2));

    std::vector<Term> out;
    for (int64_t i = 0; i < n; ++i) {
        out.clear();
        for (int64_t k = offsets[i]; k < offsets[i + 1]; ++k) {
            uint64_t var = vars[k];
            const Fp4 &c = vals_m[coeff_ids[k]];
            if (is_lc(var)) {
                // substitute the already-inlined row (index < i guaranteed)
                int64_t j = (int64_t)payload(var);
                int64_t s = res->offsets[(size_t)j];
                int64_t e = res->offsets[(size_t)j + 1];
                bool c_is_one =
                    std::memcmp(c.v, one_m.v, 32) == 0;
                for (int64_t t = s; t < e; ++t) {
                    if (c_is_one) {
                        out.push_back({res->vars[(size_t)t],
                                       res->coeffs[(size_t)t]});
                    } else {
                        uint64_t iv = res->vars[(size_t)t];
                        if (iv == 0) continue; // Zero variable
                        Fp4 scaled =
                            mont_mul(c, res->coeffs[(size_t)t], f);
                        out.push_back({iv, scaled});
                    }
                }
            } else {
                out.push_back({var, c});
            }
        }
        // compactify: sort by var, merge duplicates (mod-p addition)
        std::sort(out.begin(), out.end(),
                  [](const Term &a, const Term &b) { return a.var < b.var; });
        size_t start_nnz = res->vars.size();
        for (size_t k = 0; k < out.size();) {
            uint64_t v = out[k].var;
            Fp4 acc = out[k].coeff;
            size_t k2 = k + 1;
            while (k2 < out.size() && out[k2].var == v) {
                add_mod(acc, out[k2].coeff, f);
                ++k2;
            }
            res->vars.push_back(v);
            res->coeffs.push_back(acc);
            k = k2;
        }
        res->offsets.push_back((int64_t)res->vars.size());
        (void)start_nnz;
    }
    return res;
}

int64_t lc_inline_nnz(void *handle) {
    return (int64_t)((InlineResult *)handle)->vars.size();
}

// Fetch results; out_coeffs receives canonical (non-Montgomery) values.
void lc_inline_fetch(const FieldCtx *ctx, void *handle, int64_t *out_offsets,
                     uint64_t *out_vars, uint64_t *out_coeffs) {
    auto *res = (InlineResult *)handle;
    const FieldCtx &f = *ctx;
    std::memcpy(out_offsets, res->offsets.data(),
                res->offsets.size() * sizeof(int64_t));
    std::memcpy(out_vars, res->vars.data(),
                res->vars.size() * sizeof(uint64_t));
    Fp4 one{{1, 0, 0, 0}};
    for (size_t i = 0; i < res->coeffs.size(); ++i) {
        Fp4 canon = mont_mul(res->coeffs[i], one, f); // from Montgomery
        std::memcpy(out_coeffs + 4 * i, canon.v, 32);
    }
}

void lc_inline_free(void *handle) { delete (InlineResult *)handle; }

size_t lc_field_ctx_size() { return sizeof(FieldCtx); }
}
