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
// The port's copy holds the whole engine: the inline pass, the batched
// row evaluator (lc_eval_rows) and the seeded random-LC synthesizer
// (lc_synth_*), whose splitmix64 stream gives the same arrays as the
// repository's native/lc_engine.cpp for the same arguments.
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
#include <thread>

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

// Batched sparse-row dot products: evaluate each LC against an assignment
// (canonical 4x64 values), used by satisfiability checking at scale.
void lc_eval_rows(const FieldCtx *ctx, int64_t n, const int64_t *offsets,
                  const uint64_t *vars, const uint32_t *coeff_ids,
                  int64_t num_values, const uint64_t *values,
                  int64_t num_cols,
                  const uint64_t *assignment /* (num_cols x 4) by global
                  column index; caller maps entries to columns */,
                  const int64_t *var_to_col, uint64_t *out /* n x 4 */) {
    const FieldCtx &f = *ctx;
    (void)vars;
    std::vector<Fp4> vals_m((size_t)num_values);
    for (int64_t i = 0; i < num_values; ++i) {
        Fp4 v;
        std::memcpy(v.v, values + 4 * i, 32);
        vals_m[(size_t)i] = mont_mul(v, f.r2, f);
    }
    // pre-convert the assignment ONCE (the per-term conversion doubled
    // the Montgomery-mul count at 2^23 scale)
    std::vector<Fp4> asg_m((size_t)num_cols);
    for (int64_t i = 0; i < num_cols; ++i) {
        Fp4 v;
        std::memcpy(v.v, assignment + 4 * i, 32);
        asg_m[(size_t)i] = mont_mul(v, f.r2, f);
    }
    auto run_range = [&](int64_t lo, int64_t hi) {
        Fp4 one{{1, 0, 0, 0}};
        for (int64_t i = lo; i < hi; ++i) {
            Fp4 acc{{0, 0, 0, 0}};
            for (int64_t k = offsets[i]; k < offsets[i + 1]; ++k) {
                int64_t col = var_to_col[k];
                if (col < 0) continue; // Zero variable
                Fp4 prod = mont_mul(vals_m[coeff_ids[k]], asg_m[(size_t)col], f);
                add_mod(acc, prod, f);
            }
            // acc = sum(a*b*R); one extra reduction by ONE strips the R
            Fp4 canon = mont_mul(acc, one, f);
            std::memcpy(out + 4 * i, canon.v, 32);
        }
    };
    unsigned hw = std::thread::hardware_concurrency();
    int64_t nthreads = hw ? (int64_t)hw : 1;
    if (nthreads > 1 && n >= 4096) {
        std::vector<std::thread> ts;
        int64_t chunk = (n + nthreads - 1) / nthreads;
        for (int64_t t = 0; t < nthreads; ++t) {
            int64_t lo = t * chunk, hi = std::min(n, lo + chunk);
            if (lo < hi) ts.emplace_back(run_range, lo, hi);
        }
        for (auto &t : ts) t.join();
    } else {
        run_range(0, n);
    }
}

size_t lc_field_ctx_size() { return sizeof(FieldCtx); }
}

// ---------------------------------------------------------------------------
// Native random-LC synthesis (the bench.rs workload, relations/examples/
// bench.rs:85-109): n constraints x 3 argument LCs of 1..T random terms,
// coefficient interning through a real hash map, columnar CSR output
// (synthesis at 2^23 constraints).
// ---------------------------------------------------------------------------

namespace {

struct Fp4Hash {
    size_t operator()(const Fp4 &a) const {
        uint64_t h = 0x9e3779b97f4a7c15ULL;
        for (int i = 0; i < 4; ++i) {
            h ^= a.v[i] + 0x9e3779b97f4a7c15ULL + (h << 6) + (h >> 2);
        }
        return (size_t)h;
    }
};
struct Fp4Eq {
    bool operator()(const Fp4 &a, const Fp4 &b) const {
        return std::memcmp(a.v, b.v, 32) == 0;
    }
};

struct SynthResult {
    std::vector<int64_t> offsets;   // (num_lcs + 1)
    std::vector<uint64_t> vars;     // nnz
    std::vector<uint32_t> coeff_ids;
    std::vector<Fp4> values;        // interner table (canonical)
    std::vector<uint64_t> arg_vars; // 3n argument variables
};

inline uint64_t splitmix64(uint64_t &s) {
    uint64_t z = (s += 0x9e3779b97f4a7c15ULL);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
    return z ^ (z >> 31);
}

} // namespace


extern "C" {

// Synthesize n random R1CS constraints: per constraint 3 LCs with
// 1..terms random (coeff, witness-var) terms. lc_base / id_base offset the
// emitted symbolic-LC handles and interner ids past the caller's existing
// LC0 / pre-interned {1, -1}. Witness handles are tag-3 over [0, num_vars).
void *lc_synth_random(const FieldCtx *ctx, int64_t n, int32_t terms,
                      uint64_t seed, int64_t num_vars, int64_t lc_base,
                      int64_t id_base) {
    const FieldCtx &f = *ctx;
    auto *res = new SynthResult();
    res->offsets.reserve((size_t)(3 * n + 1));
    res->offsets.push_back(0);
    size_t est = (size_t)(3 * n) * (size_t)(terms / 2 + 1);
    res->vars.reserve(est);
    res->coeff_ids.reserve(est);
    res->arg_vars.reserve((size_t)(3 * n));
    // open-addressed interner (ark-relations uses IndexMap + foldhash for
    // the same reason: std::unordered_map's node allocations dominate)
    size_t cap = 1;
    while (cap < 2 * est) cap <<= 1;
    std::vector<uint32_t> slots(cap, 0xFFFFFFFFu);
    const size_t mask = cap - 1;
    uint64_t s = seed ^ 0xdeadbeefcafef00dULL;
    const uint64_t WITNESS_TAG = 3ULL << TAG_SHIFT;
    int64_t next_lc = lc_base;
    for (int64_t i = 0; i < n; ++i) {
        for (int a = 0; a < 3; ++a) {
            int k = 1 + (int)(splitmix64(s) % (uint64_t)terms);
            for (int t = 0; t < k; ++t) {
                Fp4 c{{splitmix64(s), splitmix64(s), splitmix64(s),
                       splitmix64(s)}};
                while (geq(c, f.p)) sub_in_place(c, f.p);
                if (!(c.v[0] | c.v[1] | c.v[2] | c.v[3])) c.v[0] = 1;
                size_t slot = Fp4Hash()(c) & mask;
                uint32_t id;
                for (;;) {
                    uint32_t cur = slots[slot];
                    if (cur == 0xFFFFFFFFu) {
                        id = (uint32_t)(id_base + (int64_t)res->values.size());
                        slots[slot] = (uint32_t)res->values.size();
                        res->values.push_back(c);
                        break;
                    }
                    if (Fp4Eq()(res->values[cur], c)) {
                        id = (uint32_t)(id_base + cur);
                        break;
                    }
                    slot = (slot + 1) & mask;
                }
                uint64_t var =
                    WITNESS_TAG | (splitmix64(s) % (uint64_t)num_vars);
                res->vars.push_back(var);
                res->coeff_ids.push_back(id);
            }
            // canonicalize exactly like new_lc_add_helper: a 1-term LC
            // with coefficient one is a passthrough (probability ~2^-254
            // here, but semantics matter)
            int64_t start = res->offsets.back();
            int64_t end = (int64_t)res->vars.size();
            bool passthrough = false;
            if (end - start == 1) {
                Fp4 one{{1, 0, 0, 0}};
                int64_t vid = res->coeff_ids[(size_t)start] - id_base;
                if (vid >= 0 &&
                    Fp4Eq()(res->values[(size_t)vid], one)) {
                    res->arg_vars.push_back(res->vars[(size_t)start]);
                    res->vars.pop_back();
                    res->coeff_ids.pop_back();
                    passthrough = true;
                }
            }
            if (!passthrough) {
                res->offsets.push_back(end);
                res->arg_vars.push_back((4ULL << TAG_SHIFT) |
                                        (uint64_t)next_lc);
                ++next_lc;
            }
        }
    }
    return res;
}

int64_t lc_synth_num_lcs(void *h) {
    return (int64_t)((SynthResult *)h)->offsets.size() - 1;
}
int64_t lc_synth_nnz(void *h) {
    return (int64_t)((SynthResult *)h)->vars.size();
}
int64_t lc_synth_num_values(void *h) {
    return (int64_t)((SynthResult *)h)->values.size();
}

void lc_synth_fetch(void *h, int64_t *offsets, uint64_t *vars,
                    uint32_t *coeff_ids, uint64_t *values,
                    uint64_t *arg_vars) {
    auto *res = (SynthResult *)h;
    std::memcpy(offsets, res->offsets.data(),
                res->offsets.size() * sizeof(int64_t));
    std::memcpy(vars, res->vars.data(), res->vars.size() * sizeof(uint64_t));
    std::memcpy(coeff_ids, res->coeff_ids.data(),
                res->coeff_ids.size() * sizeof(uint32_t));
    std::memcpy(values, res->values.data(), res->values.size() * 32);
    std::memcpy(arg_vars, res->arg_vars.data(),
                res->arg_vars.size() * sizeof(uint64_t));
}

void lc_synth_free(void *h) { delete (SynthResult *)h; }
}
