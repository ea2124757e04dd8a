// PTX primitives of the field core (field.cuh, curve.cuh): the carry-chain
// instructions, one PTX integer instruction each on u32 words, and a load
// that is repeated at each use. The instructions with .cc write
// the carry flag (CC.CF); addc, subc and madc read it as carry in (subc as
// borrow in). A chain is a run of such calls with no other .cc instruction
// between them, so the carry passes from one word to the next in the flag
// and never through a general register. Every call is `asm volatile`: the
// compiler keeps the calls of a chain in their order.
//
// tests/test_torch_mont_chain.py models each primitive on Python integers
// (the flag included) and runs the core's sequences through that model.
#pragma once

#include <cstdint>

namespace snark {
namespace chain {

__device__ __forceinline__ uint32_t mul_lo(uint32_t a, uint32_t b) { return a * b; }

__device__ __forceinline__ uint32_t mul_hi(uint32_t a, uint32_t b) { return __umulhi(a, b); }

// r = a + b, carry out
__device__ __forceinline__ uint32_t add_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// r = a + b + carry, carry out
__device__ __forceinline__ uint32_t addc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// r = a + b + carry, the end of a chain (the caller's bound says nothing
// carries out, or that what carries out cancels an earlier borrow)
__device__ __forceinline__ uint32_t addc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// r = a - b, borrow out
__device__ __forceinline__ uint32_t sub_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// r = a - b - borrow, borrow out
__device__ __forceinline__ uint32_t subc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// 0 - 0 - borrow: all ones after a chain that borrowed out of its top
// word, else 0 (the end of a subtraction chain)
__device__ __forceinline__ uint32_t borrow_mask() {
  uint32_t r;
  asm volatile("subc.u32 %0, %1, %1;" : "=r"(r) : "r"(0u));
  return r;
}

// r = lo(a b) + c, carry out
__device__ __forceinline__ uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("mad.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}

// r = hi(a b) + c, carry out
__device__ __forceinline__ uint32_t mad_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("mad.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}

// r = lo(a b) + c + carry, carry out
__device__ __forceinline__ uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}

// r = hi(a b) + c + carry, carry out
__device__ __forceinline__ uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}

// r = hi(a b) + c + carry, the end of a chain (nothing carries out)
__device__ __forceinline__ uint32_t madc_hi(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.hi.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}

// 4 words at src (16-byte aligned), loaded anew at each call: asm volatile,
// so never merged with another load of the same words nor hoisted; through
// the read-only path (the data must not change while the kernel runs).
// What a kernel reads this way at each use it need not hold in registers.
__device__ __forceinline__ void load4_fresh(uint32_t* dst, const uint32_t* src) {
  asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(dst[0]), "=r"(dst[1]), "=r"(dst[2]), "=r"(dst[3])
               : "l"(src));
}

}  // namespace chain
}  // namespace snark
