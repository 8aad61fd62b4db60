/* float32 pow as XLA's CPU backend computes it: a call to the C library's
 * powf for each element (XLA lowers its power op to llvm.pow.f32, which
 * resolves to powf).  Built without -march=native and without fast-math,
 * so that the compiler keeps the scalar powf and does not substitute a
 * vector library's. */
#include <math.h>
#include <stdint.h>

void powf_array(const float* x, int64_t n, float e, float* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = powf(x[i], e);
}
