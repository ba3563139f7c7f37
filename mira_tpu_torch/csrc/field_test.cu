// Test entry point for field.cuh: applies one field or curve operation
// elementwise, so the header can be held against the plain torch arithmetic
// (fields/limbs.py, curves/torch_curve.py) on the card.
#include <cuda_runtime.h>

#include "field.cuh"

using namespace mira;

enum { OP_MUL = 0, OP_ADD = 1, OP_SUB = 2, OP_INV = 3, OP_JAC_ADD = 4,
       OP_JAC_DOUBLE = 5, OP_XYZZ_MADD = 6 };

template <class F>
__global__ void field_test_kernel(int op, int n, const uint32_t* a,
                                  const uint32_t* b, uint32_t* out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (op <= OP_INV) {
    fe x = fe_load(a + 8 * i);
    fe y = fe_load(b + 8 * i);
    fe r;
    if (op == OP_MUL) r = fe_mul<F>(x, y);
    else if (op == OP_ADD) r = fe_add<F>(x, y);
    else if (op == OP_SUB) r = fe_sub<F>(x, y);
    else r = fe_inv<F>(x);
    fe_store(out + 8 * i, r);
    return;
  }
  // points: (n, 3, 8) Jacobian words
  jac p, q;
  p.X = fe_load(a + 24 * i);
  p.Y = fe_load(a + 24 * i + 8);
  p.Z = fe_load(a + 24 * i + 16);
  q.X = fe_load(b + 24 * i);
  q.Y = fe_load(b + 24 * i + 8);
  q.Z = fe_load(b + 24 * i + 16);
  jac r;
  if (op == OP_JAC_ADD) {
    r = jac_add<F>(p, q);
  } else if (op == OP_JAC_DOUBLE) {
    r = jac_double<F>(p);
  } else {
    // XYZZ path: p (Z in {0, 1}) as XYZZ, plus q's affine (X, Y) when q.Z
    // is nonzero; exercised with p == q and p == -q by the caller
    xyzz acc = xyzz_identity<F>();
    if (!fe_is_zero(p.Z)) xyzz_madd<F>(acc, p.X, p.Y);
    if (!fe_is_zero(q.Z)) xyzz_madd<F>(acc, q.X, q.Y);
    xyzz d = xyzz_add<F>(acc, xyzz_double<F>(acc));  // 3 * acc
    r = xyzz_to_jac<F>(d);
  }
  fe_store(out + 24 * i, r.X);
  fe_store(out + 24 * i + 8, r.Y);
  fe_store(out + 24 * i + 16, r.Z);
}

extern "C" int mira_field_test(int field, int op, int n, const void* a,
                               const void* b, void* out, void* stream) {
  if (n <= 0) return 0;
  int threads = 128;
  int blocks = (n + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
  if (field == 0)
    field_test_kernel<Fq><<<blocks, threads, 0, s>>>(
        op, n, (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out);
  else
    field_test_kernel<Fr><<<blocks, threads, 0, s>>>(
        op, n, (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out);
  return (int)cudaGetLastError();
}
