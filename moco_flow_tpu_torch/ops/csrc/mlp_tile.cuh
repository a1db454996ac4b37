// The NoF head's warp and its VJP on one sample, shared by the warp kernels
// of chain_bwd.cu (#3-#6): the log-quaternion transform of _nof_quat_fwd_t /
// _nof_quat_bwd_t, or the offset head. Elementwise steps use explicitly
// rounded intrinsics (__fadd_rn, __fmul_rn) so nvcc cannot contract them
// into FMAs, and sin/cos are full precision: a 1-ulp change of a warped
// position grows 512-fold through the top NeRF PE band.

#pragma once

#include <cuda_runtime.h>

namespace mlp {

__device__ __forceinline__ void cross3(const float* a, const float* b,
                                       float* o) {
  o[0] = __fsub_rn(__fmul_rn(a[1], b[2]), __fmul_rn(a[2], b[1]));
  o[1] = __fsub_rn(__fmul_rn(a[2], b[0]), __fmul_rn(a[0], b[2]));
  o[2] = __fsub_rn(__fmul_rn(a[0], b[1]), __fmul_rn(a[1], b[0]));
}

// The quaternion transform's scalars: theta = sqrt(|v|^2 + eps^2), w =
// cos(theta), k = sin(theta) / theta, qv = -v k (_nof_quat_fwd_t).
__device__ __forceinline__ void quat_scalars(const float* v, float* theta,
                                             float* w, float* k, float* qv) {
  const float th2 = __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(v[0], v[0]), __fmul_rn(v[1], v[1])),
                __fmul_rn(v[2], v[2])),
      1e-16f);
  *theta = sqrtf(th2);
  *w = cosf(*theta);
  *k = __fdiv_rn(sinf(*theta), *theta);
  for (int j = 0; j < 3; ++j) qv[j] = __fmul_rn(-v[j], *k);
}

// warped = d + 2 qv x t1 + s + t, d = x - s, t1 = qv x d + w d; or x + o
inline __device__ void head_apply(const float* o, bool use_quat, const float* x,
                           float* out) {
  if (!use_quat) {
    for (int j = 0; j < 3; ++j) out[j] = __fadd_rn(o[j], x[j]);
    return;
  }
  float d[3], qv[3], c1[3], t1[3], c2[3], theta, w, k;
  for (int j = 0; j < 3; ++j) d[j] = __fsub_rn(x[j], o[3 + j]);
  quat_scalars(o, &theta, &w, &k, qv);
  cross3(qv, d, c1);
  for (int j = 0; j < 3; ++j) t1[j] = __fadd_rn(c1[j], __fmul_rn(w, d[j]));
  cross3(qv, t1, c2);
  for (int j = 0; j < 3; ++j)
    out[j] = __fadd_rn(__fadd_rn(__fadd_rn(d[j], __fmul_rn(2.f, c2[j])),
                                 o[3 + j]),
                       o[6 + j]);
}

// _nof_quat_bwd_t on one sample: cotangent g of the warped position ->
// dout (9: dv, ds, dt) and dx; o = [v, s, t] is the head output.
inline __device__ void head_vjp(const float* o, bool use_quat, const float* x,
                         const float* g, float* dout, float* dx) {
  if (!use_quat) {
    for (int j = 0; j < 3; ++j) dout[j] = dx[j] = g[j];
    return;
  }
  const float* v = o;
  float d[3], qv[3], c1[3], t1[3], theta, w, k;
  for (int j = 0; j < 3; ++j) d[j] = __fsub_rn(x[j], o[3 + j]);
  quat_scalars(v, &theta, &w, &k, qv);
  cross3(qv, d, c1);
  for (int j = 0; j < 3; ++j) t1[j] = __fadd_rn(c1[j], __fmul_rn(w, d[j]));
  float g2[3], dqv[3], dt1[3], tmp[3], dd[3];
  for (int j = 0; j < 3; ++j) g2[j] = __fmul_rn(2.f, g[j]);
  cross3(t1, g2, dqv);
  cross3(g2, qv, dt1);
  cross3(d, dt1, tmp);
  for (int j = 0; j < 3; ++j) dqv[j] = __fadd_rn(dqv[j], tmp[j]);
  cross3(dt1, qv, tmp);
  for (int j = 0; j < 3; ++j)
    dd[j] = __fadd_rn(__fadd_rn(g[j], tmp[j]), __fmul_rn(w, dt1[j]));
  const float dw = __fadd_rn(__fadd_rn(__fmul_rn(dt1[0], d[0]),
                                       __fmul_rn(dt1[1], d[1])),
                             __fmul_rn(dt1[2], d[2]));
  float dv[3];
  for (int j = 0; j < 3; ++j) dv[j] = __fmul_rn(-k, dqv[j]);
  const float dk = __fadd_rn(__fadd_rn(__fmul_rn(-v[0], dqv[0]),
                                       __fmul_rn(-v[1], dqv[1])),
                             __fmul_rn(-v[2], dqv[2]));
  const float sin_t = __fmul_rn(k, theta);
  const float dtheta = __fadd_rn(
      __fmul_rn(-sin_t, dw),
      __fmul_rn(dk, __fsub_rn(__fdiv_rn(w, theta),
                              __fdiv_rn(sin_t, __fmul_rn(theta, theta)))));
  for (int j = 0; j < 3; ++j) {
    dout[j] = __fadd_rn(dv[j], __fdiv_rn(__fmul_rn(dtheta, v[j]), theta));
    dout[3 + j] = __fsub_rn(g[j], dd[j]);
    dout[6 + j] = g[j];
    dx[j] = dd[j];
  }
}

}  // namespace mlp
