// K1: batched substepped motor dynamics of a 7-dof serial revolute chain
// (the Panda of the Reach family) on Hopper.
//
// Replaces panda_gym_tpu/ops/pallas_dynamics.py::make_pallas_motor_steps
// (the only pl.pallas_call of the JAX package).  Computes what
// ops/scalarized.py::make_batched_motor_steps computes, warm path:
//   (q, qd, target) -> (q, qd) after n_substeps of PyBullet-motor dynamics.
// Per substep: v_des from the position servo (or the velocity target),
// clamped to vel_limit; RNEA bias; CRBA mass matrix; Cholesky free-velocity
// solve; masked active-set refinements of the motor box-LCP with impulse
// caps effort*dt; semi-implicit Euler; joint-limit clamp that zeroes qd.
// One cold pre-solve seeds the active set (sat, sign); every substep then
// runs the warm refinements.  Like the TPU kernel this always warm-starts.
//
// What bounds it: per env it reads 3x7 and writes 2x7 floats (140 B) and
// does ~82k fp32 operations per policy step, so it is bound by operations,
// not bytes; and the operations form one long dependent chain per env.
// The design keeps that chain in registers: one env per thread, q/qd/target
// loaded once, the cold pre-solve and all substeps run without touching
// device memory, q/qd stored once.  The model tables travel as a by-value
// kernel argument, which the card keeps in its constant bank and
// broadcasts to the warp (the __constant__ route, without a global symbol,
// so two models can be in flight).  All dof loops are unrolled so every
// array index is known at compile time and the arrays live in registers.
//
// Layout: the kernel reads and writes the (B, 7) row-major tensors
// directly.  A warp's 7 loads of one array cover one contiguous 896-byte
// span, so every sector fetched is used; a transpose to (7, B) would cost
// two more launches and twice the traffic for no gain at 140 B per env.
// The ragged last block is masked; nothing is padded.
//
// Arithmetic follows ops/scalarized.py term by term, in the same order, and
// is built without FMA contraction (-fmad=false in ops/_build.py) so that it
// rounds as the plain PyTorch version does.

#include <cuda_runtime.h>
#include <math.h>
#include <string.h>

namespace {

constexpr int N = 7;

// Model tables, all float32, as packed by ops/cuda_dynamics.py (same order).
struct Model {
  float XR[N][9];      // joint frame rotation in parent body frame, row-major
  float Xp[N][3];      // joint frame origin in parent body frame
  float axis[N][3];    // joint axis
  float mass[N];
  float com[N][3];
  float inertia[N][9]; // about the body origin, row-major
  float q_lo[N];
  float q_hi[N];
  float effort[N];
  float vel_limit[N];
};

struct Args {
  Model m;
  float cap[N];        // effort * dt, folded in double as the plain version does
  float vgain;         // position_gain / dt, folded in double
  float dt;
  int n_substeps;
  int ctrl_mode;       // 0 position, 1 velocity
  int cold_iters;
  int warm_iters;
};

struct V3 { float x, y, z; };
struct M3 { float a[9]; };

__device__ __forceinline__ V3 vadd(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 vsub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 vscale(float s, V3 a) { return {s * a.x, s * a.y, s * a.z}; }
__device__ __forceinline__ float vdot(V3 a, V3 b) { return (a.x * b.x + a.y * b.y) + a.z * b.z; }
__device__ __forceinline__ V3 vcross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ V3 load3(const float* p) { return {p[0], p[1], p[2]}; }
__device__ __forceinline__ M3 load9(const float* p) {
  M3 r;
#pragma unroll
  for (int i = 0; i < 9; ++i) r.a[i] = p[i];
  return r;
}
// M v
__device__ __forceinline__ V3 mv(const M3& M, V3 v) {
  return {(M.a[0] * v.x + M.a[1] * v.y) + M.a[2] * v.z,
          (M.a[3] * v.x + M.a[4] * v.y) + M.a[5] * v.z,
          (M.a[6] * v.x + M.a[7] * v.y) + M.a[8] * v.z};
}
// M^T v
__device__ __forceinline__ V3 mtv(const M3& M, V3 v) {
  return {(M.a[0] * v.x + M.a[3] * v.y) + M.a[6] * v.z,
          (M.a[1] * v.x + M.a[4] * v.y) + M.a[7] * v.z,
          (M.a[2] * v.x + M.a[5] * v.y) + M.a[8] * v.z};
}
__device__ __forceinline__ M3 mm(const M3& A, const M3& B) {
  M3 r;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      r.a[3 * i + j] = (A.a[3 * i] * B.a[j] + A.a[3 * i + 1] * B.a[3 + j]) +
                       A.a[3 * i + 2] * B.a[6 + j];
  return r;
}
__device__ __forceinline__ M3 mT(const M3& A) {
  M3 r;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) r.a[3 * i + j] = A.a[3 * j + i];
  return r;
}
// skew(v) skew(v)^T
__device__ __forceinline__ M3 skew_sq(V3 v) {
  M3 S = {{0.f, -v.z, v.y, v.z, 0.f, -v.x, -v.y, v.x, 0.f}};
  return mm(S, mT(S));
}

// Child-body frame pose in parent coords for the revolute joint d at angle q
// (scalarized.py:_joint_X with axis_angle).
__device__ __forceinline__ void joint_X(const Model& m, int d, float q, M3& R, V3& p) {
  const float c = cosf(q), s = sinf(q);
  const float x = m.axis[d][0], y = m.axis[d][1], z = m.axis[d][2];
  const float C1 = 1.0f - c;
  M3 A = {{c + (x * x) * C1, (x * y) * C1 - z * s, (x * z) * C1 + y * s,
           (y * x) * C1 + z * s, c + (y * y) * C1, (y * z) * C1 - x * s,
           (z * x) * C1 - y * s, (z * y) * C1 + x * s, c + (z * z) * C1}};
  R = mm(load9(m.XR[d]), A);
  p = load3(m.Xp[d]);
}

__device__ __forceinline__ void force_to_parent(const M3& R, V3 p, V3& n, V3& f) {
  const V3 f_p = mv(R, f);
  n = vadd(mv(R, n), vcross(p, f_p));
  f = f_p;
}

__device__ __forceinline__ void inertia_mul(float m, V3 c, const M3& I, V3 om, V3 v, V3& n, V3& f) {
  n = vadd(mv(I, om), vscale(m, vcross(c, v)));
  f = vscale(m, vadd(v, vcross(om, c)));
}

// Bias force C(q, qd) qd + G(q) by RNEA with qdd = 0 (scalarized.py:rnea).
__device__ __forceinline__ void rnea_bias(const Model& m, const M3 (&R)[N], const V3 (&p)[N],
                                          const float (&qd)[N], float (&tau)[N]) {
  V3 fn[N], ff[N];
  V3 om_p = {0.f, 0.f, 0.f}, v_p = {0.f, 0.f, 0.f};
  V3 aom_p = {0.f, 0.f, 0.f}, av_p = {0.f, 0.f, 9.81f};  // base accel = -g
#pragma unroll
  for (int d = 0; d < N; ++d) {
    V3 om = mtv(R[d], om_p);
    V3 v = mtv(R[d], vadd(v_p, vcross(om_p, p[d])));
    V3 aom = mtv(R[d], aom_p);
    V3 av = mtv(R[d], vadd(av_p, vcross(aom_p, p[d])));
    const V3 vj = vscale(qd[d], load3(m.axis[d]));
    om = vadd(om, vj);
    aom = vadd(aom, vcross(om, vj));
    av = vadd(av, vcross(v, vj));
    const float ms = m.mass[d];
    const V3 c = load3(m.com[d]);
    const M3 I = load9(m.inertia[d]);
    V3 hn, hf, n, f;
    inertia_mul(ms, c, I, om, v, hn, hf);
    inertia_mul(ms, c, I, aom, av, n, f);
    fn[d] = vadd(n, vadd(vcross(om, hn), vcross(v, hf)));
    ff[d] = vadd(f, vcross(om, hf));
    om_p = om; v_p = v; aom_p = aom; av_p = av;
  }
#pragma unroll
  for (int d = N - 1; d >= 0; --d) {
    tau[d] = vdot(load3(m.axis[d]), fn[d]);
    if (d > 0) {
      V3 n = fn[d], f = ff[d];
      force_to_parent(R[d], p[d], n, f);
      fn[d - 1] = vadd(fn[d - 1], n);
      ff[d - 1] = vadd(ff[d - 1], f);
    }
  }
}

// Joint-space mass matrix by CRBA (scalarized.py:crba); fills the full matrix.
__device__ __forceinline__ void crba(const Model& m, const M3 (&R)[N], const V3 (&p)[N],
                                     float (&M)[N][N]) {
  float mc[N];
  V3 cc[N];
  M3 Ic[N];
#pragma unroll
  for (int d = 0; d < N; ++d) {
    mc[d] = m.mass[d];
    cc[d] = load3(m.com[d]);
    Ic[d] = load9(m.inertia[d]);
  }
#pragma unroll
  for (int d = N - 1; d > 0; --d) {
    // child inertia in parent coords (scalarized.py:_inertia_to_parent)
    const float m_c = mc[d];
    const V3 c_p = vadd(mv(R[d], cc[d]), p[d]);
    const M3 sk = skew_sq(cc[d]);
    M3 I_com;
#pragma unroll
    for (int i = 0; i < 9; ++i) I_com.a[i] = Ic[d].a[i] - m_c * sk.a[i];
    const M3 I_com_p = mm(R[d], mm(I_com, mT(R[d])));
    const M3 skp = skew_sq(c_p);
    const float m_p = mc[d - 1];
    const float m_t = m_p + m_c;
    const float w = 1.0f / fmaxf(m_t, 1e-12f);
    cc[d - 1] = vscale(w, vadd(vscale(m_p, cc[d - 1]), vscale(m_c, c_p)));
#pragma unroll
    for (int i = 0; i < 9; ++i) Ic[d - 1].a[i] = Ic[d - 1].a[i] + (I_com_p.a[i] + m_c * skp.a[i]);
    mc[d - 1] = m_t;
  }
#pragma unroll
  for (int d = 0; d < N; ++d) {
    const V3 ax = load3(m.axis[d]);
    V3 Fn, Ff;
    inertia_mul(mc[d], cc[d], Ic[d], ax, V3{0.f, 0.f, 0.f}, Fn, Ff);
    M[d][d] = vdot(ax, Fn);
#pragma unroll
    for (int j = d; j > 0; --j) {
      force_to_parent(R[j], p[j], Fn, Ff);
      const float Mdj = vdot(load3(m.axis[j - 1]), Fn);
      M[d][j - 1] = Mdj;
      M[j - 1][d] = Mdj;
    }
  }
}

// Index-unrolled Cholesky solve A x = b (scalarized.py:cholesky_solve).
__device__ __forceinline__ void cholesky_solve(const float (&A)[N][N], const float (&b)[N],
                                               float (&x)[N]) {
  float L[N][N];
  float inv[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s = A[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) s = s - L[i][k] * L[j][k];
      if (i == j) {
        L[i][i] = sqrtf(fmaxf(s, 1e-9f));
        inv[i] = 1.0f / L[i][i];
      } else {
        L[i][j] = s * inv[j];
      }
    }
  }
  float y[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
    y[i] = s * inv[i];
  }
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < N; ++k) s = s - L[k][i] * x[k];
    x[i] = s * inv[i];
  }
}

__device__ __forceinline__ void matvec(const float (&M)[N][N], const float (&v)[N], float (&out)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = M[i][0] * v[0];
#pragma unroll
    for (int j = 1; j < N; ++j) s = s + M[i][j] * v[j];
    out[i] = s;
  }
}

// One substep (scalarized.py:motor_substep).  cold: seed the active set from
// the unconstrained pass and run cold_iters refinements; else refine the
// carried (sat, sign) warm_iters times.  Updates q, qd unless seed_only, and
// always returns the new (sat, sign).
__device__ __forceinline__ void motor_substep(const Args& a, float (&q)[N], float (&qd)[N],
                                              const float (&tgt)[N], bool cold, bool seed_only,
                                              bool (&sat)[N], float (&sign)[N]) {
  const Model& m = a.m;
  float v_des[N];
#pragma unroll
  for (int d = 0; d < N; ++d) {
    const float v = a.ctrl_mode == 0 ? a.vgain * (tgt[d] - q[d]) : tgt[d];
    v_des[d] = fminf(fmaxf(v, -m.vel_limit[d]), m.vel_limit[d]);
  }

  M3 R[N];
  V3 p[N];
#pragma unroll
  for (int d = 0; d < N; ++d) joint_X(m, d, q[d], R[d], p[d]);

  float bias[N], M[N][N];
  rnea_bias(m, R, p, qd, bias);
  crba(m, R, p, M);

  float rhs[N], fv[N];
#pragma unroll
  for (int i = 0; i < N; ++i) rhs[i] = -bias[i];
  cholesky_solve(M, rhs, fv);
  float qd_free[N], Mqf[N];
#pragma unroll
  for (int d = 0; d < N; ++d) qd_free[d] = qd[d] + a.dt * fv[d];
  matvec(M, qd_free, Mqf);

  float c[N], x[N];
  int n_iters;
  if (cold) {
    float Mv[N];
    matvec(M, v_des, Mv);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      x[i] = Mv[i] - Mqf[i];
      sat[i] = fabsf(x[i]) > a.cap[i];
      c[i] = fminf(fmaxf(x[i], -a.cap[i]), a.cap[i]);
    }
    n_iters = a.cold_iters;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) c[i] = a.cap[i] * sign[i];
    n_iters = a.warm_iters;
  }

  float u[N];
#pragma unroll
  for (int i = 0; i < N; ++i) u[i] = v_des[i];
#pragma unroll 1
  for (int it = 0; it < n_iters; ++it) {
    // rows S (saturated): M_SS u_S = c_S + (M qd_free)_S - M_SF v_des_F
    // rows F (free):      u_F = v_des_F
    float A[N][N], vf[N], mvf[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j) A[i][j] = (sat[i] && sat[j]) ? M[i][j] : (i == j ? 1.0f : 0.0f);
      vf[i] = sat[i] ? 0.0f : v_des[i];
    }
    matvec(M, vf, mvf);
#pragma unroll
    for (int i = 0; i < N; ++i) rhs[i] = sat[i] ? (c[i] + Mqf[i]) - mvf[i] : v_des[i];
    cholesky_solve(A, rhs, u);
    float Mu[N];
    matvec(M, u, Mu);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      x[i] = Mu[i] - Mqf[i];
      // saturated stays iff the deficit still pushes into the cap; free
      // joints whose required impulse exceeds the cap saturate
      sat[i] = sat[i] ? ((v_des[i] - u[i]) * c[i] >= 0.0f) : (fabsf(x[i]) > a.cap[i]);
      c[i] = fminf(fmaxf(x[i], -a.cap[i]), a.cap[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) sign[i] = x[i] >= 0.0f ? 1.0f : -1.0f;
  if (seed_only) return;

#pragma unroll
  for (int d = 0; d < N; ++d) {
    const float q_new = q[d] + a.dt * u[d];
    const float q_cl = fminf(fmaxf(q_new, m.q_lo[d]), m.q_hi[d]);
    qd[d] = q_cl != q_new ? 0.0f : u[d];
    q[d] = q_cl;
  }
}

__global__ void __launch_bounds__(128)
motor_steps_kernel(const float* __restrict__ q_in, const float* __restrict__ qd_in,
                   const float* __restrict__ tgt_in, float* __restrict__ q_out,
                   float* __restrict__ qd_out, int B, const Args a) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const long long off = static_cast<long long>(b) * N;
  float q[N], qd[N], tgt[N];
#pragma unroll
  for (int d = 0; d < N; ++d) {
    q[d] = q_in[off + d];
    qd[d] = qd_in[off + d];
    tgt[d] = tgt_in[off + d];
  }
  bool sat[N];
  float sign[N];
  // cold pre-solve on the initial system: keeps only the active set
  motor_substep(a, q, qd, tgt, /*cold=*/true, /*seed_only=*/true, sat, sign);
#pragma unroll 1
  for (int s = 0; s < a.n_substeps; ++s)
    motor_substep(a, q, qd, tgt, /*cold=*/false, /*seed_only=*/false, sat, sign);
#pragma unroll
  for (int d = 0; d < N; ++d) {
    q_out[off + d] = q[d];
    qd_out[off + d] = qd[d];
  }
}

}  // namespace

// C entry point, bound with ctypes by ops/cuda_dynamics.py.  Launches on the
// caller's stream on card `device` and returns cudaGetLastError() (0 on
// success).
extern "C" int motor_steps_launch(const float* q, const float* qd, const float* tgt,
                                  float* q_out, float* qd_out, int B, const float* model,
                                  int n_substeps, double dt, int ctrl_mode,
                                  double position_gain, int cold_iters, int warm_iters,
                                  int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  Args a;
  memcpy(&a.m, model, sizeof(Model));
  for (int d = 0; d < N; ++d) a.cap[d] = static_cast<float>(dt * a.m.effort[d]);
  a.vgain = static_cast<float>(position_gain * (1.0 / dt));
  a.dt = static_cast<float>(dt);
  a.n_substeps = n_substeps;
  a.ctrl_mode = ctrl_mode;
  a.cold_iters = cold_iters;
  a.warm_iters = warm_iters;
  if (B > 0) {
    const int threads = 128;
    const int blocks = (B + threads - 1) / threads;
    motor_steps_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        q, qd, tgt, q_out, qd_out, B, a);
  }
  return static_cast<int>(cudaGetLastError());
}

// Number of floats the model table must hold (checked by the wrapper).
extern "C" int motor_steps_model_floats() { return static_cast<int>(sizeof(Model) / sizeof(float)); }
