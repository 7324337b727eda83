// K1: batched substepped motor dynamics of a kinematic chain on Hopper: the
// welded 7-dof Panda (Reach, ReachAO, Push, Slide), MyCobot's 6 serial
// revolute dofs (MyCobotReach) and the 9-dof Panda whose two prismatic
// fingers both hang from link 6 (PickAndPlace, Stack, Flip).
//
// Replaces panda_gym_tpu/ops/pallas_dynamics.py::make_pallas_motor_steps
// (the only pl.pallas_call of the JAX package).  Computes what
// ops/scalarized.py::make_batched_motor_steps computes:
//   (q, qd, target) -> (q, qd) after n_substeps of PyBullet-motor dynamics.
// Per substep: v_des from the position servo (or the velocity target),
// clamped to vel_limit; RNEA bias; CRBA mass matrix; Cholesky free-velocity
// solve; masked active-set refinements of the motor box-LCP with impulse
// caps effort*dt; semi-implicit Euler; joint-limit clamp that zeroes qd.
// Warm (the TPU kernel's way, and the default): one cold pre-solve seeds
// the active set (sat, sign); every substep then runs the warm refinements.
// Cold (the reference's ReachAO collision step, which launches one substep
// at a time): every substep solves from its own unconstrained pass.
//
// One warm substep at a time (the contact step, and the ReachAO step under
// PANDA_LCP_WARM=1, which launch once per substep): a seed launch runs only
// the cold pre-solve and writes the active set; each substep launch then
// reads the set carried from the launch before, refines it warm and writes
// it back.  A contact torque tau_ext (B, ndof) is added to the right-hand side
// of the free-velocity solve, tau_ext - bias, as scalarized.py adds it; the
// seed ignores it, as the reference's seed does.  With null pointers for
// these (the Reach step, and the cold collision step) every output is what
// it was without them, bit for bit.
//
// What bounds it: per env of the welded Panda it reads 3x7 and writes 2x7
// floats (140 B) and does ~82k fp32 operations per policy step, so it is
// bound by operations, not bytes.  Those operations are one long chain per
// env.  Two kernels compute it for the welded Panda, and the wrapper
// (ops/cuda_dynamics.py) picks one from B and what the card reports:
//
// motor_steps_lanes_kernel, up to one wave of its grid (every block
// resident at once: 132 SMs x 2 blocks x 16 envs = 4,224 envs on the H100).
// At the batches the trainer and the env step use (B = 64 ... 4096) one
// thread per env leaves most of the 132 SMs idle and each busy scheduler
// with one warp whose chain nothing hides.  So one env runs on a group of
// 8 lanes:
//
//   - lane d < 7 owns dof d, lane 7 is spare; 4 envs per warp, 16 per
//     128-thread block, so B = 4096 is 256 blocks and B = 512 is 32;
//   - split by dof, each lane for its own joint: the joint frame
//     (sincosf and the rotation), the link's own RNEA force (two inertia
//     products and the gyroscopic terms), one column of the CRBA mass
//     matrix (an independent chain of force_to_parent, up to 6 hops) and
//     one row of each 7x7 matrix-vector product of the LCP;
//   - split by vector or row, with the link recursions kept in order: the
//     RNEA motion sweep carries om, v, aom, av on lanes 0-3, one vector
//     each, and the CRBA composite-inertia sweep one 3x3 row each on lanes
//     0-2; the two sweeps are independent, so they run interleaved, one link
//     of each per step, sharing the step's two exchanges;
//   - the two Cholesky factorizations of a warm substep (M for the free
//     velocity, and the active-set matrix A, which depends only on the
//     carried active set) run in the same instructions: lanes 0-3 factor M,
//     lanes 4-7 factor A, and each solution is broadcast from its lane.
//     This takes one 7x7 factorization off every lane's path (warm_iters
//     is 1) at the cost of 231 registers against 186, still 2 blocks per
//     SM: measured against every lane factoring both, K1 is 6-8% faster at
//     B = 64 and 512 and 3-4% at 4096 and 65536 (PERF.md);
//   - computed alike on every lane: the RNEA force sweep (link to link),
//     the Cholesky substitutions and the active-set update.  A Cholesky
//     column waits on a sqrt and a reciprocal, so spreading its rows would
//     save a few multiply-adds against an exchange per column; computed
//     alike, every lane holds the full q, qd, target, active set and
//     solution.
//   Every scalar is computed by one lane in the order of operations of the
//   plain version; parallelism comes from computing different scalars on
//   different lanes, never from re-associating a sum.  Where lanes run one
//   code path for different roles, a role's missing term is an exact zero.
//
// motor_steps_thread_kernel, past that wave: one env per thread, the whole
// chain in registers.  It is a template on the chain (ndof, parents, joint
// types, known at compile time), built for each of the three chains; the
// lane groups own one dof per lane and stay the welded Panda's, so MyCobot
// and the 9-dof Panda run this kernel at every B.  A warp of lane groups serves 4 envs where one of
// threads serves 32, and the work that every lane repeats is issued once
// per 4 envs; once the card is full time follows the instructions issued
// per env, about 1,000 per substep in the lane groups against about 240
// here, so at B = 65536 (the batch of the repo's bench.py) the lane groups
// take about 4.7x as long.  Both kernels share the helpers below and keep
// the plain version's order of operations.
//
// The rest of this note is about the lane-group kernel.
//
// Exchange goes through a per-group scratch area in shared memory, written
// by its owner lane and read after __syncwarp(): the joint frames once per
// substep, two exchanges per link of the interleaved sweeps, the link
// forces once, the mass-matrix rows once, and the LCP's row products and
// solutions.  Constants: what every lane reads alike (link constants indexed
// by an unrolled loop, dt, the gain, the loop counts, the composite masses
// folded on the host) is read from the by-value kernel argument, i.e. the
// constant bank, which broadcasts a word to the warp; a lane's own joint
// constants (axis, frame, mass, CoM, inertia rows) are picked once at kernel
// start into registers or into the scratch, so no constant-bank read ever
// differs across lanes.

// Ragged edge: the lanes of a group whose env index is >= B stay in the warp
// and compute on the last env (b clamped to B-1), so every lane reaches every
// __syncwarp(); only their stores are masked.  The spare lane 7 computes a
// copy of dof 6 into its own scratch slots and stores nothing.
//
// Layout: each lane loads the env's 3x7 inputs (the 8 lanes of a group read
// the same 84 bytes, a broadcast); lane d < 7 stores element d, so a warp
// stores 4 contiguous rows.  No transpose, no padding.
//
// Arithmetic follows ops/scalarized.py term by term, in the same order, and
// is built without FMA contraction (-fmad=false in ops/_build.py) so that it
// rounds as the plain PyTorch version does.

#include <cuda_runtime.h>
#include <math.h>
#include <string.h>

namespace {

constexpr int N = 7;                      // the lane-group kernel's chain
constexpr int LANES = 8;                  // lanes per env
constexpr int THREADS = 128;              // threads per block
constexpr int GROUPS = THREADS / LANES;   // envs per block

// The chains K1 is built for: the number of dofs, each dof's parent (-1 for
// the base; a parent has a lower index, as ChainModel orders them) and
// whether its joint is prismatic (else revolute); ``serial`` when every
// dof's parent is the one before it and every joint is revolute.  The wrapper names them by their index
// in this list (chain id 0, 1, 2).
struct PandaChain {         // the welded Panda: 7 serial revolute dofs
  static constexpr int N = 7;
  static constexpr bool serial = true;
  static constexpr __host__ __device__ int parent(int d) { return d - 1; }
  static constexpr __host__ __device__ bool prismatic(int) { return false; }
};
struct MyCobotChain {       // MyCobot: 6 serial revolute dofs
  static constexpr int N = 6;
  static constexpr bool serial = true;
  static constexpr __host__ __device__ int parent(int d) { return d - 1; }
  static constexpr __host__ __device__ bool prismatic(int) { return false; }
};
struct GripperPandaChain {  // the Panda with its fingers: 7 revolute arm
  static constexpr int N = 9;  // dofs, prismatic fingers 7 and 8 on link 6
  static constexpr bool serial = false;
  static constexpr __host__ __device__ int parent(int d) { return d == 8 ? 6 : d - 1; }
  static constexpr __host__ __device__ bool prismatic(int d) { return d >= 7; }
};

// Model tables of an ND-dof chain, all float32, as packed by
// ops/cuda_dynamics.py (same order).
template <int ND>
struct ModelT {
  float XR[ND][9];      // joint frame rotation in parent body frame, row-major
  float Xp[ND][3];      // joint frame origin in parent body frame
  float axis[ND][3];    // joint axis
  float mass[ND];
  float com[ND][3];
  float inertia[ND][9]; // about the body origin, row-major
  float q_lo[ND];
  float q_hi[ND];
  float effort[ND];
  float vel_limit[ND];
};
using Model = ModelT<N>;

template <int ND>
struct ArgsT {
  ModelT<ND> m;
  float cap[ND];        // effort * dt, folded in double as the plain version does
  float comp_m[ND];     // CRBA: mass of the composite body of link d (q-independent)
  float comp_w[ND];     // CRBA: 1 / max(comp_mp[d] + comp_m[d], 1e-12), the CoM
                        // weight as link d joins its parent
  float vgain;          // position_gain / dt, folded in double
  float dt;
  int n_substeps;
  int ctrl_mode;        // 0 position, 1 velocity
  int cold_iters;
  int warm_iters;
  int warm;             // 1: seed once, refine warm; 0: every substep cold
  int seed;             // 1: only the cold pre-solve, which writes the set
  float comp_mp[ND];    // CRBA: mass of the parent's composite as link d joins it
                        // (last, so that the lane-group kernel's block keeps
                        // the layout it had before the chains)
};
using Args = ArgsT<N>;

// The optional per-env inputs and outputs of one-substep launches,
// (B, ndof) each; null where not given.
struct Carry {
  const float* tau;            // contact torque, added to -bias
  const unsigned char* sat_in; // carried active set (0/1) and its signs
  const float* sign_in;
  unsigned char* sat_out;      // the active set after the launch
  float* sign_out;
};

// One group's scratch in shared memory.  Slots are indexed by lane (lane 7
// writes only its own slot 7).  Records of 20 floats keep the 16-byte loads
// of 8 lanes from 8 different records free of bank conflicts; the size, 696
// floats (24 mod 32), puts the 4 groups of a warp in different banks.
struct __align__(16) Scratch {
  float X[LANES][20];    // joint frame of the lane's joint: R (9), p (3), axis (3)
  float Mo[N][16];       // motion of link d: om, v, aom, av (3 each, padded to 4)
  float F[LANES][8];     // the lane's own link force: n (3), pad, f (3), pad
  float C[LANES][16];    // composite body of link d: I (9), c (3), m
  float I0[3][N][4];     // row r of each link's own inertia (constant)
  float T[4][4];         // composite sweep: rows of I_com R^T
  float M[LANES][8];     // row d of the mass matrix, M[d][0..d]
  float G[6][8];         // LCP exchange: M qd_free, M v_des, M v_free, M u by
                         // row (one per lane); the solutions fv and u
  float pad[20];
};

struct V3 { float x, y, z; };
struct M3 { float a[9]; };

__device__ __forceinline__ V3 vadd(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 vscale(float s, V3 a) { return {s * a.x, s * a.y, s * a.z}; }
__device__ __forceinline__ float vdot(V3 a, V3 b) { return (a.x * b.x + a.y * b.y) + a.z * b.z; }
__device__ __forceinline__ V3 vcross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ V3 load3(const float* p) { return {p[0], p[1], p[2]}; }
__device__ __forceinline__ void store3(float* p, V3 v) { p[0] = v.x; p[1] = v.y; p[2] = v.z; }
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
// Row i of skew(v) skew(v)^T.  The plain version forms the product with the
// zeros of skew(v) in place; the terms dropped here are exact zeros, so the
// nonzero entries round alike.
__device__ __forceinline__ V3 skew_sq_row(int i, V3 v) {
  const float xy = -(v.x * v.y), xz = -(v.x * v.z), yz = -(v.y * v.z);
  if (i == 0) return {v.z * v.z + v.y * v.y, xy, xz};
  if (i == 1) return {xy, v.z * v.z + v.x * v.x, yz};
  return {xz, yz, v.y * v.y + v.x * v.x};
}

// a[i] for a lane-dependent i: a chain of selects over unrolled constant
// indices, so the table is only ever read at addresses uniform to the warp.
__device__ __forceinline__ float pick(int i, const float (&a)[N]) {
  float r = a[0];
#pragma unroll
  for (int k = 1; k < N; ++k) r = i == k ? a[k] : r;
  return r;
}
__device__ __forceinline__ V3 pick_v3(int i, const float (&a)[N][3]) {
  float r[3];
#pragma unroll
  for (int w = 0; w < 3; ++w) {
    r[w] = a[0][w];
#pragma unroll
    for (int k = 1; k < N; ++k) r[w] = i == k ? a[k][w] : r[w];
  }
  return {r[0], r[1], r[2]};
}
__device__ __forceinline__ M3 pick_m3(int i, const float (&a)[N][9]) {
  M3 r;
#pragma unroll
  for (int w = 0; w < 9; ++w) {
    r.a[w] = a[0][w];
#pragma unroll
    for (int k = 1; k < N; ++k) r.a[w] = i == k ? a[k][w] : r.a[w];
  }
  return r;
}
__device__ __forceinline__ V3 pick3(int i, V3 a, V3 b, V3 c) { return i == 0 ? a : (i == 1 ? b : c); }
__device__ __forceinline__ unsigned char pick_sat(int i, const bool (&a)[N]) {
  bool r = a[0];
#pragma unroll
  for (int k = 1; k < N; ++k) r = i == k ? a[k] : r;
  return r ? 1 : 0;
}

// Every lane (or the env's one thread) reads the env's whole contact torque
// and carried active set, where given.
template <int ND>
__device__ __forceinline__ void load_carry(const Carry& c, long long off, float (&tau)[ND],
                                           bool (&sat)[ND], float (&sign)[ND]) {
  if (c.tau != nullptr) {
#pragma unroll
    for (int d = 0; d < ND; ++d) tau[d] = c.tau[off + d];
  }
  if (c.sat_in != nullptr) {
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      sat[d] = c.sat_in[off + d] != 0;
      sign[d] = c.sign_in[off + d];
    }
  }
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

// The lane's own joint: its constants, picked once at kernel start.
struct Lane {
  int l;     // lane in the group, 0..7
  int d;     // dof it owns (lane 7: a copy of dof 6)
  int r;     // row it takes in the composite sweep (lanes 3..7: a copy of row 2)
  V3 ax, com;
  float mass;
  M3 XR, I;
};

// Child-body frame rotation in parent coords for a revolute joint with
// frame rotation XR and axis ax at angle q (scalarized.py:_joint_X with
// axis_angle).
__device__ __forceinline__ M3 joint_R(const M3& XR, V3 ax, float q) {
  float s, c;
  sincosf(q, &s, &c);
  const float x = ax.x, y = ax.y, z = ax.z;
  const float C1 = 1.0f - c;
  const M3 A = {{c + (x * x) * C1, (x * y) * C1 - z * s, (x * z) * C1 + y * s,
                 (y * x) * C1 + z * s, c + (y * y) * C1, (y * z) * C1 - x * s,
                 (z * x) * C1 - y * s, (z * y) * C1 + x * s, c + (z * z) * C1}};
  return mm(XR, A);
}

// The RNEA forward sweep (scalarized.py:rnea, qdd = 0), one link d, split
// by motion vector: lane role 0 carries om, 1 v, 2 aom, 3 av (lanes 4-7 a
// copy of role 3).  Each role's update has the same form
//   X = R^T (X_parent + Y_parent x p) [+ vj for om] [+ Z x vj]
// with Y = om for v, aom for av (the parent's, from s.Mo), Z = om for aom,
// v for av (this link's, published in between), and zero elsewhere; the
// zero terms add exact zeros, so every entry rounds as in the plain version.
// Half 1 computes R^T(...) and publishes om and v of link d.
__device__ __forceinline__ V3 motion_half1(const Model& m, const Scratch& s, int role, int d,
                                           V3 X, V3 vj) {
  const V3 zero = {0.f, 0.f, 0.f};
  V3 Y = zero;
  if (d > 0) Y = role == 1 ? load3(s.Mo[d - 1]) : (role == 3 ? load3(s.Mo[d - 1] + 8) : zero);
  const V3 Xn = mtv(load9(s.X[d]), vadd(X, vcross(Y, load3(m.Xp[d]))));
  return vadd(Xn, role == 0 ? vj : zero);
}
// Half 2, after the exchange: the Coriolis terms of aom and av.
__device__ __forceinline__ V3 motion_half2(const Scratch& s, int role, int d, V3 X, V3 vj) {
  const V3 zero = {0.f, 0.f, 0.f};
  const V3 Z = role == 2 ? load3(s.Mo[d]) : (role == 3 ? load3(s.Mo[d] + 4) : zero);
  return vadd(X, vcross(Z, vj));
}

// The CRBA composite sweep (scalarized.py:crba with _inertia_to_parent), one
// link d: the composite body of link d (CoM cc, row r of its inertia Ir)
// moves into its parent's frame and joins link d-1's own body.  Lanes 0-2
// take one row each.  Half 1 publishes row r of I_com R^T.
__device__ __forceinline__ void composite_half1(const Lane& me, Scratch& s, float m_c, int d,
                                                V3 cc, V3 Ir) {
  const int r = me.r;
  const M3 R = load9(s.X[d]);
  const V3 sk = skew_sq_row(r, cc);
  const V3 Icom = {Ir.x - m_c * sk.x, Ir.y - m_c * sk.y, Ir.z - m_c * sk.z};
  if (me.l < 3) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      s.T[r][j] = (Icom.x * R.a[3 * j] + Icom.y * R.a[3 * j + 1]) + Icom.z * R.a[3 * j + 2];
  }
}
// Half 2, after the exchange: row r of I_com_p = R T, the parent's new
// composite, published to s.C[d-1].
__device__ __forceinline__ void composite_half2(const Args& a, const Lane& me, Scratch& s, int d,
                                                V3& cc, V3& Ir) {
  const Model& m = a.m;
  const int r = me.r;
  const M3 R = load9(s.X[d]);
  const float m_c = a.comp_m[d];
  const V3 c_p = vadd(mv(R, cc), load3(m.Xp[d]));
  const V3 Rr = pick3(r, load3(R.a), load3(R.a + 3), load3(R.a + 6));
  V3 Ip;
  Ip.x = (Rr.x * s.T[0][0] + Rr.y * s.T[1][0]) + Rr.z * s.T[2][0];
  Ip.y = (Rr.x * s.T[0][1] + Rr.y * s.T[1][1]) + Rr.z * s.T[2][1];
  Ip.z = (Rr.x * s.T[0][2] + Rr.y * s.T[1][2]) + Rr.z * s.T[2][2];
  const V3 skp = skew_sq_row(r, c_p);
  const float m_p = m.mass[d - 1];
  cc = vscale(a.comp_w[d], vadd(vscale(m_p, load3(m.com[d - 1])), vscale(m_c, c_p)));
  const V3 I0 = load3(s.I0[r][d - 1]);
  Ir = {I0.x + (Ip.x + m_c * skp.x), I0.y + (Ip.y + m_c * skp.y), I0.z + (Ip.z + m_c * skp.z)};
  if (me.l < 3) store3(s.C[d - 1] + 3 * r, Ir);
  if (me.l == 0) {
    store3(s.C[d - 1] + 9, cc);
    s.C[d - 1][12] = a.comp_m[d - 1];
  }
}

// Bias force C(q, qd) qd + G(q) by RNEA with qdd = 0 into tau (every lane),
// and the joint-space mass matrix by CRBA into s.M (row d holds M[d][0..d]);
// scalarized.py:rnea and :crba.  Reads the joint frames from s.X.
//
// The RNEA motion sweep (one vector per lane) and the CRBA composite sweep
// (one row per lane) do not depend on each other, so they run interleaved,
// one link of each per step, and share the step's two exchanges.  Each lane
// then computes its own link's force from the published motion; then the
// RNEA force sweep (every lane alike) runs interleaved with the CRBA column
// of the lane's dof.
__device__ __forceinline__ void bias_and_mass(const Args& a, const Lane& me, Scratch& s,
                                              const float (&qd)[N], float (&tau)[N]) {
  const Model& m = a.m;
  const int role = me.l < 4 ? me.l : 3;
  V3 X = {0.f, 0.f, role == 3 ? 9.81f : 0.f};  // base accel = -g
  V3 cc = load3(m.com[N - 1]);
  V3 Ir = load3(s.I0[me.r][N - 1]);
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int d = N - 1 - k;  // the composite sweep's link
    const V3 vj = vscale(qd[k], load3(m.axis[k]));
    X = motion_half1(m, s, role, k, X, vj);
    if (role < 2) store3(s.Mo[k] + 4 * role, X);
    if (d > 0) composite_half1(me, s, a.comp_m[d], d, cc, Ir);
    __syncwarp();
    X = motion_half2(s, role, k, X, vj);
    if (role >= 2 && me.l < 4) store3(s.Mo[k] + 4 * role, X);
    if (d > 0) composite_half2(a, me, s, d, cc, Ir);
    __syncwarp();
  }
  {
    const float* o = s.Mo[me.d];
    const V3 om = load3(o), v = load3(o + 4);
    V3 hn, hf, n, f;
    inertia_mul(me.mass, me.com, me.I, om, v, hn, hf);
    inertia_mul(me.mass, me.com, me.I, load3(o + 8), load3(o + 12), n, f);
    store3(s.F[me.l], vadd(n, vadd(vcross(om, hn), vcross(v, hf))));
    store3(s.F[me.l] + 4, vadd(f, vcross(om, hf)));
  }
  __syncwarp();

  // force sweep from the tip (link d = N-1-h), and column me.d of M: M[d][d],
  // then M[d][j-1] as the force crosses joint j = d-h
  V3 fn = load3(s.F[N - 1]), ff = load3(s.F[N - 1] + 4);
  const float* Cd = s.C[me.d];
  V3 Fn, Ff;
  inertia_mul(Cd[12], load3(Cd + 9), load9(Cd), me.ax, V3{0.f, 0.f, 0.f}, Fn, Ff);
  float* Mrow = s.M[me.l];
  Mrow[me.d] = vdot(me.ax, Fn);
#pragma unroll
  for (int h = 0; h < N - 1; ++h) {
    const int d = N - 1 - h;
    tau[d] = vdot(load3(m.axis[d]), fn);
    V3 n = fn, f = ff;
    force_to_parent(load9(s.X[d]), load3(m.Xp[d]), n, f);
    fn = vadd(load3(s.F[d - 1]), n);
    ff = vadd(load3(s.F[d - 1] + 4), f);

    const int j = me.d - h;
    const int jc = j >= 1 ? j : 1;  // spent lanes run on a valid joint; nothing is stored
    force_to_parent(load9(s.X[jc]), load3(s.X[jc] + 9), Fn, Ff);
    const float Mdj = vdot(load3(s.X[jc - 1] + 12), Fn);
    if (j >= 1) Mrow[j - 1] = Mdj;
  }
  tau[0] = vdot(load3(m.axis[0]), fn);
  __syncwarp();
}

// Index-unrolled Cholesky factor of A (scalarized.py:cholesky_factor):
// lower L and the reciprocals of its diagonal.
template <int ND>
__device__ __forceinline__ void cholesky_factor(const float (&A)[ND][ND], float (&L)[ND][ND],
                                                float (&inv)[ND]) {
#pragma unroll
  for (int i = 0; i < ND; ++i) {
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
}

// Forward and back substitution with a factor (scalarized.py:
// cholesky_substitute).
template <int ND>
__device__ __forceinline__ void cholesky_subst(const float (&L)[ND][ND], const float (&inv)[ND],
                                               const float (&b)[ND], float (&x)[ND]) {
  float y[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) {
    float s = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
    y[i] = s * inv[i];
  }
#pragma unroll
  for (int i = ND - 1; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < ND; ++k) s = s - L[k][i] * x[k];
    x[i] = s * inv[i];
  }
}

// The active-set matrix of the motor LCP: M on the saturated rows and
// columns, the identity elsewhere.
template <int ND>
__device__ __forceinline__ void active_matrix(const bool (&sat)[ND], const float (&M)[ND][ND],
                                              float (&A)[ND][ND]) {
#pragma unroll
  for (int i = 0; i < ND; ++i)
#pragma unroll
    for (int j = 0; j < ND; ++j) A[i][j] = (sat[i] && sat[j]) ? M[i][j] : (i == j ? 1.0f : 0.0f);
}

// Row i of M v, for the lane that owns row i (matvec order of ops).
template <int ND>
__device__ __forceinline__ float row_dot(const float (&Mi)[ND], const float (&v)[ND]) {
  float s = Mi[0] * v[0];
#pragma unroll
  for (int j = 1; j < ND; ++j) s = s + Mi[j] * v[j];
  return s;
}
__device__ __forceinline__ void load7(const float* p, float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = p[i];
}
__device__ __forceinline__ void store7(float* p, const float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) p[i] = v[i];
}

// One substep of one env on its group of 8 lanes (scalarized.py:
// motor_substep).  cold: seed the active set from the unconstrained pass and
// run cold_iters refinements; else refine the carried (sat, sign) warm_iters
// times.  Updates q, qd unless seed_only, and always returns the new
// (sat, sign).  Every lane holds the env's full q, qd, tgt, sat and sign and
// leaves with the same values; all 8 lanes must call it together.
__device__ __forceinline__ void motor_substep(const Args& a, const Lane& me, Scratch& s,
                                              float (&q)[N], float (&qd)[N],
                                              const float (&tgt)[N], const float (&tau)[N],
                                              bool has_tau, bool cold, bool seed_only,
                                              bool (&sat)[N], float (&sign)[N]) {
  const Model& m = a.m;
  float v_des[N];
#pragma unroll
  for (int d = 0; d < N; ++d) {
    const float v = a.ctrl_mode == 0 ? a.vgain * (tgt[d] - q[d]) : tgt[d];
    v_des[d] = fminf(fmaxf(v, -m.vel_limit[d]), m.vel_limit[d]);
  }

  {
    const M3 R = joint_R(me.XR, me.ax, pick(me.d, q));
#pragma unroll
    for (int i = 0; i < 9; ++i) s.X[me.l][i] = R.a[i];
  }
  __syncwarp();

  float bias[N], M[N][N], Mr[N];
  bias_and_mass(a, me, s, qd, bias);
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      M[i][j] = s.M[i][j];
      M[j][i] = M[i][j];
    }
  // row me.d of M, for the products split by row
#pragma unroll
  for (int j = 0; j < N; ++j) Mr[j] = j <= me.d ? s.M[me.d][j] : s.M[j][me.d];

  // Factor M for the free-velocity solve.  In the warm pass the first
  // active-set matrix depends only on the carried active set, so it is
  // factored in the same instructions: lanes 0-3 factor M, lanes 4-7 A.
  float L[N][N], inv[N];
  {
    float A[N][N], F[N][N];
    active_matrix(sat, M, A);
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) F[i][j] = (cold || me.l < 4) ? M[i][j] : A[i][j];
    cholesky_factor(F, L, inv);
  }
  float rhs[N], fv[N];
#pragma unroll
  for (int i = 0; i < N; ++i) rhs[i] = has_tau ? tau[i] - bias[i] : -bias[i];
  cholesky_subst(L, inv, rhs, fv);
  if (me.l == 0) store7(s.G[4], fv);
  __syncwarp();
  load7(s.G[4], fv);
  float qd_free[N], Mqf[N];
#pragma unroll
  for (int d = 0; d < N; ++d) qd_free[d] = qd[d] + a.dt * fv[d];
  s.G[0][me.l] = row_dot(Mr, qd_free);
  if (cold) s.G[1][me.l] = row_dot(Mr, v_des);
  __syncwarp();
  load7(s.G[0], Mqf);

  float c[N], x[N];
  int n_iters;
  if (cold) {
    float Mv[N];
    load7(s.G[1], Mv);
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
    if (cold || it > 0) {
      float A[N][N];
      active_matrix(sat, M, A);
      cholesky_factor(A, L, inv);
    }
    float vf[N], mvf[N];
#pragma unroll
    for (int i = 0; i < N; ++i) vf[i] = sat[i] ? 0.0f : v_des[i];
    s.G[2][me.l] = row_dot(Mr, vf);
    __syncwarp();
    load7(s.G[2], mvf);
#pragma unroll
    for (int i = 0; i < N; ++i) rhs[i] = sat[i] ? (c[i] + Mqf[i]) - mvf[i] : v_des[i];
    cholesky_subst(L, inv, rhs, u);  // lanes 4-7 hold the factor of A
    if (me.l == 4) store7(s.G[5], u);
    __syncwarp();
    load7(s.G[5], u);
    float Mu[N];
    s.G[3][me.l] = row_dot(Mr, u);
    __syncwarp();
    load7(s.G[3], Mu);
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

__global__ void __launch_bounds__(THREADS)
motor_steps_lanes_kernel(const float* __restrict__ q_in, const float* __restrict__ qd_in,
                   const float* __restrict__ tgt_in, float* __restrict__ q_out,
                   float* __restrict__ qd_out, int B, const Args a, const Carry c) {
  __shared__ Scratch scratch[GROUPS];
  const Model& m = a.m;
  Lane me;
  me.l = threadIdx.x % LANES;
  me.d = me.l < N ? me.l : N - 1;
  me.r = me.l < 3 ? me.l : 2;
  me.ax = pick_v3(me.d, m.axis);
  me.com = pick_v3(me.d, m.com);
  me.XR = pick_m3(me.d, m.XR);
  me.I = pick_m3(me.d, m.inertia);
  me.mass = pick(me.d, m.mass);

  const int g = threadIdx.x / LANES;
  const int b = blockIdx.x * GROUPS + g;
  const long long off = static_cast<long long>(b < B ? b : B - 1) * N;
  Scratch& s = scratch[g];
  float q[N], qd[N], tgt[N];
#pragma unroll
  for (int d = 0; d < N; ++d) {
    q[d] = q_in[off + d];
    qd[d] = qd_in[off + d];
    tgt[d] = tgt_in[off + d];
  }
  // constant parts of the scratch: the joint origins and axes, and the
  // composite of the last link (its own body)
  store3(s.X[me.l] + 9, pick_v3(me.d, m.Xp));
  store3(s.X[me.l] + 12, me.ax);
  if (me.l < 3) {
#pragma unroll
    for (int k = 0; k < N; ++k)
      store3(s.I0[me.r][k], pick3(me.r, load3(m.inertia[k]), load3(m.inertia[k] + 3),
                                  load3(m.inertia[k] + 6)));
    store3(s.C[N - 1] + 3 * me.r, load3(s.I0[me.r][N - 1]));
  }
  if (me.l == 0) {
    store3(s.C[N - 1] + 9, load3(m.com[N - 1]));
    s.C[N - 1][12] = m.mass[N - 1];
  }
  // (made visible by the first __syncwarp() of the substep)

  float tau[N] = {};
  bool sat[N] = {};
  float sign[N] = {};
  load_carry(c, off, tau, sat, sign);
  // warm: a cold pre-solve on the initial system keeps only the active set,
  // unless the set is carried in; it ignores tau_ext
  if (a.seed || (a.warm && c.sat_in == nullptr))
    motor_substep(a, me, s, q, qd, tgt, tau, false, /*cold=*/true, /*seed_only=*/true, sat,
                  sign);
  if (!a.seed) {
#pragma unroll 1
    for (int k = 0; k < a.n_substeps; ++k)
      motor_substep(a, me, s, q, qd, tgt, tau, c.tau != nullptr, /*cold=*/!a.warm,
                    /*seed_only=*/false, sat, sign);
  }
  // lane d stores element d of each output
  if (b < B && me.l < N) {
    if (!a.seed) {
      q_out[off + me.l] = pick(me.l, q);
      qd_out[off + me.l] = pick(me.l, qd);
    }
    if (c.sat_out != nullptr) {
      c.sat_out[off + me.l] = pick_sat(me.l, sat);
      c.sign_out[off + me.l] = pick(me.l, sign);
    }
  }
}

// ---------------------------------------------------------------------------
// One env per thread (the kernel for batches past one wave of the lane
// groups, and for every batch of the chains other than the welded Panda).
// The whole chain runs in registers; the model tables are read from the
// constant bank at addresses uniform to the warp.  A template on the chain C:
// its parents and joint types are compile-time constants, so every loop
// over the links unrolls into straight code on fixed registers.

// skew(v) skew(v)^T
__device__ __forceinline__ M3 skew_sq(V3 v) {
  const V3 r0 = skew_sq_row(0, v), r1 = skew_sq_row(1, v), r2 = skew_sq_row(2, v);
  return {{r0.x, r0.y, r0.z, r1.x, r1.y, r1.z, r2.x, r2.y, r2.z}};
}
__device__ __forceinline__ M3 mT(const M3& A) {
  M3 r;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) r.a[3 * i + j] = A.a[3 * j + i];
  return r;
}

// Child-body frame (R, p) in parent coords of every joint at q
// (scalarized.py:_joint_X): a revolute joint turns its frame about the axis;
// a prismatic one keeps the frame and slides its origin by R (q axis).  P
// holds the origins of the prismatic joints only; joint_p reads a revolute
// joint's fixed origin from the constant bank where it is used, so that the
// revolute chains keep no origin in registers.
template <class C>
__device__ __forceinline__ void joint_frames(const ModelT<C::N>& m, const float (&q)[C::N],
                                             M3 (&R)[C::N], V3 (&P)[C::N]) {
#pragma unroll
  for (int d = 0; d < C::N; ++d) {
    if (C::prismatic(d)) {
      R[d] = load9(m.XR[d]);
      P[d] = vadd(load3(m.Xp[d]), mv(R[d], vscale(q[d], load3(m.axis[d]))));
    } else {
      R[d] = joint_R(load9(m.XR[d]), load3(m.axis[d]), q[d]);
      P[d] = V3{0.f, 0.f, 0.f};
    }
  }
}
template <class C>
__device__ __forceinline__ V3 joint_p(const ModelT<C::N>& m, const V3 (&P)[C::N], int d) {
  return C::prismatic(d) ? P[d] : load3(m.Xp[d]);
}

// Bias force C(q, qd) qd + G(q) by RNEA with qdd = 0 (scalarized.py:rnea).
// A prismatic joint's velocity enters v, not om, and its torque is the
// force along the axis; each link's force joins its parent's, the children
// of a branch from the last dof down.  A serial revolute chain keeps the
// form that carries only the previous link's motion, which compiles to
// fewer spilled registers.
template <class C>
__device__ __forceinline__ void rnea_bias(const ModelT<C::N>& m, const M3 (&R)[C::N],
                                          const V3 (&P)[C::N], const float (&qd)[C::N],
                                          float (&tau)[C::N]) {
  constexpr int ND = C::N;
  V3 fn[ND], ff[ND];
  if constexpr (C::serial) {
    V3 om_p = {0.f, 0.f, 0.f}, v_p = {0.f, 0.f, 0.f};
    V3 aom_p = {0.f, 0.f, 0.f}, av_p = {0.f, 0.f, 9.81f};  // base accel = -g
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      const V3 p = load3(m.Xp[d]);
      V3 om = mtv(R[d], om_p);
      V3 vv = mtv(R[d], vadd(v_p, vcross(om_p, p)));
      V3 aom = mtv(R[d], aom_p);
      V3 av = mtv(R[d], vadd(av_p, vcross(aom_p, p)));
      const V3 vj = vscale(qd[d], load3(m.axis[d]));
      om = vadd(om, vj);
      aom = vadd(aom, vcross(om, vj));
      av = vadd(av, vcross(vv, vj));
      const float ms = m.mass[d];
      const V3 c = load3(m.com[d]);
      const M3 I = load9(m.inertia[d]);
      V3 hn, hf, n, f;
      inertia_mul(ms, c, I, om, vv, hn, hf);
      inertia_mul(ms, c, I, aom, av, n, f);
      fn[d] = vadd(n, vadd(vcross(om, hn), vcross(vv, hf)));
      ff[d] = vadd(f, vcross(om, hf));
      om_p = om; v_p = vv; aom_p = aom; av_p = av;
    }
  } else {
    V3 om[ND], v[ND], aom[ND], av[ND];
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      const int pd = C::parent(d);
      const int pi = pd < 0 ? 0 : pd;
      const V3 zero = {0.f, 0.f, 0.f};
      const V3 om_p = pd < 0 ? zero : om[pi], v_p = pd < 0 ? zero : v[pi];
      const V3 aom_p = pd < 0 ? zero : aom[pi];
      const V3 av_p = pd < 0 ? V3{0.f, 0.f, 9.81f} : av[pi];  // base accel = -g
      const V3 p = joint_p<C>(m, P, d);
      V3 o = mtv(R[d], om_p);
      V3 vv = mtv(R[d], vadd(v_p, vcross(om_p, p)));
      V3 ao = mtv(R[d], aom_p);
      V3 a = mtv(R[d], vadd(av_p, vcross(aom_p, p)));
      const V3 vj = vscale(qd[d], load3(m.axis[d]));
      if (C::prismatic(d)) {
        vv = vadd(vv, vj);
        a = vadd(a, vcross(o, vj));
      } else {
        o = vadd(o, vj);
        ao = vadd(ao, vcross(o, vj));
        a = vadd(a, vcross(vv, vj));
      }
      const float ms = m.mass[d];
      const V3 c = load3(m.com[d]);
      const M3 I = load9(m.inertia[d]);
      V3 hn, hf, n, f;
      inertia_mul(ms, c, I, o, vv, hn, hf);
      inertia_mul(ms, c, I, ao, a, n, f);
      fn[d] = vadd(n, vadd(vcross(o, hn), vcross(vv, hf)));
      ff[d] = vadd(f, vcross(o, hf));
      om[d] = o; v[d] = vv; aom[d] = ao; av[d] = a;
    }
  }
#pragma unroll
  for (int d = ND - 1; d >= 0; --d) {
    tau[d] = vdot(load3(m.axis[d]), C::prismatic(d) ? ff[d] : fn[d]);
    const int pd = C::parent(d);
    if (pd >= 0) {
      V3 n = fn[d], f = ff[d];
      force_to_parent(R[d], joint_p<C>(m, P, d), n, f);
      fn[pd] = vadd(fn[pd], n);
      ff[pd] = vadd(ff[pd], f);
    }
  }
}

// Joint-space mass matrix by CRBA (scalarized.py:crba); fills the full
// matrix.  The composite masses and CoM weights come folded from the host.
// Each link's composite joins its parent's from the last dof down; each
// column walks from its dof to the base through the parents, so the entries
// of two dofs that are not each other's ancestors stay exact zeros (a
// serial chain writes every entry).
template <class C>
__device__ __forceinline__ void crba(const ArgsT<C::N>& a, const M3 (&R)[C::N],
                                     const V3 (&P)[C::N], float (&M)[C::N][C::N]) {
  constexpr int ND = C::N;
  const ModelT<ND>& m = a.m;
  V3 cc[ND];
  M3 Ic[ND];
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    cc[d] = load3(m.com[d]);
    Ic[d] = load9(m.inertia[d]);
  }
#pragma unroll
  for (int d = ND - 1; d >= 0; --d) {
    const int pd = C::parent(d);
    if (pd < 0) continue;
    // child inertia in parent coords (scalarized.py:_inertia_to_parent)
    const float m_c = a.comp_m[d];
    const V3 c_p = vadd(mv(R[d], cc[d]), joint_p<C>(m, P, d));
    const M3 sk = skew_sq(cc[d]);
    M3 I_com;
#pragma unroll
    for (int i = 0; i < 9; ++i) I_com.a[i] = Ic[d].a[i] - m_c * sk.a[i];
    const M3 I_com_p = mm(R[d], mm(I_com, mT(R[d])));
    const M3 skp = skew_sq(c_p);
    // a serial chain's parent holds only its own mass when its one child
    // joins it
    float m_p;
    if constexpr (C::serial) m_p = m.mass[pd];
    else m_p = a.comp_mp[d];
    cc[pd] = vscale(a.comp_w[d], vadd(vscale(m_p, cc[pd]), vscale(m_c, c_p)));
#pragma unroll
    for (int i = 0; i < 9; ++i) Ic[pd].a[i] = Ic[pd].a[i] + (I_com_p.a[i] + m_c * skp.a[i]);
  }
  if constexpr (!C::serial) {
#pragma unroll
    for (int i = 0; i < ND; ++i)
#pragma unroll
      for (int j = 0; j < ND; ++j) M[i][j] = 0.0f;
  }
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    const V3 ax = load3(m.axis[d]);
    const V3 zero = {0.f, 0.f, 0.f};
    V3 Fn, Ff;
    if (C::prismatic(d)) {
      inertia_mul(a.comp_m[d], cc[d], Ic[d], zero, ax, Fn, Ff);
      M[d][d] = vdot(ax, Ff);
    } else {
      inertia_mul(a.comp_m[d], cc[d], Ic[d], ax, zero, Fn, Ff);
      M[d][d] = vdot(ax, Fn);
    }
    int j = d;
#pragma unroll
    for (int h = 0; h < ND; ++h) {
      const int pj = C::parent(j);
      if (pj < 0) break;
      force_to_parent(R[j], joint_p<C>(m, P, j), Fn, Ff);
      const float Mdj = vdot(load3(m.axis[pj]), C::prismatic(pj) ? Ff : Fn);
      M[d][pj] = Mdj;
      M[pj][d] = Mdj;
      j = pj;
    }
  }
}

template <int ND>
__device__ __forceinline__ void matvec(const float (&M)[ND][ND], const float (&v)[ND],
                                       float (&out)[ND]) {
#pragma unroll
  for (int i = 0; i < ND; ++i) out[i] = row_dot(M[i], v);
}

// One substep of one env on one thread (scalarized.py:motor_substep); the
// same steps as motor_substep above, every one on this thread.
template <class C>
__device__ __forceinline__ void thread_substep(const ArgsT<C::N>& a, float (&q)[C::N],
                                               float (&qd)[C::N], const float (&tgt)[C::N],
                                               const float (&tau)[C::N], bool has_tau, bool cold,
                                               bool seed_only, bool (&sat)[C::N],
                                               float (&sign)[C::N]) {
  constexpr int ND = C::N;
  const ModelT<ND>& m = a.m;
  float v_des[ND];
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    const float v = a.ctrl_mode == 0 ? a.vgain * (tgt[d] - q[d]) : tgt[d];
    v_des[d] = fminf(fmaxf(v, -m.vel_limit[d]), m.vel_limit[d]);
  }
  M3 R[ND];
  V3 P[ND];
  joint_frames<C>(m, q, R, P);

  float bias[ND], M[ND][ND];
  rnea_bias<C>(m, R, P, qd, bias);
  crba<C>(a, R, P, M);

  float L[ND][ND], inv[ND], rhs[ND], fv[ND];
  cholesky_factor(M, L, inv);
#pragma unroll
  for (int i = 0; i < ND; ++i) rhs[i] = has_tau ? tau[i] - bias[i] : -bias[i];
  cholesky_subst(L, inv, rhs, fv);
  float qd_free[ND], Mqf[ND];
#pragma unroll
  for (int d = 0; d < ND; ++d) qd_free[d] = qd[d] + a.dt * fv[d];
  matvec(M, qd_free, Mqf);

  float c[ND], x[ND];
  int n_iters;
  if (cold) {
    float Mv[ND];
    matvec(M, v_des, Mv);
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      x[i] = Mv[i] - Mqf[i];
      sat[i] = fabsf(x[i]) > a.cap[i];
      c[i] = fminf(fmaxf(x[i], -a.cap[i]), a.cap[i]);
    }
    n_iters = a.cold_iters;
  } else {
#pragma unroll
    for (int i = 0; i < ND; ++i) c[i] = a.cap[i] * sign[i];
    n_iters = a.warm_iters;
  }

  float u[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) u[i] = v_des[i];
#pragma unroll 1
  for (int it = 0; it < n_iters; ++it) {
    float A[ND][ND], vf[ND], mvf[ND], Mu[ND];
    active_matrix(sat, M, A);
    cholesky_factor(A, L, inv);
#pragma unroll
    for (int i = 0; i < ND; ++i) vf[i] = sat[i] ? 0.0f : v_des[i];
    matvec(M, vf, mvf);
#pragma unroll
    for (int i = 0; i < ND; ++i) rhs[i] = sat[i] ? (c[i] + Mqf[i]) - mvf[i] : v_des[i];
    cholesky_subst(L, inv, rhs, u);
    matvec(M, u, Mu);
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      x[i] = Mu[i] - Mqf[i];
      sat[i] = sat[i] ? ((v_des[i] - u[i]) * c[i] >= 0.0f) : (fabsf(x[i]) > a.cap[i]);
      c[i] = fminf(fmaxf(x[i], -a.cap[i]), a.cap[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < ND; ++i) sign[i] = x[i] >= 0.0f ? 1.0f : -1.0f;
  if (seed_only) return;

#pragma unroll
  for (int d = 0; d < ND; ++d) {
    const float q_new = q[d] + a.dt * u[d];
    const float q_cl = fminf(fmaxf(q_new, m.q_lo[d]), m.q_hi[d]);
    qd[d] = q_cl != q_new ? 0.0f : u[d];
    q[d] = q_cl;
  }
}

template <class C>
__global__ void __launch_bounds__(THREADS)
motor_steps_thread_kernel(const float* __restrict__ q_in, const float* __restrict__ qd_in,
                          const float* __restrict__ tgt_in, float* __restrict__ q_out,
                          float* __restrict__ qd_out, int B, const ArgsT<C::N> a,
                          const Carry c) {
  constexpr int ND = C::N;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const long long off = static_cast<long long>(b) * ND;
  float q[ND], qd[ND], tgt[ND];
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    q[d] = q_in[off + d];
    qd[d] = qd_in[off + d];
    tgt[d] = tgt_in[off + d];
  }
  float tau[ND] = {};
  bool sat[ND] = {};
  float sign[ND] = {};
  load_carry(c, off, tau, sat, sign);
  if (a.seed || (a.warm && c.sat_in == nullptr))
    thread_substep<C>(a, q, qd, tgt, tau, false, /*cold=*/true, /*seed_only=*/true, sat, sign);
  if (!a.seed) {
#pragma unroll 1
    for (int k = 0; k < a.n_substeps; ++k)
      thread_substep<C>(a, q, qd, tgt, tau, c.tau != nullptr, /*cold=*/!a.warm,
                        /*seed_only=*/false, sat, sign);
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      q_out[off + d] = q[d];
      qd_out[off + d] = qd[d];
    }
  }
  if (c.sat_out != nullptr) {
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      c.sat_out[off + d] = sat[d] ? 1 : 0;
      c.sign_out[off + d] = sign[d];
    }
  }
}

// The kernel argument block of chain C: the model table, the impulse caps,
// and the composite masses and CoM weights of CRBA, which do not depend on q
// and are folded here in float as the kernel would compute them: each dof's
// composite joins its parent's, from the last dof down (for the welded
// Panda, link d into link d-1).
template <class C>
void fill_args(ArgsT<C::N>& a, const float* model, int n_substeps, double dt, int ctrl_mode,
               double position_gain, int cold_iters, int warm_iters, int warm, int seed) {
  constexpr int ND = C::N;
  memcpy(&a.m, model, sizeof(ModelT<ND>));
  for (int d = 0; d < ND; ++d) {
    a.cap[d] = static_cast<float>(dt * a.m.effort[d]);
    a.comp_m[d] = a.m.mass[d];
    a.comp_mp[d] = 0.0f;
    a.comp_w[d] = 0.0f;
  }
  for (int d = ND - 1; d >= 0; --d) {
    const int pd = C::parent(d);
    if (pd < 0) continue;
    a.comp_mp[d] = a.comp_m[pd];
    a.comp_m[pd] = a.comp_m[pd] + a.comp_m[d];
    a.comp_w[d] = 1.0f / fmaxf(a.comp_m[pd], 1e-12f);
  }
  a.vgain = static_cast<float>(position_gain * (1.0 / dt));
  a.dt = static_cast<float>(dt);
  a.n_substeps = n_substeps;
  a.ctrl_mode = ctrl_mode;
  a.cold_iters = cold_iters;
  a.warm_iters = warm_iters;
  a.warm = warm;
  a.seed = seed;
}

// One launch of the one-env-per-thread kernel of chain C.
template <class C>
int launch_chain(const float* q, const float* qd, const float* tgt, float* q_out,
                 float* qd_out, int B, const float* model, int n_substeps, double dt,
                 int ctrl_mode, double position_gain, int cold_iters, int warm_iters,
                 void* stream, int warm, const Carry& c, int seed) {
  ArgsT<C::N> a;
  fill_args<C>(a, model, n_substeps, dt, ctrl_mode, position_gain, cold_iters, warm_iters,
               warm, seed);
  if (B > 0) {
    const int blocks = (B + THREADS - 1) / THREADS;
    motor_steps_thread_kernel<C><<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        q, qd, tgt, q_out, qd_out, B, a, c);
  }
  return static_cast<int>(cudaGetLastError());
}

// the chain ids of the C interface, in the order of the chain list above
constexpr int N_CHAINS = 3;
constexpr int CHAIN_NDOF[N_CHAINS] = {PandaChain::N, MyCobotChain::N, GripperPandaChain::N};

}  // namespace

// C entry point, bound with ctypes by ops/cuda_dynamics.py.  Launches K1 for
// chain `chain` (0 the welded Panda, 1 MyCobot, 2 the 9-dof Panda): the
// lane-group kernel (lanes_per_env 8, the welded Panda only) or the
// one-env-per-thread kernel (lanes_per_env 1), warm-started (warm 1) or cold
// (warm 0), on the caller's stream on card `device`, and returns
// cudaGetLastError() (0 on success).  Optional, (B, ndof) each, null where
// not given: tau (the contact torque), sat_in/sign_in (a carried active set,
// read in place of the seed when warm), sat_out/sign_out (the set after the
// launch).  seed 1 runs only the cold pre-solve and writes the set to
// sat_out/sign_out, and nothing else.
extern "C" int motor_steps_launch(const float* q, const float* qd, const float* tgt,
                                  float* q_out, float* qd_out, int B, const float* model,
                                  int n_substeps, double dt, int ctrl_mode,
                                  double position_gain, int cold_iters, int warm_iters,
                                  int device, void* stream, int lanes_per_env, int warm,
                                  const float* tau, const unsigned char* sat_in,
                                  const float* sign_in, unsigned char* sat_out,
                                  float* sign_out, int seed, int chain) {
  if (chain < 0 || chain >= N_CHAINS || (lanes_per_env != LANES && lanes_per_env != 1) ||
      (lanes_per_env == LANES && chain != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((sat_in == nullptr) != (sign_in == nullptr) ||
      (sat_out == nullptr) != (sign_out == nullptr) || (seed && sat_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const Carry c = {tau, sat_in, sign_in, sat_out, sign_out};
  if (lanes_per_env == LANES) {
    Args a;
    fill_args<PandaChain>(a, model, n_substeps, dt, ctrl_mode, position_gain, cold_iters,
                          warm_iters, warm, seed);
    if (B > 0) {
      const int blocks = (B + GROUPS - 1) / GROUPS;
      motor_steps_lanes_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
          q, qd, tgt, q_out, qd_out, B, a, c);
    }
    return static_cast<int>(cudaGetLastError());
  }
  if (chain == 0)
    return launch_chain<PandaChain>(q, qd, tgt, q_out, qd_out, B, model, n_substeps, dt,
                                    ctrl_mode, position_gain, cold_iters, warm_iters, stream,
                                    warm, c, seed);
  if (chain == 1)
    return launch_chain<MyCobotChain>(q, qd, tgt, q_out, qd_out, B, model, n_substeps, dt,
                                      ctrl_mode, position_gain, cold_iters, warm_iters, stream,
                                      warm, c, seed);
  return launch_chain<GripperPandaChain>(q, qd, tgt, q_out, qd_out, B, model, n_substeps, dt,
                                         ctrl_mode, position_gain, cold_iters, warm_iters,
                                         stream, warm, c, seed);
}

// Number of floats the model table of chain `chain` must hold (checked by
// the wrapper); 0 for an unknown chain.
extern "C" int motor_steps_model_floats(int chain) {
  if (chain < 0 || chain >= N_CHAINS) return 0;
  return static_cast<int>(sizeof(ModelT<1>) / sizeof(float)) * CHAIN_NDOF[chain];
}

// What the card makes of a kernel (lanes_per_env and chain as for the
// launch): resident blocks per SM (the card's own occupancy query),
// registers per thread, local memory per thread in bytes, and threads per
// block.  Returns a cudaError_t (0 on success).
extern "C" int motor_steps_occupancy(int device, int lanes_per_env, int chain,
                                     int* blocks_per_sm, int* regs, int* local_bytes,
                                     int* threads) {
  if (chain < 0 || chain >= N_CHAINS || (lanes_per_env != LANES && lanes_per_env != 1) ||
      (lanes_per_env == LANES && chain != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const void* kernel =
      lanes_per_env == LANES ? reinterpret_cast<const void*>(motor_steps_lanes_kernel)
      : chain == 0           ? reinterpret_cast<const void*>(motor_steps_thread_kernel<PandaChain>)
      : chain == 1 ? reinterpret_cast<const void*>(motor_steps_thread_kernel<MyCobotChain>)
                   : reinterpret_cast<const void*>(motor_steps_thread_kernel<GripperPandaChain>);
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, THREADS, 0);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *threads = THREADS;
  return static_cast<int>(e);
}
