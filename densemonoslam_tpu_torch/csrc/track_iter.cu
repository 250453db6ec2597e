// One whole dense-tracking iteration per launch: the per-pixel rows, their
// Gram sums, the 6x6 (or 3x3) solve and the pose update with its frozen
// carry (kernel K1 in its fused form).
//
// Replaces, on the TPU side, `gram_pallas`
// (`densemonoslam_tpu/ops/pallas/gram.py`) together with the XLA-fused row
// build before it (`reductions.joint_rows_packed` / `joint_rows_frozen` /
// `so3_rows_packed` / `so3_rows_frozen`) and the solve and update after it
// (`reductions.combined_system`, `solve_se3`, `solve_so3`,
// `odometry._advance` and the SO3 pre-align's rollback).  XLA fuses that
// chain into a few programs around the Pallas kernel; on the card, op by op,
// it was ~200 launches a Gauss-Newton iteration and ~135 an SO3 iteration,
// each a few microseconds of fixed cost for well under one of work.
//
// What bounds it on Hopper: the launch, then the latency of one dependent
// chain per row (frame maps -> transform -> project -> model gather ->
// gates -> Gram update), then the cross-block step and one thread's solve.
// The bytes are small: a row reads 7 floats of frame maps and the frozen
// sample (12), one nearest model texel (12) or four bilinear ones (36),
// 9-43 floats in all (SO3: its intensity and 8 or 36); 0.1-7 MB an
// iteration, 0.05-2 us at 3.35 TB/s.  So the
// design spends one launch per iteration, keeps a row's whole chain in
// registers (the rows never reach device memory), and reads back nothing:
// the carry the next launch starts from stays in device memory.
//
// Design: one launch, no float atomics, bit-identical from run to run.
//   rows     row r of the level's grid (P = h x w, the frame maps read
//            through their strides, so a row-strided view costs nothing)
//            goes to thread r mod THREADS of block (r / THREADS) mod
//            blocks, in increasing r; the block count follows P alone.
//            Each thread builds its rows with the plain builders' gates,
//            constants and order of operations (compiled without FMA
//            contraction, so the row values round as the op-by-op
//            composition's do) and adds the rows that pass into the sums
//            `combined_system` reads: per 8-column block, the upper
//            triangle of JtJ (21), Jtr (6), sum r^2 and the inlier count
//            (58 sums for the joint ICP + RGB rows; 11 for SO3).
//   frozen   the first frozen iteration of a level samples the model at
//            the current estimate (its rows are the exact rows: the drift
//            is 0) and writes the sample, 12 floats a row (8 for SO3); the
//            later ones read it.  An out-of-bounds sample stores a NaN
//            position, which fails the drift gate like the in-bounds flag.
//   reduce   K1's scheme: each warp sums its lanes in a fixed butterfly,
//            the block its warps in order, into per-block partials; one
//            thread draws an integer ticket with a release/acquire atomic;
//            the block that draws the last one sums every block's partials
//            in block order (split sums, all loads in flight together,
//            combined in split order).
//   update   that block's thread 0 forms JtJ and Jtr (ICP weight squared,
//            the RGB unit scale), solves with closed-form 3x3 inverses
//            (the Schur complement for SE3), applies the `ok` test and the
//            exp-map update, and writes the carry (pose, the five stats,
//            `done`; for SO3 the best rotation, its error and the
//            rollback) for the next launch; optionally also the carry it
//            started from and the level's starvation flag.  Then it resets
//            the ticket.
// The scratch and the ticket belong to one stream (the wrapper keeps one
// pair per device and stream), so two streams never share a ticket.  The
// CUDA-only parts sit under __CUDACC__: the row, solve and update functions
// also compile as plain C++ (without FMA contraction) for a CPU emulation.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define TI_FN __host__ __device__ __forceinline__
#else
#define TI_FN inline
#endif
#include <math.h>

namespace track_iter {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_BLOCKS = 256;

// the sums of one 8-column block: JtJ upper triangle, Jtr, sum r^2, count
constexpr int GN_BLOCK = 29;
constexpr int GN_SUMS = 2 * GN_BLOCK;  // ICP then RGB
constexpr int SO3_SUMS = 11;           // JtJ3 upper (6), Jtr3 (3), sum r^2, count

// GN carry: pose, the five stats, done (0 / 1)
constexpr int C_A = 0, C_ICP_ERR = 16, C_ICP_INL = 17, C_RGB_ERR = 18, C_RGB_INL = 19,
              C_JTJ = 20, C_DONE = 56, GN_CARRY = 64;
// SO3 carry: pose (its rotation is the estimate), best rotation, its error, done
constexpr int S_RBEST = 16, S_ERRBEST = 25, S_DONE = 26, SO3_CARRY = 32;
constexpr int GN_SAMPLE = 12, SO3_SAMPLE = 8;  // floats of a frozen sample row

struct Params {
  // the level's frame maps, element strides (the channel stride is 1)
  const float* vc;
  long long vc_sy, vc_sx;
  const float* nc;
  long long nc_sy, nc_sx;
  const float* ic;
  long long ic_sy, ic_sx;
  int h, w;  // the rows' grid
  // the level's packed model [Hm, Wm, 12] (`reductions.pack_model`)
  const float* pack;
  int Hm, Wm;
  float* sample;  // the frozen sample (FROZEN reads it; write_sample writes it)
  int write_sample;
  float fx, fy, cx, cy;
  float w2, rgb_scale, damping, drift;
  float dist_thresh, angle_thresh, min_grad2, max_residual, occlusion_thresh;
  float min_inliers, step_tol;
  const float* carry_in;  // fresh: only its first 16 floats, the pose, are read
  float* carry_out;       // may be carry_in
  int fresh;
  float* pre_out;              // nullable: the carry this iteration started from
  unsigned char* starved_out;  // nullable: !done && !ok
  float* sums_out;             // the reduced sums
  float* partials;
  unsigned* ticket;
};

struct Sample {
  float vx, vy, vz, nx, ny, nz, i, gx, gy, z;
  bool inb;
};

struct F4 {
  float x, y, z, w;
};

TI_FN F4 load4(const float* p) {
#ifdef __CUDA_ARCH__
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  return F4{q.x, q.y, q.z, q.w};
#else
  return F4{p[0], p[1], p[2], p[3]};
#endif
}

TI_FN void store4(float* p, float x, float y, float z, float w) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<float4*>(p) = make_float4(x, y, z, w);
#else
  p[0] = x; p[1] = y; p[2] = z; p[3] = w;
#endif
}

// `geometry.project`
TI_FN void project(float x, float y, float z, const Params& p, float& u, float& v) {
  const float zs = fabsf(z) > 1e-9f ? z : 1e-9f;
  u = x / zs * p.fx + p.cx;
  v = y / zs * p.fy + p.cy;
}

// `reductions.sample_model` on the packed model at (u, v)
template <bool BILINEAR>
TI_FN Sample sample_model(const Params& p, float u, float v) {
  const int H = p.Hm, W = p.Wm;
  Sample s;
  s.inb = (u >= 0.0f) & (u <= static_cast<float>(W - 1)) & (v >= 0.0f) &
          (v <= static_cast<float>(H - 1));
  const float uc = fminf(fmaxf(u, 0.0f), static_cast<float>(W - 1.001));
  const float vc = fminf(fmaxf(v, 0.0f), static_cast<float>(H - 1.001));
  if (!BILINEAR) {
    const long long idx = static_cast<long long>(rintf(vc)) * W + static_cast<long long>(rintf(uc));
    const float* t = p.pack + idx * 12;
    const F4 q0 = load4(t), q1 = load4(t + 4), q2 = load4(t + 8);
    s.vx = q0.x; s.vy = q0.y; s.vz = q0.z; s.nx = q0.w;
    s.ny = q1.x; s.nz = q1.y; s.i = q1.z; s.gx = q1.w;
    s.gy = q2.x; s.z = q2.y;
    return s;
  }
  const float fu0 = floorf(uc), fv0 = floorf(vc);
  const float fu = uc - fu0, fv = vc - fv0;
  const long long base = static_cast<long long>(fv0) * W + static_cast<long long>(fu0);
  const float* c00 = p.pack + base * 12;
  const float* c01 = c00 + 12;
  const float* c10 = c00 + 12LL * W;
  const float* c11 = c10 + 12;
  const F4 a00 = load4(c00 + 4), a01 = load4(c01 + 4), a10 = load4(c10 + 4), a11 = load4(c11 + 4);
  const F4 b00 = load4(c00 + 8), b01 = load4(c01 + 8), b10 = load4(c10 + 8), b11 = load4(c11 + 8);
  const bool right = fu > 0.5f, down = fv > 0.5f;
  const float* sel = down ? (right ? c11 : c10) : (right ? c01 : c00);
  const F4 q0 = load4(sel);
  const F4 q1 = down ? (right ? a11 : a10) : (right ? a01 : a00);
  s.vx = q0.x; s.vy = q0.y; s.vz = q0.z; s.nx = q0.w;
  s.ny = q1.x; s.nz = q1.y;
  // c00 * (1 - fu) * (1 - fv) + c01 * fu * (1 - fv) + c10 * (1 - fu) * fv + c11 * fu * fv
  const float gu = 1.0f - fu, gv = 1.0f - fv;
#define TI_BIL(f00, f01, f10, f11) \
  ((((f00) * gu * gv + (f01) * fu * gv) + (f10) * gu * fv) + (f11) * fu * fv)
  s.i = TI_BIL(a00.z, a01.z, a10.z, a11.z);
  s.gx = TI_BIL(a00.w, a01.w, a10.w, a11.w);
  s.gy = TI_BIL(b00.x, b01.x, b10.x, b11.x);
  s.z = TI_BIL(b00.y, b01.y, b10.y, b11.y);
#undef TI_BIL
  return s;
}

// Add one row [J (N) | r | 1] to the block's sums: JtJ's upper triangle,
// Jtr, r^2, count.
template <int N>
TI_FN void add_row(float* acc, const float* J, float r) {
  int k = 0;
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = i; j < N; ++j, ++k) acc[k] = fmaf(J[i], J[j], acc[k]);
#pragma unroll
  for (int i = 0; i < N; ++i) acc[k + i] = fmaf(J[i], r, acc[k + i]);
  acc[k + N] = fmaf(r, r, acc[k + N]);
  acc[k + N + 1] += 1.0f;
}

// `reductions._image_grad_rows`: dr = g3 . dp for a point and the image
// gradient at its projection
TI_FN void grad_rows(float px, float py, float pz, float gx, float gy, const Params& p,
                     float g3[3]) {
  const float z = fmaxf(pz, 1e-6f);
  const float a = gx * p.fx / z;
  const float b = gy * p.fy / z;
  g3[0] = a;
  g3[1] = b;
  g3[2] = -(a * px + b * py) / z;
}

TI_FN void cross(const float a[3], const float b[3], float c[3]) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

TI_FN float norm3(const float a[3]) { return sqrtf(a[0] * a[0] + a[1] * a[1] + a[2] * a[2]); }

// One joint ICP + RGB row pair (`joint_rows_packed`, or `joint_rows_frozen`
// where FROZEN) of grid pixel (y, x), row r, added to `acc`.
template <bool FROZEN, bool BILINEAR>
TI_FN void gn_row(const Params& p, const float* A, long long r, int y, int x, float* acc) {
  const float* vp = p.vc + y * p.vc_sy + x * p.vc_sx;
  const float* np_ = p.nc + y * p.nc_sy + x * p.nc_sx;
  const float vc[3] = {vp[0], vp[1], vp[2]};
  const float nraw[3] = {np_[0], np_[1], np_[2]};
  const float ic = p.ic[y * p.ic_sy + x * p.ic_sx];
  const bool valid_c = vc[2] > 0.0f;
  float pt[3], nc[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    pt[i] = A[4 * i] * vc[0] + A[4 * i + 1] * vc[1] + A[4 * i + 2] * vc[2] + A[4 * i + 3];
    nc[i] = A[4 * i] * nraw[0] + A[4 * i + 1] * nraw[1] + A[4 * i + 2] * nraw[2];
  }
  float u, v;
  project(pt[0], pt[1], pt[2], p, u, v);
  Sample s;
  bool inb;
  float du = 0.0f, dv = 0.0f;
  if (FROZEN) {
    const float* q = p.sample + r * GN_SAMPLE;
    const F4 q0 = load4(q), q1 = load4(q + 4), q2 = load4(q + 8);
    s.vx = q0.x; s.vy = q0.y; s.vz = q0.z; s.nx = q0.w;
    s.ny = q1.x; s.nz = q1.y; s.i = q1.z; s.gx = q1.w;
    s.gy = q2.x; s.z = q2.y;
    du = u - q2.z;  // NaN where the sample was out of bounds
    dv = v - q2.w;
    inb = (pt[2] > 0.0f) & (fabsf(du) <= p.drift) & (fabsf(dv) <= p.drift);
  } else {
    s = sample_model<BILINEAR>(p, u, v);
    inb = s.inb & (pt[2] > 0.0f);
    if (p.write_sample) {
      float* q = p.sample + r * GN_SAMPLE;
      store4(q, s.vx, s.vy, s.vz, s.nx);
      store4(q + 4, s.ny, s.nz, s.i, s.gx);
      store4(q + 8, s.gy, s.z, s.inb ? u : nanf(""), v);
    }
  }
  // ICP: `_icp_block`
  const float vm[3] = {s.vx, s.vy, s.vz};
  const float nm[3] = {s.nx, s.ny, s.nz};
  const float diff[3] = {pt[0] - vm[0], pt[1] - vm[1], pt[2] - vm[2]};
  float cn[3];
  cross(nc, nm, cn);
  const bool icp = valid_c & inb & (vm[2] > 0.0f) & (norm3(nraw) > 0.5f) &
                   (norm3(diff) < p.dist_thresh) & (norm3(cn) < p.angle_thresh);
  if (icp) {
    float J[6];
    cross(pt, nm, J);
    J[3] = nm[0]; J[4] = nm[1]; J[5] = nm[2];
    add_row<6>(acc, J, nm[0] * diff[0] + nm[1] * diff[1] + nm[2] * diff[2]);
  }
  // RGB: `_rgb_block`
  const float rr = FROZEN ? s.i + s.gx * du + s.gy * dv - ic : s.i - ic;
  const bool rgb = valid_c & inb & (s.gx * s.gx + s.gy * s.gy > p.min_grad2) &
                   (fabsf(rr) < p.max_residual) & (s.z > 0.0f) &
                   (fabsf(pt[2] - s.z) < p.occlusion_thresh);
  if (rgb) {
    float J[6];
    grad_rows(pt[0], pt[1], pt[2], s.gx, s.gy, p, J + 3);
    cross(pt, J + 3, J);
    add_row<6>(acc + GN_BLOCK, J, rr);
  }
}

// One SO3 row (`so3_rows_packed`, or `so3_rows_frozen` where FROZEN) of
// pixel (y, x), row r, added to `acc`.
template <bool FROZEN>
TI_FN void so3_row(const Params& p, const float* A, long long r, int y, int x, float* acc) {
  const float ic = p.ic[y * p.ic_sy + x * p.ic_sx];
  // `unit_rays`, rotated: sum(R * d, -1)
  const float d0 = (static_cast<float>(x) - p.cx) / p.fx;
  const float d1 = (static_cast<float>(y) - p.cy) / p.fy;
  float rd[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) rd[i] = A[4 * i] * d0 + A[4 * i + 1] * d1 + A[4 * i + 2] * 1.0f;
  float u, v;
  project(rd[0], rd[1], rd[2], p, u, v);
  float im, gx, gy, rr;
  bool keep;
  if (FROZEN) {
    const float* q = p.sample + r * SO3_SAMPLE;
    const F4 q0 = load4(q), q1 = load4(q + 4);
    im = q0.x; gx = q0.y; gy = q0.z;
    const float du = u - q0.w, dv = v - q1.x;  // NaN where the sample was out of bounds
    rr = im + gx * du + gy * dv - ic;
    keep = (fabsf(du) <= p.drift) & (fabsf(dv) <= p.drift) & (rd[2] > 0.0f) &
           (fabsf(rr) < p.max_residual);
  } else {
    const Sample s = sample_model<true>(p, u, v);
    im = s.i; gx = s.gx; gy = s.gy;
    rr = im - ic;
    keep = s.inb & (rd[2] > 0.0f) & (fabsf(rr) < p.max_residual);
    if (p.write_sample) {
      float* q = p.sample + r * SO3_SAMPLE;
      store4(q, im, gx, gy, s.inb ? u : nanf(""));
      store4(q + 4, v, 0.0f, 0.0f, 0.0f);
    }
  }
  if (keep) {
    float g3[3], J[3];
    grad_rows(rd[0], rd[1], rd[2], gx, gy, p, g3);
    cross(rd, g3, J);
    add_row<3>(acc, J, rr);
  }
}

// ----------------------------------------------------------------- solve

// `reductions._inv3`: adjugate / determinant, out[i][j] = c_j[i] / det
TI_FN void inv3(const float M[3][3], float out[3][3]) {
  float c[3][3];
  cross(M[1], M[2], c[0]);
  cross(M[2], M[0], c[1]);
  cross(M[0], M[1], c[2]);
  const float det = M[0][0] * c[0][0] + M[0][1] * c[0][1] + M[0][2] * c[0][2];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) out[i][j] = c[j][i] / det;
}

TI_FN void matmul3(const float a[3][3], const float b[3][3], float c[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) c[i][j] = a[i][0] * b[0][j] + a[i][1] * b[1][j] + a[i][2] * b[2][j];
}

TI_FN void matvec3(const float a[3][3], const float x[3], float y[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) y[i] = a[i][0] * x[0] + a[i][1] * x[1] + a[i][2] * x[2];
}

// `reductions.solve_se3`: JtJ xi = -Jtr by the 3x3 block Schur complement
TI_FN void solve_se3(const float H[6][6], const float g[6], float damping, float xi[6]) {
  float P[3][3], Q[3][3], QT[3][3], S[3][3], b1[3], b2[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      P[i][j] = H[i][j] + (i == j ? damping : 0.0f);
      Q[i][j] = H[i][j + 3];
      QT[j][i] = H[i][j + 3];
      S[i][j] = H[i + 3][j + 3] + (i == j ? damping : 0.0f);
    }
    b1[i] = -g[i];
    b2[i] = -g[i + 3];
  }
  float Pinv[3][3], T[3][3], QtT[3][3], Ss[3][3], Ssinv[3][3];
  inv3(P, Pinv);
  matmul3(Pinv, Q, T);
  matmul3(QT, T, QtT);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) Ss[i][j] = S[i][j] - QtT[i][j];
  float y1p[3], qy[3], rhs[3], x2[3], tx2[3];
  matvec3(Pinv, b1, y1p);
  matvec3(QT, y1p, qy);
#pragma unroll
  for (int i = 0; i < 3; ++i) rhs[i] = b2[i] - qy[i];
  inv3(Ss, Ssinv);
  matvec3(Ssinv, rhs, x2);
  matvec3(T, x2, tx2);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    xi[i] = y1p[i] - tx2[i];
    xi[i + 3] = x2[i];
  }
}

// `se3._exp_coeffs`: (small, sin(t)/t, (1-cos t)/t^2, safe t^2)
TI_FN void exp_coeffs(float theta2, bool& small, float& a, float& b, float& t2s) {
  small = theta2 < 1e-8f;
  t2s = small ? 1.0f : theta2;
  const float theta = sqrtf(t2s);
  a = small ? 1.0f - theta2 / 6.0f : sinf(theta) / theta;
  b = small ? 0.5f - theta2 / 24.0f : (1.0f - cosf(theta)) / t2s;
}

TI_FN void hat(const float w[3], float W[3][3]) {
  W[0][0] = 0.0f;  W[0][1] = -w[2]; W[0][2] = w[1];
  W[1][0] = w[2];  W[1][1] = 0.0f;  W[1][2] = -w[0];
  W[2][0] = -w[1]; W[2][1] = w[0];  W[2][2] = 0.0f;
}

// `se3.so3_exp`
TI_FN void so3_exp(const float w[3], float R[3][3]) {
  bool small;
  float a, b, t2s;
  exp_coeffs(w[0] * w[0] + w[1] * w[1] + w[2] * w[2], small, a, b, t2s);
  float W[3][3], W2[3][3];
  hat(w, W);
  matmul3(W, W, W2);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) R[i][j] = (i == j ? 1.0f : 0.0f) + a * W[i][j] + b * W2[i][j];
}

// `se3.se3_exp` (rows 0-2 of the 4x4; the last row is 0 0 0 1)
TI_FN void se3_exp(const float xi[6], float T[3][4]) {
  const float w[3] = {xi[0], xi[1], xi[2]};
  const float theta2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  bool small;
  float a, b, t2s;
  exp_coeffs(theta2, small, a, b, t2s);
  const float c = small ? 1.0f / 6.0f - theta2 / 120.0f : (1.0f - a) / t2s;
  float W[3][3], W2[3][3], V[3][3];
  hat(w, W);
  matmul3(W, W, W2);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float e = i == j ? 1.0f : 0.0f;
      T[i][j] = e + a * W[i][j] + b * W2[i][j];
      V[i][j] = e + b * W[i][j] + c * W2[i][j];
    }
#pragma unroll
  for (int i = 0; i < 3; ++i) T[i][3] = V[i][0] * xi[3] + V[i][1] * xi[4] + V[i][2] * xi[5];
}

template <int N>
TI_FN bool all_finite(const float* x) {
  bool f = true;
#pragma unroll
  for (int i = 0; i < N; ++i) f = f & (isfinite(x[i]) != 0);
  return f;
}

template <int N>
TI_FN float sumsq(const float* x) {
  float s = x[0] * x[0];
#pragma unroll
  for (int i = 1; i < N; ++i) s = s + x[i] * x[i];
  return s;
}

// The GN update from the reduced sums: `_solve_iter` then `_advance`.
TI_FN void gn_update(const Params& p, const float* sums) {
  const float* si = sums;
  const float* sr = sums + GN_BLOCK;
  float cin[57];
  if (p.fresh) {
#pragma unroll
    for (int k = 0; k < 16; ++k) cin[k] = p.carry_in[k];
    const float inf = INFINITY;
    cin[C_ICP_ERR] = inf; cin[C_ICP_INL] = 0.0f; cin[C_RGB_ERR] = inf; cin[C_RGB_INL] = 0.0f;
#pragma unroll
    for (int k = 0; k < 36; ++k) cin[C_JTJ + k] = (k % 7 == 0) ? 1.0f : 0.0f;
    cin[C_DONE] = 0.0f;
  } else {
#pragma unroll
    for (int k = 0; k < 57; ++k) cin[k] = p.carry_in[k];
  }
  // `combined_system`: JtJ = rgb_scale * G_rgb.JtJ + w2 * G_icp.JtJ
  float H[6][6], g[6];
  int k = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = i; j < 6; ++j, ++k) H[i][j] = H[j][i] = p.rgb_scale * sr[k] + p.w2 * si[k];
#pragma unroll
  for (int i = 0; i < 6; ++i) g[i] = p.rgb_scale * sr[k + i] + p.w2 * si[k + i];
  const float icp_res = si[27], icp_inl = si[28], rgb_res = sr[27], rgb_inl = sr[28];
  float xi[6];
  solve_se3(H, g, p.damping, xi);
  const bool ok = all_finite<6>(xi) & ((icp_inl > p.min_inliers) | (rgb_inl > p.min_inliers));
  const bool done = cin[C_DONE] != 0.0f;
  const bool step_done = !ok | (sumsq<6>(xi) < p.step_tol);
  float out[57];
#pragma unroll
  for (int q = 0; q < 57; ++q) out[q] = cin[q];
  if (!done) {
    if (ok) {
      float T[3][4];
      se3_exp(xi, T);
      // exp(xi) @ A, rows 0-2 (row 3 of exp(xi) is 0 0 0 1)
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          out[4 * i + j] = T[i][0] * cin[j] + T[i][1] * cin[4 + j] + T[i][2] * cin[8 + j] +
                           T[i][3] * cin[12 + j];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        out[12 + j] = 0.0f * cin[j] + 0.0f * cin[4 + j] + 0.0f * cin[8 + j] + 1.0f * cin[12 + j];
    }
    out[C_ICP_ERR] = icp_res / fmaxf(icp_inl, 1.0f);
    out[C_ICP_INL] = icp_inl;
    out[C_RGB_ERR] = rgb_res / fmaxf(rgb_inl, 1.0f);
    out[C_RGB_INL] = rgb_inl;
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int j = 0; j < 6; ++j) out[C_JTJ + 6 * i + j] = H[i][j];
  }
  out[C_DONE] = (done | step_done) ? 1.0f : 0.0f;
  if (p.pre_out)
#pragma unroll
    for (int q = 0; q < 57; ++q) p.pre_out[q] = cin[q];
  if (p.starved_out) *p.starved_out = (!done & !ok) ? 1 : 0;
#pragma unroll
  for (int q = 0; q < 57; ++q) p.carry_out[q] = out[q];
}

// The SO3 pre-align's update from the reduced sums, with its rollback.
TI_FN void so3_update(const Params& p, const float* sums) {
  float cin[27];
#pragma unroll
  for (int k = 0; k < 16; ++k) cin[k] = p.carry_in[k];
  if (p.fresh) {
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) cin[S_RBEST + 3 * i + j] = cin[4 * i + j];
    cin[S_ERRBEST] = INFINITY;
    cin[S_DONE] = 0.0f;
  } else {
#pragma unroll
    for (int k = 16; k < 27; ++k) cin[k] = p.carry_in[k];
  }
  const float count = sums[10];
  const float err = sums[9] / fmaxf(count, 1.0f);
  float Areg[3][3], inv[3][3];
  const int up[3][3] = {{0, 1, 2}, {1, 3, 4}, {2, 4, 5}};
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) Areg[i][j] = sums[up[i][j]] + (i == j ? p.damping : 0.0f);
  inv3(Areg, inv);
  const float b[3] = {-sums[6], -sums[7], -sums[8]};
  float dw[3];
  matvec3(inv, b, dw);
  const bool ok = (count > p.min_inliers) & all_finite<3>(dw);
  float R[3][3], Rb[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      R[i][j] = cin[4 * i + j];
      Rb[i][j] = cin[S_RBEST + 3 * i + j];
    }
  float R_new[3][3];
  if (ok) {
    float E[3][3];
    so3_exp(dw, E);
    matmul3(E, R, R_new);
  } else {
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) R_new[i][j] = R[i][j];
  }
  const float err_best = cin[S_ERRBEST];
  const bool improved = err < err_best;
  // torch.minimum: NaN if either is NaN
  const float err_best_new = (isnan(err) | isnan(err_best)) ? NAN : fminf(err, err_best);
  const bool done = cin[S_DONE] != 0.0f;
  const bool step_done = !ok | (sumsq<3>(dw) < p.step_tol);
  float out[27];
#pragma unroll
  for (int q = 0; q < 27; ++q) out[q] = cin[q];
  if (!done) {
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float best_new = improved ? R[i][j] : Rb[i][j];
        out[S_RBEST + 3 * i + j] = best_new;
        out[4 * i + j] = improved ? R_new[i][j] : best_new;  // diverged: roll back
      }
    out[S_ERRBEST] = err_best_new;
  }
  out[S_DONE] = (done | step_done) ? 1.0f : 0.0f;
#pragma unroll
  for (int q = 0; q < 27; ++q) p.carry_out[q] = out[q];
}

#ifdef __CUDACC__

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <bool SO3, bool FROZEN, bool BILINEAR>
__global__ void __launch_bounds__(THREADS, 2) track_iter_gram_kernel(const Params p) {
  constexpr int NS = SO3 ? SO3_SUMS : GN_SUMS;
  constexpr int SPLIT = THREADS / NS;  // 4 (GN), 23 (SO3)
  constexpr int PER_SPLIT = (MAX_BLOCKS + SPLIT - 1) / SPLIT;
  __shared__ float red[WARPS][NS];
  __shared__ float split[SPLIT * NS];
  __shared__ float total[NS];
  __shared__ bool s_last;

  const int t = threadIdx.x;
  float A[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) A[i] = p.carry_in[i];
  float acc[NS];
#pragma unroll
  for (int e = 0; e < NS; ++e) acc[e] = 0.0f;

  const long long P = static_cast<long long>(p.h) * p.w;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  for (long long r = static_cast<long long>(blockIdx.x) * THREADS + t; r < P; r += stride) {
    const int y = static_cast<int>(r / p.w), x = static_cast<int>(r - static_cast<long long>(y) * p.w);
    if (SO3) {
      so3_row<FROZEN>(p, A, r, y, x, acc);
    } else {
      gn_row<FROZEN, BILINEAR>(p, A, r, y, x, acc);
    }
  }

  const int lane = t & 31, warp = t >> 5;
#pragma unroll
  for (int e = 0; e < NS; ++e) {
    const float s = warp_sum(acc[e]);
    if (lane == 0) red[warp][e] = s;
  }
  __syncthreads();
  if (t < NS) {
    float s = red[0][t];
#pragma unroll
    for (int q = 1; q < WARPS; ++q) s += red[q][t];
    p.partials[static_cast<long long>(blockIdx.x) * NS + t] = s;
  }
  // as in K1: the barrier orders the partial writes before thread 0's
  // release; the last block's acquire (then the barrier) orders its reads
  __syncthreads();
  if (t == 0) {
    unsigned drawn;
    asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], 1;"
                 : "=r"(drawn) : "l"(p.ticket) : "memory");
    s_last = drawn == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;

  if (t < SPLIT * NS) {
    const int e = t % NS, first = t / NS;
    const int last = static_cast<int>(gridDim.x) - 1;
    float v[PER_SPLIT];
#pragma unroll
    for (int k = 0; k < PER_SPLIT; ++k) {
      const int b = first + k * SPLIT;
      v[k] = __ldcg(p.partials + (b < last ? b : last) * NS + e);
    }
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < PER_SPLIT; ++k)
      if (first + k * SPLIT <= last) s += v[k];
    split[t] = s;
  }
  __syncthreads();
  if (t < NS) {
    float s = split[t];
#pragma unroll
    for (int q = 1; q < SPLIT; ++q) s += split[q * NS + t];
    total[t] = s;
    p.sums_out[t] = s;
  }
  __syncthreads();
  if (t == 0) {
    if (SO3) {
      so3_update(p, total);
    } else {
      gn_update(p, total);
    }
    *p.ticket = 0;
  }
}

template <bool SO3, bool FROZEN, bool BILINEAR>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const long long P = static_cast<long long>(p.h) * p.w;
  const long long want = (P + THREADS - 1) / THREADS;
  const int grid = want < 1 ? 1 : (want > MAX_BLOCKS ? MAX_BLOCKS : static_cast<int>(want));
  track_iter_gram_kernel<SO3, FROZEN, BILINEAR><<<grid, THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

#endif  // __CUDACC__

}  // namespace track_iter

#ifdef __CUDACC__

extern "C" {

// Floats of scratch one stream needs: every block's GN partials.
int track_iter_scratch_floats() { return track_iter::MAX_BLOCKS * track_iter::GN_SUMS; }

// Bytes of `Params`, for the binding to check its mirror of the struct.
int track_iter_params_bytes() { return static_cast<int>(sizeof(track_iter::Params)); }

// One iteration (so3: SO3 rows, else joint ICP + RGB rows; frozen: read
// the sample; bilinear: the GN model sample's interpolation) on `stream`
// of CUDA device `device`, without synchronising; returns its cudaError_t
// (0 = launched).
int track_iter_f32(const track_iter::Params* params, int so3, int frozen, int bilinear,
                   int device, void* stream) {
  using namespace track_iter;
  if (params == nullptr || params->h < 0 || params->w < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess) return static_cast<int>(err);
  const Params& p = *params;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (so3) {
    err = frozen ? launch<true, true, true>(p, s) : launch<true, false, true>(p, s);
  } else if (frozen) {
    err = launch<false, true, true>(p, s);  // a frozen row reads its sample, not the model
  } else {
    err = bilinear ? launch<false, false, true>(p, s) : launch<false, false, false>(p, s);
  }
  if (current != device) cudaSetDevice(current);
  return static_cast<int>(err);
}

}  // extern "C"

#endif  // __CUDACC__
