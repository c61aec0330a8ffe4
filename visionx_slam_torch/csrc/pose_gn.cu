// Pose-only Gauss-Newton on weighted reprojection (K2), for Hopper (sm_90a):
// every step of one models/estimation.py::_pose_gn_refine call in one launch.
//
// It replaces no TPU kernel: the JAX package leaves these steps to XLA, which
// fuses a step into a few programs. The port ran them as an eager chain of
// ~310 small launches a step (the unrolled 6x6 Cholesky alone ~164), and
// those launches paced the offline stages on the host while the card idled.
// K2 computes the same function as the plain version (_pose_gn_refine_plain)
// in float32, with the same formulas, clamps and branches:
//
//   per step, for every problem b (a pose) over its N points:
//     pc = R(q) X + t (quat_rotate's cross-product form); z = max(pc.z, 1e-6)
//     residuals (u, v) = px - (f * pc.xy / z + c); weight w, zero where
//     pc.z <= 1e-6; robust: times the Huber IRLS weight at huber_delta and
//     zero beyond gate_px, from this step's residual norm
//     G = [J | r] rows (u and v), M = G^T W G: the 21 entries of the 6x6
//     normal matrix's upper triangle and its 6 right-hand sides
//     dx = solve(M6 + 1e-6 I, M[:6, 6]) by the unrolled Cholesky of
//     ops/linalg.py::_chol_solve (diagonal clamped at 1e-12); dx = 0 where
//     any entry is not finite
//     pose = normalize(exp(dx) * pose): se3_exp's small-angle branches,
//     quat_normalize's clamp and sign
//
// Poses are wxyz quaternions plus translations (ops/se3.py). NaN propagates
// as in torch: clamps are written x < lo ? lo : x (fmaxf would drop a NaN),
// and every product of the normal matrix is formed, zero entries of J
// included, so a NaN or inf in one point poisons the step as it does there.
//
// Design. One block per problem. A thread holds its share of the points
// (X, px, w: 6 floats each, kPpt per thread) in registers, loaded once and
// reused by every step; above 8 a thread (N > 2048) it reads them from
// device memory each step instead. A step accumulates the 27 sums per
// thread, reduces them by a fixed-order warp shuffle tree and then across
// warps in shared memory in warp order: no atomics, so a call repeats bit
// for bit on the card. Thread 0 solves the 6x6 system, updates the pose and
// publishes it through shared memory for the next step. Batch dimensions of
// any rank reach the kernel flattened to at most 4 (the wrapper merges what
// it can); each input is read through its own strides, over them and within
// a problem, so inputs that broadcast over hypotheses ([P,1,N,3] against
// [P,H] poses) are never expanded in memory and the re-track's points,
// stored coordinate-major, are read in place (each coordinate's loads
// coalesce across the warp).
//
// Bound. Bytes: each input read once and the poses written, 24 B a point for
// an unshared problem plus 56 B of poses; the arithmetic, ~183 operations a
// point a step (193 robust) and ~400 a step for the solve, is the larger
// bound at the main path's shapes (utils/flops.py: k2_bytes, k2_ops). What
// the kernel actually waits on is the serial tail of each step (reduction,
// one thread's solve and update) and the launch itself: at the offline
// stages' shapes a call is microseconds of device time. Times: PERF.md.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxDims = 4;     // batch dims after merging
constexpr int kSums = 27;       // 21 of the 6x6 upper triangle + 6 rhs
constexpr int kThreads = 256;   // threads of a block when N > 256
constexpr int kMaxWarps = kThreads / 32;

struct Args {
  const float* q;   // [..., 4] wxyz
  const float* t;   // [..., 3]
  const float* X;   // [..., N, 3]
  const float* px;  // [..., N, 2]
  const float* w;   // [..., N]
  float* q_out;     // [B, 4]
  float* t_out;     // [B, 3]
  int n, iters, robust, ndim;
  long long size[kMaxDims];
  // element strides of each input over the merged batch dims
  long long sq[kMaxDims], st[kMaxDims], sX[kMaxDims], spx[kMaxDims],
      sw[kMaxDims];
  // and within a problem: over the quaternion's and translation's entries,
  // over the points (n) and their coordinates (c)
  long long sq_c, st_c, sX_n, sX_c, spx_n, spx_c, sw_n;
  float fx, fy, cx, cy, huber, gate;
};

// torch.clamp(x, min=lo): a NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

__device__ __forceinline__ void cross(const float a[3], const float b[3],
                                      float o[3]) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

// ops/se3.py::quat_rotate: v + 2 (w (u x v) + u x (u x v)), u = q.xyz
__device__ __forceinline__ void quat_rotate(const float q[4], const float v[3],
                                            float o[3]) {
  const float u[3] = {q[1], q[2], q[3]};
  float uv[3], uuv[3];
  cross(u, v, uv);
  cross(u, uv, uuv);
#pragma unroll
  for (int i = 0; i < 3; ++i) o[i] = v[i] + 2.0f * (q[0] * uv[i] + uuv[i]);
}

// One point's rows of G = [J | r], weighted, added to the 27 sums.
__device__ __forceinline__ void accumulate(const Args& a, const float q[4],
                                           const float t[3], const float X[3],
                                           float pu, float pv, float w,
                                           float acc[kSums]) {
  float p[3];
  quat_rotate(q, X, p);
  const float x = p[0] + t[0], y = p[1] + t[1], zr = p[2] + t[2];
  const float z = clamp_min(zr, 1e-6f);
  const float iz = 1.0f / z;
  const float xiz = x * iz, yiz = y * iz;
  const float ue = pu - (a.fx * xiz + a.cx);
  const float ve = pv - (a.fy * yiz + a.cy);
  float ww = w * (zr > 1e-6f ? 1.0f : 0.0f);
  if (a.robust) {
    const float en = sqrtf(ue * ue + ve * ve);
    ww = ww * (en <= a.huber ? 1.0f : a.huber / clamp_min(en, 1e-9f));
    ww = ww * (en <= a.gate ? 1.0f : 0.0f);
  }
  const float xyiz2 = xiz * yiz;
  const float gu[7] = {a.fx * iz, 0.0f, -a.fx * xiz * iz, -a.fx * xyiz2,
                       a.fx * (1.0f + xiz * xiz), -a.fx * yiz, ue};
  const float gv[7] = {0.0f, a.fy * iz, -a.fy * yiz * iz,
                       -a.fy * (1.0f + yiz * yiz), a.fy * xyiz2, a.fy * xiz,
                       ve};
  int k = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const float wu = gu[i] * ww, wv = gv[i] * ww;
#pragma unroll
    for (int j = i; j < 7; ++j) acc[k++] += wu * gu[j] + wv * gv[j];
  }
}

// dx from the 27 sums, then pose <- normalize(exp(dx) * pose), in place.
__device__ void solve_and_update(const float s[kSums], float pose[7]) {
  float A[6][6], b[6];
  int k = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = i; j < 7; ++j) {
      if (j < 6) A[j][i] = s[k] + (i == j ? 1e-6f : 0.0f);
      else b[i] = s[k];
      ++k;
    }
  }
  // ops/linalg.py::_chol_solve, eps 1e-12 (lower triangle of A)
  float L[6][6], y[6], dx[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float acc = A[i][j];
#pragma unroll
      for (int m = 0; m < j; ++m) acc = acc - L[i][m] * L[j][m];
      L[i][j] = i == j ? sqrtf(clamp_min(acc, 1e-12f)) : acc / L[j][j];
    }
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float acc = b[i];
#pragma unroll
    for (int m = 0; m < i; ++m) acc = acc - L[i][m] * y[m];
    y[i] = acc / L[i][i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float acc = y[i];
#pragma unroll
    for (int m = i + 1; m < 6; ++m) acc = acc - L[m][i] * dx[m];
    dx[i] = acc / L[i][i];
  }
  bool finite = true;
#pragma unroll
  for (int i = 0; i < 6; ++i) finite = finite && isfinite(dx[i]);
  if (!finite) {
#pragma unroll
    for (int i = 0; i < 6; ++i) dx[i] = 0.0f;
  }

  // se3_exp(dx): V (the left Jacobian) and so3_exp, with their branches
  const float up[3] = {dx[0], dx[1], dx[2]};
  const float o[3] = {dx[3], dx[4], dx[5]};
  const float th2 = o[0] * o[0] + o[1] * o[1] + o[2] * o[2];
  const float th = sqrtf(clamp_min(th2, 0.0f));
  const bool small = th2 < 1e-10f;
  const float ca = small ? 0.5f - th2 / 24.0f
                         : (1.0f - cosf(th)) / clamp_min(th2, 1e-8f);
  const float cb = small ? (float)(1.0 / 6.0) - th2 / 120.0f
                         : (th - sinf(th)) / clamp_min(th2 * th, 1e-8f);
  const float O[3][3] = {{0.0f, -o[2], o[1]},
                         {o[2], 0.0f, -o[0]},
                         {-o[1], o[0], 0.0f}};
  float te[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float OO = O[i][0] * O[0][j] + O[i][1] * O[1][j] + O[i][2] * O[2][j];
      const float V = (i == j ? 1.0f : 0.0f) + ca * O[i][j] + cb * OO;
      acc = acc + V * up[j];
    }
    te[i] = acc;
  }
  const float kq = small ? 0.5f - th2 / 48.0f
                         : sinf(0.5f * th) / clamp_min(th, 1e-8f);
  const float qe[4] = {small ? 1.0f - th2 / 8.0f : cosf(0.5f * th),
                       kq * o[0], kq * o[1], kq * o[2]};

  // se3_compose(exp(dx), pose): quat_mul, quat_normalize; rotate t and add
  const float* q = pose;
  float qm[4] = {qe[0] * q[0] - qe[1] * q[1] - qe[2] * q[2] - qe[3] * q[3],
                 qe[0] * q[1] + qe[1] * q[0] + qe[2] * q[3] - qe[3] * q[2],
                 qe[0] * q[2] - qe[1] * q[3] + qe[2] * q[0] + qe[3] * q[1],
                 qe[0] * q[3] + qe[1] * q[2] - qe[2] * q[1] + qe[3] * q[0]};
  const float nq = sqrtf(qm[0] * qm[0] + qm[1] * qm[1] + qm[2] * qm[2] +
                         qm[3] * qm[3]);
  const float dq = clamp_min(nq, 1e-8f);
#pragma unroll
  for (int i = 0; i < 4; ++i) qm[i] = qm[i] / dq;
  const float sign = qm[0] < 0.0f ? -1.0f : 1.0f;
  float tr[3];
  quat_rotate(qe, pose + 4, tr);
#pragma unroll
  for (int i = 0; i < 4; ++i) pose[i] = qm[i] * sign;
#pragma unroll
  for (int i = 0; i < 3; ++i) pose[4 + i] = tr[i] + te[i];
}

// kPpt > 0: points in registers, kPpt a thread; kPpt == 0: read each step.
template <int kPpt>
__global__ void __launch_bounds__(kThreads) pose_gn_kernel(const Args a) {
  __shared__ float s_pose[7];
  __shared__ float s_part[kMaxWarps][kSums];
  __shared__ float s_sum[kSums];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;

  long long r = blockIdx.x, oq = 0, ot = 0, oX = 0, opx = 0, ow = 0;
  for (int d = a.ndim - 1; d >= 0; --d) {
    const long long i = r % a.size[d];
    r /= a.size[d];
    oq += i * a.sq[d];
    ot += i * a.st[d];
    oX += i * a.sX[d];
    opx += i * a.spx[d];
    ow += i * a.sw[d];
  }
  const float* X = a.X + oX;
  const float* px = a.px + opx;
  const float* w = a.w + ow;
  if (tid < 4) s_pose[tid] = a.q[oq + tid * a.sq_c];
  else if (tid < 7) s_pose[tid] = a.t[ot + (tid - 4) * a.st_c];

  float rX[kPpt > 0 ? kPpt : 1][3], rp[kPpt > 0 ? kPpt : 1][2],
      rw[kPpt > 0 ? kPpt : 1];
  if constexpr (kPpt > 0) {
#pragma unroll
    for (int k = 0; k < kPpt; ++k) {
      const long long n = tid + k * nthreads;
      if (n < a.n) {
#pragma unroll
        for (int c = 0; c < 3; ++c) rX[k][c] = X[n * a.sX_n + c * a.sX_c];
        rp[k][0] = px[n * a.spx_n];
        rp[k][1] = px[n * a.spx_n + a.spx_c];
        rw[k] = w[n * a.sw_n];
      }
    }
  }

  for (int it = 0; it < a.iters; ++it) {
    __syncthreads();  // this step's pose is in s_pose
    const float q[4] = {s_pose[0], s_pose[1], s_pose[2], s_pose[3]};
    const float t[3] = {s_pose[4], s_pose[5], s_pose[6]};
    float acc[kSums];
#pragma unroll
    for (int i = 0; i < kSums; ++i) acc[i] = 0.0f;
    if constexpr (kPpt > 0) {
#pragma unroll
      for (int k = 0; k < kPpt; ++k)
        if (tid + k * nthreads < a.n)
          accumulate(a, q, t, rX[k], rp[k][0], rp[k][1], rw[k], acc);
    } else {
      for (long long n = tid; n < a.n; n += nthreads) {
        const float* Xp = X + n * a.sX_n;
        const float Xn[3] = {Xp[0], Xp[a.sX_c], Xp[2 * a.sX_c]};
        accumulate(a, q, t, Xn, px[n * a.spx_n], px[n * a.spx_n + a.spx_c],
                   w[n * a.sw_n], acc);
      }
    }
#pragma unroll
    for (int i = 0; i < kSums; ++i) {
      float v = acc[i];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) s_part[warp][i] = v;
    }
    __syncthreads();
    if (tid < kSums) {
      float v = s_part[0][tid];
      for (int k = 1; k < nwarps; ++k) v += s_part[k][tid];
      s_sum[tid] = v;
    }
    __syncthreads();
    if (tid == 0) solve_and_update(s_sum, s_pose);
  }
  __syncthreads();
  const long long b = blockIdx.x;
  if (tid < 4) a.q_out[4 * b + tid] = s_pose[tid];
  else if (tid < 7) a.t_out[3 * b + tid - 4] = s_pose[tid];
}

}  // namespace

// Plain C entry point (bound with ctypes); returns the cudaError_t of the
// launch on `stream` (a cudaStream_t).
//
// layout (int64): [B, N, iters, robust, ndim, size[4], the strides over the
// batch dims of q, t, X, px, w (4 each), then the strides within a problem:
// q's and t's entries, X's points and coordinates, px's points and
// coordinates, w's points]; params (f32): [fx, fy, cx, cy, huber_delta,
// gate_px]. Every input is read through its strides; the outputs are
// contiguous [B,4] and [B,3].
extern "C" int vxs_pose_gn(const void* q, const void* t, const void* X,
                           const void* px, const void* w, void* q_out,
                           void* t_out, const long long* layout,
                           const float* params, void* stream) {
  Args a;
  a.q = (const float*)q;
  a.t = (const float*)t;
  a.X = (const float*)X;
  a.px = (const float*)px;
  a.w = (const float*)w;
  a.q_out = (float*)q_out;
  a.t_out = (float*)t_out;
  const long long nb = layout[0];
  a.n = (int)layout[1];
  a.iters = (int)layout[2];
  a.robust = (int)layout[3];
  a.ndim = (int)layout[4];
  if (nb <= 0 || nb > 0x7fffffffLL || a.ndim < 0 || a.ndim > kMaxDims)
    return (int)cudaErrorInvalidValue;
  for (int d = 0; d < kMaxDims; ++d) {
    a.size[d] = layout[5 + d];
    a.sq[d] = layout[9 + d];
    a.st[d] = layout[13 + d];
    a.sX[d] = layout[17 + d];
    a.spx[d] = layout[21 + d];
    a.sw[d] = layout[25 + d];
  }
  a.sq_c = layout[29];
  a.st_c = layout[30];
  a.sX_n = layout[31];
  a.sX_c = layout[32];
  a.spx_n = layout[33];
  a.spx_c = layout[34];
  a.sw_n = layout[35];
  a.fx = params[0];
  a.fy = params[1];
  a.cx = params[2];
  a.cy = params[3];
  a.huber = params[4];
  a.gate = params[5];

  // threads and points a thread from N
  int threads = kThreads, ppt;
  if (a.n <= kThreads) {
    ppt = 1;
    threads = a.n <= 32 ? 32 : (a.n + 31) / 32 * 32;
  } else if (a.n <= 2 * kThreads) {
    ppt = 2;
  } else if (a.n <= 4 * kThreads) {
    ppt = 4;
  } else if (a.n <= 8 * kThreads) {
    ppt = 8;
  } else {
    ppt = 0;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((unsigned)nb);
  switch (ppt) {
    case 1: pose_gn_kernel<1><<<grid, threads, 0, s>>>(a); break;
    case 2: pose_gn_kernel<2><<<grid, threads, 0, s>>>(a); break;
    case 4: pose_gn_kernel<4><<<grid, threads, 0, s>>>(a); break;
    case 8: pose_gn_kernel<8><<<grid, threads, 0, s>>>(a); break;
    default: pose_gn_kernel<0><<<grid, threads, 0, s>>>(a); break;
  }
  return (int)cudaGetLastError();
}
