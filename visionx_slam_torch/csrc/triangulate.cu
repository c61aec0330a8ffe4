// Two-view landmark creation (K4), for Hopper (sm_90a): one whole
// tracking/stages.py::triangulate_pair call in one launch, the landmark
// allocation and both keyframes' links included, so the host reads nothing.
//
// It replaces no TPU kernel: the JAX package leaves this stage to XLA. The
// port ran it as an eager chain of ~485 small launches a keyframe event (the
// DLT's row normalisation, 3x3 and two unrolled 4x4 solves, the gates, the
// two scatter-min passes of the dedupe and the allocator), which paced the
// scan's keyframe event on the host. K4 computes the same function as the
// plain version (_triangulate_pair_plain) in float32, with the same formulas,
// clamps and gates:
//
//   for each query feature n of keyframe a, matched (knn2 ratio test) to
//   feature m = idx[n] of keyframe b, both without a landmark:
//     angle gate: the world-frame angle between the two unit viewing rays
//       >= min_angle_deg
//     DLT: rows u P[2] - P[0], v P[2] - P[1] of both views (P = K [R|t]),
//       each normalised (norm clamped at 1e-12), M = A^T A; the smallest
//       eigenvector by the inhomogeneous 3x3 start (non-finite entries 0,
//       normalised with [X0, 1]) and two shifted inverse-iteration steps
//       (shift 1e-7 trace, unrolled 4x4 Cholesky, diagonal clamped at
//       1e-30); the point X / w (|w| clamped at 1e-12)
//     finite, in front of both cameras (z > 1e-6), both reprojection errors
//       <= max_reproj
//   dedupe: per train feature the lowest distance (clamped at 511), then the
//     lowest query row, wins
//   allocation: the winners take landmark rows from the cursor next_lm in
//   query order while rows are left below the capacity L (position, alive,
//   observed twice), the cursor moves by the winners (clamped at L) and the
//   rest count as dropped; both keyframes' features link to the new rows
//
// NaN propagates as in torch: clamps are written x < lo ? lo : x, and a
// non-finite point fails its gates as it does there.
//
// Design. One block of 1024 threads, a thread a query feature (a strided
// loop above 1024). Six words a feature (the minima, the flags, the points)
// live in shared memory up to 8,192 features, above that in the caller's
// workspace in global memory, in the same kernel (an instantiation of it),
// so any feature count the plain version takes runs, up to 2**28. The
// dedupe's two minima are integer atomicMin on those words (a distance is
// non-negative, so its float bits order as integers):
// the minimum does not depend on the order the threads arrive in. The
// allocation's ranks are a block-wide prefix count in query order. So a
// call repeats bit for bit on the card. The work is ~1,000 independent
// small solves and three barriers; the launch is what it costs.
//
// Bound. Bytes: both keyframes' pixels and links, the match, the poses, and
// for each created landmark its row written (utils/flops.py: k4_bytes);
// arithmetic ~600 operations a query (k4_ops). Times: PERF.md.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kSharedFeatures = 8192;   // six words each in shared memory

struct Args {
  const float* kf_q;           // [K,4]
  const float* kf_t;           // [K,3]
  const float* kf_px;          // [K,2,N]
  int* kf_feat_lm;             // [K,N], updated in place
  float* lm_pos;               // [3,Lp], updated in place
  unsigned char* lm_alive;     // [Lp] bool, updated in place
  int* lm_obs;                 // [Lp], updated in place
  int* next_lm;                // [] updated in place
  int* lm_dropped;             // [] updated in place
  const long long* idx;        // [N] train feature of each query
  const float* dist;           // [N]
  const unsigned char* valid;  // [N] bool
  int* work;                   // [6 N] the words of each feature where
                               // shared memory has no room for them
  int N, Lp, L, a, b;
  float fx, fy, cx, cy, min_angle, max_reproj;
};

__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

// ops/se3.py::quat_rotate
__device__ __forceinline__ void quat_rotate(const float q[4], const float v[3],
                                            float o[3]) {
  const float u[3] = {q[1], q[2], q[3]};
  const float uv[3] = {u[1] * v[2] - u[2] * v[1], u[2] * v[0] - u[0] * v[2],
                       u[0] * v[1] - u[1] * v[0]};
  const float uuv[3] = {u[1] * uv[2] - u[2] * uv[1],
                        u[2] * uv[0] - u[0] * uv[2],
                        u[0] * uv[1] - u[1] * uv[0]};
#pragma unroll
  for (int i = 0; i < 3; ++i) o[i] = v[i] + 2.0f * (q[0] * uv[i] + uuv[i]);
}

// ops/se3.py::quat_to_matrix, row-major
__device__ __forceinline__ void quat_to_matrix(const float q[4], float R[9]) {
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, xz = x * z, yz = y * z;
  const float wx = w * x, wy = w * y, wz = w * z;
  R[0] = 1.0f - 2.0f * (yy + zz);
  R[1] = 2.0f * (xy - wz);
  R[2] = 2.0f * (xz + wy);
  R[3] = 2.0f * (xy + wz);
  R[4] = 1.0f - 2.0f * (xx + zz);
  R[5] = 2.0f * (yz - wx);
  R[6] = 2.0f * (xz - wy);
  R[7] = 2.0f * (yz + wx);
  R[8] = 1.0f - 2.0f * (xx + yy);
}

// the unit viewing ray of a pixel, in the world frame (_ray_angle_ok)
__device__ void world_ray(const Args& a, float u, float v, const float q[4],
                          float o[3]) {
  const float f[3] = {(u - a.cx) / a.fx * 1.0f, (v - a.cy) / a.fy * 1.0f, 1.0f};
  const float n = clamp_min(sqrtf(f[0] * f[0] + f[1] * f[1] + f[2] * f[2]), 1e-12f);
  const float fu[3] = {f[0] / n, f[1] / n, f[2] / n};
  const float qi[4] = {q[0], -q[1], -q[2], -q[3]};
  quat_rotate(qi, fu, o);
}

// estimation.py::projection_matrix, rows of K [R|t]
__device__ void projection(const Args& a, const float q[4], const float t[3],
                           float P[12]) {
  float R[9];
  quat_to_matrix(q, R);
  const float Rt[12] = {R[0], R[1], R[2], t[0], R[3], R[4], R[5], t[1],
                        R[6], R[7], R[8], t[2]};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    P[j] = a.fx * Rt[j] + a.cx * Rt[8 + j];
    P[4 + j] = a.fy * Rt[4 + j] + a.cy * Rt[8 + j];
    P[8 + j] = Rt[8 + j];
  }
}

// ops/linalg.py::solve3x3 (adjugate, |det| clamped at 1e-20 with its sign)
__device__ void solve3(const float A[9], const float b[3], float x[3]) {
  const float a = A[0], bb = A[1], c = A[2], d = A[3], e = A[4], f = A[5],
              g = A[6], h = A[7], i = A[8];
  const float adj[9] = {e * i - f * h, c * h - bb * i, bb * f - c * e,
                        f * g - d * i, a * i - c * g, c * d - a * f,
                        d * h - e * g, bb * g - a * h, a * e - bb * d};
  const float det = a * adj[0] + bb * adj[3] + c * adj[6];
  const float eps = 1e-20f;
  const float det_safe = fabsf(det) < eps ? (det < 0.0f ? -eps : eps) : det;
  const float inv_det = 1.0f / det_safe;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float m0 = adj[3 * r] * inv_det, m1 = adj[3 * r + 1] * inv_det,
                m2 = adj[3 * r + 2] * inv_det;
    x[r] = m0 * b[0] + m1 * b[1] + m2 * b[2];
  }
}

// ops/linalg.py::chol_solve4x4 (eps 1e-30), lower triangle of A
__device__ void chol_solve4(const float A[16], const float b[4], float x[4]) {
  float L[4][4], y[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s = A[4 * i + j];
#pragma unroll
      for (int k = 0; k < j; ++k) s = s - L[i][k] * L[j][k];
      L[i][j] = i == j ? sqrtf(clamp_min(s, 1e-30f)) : s / L[j][j];
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float s = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
#pragma unroll
  for (int i = 3; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < 4; ++k) s = s - L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
}

// estimation.py::_unit of a 4-vector, in place
__device__ __forceinline__ void unit4(float v[4], float eps) {
  const float n = clamp_min(sqrtf(v[0] * v[0] + v[1] * v[1] + v[2] * v[2] +
                                  v[3] * v[3]), eps);
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = v[i] / n;
}

// estimation.py::triangulate_dlt of one correspondence
__device__ void triangulate(const float P1[12], const float P2[12], float u1,
                            float v1, float u2, float v2, float X[3]) {
  float A[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    A[0][j] = u1 * P1[8 + j] - P1[j];
    A[1][j] = v1 * P1[8 + j] - P1[4 + j];
    A[2][j] = u2 * P2[8 + j] - P2[j];
    A[3][j] = v2 * P2[8 + j] - P2[4 + j];
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) unit4(A[r], 1e-12f);
  float M[16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      M[4 * i + j] = A[0][i] * A[0][j] + A[1][i] * A[1][j] +
                     A[2][i] * A[2][j] + A[3][i] * A[3][j];
  }
  // _smallest_eigvec, d = 4
  const float M3[9] = {M[0], M[1], M[2], M[4], M[5], M[6], M[8], M[9], M[10]};
  const float r3[3] = {-M[3], -M[7], -M[11]};
  float X0[3];
  solve3(M3, r3, X0);
  float v[4];
#pragma unroll
  for (int i = 0; i < 3; ++i) v[i] = isfinite(X0[i]) ? X0[i] : 0.0f;
  v[3] = 1.0f;
  unit4(v, 1e-30f);
  const float tr = M[0] + M[5] + M[10] + M[15];
  const float shift = 1e-7f * clamp_min(tr, 1e-20f);
  float Ms[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) Ms[i] = M[i] + ((i % 5) == 0 ? shift : 0.0f);
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    float x[4];
    chol_solve4(Ms, v, x);
    unit4(x, 1e-30f);
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = x[i];
  }
  const float w = v[3];
  const float safe_w = fabsf(w) < 1e-12f ? 1e-12f : w;
#pragma unroll
  for (int i = 0; i < 3; ++i) X[i] = v[i] / safe_w;
}

// camera.py::project_pinhole of one point; the reprojection error's norm
// against (u, v), and whether the point is in front
__device__ bool reproj_ok(const Args& a, const float q[4], const float t[3],
                          const float X[3], float u, float v) {
  float p[3];
  quat_rotate(q, X, p);
#pragma unroll
  for (int i = 0; i < 3; ++i) p[i] = p[i] + t[i];
  const bool front = p[2] > 1e-6f;
  const float z = front ? p[2] : 1.0f;
  const float pu = front ? a.fx * p[0] / z + a.cx : 0.0f;
  const float pv = front ? a.fy * p[1] / z + a.cy : 0.0f;
  const float du = pu - u, dv = pv - v;
  return front && sqrtf(du * du + dv * dv) <= a.max_reproj;
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads) triangulate_kernel(const Args a) {
  extern __shared__ int s_dyn[];
  int* s_mem = kShared ? s_dyn : a.work;
  const int N = a.N;
  int* s_best_d = s_mem;              // [N] float bits of the least distance
  int* s_best_q = s_mem + N;          // [N] its least query row
  int* s_want = s_mem + 2 * N;        // [N] 0 / 1, then 2 for the winners
  float* s_pw = (float*)(s_mem + 3 * N);   // [N,3]
  __shared__ int s_warp[kWarps];
  __shared__ float s_q[2][4], s_t[2][3], s_P[2][12];
  __shared__ int s_next;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid < 2) {
    const int slot = tid == 0 ? a.a : a.b;
    for (int c = 0; c < 4; ++c) s_q[tid][c] = a.kf_q[4 * slot + c];
    for (int c = 0; c < 3; ++c) s_t[tid][c] = a.kf_t[3 * slot + c];
    projection(a, s_q[tid], s_t[tid], s_P[tid]);
  }
  if (tid == 0) s_next = *a.next_lm;
  for (int m = tid; m < N; m += kThreads) {
    s_best_d[m] = 0x7f800000;   // +inf
    s_best_q[m] = N;
  }
  __syncthreads();

  const float* px_a = a.kf_px + (long long)a.a * 2 * N;
  const float* px_b = a.kf_px + (long long)a.b * 2 * N;
  const int* lm_a = a.kf_feat_lm + (long long)a.a * N;
  int* lm_b = a.kf_feat_lm + (long long)a.b * N;
  const float max_d = 511.0f;

  // the gated candidates and their points
  for (int n = tid; n < N; n += kThreads) {
    const int m = (int)a.idx[n];
    const float ua = px_a[n], va = px_a[N + n];
    const float ub = px_b[m], vb = px_b[N + m];
    const bool free_ = lm_a[n] < 0 && lm_b[m] < 0;
    float ra[3], rb[3];
    world_ray(a, ua, va, s_q[0], ra);
    world_ray(a, ub, vb, s_q[1], rb);
    float c = ra[0] * rb[0] + ra[1] * rb[1] + ra[2] * rb[2];
    c = c > 1.0f ? 1.0f : (c < -1.0f ? -1.0f : c);
    const bool angle_ok = acosf(c) >= a.min_angle;
    float X[3];
    triangulate(s_P[0], s_P[1], ua, va, ub, vb, X);
    const bool finite = isfinite(X[0]) && isfinite(X[1]) && isfinite(X[2]);
    const bool ok = reproj_ok(a, s_q[0], s_t[0], X, ua, va) &&
                    reproj_ok(a, s_q[1], s_t[1], X, ub, vb);
    const bool want = a.valid[n] && free_ && angle_ok && finite && ok;
    s_want[n] = want;
#pragma unroll
    for (int k = 0; k < 3; ++k) s_pw[3 * n + k] = X[k];
    if (want) {
      const float d = a.dist[n] > max_d ? max_d : a.dist[n];
      atomicMin(&s_best_d[m], __float_as_int(d));
    }
  }
  __syncthreads();
  // ties at the least distance: the least query row
  for (int n = tid; n < N; n += kThreads) {
    if (!s_want[n]) continue;
    const int m = (int)a.idx[n];
    const float d = a.dist[n] > max_d ? max_d : a.dist[n];
    if (__float_as_int(d) == s_best_d[m]) atomicMin(&s_best_q[m], n);
    else s_want[n] = 0;
  }
  __syncthreads();

  // ranks of the winners in query order: a prefix count over the block
  int base = 0;
  for (int n0 = 0; n0 < N; n0 += kThreads) {
    const int n = n0 + tid;
    int win = 0;
    if (n < N && s_want[n]) win = s_best_q[(int)a.idx[n]] == n;
    const unsigned mask = __ballot_sync(0xffffffffu, win);
    if (lane == 0) s_warp[warp] = __popc(mask);
    __syncthreads();
    int before = base;
    for (int w = 0; w < warp; ++w) before += s_warp[w];
    before += __popc(mask & ((1u << lane) - 1u));
    int total = 0;
    for (int w = 0; w < kWarps; ++w) total += s_warp[w];
    if (win) {
      const long long slot = (long long)s_next + before;
      if (slot < a.L) {
        for (int k = 0; k < 3; ++k)
          a.lm_pos[(long long)k * a.Lp + slot] = s_pw[3 * n + k];
        a.lm_alive[slot] = 1;
        a.lm_obs[slot] = 2;
        // one slot on both sides: the train side's links are written last
        // and keep the row, as in the plain version
        if (a.a != a.b) a.kf_feat_lm[(long long)a.a * N + n] = (int)slot;
        lm_b[(int)a.idx[n]] = (int)slot;
      }
    }
    base += total;
    __syncthreads();
  }
  if (tid == 0) {
    const long long room = (long long)a.L - s_next;
    const long long created = base < room ? base : (room > 0 ? room : 0);
    const long long next = (long long)s_next + base;
    *a.next_lm = (int)(next < a.L ? next : a.L);
    *a.lm_dropped += (int)(base - created);
  }
}

// one launch, the words in shared memory or in the workspace; the first
// launch on a device allows the shared instantiation the most it takes
template <bool kShared>
cudaError_t launch(const Args& a, size_t smem, cudaStream_t stream) {
  static bool raised[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (smem > 48 * 1024 && (dev >= 64 || !raised[dev])) {
    err = cudaFuncSetAttribute(triangulate_kernel<kShared>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)(kSharedFeatures * 6 * sizeof(int)));
    if (err != cudaSuccess) return err;
    if (dev < 64) raised[dev] = true;
  }
  triangulate_kernel<kShared><<<1, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes); returns the cudaError_t of the
// launch on `stream` (a cudaStream_t).
//
// layout (int64): [N, Lp, L, slot a, slot b]; params (f32): [fx, fy, cx, cy,
// min angle (radians), max reprojection error (px)]. Every tensor is
// contiguous; the workspace holds 6 N int32 words (used above 8,192
// features).
extern "C" int vxs_triangulate(const void* kf_q, const void* kf_t,
                               const void* kf_px, void* kf_feat_lm,
                               void* lm_pos, void* lm_alive, void* lm_obs,
                               void* next_lm, void* lm_dropped, const void* idx,
                               const void* dist, const void* valid,
                               void* workspace, const long long* layout,
                               const float* params, void* stream) {
  Args a;
  a.kf_q = (const float*)kf_q;
  a.kf_t = (const float*)kf_t;
  a.kf_px = (const float*)kf_px;
  a.kf_feat_lm = (int*)kf_feat_lm;
  a.lm_pos = (float*)lm_pos;
  a.lm_alive = (unsigned char*)lm_alive;
  a.lm_obs = (int*)lm_obs;
  a.next_lm = (int*)next_lm;
  a.lm_dropped = (int*)lm_dropped;
  a.idx = (const long long*)idx;
  a.dist = (const float*)dist;
  a.valid = (const unsigned char*)valid;
  a.work = (int*)workspace;
  const long long N = layout[0], Lp = layout[1], L = layout[2];
  if (N < 1 || N > (1LL << 28) || Lp < N || Lp > 0x7ffffffeLL || L != Lp - N)
    return (int)cudaErrorInvalidValue;
  a.N = (int)N;
  a.Lp = (int)Lp;
  a.L = (int)L;
  a.a = (int)layout[3];
  a.b = (int)layout[4];
  a.fx = params[0];
  a.fy = params[1];
  a.cx = params[2];
  a.cy = params[3];
  a.min_angle = params[4];
  a.max_reproj = params[5];
  if (N <= kSharedFeatures)
    return (int)launch<true>(a, (size_t)N * 6 * sizeof(int), (cudaStream_t)stream);
  return (int)launch<false>(a, 0, (cudaStream_t)stream);
}
