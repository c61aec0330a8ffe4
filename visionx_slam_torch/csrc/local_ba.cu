// Windowed local bundle adjustment (K3), for Hopper (sm_90a): one whole
// models/local_ba.py::local_ba call in one launch, its convergence test
// included, so the host reads nothing.
//
// It replaces no TPU kernel: the JAX package leaves local BA to XLA, which
// fuses an iteration into a few programs. The port ran it as an eager chain
// of ~630 small launches a call (set-up ~80, each alternating iteration
// ~250-300, the unrolled 6x6 Cholesky alone ~85), and with the early exit one
// or two device reads; a keyframe event of the scan paid that on the host.
// K3 computes the same function as the plain version (_local_ba_plain) in
// float32, with the same formulas, clamps, gates and branches:
//
//   window: the newest W alive keyframes, ascending by frame id (a stable
//     sort of the slots by id, descending, the W first reversed; a window of
//     fewer alive keyframes holds empty slots, masked)
//   buckets: each feature of the window that has a landmark (valid, in a
//     valid window slot, linked >= 0) belongs to its landmark's bucket;
//     features without one use the last physical landmark row (the padding
//     bucket) and are summed by no bucket
//   enabled: at least two valid keyframes and one eligible landmark (alive,
//     at least min_point_observations)
//   per iteration:
//     pose pass (landmarks fixed), every feature of every window keyframe:
//       pc = R(q) X + t (quat_to_matrix), z clamped at 1e-6, residual
//       r = px - projection, observed where it has an alive landmark, pc.z >
//       1e-6 and |r| <= max_reproj_error, Huber weight at huber_delta;
//       J = [Jp | pc x Jp]; per keyframe H = sum w J^T J + 1e-6 I, b = sum w
//       J^T r, dx by the unrolled Cholesky (diagonal clamped at 1e-12),
//       applied where the keyframe has min_pose_observations observations,
//       is valid, the loop is not done, the window is enabled and dx is
//       finite; pose = normalize(exp(dx) * pose) (exp(0) where not applied)
//     point pass (the new poses fixed), every eligible landmark: the 3x3
//       blocks Jpt^T w Jpt and Jpt^T w r of its observations (Jpt = Jp R)
//       summed in feature order, dp = adj(A + 1e-6 I) b / det (|det|
//       clamped at 1e-20), applied under the same gates with
//       min_point_observations
//     convergence: done |= (no observation) or |last - cost| < rel_tol *
//       last; the iteration counts unless the loop was done or disabled
//   with early_exit the loop stops when done is set (the plain version's
//   host-read loop), without it the remaining iterations run masked (its
//   fixed loop); the cost and observation count are the last iteration's
//
// Poses are wxyz quaternions plus translations (ops/se3.py). NaN propagates
// as in torch: clamps are written x < lo ? lo : x, and every product of the
// normal equations is formed, rows of weight zero included, so a NaN or inf
// in one feature poisons its keyframe's or its landmark's step as it does
// there.
//
// Design. One block of 512 threads does the whole call; the window's poses
// and sums live in shared memory, and so do its sort keys while they fit
// there (W x N up to 16,384 at W = 5); above that the keys take the caller's
// workspace in global memory, in the same kernel (an instantiation of it),
// as the buckets' positions and flags always do (a few hundred kB, L1/L2
// resident). So any window the plain version takes runs, up to 1,024 slots
// (their state in shared memory) and 2**28 window features. The buckets
// are built by a bitonic sort of (landmark, feature) keys, unique, so the
// order is fixed; a bucket's head walks its features in feature order, which
// is the order the plain version's segment sums add in. The pose pass splits
// each keyframe's features into chunks, one warp a (keyframe, chunk), sums a
// chunk by a fixed-order shuffle tree and the chunks in chunk order, and one
// thread a keyframe solves and updates; the point pass runs one thread a
// bucket. No atomics touch a float, so a call repeats bit for bit on the
// card. The pose and point passes are ordered by __syncthreads: that
// ordering is the one constraint a multi-block layout would have to pay a
// grid-wide barrier for, and the problem (W x N = 5,120 features, at most 5
// iterations) is far too small to need one.
//
// Bound. Bytes: the window's features (link, validity, pixels) and poses,
// and for each of its at most W x N landmarks the position, flags and count
// read and the position written (utils/flops.py: k3_bytes); the arithmetic
// (k3_ops), ~300 operations a feature an iteration and the sort, is larger.
// What the kernel waits on is its serial parts: the sort's barriers, one
// thread's 6x6 solve a keyframe, and the launch itself. Times: PERF.md.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxWindow = 1024;     // window slots: their state in shared memory
constexpr long long kMaxRows = 1LL << 28;   // W x N: int indices of the workspace
constexpr int kUnits = 5 * kWarps;    // (keyframe, chunk) units of a pose pass
constexpr int kSums = 29;             // 21 of H's upper triangle, 6 of b,
                                      // the cost and the observation count
// dynamic shared memory a launch takes at most: the window's state, and the
// sort keys where they fit beside it
constexpr int kSmemBudget = 200 * 1024;
constexpr int kAlive = 1, kEligible = 2;

struct Args {
  float* kf_q;                 // [K,4] wxyz, updated in place
  float* kf_t;                 // [K,3], updated in place
  const int* kf_id;            // [K]
  const float* kf_px;          // [K,2,N]
  const unsigned char* kf_fvalid;  // [K,N] bool
  const int* kf_feat_lm;       // [K,N]
  float* lm_pos;               // [3,Lp], updated in place
  const unsigned char* lm_alive;   // [Lp] bool
  const int* lm_obs;           // [Lp]
  int* stats;                  // [3]: iterations, final cost (f32 bits),
                               // observations of the last pose pass
  int* ws_head;                // [S] a feature's bucket head, -1: none
  float* ws_pos;               // [S,4] a head's landmark position
  int* ws_flag;                // [S] a head's kAlive | kEligible
  unsigned long long* ws_keys; // [P] the sort keys where shared memory has
                               // no room for them
  int K, N, Lp, W, iters, min_pose_obs, min_point_obs, early_exit;
  float fx, fy, cx, cy, huber, max_err, rel_tol;
};

// torch.clamp(x, min=lo): a NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
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

// ops/se3.py::quat_rotate: v + 2 (w (u x v) + u x (u x v)), u = q.xyz
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

// pose <- normalize(exp(dx) * pose) (se3_exp, se3_compose), in place
__device__ void retract(const float dx[6], float q[4], float t[3]) {
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
  quat_rotate(qe, t, tr);
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = qm[i] * sign;
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = tr[i] + te[i];
}

// ops/linalg.py::chol_solve6x6 (eps 1e-12) of the damped sums: s holds H's
// upper triangle row by row, then b
__device__ void chol_solve6(const float s[kSums], float dx[6]) {
  float A[6][6], b[6];
  int k = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = i; j < 6; ++j) A[j][i] = s[k++] + (i == j ? 1e-6f : 0.0f);
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) b[i] = s[21 + i];
  float L[6][6], y[6];
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

// A feature seen from keyframe pose (R, t): the camera point, its residual
// and the projection Jacobian's two rows; returns the residual's norm.
struct View {
  float pc[3], e[2], ju[3], jv[3];
  float en;
  bool z_ok;
};

__device__ __forceinline__ void view(const Args& a, const float R[9],
                                     const float t[3], const float X[3],
                                     float mu, float mv, View& o) {
#pragma unroll
  for (int j = 0; j < 3; ++j)
    o.pc[j] = (X[0] * R[3 * j] + X[1] * R[3 * j + 1] + X[2] * R[3 * j + 2]) + t[j];
  o.z_ok = o.pc[2] > 1e-6f;
  const float zs = clamp_min(o.pc[2], 1e-6f);
  o.e[0] = mu - (a.fx * o.pc[0] / zs + a.cx);
  o.e[1] = mv - (a.fy * o.pc[1] / zs + a.cy);
  o.en = sqrtf(o.e[0] * o.e[0] + o.e[1] * o.e[1]);
  const float iz = 1.0f / zs;
  const float iz2 = iz * iz;
  o.ju[0] = a.fx * iz;
  o.ju[1] = 0.0f;
  o.ju[2] = (-a.fx * o.pc[0]) * iz2;
  o.jv[0] = 0.0f;
  o.jv[1] = a.fy * iz;
  o.jv[2] = (-a.fy * o.pc[1]) * iz2;
}

// local_ba.py::_huber_w
__device__ __forceinline__ float huber_w(float en, float delta) {
  return en <= delta ? 1.0f : delta / clamp_min(en, 1e-12f);
}

// (keyframe, chunk) units of a pose pass: C chunks a keyframe
__host__ __device__ __forceinline__ int chunks(int W) {
  return W < kUnits ? kUnits / W : 1;
}

// bytes of the window's state in dynamic shared memory: poses, rotations,
// costs, the pose pass's partial sums, counts, slots and validity
__host__ __device__ __forceinline__ long long window_bytes(int W) {
  return 4LL * (17LL * W + (long long)W * chunks(W) * kSums + 3LL * W);
}

template <bool kSharedKeys>
__global__ void __launch_bounds__(kThreads, 1) local_ba_kernel(const Args a) {
  // [P] (landmark, feature) keys while they fit, then the window's state
  extern __shared__ __align__(16) unsigned char s_dyn[];
  __shared__ float s_pad[3];
  __shared__ int s_any, s_done;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = a.K, N = a.N, Lp = a.Lp, W = a.W, S = W * N;
  int P = 1;
  while (P < S) P <<= 1;
  const int C = chunks(W);
  unsigned long long* s_keys =
      kSharedKeys ? (unsigned long long*)s_dyn : a.ws_keys;
  float* s_q = (float*)(s_dyn + (kSharedKeys ? (size_t)P * 8 : 0));  // [W,4]
  float* s_t = s_q + 4 * W;                  // [W,3]
  float* s_R = s_t + 3 * W;                  // [W,9]
  float* s_cost = s_R + 9 * W;               // [W]
  float* s_part = s_cost + W;                // [W C, kSums]
  int* s_cnt = (int*)(s_part + W * C * kSums);   // [W]
  int* s_slot = s_cnt + W;                   // [W]
  int* s_wvalid = s_slot + W;                // [W]

  // ---- the window: slots ranked by a stable descending sort of the ids ----
  for (int k = tid; k < K; k += kThreads) {
    const int idk = a.kf_id[k] >= 0 ? a.kf_id[k] : -1;
    int rank = 0;
    for (int j = 0; j < K; ++j) {
      const int idj = a.kf_id[j] >= 0 ? a.kf_id[j] : -1;
      rank += (idj > idk) || (idj == idk && j < k);
    }
    if (rank < W) {
      s_slot[W - 1 - rank] = k;
      s_wvalid[W - 1 - rank] = idk >= 0;
    }
  }
  if (tid == 0) {
    s_any = 0;
    for (int c = 0; c < 3; ++c) s_pad[c] = a.lm_pos[(long long)c * Lp + Lp - 1];
  }
  __syncthreads();
  for (int w = tid; w < W; w += kThreads) {
    const int slot = s_slot[w];
    for (int c = 0; c < 4; ++c) s_q[4 * w + c] = a.kf_q[4 * slot + c];
    for (int c = 0; c < 3; ++c) s_t[3 * w + c] = a.kf_t[3 * slot + c];
    quat_to_matrix(s_q + 4 * w, s_R + 9 * w);
  }

  // ---- buckets: sort (landmark or Lp, feature) keys ----
  for (int r = tid; r < P; r += kThreads) {
    unsigned long long key = ~0ull;
    if (r < S) {
      const int w = r / N, n = r - w * N;
      const long long f = (long long)s_slot[w] * N + n;
      const int lm = a.kf_feat_lm[f];
      const bool has = a.kf_fvalid[f] && s_wvalid[w] && lm >= 0;
      const unsigned int bucket = has ? (unsigned int)(lm < Lp - 1 ? lm : Lp - 1)
                                      : (unsigned int)Lp;
      key = ((unsigned long long)bucket << 32) | (unsigned int)r;
    }
    s_keys[r] = key;
  }
  __syncthreads();
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = tid; p < P / 2; p += kThreads) {
        const int i = 2 * j * (p / j) + (p % j), l = i + j;
        const unsigned long long x = s_keys[i], y = s_keys[l];
        if ((x > y) == ((i & k) == 0)) {
          s_keys[i] = y;
          s_keys[l] = x;
        }
      }
      __syncthreads();
    }
  }
  // a bucket's head (its first sorted entry) keeps the landmark's position
  // and flags; every feature learns its head
  for (int i = tid; i < S; i += kThreads) {
    const unsigned int key = (unsigned int)(s_keys[i] >> 32);
    if (key >= (unsigned int)Lp) {
      a.ws_head[(unsigned int)s_keys[i]] = -1;
      continue;
    }
    if (i > 0 && (unsigned int)(s_keys[i - 1] >> 32) == key) continue;
    const bool alive = a.lm_alive[key];
    const bool elig = alive && a.lm_obs[key] >= a.min_point_obs;
    for (int c = 0; c < 3; ++c)
      a.ws_pos[4 * i + c] = a.lm_pos[(long long)c * Lp + key];
    a.ws_flag[i] = (alive ? kAlive : 0) | (elig ? kEligible : 0);
    if (elig) atomicOr(&s_any, 1);
    for (int j = i; j < S && (unsigned int)(s_keys[j] >> 32) == key; ++j)
      a.ws_head[(unsigned int)s_keys[j]] = i;
  }
  __syncthreads();
  int n_kf = 0;
  for (int w = 0; w < W; ++w) n_kf += s_wvalid[w];
  const bool enabled = n_kf >= 2 && s_any;

  // ---- the alternating iterations ----
  const int chunk = (N + C - 1) / C;
  float last_cost = FLT_MAX, cost_out = FLT_MAX;
  int iters = 0, obs_out = 0;
  if (tid == 0) s_done = !enabled;
  __syncthreads();
  for (int it = 0; it < a.iters; ++it) {
    const bool done_in = s_done;
    if (a.early_exit && done_in) break;

    // pose pass: a warp a (keyframe, chunk)
    for (int u = warp; u < W * C; u += kWarps) {
      const int w = u / C, c = u - w * C;
      float acc[kSums];
#pragma unroll
      for (int k = 0; k < kSums; ++k) acc[k] = 0.0f;
      const long long base = (long long)s_slot[w] * 2 * N;
      const int hi = min(N, (c + 1) * chunk);
      for (int n = c * chunk + lane; n < hi; n += 32) {
        const int h = a.ws_head[w * N + n];
        float X[3];
        bool alive = false;
        if (h >= 0) {
#pragma unroll
          for (int k = 0; k < 3; ++k) X[k] = a.ws_pos[4 * h + k];
          alive = a.ws_flag[h] & kAlive;
        } else {
#pragma unroll
          for (int k = 0; k < 3; ++k) X[k] = s_pad[k];
        }
        View v;
        view(a, s_R + 9 * w, s_t + 3 * w, X, a.kf_px[base + n],
             a.kf_px[base + N + n], v);
        const bool obs = h >= 0 && alive && v.z_ok && v.en <= a.max_err;
        const float ww = obs ? huber_w(v.en, a.huber) : 0.0f;
        // J = [Jp | pc x Jp], a row for u and one for v
        const float* p = v.pc;
        const float gu[6] = {v.ju[0], v.ju[1], v.ju[2],
                             p[1] * v.ju[2] - p[2] * v.ju[1],
                             p[2] * v.ju[0] - p[0] * v.ju[2],
                             p[0] * v.ju[1] - p[1] * v.ju[0]};
        const float gv[6] = {v.jv[0], v.jv[1], v.jv[2],
                             p[1] * v.jv[2] - p[2] * v.jv[1],
                             p[2] * v.jv[0] - p[0] * v.jv[2],
                             p[0] * v.jv[1] - p[1] * v.jv[0]};
        int k = 0;
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          const float wu = gu[i] * ww, wv = gv[i] * ww;
#pragma unroll
          for (int j = i; j < 6; ++j) acc[k++] += wu * gu[j] + wv * gv[j];
        }
#pragma unroll
        for (int i = 0; i < 6; ++i)
          acc[21 + i] += (gu[i] * ww) * v.e[0] + (gv[i] * ww) * v.e[1];
        acc[27] += ww * (v.e[0] * v.e[0] + v.e[1] * v.e[1]);
        acc[28] += obs ? 1.0f : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < kSums; ++k) {
        float x = acc[k];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          x += __shfl_down_sync(0xffffffffu, x, off);
        if (lane == 0) s_part[u * kSums + k] = x;
      }
    }
    __syncthreads();
    for (int w = tid; w < W; w += kThreads) {
      float s[kSums];
#pragma unroll
      for (int k = 0; k < kSums; ++k) {
        float x = s_part[w * C * kSums + k];
        for (int c = 1; c < C; ++c) x += s_part[(w * C + c) * kSums + k];
        s[k] = x;
      }
      float dx[6];
      chol_solve6(s, dx);
      bool finite = true;
#pragma unroll
      for (int i = 0; i < 6; ++i) finite = finite && isfinite(dx[i]);
      const int cnt = (int)s[28];
      const bool apply = cnt >= a.min_pose_obs && s_wvalid[w] && !done_in &&
                         enabled && finite;
      if (!apply) {
#pragma unroll
        for (int i = 0; i < 6; ++i) dx[i] = 0.0f;
      }
      retract(dx, s_q + 4 * w, s_t + 3 * w);
      quat_to_matrix(s_q + 4 * w, s_R + 9 * w);
      s_cost[w] = s[27];
      s_cnt[w] = cnt;
    }
    __syncthreads();

    // point pass: a thread an eligible bucket, its features in order
    if (!done_in && enabled) {
      for (int i = tid; i < S; i += kThreads) {
        const unsigned int key = (unsigned int)(s_keys[i] >> 32);
        if (key >= (unsigned int)Lp) continue;
        if (i > 0 && (unsigned int)(s_keys[i - 1] >> 32) == key) continue;
        if (!(a.ws_flag[i] & kEligible)) continue;
        float X[3] = {a.ws_pos[4 * i], a.ws_pos[4 * i + 1], a.ws_pos[4 * i + 2]};
        float H[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        float b[3] = {0.0f, 0.0f, 0.0f}, cnt = 0.0f;
        for (int j = i; j < S && (unsigned int)(s_keys[j] >> 32) == key; ++j) {
          const int r = (int)(unsigned int)s_keys[j];
          const int w = r / N, n = r - w * N;
          const long long base = (long long)s_slot[w] * 2 * N;
          const float* R = s_R + 9 * w;
          View v;
          view(a, R, s_t + 3 * w, X, a.kf_px[base + n], a.kf_px[base + N + n], v);
          const bool obs = v.z_ok && v.en <= a.max_err;
          const float ww = obs ? huber_w(v.en, a.huber) : 0.0f;
          float Ju[3], Jv[3];   // Jp R
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            Ju[k] = v.ju[0] * R[k] + v.ju[1] * R[3 + k] + v.ju[2] * R[6 + k];
            Jv[k] = v.jv[0] * R[k] + v.jv[1] * R[3 + k] + v.jv[2] * R[6 + k];
          }
#pragma unroll
          for (int p = 0; p < 3; ++p) {
#pragma unroll
            for (int q = 0; q < 3; ++q)
              H[3 * p + q] += Ju[p] * (Ju[q] * ww) + Jv[p] * (Jv[q] * ww);
            b[p] += Ju[p] * (v.e[0] * ww) + Jv[p] * (v.e[1] * ww);
          }
          cnt += obs ? 1.0f : 0.0f;
        }
        H[0] += 1e-6f;
        H[4] += 1e-6f;
        H[8] += 1e-6f;
        float dp[3];
        solve3(H, b, dp);
        const bool finite = isfinite(dp[0]) && isfinite(dp[1]) && isfinite(dp[2]);
        if (cnt >= (float)a.min_point_obs && finite) {
#pragma unroll
          for (int k = 0; k < 3; ++k) a.ws_pos[4 * i + k] = X[k] + dp[k];
        }
      }
    }

    // convergence
    if (tid == 0) {
      float cost = s_cost[0];
      int tobs = s_cnt[0];
      for (int w = 1; w < W; ++w) {
        cost += s_cost[w];
        tobs += s_cnt[w];
      }
      const bool converged =
          tobs == 0 || fabsf(last_cost - cost) < a.rel_tol * last_cost;
      iters += (done_in || !enabled) ? 0 : 1;
      s_done = done_in || converged;
      last_cost = cost_out = cost;
      obs_out = tobs;
    }
    __syncthreads();
  }

  // ---- write back: the valid window poses, the eligible landmarks ----
  for (int w = tid; w < W; w += kThreads) {
    if (!s_wvalid[w]) continue;
    const int slot = s_slot[w];
    for (int c = 0; c < 4; ++c) a.kf_q[4 * slot + c] = s_q[4 * w + c];
    for (int c = 0; c < 3; ++c) a.kf_t[3 * slot + c] = s_t[3 * w + c];
  }
  for (int i = tid; i < S; i += kThreads) {
    const unsigned int key = (unsigned int)(s_keys[i] >> 32);
    if (key >= (unsigned int)Lp) continue;
    if (i > 0 && (unsigned int)(s_keys[i - 1] >> 32) == key) continue;
    if (!(a.ws_flag[i] & kEligible)) continue;
    for (int c = 0; c < 3; ++c)
      a.lm_pos[(long long)c * Lp + key] = a.ws_pos[4 * i + c];
  }
  if (tid == 0) {
    a.stats[0] = iters;
    a.stats[1] = __float_as_int(cost_out);
    a.stats[2] = obs_out;
  }
}

// one launch, the keys in shared memory or in the workspace; the first
// launch of an instantiation on a device allows it the budget
template <bool kSharedKeys>
cudaError_t launch(const Args& a, size_t smem, cudaStream_t stream) {
  static bool raised[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (smem > 48 * 1024 && (dev >= 64 || !raised[dev])) {
    err = cudaFuncSetAttribute(local_ba_kernel<kSharedKeys>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBudget);
    if (err != cudaSuccess) return err;
    if (dev < 64) raised[dev] = true;
  }
  local_ba_kernel<kSharedKeys><<<1, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes); returns the cudaError_t of the
// launch on `stream` (a cudaStream_t).
//
// layout (int64): [K, N, Lp, W, iterations, min_pose_observations,
// min_point_observations, early_exit]; params (f32): [fx, fy, cx, cy,
// huber_delta, max_reproj_error, rel_tol]. Every tensor is contiguous; the
// workspace holds 6 W N + 2 P int32 words, P the least power of two at or
// above W N (the last 2 P: the sort keys, where shared memory has no room).
extern "C" int vxs_local_ba(void* kf_q, void* kf_t, const void* kf_id,
                            const void* kf_px, const void* kf_fvalid,
                            const void* kf_feat_lm, void* lm_pos,
                            const void* lm_alive, const void* lm_obs,
                            void* stats, void* workspace,
                            const long long* layout, const float* params,
                            void* stream) {
  Args a;
  a.kf_q = (float*)kf_q;
  a.kf_t = (float*)kf_t;
  a.kf_id = (const int*)kf_id;
  a.kf_px = (const float*)kf_px;
  a.kf_fvalid = (const unsigned char*)kf_fvalid;
  a.kf_feat_lm = (const int*)kf_feat_lm;
  a.lm_pos = (float*)lm_pos;
  a.lm_alive = (const unsigned char*)lm_alive;
  a.lm_obs = (const int*)lm_obs;
  a.stats = (int*)stats;
  const long long K = layout[0], N = layout[1], Lp = layout[2], W = layout[3];
  if (K < 1 || N < 1 || Lp < 1 || Lp > 0x7ffffffeLL || W < 1 ||
      W > kMaxWindow || W > K || W * N > kMaxRows || layout[4] < 0)
    return (int)cudaErrorInvalidValue;
  a.K = (int)K;
  a.N = (int)N;
  a.Lp = (int)Lp;
  a.W = (int)W;
  a.iters = (int)layout[4];
  a.min_pose_obs = (int)layout[5];
  a.min_point_obs = (int)layout[6];
  a.early_exit = layout[7] != 0;
  const long long S = W * N;
  int* ws = (int*)workspace;
  a.ws_head = ws;
  a.ws_pos = (float*)(ws + S);
  a.ws_flag = ws + 5 * S;
  a.ws_keys = (unsigned long long*)(ws + 6 * S);
  a.fx = params[0];
  a.fy = params[1];
  a.cx = params[2];
  a.cy = params[3];
  a.huber = params[4];
  a.max_err = params[5];
  a.rel_tol = params[6];

  long long P = 1;
  while (P < S) P <<= 1;
  const long long state = window_bytes(a.W);
  const long long keys = P * (long long)sizeof(unsigned long long);
  if (state + keys <= kSmemBudget)
    return (int)launch<true>(a, (size_t)(state + keys), (cudaStream_t)stream);
  return (int)launch<false>(a, (size_t)state, (cudaStream_t)stream);
}
