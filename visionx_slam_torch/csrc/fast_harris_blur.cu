// Fused FAST-9/16 + Harris + masked 3x3 NMS + border mask + 7-tap Gaussian
// blur over a batch of bf16 pyramid atlases, for Hopper (sm_90a).
//
// Replaces the TPU kernel visionx_slam_tpu/ops/pallas_detect.py::
// fast_harris_blur and computes the same function:
//
//   score f32 [B,H,W]: Harris response where (FAST-9 corner at threshold t)
//                      & (inside the border mask) & (3x3 NMS winner, ties
//                      survive), else NEG = -3e38;
//   blur  bf16 [B,H,W]: separable 7-tap Gaussian (sigma 2), vertical first.
//
// Out-of-image taps read the nearest edge pixel (clamped coordinates), which
// is the edge padding the TPU kernel applies before its row tiles.
//
// Rounding points follow the TPU kernel: FAST compares in f32; the Sobel
// taps, gradient products and 7x7 box sums round to bf16 after every
// multiply and add, in the same tap order; det/trace run in f32 with
// explicit _rn intrinsics so no FMA contraction changes a rounding.
//
// What bounds it on the H100. Its bytes: each pixel reads 2 B of image and
// 1 B of mask and writes 4 B of score and 2 B of blur, about 9 B per pixel
// or 11 MB per 1896x640 atlas. The design moves only those: it reads every
// input pixel once into shared memory (a 32x32 output tile plus a 5-pixel
// halo: FAST radius 3 + NMS 1, or Sobel 1 + box 3 + NMS 1), keeps every
// intermediate (corner flags, Sobel rows, gradient products, box sums,
// masked Harris, blur rows) on chip, and writes each output once. Measured
// on an H100 at 700 W, 8 atlases take ~0.38 ms, ~230 GB/s or 7% of HBM
// bandwidth, so at present the per-pixel instructions bound it instead:
// the bf16 rounding after every add and multiply (two conversions each),
// the 16-tap FAST test and the 7x7 box sums, at 3 blocks of 256 threads
// per SM (70 KB of shared memory each).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;              // output tile side
constexpr int HALO = 5;
constexpr int IN = TILE + 2 * HALO;   // 42: input tile, virtual [-5, 37)
constexpr int GR = TILE + 8;          // 40: gradient region, virtual [-4, 36)
constexpr int HR = TILE + 2;          // 34: FAST/Harris region, virtual [-1, 33)
constexpr int BV = TILE + 6;          // 38: blur row region, virtual [-3, 35)
constexpr int THREADS = 256;
constexpr float NEG = -3.0e38f;
constexpr float HARRIS_K = 0.04f;

// FAST circle (dy, dx), radius 3, clockwise from 12 o'clock; bit i = tap i.
__constant__ int kCircleDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3,
                                  3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int kCircleDx[16] = {0, 1, 2, 3, 3, 3, 2, 1,
                                  0, -1, -2, -3, -3, -3, -2, -1};

struct BlurTaps {
  float w[7];  // Gaussian taps, already rounded to bf16
};

// shared-memory layout (floats), one region per intermediate
constexpr int OFF_IN = 0;                     // [IN][IN]   image
constexpr int OFF_RS = OFF_IN + IN * IN;      // [GR][IN]   Sobel smooth rows
constexpr int OFF_RD = OFF_RS + GR * IN;      // [GR][IN]   Sobel diff rows
constexpr int OFF_P = OFF_RD + GR * IN;       // 3 x [GR][GR] gradient products
constexpr int OFF_V = OFF_P + 3 * GR * GR;    // 3 x [HR][GR] vertical box sums
constexpr int OFF_M = OFF_V + 3 * HR * GR;    // [HR][HR]   masked Harris
constexpr int OFF_BV = OFF_M + HR * HR;       // [TILE][BV] vertical blur
constexpr int OFF_C = OFF_BV + TILE * BV;     // [HR][HR]   corner flags
constexpr int SMEM_FLOATS = OFF_C + HR * HR;
constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float);

__device__ __forceinline__ float r16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float add16(float a, float b) {
  return r16(__fadd_rn(a, b));
}
__device__ __forceinline__ float sub16(float a, float b) {
  return r16(__fsub_rn(a, b));
}
__device__ __forceinline__ float mul16(float a, float b) {
  return r16(__fmul_rn(a, b));
}

// cyclic run of >= 9 set bits among 16: duplicate to 32 bits, shift-AND
__device__ __forceinline__ unsigned run9(unsigned m) {
  unsigned x = m | (m << 16);
  unsigned r = x & (x >> 1);
  r = r & (r >> 2);
  r = r & (r >> 4);
  r = r & (x >> 8);
  return r & 0xFFFFu;
}

__global__ void __launch_bounds__(THREADS)
fast_harris_blur_kernel(const __nv_bfloat16* __restrict__ img,
                        const int8_t* __restrict__ mask,
                        float* __restrict__ score,
                        __nv_bfloat16* __restrict__ blur,
                        int H, int W, float threshold, BlurTaps taps) {
  extern __shared__ float smem[];
  float* s_in = smem + OFF_IN;
  float* s_rs = smem + OFF_RS;
  float* s_rd = smem + OFF_RD;
  float* s_pxx = smem + OFF_P;
  float* s_pyy = s_pxx + GR * GR;
  float* s_pxy = s_pyy + GR * GR;
  float* s_vxx = smem + OFF_V;
  float* s_vyy = s_vxx + HR * GR;
  float* s_vxy = s_vyy + HR * GR;
  float* s_m = smem + OFF_M;
  float* s_bv = smem + OFF_BV;
  float* s_c = smem + OFF_C;

  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * TILE;
  const int y0 = blockIdx.y * TILE;
  const size_t frame = (size_t)blockIdx.z * H * W;
  const __nv_bfloat16* im = img + frame;

  // 1. input tile + halo, clamped at the image edge
  for (int i = tid; i < IN * IN; i += THREADS) {
    int iy = i / IN, ix = i % IN;
    int gy = min(max(y0 - HALO + iy, 0), H - 1);
    int gx = min(max(x0 - HALO + ix, 0), W - 1);
    s_in[i] = __bfloat162float(im[(size_t)gy * W + gx]);
  }
  __syncthreads();

  // 2a. FAST-9 corner flags over the NMS region; s_in index = virtual + 5
  for (int i = tid; i < HR * HR; i += THREADS) {
    int h = i / HR, w = i % HR;
    int cy = h + 4, cx = w + 4;
    float center = s_in[cy * IN + cx];
    float hi = __fadd_rn(center, threshold);
    float lo = __fsub_rn(center, threshold);
    unsigned bright = 0, dark = 0;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      float tap = s_in[(cy + kCircleDy[k]) * IN + cx + kCircleDx[k]];
      bright |= (tap > hi) ? (1u << k) : 0u;
      dark |= (tap < lo) ? (1u << k) : 0u;
    }
    s_c[i] = (run9(bright) | run9(dark)) ? 1.0f : 0.0f;
  }
  // 2b. Sobel rows over the gradient rows, all input columns:
  //     smooth = (2*c + up) + down, diff = down - up (bf16)
  for (int i = tid; i < GR * IN; i += THREADS) {
    int r = i / IN, c = i % IN;
    float up = s_in[r * IN + c];
    float mid = s_in[(r + 1) * IN + c];
    float dn = s_in[(r + 2) * IN + c];
    s_rs[i] = add16(add16(mul16(mid, 2.0f), up), dn);
    s_rd[i] = sub16(dn, up);
  }
  // 2c. vertical blur pass over the output rows, blur-row columns
  for (int i = tid; i < TILE * BV; i += THREADS) {
    int r = i / BV, c = i % BV;
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 7; ++k)
      acc = add16(acc, mul16(taps.w[k], s_in[(r + 2 + k) * IN + c + 2]));
    s_bv[i] = acc;
  }
  __syncthreads();

  // 3a. gradients (x0.25) and their products over the gradient region
  for (int i = tid; i < GR * GR; i += THREADS) {
    int r = i / GR, c = i % GR;
    const float* rs = s_rs + r * IN + c;  // columns c, c+1, c+2
    const float* rd = s_rd + r * IN + c;
    float dx = mul16(sub16(rs[2], rs[0]), 0.25f);
    float dy = mul16(add16(add16(rd[0], mul16(2.0f, rd[1])), rd[2]), 0.25f);
    s_pxx[i] = mul16(dx, dx);
    s_pyy[i] = mul16(dy, dy);
    s_pxy[i] = mul16(dx, dy);
  }
  // 3b. horizontal blur pass -> blur output
  for (int i = tid; i < TILE * TILE; i += THREADS) {
    int r = i / TILE, c = i % TILE;
    int gy = y0 + r, gx = x0 + c;
    if (gy >= H || gx >= W) continue;
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 7; ++k)
      acc = add16(acc, mul16(taps.w[k], s_bv[r * BV + c + k]));
    blur[frame + (size_t)gy * W + gx] = __float2bfloat16_rn(acc);
  }
  __syncthreads();

  // 4. vertical 7-box of the products onto the Harris rows (bf16)
  for (int i = tid; i < HR * GR; i += THREADS) {
    int h = i / GR, c = i % GR;
    float axx = 0.0f, ayy = 0.0f, axy = 0.0f;
#pragma unroll
    for (int k = 0; k < 7; ++k) {
      int j = (h + k) * GR + c;
      axx = add16(axx, s_pxx[j]);
      ayy = add16(ayy, s_pyy[j]);
      axy = add16(axy, s_pxy[j]);
    }
    s_vxx[i] = axx;
    s_vyy[i] = ayy;
    s_vxy[i] = axy;
  }
  __syncthreads();

  // 5. horizontal 7-box, Harris det - k tr^2 in f32, masked by corner flag
  for (int i = tid; i < HR * HR; i += THREADS) {
    int h = i / HR, w = i % HR;
    float sxx = 0.0f, syy = 0.0f, sxy = 0.0f;
#pragma unroll
    for (int k = 0; k < 7; ++k) {
      int j = h * GR + w + k;
      sxx = add16(sxx, s_vxx[j]);
      syy = add16(syy, s_vyy[j]);
      sxy = add16(sxy, s_vxy[j]);
    }
    float det = __fsub_rn(__fmul_rn(sxx, syy), __fmul_rn(sxy, sxy));
    float tr = __fadd_rn(sxx, syy);
    float harris = __fsub_rn(det, __fmul_rn(__fmul_rn(HARRIS_K, tr), tr));
    s_m[i] = s_c[i] != 0.0f ? harris : NEG;
  }
  __syncthreads();

  // 6. masked 3x3 NMS (center >= max of 8 neighbours) + border mask
  for (int i = tid; i < TILE * TILE; i += THREADS) {
    int r = i / TILE, c = i % TILE;
    int gy = y0 + r, gx = x0 + c;
    if (gy >= H || gx >= W) continue;
    float center = s_m[(r + 1) * HR + c + 1];
    float nmax = NEG;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        if (dy != 1 || dx != 1) nmax = fmaxf(nmax, s_m[(r + dy) * HR + c + dx]);
    bool keep = center >= nmax && mask[(size_t)gy * W + gx] != 0;
    score[frame + (size_t)gy * W + gx] = keep ? center : NEG;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). img/blur: bf16 [B,H,W]; mask:
// int8 [H,W] shared by the batch; score: f32 [B,H,W]; taps: 7 host floats;
// stream: a cudaStream_t. Returns the cudaError_t of the launch.
extern "C" int vxs_fast_harris_blur(const void* img, const void* mask,
                                    void* score, void* blur, int B, int H,
                                    int W, float threshold, const float* taps,
                                    void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fast_harris_blur_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  BlurTaps t;
  for (int k = 0; k < 7; ++k) t.w[k] = taps[k];
  dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, B);
  fast_harris_blur_kernel<<<grid, THREADS, SMEM_BYTES,
                            (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)img, (const int8_t*)mask, (float*)score,
      (__nv_bfloat16*)blur, H, W, threshold, t);
  return (int)cudaGetLastError();
}
