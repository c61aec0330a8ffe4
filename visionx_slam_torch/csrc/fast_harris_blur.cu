// Fused FAST-9/16 + Harris + masked 3x3 NMS + border mask + 7-tap Gaussian
// blur over a batch of bf16 pyramid atlases (K1), and its score-only form
// over a float32 image (K1b), for Hopper (sm_90a).
//
// Replaces the TPU kernel visionx_slam_tpu/ops/pallas_detect.py::
// fast_harris_blur (K1, :167) and its wrapper fast_harris_score (K1b, :213),
// and computes the same function bit for bit as the plain versions in
// ops/detect.py:
//
//   score f32 [B,H,W]: Harris response where (FAST-9 corner at threshold t)
//                      & (inside the border mask) & (3x3 NMS winner, ties
//                      survive), else NEG = -3e38;
//   blur  bf16 [B,H,W]: separable 7-tap Gaussian (sigma 2), vertical first.
//
// Out-of-image taps read the nearest edge pixel (clamped coordinates): the
// edge padding the TPU kernel applies before its row tiles.
//
// Rounding. The Sobel taps, gradient products, 7x7 box sums and blur taps
// round to bf16 after every multiply and add, in the plain version's order
// (each sum starts from its first term and adds the rest in tap order). They
// run as native bf16x2 arithmetic (add/sub/mul.rn.bf16x2 through __hadd2_rn,
// __hsub2_rn, __hmul2_rn: the _rn forms are never contracted into an fma),
// which equals an f32 op rounded to bf16: f32 carries 24 >= 2*8+2 significand
// bits, so rounding its correctly rounded result again to bf16 gives the
// once-rounded value. det, trace and the Harris response run in f32 with _rn
// intrinsics. FAST compares each bf16 tap with center +- t in f32; since a
// tap is a bf16 value, tap > hi exactly when tap > (hi rounded down to bf16)
// and tap < lo exactly when tap < (lo rounded up), so the compares run as
// bf16x2 set.gt/set.lt against thresholds rounded by bit masks.
//
// Design. Each warp owns a strip of 128 input columns (4 per lane, two bf16x2
// pairs) and walks down a band of kRows output rows, reading one input row
// per step (clamped, one row ahead of its use). The vertical passes (Sobel 3
// rows, box 7, blur 7, FAST 7, NMS 3) keep their windows in registers; the
// horizontal passes take neighbouring columns from the adjacent lanes by
// warp shuffles. Nothing goes through shared memory and no block barrier
// runs. A strip's outputs are its middle 112 columns (lanes 2..29): every
// output's 5-pixel halo lies inside the strip. The step loop is unrolled by 7
// so that the 7-row windows rotate by renaming, not by moves. kRows = 46 puts
// the [8,1896,640] chunk in one wave at 4 blocks of 4 warps per SM (128
// registers a thread).
//
// Bytes and bound on the H100 (3.35 TB/s): K1 reads 2 B of image per pixel
// and 1 B of mask per pixel of one frame, and writes 4 B of score and 2 B of
// blur: 78.9 MB for an [8,1896,640] chunk, 23.5 us. K1b reads 4 B and writes
// 4 B per pixel: 77.7 MB, 23.2 us. Their arithmetic (125 and 99 operations a
// pixel) at the float32 rate would take less. What bounds the kernel is
// instruction issue, not memory: it moves ~0.5 TB/s. Per step a lane runs
// ~700 SASS instructions for its 4 pixels (~1.4x that per output pixel with
// the recomputed halo), and the time follows that count: a FAST test in
// bf16 arithmetic in place of the integer bit masks changed it by a few
// percent either way. 16-byte loads and stores measured slower than the
// clamped 2-byte ones, and a tighter register cap (more warps) spilled and
// ran slower. Times and shares: PERF.md.
//
// Tensor cores and sliding-window running sums do not apply: every add of
// the box and blur sums must round to bf16 in tap order, and neither a wgmma
// (which accumulates in f32) nor a running sum (which subtracts the leaving
// tap) gives those roundings.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat162 bf2;

constexpr int kWarps = 4;        // independent warps per block
constexpr int kOut = 112;        // output columns of a strip (lanes 2..29)
constexpr int kLeft = 8;         // input columns left of a strip's outputs
constexpr int kRows = 46;        // output rows of a band; (kRows + 10) % 7 == 0
constexpr int kSteps = (kRows + 10 + 6) / 7 * 7;  // input rows walked per band
constexpr float NEG = -3.0e38f;
constexpr float HARRIS_K = 0.04f;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned TWO = 0x40004000u;      // bf16x2 (2, 2)
constexpr unsigned QUARTER = 0x3E803E80u;  // bf16x2 (0.25, 0.25)

struct Taps {
  unsigned w[7];  // Gaussian taps as bf16x2 (the tap in both halves)
};

__device__ __forceinline__ unsigned bits(bf2 v) {
  return *reinterpret_cast<unsigned*>(&v);
}
__device__ __forceinline__ bf2 pair(unsigned x) {
  return *reinterpret_cast<bf2*>(&x);
}
__device__ __forceinline__ unsigned add(unsigned a, unsigned b) {
  return bits(__hadd2_rn(pair(a), pair(b)));
}
__device__ __forceinline__ unsigned sub(unsigned a, unsigned b) {
  return bits(__hsub2_rn(pair(a), pair(b)));
}
__device__ __forceinline__ unsigned mul(unsigned a, unsigned b) {
  return bits(__hmul2_rn(pair(a), pair(b)));
}
// (a.hi, b.lo): the pair one column right of a
__device__ __forceinline__ unsigned mid(unsigned a, unsigned b) {
  return __byte_perm(a, b, 0x5432);
}
__device__ __forceinline__ unsigned up(unsigned v) {
  return __shfl_up_sync(FULL, v, 1);
}
__device__ __forceinline__ unsigned down(unsigned v) {
  return __shfl_down_sync(FULL, v, 1);
}
__device__ __forceinline__ float lo_f(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_f(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

// f32 bits of x rounded to bf16 toward -inf / +inf (x finite)
__device__ __forceinline__ unsigned round_down16(float x) {
  unsigned b = __float_as_uint(x), t = b & 0xffff0000u;
  return ((b >> 31) && (b & 0xffffu)) ? t + 0x10000u : t;
}
__device__ __forceinline__ unsigned round_up16(float x) {
  unsigned b = __float_as_uint(x), t = b & 0xffff0000u;
  return (!(b >> 31) && (b & 0xffffu)) ? t + 0x10000u : t;
}

// a cyclic run of >= 9 set bits in the 16-bit half of m picked by sel
// (0x1010 low half, 0x3232 high half): duplicate to 32 bits, shift-AND
__device__ __forceinline__ unsigned run9(unsigned m, unsigned sel) {
  unsigned x = __byte_perm(m, 0, sel);
  unsigned r = x & (x >> 1);
  r = r & (r >> 2);
  r = r & (r >> 4);
  r = r & (x >> 8);
  return r & 0xffffu;
}

// horizontal 7-tap sums of the two pairs (a, b) of a lane, from the words of
// the lanes on either side (l = left lane's (a, b), r = right lane's):
// out_a = sum_k T(k)(c-3+k), out_b = sum_k T(k)(c-1+k), in tap order
struct Row7 {
  unsigned x[9];  // pairs starting at columns c-3, c-2, ..., c+5
};
__device__ __forceinline__ Row7 row7(unsigned a, unsigned b) {
  unsigned la = up(a), lb = up(b), ra = down(a), rb = down(b);
  Row7 t;
  t.x[0] = mid(la, lb);
  t.x[1] = lb;
  t.x[2] = mid(lb, a);
  t.x[3] = a;
  t.x[4] = mid(a, b);
  t.x[5] = b;
  t.x[6] = mid(b, ra);
  t.x[7] = ra;
  t.x[8] = mid(ra, rb);
  return t;
}

template <bool kScoreOnly>
__global__ void __launch_bounds__(kWarps * 32, 4)
fast_harris_kernel(const void* __restrict__ img, const int8_t* __restrict__ mask,
                   float* __restrict__ score, __nv_bfloat16* __restrict__ blur,
                   int H, int W, int strips, int bands, float threshold,
                   Taps taps) {
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (item >= strips * bands) return;  // the whole warp leaves
  const int x0 = (item % strips) * kOut;
  const int y0 = (item / strips) * kRows;
  const int y_end = min(y0 + kRows, H);
  const int c = x0 - kLeft + 4 * lane;  // this lane's first column
  const size_t frame = (size_t)blockIdx.y * H * W;
  const bool out_lane = lane >= 2 && lane < 30 && c < W;
  int gx[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) gx[j] = min(max(c + j, 0), W - 1);

  // row r of the image (clamped) as two bf16x2 pairs
  auto load = [&](int r, unsigned& a, unsigned& b) {
    const size_t base = frame + (size_t)min(max(r, 0), H - 1) * W;
    if constexpr (kScoreOnly) {
      const float* im = static_cast<const float*>(img) + base;
      a = bits(__floats2bfloat162_rn(im[gx[0]], im[gx[1]]));
      b = bits(__floats2bfloat162_rn(im[gx[2]], im[gx[3]]));
    } else {
      const unsigned short* im = static_cast<const unsigned short*>(img) + base;
      a = im[gx[0]] | ((unsigned)im[gx[1]] << 16);
      b = im[gx[2]] | ((unsigned)im[gx[3]] << 16);
    }
  };

  // windows, slot = input row mod 7 (rows r-6..r)
  unsigned in_a[7], in_b[7];    // this lane's pairs of the input rows
  unsigned nl[7], nr[7];        // left lane's b pair, right lane's a pair
  unsigned pxx_a[7], pxx_b[7], pyy_a[7], pyy_b[7], pxy_a[7], pxy_b[7];
  float m5[4], m6[4];           // masked Harris of rows r-5 and r-6
  unsigned corner = 0;          // FAST flags (bit j) of row r-4
#pragma unroll
  for (int k = 0; k < 7; ++k) {
    in_a[k] = in_b[k] = nl[k] = nr[k] = 0;
    pxx_a[k] = pxx_b[k] = pyy_a[k] = pyy_b[k] = pxy_a[k] = pxy_b[k] = 0;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) m5[j] = m6[j] = NEG;

  const float thr = threshold;
  unsigned next_a, next_b;
  load(y0 - 5, next_a, next_b);

  for (int i0 = 0; i0 < kSteps; i0 += 7) {
#pragma unroll
    for (int p = 0; p < 7; ++p) {
      // S(k): the slot of input row r-k
#define S(k) ((p + 7 - (k)) % 7)
      const int r = y0 - 5 + i0 + p;  // the newest input row
      in_a[p] = next_a;
      in_b[p] = next_b;
      load(r + 1, next_a, next_b);
      nl[p] = up(in_b[p]);
      nr[p] = down(in_a[p]);

      // ---- Sobel rows at r-1, gradients (x0.25) and products ----
      {
        unsigned rs_a = add(add(mul(in_a[S(1)], TWO), in_a[S(2)]), in_a[S(0)]);
        unsigned rs_b = add(add(mul(in_b[S(1)], TWO), in_b[S(2)]), in_b[S(0)]);
        unsigned rd_a = sub(in_a[S(0)], in_a[S(2)]);
        unsigned rd_b = sub(in_b[S(0)], in_b[S(2)]);
        unsigned s_m = mid(rs_a, rs_b), s_l = mid(up(rs_b), rs_a),
                 s_r = mid(rs_b, down(rs_a));
        unsigned d_m = mid(rd_a, rd_b), d_l = mid(up(rd_b), rd_a),
                 d_r = mid(rd_b, down(rd_a));
        unsigned dx_a = mul(sub(s_m, s_l), QUARTER);
        unsigned dx_b = mul(sub(s_r, s_m), QUARTER);
        unsigned dy_a = mul(add(add(d_l, mul(TWO, rd_a)), d_m), QUARTER);
        unsigned dy_b = mul(add(add(d_m, mul(TWO, rd_b)), d_r), QUARTER);
        pxx_a[p] = mul(dx_a, dx_a);
        pxx_b[p] = mul(dx_b, dx_b);
        pyy_a[p] = mul(dy_a, dy_a);
        pyy_b[p] = mul(dy_b, dy_b);
        pxy_a[p] = mul(dx_a, dy_a);
        pxy_b[p] = mul(dx_b, dy_b);
      }

      // ---- 7x7 box sums at row r-4 (products of rows r-7..r-1) ----
      float m4[4];
      {
        unsigned v[6];
        v[0] = pxx_a[S(6)]; v[1] = pxx_b[S(6)];
        v[2] = pyy_a[S(6)]; v[3] = pyy_b[S(6)];
        v[4] = pxy_a[S(6)]; v[5] = pxy_b[S(6)];
#pragma unroll
        for (int k = 5; k >= 0; --k) {
          v[0] = add(v[0], pxx_a[S(k)]); v[1] = add(v[1], pxx_b[S(k)]);
          v[2] = add(v[2], pyy_a[S(k)]); v[3] = add(v[3], pyy_b[S(k)]);
          v[4] = add(v[4], pxy_a[S(k)]); v[5] = add(v[5], pxy_b[S(k)]);
        }
        unsigned h[6];
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          Row7 t = row7(v[2 * q], v[2 * q + 1]);
          unsigned sa = t.x[0], sb = t.x[2];
#pragma unroll
          for (int k = 1; k < 7; ++k) {
            sa = add(sa, t.x[k]);
            sb = add(sb, t.x[k + 2]);
          }
          h[2 * q] = sa;
          h[2 * q + 1] = sb;
        }
        // Harris det - k tr^2 in f32, masked by the FAST flag
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const unsigned wxx = h[j >> 1], wyy = h[2 + (j >> 1)], wxy = h[4 + (j >> 1)];
          const float sxx = (j & 1) ? hi_f(wxx) : lo_f(wxx);
          const float syy = (j & 1) ? hi_f(wyy) : lo_f(wyy);
          const float sxy = (j & 1) ? hi_f(wxy) : lo_f(wxy);
          const float det = __fsub_rn(__fmul_rn(sxx, syy), __fmul_rn(sxy, sxy));
          const float tr = __fadd_rn(sxx, syy);
          const float harris = __fsub_rn(det, __fmul_rn(__fmul_rn(HARRIS_K, tr), tr));
          m4[j] = ((corner >> j) & 1u) ? harris : NEG;
        }
      }

      // ---- 3x3 NMS (ties survive) and border mask at row r-5 ----
      {
        float cm[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          cm[j] = fmaxf(fmaxf(fmaxf(NEG, m6[j]), m5[j]), m4[j]);
        const float cl = __shfl_up_sync(FULL, cm[3], 1);
        const float cr = __shfl_down_sync(FULL, cm[0], 1);
        const int y = r - 5;
        if (out_lane && y >= y0 && y < y_end) {
          const size_t row = (size_t)y * W + c;
          float o[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float nb = fmaxf(fmaxf(j ? cm[j - 1] : cl, cm[j]),
                                   j < 3 ? cm[j + 1] : cr);
            const bool keep = m5[j] >= nb &&
                              (kScoreOnly || (c + j < W && mask[row + j] != 0));
            o[j] = keep ? m5[j] : NEG;
          }
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (c + j < W) score[frame + row + j] = o[j];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          m6[j] = m5[j];
          m5[j] = m4[j];
        }
      }

      // ---- FAST-9 at row r-3 (input rows r-6..r) ----
      {
        const unsigned ca = in_a[S(3)], cb = in_b[S(3)];
        unsigned hb[4], lb[4];
        const float cen[4] = {lo_f(ca), hi_f(ca), lo_f(cb), hi_f(cb)};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          hb[j] = round_down16(__fadd_rn(cen[j], thr));
          lb[j] = round_up16(__fsub_rn(cen[j], thr));
        }
        const bf2 hi_a = pair(__byte_perm(hb[0], hb[1], 0x7632));
        const bf2 hi_b = pair(__byte_perm(hb[2], hb[3], 0x7632));
        const bf2 lo_a = pair(__byte_perm(lb[0], lb[1], 0x7632));
        const bf2 lo_b = pair(__byte_perm(lb[2], lb[3], 0x7632));
        // left lane's a pair and right lane's b pair of rows r-4..r-2
        unsigned l0[3], r1[3];
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          l0[d] = up(in_a[S(4 - d)]);
          r1[d] = down(in_b[S(4 - d)]);
        }
        // circle taps (dy, dx), radius 3, clockwise from 12 o'clock
        const int kDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
        const int kDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
        unsigned bright_a = 0, dark_a = 0, bright_b = 0, dark_b = 0;
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          const int sl = S(3 - kDy[k]);
          const unsigned wa = in_a[sl], wb = in_b[sl], L1 = nl[sl], R0 = nr[sl];
          const unsigned L0 = (kDy[k] >= -1 && kDy[k] <= 1) ? l0[kDy[k] + 1] : 0;
          const unsigned R1 = (kDy[k] >= -1 && kDy[k] <= 1) ? r1[kDy[k] + 1] : 0;
          unsigned ta, tb;
          switch (kDx[k]) {
            case -3: ta = mid(L0, L1); tb = mid(L1, wa); break;
            case -2: ta = L1; tb = wa; break;
            case -1: ta = mid(L1, wa); tb = mid(wa, wb); break;
            case 0: ta = wa; tb = wb; break;
            case 1: ta = mid(wa, wb); tb = mid(wb, R0); break;
            case 2: ta = wb; tb = R0; break;
            default: ta = mid(wb, R0); tb = mid(R0, R1); break;
          }
          const unsigned bit = 0x10001u << k;
          bright_a |= __hgt2_mask(pair(ta), hi_a) & bit;
          dark_a |= __hlt2_mask(pair(ta), lo_a) & bit;
          bright_b |= __hgt2_mask(pair(tb), hi_b) & bit;
          dark_b |= __hlt2_mask(pair(tb), lo_b) & bit;
        }
        corner = ((run9(bright_a, 0x1010) | run9(dark_a, 0x1010)) ? 1u : 0u) |
                 ((run9(bright_a, 0x3232) | run9(dark_a, 0x3232)) ? 2u : 0u) |
                 ((run9(bright_b, 0x1010) | run9(dark_b, 0x1010)) ? 4u : 0u) |
                 ((run9(bright_b, 0x3232) | run9(dark_b, 0x3232)) ? 8u : 0u);
      }

      // ---- blur at row r-3: vertical over rows r-6..r, then horizontal ----
      if constexpr (!kScoreOnly) {
        unsigned va = mul(taps.w[0], in_a[S(6)]), vb = mul(taps.w[0], in_b[S(6)]);
#pragma unroll
        for (int k = 1; k < 7; ++k) {
          va = add(va, mul(taps.w[k], in_a[S(6 - k)]));
          vb = add(vb, mul(taps.w[k], in_b[S(6 - k)]));
        }
        Row7 t = row7(va, vb);
        unsigned oa = mul(taps.w[0], t.x[0]), ob = mul(taps.w[0], t.x[2]);
#pragma unroll
        for (int k = 1; k < 7; ++k) {
          oa = add(oa, mul(taps.w[k], t.x[k]));
          ob = add(ob, mul(taps.w[k], t.x[k + 2]));
        }
        const int y = r - 3;
        if (out_lane && y >= y0 && y < y_end) {
          unsigned short* dst = reinterpret_cast<unsigned short*>(blur) + frame +
                                (size_t)y * W + c;
          const unsigned short o[4] = {(unsigned short)oa, (unsigned short)(oa >> 16),
                                       (unsigned short)ob, (unsigned short)(ob >> 16)};
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (c + j < W) dst[j] = o[j];
        }
      }
#undef S
    }
  }
}

template <bool kScoreOnly>
int launch(const void* img, const void* mask, void* score, void* blur, int B,
           int H, int W, float threshold, const Taps& taps, void* stream) {
  const int strips = (W + kOut - 1) / kOut;
  const int bands = (H + kRows - 1) / kRows;
  dim3 grid((strips * bands + kWarps - 1) / kWarps, B);
  fast_harris_kernel<kScoreOnly><<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      img, (const int8_t*)mask, (float*)score, (__nv_bfloat16*)blur, H, W,
      strips, bands, threshold, taps);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes); each returns the cudaError_t of
// its launch on `stream` (a cudaStream_t).
//
// K1: img/blur bf16 [B,H,W]; mask int8 [H,W] shared by the batch; score f32
// [B,H,W]; taps: the 7 Gaussian taps (host floats, already bf16 values).
extern "C" int vxs_fast_harris_blur(const void* img, const void* mask,
                                    void* score, void* blur, int B, int H,
                                    int W, float threshold, const float* taps,
                                    void* stream) {
  Taps t;
  for (int k = 0; k < 7; ++k) {
    const unsigned short h = __bfloat16_as_ushort(__float2bfloat16_rn(taps[k]));
    t.w[k] = h | ((unsigned)h << 16);
  }
  return launch<false>(img, mask, score, blur, B, H, W, threshold, t, stream);
}

// K1b: img f32 [B,H,W] (rounded to bf16 as it is read); score f32 [B,H,W];
// no mask (all ones), no blur.
extern "C" int vxs_fast_harris_score(const void* img, void* score, int B,
                                     int H, int W, float threshold,
                                     void* stream) {
  return launch<true>(img, nullptr, score, nullptr, B, H, W, threshold, Taps{},
                      stream);
}
