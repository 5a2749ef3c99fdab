// Fused tap-major per-pixel DP convolution + PSF normalisation (Hopper).
//
// Replaces the Pallas TPU kernel sdirt_tpu/render/fused_conv_pallas.py:
// fused_dp_conv_tapmajor (kernel _kernel). From the RAW network PSF,
// tap-major [ks*ks, N, 2, H*W] bf16 (render/mlp_fast.py), and the image
// [N, H, W, C] f32, edge-padded by (ks-1)/2 and rounded to bf16 (img_p), it
// computes
//
//   out_L[y,x,c] = sum_{ty,dx} img_p[y+ks-1-ty, x+dx, c] * netL[ty, ks-1-dx] / sum(netL)
//   out_R[y,x,c] = sum_{ty,dx} img_p[y+ks-1-ty, x+dx, c] * netR[ty, dx]      / sum(netR)
//
// (the right view's stored kx flip and the convolution's kernel flip
// cancel), each view divided by its own tap sum + 1e-9, output [N, H, W, C]
// f32 per view. Products are taken in f32 from the bf16 inputs (exact) and
// summed in f32, ty outer and dx inner, for every pixel.
//
// Bound on an H100 SXM: memory. At the serve shape (N=1, 512x768, C=3,
// ks=21) the PSF alone is 441 * 2 * 393216 * 2 B = 693.6 MB, read once; the
// image and output add ~14 MB. 0.708 GB / 3.35 TB/s = 0.21 ms, against
// ~3.1 GFLOP (far below the compute roof).
//
// Design. The kernel must stream the PSF at HBM rate and do little else.
// One thread per pixel, with a 2-byte PSF load per tap and view and the
// image re-read from L1, reaches only 45% of the bound on the H100, limited
// by load instructions and L1.
//  * One block per output tile of TH = 8 rows x TW = 128 columns of one
//    image; each thread computes VEC = 8 consecutive pixels of one row. For
//    every tap and view it reads their 8 PSF values with one 16-byte load,
//    marked streaming (ld.global.cs: read once, evict first), so a warp
//    moves 512 B per load instruction and the image keeps its place in L2.
//    The loads of SUB = 4 taps are in flight before their products.
//  * The tile's image rows, (TH + ks - 1) x (TW + 8 ceil(ks/8)) x C, go to
//    shared memory once, as bf16. The block reads them from the f32 NHWC
//    image itself, clamping the coordinates for the replicate pad and
//    rounding to bf16 on the way, so no padded copy of the image is made
//    (cp.async or TMA copy bytes as they are; they could neither clamp nor
//    convert). Per tap row a thread takes its window of image values from
//    shared memory in 16-byte chunks, 8 taps at a time, and slides it in
//    registers: 8 taps x 8 pixels x C channels of products need one
//    shared-memory load per channel.
//  * Registers are capped at 168 so that 3 blocks share an SM: with more
//    warps in flight the kernel ran faster on the H100 than with the 255
//    registers ptxas takes uncapped (2 blocks), despite a few spilled
//    values.
//  * A row whose 8 pixels are not all inside the image, or whose PSF
//    address is not 16-byte aligned (H*W or the pixel index not a multiple
//    of 8), takes the same loop with scalar PSF loads and masked stores.
//  * Shared memory is C (TH + ks - 1)(TW + 8 ceil(ks/8)) bf16: 25.5 KB at
//    C = 3, ks 21. The largest ks is the largest odd one that fits the
//    227 KB a block may use (render/fused_conv.py:max_ks: 135 at C = 3,
//    277 at C = 1); a larger one is refused at launch.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (render/fused_conv.py); no PyTorch headers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int VEC = 8;           // pixels per thread, PSF values per 16-byte load
constexpr int TX = 16;           // threads along x
constexpr int TY = 8;            // threads along y, one row each
constexpr int TW = VEC * TX;     // tile width (pixels)
constexpr int TH = TY;           // tile height (rows)
constexpr int SUB = 4;           // taps whose PSF loads are in flight together
constexpr int SMEM_MAX = 232448; // bytes a block may use on sm_90

__host__ __device__ constexpr int groups(int ks) { return (ks + VEC - 1) / VEC; }
__host__ __device__ constexpr int tile_rows(int ks) { return TH + ks - 1; }
__host__ __device__ constexpr int tile_cols(int ks) { return TW + VEC * groups(ks); }

int smem_bytes(int c, int ks) {
  return c * tile_rows(ks) * tile_cols(ks) * (int)sizeof(__nv_bfloat16);
}

__device__ __forceinline__ float lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// 8 bf16 -> 8 f32
__device__ __forceinline__ void unpack(uint4 q, float* f) {
  f[0] = lo(q.x); f[1] = hi(q.x); f[2] = lo(q.y); f[3] = hi(q.y);
  f[4] = lo(q.z); f[5] = hi(q.z); f[6] = lo(q.w); f[7] = hi(q.w);
}

// The VEC PSF values of this thread's pixels at one tap and view: one
// streaming 16-byte load, or (ragged or misaligned rows) scalar loads of the
// pixels inside the image, zero elsewhere
template <bool ALIGNED>
__device__ __forceinline__ void psf_vec(const __nv_bfloat16* p, int nvalid, float* k) {
  if (ALIGNED) {
    unpack(__ldcs(reinterpret_cast<const uint4*>(p)), k);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      k[j] = j < nvalid ? __bfloat162float(__ldcs(p + j)) : 0.f;
  }
}

// R taps dx = dx0 .. dx0 + R - 1 of one tap row, their PSF loads made
// SUB taps at a time. win[c][m] holds image column (this thread's first
// pixel) + dx0 + m, m < 2 VEC.
template <int C, int R, bool ALIGNED>
__device__ __forceinline__ void taps(const __nv_bfloat16* tl, const __nv_bfloat16* tr,
                                     int64_t tap_stride, int dx0, int nvalid,
                                     const float (&win)[C][2 * VEC],
                                     float (&acc_l)[C][VEC], float (&acc_r)[C][VEC],
                                     float (&nl)[VEC], float (&nr)[VEC]) {
#pragma unroll
  for (int r0 = 0; r0 < R; r0 += SUB) {
    float kl[SUB][VEC], kr[SUB][VEC];
#pragma unroll
    for (int q = 0; q < SUB; ++q) {
      if (r0 + q < R) {
        // left tap (ty, ks-1-dx), right tap (ty, dx)
        psf_vec<ALIGNED>(tl - (int64_t)(dx0 + r0 + q) * tap_stride, nvalid, kl[q]);
        psf_vec<ALIGNED>(tr + (int64_t)(dx0 + r0 + q) * tap_stride, nvalid, kr[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < SUB; ++q) {
      if (r0 + q < R) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          nl[j] += kl[q][j];
          nr[j] += kr[q][j];
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const float v = win[c][r0 + q + j];
            acc_l[c][j] = fmaf(v, kl[q][j], acc_l[c][j]);
            acc_r[c][j] = fmaf(v, kr[q][j], acc_r[c][j]);
          }
        }
      }
    }
  }
}

// the last, partial group of a tap row: rest = ks % VEC taps (ks is odd)
template <int C, int R, bool ALIGNED>
__device__ __forceinline__ void tail(int rest, const __nv_bfloat16* tl,
                                     const __nv_bfloat16* tr, int64_t tap_stride,
                                     int dx0, int nvalid, const float (&win)[C][2 * VEC],
                                     float (&acc_l)[C][VEC], float (&acc_r)[C][VEC],
                                     float (&nl)[VEC], float (&nr)[VEC]) {
  if constexpr (R < VEC) {
    if (rest == R)
      taps<C, R, ALIGNED>(tl, tr, tap_stride, dx0, nvalid, win, acc_l, acc_r, nl, nr);
    else
      tail<C, R + 2, ALIGNED>(rest, tl, tr, tap_stride, dx0, nvalid, win, acc_l, acc_r, nl, nr);
  }
}

template <int C, bool ALIGNED>
__device__ __forceinline__ void pixels(const __nv_bfloat16* __restrict__ tile,
                                       const __nv_bfloat16* __restrict__ psf,
                                       float* __restrict__ out_l,
                                       float* __restrict__ out_r, int n_img,
                                       int n, int h, int w, int ks, int y,
                                       int x, int ly, int lx) {
  const int64_t hw = (int64_t)h * w;
  const int64_t p0 = (int64_t)y * w + x;
  const int64_t tap_stride = (int64_t)n_img * 2 * hw;
  const int nvalid = min(VEC, w - x);
  const int rows = tile_rows(ks), cols = tile_cols(ks);
  const __nv_bfloat16* psf_l = psf + (int64_t)n * 2 * hw + p0;   // psf[t, n, 0, p0]
  const __nv_bfloat16* psf_r = psf_l + hw;                       // psf[t, n, 1, p0]

  float acc_l[C][VEC], acc_r[C][VEC], nl[VEC], nr[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    nl[j] = 0.f;
    nr[j] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      acc_l[c][j] = 0.f;
      acc_r[c][j] = 0.f;
    }
  }

  const int full = ks / VEC, rest = ks % VEC;
  for (int ty = 0; ty < ks; ++ty) {
    const __nv_bfloat16* row = tile + (ly + ks - 1 - ty) * cols + lx;
    const __nv_bfloat16* tl = psf_l + (int64_t)(ty * ks + ks - 1) * tap_stride;
    const __nv_bfloat16* tr = psf_r + (int64_t)(ty * ks) * tap_stride;
    float win[C][2 * VEC];
#pragma unroll
    for (int c = 0; c < C; ++c)
      unpack(*reinterpret_cast<const uint4*>(row + c * rows * cols), &win[c][VEC]);
    for (int g = 0; g <= full; ++g) {
      if (g == full && rest == 0) break;
#pragma unroll
      for (int c = 0; c < C; ++c) {
#pragma unroll
        for (int m = 0; m < VEC; ++m) win[c][m] = win[c][VEC + m];
        unpack(*reinterpret_cast<const uint4*>(row + c * rows * cols + VEC * (g + 1)),
               &win[c][VEC]);
      }
      const int dx0 = VEC * g;
      if (g < full) {
        taps<C, VEC, ALIGNED>(tl, tr, tap_stride, dx0, nvalid, win, acc_l, acc_r, nl, nr);
      } else {
        tail<C, 1, ALIGNED>(rest, tl, tr, tap_stride, dx0, nvalid, win, acc_l, acc_r, nl, nr);
      }
    }
  }

  const int64_t o0 = ((int64_t)n * hw + p0) * C;
  if (ALIGNED) {
    float vl[C * VEC], vr[C * VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float inv_l = 1.f / (nl[j] + 1e-9f);
      const float inv_r = 1.f / (nr[j] + 1e-9f);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        vl[j * C + c] = acc_l[c][j] * inv_l;
        vr[j * C + c] = acc_r[c][j] * inv_r;
      }
    }
    float4* dl = reinterpret_cast<float4*>(out_l + o0);
    float4* dr = reinterpret_cast<float4*>(out_r + o0);
#pragma unroll
    for (int q = 0; q < C * VEC / 4; ++q) {
      dl[q] = make_float4(vl[4 * q], vl[4 * q + 1], vl[4 * q + 2], vl[4 * q + 3]);
      dr[q] = make_float4(vr[4 * q], vr[4 * q + 1], vr[4 * q + 2], vr[4 * q + 3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      if (j >= nvalid) break;
      const float inv_l = 1.f / (nl[j] + 1e-9f);
      const float inv_r = 1.f / (nr[j] + 1e-9f);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        out_l[o0 + j * C + c] = acc_l[c][j] * inv_l;
        out_r[o0 + j * C + c] = acc_r[c][j] * inv_r;
      }
    }
  }
}

// at most 168 registers, so that 3 blocks (12 warps) share an SM and keep
// their PSF loads in flight
template <int C>
__global__ void __launch_bounds__(TX * TY, 3)
fused_dp_conv_kernel(const float* __restrict__ img, const __nv_bfloat16* __restrict__ psf,
                     float* __restrict__ out_l, float* __restrict__ out_r,
                     int n_img, int h, int w, int ks) {
  extern __shared__ __align__(16) __nv_bfloat16 tile[];   // [C][rows][cols]
  const int rows = tile_rows(ks), cols = tile_cols(ks), pad = (ks - 1) / 2;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH, n = blockIdx.z;

  // the tile's rows of the edge-padded image, rounded to bf16
  for (int r = threadIdx.y; r < rows; r += TY) {
    const int gy = min(max(y0 + r - pad, 0), h - 1);
    const float* src = img + ((int64_t)n * h + gy) * w * C;
    __nv_bfloat16* dst = tile + r * cols;
#pragma unroll 4
    for (int e = threadIdx.x; e < cols * C; e += TX) {
      const int col = e / C, c = e - col * C;
      const int gx = min(max(x0 + col - pad, 0), w - 1);
      dst[c * rows * cols + col] = __float2bfloat16_rn(src[gx * C + c]);
    }
  }
  __syncthreads();

  const int lx = VEC * threadIdx.x, ly = threadIdx.y;
  const int x = x0 + lx, y = y0 + ly;
  if (y >= h || x >= w) return;
  const bool aligned = ((int64_t)h * w) % VEC == 0 && ((int64_t)y * w + x) % VEC == 0 &&
                       x + VEC <= w && reinterpret_cast<uintptr_t>(psf) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out_l) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out_r) % 16 == 0;
  if (aligned)
    pixels<C, true>(tile, psf, out_l, out_r, n_img, n, h, w, ks, y, x, ly, lx);
  else
    pixels<C, false>(tile, psf, out_l, out_r, n_img, n, h, w, ks, y, x, ly, lx);
}

template <int C>
int launch(const float* img, const __nv_bfloat16* psf, float* out_l, float* out_r,
           int n, int h, int w, int ks, cudaStream_t stream) {
  static int allowed = 48 * 1024;   // dynamic shared memory granted so far
  const int smem = smem_bytes(C, ks);
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_dp_conv_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    allowed = smem;
  }
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, n);
  fused_dp_conv_kernel<C><<<grid, dim3(TX, TY), smem, stream>>>(
      img, psf, out_l, out_r, n, h, w, ks);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory a launch takes, in bytes; the limit a block may use.
extern "C" int fused_dp_conv_smem_bytes(int c, int ks) { return smem_bytes(c, ks); }
extern "C" int fused_dp_conv_smem_limit() { return SMEM_MAX; }

// Launches on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a channel count, ks or size the kernel does not
// take (ks even, or its tile larger than a block's shared memory).
extern "C" int fused_dp_conv_tapmajor(const void* img, const void* psf,
                                      void* out_l, void* out_r, int n, int h,
                                      int w, int c, int ks, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || ks <= 0 || (ks & 1) == 0 || n > 65535 ||
      (c != 1 && c != 3) || smem_bytes(c, ks) > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  const float* im = static_cast<const float*>(img);
  const __nv_bfloat16* p = static_cast<const __nv_bfloat16*>(psf);
  float* ol = static_cast<float*>(out_l);
  float* orr = static_cast<float*>(out_r);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return c == 1 ? launch<1>(im, p, ol, orr, n, h, w, ks, s)
                : launch<3>(im, p, ol, orr, n, h, w, ks, s);
}
