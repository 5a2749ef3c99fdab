// Fused tap-major per-pixel DP convolution + PSF normalisation (Hopper).
//
// Replaces the Pallas TPU kernel sdirt_tpu/render/fused_conv_pallas.py:
// fused_dp_conv_tapmajor (kernel _kernel). From the RAW network PSF,
// tap-major [ks*ks, N, 2, H*W] bf16 (render/mlp_fast.py), and the
// edge-padded image [N, C, H+ks-1, W+ks-1] bf16, it computes
//
//   out_L[y,x,c] = sum_{ty,dx} img[y+ks-1-ty, x+dx, c] * netL[ty, ks-1-dx] / sum(netL)
//   out_R[y,x,c] = sum_{ty,dx} img[y+ks-1-ty, x+dx, c] * netR[ty, dx]      / sum(netR)
//
// (the right view's stored kx flip and the convolution's kernel flip
// cancel), each view divided by its own tap sum + 1e-9, output [N, H, W, C]
// f32 per view. Products are taken in f32 from the bf16 inputs (exact) and
// summed in f32.
//
// Bound on an H100 SXM: memory. At the serve shape (N=1, 512x768, C=3,
// ks=21) the PSF alone is 441 * 2 * 393216 * 2 B = 693.6 MB, read once; the
// image and output add ~12 MB. 0.706 GB / 3.35 TB/s = 0.21 ms, against
// ~2.4 GFLOP (far below the compute roof).
//
// Design (first version: simple and right). One thread computes one output
// pixel (n, y, x) for both views and all C channels; it walks the ks*ks taps
// with the f32 accumulators in registers. For a fixed tap, neighbouring
// threads hold neighbouring x, so the PSF read -- the kernel's whole cost --
// is coalesced, and each tap plane is read exactly once. Image rows are
// re-read by ks*ks threads and come from L1/L2. The ragged edge of the grid
// is masked. Shared-memory halo tiles, TMA and vectorised loads are later
// work.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (render/fused_conv.py); no PyTorch headers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int C>
__global__ void __launch_bounds__(256)
fused_dp_conv_kernel(const __nv_bfloat16* __restrict__ img_p,
                     const __nv_bfloat16* __restrict__ psf,
                     float* __restrict__ out_l, float* __restrict__ out_r,
                     int n_img, int h, int w, int ks) {
  const int64_t hw = (int64_t)h * w;
  const int64_t pix = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= (int64_t)n_img * hw) return;
  const int n = (int)(pix / hw);
  const int64_t p = pix - (int64_t)n * hw;
  const int y = (int)(p / w);
  const int x = (int)(p - (int64_t)y * w);
  const int64_t hp = h + ks - 1, wp = w + ks - 1;
  const int64_t plane = hp * wp;
  const int64_t tap_stride = (int64_t)n_img * 2 * hw;

  // psf[t, n, v, p]: view 0 (left) and view 1 (right) of this pixel
  const __nv_bfloat16* psf_l = psf + (int64_t)n * 2 * hw + p;
  const __nv_bfloat16* psf_r = psf_l + hw;
  const __nv_bfloat16* img_n = img_p + (int64_t)n * C * plane;

  float acc_l[C], acc_r[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    acc_l[c] = 0.f;
    acc_r[c] = 0.f;
  }
  float norm_l = 0.f, norm_r = 0.f;

  for (int ty = 0; ty < ks; ++ty) {
    const __nv_bfloat16* img_row = img_n + (int64_t)(y + ks - 1 - ty) * wp + x;
    // left tap (ty, ks-1-dx) and right tap (ty, dx) at dx = 0
    const __nv_bfloat16* tap_l = psf_l + (int64_t)(ty * ks + ks - 1) * tap_stride;
    const __nv_bfloat16* tap_r = psf_r + (int64_t)(ty * ks) * tap_stride;
#pragma unroll 3
    for (int dx = 0; dx < ks; ++dx) {
      const float kl = __bfloat162float(tap_l[-(int64_t)dx * tap_stride]);
      const float kr = __bfloat162float(tap_r[(int64_t)dx * tap_stride]);
      norm_l += kl;
      norm_r += kr;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float v = __bfloat162float(img_row[c * plane + dx]);
        acc_l[c] = fmaf(v, kl, acc_l[c]);
        acc_r[c] = fmaf(v, kr, acc_r[c]);
      }
    }
  }

  const float inv_l = 1.f / (norm_l + 1e-9f);
  const float inv_r = 1.f / (norm_r + 1e-9f);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    out_l[pix * C + c] = acc_l[c] * inv_l;
    out_r[pix * C + c] = acc_r[c] * inv_r;
  }
}

template <int C>
void launch(const void* img_p, const void* psf, void* out_l, void* out_r,
            int n, int h, int w, int ks, cudaStream_t stream) {
  const int threads = 256;
  const int64_t total = (int64_t)n * h * w;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  fused_dp_conv_kernel<C><<<blocks, threads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(img_p),
      static_cast<const __nv_bfloat16*>(psf), static_cast<float*>(out_l),
      static_cast<float*>(out_r), n, h, w, ks);
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a channel count or size the kernel does not take.
extern "C" int fused_dp_conv_tapmajor(const void* img_p, const void* psf,
                                      void* out_l, void* out_r, int n, int h,
                                      int w, int c, int ks, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || ks <= 0 || (ks & 1) == 0)
    return (int)cudaErrorInvalidValue;
  if ((int64_t)n * h * w > (int64_t)0x7fffffff * 256)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 1: launch<1>(img_p, psf, out_l, out_r, n, h, w, ks, s); break;
    case 3: launch<3>(img_p, psf, out_l, out_r, n, h, w, ks, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
