// Mirror-boundary affine warp of a batch of float32 images, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel deepfluoro_tpu/ops/pallas/warp.py::_warp_kernel
// (warp.py:59, launched by affine_warp_pallas through pl.pallas_call at
// warp.py:367). The plain PyTorch version of the same function is
// deepfluoro_tpu_torch/ops/image.py::affine_warp; the wrapper that builds,
// binds and launches this file is deepfluoro_tpu_torch/ops/warp.py.
//
// What it computes: for output pixel (r, c) of sample b,
//   x = (c + 0.5) + ox,  y = (r + 0.5) + oy
//   in_x = m0*x + m1*y + m2 - 0.5,  in_y = m3*x + m4*y + m5 - 0.5
// (PIL's half-pixel convention), then order 1 interpolates bilinearly and
// order 0 takes floor(in + 0.5). Every tap index is mirrored in closed form,
//   s = n - 1;  i -> |((i + s) mod 2s) - s|   (a non-negative mod),
// which is map_coordinates(mode='mirror') for ANY matrix. The TPU kernel
// needed a reflect-padded apron, a row band, a one-hot MXU matmul and an
// envelope guard with an XLA fallback; all of that existed for VMEM and the
// MXU and is gone here.
//
// What bounds it on this card: the training step at 8x warps a (5, 180, 180)
// projection into a (5, 192, 192) frame and a (5, 180, 180) label map into
// (5, 180, 180): about 2.7 MB of reads and writes, under 1 us at 3.35 TB/s,
// and some twenty float operations per output pixel. Each launch is
// therefore bound by launch latency, not by bytes or operations, so the
// design is the simplest one: one thread per output pixel, a 2-D grid over
// (pixels, batch), gathers straight from device memory (the image stays in
// L2). The coordinate and weight arithmetic uses round-to-nearest
// intrinsics so that no multiply-add is contracted: the kernel then repeats
// the plain version's float operations one for one.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int mirror_index(long long i, int n) {
    if (n == 1) return 0;
    const long long s = n - 1;
    const long long p = 2 * s;
    long long r = (i + s) % p;  // C++ remainder keeps the dividend's sign
    if (r < 0) r += p;
    r -= s;
    return (int)(r < 0 ? -r : r);
}

__global__ void affine_warp_kernel(const float* __restrict__ img,
                                   const float* __restrict__ mat,
                                   float* __restrict__ out,
                                   int H, int W, int OH, int OW,
                                   float ox, float oy, int order) {
    const int b = blockIdx.y;
    const long long pix = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long npix = (long long)OH * OW;
    if (pix >= npix) return;
    const int r = (int)(pix / OW);
    const int c = (int)(pix - (long long)r * OW);

    const float* m = mat + 6 * (long long)b;
    const float x = __fadd_rn(__fadd_rn((float)c, 0.5f), ox);
    const float y = __fadd_rn(__fadd_rn((float)r, 0.5f), oy);
    const float in_x = __fsub_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(m[0], x), __fmul_rn(m[1], y)), m[2]), 0.5f);
    const float in_y = __fsub_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(m[3], x), __fmul_rn(m[4], y)), m[5]), 0.5f);

    const float* src = img + (long long)b * H * W;
    float v;
    if (order == 0) {
        const long long iy = (long long)floorf(__fadd_rn(in_y, 0.5f));
        const long long ix = (long long)floorf(__fadd_rn(in_x, 0.5f));
        v = __ldg(src + (long long)mirror_index(iy, H) * W + mirror_index(ix, W));
    } else {
        const float fy = floorf(in_y);
        const float fx = floorf(in_x);
        const float wy1 = __fsub_rn(in_y, fy);
        const float wx1 = __fsub_rn(in_x, fx);
        const float wy0 = __fsub_rn(1.0f, wy1);
        const float wx0 = __fsub_rn(1.0f, wx1);
        const long long y0 = (long long)fy;
        const long long x0 = (long long)fx;
        const long long ry0 = (long long)mirror_index(y0, H) * W;
        const long long ry1 = (long long)mirror_index(y0 + 1, H) * W;
        const int rx0 = mirror_index(x0, W);
        const int rx1 = mirror_index(x0 + 1, W);
        // the plain version's product and sum order
        v = __fmul_rn(__fmul_rn(wy0, wx0), __ldg(src + ry0 + rx0));
        v = __fadd_rn(v, __fmul_rn(__fmul_rn(wy0, wx1), __ldg(src + ry0 + rx1)));
        v = __fadd_rn(v, __fmul_rn(__fmul_rn(wy1, wx0), __ldg(src + ry1 + rx0)));
        v = __fadd_rn(v, __fmul_rn(__fmul_rn(wy1, wx1), __ldg(src + ry1 + rx1)));
    }
    out[(long long)b * npix + pix] = v;
}

}  // namespace

// img (B, H, W), mat (B, 6) and out (B, OH, OW) are contiguous float32 on the
// current device. Returns cudaGetLastError() after the launch.
extern "C" int affine_warp_launch(const float* img, const float* mat, float* out,
                                  int B, int H, int W, int OH, int OW,
                                  float ox, float oy, int order,
                                  cudaStream_t stream) {
    const long long npix = (long long)OH * OW;
    if (B <= 0 || npix <= 0) return (int)cudaSuccess;
    const int threads = 256;
    const dim3 grid((unsigned)((npix + threads - 1) / threads), (unsigned)B);
    affine_warp_kernel<<<grid, threads, 0, stream>>>(img, mat, out, H, W, OH, OW, ox, oy, order);
    return (int)cudaGetLastError();
}
