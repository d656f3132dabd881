// Mirror-boundary affine warp of float32 image batches, for Hopper (sm_90a).
//
// Replaces the TPU kernel deepfluoro_tpu/ops/pallas/warp.py::_warp_kernel
// (warp.py:59, launched by affine_warp_pallas through pl.pallas_call at
// warp.py:367). The plain PyTorch version of the same function is
// deepfluoro_tpu_torch/ops/image.py::affine_warp; the wrapper that builds,
// binds and launches this file is deepfluoro_tpu_torch/ops/warp.py, whose
// tile_windows is a copy of this file's window rule in Python.
//
// What it computes: for output pixel (r, c) of sample b,
//   x = (c + 0.5) + ox,  y = (r + 0.5) + oy
//   in_x = m0*x + m1*y + m2 - 0.5,  in_y = m3*x + m4*y + m5 - 0.5
// (PIL's half-pixel convention), then order 1 interpolates bilinearly and
// order 0 takes floor(in + 0.5). Every tap index i of an axis of length n is
// mirrored, s = n - 1:  i -> |((i + s) mod 2s) - s|  (a non-negative mod),
// which is map_coordinates(mode='mirror') for ANY matrix. The coordinate and
// weight arithmetic uses round-to-nearest intrinsics, so nvcc contracts no
// multiply-add and the kernel repeats the plain version's float operations
// one for one: it is bit-equal to it.
//
// One launch warps up to two tasks that share the per-sample matrices: the
// augmentation's projection (bilinear, into the padded frame at an offset)
// and its label map (nearest, into its own frame). blockIdx.x walks the
// output tiles of task 0, then those of task 1; blockIdx.y is the sample.
//
// What bounds it on this card: bytes. A training step's pair reads the
// projection and the labels once and writes both outputs once: 2.7 MB at 8x
// (5 x 180^2 -> 192^2), 41.8 MB at 2x (5 x 718^2 -> 736^2) and 66.1 MB at 1x
// (2 x 1436^2 -> 1440^2), 0.8, 12.5 and 19.7 us at 3.35 TB/s; some twenty
// float operations per output pixel are 1 us or less at 67 TFLOP/s. At 8x
// one launch's latency exceeds the bound, so the pair is one launch, not
// two. At 2x and 1x the design keeps the memory system busy with few
// instructions per byte:
//   * each block owns a 64 x 32 output tile; each thread writes 4
//     consecutive pixels of a row with one 16-byte store where the row's
//     alignment allows (a scalar tail otherwise: 179 and 718 are not
//     multiples of 4);
//   * the block bounds its tile's preimage from the four corner pixels,
//     with one tap of margin for rounding (valid while every coordinate
//     term stays under 2^20), and when that window fits 24 KB it stages
//     the window in shared memory with cp.async, applying the mirror while
//     it stages; the sampling loop then reads shared memory with no
//     boundary logic. A tile whose window does not fit (a zoom-out past the
//     budget, a far or huge matrix) samples from global memory with the
//     mirror index, in the same kernel, exact for any matrix;
//   * index arithmetic is 32-bit: a tap inside [0, n) takes no mirror
//     arithmetic, only one outside it takes the closed form (a rare branch),
//     and a coordinate beyond 2^30 takes it in 64 bits.
// No TMA: a tensor map cannot address a mirror, and encoding one on the host
// per call would add host time where the 8x step is already bound by host
// dispatch. No tensor cores: there is no matrix product here; the Pallas
// kernel's one-hot MXU matmul (warp.py:16-19) stood in for the TPU's lane
// gathers, which a CUDA thread does with an ordinary load.

#include <cuda_runtime.h>

namespace {

constexpr int TILE_W = 64;                        // output columns per tile
constexpr int TILE_H = 32;                        // output rows per tile
constexpr int VEC = 4;                            // pixels per thread and row
constexpr int THREADS = 128;
constexpr int ROW_THREADS = TILE_W / VEC;         // 16 threads cover a row
constexpr int ROWS_PER_PASS = THREADS / ROW_THREADS;
constexpr int WIN_FLOATS = 6144;                  // 24 KB of shared memory
constexpr float WINDOW_MAX_TERM = 1048576.0f;     // 2^20, see window()
constexpr float INT32_SAFE = 1073741824.0f;       // 2^30

static_assert(TILE_H % ROWS_PER_PASS == 0, "rows per pass must divide the tile");

struct Task {
    const float* src;  // (B, H, W)
    float* dst;        // (B, OH, OW), 16-byte aligned
    int H, W, OH, OW;
    float ox, oy;
    int order;
    int tiles_x;       // tiles across an output row
    int tiles;         // tiles per sample
};

__device__ __forceinline__ int mirror_far32(int i, int n) {
    if (n == 1) return 0;
    const int s = n - 1;
    const int p = 2 * s;
    int r = (i + s) % p;  // C++ remainder keeps the dividend's sign
    if (r < 0) r += p;
    r -= s;
    return r < 0 ? -r : r;
}

__device__ __noinline__ int mirror_far64(long long i, int n) {
    if (n == 1) return 0;
    const long long s = n - 1;
    const long long p = 2 * s;
    long long r = (i + s) % p;
    if (r < 0) r += p;
    r -= s;
    return (int)(r < 0 ? -r : r);
}

// |i| < 2^30: in range costs one compare
__device__ __forceinline__ int mirror32(int i, int n) {
    return (unsigned)i < (unsigned)n ? i : mirror_far32(i, n);
}

// f is floorf of a coordinate (any float); the tap is f + add, mirrored
__device__ __forceinline__ int tap_index(float f, int add, int n) {
    if (fabsf(f) < INT32_SAFE) return mirror32((int)f + add, n);
    return mirror_far64((long long)f + add, n);
}

// the output pixel's centre on one axis, (i + 0.5) + offset
__device__ __forceinline__ float center(int i, float off) { return __fadd_rn(__fadd_rn((float)i, 0.5f), off); }

// the plain version's operation order: ((m0*x + m1*y) + m2) - 0.5
__device__ __forceinline__ float in_coord(float a, float b, float c, float x, float y) {
    return __fsub_rn(__fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)), c), 0.5f);
}

struct Window {
    int x0, y0, w, h;  // first column and row (unmirrored), width, height
    bool shared;       // staged in shared memory, else sampled from global
};

// The tile's source window: every tap of every pixel of rows r0..r1 and
// columns c0..c1 lies in it. in_x and in_y are affine in (c, r), so their
// exact extremes lie at the four corners; the computed coordinate of any
// pixel is within a few roundings of its exact value, under 2^-24 * 6 * E
// with E the sum of the terms' magnitudes (+1). E < 2^20 keeps that under
// 0.375 for both the corners and the pixel, so one tap of margin on each
// side covers floor(v), floor(v) + 1 and floor(v + 0.5). Each warp finds
// it on its own: lanes 0-3 take the corners' in_x, lanes 4-7 their in_y,
// and shuffles reduce them, so no block barrier is needed. Every lane of
// the warp must call it.
__device__ Window window(const float m[6], int r0, int r1, int c0, int c1, float ox, float oy) {
    constexpr unsigned FULL = 0xffffffffu;
    const int lane = threadIdx.x & 31;
    const bool is_y = lane & 4;  // lanes 4-7 (and their copies): in_y
    const float a = is_y ? m[3] : m[0], b = is_y ? m[4] : m[1], c = is_y ? m[5] : m[2];
    const float xa = center(c0, ox), xb = center(c1, ox);
    const float ya = center(r0, oy), yb = center(r1, oy);
    const float X = fmaxf(fabsf(xa), fabsf(xb));
    const float Y = fmaxf(fabsf(ya), fabsf(yb));
    const float e = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(fabsf(a), X), __fmul_rn(fabsf(b), Y)), fabsf(c)), 1.0f);
    float lo = in_coord(a, b, c, (lane & 1) ? xb : xa, (lane & 2) ? yb : ya);
    float hi = lo;
    lo = fminf(lo, __shfl_xor_sync(FULL, lo, 1));
    hi = fmaxf(hi, __shfl_xor_sync(FULL, hi, 1));
    lo = fminf(lo, __shfl_xor_sync(FULL, lo, 2));
    hi = fmaxf(hi, __shfl_xor_sync(FULL, hi, 2));
    const float ex = __shfl_sync(FULL, e, 0), ey = __shfl_sync(FULL, e, 4);
    Window win{0, 0, 0, 0, false};
    if (!(ex < WINDOW_MAX_TERM && ey < WINDOW_MAX_TERM)) return win;  // NaN too
    const int lo_x = (int)floorf(__shfl_sync(FULL, lo, 0)) - 1;
    const int hi_x = (int)floorf(__shfl_sync(FULL, hi, 0)) + 2;
    const int lo_y = (int)floorf(__shfl_sync(FULL, lo, 4)) - 1;
    const int hi_y = (int)floorf(__shfl_sync(FULL, hi, 4)) + 2;
    win.x0 = lo_x;
    win.y0 = lo_y;
    win.w = hi_x - lo_x + 1;
    win.h = hi_y - lo_y + 1;
    win.shared = win.w <= WIN_FLOATS && win.h <= WIN_FLOATS && win.w * win.h <= WIN_FLOATS;
    return win;
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
    const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem));
}

// Stage the window, mirrored, one warp per window row; a row segment inside
// [0, W) (the usual case) copies with no mirror arithmetic.
__device__ void stage(float* smem, const float* src, int H, int W, const Window& win) {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const bool inside = win.x0 >= 0 && win.x0 + win.w <= W;
    for (int j = warp; j < win.h; j += THREADS / 32) {
        const float* row = src + mirror32(win.y0 + j, H) * W;
        float* srow = smem + j * win.w;
        if (inside) {
            for (int i = lane; i < win.w; i += 32) cp_async4(srow + i, row + win.x0 + i);
        } else {
            for (int i = lane; i < win.w; i += 32) cp_async4(srow + i, row + mirror32(win.x0 + i, W));
        }
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
}

// A thread's pixels share their row's y and, row after row, their columns'
// x, so a*x and b*y are each computed once and reused: the same operations
// on the same values as in_coord, hence the same bits.
struct Terms {
    float ax[VEC], dx[VEC];  // m0 * x, m3 * x of the thread's columns
    float by, ey;            // m1 * y, m4 * y of the current row
};

// One output pixel, column k of the thread's group. SHARED: taps read the
// staged window at (tap - origin), folded into base = -(y0 * w + x0);
// otherwise they read src with the mirror index.
template <int ORDER, bool SHARED>
__device__ __forceinline__ float sample(const float m[6], const Terms& tm, int k, const float* __restrict__ src,
                                        int H, int W, const float* smem, int pitch, int base) {
    const float in_x = __fsub_rn(__fadd_rn(__fadd_rn(tm.ax[k], tm.by), m[2]), 0.5f);
    const float in_y = __fsub_rn(__fadd_rn(__fadd_rn(tm.dx[k], tm.ey), m[5]), 0.5f);
    if (ORDER == 0) {
        if (SHARED) {  // floor(v + 0.5) converted in one instruction; |v| < 2^20
            return smem[__float2int_rd(__fadd_rn(in_y, 0.5f)) * pitch + __float2int_rd(__fadd_rn(in_x, 0.5f)) + base];
        }
        const float fy = floorf(__fadd_rn(in_y, 0.5f));
        const float fx = floorf(__fadd_rn(in_x, 0.5f));
        return __ldg(src + tap_index(fy, 0, H) * W + tap_index(fx, 0, W));
    }
    const float fy = floorf(in_y);
    const float fx = floorf(in_x);
    const float wy1 = __fsub_rn(in_y, fy);
    const float wx1 = __fsub_rn(in_x, fx);
    const float wy0 = __fsub_rn(1.0f, wy1);
    const float wx0 = __fsub_rn(1.0f, wx1);
    float t00, t01, t10, t11;
    if (SHARED) {
        const float* p = smem + ((int)fy * pitch + (int)fx + base);
        t00 = p[0];
        t01 = p[1];
        t10 = p[pitch];
        t11 = p[pitch + 1];
    } else {
        const int y0 = tap_index(fy, 0, H) * W, y1 = tap_index(fy, 1, H) * W;
        const int x0 = tap_index(fx, 0, W), x1 = tap_index(fx, 1, W);
        t00 = __ldg(src + y0 + x0);
        t01 = __ldg(src + y0 + x1);
        t10 = __ldg(src + y1 + x0);
        t11 = __ldg(src + y1 + x1);
    }
    // the plain version's product and sum order
    float v = __fmul_rn(__fmul_rn(wy0, wx0), t00);
    v = __fadd_rn(v, __fmul_rn(__fmul_rn(wy0, wx1), t01));
    v = __fadd_rn(v, __fmul_rn(__fmul_rn(wy1, wx0), t10));
    v = __fadd_rn(v, __fmul_rn(__fmul_rn(wy1, wx1), t11));
    return v;
}

template <int ORDER, bool SHARED>
__device__ void write_tile(const Task& t, const float m[6], int b, int r0, int r1, int c0, int c1,
                           const float* smem, const Window& win) {
    const float* src = t.src + (size_t)b * t.H * t.W;
    const size_t plane = (size_t)b * t.OH * t.OW;
    const int pitch = win.w;
    const int base = -(win.y0 * win.w + win.x0);
    const int c = c0 + (threadIdx.x % ROW_THREADS) * VEC;
    if (c > c1) return;
    Terms tm;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
        const float x = center(c + k, t.ox);
        tm.ax[k] = __fmul_rn(m[0], x);
        tm.dx[k] = __fmul_rn(m[3], x);
    }
    for (int r = r0 + threadIdx.x / ROW_THREADS; r <= r1; r += ROWS_PER_PASS) {
        const float y = center(r, t.oy);
        tm.by = __fmul_rn(m[1], y);
        tm.ey = __fmul_rn(m[4], y);
        const size_t at = plane + (size_t)r * t.OW + c;
        if (c + VEC - 1 <= c1 && (at & (VEC - 1)) == 0) {
            float4 v;
            v.x = sample<ORDER, SHARED>(m, tm, 0, src, t.H, t.W, smem, pitch, base);
            v.y = sample<ORDER, SHARED>(m, tm, 1, src, t.H, t.W, smem, pitch, base);
            v.z = sample<ORDER, SHARED>(m, tm, 2, src, t.H, t.W, smem, pitch, base);
            v.w = sample<ORDER, SHARED>(m, tm, 3, src, t.H, t.W, smem, pitch, base);
            *reinterpret_cast<float4*>(t.dst + at) = v;
        } else {
#pragma unroll
            for (int k = 0; k < VEC; ++k) {
                if (c + k <= c1) t.dst[at + k] = sample<ORDER, SHARED>(m, tm, k, src, t.H, t.W, smem, pitch, base);
            }
        }
    }
}

__global__ void __launch_bounds__(THREADS) affine_warp_kernel(Task t0, Task t1, const float* __restrict__ mat) {
    __shared__ float smem[WIN_FLOATS];
    int tile = blockIdx.x;
    const bool first = tile < t0.tiles;
    const Task t = first ? t0 : t1;
    if (!first) tile -= t0.tiles;
    const int b = blockIdx.y;
    const int ty = tile / t.tiles_x;
    const int r0 = ty * TILE_H;
    const int c0 = (tile - ty * t.tiles_x) * TILE_W;
    const int r1 = min(r0 + TILE_H, t.OH) - 1;  // last real row and column
    const int c1 = min(c0 + TILE_W, t.OW) - 1;

    float m[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) m[k] = __ldg(mat + 6 * b + k);

    const Window win = window(m, r0, r1, c0, c1, t.ox, t.oy);
    if (win.shared) {
        stage(smem, t.src + (size_t)b * t.H * t.W, t.H, t.W, win);
        if (t.order == 0) write_tile<0, true>(t, m, b, r0, r1, c0, c1, smem, win);
        else write_tile<1, true>(t, m, b, r0, r1, c0, c1, smem, win);
    } else {
        if (t.order == 0) write_tile<0, false>(t, m, b, r0, r1, c0, c1, smem, win);
        else write_tile<1, false>(t, m, b, r0, r1, c0, c1, smem, win);
    }
}

Task make_task(const float* src, float* dst, int H, int W, int OH, int OW, float ox, float oy, int order) {
    Task t{src, dst, H, W, OH, OW, ox, oy, order, 0, 0};
    const int tiles_y = (OH + TILE_H - 1) / TILE_H;
    t.tiles_x = (OW + TILE_W - 1) / TILE_W;
    t.tiles = src == nullptr ? 0 : tiles_y * t.tiles_x;
    return t;
}

}  // namespace

// Task 0 warps src0 (B, H0, W0) into dst0 (B, OH0, OW0) at offset (ox0, oy0)
// with order0; task 1, when src1 is not null, warps src1 (B, H1, W1) into
// dst1 (B, H1, W1), nearest, at offset 0. mat (B, 6) holds each sample's
// inverse matrix. Every tensor is contiguous float32 on the current device,
// each output 16-byte aligned, each plane under 2^31 elements. Returns
// cudaGetLastError() after the launch.
extern "C" int affine_warp_launch(const float* mat, int B,
                                  const float* src0, float* dst0, int H0, int W0, int OH0, int OW0,
                                  float ox0, float oy0, int order0,
                                  const float* src1, float* dst1, int H1, int W1,
                                  cudaStream_t stream) {
    const Task t0 = make_task(src0, dst0, H0, W0, OH0, OW0, ox0, oy0, order0);
    const Task t1 = make_task(src1, dst1, H1, W1, H1, W1, 0.0f, 0.0f, 0);
    const long long tiles = (long long)t0.tiles + t1.tiles;
    if (B <= 0 || tiles <= 0) return (int)cudaSuccess;
    const dim3 grid((unsigned)tiles, (unsigned)B);
    affine_warp_kernel<<<grid, THREADS, 0, stream>>>(t0, t1, mat);
    return (int)cudaGetLastError();
}
