// Separable upfirdn2d over NCHW planes: zero-insert by `up`, pad or crop,
// k-tap FIR along each axis, keep every `down`-th sample.
//
// Replaces the TPU kernel viscoin_tpu/ops/upfirdn2d_pallas.py::_fir1d_kernel
// (launched twice, vertical then horizontal, by upfirdn2d_pallas).
//
// Direct form: one thread per output element. Output (oy, ox) maps back
// through down, pad and up to the zero-inserted input positions
//   u = o * down + j - pad0      (j = tap index, correlation taps)
// and a position contributes only when 0 <= u < in * up and u % up == 0,
// reading input sample u / up. The taps arrive already flipped (true
// convolution) unless the caller asked for correlation, and already
// normalised; `gain` is applied once at the end. Both passes are fused: no
// intermediate plane is written to device memory, so the kernel moves each
// input byte about once (the taps overlap in L1/L2) and each output byte
// once.
//
// Bound on the card: bytes. At the serving path's shapes a 4x4 separable
// filter costs ~20 flops per output against 4-8 bytes moved, below the
// ~20 flop/byte balance point of the H100 in fp32. This first version keeps
// no shared-memory tile; that and vector loads are later work.
//
// Plain C interface, loaded with ctypes (viscoin_tpu_torch/ops/_kernels.py).
// The taps ride in a by-value parameter block (no device allocation); the
// entry point launches on the caller's stream, never synchronises, and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define VISCOIN_UPFIRDN_MAX_TAPS 16

namespace {

struct Params {
  int64_t planes;  // N * C
  int h, w;        // input plane
  int ho, wo;      // output plane
  int upy, upx, downy, downx;
  int pady0, padx0;
  int ky, kx;
  float gain;
  float ty[VISCOIN_UPFIRDN_MAX_TAPS];
  float tx[VISCOIN_UPFIRDN_MAX_TAPS];
};

__device__ __forceinline__ float load_f(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16(v);
}

template <typename T>
__global__ void upfirdn2d_kernel(const T* __restrict__ x, T* __restrict__ y, const Params p) {
  const int64_t total = p.planes * p.ho * p.wo;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int hu = p.h * p.upy;
  const int wu = p.w * p.upx;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += stride) {
    const int ox = (int)(idx % p.wo);
    const int64_t t = idx / p.wo;
    const int oy = (int)(t % p.ho);
    const int64_t plane = t / p.ho;
    const T* xp = x + plane * p.h * p.w;
    float acc = 0.0f;
    for (int i = 0; i < p.ky; ++i) {
      const int uy = oy * p.downy + i - p.pady0;
      if (uy < 0 || uy >= hu || uy % p.upy != 0) continue;
      const T* row = xp + (int64_t)(uy / p.upy) * p.w;
      float racc = 0.0f;
      for (int j = 0; j < p.kx; ++j) {
        const int ux = ox * p.downx + j - p.padx0;
        if (ux < 0 || ux >= wu || ux % p.upx != 0) continue;
        racc += p.tx[j] * load_f(row, ux / p.upx);
      }
      acc += p.ty[i] * racc;
    }
    store_f(y, idx, acc * p.gain);
  }
}

}  // namespace

extern "C" int viscoin_upfirdn2d(const void* x, void* y, long long planes, int h, int w,
                                 int ho, int wo, const float* taps_y, int ky,
                                 const float* taps_x, int kx, int upy, int upx,
                                 int downy, int downx, int pady0, int padx0, float gain,
                                 int is_bf16, void* stream) {
  if (ky < 1 || kx < 1 || ky > VISCOIN_UPFIRDN_MAX_TAPS || kx > VISCOIN_UPFIRDN_MAX_TAPS ||
      upy < 1 || upx < 1 || downy < 1 || downx < 1) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.planes = planes;
  p.h = h;
  p.w = w;
  p.ho = ho;
  p.wo = wo;
  p.upy = upy;
  p.upx = upx;
  p.downy = downy;
  p.downx = downx;
  p.pady0 = pady0;
  p.padx0 = padx0;
  p.ky = ky;
  p.kx = kx;
  p.gain = gain;
  for (int i = 0; i < VISCOIN_UPFIRDN_MAX_TAPS; ++i) {
    p.ty[i] = i < ky ? taps_y[i] : 0.0f;
    p.tx[i] = i < kx ? taps_x[i] : 0.0f;
  }
  const int64_t total = planes * (int64_t)ho * wo;
  if (total > 0) {
    const int threads = 256;
    int64_t blocks = (total + threads - 1) / threads;
    if (blocks > (int64_t)1 << 20) blocks = (int64_t)1 << 20;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_bf16) {
      upfirdn2d_kernel<__nv_bfloat16><<<(unsigned)blocks, threads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y), p);
    } else {
      upfirdn2d_kernel<float><<<(unsigned)blocks, threads, 0, s>>>(
          static_cast<const float*>(x), static_cast<float*>(y), p);
    }
  }
  return (int)cudaGetLastError();
}
