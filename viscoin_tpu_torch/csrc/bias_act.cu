// Fused bias + activation + gain + clamp over an NCHW tensor.
//
// Replaces the TPU kernel viscoin_tpu/ops/bias_act.py::_bias_act_kernel
// (launched by _bias_act_pallas through bias_act(impl="pallas")).
//
//   y = clip(gain * act(x + b[c]), -clamp, clamp),  computed in fp32,
//   act in {linear, relu, lrelu(alpha)}; clamp < 0 means no clamp.
//
// Bound on the card: bytes. Each element is read once and written once
// (4 flops per 8 bytes in fp32), far below the ~20 flop/byte the H100 needs
// before arithmetic matters. The design does one pass with one thread per
// element and a grid-stride loop; the channel of element i is
// (i / hw) % C, where hw is the product of the dims after dim 1. The Pallas
// version moved the channel axis last and tiled (rows, C) blocks; on the card
// no relayout is needed because neighbouring threads already touch
// neighbouring addresses.
//
// Plain C interface, loaded with ctypes (viscoin_tpu_torch/ops/_kernels.py).
// The entry point launches on the caller's stream, never synchronises, and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Act { kLinear = 0, kRelu = 1, kLrelu = 2 };

__device__ __forceinline__ float load_f(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

template <typename T>
__global__ void bias_act_kernel(const T* __restrict__ x, const T* __restrict__ b,
                                T* __restrict__ y, int64_t n, int64_t channels,
                                int64_t hw, int act, float alpha, float gain,
                                float clamp) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    float v = load_f(x, i);
    if (b != nullptr) v += load_f(b, (i / hw) % channels);
    if (act == kRelu) {
      v = v > 0.0f ? v : 0.0f;
    } else if (act == kLrelu) {
      v = v >= 0.0f ? v : v * alpha;
    }
    v *= gain;
    if (clamp >= 0.0f) v = fminf(fmaxf(v, -clamp), clamp);
    store_f(y, i, v);
  }
}

template <typename T>
void launch(const void* x, const void* b, void* y, int64_t n, int64_t channels,
            int64_t hw, int act, float alpha, float gain, float clamp,
            cudaStream_t stream) {
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > (int64_t)1 << 20) blocks = (int64_t)1 << 20;  // grid-stride covers the rest
  if (blocks < 1) blocks = 1;
  bias_act_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(b), static_cast<T*>(y), n,
      channels, hw, act, alpha, gain, clamp);
}

}  // namespace

extern "C" int viscoin_bias_act(const void* x, const void* b, void* y, long long n,
                                long long channels, long long hw, int act,
                                float alpha, float gain, float clamp, int is_bf16,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    if (is_bf16) {
      launch<__nv_bfloat16>(x, b, y, n, channels, hw, act, alpha, gain, clamp, s);
    } else {
      launch<float>(x, b, y, n, channels, hw, act, alpha, gain, clamp, s);
    }
  }
  return (int)cudaGetLastError();
}
