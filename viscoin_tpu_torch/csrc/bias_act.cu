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
// before arithmetic matters, so the kernel has to run at HBM speed. The
// Pallas version moved the channel axis last and tiled (rows, C) blocks; on
// the card the tensor is read in place as rows:
//
//   * NCHW-like (hw > 1): a row is one (n, c) plane of hw elements, the
//     channel is row % C, computed once per thread, and the bias is read
//     once per thread;
//   * (B, F) and (B, F, 1, ...) (hw == 1): a row is one sample of F
//     features, and the bias varies along the row, loaded as a vector
//     beside x.
//
// A 2-D block covers block_y rows by block_x * 4 vectors of one row's chunk,
// so a small plane (4x4) shares a block with its neighbours instead of
// leaving most threads idle. Accesses are 16 bytes wide (float4 in fp32,
// 8 x bf16 in bf16) when the row length is a multiple of the vector width
// and the pointers are 16-byte aligned (checked by the wrapper), else
// scalar. There is no 64-bit divide: one 32-bit divide per thread finds its
// row and chunk. The arithmetic is the plain version's, in fp32, rounded
// once, so the result is bit-equal to it in fp32 and bf16.
//
// The launch geometry is planned in Python (ops/bias_act.py::bias_act_plan)
// and arrives as one by-value parameter block.
//
// Plain C interface, loaded with ctypes (viscoin_tpu_torch/ops/_kernels.py).
// The entry point launches on the caller's stream, never synchronises, and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Act { kLinear = 0, kRelu = 1, kLrelu = 2 };
constexpr int kItems = 4;  // vectors per thread along its row (BIAS_ACT_ITEMS in bias_act.py)

// Must match ops/bias_act.py::_BiasActParams field for field.
struct Plan {
  long long rows;
  long long row_len;  // elements per row
  long long blocks;
  int channels;
  int bias_mode;  // 0: bias of row % channels; 1: bias of the column (hw == 1)
  int vec;        // elements per access
  int block_x, block_y;
  int chunks;     // chunks per row
  int act;
  int is_bf16;
  float alpha, gain, clamp;
};

template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f(float& d, float v) { d = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16& d, float v) {
  d = __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

template <typename T, int VEC, int MODE>
__global__ void __launch_bounds__(256)
    bias_act_kernel(const T* __restrict__ x, const T* __restrict__ b, T* __restrict__ y,
                    const __grid_constant__ Plan p) {
  using V = Pack<T, VEC>;
  const unsigned rowblk = blockIdx.x / static_cast<unsigned>(p.chunks);
  const unsigned chunk = blockIdx.x - rowblk * static_cast<unsigned>(p.chunks);
  const long long row = static_cast<long long>(rowblk) * p.block_y + threadIdx.y;
  if (row >= p.rows) return;
  const int nvec = static_cast<int>(p.row_len / VEC);
  float brow = 0.0f;
  if (MODE == 0 && b != nullptr) brow = to_f(b[static_cast<unsigned>(row) % p.channels]);
  const V* xr = reinterpret_cast<const V*>(x + row * p.row_len);
  V* yr = reinterpret_cast<V*>(y + row * p.row_len);
  const int v0 = chunk * (p.block_x * kItems) + threadIdx.x;

  V in[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int v = v0 + k * p.block_x;
    if (v < nvec) in[k] = xr[v];
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int v = v0 + k * p.block_x;
    if (v >= nvec) continue;
    V bv;
    if (MODE == 1 && b != nullptr) bv = reinterpret_cast<const V*>(b)[v];
    V out;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      float t = to_f(in[k].v[e]);
      if (b != nullptr) t += MODE == 0 ? brow : to_f(bv.v[e]);
      if (p.act == kRelu) {
        t = t > 0.0f ? t : 0.0f;
      } else if (p.act == kLrelu) {
        t = t >= 0.0f ? t : t * p.alpha;
      }
      t *= p.gain;
      if (p.clamp >= 0.0f) t = fminf(fmaxf(t, -p.clamp), p.clamp);
      from_f(out.v[e], t);
    }
    yr[v] = out;
  }
}

template <typename T, int VEC>
void launch(const void* x, const void* b, void* y, const Plan& p, cudaStream_t s) {
  const dim3 block(p.block_x, p.block_y);
  const unsigned grid = static_cast<unsigned>(p.blocks);
  if (p.bias_mode == 0) {
    bias_act_kernel<T, VEC, 0><<<grid, block, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(b), static_cast<T*>(y), p);
  } else {
    bias_act_kernel<T, VEC, 1><<<grid, block, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(b), static_cast<T*>(y), p);
  }
}

}  // namespace

// `plan` points to a Plan (a void pointer keeps the entry point's linkage C).
extern "C" int viscoin_bias_act(const void* x, const void* b, void* y, const void* plan,
                                void* stream) {
  const Plan& p = *static_cast<const Plan*>(plan);
  if (p.blocks < 1 || p.blocks > 0x7fffffffLL || p.block_x * p.block_y != 256 ||
      p.row_len % p.vec != 0 || p.channels < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.is_bf16) {
    if (p.vec == 8) {
      launch<__nv_bfloat16, 8>(x, b, y, p, s);
    } else {
      launch<__nv_bfloat16, 1>(x, b, y, p, s);
    }
  } else {
    if (p.vec == 4) {
      launch<float, 4>(x, b, y, p, s);
    } else {
      launch<float, 1>(x, b, y, p, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
