// Fused bias + activation + gain + clamp over an NCHW tensor, and its
// backward.
//
// Replaces the TPU kernel viscoin_tpu/ops/bias_act.py::_bias_act_kernel
// (launched by _bias_act_pallas through bias_act(impl="pallas")).
//
//   y = clip(gain * act(x + b[c]), -clamp, clamp),  computed in fp32,
//   act in {linear, relu, lrelu(alpha)}; clamp < 0 means no clamp.
//
// The backward (bias_act_grad_kernel) has no TPU counterpart: in JAX,
// jax.grad derives it from the XLA path. It recomputes t = x + b and
// y0 = gain * act(t) and writes
//
//   dx = dy * clip'(y0) * gain * act'(t),   db[c] = sum of dx over all but dim 1,
//
// with jax.grad's values at ties: relu'(0) = 1/2 (jnp.maximum splits a tie),
// lrelu'(0) = 1 (jnp.where(t >= 0)), and clip' = 1/2 where y0 is exactly
// -clamp or +clamp (jnp.clip is a maximum then a minimum), 0 outside. The
// factors are applied in jax.grad's order (clip', gain, act'), so fp32 is
// bit-equal to it. dx is rounded once to x's type; db is summed in fp32
// from the unrounded dx: per row in registers and warp shuffles, then one
// atomicAdd per row (mode 0) or per element (mode 1, (B, F) features).
// It reads x and dy and writes dx: bytes-bound like the forward.
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

// dL/dt from dL/dy = g at pre-activation t (see the head of the file).
__device__ __forceinline__ float grad_at(float t, float g, const Plan& p) {
  if (p.clamp >= 0.0f) {
    float y = t;
    if (p.act == kRelu) {
      y = y > 0.0f ? y : 0.0f;
    } else if (p.act == kLrelu) {
      y = y >= 0.0f ? y : y * p.alpha;
    }
    y *= p.gain;
    const float m = fmaxf(y, -p.clamp);
    g *= (y > -p.clamp ? 1.0f : (y == -p.clamp ? 0.5f : 0.0f)) *
         (m < p.clamp ? 1.0f : (m == p.clamp ? 0.5f : 0.0f));
  }
  g *= p.gain;
  if (p.act == kRelu) {
    g *= t > 0.0f ? 1.0f : (t == 0.0f ? 0.5f : 0.0f);
  } else if (p.act == kLrelu && !(t >= 0.0f)) {
    g *= p.alpha;
  }
  return g;
}

// The forward's launch geometry; no thread returns early, since the db
// reduction shuffles across every lane of a warp.
template <typename T, int VEC, int MODE>
__global__ void __launch_bounds__(256)
    bias_act_grad_kernel(const T* __restrict__ x, const T* __restrict__ b,
                         const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ db,
                         const __grid_constant__ Plan p) {
  using V = Pack<T, VEC>;
  const unsigned rowblk = blockIdx.x / static_cast<unsigned>(p.chunks);
  const unsigned chunk = blockIdx.x - rowblk * static_cast<unsigned>(p.chunks);
  const long long row = static_cast<long long>(rowblk) * p.block_y + threadIdx.y;
  const bool live = row < p.rows;
  const int nvec = static_cast<int>(p.row_len / VEC);
  float brow = 0.0f;
  if (MODE == 0 && b != nullptr && live) brow = to_f(b[static_cast<unsigned>(row) % p.channels]);
  const long long base = live ? row * p.row_len : 0;
  const V* xr = reinterpret_cast<const V*>(x + base);
  const V* dyr = reinterpret_cast<const V*>(dy + base);
  V* dxr = reinterpret_cast<V*>(dx + base);
  const int v0 = chunk * (p.block_x * kItems) + threadIdx.x;

  V in[kItems], gin[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int v = v0 + k * p.block_x;
    if (live && v < nvec) {
      in[k] = xr[v];
      gin[k] = dyr[v];
    }
  }
  float part = 0.0f;  // mode 0: this thread's share of db[row % channels]
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int v = v0 + k * p.block_x;
    if (!live || v >= nvec) continue;
    V bv;
    if (MODE == 1 && b != nullptr) bv = reinterpret_cast<const V*>(b)[v];
    V out;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      float t = to_f(in[k].v[e]);
      if (b != nullptr) t += MODE == 0 ? brow : to_f(bv.v[e]);
      const float g = grad_at(t, to_f(gin[k].v[e]), p);
      from_f(out.v[e], g);
      if (db != nullptr) {
        if (MODE == 0) {
          part += g;
        } else {
          atomicAdd(db + v * VEC + e, g);
        }
      }
    }
    dxr[v] = out;
  }
  if (MODE == 0 && db != nullptr) {
    // Sum over the block_x threads of the row: shuffles within a warp (or
    // within the row's segment of one), then across the row's warps.
    const int width = p.block_x < 32 ? p.block_x : 32;
    for (int o = width / 2; o > 0; o >>= 1) part += __shfl_down_sync(0xffffffffu, part, o, width);
    if (p.block_x <= 32) {
      if (threadIdx.x == 0 && live) atomicAdd(db + static_cast<unsigned>(row) % p.channels, part);
    } else {
      __shared__ float warp_sums[256 / 32];
      const int tid = threadIdx.y * p.block_x + threadIdx.x;
      if ((tid & 31) == 0) warp_sums[tid >> 5] = part;
      __syncthreads();
      if (threadIdx.x == 0 && live) {
        float s = 0.0f;
        for (int w = 0; w < p.block_x / 32; ++w) s += warp_sums[(tid >> 5) + w];
        atomicAdd(db + static_cast<unsigned>(row) % p.channels, s);
      }
    }
  }
}

template <typename T, int VEC>
void launch_grad(const void* x, const void* b, const void* dy, void* dx, float* db,
                 const Plan& p, cudaStream_t s) {
  const dim3 block(p.block_x, p.block_y);
  const unsigned grid = static_cast<unsigned>(p.blocks);
  if (p.bias_mode == 0) {
    bias_act_grad_kernel<T, VEC, 0><<<grid, block, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(b), static_cast<const T*>(dy),
        static_cast<T*>(dx), db, p);
  } else {
    bias_act_grad_kernel<T, VEC, 1><<<grid, block, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(b), static_cast<const T*>(dy),
        static_cast<T*>(dx), db, p);
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

static bool plan_ok(const Plan& p) {
  return p.blocks >= 1 && p.blocks <= 0x7fffffffLL && p.block_x * p.block_y == 256 &&
         p.row_len % p.vec == 0 && p.channels >= 1;
}

// `plan` points to a Plan (a void pointer keeps the entry point's linkage C).
extern "C" int viscoin_bias_act(const void* x, const void* b, void* y, const void* plan,
                                void* stream) {
  const Plan& p = *static_cast<const Plan*>(plan);
  if (!plan_ok(p)) return static_cast<int>(cudaErrorInvalidValue);
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

// The backward: dx from x, b (may be null) and dy, all of x's type and
// contiguous; db (fp32, zeroed by the caller, may be null) gets the bias
// gradient added. The same Plan as the forward, for x's shape.
extern "C" int viscoin_bias_act_grad(const void* x, const void* b, const void* dy, void* dx,
                                     void* db, const void* plan, void* stream) {
  const Plan& p = *static_cast<const Plan*>(plan);
  if (!plan_ok(p)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dbf = static_cast<float*>(db);
  if (p.is_bf16) {
    if (p.vec == 8) {
      launch_grad<__nv_bfloat16, 8>(x, b, dy, dx, dbf, p, s);
    } else {
      launch_grad<__nv_bfloat16, 1>(x, b, dy, dx, dbf, p, s);
    }
  } else {
    if (p.vec == 4) {
      launch_grad<float, 4>(x, b, dy, dx, dbf, p, s);
    } else {
      launch_grad<float, 1>(x, b, dy, dx, dbf, p, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
