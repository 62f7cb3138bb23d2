// Separable upfirdn2d over NCHW planes: zero-insert by `up`, pad or crop,
// k-tap FIR along each axis, keep every `down`-th sample.
//
// Replaces the TPU kernel viscoin_tpu/ops/upfirdn2d_pallas.py::_fir1d_kernel
// (launched twice, vertical then horizontal, by upfirdn2d_pallas).
//
// Bound on the card: bytes. A 4x4 separable filter costs about 20 flops per
// output against 8 bytes moved in fp32 (4 in bf16), far below the H100's
// balance point. So the design moves each input byte from device memory
// about once and each output byte once, and keeps the arithmetic and the
// shared-memory traffic per output small enough to stay under that:
//
//   * One block computes one output tile (th x tw) of `ppb` planes (several
//     whole planes where a plane is smaller than a tile). The block index
//     alone gives the plane group and the tile: no divide per element.
//   * The block stages the input window (the tile mapped back through down,
//     pad and up, plus the k-1 halo) once in shared memory as fp32, with
//     coalesced loads (cp.async in fp32, so every load is in flight at once),
//     zero-filled outside the input. The path's inputs have odd widths
//     (257, 129, ...), so rows are not 16-byte aligned and the loads are
//     scalar.
//   * Vertical pass into a second shared buffer (fp32), then the horizontal
//     pass from it: 2k multiply-adds per output instead of k^2.
//   * Polyphase for up > 1: the output's phase fixes which ceil(k/up) taps
//     meet real samples, so no tap is spent on an inserted zero and the tap
//     loops carry no `%`.
//   * With up == 1 and the taps, up and down known at compile time, each
//     thread slides a register window: 8 intermediate rows from (7*down+k)
//     shared loads, and 16 bytes of outputs from 16-byte shared loads of the
//     intermediate row, stored with one 16-byte store where the row allows.
//   * fp32 accumulation; bf16 is rounded once, at the store.
//
// Instantiations: (k, up, down) = (4, 1, 1) (the FIR after every up-conv),
// (4, 2, 1) (the skip-image upsample), (4, 1, 2) (downsampling), and a
// runtime one of the same tiled kernel for any other separable filter of up
// to 16 taps and any pads and factors, per axis.
//
// The launch geometry (tile, planes per block, window sizes, shared memory,
// instantiation) is planned in Python (ops/upfirdn2d.py::fir_plan) and
// arrives as one by-value parameter block together with the taps (already
// flipped for true convolution, the gain folded into the horizontal taps).
//
// Plain C interface, loaded with ctypes (viscoin_tpu_torch/ops/_kernels.py).
// The entry point launches on the caller's stream, never synchronises, and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define VISCOIN_UPFIRDN_MAX_TAPS 16

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRunRows = 8;  // intermediate rows per thread in the sliding vertical pass

// Must match ops/upfirdn2d.py::_FirParams field for field.
struct Plan {
  long long planes;  // N * C
  long long blocks;
  int h, w;    // input plane
  int ho, wo;  // output plane
  int upy, upx, downy, downx;
  int pady0, padx0;
  int ky, kx;
  int th, tw;             // output tile
  int lg_th, lg_xruns;    // log2(th), log2(tw / outputs per thread)
  int ppb;                // planes per block
  int lh, lw;             // staged input window
  int lwp;                // row stride of the intermediate buffer
  int xs_floats;          // floats of the staged window (a multiple of 4)
  int tiles_x, tiles_y;
  int smem_bytes;
  int variant;
  int is_bf16;
  int vec_store;          // wo and the output pointer allow 16-byte stores
  float ty[VISCOIN_UPFIRDN_MAX_TAPS];
  float tx[VISCOIN_UPFIRDN_MAX_TAPS];  // times the gain
};

__device__ __forceinline__ int floordiv(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ int posmod(int a, int b) {
  const int r = a % b;
  return r < 0 ? r + b : r;
}

// One output of the polyphase form along an axis: the first tap that meets a
// real sample and the input index it meets, relative to the window origin.
struct Phase {
  int j0, first;
};

__device__ __forceinline__ Phase phase_of(int o, int up, int down, int pad0, int origin) {
  const int vb = o * down - pad0;
  const int j0 = posmod(-vb, up);
  return {j0, (vb + j0) / up - origin};
}

// 16 bytes of outputs (VO values) to global memory.
__device__ __forceinline__ void store_run(float* dst, const float (&v)[4], bool vec, int n) {
  if (vec) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < n) dst[i] = v[i];
  }
}

__device__ __forceinline__ void store_run(__nv_bfloat16* dst, const float (&v)[8], bool vec, int n) {
  if (vec) {
    __align__(16) __nv_bfloat162 packed[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) packed[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(packed);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (i < n) dst[i] = __float2bfloat16(v[i]);
  }
}

// Stage the window [np][lh][lw], zero outside the input; warps take rows.
// fp32 goes through cp.async, so every load of the block is in flight at
// once. bf16 goes through registers (2-byte elements on odd row widths fit no
// cp.async size): each warp loads kStageRows rows of up to 160 columns before
// it stores any, so its loads overlap instead of waiting one row at a time.
constexpr int kStageRows = 2;

__device__ __forceinline__ void stage_window(const float* xin, float* xs, int rows, int lh,
                                             int lw, int h, int w, int iy0, int ix0, int warp,
                                             int lane) {
  for (int r = warp; r < rows; r += kWarps) {
    const int pl = r / lh;
    const int gy = iy0 + (r - pl * lh);
    const bool row_ok = gy >= 0 && gy < h;
    const float* src = xin + (static_cast<long long>(pl) * h + (row_ok ? gy : 0)) * w;
    for (int c = lane; c < lw; c += 32) {
      const int gx = ix0 + c;
      const bool ok = row_ok && gx >= 0 && gx < w;
      const unsigned saddr = static_cast<unsigned>(__cvta_generic_to_shared(xs + r * lw + c));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(saddr),
                   "l"(ok ? src + gx : src), "r"(ok ? 4 : 0));
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void stage_window(const __nv_bfloat16* xin, float* xs, int rows, int lh,
                                             int lw, int h, int w, int iy0, int ix0, int warp,
                                             int lane) {
  constexpr int CU = 5;  // column blocks of 32 loaded ahead
  for (int r0 = warp; r0 < rows; r0 += kWarps * kStageRows) {
    const __nv_bfloat16* src[kStageRows];
    bool row_ok[kStageRows];
    __nv_bfloat16 v[kStageRows][CU];
#pragma unroll
    for (int i = 0; i < kStageRows; ++i) {
      const int r = r0 + i * kWarps;
      const int pl = r / lh;
      const int gy = iy0 + (r - pl * lh);
      row_ok[i] = r < rows && gy >= 0 && gy < h;
      src[i] = xin + (static_cast<long long>(pl) * h + (row_ok[i] ? gy : 0)) * w;
#pragma unroll
      for (int j = 0; j < CU; ++j) {
        const int gx = ix0 + lane + 32 * j;
        v[i][j] = row_ok[i] && lane + 32 * j < lw && gx >= 0 && gx < w ? src[i][gx]
                                                                       : __float2bfloat16(0.0f);
      }
    }
#pragma unroll
    for (int i = 0; i < kStageRows; ++i) {
      const int r = r0 + i * kWarps;
      if (r >= rows) break;
#pragma unroll
      for (int j = 0; j < CU; ++j)
        if (lane + 32 * j < lw) xs[r * lw + lane + 32 * j] = __bfloat162float(v[i][j]);
      for (int c = lane + 32 * CU; c < lw; c += 32) {
        const int gx = ix0 + c;
        xs[r * lw + c] = row_ok[i] && gx >= 0 && gx < w ? __bfloat162float(src[i][gx]) : 0.0f;
      }
    }
  }
}

// K, U, D > 0: taps, up and down known at compile time (the same on both
// axes); K == 0: everything from the plan, per axis.
template <typename T, int K, int U, int D>
__global__ void __launch_bounds__(kThreads)
    upfirdn2d_tiled(const T* __restrict__ x, T* __restrict__ y, const __grid_constant__ Plan p) {
  extern __shared__ __align__(16) float smem[];
  constexpr bool kStatic = K > 0;
  constexpr int VO = 16 / sizeof(T);  // outputs per thread in the horizontal pass
  const int ky = kStatic ? K : p.ky, kx = kStatic ? K : p.kx;
  const int uy = kStatic ? U : p.upy, ux = kStatic ? U : p.upx;
  const int dy = kStatic ? D : p.downy, dx = kStatic ? D : p.downx;

  // Block -> (plane group, tile row, tile column).
  const unsigned b = blockIdx.x;
  const int tile_x = b % p.tiles_x;
  const unsigned rest = b / p.tiles_x;
  const int tile_y = rest % p.tiles_y;
  const long long plane0 = static_cast<long long>(rest / p.tiles_y) * p.ppb;
  const int np = static_cast<int>(min(static_cast<long long>(p.ppb), p.planes - plane0));
  const int oy0 = tile_y * p.th, ox0 = tile_x * p.tw;
  const int iy0 = floordiv(oy0 * dy - p.pady0 + uy - 1, uy);
  const int ix0 = floordiv(ox0 * dx - p.padx0 + ux - 1, ux);

  float* xs = smem;                  // [np][lh][lw]   staged input
  float* tmp = smem + p.xs_floats;   // [np][th][lwp]  after the vertical pass
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // 1. Stage the window.
  stage_window(x + plane0 * p.h * p.w, xs, np * p.lh, p.lh, p.lw, p.h, p.w, iy0, ix0, warp,
               lane);
  __syncthreads();

  // 2. Vertical pass: tmp[pl][r][c] for the th output rows of the tile.
  if constexpr (kStatic && U == 1) {
    constexpr int NW = (kRunRows - 1) * D + K;
    // Warps take (run of 8 rows, block of 32 columns) items.
    const int nruns = p.th / kRunRows;
    const int ncb = (p.lw + 31) >> 5;
    for (int it = warp; it < np * nruns * ncb; it += kWarps) {
      const int q = it / ncb;
      const int c = (it - q * ncb) * 32 + lane;
      const int pl = q / nruns;
      const int run = q - pl * nruns;
      const float* src = xs + (pl * p.lh + run * kRunRows * D) * p.lw;
      float* dst = tmp + (pl * p.th + run * kRunRows) * p.lwp;
      if (c < p.lw) {
        float win[NW];
#pragma unroll
        for (int i = 0; i < NW; ++i) win[i] = src[i * p.lw + c];
#pragma unroll
        for (int r = 0; r < kRunRows; ++r) {
          float acc = 0.0f;
#pragma unroll
          for (int j = 0; j < K; ++j) acc = fmaf(p.ty[j], win[r * D + j], acc);
          dst[r * p.lwp + c] = acc;
        }
      }
    }
  } else {
    for (int it = warp; it < np * p.th; it += kWarps) {
      const int pl = it >> p.lg_th;
      const Phase ph = phase_of(oy0 + (it & (p.th - 1)), uy, dy, p.pady0, iy0);
      const float* src = xs + (pl * p.lh + ph.first) * p.lw;
      float* dst = tmp + it * p.lwp;
      for (int c = lane; c < p.lw; c += 32) {
        float acc = 0.0f;
        int m = 0;
        for (int j = ph.j0; j < ky; j += uy, ++m) acc = fmaf(p.ty[j], src[m * p.lw + c], acc);
        dst[c] = acc;
      }
    }
  }
  __syncthreads();

  // 3. Horizontal pass: VO adjacent outputs per thread.
  const int xruns_mask = (1 << p.lg_xruns) - 1;
  for (int it = threadIdx.x; it < (np * p.th) << p.lg_xruns; it += kThreads) {
    const int row = it >> p.lg_xruns;  // pl * th + r
    const int oy = oy0 + (row & (p.th - 1));
    const int xo = (it & xruns_mask) * VO;  // first output of the run, in the tile
    const int ox = ox0 + xo;
    if (oy >= p.ho || ox >= p.wo) continue;
    const float* src = tmp + row * p.lwp;
    float out[VO];
    if constexpr (kStatic && U == 1) {
      constexpr int NV4 = ((VO - 1) * D + K + 3) / 4;
      float win[NV4 * 4];
      const float4* s4 = reinterpret_cast<const float4*>(src + xo * D);
#pragma unroll
      for (int i = 0; i < NV4; ++i) {
        const float4 v = s4[i];
        win[4 * i] = v.x;
        win[4 * i + 1] = v.y;
        win[4 * i + 2] = v.z;
        win[4 * i + 3] = v.w;
      }
#pragma unroll
      for (int v = 0; v < VO; ++v) {
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < K; ++j) acc = fmaf(p.tx[j], win[v * D + j], acc);
        out[v] = acc;
      }
    } else {
#pragma unroll
      for (int v = 0; v < VO; ++v) {
        const Phase ph = phase_of(ox0 + xo + v, ux, dx, p.padx0, ix0);
        float acc = 0.0f;
        int m = 0;
        for (int j = ph.j0; j < kx; j += ux, ++m) acc = fmaf(p.tx[j], src[ph.first + m], acc);
        out[v] = acc;
      }
    }
    const long long plane = plane0 + (row >> p.lg_th);
    T* dst = y + (plane * p.ho + oy) * p.wo + ox;
    store_run(dst, out, p.vec_store && ox + VO <= p.wo, p.wo - ox);
  }
}

template <typename T, int K, int U, int D>
cudaError_t launch(const void* x, void* y, const Plan& p, cudaStream_t s) {
  auto kernel = upfirdn2d_tiled<T, K, U, D>;
  if (p.smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem_bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<static_cast<unsigned>(p.blocks), kThreads, p.smem_bytes, s>>>(
      static_cast<const T*>(x), static_cast<T*>(y), p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, void* y, const Plan& p, cudaStream_t s) {
  switch (p.variant) {  // ops/upfirdn2d.py::VARIANTS
    case 0: return launch<T, 4, 1, 1>(x, y, p, s);
    case 1: return launch<T, 4, 2, 1>(x, y, p, s);
    case 2: return launch<T, 4, 1, 2>(x, y, p, s);
    case 3: return launch<T, 0, 0, 0>(x, y, p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// `plan` points to a Plan (a void pointer keeps the entry point's linkage C).
extern "C" int viscoin_upfirdn2d(const void* x, void* y, const void* plan, void* stream) {
  const Plan& p = *static_cast<const Plan*>(plan);
  if (p.ky < 1 || p.kx < 1 || p.ky > VISCOIN_UPFIRDN_MAX_TAPS ||
      p.kx > VISCOIN_UPFIRDN_MAX_TAPS || p.upy < 1 || p.upx < 1 || p.downy < 1 ||
      p.downx < 1 || p.blocks < 1 || p.blocks > 0x7fffffffLL || (p.th & (p.th - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(p.is_bf16 ? dispatch<__nv_bfloat16>(x, y, p, s)
                                    : dispatch<float>(x, y, p, s));
}
