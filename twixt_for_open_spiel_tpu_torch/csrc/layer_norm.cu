// The net's LayerNorm (S2), for Hopper: a forward fused with its epilogue
// (S2a) and a backward fused with the epilogue's mask and the parameters'
// gradients (S2b).
//
// Not a TPU kernel: it replaces no Pallas kernel.  The JAX net's
// nn.LayerNorm, with the nn.relu after it and ResBlock's residual add
// (twixt_for_open_spiel_tpu/models/network.py:32-37, 54-55, 62, 80, 83),
// is one XLA fusion there, forward and backward.  The port ran
// F.layer_norm on a float32 copy, a cast back, then a ReLU and an add, each
// a pass over the activations; an H100 profile put that at 44 % of a
// search's device time and, with the casts, 77 % of a train step's
// (PERF.md §5).
//
// Semantics: ops/layer_norm.py::layer_norm_reference and
// layer_norm_backward_reference, which compute flax's formula
// (flax/linen/normalization.py::_compute_stats with use_fast_variance,
// ::_normalize): over each row of C contiguous channels, float32 mean and
// mean of squares in one pass, var = max(0, E[x^2] - E[x]^2),
// y = (x - mean) * (rsqrt(var + 1e-6) * gamma) + beta in float32, rounded
// to the input's type T (bfloat16 or float32), then the epilogue:
//   0 none       y
//   1 relu       relu(y)
//   2 residual   relu(res + y), y rounded to T first and the sum rounded
//                again, as ResBlock adds two T tensors.
// The statistics are summed in another order than the plain version's, so
// the two agree to a few float32 ulps before the rounding to T.
//
// Backward, from dout and the forward's inputs (x, gamma, beta and, under
// the residual epilogue, res): the row's statistics and y again, by the
// forward's own arithmetic (row_stats and affine below: the same lanes, the
// same order, every rounding explicit), so the ReLU mask is bit for bit the
// forward's out > 0 without reading out:
//   relu: round(y) > 0; residual: res + round(y) > 0 (two T values: their
//   float32 sum is zero only when the exact sum is, and otherwise rounds
//   to a nonzero T);
//   dy = dout masked; xhat = (x - mean) * rstd; g = dy * gamma;
//   dx = rstd * (g - sum(g) / C - xhat * sum(g * xhat) / C), rounded to T;
//   dres = dy (exact in T) under the residual epilogue;
//   dgamma = sum over rows of dy * xhat, dbeta = sum of dy, in float32.
// The derivative is the unclamped one: it differs from autograd's through
// max(0, .) only where the variance rounds below 0.  dgamma and dbeta are
// deterministic: each block sums its rows' products in a fixed order into a
// float32 partial, and a second kernel sums the blocks' partials in block
// order.  No float atomics: two runs of a step agree bit for bit.
//
// Layout and design: a row is C contiguous elements of the NHWC activations
// (C a power of two, 8-256).  LANES = min(32, C * sizeof(T) / 16) lanes of a
// warp share a row, each loading 16 bytes at a time (ITEMS vectors a lane);
// a warp holds 32 / LANES neighbouring rows, so a warp's loads are
// contiguous.  The row's two sums go by XOR shuffles inside its lanes.  The
// row stays in registers between the statistics and the store, so x is read
// once: S2a reads x (and res) and writes out; S2b reads dout, x (and res)
// and writes dx (and dres): the bytes the function needs, at 3.35 TB/s,
// against a few dozen float operations an element.  The epilogue is a
// kernel argument, uniform over a launch; dtype and C are template
// parameters (24 instantiations).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (see ops/_cuda.py).  Plain C entry points, bound with
// ctypes; no PyTorch headers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARP = 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;
constexpr float EPS = 1e-6f;  // flax nn.LayerNorm's epsilon
constexpr int EPI_NONE = 0, EPI_RELU = 1, EPI_RESIDUAL = 2;

// 16 bytes of T as floats, and floats back to T (round to nearest even).
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* v) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
  __device__ static float round(float x) { return x; }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* v) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // the lower address is the low half
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float* v) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
  __device__ static float round(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
};

// float32 parameters for one vector of T's width
template <int N>
__device__ __forceinline__ void load_params(const float* p, float* v) {
#pragma unroll
  for (int i = 0; i < N; i += 4) Vec<float>::load(p + i, v + i);
}

template <typename T, int C>
struct Rows {
  static constexpr int V = Vec<T>::N;                             // elements a vector
  static constexpr int LANES = C / V < WARP ? C / V : WARP;        // lanes a row
  static constexpr int ITEMS = C / (LANES * V);                   // vectors a lane
  static constexpr int PER_BLOCK = THREADS / LANES;               // rows a block
  static_assert(C % V == 0 && C % (LANES * V) == 0, "C: a power of two, 16 bytes or more");
};

// The sum over the LANES aligned lanes of a row; every lane ends with it.
template <int LANES>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ float relu(float v) { return v < 0.0f ? 0.0f : v; }

// A row's (mean, rstd) from its lanes' elements: every rounding explicit, so
// S2a and S2b, which hold a row in the same lanes, get the same bits.
template <typename T, int C>
__device__ __forceinline__ float2 row_stats(const float (&v)[Rows<T, C>::ITEMS][Rows<T, C>::V]) {
  using R = Rows<T, C>;
  float s = 0.0f, ss = 0.0f;
#pragma unroll
  for (int k = 0; k < R::ITEMS; ++k) {
#pragma unroll
    for (int j = 0; j < R::V; ++j) {
      s = __fadd_rn(s, v[k][j]);
      ss = __fmaf_rn(v[k][j], v[k][j], ss);
    }
  }
  s = row_sum<R::LANES>(s);
  ss = row_sum<R::LANES>(ss);
  const float mean = __fmul_rn(s, 1.0f / C);  // C is a power of two: exact
  const float var = fmaxf(__fsub_rn(__fmul_rn(ss, 1.0f / C), __fmul_rn(mean, mean)), 0.0f);
  return make_float2(mean, rsqrtf(__fadd_rn(var, EPS)));
}

// y = (x - mean) * (rstd * gamma) + beta, rounded as S2a and S2b both take it
__device__ __forceinline__ float affine(float x, float2 st, float g, float b) {
  return __fmaf_rn(__fsub_rn(x, st.x), __fmul_rn(st.y, g), b);
}

template <typename T, int C>
__global__ void __launch_bounds__(THREADS) layer_norm_forward_kernel(
    const T* __restrict__ x, const float* __restrict__ gamma, const float* __restrict__ beta,
    const T* __restrict__ res, T* __restrict__ out, long long rows, int epilogue) {
  using R = Rows<T, C>;
  constexpr int V = R::V;
  const int sub = threadIdx.x % R::LANES;
  const long long row = (long long)blockIdx.x * R::PER_BLOCK + threadIdx.x / R::LANES;
  const bool live = row < rows;  // a dead row's lanes still join the shuffles
  const long long base = row * C;

  float v[R::ITEMS][V];
#pragma unroll
  for (int k = 0; k < R::ITEMS; ++k) {
    if (live) {
      Vec<T>::load(x + base + (k * R::LANES + sub) * V, v[k]);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) v[k][j] = 0.0f;
    }
  }
  const float2 st = row_stats<T, C>(v);
  if (!live) return;
#pragma unroll
  for (int k = 0; k < R::ITEMS; ++k) {
    const int c = (k * R::LANES + sub) * V;
    float g[V], b[V], y[V];
    load_params<V>(gamma + c, g);
    load_params<V>(beta + c, b);
#pragma unroll
    for (int j = 0; j < V; ++j) y[j] = affine(v[k][j], st, g[j], b[j]);
    if (epilogue == EPI_RELU) {
#pragma unroll
      for (int j = 0; j < V; ++j) y[j] = relu(y[j]);
    } else if (epilogue == EPI_RESIDUAL) {
      float r[V];
      Vec<T>::load(res + base + c, r);
#pragma unroll
      for (int j = 0; j < V; ++j) y[j] = relu(__fadd_rn(r[j], Vec<T>::round(y[j])));
    }
    Vec<T>::store(out + base + c, y);
  }
}

// Rows are dealt to the grid's row groups in turn (a grid-stride loop);
// ``part`` receives each block's float32 partial dgamma [gridDim.x, C] then
// dbeta [gridDim.x, C].
template <typename T, int C>
__global__ void __launch_bounds__(THREADS) layer_norm_backward_kernel(
    const T* __restrict__ dout, const T* __restrict__ x, const T* __restrict__ res,
    const float* __restrict__ gamma, const float* __restrict__ beta, T* __restrict__ dx,
    T* __restrict__ dres, float* __restrict__ part, long long rows, int epilogue) {
  using R = Rows<T, C>;
  constexpr int V = R::V;
  __shared__ float red[2][R::PER_BLOCK][C];
  const int sub = threadIdx.x % R::LANES;
  const int grp = threadIdx.x / R::LANES;

  float g[R::ITEMS][V], dg[R::ITEMS][V], db[R::ITEMS][V];
#pragma unroll
  for (int k = 0; k < R::ITEMS; ++k) {
    load_params<V>(gamma + (k * R::LANES + sub) * V, g[k]);
#pragma unroll
    for (int j = 0; j < V; ++j) dg[k][j] = db[k][j] = 0.0f;
  }

  const long long stride = (long long)gridDim.x * R::PER_BLOCK;
  // ``first`` is the block's: every lane runs the same trips
  for (long long first = (long long)blockIdx.x * R::PER_BLOCK; first < rows; first += stride) {
    const long long row = first + grp;
    const bool live = row < rows;
    const long long base = row * C;
    float dy[R::ITEMS][V], xh[R::ITEMS][V];
#pragma unroll
    for (int k = 0; k < R::ITEMS; ++k) {
      const int c = (k * R::LANES + sub) * V;
      if (live) {
        Vec<T>::load(dout + base + c, dy[k]);
        Vec<T>::load(x + base + c, xh[k]);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) dy[k][j] = xh[k][j] = 0.0f;
      }
    }
    const float2 st = row_stats<T, C>(xh);
    float a = 0.0f, b = 0.0f;
#pragma unroll
    for (int k = 0; k < R::ITEMS; ++k) {
      const int c = (k * R::LANES + sub) * V;
      if (live && epilogue != EPI_NONE) {  // the forward's out > 0
        float bt[V], r[V];
        load_params<V>(beta + c, bt);
        if (epilogue == EPI_RESIDUAL) Vec<T>::load(res + base + c, r);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          float y = Vec<T>::round(affine(xh[k][j], st, g[k][j], bt[j]));
          if (epilogue == EPI_RESIDUAL) y = __fadd_rn(r[j], y);
          dy[k][j] = y > 0.0f ? dy[k][j] : 0.0f;
        }
        if (epilogue == EPI_RESIDUAL) Vec<T>::store(dres + base + c, dy[k]);  // exact in T
      }
#pragma unroll
      for (int j = 0; j < V; ++j) {
        xh[k][j] = (xh[k][j] - st.x) * st.y;
        const float gj = dy[k][j] * g[k][j];
        a += gj;
        b += gj * xh[k][j];
        dg[k][j] += dy[k][j] * xh[k][j];
        db[k][j] += dy[k][j];
      }
    }
    a = row_sum<R::LANES>(a) * (1.0f / C);
    b = row_sum<R::LANES>(b) * (1.0f / C);
    if (!live) continue;
#pragma unroll
    for (int k = 0; k < R::ITEMS; ++k) {
      float d[V];
#pragma unroll
      for (int j = 0; j < V; ++j) d[j] = st.y * (dy[k][j] * g[k][j] - a - xh[k][j] * b);
      Vec<T>::store(dx + base + (k * R::LANES + sub) * V, d);
    }
  }

  // the block's partials: its row groups summed in group order
#pragma unroll
  for (int k = 0; k < R::ITEMS; ++k) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = (k * R::LANES + sub) * V + j;
      red[0][grp][c] = dg[k][j];
      red[1][grp][c] = db[k][j];
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < 2 * C; t += THREADS) {
    const int which = t / C, c = t % C;
    float s = 0.0f;
    for (int q = 0; q < R::PER_BLOCK; ++q) s += red[which][q][c];
    part[((long long)which * gridDim.x + blockIdx.x) * C + c] = s;
  }
}

// dgamma and dbeta from the blocks' partials: a warp a (output, channel),
// lane l summing blocks l, l + 32, ... in order, then a fixed shuffle tree.
__global__ void __launch_bounds__(THREADS) layer_norm_param_grad_kernel(
    const float* __restrict__ part, int blocks, int channels, float* __restrict__ dgamma,
    float* __restrict__ dbeta) {
  const int lane = threadIdx.x % WARP;
  const int w = blockIdx.x * (THREADS / WARP) + threadIdx.x / WARP;
  if (w >= 2 * channels) return;  // the whole warp
  const int which = w / channels, c = w % channels;
  const float* p = part + (long long)which * blocks * channels + c;
  float s = 0.0f;
  for (int q = lane; q < blocks; q += WARP) s += p[(long long)q * channels];
#pragma unroll
  for (int o = WARP / 2; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
  if (lane == 0) (which == 0 ? dgamma : dbeta)[c] = s;
}

struct ForwardArgs {
  const void* x;
  const float* gamma;
  const float* beta;
  const void* res;
  void* out;
  long long rows;
  int epilogue;
  cudaStream_t stream;
};

struct BackwardArgs {
  const void* dout;
  const void* x;
  const void* res;
  const float* gamma;
  const float* beta;
  void* dx;
  void* dres;
  float* part;
  float* dgamma;
  float* dbeta;
  int max_blocks;
  long long rows;
  int epilogue;
  cudaStream_t stream;
};

struct Forward {
  template <typename T, int C>
  static int run(const ForwardArgs& a) {
    using R = Rows<T, C>;
    if (a.rows == 0) return 0;
    const long long blocks = (a.rows + R::PER_BLOCK - 1) / R::PER_BLOCK;
    layer_norm_forward_kernel<T, C><<<(unsigned)blocks, THREADS, 0, a.stream>>>(
        (const T*)a.x, a.gamma, a.beta, (const T*)a.res, (T*)a.out, a.rows, a.epilogue);
    return (int)cudaGetLastError();
  }
};

struct Backward {
  template <typename T, int C>
  static int run(const BackwardArgs& a) {
    using R = Rows<T, C>;
    long long blocks = (a.rows + R::PER_BLOCK - 1) / R::PER_BLOCK;
    if (blocks > a.max_blocks) blocks = a.max_blocks;
    if (blocks > 0) {
      layer_norm_backward_kernel<T, C><<<(unsigned)blocks, THREADS, 0, a.stream>>>(
          (const T*)a.dout, (const T*)a.x, (const T*)a.res, a.gamma, a.beta, (T*)a.dx,
          (T*)a.dres, a.part, a.rows, a.epilogue);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    const int warps_per_block = THREADS / WARP;
    layer_norm_param_grad_kernel<<<(2 * C + warps_per_block - 1) / warps_per_block, THREADS, 0,
                                   a.stream>>>(a.part, (int)blocks, C, a.dgamma, a.dbeta);
    return (int)cudaGetLastError();
  }
};

// F::run<T, C>(args) for the runtime (dtype, channels): dtype 0 float32,
// 1 bfloat16; channels 8-256, a power of two.
template <class F, typename T, class A>
int by_channels(int channels, const A& a) {
  switch (channels) {
    case 8: return F::template run<T, 8>(a);
    case 16: return F::template run<T, 16>(a);
    case 32: return F::template run<T, 32>(a);
    case 64: return F::template run<T, 64>(a);
    case 128: return F::template run<T, 128>(a);
    case 256: return F::template run<T, 256>(a);
  }
  return (int)cudaErrorInvalidValue;
}

template <class F, class A>
int dispatch(int dtype, int channels, const A& a) {
  if (a.rows < 0 || a.epilogue < EPI_NONE || a.epilogue > EPI_RESIDUAL) {
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 0) return by_channels<F, float>(channels, a);
  if (dtype == 1) return by_channels<F, __nv_bfloat16>(channels, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Launch S2a on ``stream``; returns a CUDA error code (0 = ok).  x, res and
// out are [rows, channels] of the type ``dtype`` names, gamma and beta
// float32 [channels], every pointer 16-byte aligned; ``res`` is read under
// the residual epilogue only.
int twixt_layer_norm_forward(const void* x, const void* gamma, const void* beta,
                             const void* res, void* out, long long rows, int channels,
                             int dtype, int epilogue, void* stream) {
  const ForwardArgs a{x,    (const float*)gamma, (const float*)beta, res,
                      out,  rows,                epilogue,           (cudaStream_t)stream};
  return dispatch<Forward>(dtype, channels, a);
}

// Launch S2b (two kernels) on ``stream``.  dout, x, res, dx and dres as x
// above (``res`` read and ``dres`` written under the residual epilogue
// only); gamma and beta the forward's; ``part`` float32 [2, max_blocks,
// channels] of scratch; dgamma and dbeta float32 [channels].  The grid is at
// most ``max_blocks`` blocks, fixed by rows and channels, so the sums'
// order is too.
int twixt_layer_norm_backward(const void* dout, const void* x, const void* res,
                              const void* gamma, const void* beta, void* dx, void* dres,
                              void* part, void* dgamma, void* dbeta, int max_blocks,
                              long long rows, int channels, int dtype, int epilogue,
                              void* stream) {
  if (max_blocks < 1) return (int)cudaErrorInvalidValue;
  const BackwardArgs a{dout,           x,
                       res,            (const float*)gamma,
                       (const float*)beta, dx,
                       dres,           (float*)part,
                       (float*)dgamma, (float*)dbeta,
                       max_blocks,     rows,
                       epilogue,       (cudaStream_t)stream};
  return dispatch<Backward>(dtype, channels, a);
}

const char* twixt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
