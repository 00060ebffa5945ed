// Routed-expert GLU FFN of the dropless MoE decode (K5), Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves the expert products to
// XLA, as three batched products over every expert (models/moe.py
// _expert_ffn). At a decode's few tokens a dropless capacity is C = T, so
// those products read all E experts' weights while top-k routes each
// token to k of them, and the unrouted experts' rows are zeros with
// weight zero. This kernel computes only the routed ones: for each
// assignment a (a token and one of its k experts, e = ids[a]),
//     out[a] = (act(x_a W_gate[e]) * (x_a W_up[e])) W_down[e],
// accumulated in fp32 and rounded to the weights' type T where the dense
// path rounds: each of the two products, the activation, their product
// and the down product. act is silu or tanh-gelu, computed as PyTorch's
// CUDA activations compute them. T is bf16 or fp32.
//
// What bounds it on this card: bytes. At batch 1 each weight is used
// once (about 1 FLOP a byte, against the ~295 FLOP a byte at which bf16
// tensor cores become the limit), so the least time is the routed
// experts' weights over 3.35 TB/s: Mixtral's top-2 of experts 4096 x
// 14336 read 704.6 MB a layer (0.210 ms), Granite's top-10 of experts
// 4096 x 768 read 188.7 MB (0.056 ms). A dense all-expert product reads
// 2,818 MB / 1,359 MB.
//
// Design:
// - Every weight matrix is read as x^T W with W (K, N) row-major: the
//   contiguous axis is N, the outputs (f for W_gate / W_up, d for
//   W_down), so a warp reads one row's 32 x 16 bytes in one coalesced
//   sweep and each thread keeps 8 (bf16) or 4 (fp32) output sums.
// - Each block loads its own expert id from device memory: nothing is read
//   on the host, so the launches are captured in a CUDA graph and
//   replayed with new ids.
// - The reduction axis K is split over blocks (grid: column tile, split,
//   assignment and matrix), so that about a thousand blocks stream at
//   once at both shapes: Mixtral's down product has only 4096 outputs over
//   a depth of 14336, Granite's up product 768 outputs over 4096. Eight
//   warps a block take every eighth row of the block's split, eight rows
//   in flight a warp, with 16-byte loads that do not allocate in L1.
// - The splits' fp32 partial sums go to scratch and are summed later in
//   a fixed order (the warps of a block in warp order, the splits in
//   split order): no atomics, so a decode gives the same bits every run.
//   Four launches: the gate and up products; their sums, the activation
//   and the product (the inner rows, in T); the down product; its sums,
//   rounded to T.
// - The inputs' rows are read through a row stride, so the k assignments
//   of one token can share one row (a stride of 0).
// - The weights may hold a share of the experts, e0 .. e0 + E - 1 (an
//   expert-parallel share on one card): a block whose assignment's
//   expert lies outside it reads no weight and writes zero partial sums,
//   so that row's output is zero. The test is on the device, so a
//   captured graph skips whatever experts its replay's ids name.
// - The last three launches are programmatic dependent launches: each
//   kernel lets the next one start once all its blocks run, and the next
//   waits (griddepcontrol.wait) before it reads what came before, so
//   the launches' gaps are hidden. The down product first asks L2 for
//   its first weight rows, which depend on nothing before it.
//
// C interface (loaded with ctypes): moe_decode_ffn(...) launches on the
// given stream, allocates nothing (the wrapper hands it scratch) and
// returns the first cudaError of its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kInFlight = 8;  // rows a warp has in flight

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T, back in fp32
template <typename T>
__device__ __forceinline__ float rounded(float v) {
  return to_f(from_f<T>(v));
}

// lets the next launch in the stream start once every block of this one
// has begun (it waits in wait_inputs before reading what this one writes)
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// waits until the launches this one depends on have finished and their
// writes show (at once where it was launched the ordinary way)
__device__ __forceinline__ void wait_inputs() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// 16 bytes of weights, streamed: read once, kept out of L1
__device__ __forceinline__ uint4 ld_stream(const void* p) {
  uint4 r;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p));
  return r;
}

// acc[i] += x * w[i] over the 16 bytes' 4 (fp32) or 8 (bf16) values
template <typename T>
__device__ __forceinline__ void fma16(float* acc, const uint4& w, float x);
template <>
__device__ __forceinline__ void fma16<float>(float* acc, const uint4& w,
                                             float x) {
  acc[0] = fmaf(x, __uint_as_float(w.x), acc[0]);
  acc[1] = fmaf(x, __uint_as_float(w.y), acc[1]);
  acc[2] = fmaf(x, __uint_as_float(w.z), acc[2]);
  acc[3] = fmaf(x, __uint_as_float(w.w), acc[3]);
}
template <>
__device__ __forceinline__ void fma16<__nv_bfloat16>(float* acc,
                                                     const uint4& w,
                                                     float x) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    acc[2 * i] = fmaf(x, f.x, acc[2 * i]);
    acc[2 * i + 1] = fmaf(x, f.y, acc[2 * i + 1]);
  }
}

struct Gemv {
  const void* x;         // (A, K) of T, rows x_stride apart
  long long x_stride;    // elements between assignments' rows
  const long long* ids;  // (A,) the expert of each assignment
  long long e0;          // the first expert the weights hold
  long long E;           // experts held
  const void* w0;        // (E, K, N) of T
  const void* w1;        // a second matrix on the same rows, or null
  float* part;           // (M, A, S, N): M matrices
  int A, K, N, S, R;     // R rows a split (S = ceil(K / R))
};

__device__ __forceinline__ float silu(float v) {
  return v / (1.f + expf(-v));
}

__device__ __forceinline__ float gelu_tanh(float v) {
  const float beta = 0.7978845608028654f;  // sqrt(2 / pi)
  const float kappa = 0.044715f;
  return 0.5f * v * (1.f + tanhf(beta * (v + kappa * v * v * v)));
}

// T(T(act(T(gate))) * T(up)): the inner row's value, rounded where the
// dense path rounds
template <typename T>
__device__ __forceinline__ float glu_value(float gate, float up, int act) {
  const float g = rounded<T>(gate);
  const float h = rounded<T>(act ? gelu_tanh(g) : silu(g));
  return rounded<T>(h * rounded<T>(up));
}

// part[m, a, s, n] = sum over the split's rows k of x[a, k] W_m[e, k, n],
// for M = 1 or 2 matrices
template <typename T, int M>
__global__ void __launch_bounds__(kThreads) moe_decode_gemv(const Gemv p) {
  constexpr int V = 16 / sizeof(T);  // values a 16-byte load holds
  constexpr int TILE = 32 * V;       // columns a block covers
  const int s = blockIdx.y;
  const int m = M == 1 ? 0 : blockIdx.z / p.A;
  const int a = M == 1 ? blockIdx.z : blockIdx.z % p.A;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * TILE + lane * V;
  launch_dependents();
  // the ids were written before the first of K5's launches began
  const long long e = p.ids[a] - p.e0;
  // an expert not held: no weight read, zero partial sums
  const bool held = e >= 0 && e < p.E;
  const T* w = static_cast<const T*>(m ? p.w1 : p.w0) +
               (held ? e : 0) * static_cast<long long>(p.K) * p.N + n0;
  const T* x = static_cast<const T*>(p.x) + a * p.x_stride;
  const int k0 = s * p.R, k1 = min(p.K, k0 + p.R);
  const long long step = static_cast<long long>(kWarps) * p.N;
  int k = k0 + warp;
  const T* wk = w + static_cast<long long>(k) * p.N;
  const bool reads = held && n0 < p.N;
  if (reads) {
#pragma unroll
    for (int u = 0; u < kInFlight; ++u)
      if (k + u * kWarps < k1) prefetch_l2(wk + u * step);
  }
  wait_inputs();
  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;
  if (reads) {
    // a split's last rows may not fill a group: those loads are skipped
    for (; k < k1; k += kInFlight * kWarps, wk += kInFlight * step) {
      uint4 wv[kInFlight];
      float xv[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        if (k + u * kWarps < k1) {
          wv[u] = ld_stream(wk + u * step);
          xv[u] = to_f(x[k + u * kWarps]);
        }
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u)
        if (k + u * kWarps < k1) fma16<T>(acc, wv[u], xv[u]);
    }
  }
  __shared__ float red[kWarps][TILE];
#pragma unroll
  for (int i = 0; i < V; ++i) red[warp][lane * V + i] = acc[i];
  __syncthreads();
  for (int c = threadIdx.x; c < TILE; c += kThreads) {
    const int n = blockIdx.x * TILE + c;
    if (n < p.N) {
      float t = red[0][c];
#pragma unroll
      for (int w2 = 1; w2 < kWarps; ++w2) t += red[w2][c];
      p.part[(static_cast<long long>(blockIdx.z) * p.S + s) * p.N + n] = t;
    }
  }
}

// inner[a, n] = T(T(act(T(gate))) * T(up)), gate and up the sums over s
// of part[0, a, s, n] and part[1, a, s, n]
template <typename T>
__global__ void __launch_bounds__(kThreads)
    moe_decode_glu(const float* part, T* inner, int A, int S, int N,
                   int act) {
  launch_dependents();
  wait_inputs();
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= static_cast<long long>(A) * N) return;
  const long long a = i / N, n = i % N;
  const float* g = part + a * S * N + n;
  const float* u = g + static_cast<long long>(A) * S * N;
  float gs = 0.f, us = 0.f;
  for (int s = 0; s < S; ++s) {
    gs += g[static_cast<long long>(s) * N];
    us += u[static_cast<long long>(s) * N];
  }
  inner[i] = from_f<T>(glu_value<T>(gs, us, act));
}

// out[a, n] = T(sum_s part[a, s, n])
template <typename T>
__global__ void __launch_bounds__(kThreads)
    moe_decode_sum(const float* part, T* out, int A, int S, int N) {
  wait_inputs();
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= static_cast<long long>(A) * N) return;
  const long long a = i / N, n = i % N;
  const float* q = part + a * S * N + n;
  float t = 0.f;
  for (int s = 0; s < S; ++s) t += q[static_cast<long long>(s) * N];
  out[i] = from_f<T>(t);
}

// launches kernel on the stream, where ``after`` as a programmatic
// dependent launch (see launch_dependents / wait_inputs)
template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), dim3 grid, cudaStream_t st,
                   bool after, Args... args) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = after ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
int ffn(const void* x, long long x_stride, const long long* ids,
        const void* w_gate, const void* w_up, const void* w_down,
        float* part_up, void* inner, float* part_down, void* out, int A,
        int d, int f, int s_up, int r_up, int s_down, int r_down, int e0,
        int E, int act, cudaStream_t st) {
  constexpr int TILE = 32 * (16 / sizeof(T));
  const Gemv up{x, x_stride, ids, e0, E, w_gate, w_up, part_up,
                A, d, f, s_up, r_up};
  cudaError_t err = launch(moe_decode_gemv<T, 2>,
                           dim3((f + TILE - 1) / TILE, s_up, 2 * A), st,
                           false, up);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch(moe_decode_glu<T>, dim3((A * f + kThreads - 1) / kThreads),
               st, true, static_cast<const float*>(part_up),
               static_cast<T*>(inner), A, s_up, f, act);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Gemv down{inner, f, ids, e0, E, w_down, nullptr, part_down,
                  A, f, d, s_down, r_down};
  err = launch(moe_decode_gemv<T, 1>, dim3((d + TILE - 1) / TILE, s_down, A),
               st, true, down);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch(moe_decode_sum<T>, dim3((A * d + kThreads - 1) / kThreads),
               st, true, static_cast<const float*>(part_down),
               static_cast<T*>(out), A, s_down, d);
  return static_cast<int>(err);
}

}  // namespace

// x: (A, d) rows x_stride elements apart; ids: (A,) int64; w_gate, w_up:
// (E, d, f); w_down: (E, f, d); part_up: (2, A, s_up, f) fp32; inner: (A,
// f) of the weights' type; part_down: (A, s_down, d) fp32; out: (A, d).
// r_up / r_down: rows of each split, s_up = ceil(d / r_up), s_down =
// ceil(f / r_down). e0, E: the weights hold experts e0 .. e0 + E - 1; an
// assignment to another gives a zero row. act: 0 silu, 1 tanh-gelu. bf16:
// 1 for bfloat16 tensors, 0 for float32.
extern "C" int moe_decode_ffn(const void* x, long long x_stride,
                              const long long* ids, const void* w_gate,
                              const void* w_up, const void* w_down,
                              float* part_up, void* inner, float* part_down,
                              void* out, int A, int d, int f, int s_up,
                              int r_up, int s_down, int r_down, int e0,
                              int E, int act, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return ffn<__nv_bfloat16>(x, x_stride, ids, w_gate, w_up, w_down,
                              part_up, inner, part_down, out, A, d, f, s_up,
                              r_up, s_down, r_down, e0, E, act, st);
  return ffn<float>(x, x_stride, ids, w_gate, w_up, w_down, part_up, inner,
                    part_down, out, A, d, f, s_up, r_up, s_down, r_down, e0,
                    E, act, st);
}
