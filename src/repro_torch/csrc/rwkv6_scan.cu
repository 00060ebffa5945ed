// RWKV-6 chunked WKV scan for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_scan/rwkv6_scan.py
// (rwkv6_scan_kernel, body _rwkv_kernel): the data-dependent per-channel
// decay recurrence
//     S_t = diag(w_t) S_{t-1} + k_t^T v_t,    y_t = r_t S_{t-1},
// computed chunk by chunk. Inside a chunk of Lc tokens, with cum the
// inclusive cumulative sum of log_w over the chunk and cum_{t-1} = cum - log_w,
//     A[t,i] = sum_c r[t,c] k[i,c] exp(cum_{t-1,c} - cum_{i,c})   (i < t)
//     y      = A v + (r * exp(cum_{t-1})) S
//     S     <- S * exp(cum_last) + (k * exp(cum_last - cum))^T v.
// Every exponent is a difference that is <= 0, as in the reference, so
// strong decays (log_w = -30) underflow to 0 and never overflow; the
// "factored" form (r e^{cum}) (k e^{-cum})^T would take exp(480) there.
// The bonus-u diagonal is added by the wrapper, outside the kernel, as in
// the reference.
//
// What bounds it on this card: a launch reads r, k, v, log_w (BH x S x hs
// fp32 each) and s0, and writes y and the final state: 88,080,384 bytes at
// the serving shape (BH 128 = batch 4 x 32 heads, S 512, hs 64), 0.026 ms at
// 3.35 TB/s. Its arithmetic, about 1.3 GFLOP of fp32 there, is 0.020 ms at
// the 67 TFLOP/s fp32 rate outside the tensor cores, so the bound is bytes.
// The recurrence is serial over chunks; TF32 tensor cores would miss the
// reference's 1e-4, so everything runs in fp32 on the CUDA cores.
//
// Design, against the TPU kernel's:
// - The TPU walks its grid (BH, n_chunks) in order and carries the state in
//   VMEM scratch. Here one thread block owns one bh row and loops over its
//   chunks itself: 128 blocks at the serving shape, on 132 SMs.
// - The (hs x hs) state lives in registers: thread (column v, group g) of
//   the 4 * hs threads holds S[4j + g][v] for j < hs / 4. y[t][v] sums each
//   group's share of the k axis and reduces the four with two shuffles; the
//   state update touches only the thread's own entries, so no barrier
//   guards the state between the two.
// - The chunk tiles of r, k, v, log_w, cum, r * exp(cum_{t-1}) and
//   k * exp(cum_last - cum), and A, live in shared memory (34 KB at chunk 16,
//   135 KB at chunk 64). A is computed pair by pair on the fly: the
//   (Lc, Lc, hs) decay tensor of the reference is never formed.
// - Rows of the tiles are padded (hs + 1 floats; hs + 8 for v) so that the
//   reads of A's pairs and of v's columns fall in distinct banks.
// - Not yet fast: 32 chunks run one after another in each block, with four
//   barriers a chunk and the next chunk's loads not in flight while the
//   current one computes.
//
// C interface (loaded with ctypes): rwkv6_scan_fwd(...) launches on the
// given stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kMaxChunk = 64;
constexpr int kGroups = 4;  // threads that share one state column

int smem_bytes(int hs, int lc) {
  return (6 * lc * (hs + 1) + lc * (hs + 8) + lc * lc) * (int)sizeof(float);
}

template <int HS>
__global__ void __launch_bounds__(kGroups * HS)
    rwkv6_scan_kernel(const float* __restrict__ r, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ lw,
                      const float* __restrict__ s0, float* __restrict__ y,
                      float* __restrict__ sT, int S, int lc) {
  constexpr int P = HS + 1;   // row stride of r, k, log_w, cum, rq, kd
  constexpr int PV = HS + 8;  // row stride of v
  constexpr int NT = kGroups * HS;
  constexpr int J = HS / kGroups;
  extern __shared__ float smem[];
  float* r_s = smem;
  float* k_s = r_s + lc * P;
  float* w_s = k_s + lc * P;
  float* c_s = w_s + lc * P;   // inclusive cumsum of log_w over the chunk
  float* rq_s = c_s + lc * P;  // r * exp(cum_{t-1})
  float* kd_s = rq_s + lc * P; // k * exp(cum_last - cum)
  float* v_s = kd_s + lc * P;
  float* a_s = v_s + lc * PV;  // A[t][i], lc x lc

  const int tid = threadIdx.x;
  const int col = tid / kGroups;
  const int g = tid % kGroups;
  const size_t bh = blockIdx.x;
  const float* sb = s0 + bh * HS * HS;

  float st[J];
#pragma unroll
  for (int j = 0; j < J; ++j) st[j] = sb[(kGroups * j + g) * HS + col];

  const int n = lc * HS;  // floats of one chunk tile, contiguous in memory
  const float* last = c_s + (lc - 1) * P;
  for (int c0 = 0; c0 < S; c0 += lc) {
    const size_t off = (bh * S + c0) * HS;
    for (int e = tid * 4; e < n; e += NT * 4) {
      const int t = e / HS, c = e % HS;
      const float4 a = *reinterpret_cast<const float4*>(r + off + e);
      const float4 b = *reinterpret_cast<const float4*>(k + off + e);
      const float4 w = *reinterpret_cast<const float4*>(lw + off + e);
      const float4 x = *reinterpret_cast<const float4*>(v + off + e);
      float* rp = r_s + t * P + c;
      float* kp = k_s + t * P + c;
      float* wp = w_s + t * P + c;
      float* vp = v_s + t * PV + c;
      rp[0] = a.x; rp[1] = a.y; rp[2] = a.z; rp[3] = a.w;
      kp[0] = b.x; kp[1] = b.y; kp[2] = b.z; kp[3] = b.w;
      wp[0] = w.x; wp[1] = w.y; wp[2] = w.z; wp[3] = w.w;
      vp[0] = x.x; vp[1] = x.y; vp[2] = x.z; vp[3] = x.w;
    }
    __syncthreads();

    if (tid < HS) {
      float acc = 0.f;
      for (int t = 0; t < lc; ++t) {
        acc += w_s[t * P + tid];
        c_s[t * P + tid] = acc;
      }
    }
    __syncthreads();

    for (int p = tid; p < lc * lc; p += NT) {
      const int t = p / lc, i = p % lc;
      if (i >= t) continue;  // strictly causal: y reads A[t][i] for i < t
      const float* rt = r_s + t * P;
      const float* ct = c_s + t * P;
      const float* wt = w_s + t * P;
      const float* ki = k_s + i * P;
      const float* ci = c_s + i * P;
      float acc = 0.f;
#pragma unroll 8
      for (int c = 0; c < HS; ++c)
        acc += rt[c] * ki[c] * expf((ct[c] - wt[c]) - ci[c]);
      a_s[t * lc + i] = acc;
    }
    for (int e = tid; e < n; e += NT) {
      const int t = e / HS, c = e % HS;
      const int x = t * P + c;
      rq_s[x] = r_s[x] * expf(c_s[x] - w_s[x]);
      kd_s[x] = k_s[x] * expf(last[c] - c_s[x]);
    }
    __syncthreads();

    for (int t = 0; t < lc; ++t) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < J; ++j) acc += rq_s[t * P + kGroups * j + g] * st[j];
      for (int i = g; i < t; i += kGroups) acc += a_s[t * lc + i] * v_s[i * PV + col];
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if ((t % kGroups) == g) y[off + t * HS + col] = acc;
    }
#pragma unroll
    for (int j = 0; j < J; ++j) st[j] *= expf(last[kGroups * j + g]);
    for (int i = 0; i < lc; ++i) {
      const float vi = v_s[i * PV + col];
#pragma unroll
      for (int j = 0; j < J; ++j) st[j] += kd_s[i * P + kGroups * j + g] * vi;
    }
    __syncthreads();  // the next chunk overwrites the tiles
  }

  float* tb = sT + bh * HS * HS;
#pragma unroll
  for (int j = 0; j < J; ++j) tb[(kGroups * j + g) * HS + col] = st[j];
}

template <int HS>
cudaError_t launch(const float* r, const float* k, const float* v,
                   const float* lw, const float* s0, float* y, float* sT,
                   int BH, int S, int lc, cudaStream_t stream) {
  const int smem = smem_bytes(HS, lc);
  cudaError_t e = cudaFuncSetAttribute(
      rwkv6_scan_kernel<HS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  rwkv6_scan_kernel<HS><<<BH, kGroups * HS, smem, stream>>>(r, k, v, lw, s0, y,
                                                            sT, S, lc);
  return cudaGetLastError();
}

}  // namespace

// r, k, v, log_w, y: (BH, S, hs) fp32, contiguous, 16-byte aligned; s0, sT:
// (BH, hs, hs) fp32. hs in {16, 32, 64}; 1 <= chunk <= 64 and S % chunk == 0.
// Returns a cudaError_t.
extern "C" int rwkv6_scan_fwd(const void* r, const void* k, const void* v,
                              const void* log_w, const void* s0, void* y,
                              void* sT, int BH, int S, int hs, int chunk,
                              void* stream) {
  if (BH <= 0 || S <= 0 || chunk < 1 || chunk > kMaxChunk || S % chunk)
    return cudaErrorInvalidValue;
  const float* rf = static_cast<const float*>(r);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* wf = static_cast<const float*>(log_w);
  const float* sf = static_cast<const float*>(s0);
  float* yf = static_cast<float*>(y);
  float* tf = static_cast<float*>(sT);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hs) {
    case 16: return launch<16>(rf, kf, vf, wf, sf, yf, tf, BH, S, chunk, s);
    case 32: return launch<32>(rf, kf, vf, wf, sf, yf, tf, BH, S, chunk, s);
    case 64: return launch<64>(rf, kf, vf, wf, sf, yf, tf, BH, S, chunk, s);
    default: return cudaErrorInvalidValue;
  }
}
