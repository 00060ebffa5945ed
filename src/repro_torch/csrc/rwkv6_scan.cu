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
// What bounds it on this card: a launch reads r, k, v, log_w (B x S x H x hs
// fp32 each) and s0, and writes y and the final state: 88,080,384 bytes at
// the serving shape (batch 4 x 32 heads, S 512, hs 64), 0.026 ms at
// 3.35 TB/s. Its arithmetic, about 1.4 GFLOP of fp32 there, is 0.020 ms at
// the 67 TFLOP/s fp32 rate outside the tensor cores, so the bound is bytes.
// The recurrence is serial over chunks; TF32 tensor cores would miss the
// reference's 1e-4, so everything runs in fp32 on the CUDA cores.
//
// Design, against the TPU kernel's:
// - The TPU walks its grid (BH, n_chunks) in order and carries the state in
//   VMEM scratch. Here a block of 512 threads owns the value columns of one
//   (batch, head) row (all of them where the tiles fit in shared memory, as
//   at the serving shape; half of them at chunk 64) and loops over its
//   chunks. Splitting a row's columns over more blocks (column v of S and
//   of y depends on v's column alone given r, k and log_w) gave more blocks
//   than SMs but measured slower on the H100 (PERF.md): every block must
//   take the cumulative sums and A for its chunks again, and each block's
//   chain of chunks is no shorter. 512 threads keep 16 warps on an SM.
// - Inputs are read in the (B, S, H, hs) layout the model's projections
//   produce, through the strides the wrapper passes, and y is written in it:
//   no fold or transpose copy around the kernel.
// - The next chunk's r, k, log_w and v tiles are copied into a second
//   buffer with cp.async while the current chunk computes.
// - log_w is scaled by log2(e) as its cumulative sum is taken, so every
//   exponential is one ex2.approx (a single MUFU op) of a difference <= 0.
//   The sum runs in parallel (512 / hs threads a channel, each over a run
//   of rows, then the runs' totals), arranged so that adjacent rows decay
//   by exactly exp2(0) across a run's boundary as inside it.
// - A runs on every thread: eight lanes share one (t, i) pair from a table
//   of pairs, each over 16-byte slices of the channels, and reduce with
//   three shuffles.
// - Each thread owns a 4 x 4 block of the state in registers and mirrors it
//   into shared memory (double-buffered by chunk parity). Its update is 16
//   FMAs per two 16-byte loads; y's term r S is a register-tiled product
//   (two rows by four columns a thread, eight FMAs per 16-byte load of S),
//   computed in the same phase as A and the update, so that the MUFU, the
//   FMA pipe and shared memory work side by side; A v is added after A.
//   Three barriers a chunk, plus one inside the cumulative sum.
//
// C interface (loaded with ctypes): rwkv6_scan_fwd(...) launches on the
// given stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kMaxChunk = 64;
constexpr int kThreads = 512;
constexpr int kMaxSmem = 232448;  // bytes a block may use on an H100
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const float* in[4];       // r, k, v, log_w
  float* y;
  const float* s0;
  float* sT;
  long long sb[5], ss[5], sh[5];  // element strides of r, k, v, log_w, y
  int H, S, lc, nsplit;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void fma4(float4& acc, float a, const float4& b) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

// A's tile, rounded up so that the state after it stays 16-byte aligned
__host__ __device__ constexpr int a_floats(int lc) {
  return (lc * lc + 3) & ~3;
}

template <int HS, int NC>
constexpr int smem_bytes(int lc) {
  // double-buffered r, k, log_w (rows padded to HS + 8) and v (NC + 4);
  // cum, r * exp(cum_{t-1}), k * exp(cum_last - cum); A; the state
  // (HS x NC) twice, by chunk parity; the cumsum's part totals; the
  // table of A's (t, i) pairs (16 bits each)
  return (2 * (3 * lc * (HS + 8) + lc * (NC + 4)) + 3 * lc * (HS + 8) +
          a_floats(lc) + 2 * HS * NC + kThreads + a_floats(lc) / 2) *
         static_cast<int>(sizeof(float));
}

template <int HS, int NC>
__global__ void __launch_bounds__(kThreads)
    rwkv6_scan_kernel(const Params p) {
  constexpr int P = HS + 8;   // row stride of r, k, log_w, cum, rq, kd
  constexpr int PV = NC + 4;  // row stride of v
  constexpr int NQ = NC / 4;  // column quads of this block
  constexpr int L = HS / 4 < 8 ? HS / 4 : 8;  // lanes sharing a pair of A
  constexpr int CL = HS / (4 * L);            // float4s a lane reads a row
  constexpr int MT =  // y tasks a thread
      (kMaxChunk / 2 * NQ + kThreads - 1) / kThreads;
  static_assert(HS / 4 * NQ <= kThreads, "more state blocks than threads");
  extern __shared__ __align__(16) float smem[];
  const int lc = p.lc;
  const int bufsz = 3 * lc * P + lc * PV;  // one buffer of chunk tiles
  float* c_s = smem + 2 * bufsz;           // inclusive cum, base 2
  float* rq_s = c_s + lc * P;              // r * exp(cum_{t-1})
  float* kd_s = rq_s + lc * P;             // k * exp(cum_last - cum)
  float* a_s = kd_s + lc * P;              // A[t][i], lc x lc
  float* s_s = a_s + a_floats(lc);         // the state, 2 x (HS x NC)
  float* tot_s = s_s + 2 * HS * NC;        // cumsum totals, part x HS
  unsigned short* pair_s =                 // A's pairs, t << 8 | i
      reinterpret_cast<unsigned short*>(tot_s + kThreads);

  const int tid = threadIdx.x;
  const int bh = blockIdx.x / p.nsplit;
  const int c0 = (blockIdx.x % p.nsplit) * NC;  // first value column
  const int b = bh / p.H, h = bh % p.H;
  // r, k, log_w, v of this (batch, head) row, and their sequence strides
  const float* src[4];
  long long sstep[4];
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int in = x < 2 ? x : (x == 2 ? 3 : 2);
    src[x] = p.in[in] + b * p.sb[in] + h * p.sh[in];
    sstep[x] = p.ss[in];
  }
  src[3] += c0;
  float* yg = p.y + b * p.sb[4] + h * p.sh[4] + c0;

  // copy chunk n's tiles into buffer n & 1 (16 bytes a cp.async)
  auto load = [&](int n) {
    float* dst = smem + (n & 1) * bufsz;
    const int t0 = n * lc;
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int w4 = x < 3 ? HS / 4 : NQ;   // 16-byte pieces a row
      const int stride = x < 3 ? P : PV;
      for (int e = tid; e < lc * w4; e += kThreads) {
        const int t = e / w4, c = (e % w4) * 4;
        cp16(dst + x * lc * P + t * stride + c,
             src[x] + (t0 + t) * sstep[x] + c);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  // this thread's 4 x 4 block of the state (rows 4 kb.., columns 4 cb..),
  // in registers, mirrored into shared memory for y's products
  const bool owner = tid < HS / 4 * NQ;
  const int kb = tid / NQ, cb = tid % NQ;
  float4 st[4];
  const size_t s_off = static_cast<size_t>(bh) * HS * HS + 4 * kb * HS + c0 +
                       4 * cb;
  if (owner) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      st[r] = ld4(p.s0 + s_off + r * HS);
      *reinterpret_cast<float4*>(s_s + (4 * kb + r) * NC + 4 * cb) = st[r];
    }
  }

  const int n_chunks = p.S / lc;
  const int pairs = lc * (lc - 1) / 2;
  for (int t = 1 + tid; t < lc; t += kThreads)
    for (int i = 0; i < t; ++i)
      pair_s[t * (t - 1) / 2 + i] = static_cast<unsigned short>(t << 8 | i);
  const int q = tid / L, lane = tid % L;
  // the cumsum: NPART threads a channel, each over its own run of rows
  constexpr int NPART = kThreads / HS;
  const int part = tid / HS, ch = tid % HS;
  const int ta = part * lc / NPART, tb = (part + 1) * lc / NPART;
  load(0);
  for (int n = 0; n < n_chunks; ++n) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // chunk n landed; chunk n - 1 is done with every tile
    if (n + 1 < n_chunks) load(n + 1);
    const float* r_s = smem + (n & 1) * bufsz;
    const float* k_s = r_s + lc * P;
    float* w_s = const_cast<float*>(k_s) + lc * P;  // log_w -> cum_{t-1}
    const float* v_s = w_s + lc * P;
    const float* s_old = s_s + (n & 1) * HS * NC;
    float* s_new = s_s + ((n + 1) & 1) * HS * NC;

    float run = 0.f;   // this part's sum of log2-scaled log_w
    for (int t = ta; t < tb; ++t) run += w_s[t * P + ch] * kLog2e;
    tot_s[part * HS + ch] = run;
    __syncthreads();
    {
      // cum = (sum of the earlier parts' totals) + (this part's running
      // sum): the same two operands give the last cum of one part and the
      // first cum_{t-1} of the next, so adjacent rows decay by exactly
      // exp2(0) across a part boundary, as they do inside a part
      float base = 0.f, last = 0.f;
      for (int x = 0; x < NPART; ++x) {
        const float v = tot_s[x * HS + ch];
        if (x < part) base += v;
        last += v;
      }
      float loc = 0.f;
      for (int t = ta; t < tb; ++t) {
        const int x = t * P + ch;
        const float prev = base + loc;
        loc += w_s[x] * kLog2e;
        const float cum = base + loc;
        w_s[x] = prev;
        c_s[x] = cum;
        rq_s[x] = r_s[x] * ex2(prev);
        kd_s[x] = k_s[x] * ex2(last - cum);
      }
    }
    __syncthreads();

    // y, its first term: (r * exp(cum_{t-1})) S over the state before
    // this chunk. A task is rows t and t + half of four columns, so each
    // 16-byte load of S feeds eight FMAs. Kept in registers until A is
    // done: this term reads shared memory, A's exponentials the MUFU and
    // the state's update the FMA pipe, so the three share one phase
    const int half = (lc + 1) / 2;
    float4 yacc[MT][2];
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      const int task = tid + j * kThreads;
      if (task >= half * NQ) continue;
      const int t = task / NQ, c = (task % NQ) * 4;
      const int t2 = min(t + half, lc - 1);   // a duplicate row if past lc
      float4 a0 = make_float4(0.f, 0.f, 0.f, 0.f), a1 = a0;
#pragma unroll 4
      for (int k = 0; k < HS; k += 4) {
        const float4 q0 = ld4(rq_s + t * P + k), q1 = ld4(rq_s + t2 * P + k);
        const float4 s0 = ld4(s_old + (k + 0) * NC + c);
        const float4 s1 = ld4(s_old + (k + 1) * NC + c);
        const float4 s2 = ld4(s_old + (k + 2) * NC + c);
        const float4 s3 = ld4(s_old + (k + 3) * NC + c);
        fma4(a0, q0.x, s0);
        fma4(a1, q1.x, s0);
        fma4(a0, q0.y, s1);
        fma4(a1, q1.y, s1);
        fma4(a0, q0.z, s2);
        fma4(a1, q1.z, s2);
        fma4(a0, q0.w, s3);
        fma4(a1, q1.w, s3);
      }
      yacc[j][0] = a0;
      yacc[j][1] = a1;
    }

    // the state: S <- S * exp(cum_last) + kd^T v, 16 FMAs per two loads
    if (owner) {
      const float* last = c_s + (lc - 1) * P + 4 * kb;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float d = ex2(last[r]);
        st[r].x *= d;
        st[r].y *= d;
        st[r].z *= d;
        st[r].w *= d;
      }
      for (int i = 0; i < lc; ++i) {
        const float4 kd = ld4(kd_s + i * P + 4 * kb);
        const float4 v = ld4(v_s + i * PV + 4 * cb);
        fma4(st[0], kd.x, v);
        fma4(st[1], kd.y, v);
        fma4(st[2], kd.z, v);
        fma4(st[3], kd.w, v);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
        *reinterpret_cast<float4*>(s_new + (4 * kb + r) * NC + 4 * cb) =
            st[r];
    }

    // A over every thread: L lanes a pair, each over CL float4s of a row
    for (int p0 = 0; p0 < pairs; p0 += kThreads / L) {
      const int pt = pair_s[min(p0 + q, pairs - 1)];
      const int t = pt >> 8, i = pt & 255;
      float acc = 0.f;
#pragma unroll
      for (int m = 0; m < CL; ++m) {
        const int c = 4 * (lane + L * m);
        const float4 rt = ld4(r_s + t * P + c), wt = ld4(w_s + t * P + c);
        const float4 ki = ld4(k_s + i * P + c), ci = ld4(c_s + i * P + c);
        acc += rt.x * ki.x * ex2(wt.x - ci.x) + rt.y * ki.y * ex2(wt.y - ci.y) +
               rt.z * ki.z * ex2(wt.z - ci.z) + rt.w * ki.w * ex2(wt.w - ci.w);
      }
#pragma unroll
      for (int o = 1; o < L; o <<= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (lane == 0 && p0 + q < pairs) a_s[t * lc + i] = acc;
    }
    __syncthreads();

    // y += A v, written straight to device memory, 16 bytes a row
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      const int task = tid + j * kThreads;
      if (task >= half * NQ) continue;
      const int t = task / NQ, c = (task % NQ) * 4, t2 = t + half;
      float4 a0 = yacc[j][0], a1 = yacc[j][1];
      const float* at = a_s + t * lc;
      const float* at2 = a_s + min(t2, lc - 1) * lc;
      int i = 0;
      for (; i < t; ++i) {
        const float4 v = ld4(v_s + i * PV + c);
        fma4(a0, at[i], v);
        fma4(a1, at2[i], v);
      }
      for (; i < t2 && t2 < lc; ++i) fma4(a1, at2[i], ld4(v_s + i * PV + c));
      *reinterpret_cast<float4*>(yg + (n * lc + t) * p.ss[4] + c) = a0;
      if (t2 < lc)
        *reinterpret_cast<float4*>(yg + (n * lc + t2) * p.ss[4] + c) = a1;
    }
  }

  if (owner) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      *reinterpret_cast<float4*>(p.sT + s_off + r * HS) = st[r];
  }
}

template <int HS, int NC>
cudaError_t launch(const Params& p, int BH, cudaStream_t stream) {
  const int smem = smem_bytes<HS, NC>(p.lc);
  cudaError_t e = cudaFuncSetAttribute(
      rwkv6_scan_kernel<HS, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  Params q = p;
  q.nsplit = HS / NC;
  rwkv6_scan_kernel<HS, NC><<<BH * q.nsplit, kThreads, smem, stream>>>(q);
  return cudaGetLastError();
}

// the widest block of value columns whose tiles fit in shared memory: all
// hs of them (one block a row), or 32 where that does not fit (hs 64 at
// chunk 64); the narrower blocks measured slower where both fit (PERF.md)
template <int HS>
cudaError_t launch_hs(const Params& p, int BH, cudaStream_t s) {
  constexpr int NC = HS < 32 ? HS : 32;
  static_assert(smem_bytes<HS, NC>(kMaxChunk) <= kMaxSmem,
                "the narrowest block must fit at every chunk");
  if constexpr (HS > NC) {
    if (smem_bytes<HS, HS>(p.lc) <= kMaxSmem) return launch<HS, HS>(p, BH, s);
  }
  return launch<HS, NC>(p, BH, s);
}

}  // namespace

// r, k, v, log_w, y: (B, S, H, hs) fp32 with hs contiguous, read and
// written through 15 element strides ((batch, seq, head) of r, k, v,
// log_w, y in that order), each a multiple of 4, every base 16-byte
// aligned; s0, sT: (B * H, hs, hs) fp32, contiguous. hs in {16, 32, 64};
// 1 <= chunk <= 64 and S % chunk == 0. Returns a cudaError_t.
extern "C" int rwkv6_scan_fwd(const void* r, const void* k, const void* v,
                              const void* log_w, const void* s0, void* y,
                              void* sT, int B, int S, int H, int hs,
                              int chunk, const long long* strides,
                              void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || chunk < 1 || chunk > kMaxChunk ||
      S % chunk)
    return cudaErrorInvalidValue;
  Params p{{static_cast<const float*>(r), static_cast<const float*>(k),
            static_cast<const float*>(v), static_cast<const float*>(log_w)},
           static_cast<float*>(y), static_cast<const float*>(s0),
           static_cast<float*>(sT)};
  for (int x = 0; x < 5; ++x) {
    p.sb[x] = strides[3 * x];
    p.ss[x] = strides[3 * x + 1];
    p.sh[x] = strides[3 * x + 2];
  }
  p.H = H;
  p.S = S;
  p.lc = chunk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hs) {
    case 16: return launch_hs<16>(p, B * H, s);
    case 32: return launch_hs<32>(p, B * H, s);
    case 64: return launch_hs<64>(p, B * H, s);
    default: return cudaErrorInvalidValue;
  }
}
