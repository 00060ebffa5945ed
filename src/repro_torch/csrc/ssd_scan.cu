// Mamba-2 chunked SSD scan for Hopper (sm_90a), fp32.
//
// Replaces no TPU kernel: the JAX package runs this SSD as einsums outside
// any Pallas kernel (src/repro/models/ssm.py mamba_ssd_chunked). The port's
// plain version (kernels/ssd_scan/ref.py mamba_ssd_chunked) is a Python loop
// over chunks of 64 with some 15 small launches a chunk, so a long prompt's
// prefill is paced by the host. Here the whole scan is two launches, whatever
// the sequence length.
//
// For one (batch, head), with x the dt-scaled inputs (S, P), B and C (S, N)
// shared by every head, a the log decays (S) <= 0 and h the state (P, N):
//     h_t = exp(a_t) h_{t-1} + x_t^T B_t,    y_t = h_t C_t,
// computed chunk by chunk. Inside a chunk of L tokens, with cum the inclusive
// cumulative sum of a over the chunk,
//     y[t] = sum_{i<=t} (C_t . B_i) exp(cum_t - cum_i) x_i + exp(cum_t) h C_t
//     h   <- exp(cum_last) h + sum_i x_i^T (exp(cum_last - cum_i) B_i).
// Every exponent is a difference of inclusive cumulative log decays (or cum
// itself), <= 0, as in the plain version. Products and sums are fp32 on the
// CUDA cores: TF32 tensor cores would be a lower precision than the port
// runs.
//
// What bounds it on this card: at Granite-4.0-H-Small's shape (128 heads of
// P 64, N 128, one B/C group) and a prompt of 1,905 tokens a call does about
// 9.0 GFLOP (the causal intra-chunk product, the state's update and the
// inter-chunk read, each head over 30 chunks), 0.135 ms at the 67 TFLOP/s
// fp32 rate, and moves about 136 MB (x and y dominate), 0.041 ms at 3.35
// TB/s: the bound is operations.
//
// Design:
// - Launch 1 (ssd_scan_prep), one block a chunk: C_t . B_i for the chunk,
//   (L, L), once for every head that shares it (128 heads would otherwise
//   each redo 2 L L N operations a chunk), and each head's inclusive
//   cumulative sum of a over the chunk, in order (cum_{t+1} = cum_t + a_{t+1}
//   rounded, so cum never rises and every difference below is <= 0
//   exactly), scaled by log2(e) so that each exponential is one ex2.approx.
// - Launch 2 (ssd_scan_chunk): one block of 512 threads a (batch, head)
//   walks its chunks in order and keeps the (P, N) state in registers, a
//   4 x 4 tile a thread (16 KB a block on chip at N 128), mirrored
//   transposed into shared memory. The next chunk's x, B, C and cum are
//   copied into a second buffer with cp.async while the current chunk
//   computes; rows past S are filled with zeros, so the ragged tail is
//   masked in the kernel (no decay, nothing written into the state) and its
//   y is not written.
// - Each chunk: M = CB exp(cum_t - cum_i) (zero above the diagonal), B
//   scaled by exp(cum_last - cum_i) and C by exp(cum_t), in place; then y as
//   one product [M | C] [x ; h^T] of depth L + N, a 4 x 4 tile a thread in
//   16-byte shared loads, 8 loads per 64 FMAs. Each thread holds rows t,
//   31 - t, 32 + t and 63 - t, whose causal lengths in M x sum to the same
//   for every t; half the block takes M x and the state's first NA columns,
//   the other half the rest, and hands its sums to the first through M's
//   tile. Then the state's update, 16 FMAs per two 16-byte loads. Four
//   barriers a chunk.
//
// C interface (loaded with ctypes): ssd_scan_fwd(...) launches both kernels
// on the given stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kL = 64;          // chunk length
constexpr int kP = 64;          // head size
constexpr int kThreads = 512;   // ssd_scan_chunk's block
constexpr int kPrepThreads = 256;
constexpr int kMaxSmem = 232448;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const float* x;   // (B, S, H, P), P contiguous
  const float* bm;  // (B, S, N), N contiguous
  const float* cm;  // (B, S, N), N contiguous
  const float* la;  // (B, S, H)
  const float* h0;  // (B, H, P, N), contiguous
  float* y;         // (B, S, H, P), contiguous
  float* hf;        // (B, H, P, N), contiguous
  float* cb;        // (B, n_chunks, L, L), contiguous scratch: C_t . B_i
  float* cum;       // (B, S, H), contiguous scratch: cum, base 2
  long long x_sb, x_ss, x_sh;  // element strides: batch, sequence, head
  long long b_sb, b_ss;
  long long c_sb, c_ss;
  long long a_sb, a_ss, a_sh;
  int S, H, n_chunks;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 16 bytes global -> shared; zeros where !in (nothing is read then)
__device__ __forceinline__ void cp16(float* dst, const float* src, bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp4(float* dst, const float* src, bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, const float4& v) {
  *reinterpret_cast<float4*>(p) = v;
}

// v's j-th value (j a constant once unrolled, so no local memory)
__device__ __forceinline__ float comp(const float4& v, int j) {
  return j == 0 ? v.x : (j == 1 ? v.y : (j == 2 ? v.z : v.w));
}

__device__ __forceinline__ float4 scale4(const float4& v, float s) {
  return make_float4(v.x * s, v.y * s, v.z * s, v.w * s);
}

__device__ __forceinline__ void fma4(float4& acc, float a, const float4& b) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

// acc[r] += a_r * b for a's four values a_r, r = 0..3
__device__ __forceinline__ void outer4(float4 (&acc)[4], const float4& a,
                                       const float4& b) {
  fma4(acc[0], a.x, b);
  fma4(acc[1], a.y, b);
  fma4(acc[2], a.z, b);
  fma4(acc[3], a.w, b);
}

// acc + a . b, over the four terms in order
__device__ __forceinline__ float dot4(float acc, const float4& a,
                                      const float4& b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <int N>
constexpr int prep_smem_bytes() {
  return 2 * kL * (N + 4) * static_cast<int>(sizeof(float));
}

// one chunk: C_t . B_i for every (t, i), a 4 x 4 tile a thread (rows ti..
// ti + 3, columns ii + 16 k), over C and B staged with rows padded to N + 4;
// and cum of every head, in order
template <int N>
__global__ void __launch_bounds__(kPrepThreads) ssd_scan_prep(const Params p) {
  constexpr int R = N + 4;
  extern __shared__ __align__(16) float smem[];
  float* c_s = smem;
  float* b_s = smem + kL * R;
  const int c = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int t0 = c * kL, rows = min(kL, p.S - t0);
  const float* cg = p.cm + b * p.c_sb;
  const float* bg = p.bm + b * p.b_sb;
  for (int e = tid; e < kL * (N / 4); e += kPrepThreads) {
    const int t = e / (N / 4), q = (e % (N / 4)) * 4;
    const bool in = t < rows;
    const long long o = in ? t0 + t : 0;
    cp16(c_s + t * R + q, cg + o * p.c_ss + q, in);
    cp16(b_s + t * R + q, bg + o * p.b_ss + q, in);
  }
  cp_commit();

  for (int h = tid; h < p.H; h += kPrepThreads) {
    const float* a = p.la + b * p.a_sb + h * p.a_sh +
                     static_cast<long long>(t0) * p.a_ss;
    float* out = p.cum + (static_cast<long long>(b) * p.S + t0) * p.H + h;
    float v[kL];
#pragma unroll
    for (int t = 0; t < kL; ++t) v[t] = t < rows ? a[t * p.a_ss] : 0.f;
    float s = 0.f;
#pragma unroll
    for (int t = 0; t < kL; ++t) {
      s = fmaf(v[t], kLog2e, s);
      if (t < rows) out[static_cast<long long>(t) * p.H] = s;
    }
  }

  cp_wait_all();
  __syncthreads();
  const int ti = (tid / 16) * 4, ii = tid % 16;
  float acc[4][4] = {};
#pragma unroll 2
  for (int n = 0; n < N; n += 4) {
    float4 cr[4], br[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) cr[r] = ld4(c_s + (ti + r) * R + n);
#pragma unroll
    for (int k = 0; k < 4; ++k) br[k] = ld4(b_s + (ii + 16 * k) * R + n);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[r][k] = dot4(acc[r][k], cr[r], br[k]);
  }
  float* out = p.cb + (static_cast<long long>(b) * p.n_chunks + c) * kL * kL;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int k = 0; k < 4; ++k) out[(ti + r) * kL + ii + 16 * k] = acc[r][k];
}

template <int N>
constexpr int chunk_smem_bytes() {
  // x, B, C (rows padded to N + 4), cum: two buffers each; M (rows padded
  // to L + 4); the state, transposed (N x (P + 4))
  return (2 * (kL * kP + kL * N + kL * (N + 4) + kL) + kL * (kL + 4) +
          N * (kP + 4)) *
         static_cast<int>(sizeof(float));
}

// the state's columns that the first half of the block reads in y's
// product, beside M x (34 quads of 16 FMAs a thread): about as many FMAs as
// the second half's, in quads
template <int N>
__host__ __device__ constexpr int first_half_columns() {
  constexpr int na = ((16 * N - 544) / 32 + 2) / 4 * 4;
  return na < 0 ? 0 : (na > N ? N : na);
}

template <int N>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_scan_chunk(const Params p) {
  constexpr int NC = N + 4;   // row stride of C
  constexpr int MR = kL + 4;  // row stride of M
  constexpr int HR = kP + 4;  // row stride of the state's mirror
  constexpr int NQ = N / 4;   // column quads of the state
  constexpr int NA = first_half_columns<N>();
  constexpr int MQ = kL * kL / 4 / kThreads;  // quads of M a thread
  // the state's 4 x 4 tiles: a warp holds LN column quads by PW row quads,
  // row quads fastest, so each of its 16-byte loads of x and of B reads one
  // wavefront and the mirror's stores (rows padded to HR) meet no conflict
  constexpr int LN = NQ < 8 ? NQ : 8, PW = 32 / LN, NG = NQ / LN;
  static_assert(NQ >= 2 && NQ % LN == 0 && 16 * NQ <= kThreads,
                "state tiles do not fit the block");
  extern __shared__ __align__(16) float smem[];
  float* xbuf = smem;                   // 2 x (L x P)
  float* bbuf = xbuf + 2 * kL * kP;     // 2 x (L x N)
  float* cbuf = bbuf + 2 * kL * N;      // 2 x (L x NC)
  float* ubuf = cbuf + 2 * kL * NC;     // 2 x L: cum, base 2
  float* m_s = ubuf + 2 * kL;           // L x MR
  float* ht_s = m_s + kL * MR;          // N x HR: the state, transposed

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const float* xg = p.x + b * p.x_sb + h * p.x_sh;
  const float* bg = p.bm + b * p.b_sb;
  const float* cg = p.cm + b * p.c_sb;
  const float* ug = p.cum + static_cast<long long>(b) * p.S * p.H + h;
  float* yg = p.y + (static_cast<long long>(b) * p.S * p.H + h) * kP;
  const long long y_ss = static_cast<long long>(p.H) * kP;
  const float* cbg = p.cb + static_cast<long long>(b) * p.n_chunks * kL * kL;

  // copy chunk c's tiles into buffer c & 1; rows past S read as zeros
  auto load = [&](int c) {
    const int t0 = c * kL, rows = min(kL, p.S - t0);
    float* xd = xbuf + (c & 1) * kL * kP;
    float* bd = bbuf + (c & 1) * kL * N;
    float* cd = cbuf + (c & 1) * kL * NC;
    for (int e = tid; e < kL * kP / 4; e += kThreads) {
      const int t = e / (kP / 4), q = (e % (kP / 4)) * 4;
      const bool in = t < rows;
      cp16(xd + t * kP + q,
           xg + (in ? static_cast<long long>(t0 + t) * p.x_ss : 0) + q, in);
    }
    for (int e = tid; e < kL * NQ; e += kThreads) {
      const int t = e / NQ, q = (e % NQ) * 4;
      const bool in = t < rows;
      const long long o = in ? t0 + t : 0;
      cp16(bd + t * N + q, bg + o * p.b_ss + q, in);
      cp16(cd + t * NC + q, cg + o * p.c_ss + q, in);
    }
    if (tid < kL) {
      const bool in = tid < rows;
      cp4(ubuf + (c & 1) * kL + tid,
          ug + (in ? static_cast<long long>(t0 + tid) * p.H : 0), in);
    }
    cp_commit();
  };

  // this thread's state tile: rows 4 pq.. (of P), columns 4 nq.. (of N)
  const bool owner = warp < NQ / 2;
  const int nq = (warp % NG) * LN + lane / PW;
  const int pq = (warp / NG) * PW + lane % PW;
  const long long h_off =
      (static_cast<long long>(b) * p.H + h) * kP * N + 4 * pq * N + 4 * nq;
  float4 st[4] = {};
  auto mirror = [&]() {   // the tile, transposed, into ht_s
    st4(ht_s + (4 * nq + 0) * HR + 4 * pq,
        make_float4(st[0].x, st[1].x, st[2].x, st[3].x));
    st4(ht_s + (4 * nq + 1) * HR + 4 * pq,
        make_float4(st[0].y, st[1].y, st[2].y, st[3].y));
    st4(ht_s + (4 * nq + 2) * HR + 4 * pq,
        make_float4(st[0].z, st[1].z, st[2].z, st[3].z));
    st4(ht_s + (4 * nq + 3) * HR + 4 * pq,
        make_float4(st[0].w, st[1].w, st[2].w, st[3].w));
  };
  if (owner) {
#pragma unroll
    for (int r = 0; r < 4; ++r) st[r] = ld4(p.h0 + h_off + r * N);
    mirror();
  }

  // y's tiles: rows t, 31 - t, 32 + t, 63 - t (t < 16) by columns 4 yq..,
  // a warp holding 8 values of t by 4 column quads; in the first half M x
  // and the state's columns [0, NA), in the second the columns [NA, N)
  const bool first = warp < kThreads / 64;
  const int w8 = warp % (kThreads / 64);
  const int yq = (w8 % 4) * 4 + lane % 4;
  const int ty = (w8 / 4) * 8 + lane / 4;
  const int r0 = ty, r1 = 31 - ty, r2 = 32 + ty, r3 = 63 - ty;
  // i quads that reach each row: e0 <= e1 <= e2 <= e3
  const int e0 = r0 / 4 + 1, e1 = r1 / 4 + 1, e2 = r2 / 4 + 1,
            e3 = r3 / 4 + 1;
  const int n_lo = first ? 0 : NA, n_hi = first ? NA : N;

  load(0);
  for (int c = 0; c < p.n_chunks; ++c) {
    const float4* cbc = reinterpret_cast<const float4*>(
        cbg + static_cast<long long>(c) * kL * kL);
    float4 cbv[MQ];
#pragma unroll
    for (int k = 0; k < MQ; ++k) cbv[k] = cbc[tid + k * kThreads];
    cp_wait_all();
    __syncthreads();  // chunk c landed; chunk c - 1 is done with its tiles
    if (c + 1 < p.n_chunks) load(c + 1);
    const float* xs = xbuf + (c & 1) * kL * kP;
    float* bs = bbuf + (c & 1) * kL * N;
    float* cs = cbuf + (c & 1) * kL * NC;
    const float* cu = ubuf + (c & 1) * kL;   // 0 past S
    const int t0 = c * kL, rows = min(kL, p.S - t0);
    const float last = cu[rows - 1];

    // M = CB exp(cum_t - cum_i) where i <= t < rows, else 0
#pragma unroll
    for (int k = 0; k < MQ; ++k) {
      const int e = tid + k * kThreads, t = e / (kL / 4);
      const int i = (e % (kL / 4)) * 4;
      const float ct = cu[t];
      const float4 ci = ld4(cu + i);
      const bool live = t < rows;
      st4(m_s + t * MR + i,
          make_float4(live && i <= t ? cbv[k].x * ex2(ct - ci.x) : 0.f,
                      live && i + 1 <= t ? cbv[k].y * ex2(ct - ci.y) : 0.f,
                      live && i + 2 <= t ? cbv[k].z * ex2(ct - ci.z) : 0.f,
                      live && i + 3 <= t ? cbv[k].w * ex2(ct - ci.w) : 0.f));
    }
    // B_i <- B_i exp(cum_last - cum_i), C_t <- C_t exp(cum_t)
    for (int e = tid; e < kL * NQ; e += kThreads) {
      const int t = e / NQ, q = (e % NQ) * 4;
      const float ut = cu[t];
      st4(bs + t * N + q, scale4(ld4(bs + t * N + q), ex2(last - ut)));
      st4(cs + t * NC + q, scale4(ld4(cs + t * NC + q), ex2(ut)));
    }
    __syncthreads();

    // y = [M | C] [x ; h^T], h the state before this chunk
    float4 acc[4] = {};
    if (first) {
      int q = 0;
      for (; q < e0; ++q) {
        const float4 m0 = ld4(m_s + r0 * MR + 4 * q);
        const float4 m1 = ld4(m_s + r1 * MR + 4 * q);
        const float4 m2 = ld4(m_s + r2 * MR + 4 * q);
        const float4 m3 = ld4(m_s + r3 * MR + 4 * q);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 xv = ld4(xs + (4 * q + j) * kP + 4 * yq);
          fma4(acc[0], comp(m0, j), xv);
          fma4(acc[1], comp(m1, j), xv);
          fma4(acc[2], comp(m2, j), xv);
          fma4(acc[3], comp(m3, j), xv);
        }
      }
      for (; q < e1; ++q) {
        const float4 m1 = ld4(m_s + r1 * MR + 4 * q);
        const float4 m2 = ld4(m_s + r2 * MR + 4 * q);
        const float4 m3 = ld4(m_s + r3 * MR + 4 * q);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 xv = ld4(xs + (4 * q + j) * kP + 4 * yq);
          fma4(acc[1], comp(m1, j), xv);
          fma4(acc[2], comp(m2, j), xv);
          fma4(acc[3], comp(m3, j), xv);
        }
      }
      for (; q < e2; ++q) {
        const float4 m2 = ld4(m_s + r2 * MR + 4 * q);
        const float4 m3 = ld4(m_s + r3 * MR + 4 * q);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 xv = ld4(xs + (4 * q + j) * kP + 4 * yq);
          fma4(acc[2], comp(m2, j), xv);
          fma4(acc[3], comp(m3, j), xv);
        }
      }
      for (; q < e3; ++q) {
        const float4 m3 = ld4(m_s + r3 * MR + 4 * q);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          fma4(acc[3], comp(m3, j), ld4(xs + (4 * q + j) * kP + 4 * yq));
      }
    }
#pragma unroll 2
    for (int n = n_lo; n < n_hi; n += 4) {
      const float4 c0 = ld4(cs + r0 * NC + n), c1 = ld4(cs + r1 * NC + n);
      const float4 c2 = ld4(cs + r2 * NC + n), c3 = ld4(cs + r3 * NC + n);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 hv = ld4(ht_s + (n + j) * HR + 4 * yq);
        fma4(acc[0], comp(c0, j), hv);
        fma4(acc[1], comp(c1, j), hv);
        fma4(acc[2], comp(c2, j), hv);
        fma4(acc[3], comp(c3, j), hv);
      }
    }
    __syncthreads();  // every read of M and of the old state's mirror is done
    const int rr[4] = {r0, r1, r2, r3};
    if (!first) {   // the second half's sums, through M's tile
#pragma unroll
      for (int r = 0; r < 4; ++r) st4(m_s + rr[r] * MR + 4 * yq, acc[r]);
    }
    __syncthreads();
    if (first) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4 o = ld4(m_s + rr[r] * MR + 4 * yq);
        acc[r].x += o.x;
        acc[r].y += o.y;
        acc[r].z += o.z;
        acc[r].w += o.w;
        if (rr[r] < rows) st4(yg + (t0 + rr[r]) * y_ss + 4 * yq, acc[r]);
      }
    }

    // h <- exp(cum_last) h + x^T (B exp(cum_last - cum)), in registers
    if (owner) {
      const float d = ex2(last);
#pragma unroll
      for (int r = 0; r < 4; ++r) st[r] = scale4(st[r], d);
#pragma unroll 8
      for (int i = 0; i < kL; ++i)
        outer4(st, ld4(xs + i * kP + 4 * pq), ld4(bs + i * N + 4 * nq));
      mirror();
    }
  }
  if (owner) {
#pragma unroll
    for (int r = 0; r < 4; ++r) st4(p.hf + h_off + r * N, st[r]);
  }
}

template <int N>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  constexpr int prep = prep_smem_bytes<N>(), chunk = chunk_smem_bytes<N>();
  static_assert(chunk <= kMaxSmem && prep <= kMaxSmem,
                "ssd_scan's tiles do not fit");
  cudaError_t e = cudaFuncSetAttribute(
      ssd_scan_prep<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, prep);
  if (e != cudaSuccess) return e;
  ssd_scan_prep<N><<<dim3(p.n_chunks, B), kPrepThreads, prep, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(
      ssd_scan_chunk<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, chunk);
  if (e != cudaSuccess) return e;
  ssd_scan_chunk<N><<<B * p.H, kThreads, chunk, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// x, y: (B, S, H, 64) fp32, P contiguous; B_, C_: (B, S, N) fp32, N
// contiguous; log_a: (B, S, H) fp32; h0, h_final: (B, H, 64, N) fp32,
// contiguous; cb: (B, ceil(S / 64), 64, 64) and cum: (B, S, H) fp32
// scratch. strides: 10 element strides, x's (batch, seq, head), B's (batch,
// seq), C's (batch, seq), log_a's (batch, seq, head); those of x, B and C
// multiples of 4 and their bases 16-byte aligned. N in {16, 32, 64, 128},
// S >= 1. y is written contiguous. Returns a cudaError_t.
extern "C" int ssd_scan_fwd(const void* x, const void* bm, const void* cm,
                            const void* log_a, const void* h0, void* y,
                            void* h_final, void* cb, void* cum, int B, int S,
                            int H, int N, const long long* strides,
                            void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return cudaErrorInvalidValue;
  Params p{static_cast<const float*>(x),     static_cast<const float*>(bm),
           static_cast<const float*>(cm),    static_cast<const float*>(log_a),
           static_cast<const float*>(h0),    static_cast<float*>(y),
           static_cast<float*>(h_final),     static_cast<float*>(cb),
           static_cast<float*>(cum)};
  p.x_sb = strides[0];
  p.x_ss = strides[1];
  p.x_sh = strides[2];
  p.b_sb = strides[3];
  p.b_ss = strides[4];
  p.c_sb = strides[5];
  p.c_ss = strides[6];
  p.a_sb = strides[7];
  p.a_ss = strides[8];
  p.a_sh = strides[9];
  p.S = S;
  p.H = H;
  p.n_chunks = (S + kL - 1) / kL;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 16: return launch<16>(p, B, s);
    case 32: return launch<32>(p, B, s);
    case 64: return launch<64>(p, B, s);
    case 128: return launch<128>(p, B, s);
    default: return cudaErrorInvalidValue;
  }
}
