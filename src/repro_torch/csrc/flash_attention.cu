// Flash attention forward for Hopper (sm_90a), fp32 and bf16 inputs.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/flash_attention.py
// (flash_attention_kernel, body _fa_kernel): fused online-softmax attention
// with the running (m, l, acc) kept in fp32, GQA (q head h reads kv head
// h / G), causal and sliding-window masks (q - k < window), an optional logit
// softcap tanh(s / c) * c, and the output acc / max(l, 1e-30).
//
// What bounds it on this card: the useful work is 4 * B * H * dh * (visible
// q-k pairs) operations against q + k + v + o bytes. At the Qwen3-8B shape
// (32 q heads over 8 kv heads, dh 128, causal, bf16) that is 0.4 * (S + 1)
// operations per byte: 205 at the serving prompt S = 512, below the H100's
// ridge point (989 TFLOP/s over 3.35 TB/s, about 295), so a launch there is
// bound by HBM bandwidth; it turns bound by the tensor cores' rate only
// from S of about 737. Either way the kernel's job is to keep scores and
// probabilities out of device memory (q is read once and o written once;
// k and v tiles are re-read by each q tile and by each head of a group,
// mostly from L2) and to feed the tensor cores.
//
// Design, against the TPU kernel's:
// - The TPU walks a sequential grid axis over KV blocks and carries
//   (m, l, acc) in VMEM scratch. Here one thread block owns one
//   (batch * q-head, q tile) and loops over KV tiles inside itself; the
//   running state lives in registers, nothing crosses blocks.
// - q/k/v/o are read and written in their (B, S, heads, dh) layout through
//   the strides the wrapper passes: no pad, transpose or head-repeat copy.
// - KV tiles wholly above the causal diagonal or outside the window are not
//   visited; in _fa_kernel such a tile leaves (m, l, acc) unchanged, so the
//   numbers are the same. Ragged q and kv edges are masked in the kernel.
// - bf16 (the serving path): each warp owns 16 q rows of a 64-row tile and
//   runs both products on the tensor cores with mma.sync m16n8k16 (bf16 in,
//   fp32 accumulate). The score fragments are the A operand of P @ V, so
//   probabilities go from accumulator registers straight back into the
//   tensor cores, rounded to bf16 before they are normalized (the plain
//   path rounds the normalized probabilities); V is stored
//   transposed in shared memory so its fragments are 32-bit loads. Not yet
//   Hopper's own path (wgmma fed by TMA): mma.sync reaches a fraction of the
//   tensor-core peak, and the tiles are loaded synchronously, not pipelined.
// - fp32: SIMT on the CUDA cores in full fp32 (the reference's 2e-5), each
//   warp owning 8 q rows of a 32-row tile. Scores: lane j computes key j of a
//   32-key tile against the warp's rows (K transposed in shared memory, q
//   broadcast as float4). P @ V: lane owns output columns lane, lane + 32, ...
//   and reads P back as broadcast float4. Bound by fp32 FMA issue and
//   shared-memory reads.
//
// C interface (loaded with ctypes): fa_fwd(...) launches on the given stream,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 8;                 // q rows per warp
constexpr int kBQ = kWarps * kRows;      // q rows per block
constexpr int kBK = 32;                  // keys per KV tile (one per lane)
constexpr float kNegInf = -1e30f;        // the reference's NEG_INF

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, Sq, Skv, H, KV, G;
  // element strides of the (B, S, heads, dh) tensors; dh is contiguous
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh, o_sb, o_ss, o_sh;
  int causal, window;                    // window <= 0: no window
  float softcap, scale;                  // softcap <= 0: no softcap
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int DH>
constexpr int smem_floats() {
  return kBQ * DH + DH * (kBK + 1) + kBK * DH + kWarps * kRows * kBK;
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
    fa_fwd_simt_f32(const Params p) {
  constexpr int kCols = (DH + 31) / 32;  // output columns per lane
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                       // [kBQ][DH]
  float* Kt = Qs + kBQ * DH;              // [DH][kBK + 1], transposed
  float* Vs = Kt + DH * (kBK + 1);        // [kBK][DH]
  float* Ps = Vs + kBK * DH;              // [kWarps * kRows][kBK]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H, kvh = h / p.G;
  const int q0 = blockIdx.x * kBQ;
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  float* og = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int i = tid; i < kBQ * DH; i += kThreads) {
    const int r = i / DH, d = i % DH, qpos = q0 + r;
    Qs[i] = qpos < p.Sq ? qg[qpos * p.q_ss + d] : 0.f;
  }

  // keys [k_lo, k_hi) can be visible to some row of this tile
  const int q_last = min(q0 + kBQ, p.Sq) - 1;
  int k_lo = 0, k_hi = p.Skv;
  if (p.causal) k_hi = min(k_hi, q_last + 1);
  if (p.window > 0) k_lo = max(0, q0 - p.window + 1);
  const int t_lo = k_lo / kBK;
  const int t_hi = k_hi > k_lo ? (k_hi + kBK - 1) / kBK : t_lo;

  float m[kRows], l[kRows], acc[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }
  const float* qw = Qs + warp * kRows * DH;
  float* pw = Ps + warp * kRows * kBK;

  for (int t = t_lo; t < t_hi; ++t) {
    const int kbase = t * kBK;
    __syncthreads();  // previous tile's readers are done (and Qs is loaded)
    for (int i = tid; i < kBK * DH; i += kThreads) {
      const int j = i / DH, d = i % DH, kpos = kbase + j;
      const bool in = kpos < p.Skv;
      Kt[d * (kBK + 1) + j] = in ? kg[kpos * p.k_ss + d] : 0.f;
      Vs[i] = in ? vg[kpos * p.v_ss + d] : 0.f;
    }
    __syncthreads();

    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
#pragma unroll 2
    for (int d = 0; d < DH; d += 4) {
      const float k0 = Kt[(d + 0) * (kBK + 1) + lane];
      const float k1 = Kt[(d + 1) * (kBK + 1) + lane];
      const float k2 = Kt[(d + 2) * (kBK + 1) + lane];
      const float k3 = Kt[(d + 3) * (kBK + 1) + lane];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(qw + r * DH + d);
        s[r] = fmaf(qv.x, k0, s[r]);
        s[r] = fmaf(qv.y, k1, s[r]);
        s[r] = fmaf(qv.z, k2, s[r]);
        s[r] = fmaf(qv.w, k3, s[r]);
      }
    }

    const int kpos = kbase + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = q0 + warp * kRows + r;
      float x = s[r] * p.scale;
      if (p.softcap > 0.f) x = tanhf(x / p.softcap) * p.softcap;
      bool ok = kpos < p.Skv;
      if (p.causal) ok = ok && qpos >= kpos;
      if (p.window > 0) ok = ok && (qpos - kpos) < p.window;
      x = ok ? x : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(x));
      const float alpha = expf(m[r] - m_new);
      const float pr = ok ? expf(x - m_new) : 0.f;
      l[r] = l[r] * alpha + warp_sum(pr);
      m[r] = m_new;
      pw[r * kBK + lane] = pr;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= alpha;
    }
    __syncwarp();

#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float4 pv[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        pv[r] = *reinterpret_cast<const float4*>(pw + r * kBK + j);
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int d = lane + 32 * c;
        if (DH >= 32 || d < DH) {
          const float v0 = Vs[(j + 0) * DH + d];
          const float v1 = Vs[(j + 1) * DH + d];
          const float v2 = Vs[(j + 2) * DH + d];
          const float v3 = Vs[(j + 3) * DH + d];
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            acc[r][c] = fmaf(pv[r].x, v0, acc[r][c]);
            acc[r][c] = fmaf(pv[r].y, v1, acc[r][c]);
            acc[r][c] = fmaf(pv[r].z, v2, acc[r][c]);
            acc[r][c] = fmaf(pv[r].w, v3, acc[r][c]);
          }
        }
      }
    }
    __syncwarp();  // pw is rewritten by the next tile's softmax
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qpos = q0 + warp * kRows + r;
    if (qpos >= p.Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = lane + 32 * c;
      if (DH >= 32 || d < DH)
        og[qpos * p.o_ss + d] = acc[r][c] / denom;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores through mma.sync
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kMmaBQ = 16 * kWarps;      // q rows per block, 16 per warp
constexpr int kMmaBK = 64;               // keys per KV tile

template <int DH>
constexpr int mma_smem_bytes() {
  // Qs, Ks: [64][DH + 8]; Vt: [DH][64 + 8] (rows padded by 16 bytes so the
  // fragment loads of a warp fall in distinct banks)
  return (kMmaBQ * (DH + 8) + kMmaBK * (DH + 8) + DH * (kMmaBK + 8)) * 2;
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D = A(16x16, row) * B(16x8, col) + D; bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Fragment layout of m16n8k16 (lane = 4 * g + t): A holds rows g and g + 8,
// columns 2t, 2t + 1 (+ 8); B holds k rows 2t, 2t + 1 (+ 8) of column g; the
// accumulator holds rows g (c0, c1) and g + 8 (c2, c3), columns 2t, 2t + 1.
template <int DH>
__global__ void __launch_bounds__(kThreads)
    fa_fwd_mma_bf16(const Params p) {
  constexpr int QS = DH + 8;             // row stride of Qs and Ks
  constexpr int VS = kMmaBK + 8;         // row stride of Vt
  constexpr int CH = DH / 8;             // 16-byte chunks per row
  constexpr int KD = DH / 16;            // k steps of Q K^T
  constexpr int ND = DH / 8;             // n tiles of the output
  constexpr int NT = kMmaBK / 8;         // n tiles of the scores
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + kMmaBQ * QS;
  bf16* Vt = Ks + kMmaBK * QS;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H, kvh = h / p.G;
  const int q0 = blockIdx.x * kMmaBQ;
  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  bf16* og = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int i = tid; i < kMmaBQ * CH; i += kThreads) {
    const int r = i / CH, c = (i % CH) * 8, qpos = q0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (qpos < p.Sq)
      val = *reinterpret_cast<const uint4*>(qg + qpos * p.q_ss + c);
    *reinterpret_cast<uint4*>(Qs + r * QS + c) = val;
  }

  const int q_last = min(q0 + kMmaBQ, p.Sq) - 1;
  int k_lo = 0, k_hi = p.Skv;
  if (p.causal) k_hi = min(k_hi, q_last + 1);
  if (p.window > 0) k_lo = max(0, q0 - p.window + 1);
  const int t_lo = k_lo / kMmaBK;
  const int t_hi = k_hi > k_lo ? (k_hi + kMmaBK - 1) / kMmaBK : t_lo;

  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  const bf16* qw = Qs + (warp * 16 + g) * QS + 2 * t;
  float oc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) oc[n][0] = oc[n][1] = oc[n][2] = oc[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // l: partial sums

  for (int tile = t_lo; tile < t_hi; ++tile) {
    const int kbase = tile * kMmaBK;
    __syncthreads();  // previous tile's readers are done (and Qs is loaded)
    for (int i = tid; i < kMmaBK * CH; i += kThreads) {
      const int j = i / CH, c = (i % CH) * 8, kpos = kbase + j;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (kpos < p.Skv)
        val = *reinterpret_cast<const uint4*>(kg + kpos * p.k_ss + c);
      *reinterpret_cast<uint4*>(Ks + j * QS + c) = val;
    }
    // V transposed: neighbouring threads take neighbouring keys, so their
    // 2-byte stores into a row of Vt share banks without conflicts
    for (int i = tid; i < kMmaBK * CH; i += kThreads) {
      const int j = i % kMmaBK, c = (i / kMmaBK) * 8, kpos = kbase + j;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (kpos < p.Skv)
        val = *reinterpret_cast<const uint4*>(vg + kpos * p.v_ss + c);
      const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
      for (int x = 0; x < 8; ++x) Vt[(c + x) * VS + j] = e[x];
    }
    __syncthreads();

    float sc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      const bf16* qa = qw + kk * 16;
      const uint32_t a0 = lds32(qa), a1 = lds32(qa + 8 * QS);
      const uint32_t a2 = lds32(qa + 8), a3 = lds32(qa + 8 * QS + 8);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const bf16* kb = Ks + (n * 8 + g) * QS + kk * 16 + 2 * t;
        mma_bf16(sc[n], a0, a1, a2, a3, lds32(kb), lds32(kb + 8));
      }
    }

    // scale, softcap, mask; bit (4n + e) of ok marks sc[n][e] visible
    uint32_t ok = 0;
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qpos = e < 2 ? row0 : row1;
        const int kpos = kbase + n * 8 + 2 * t + (e & 1);
        float x = sc[n][e] * p.scale;
        if (p.softcap > 0.f) x = tanhf(x / p.softcap) * p.softcap;
        bool vis = kpos < p.Skv;
        if (p.causal) vis = vis && qpos >= kpos;
        if (p.window > 0) vis = vis && (qpos - kpos) < p.window;
        sc[n][e] = vis ? x : kNegInf;
        ok |= (vis ? 1u : 0u) << (4 * n + e);
        if (e < 2) mx0 = fmaxf(mx0, sc[n][e]);
        else mx1 = fmaxf(mx1, sc[n][e]);
      }
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool vis = (ok >> (4 * n + e)) & 1u;
        const float pr = vis ? expf(sc[n][e] - (e < 2 ? mn0 : mn1)) : 0.f;
        sc[n][e] = pr;
        if (e < 2) rs0 += pr;
        else rs1 += pr;
      }
    }
    l0 = l0 * al0 + rs0;
    l1 = l1 * al1 + rs1;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      oc[n][0] *= al0;
      oc[n][1] *= al0;
      oc[n][2] *= al1;
      oc[n][3] *= al1;
    }

#pragma unroll
    for (int j = 0; j < kMmaBK / 16; ++j) {
      const uint32_t a0 = pack_bf16(sc[2 * j][0], sc[2 * j][1]);
      const uint32_t a1 = pack_bf16(sc[2 * j][2], sc[2 * j][3]);
      const uint32_t a2 = pack_bf16(sc[2 * j + 1][0], sc[2 * j + 1][1]);
      const uint32_t a3 = pack_bf16(sc[2 * j + 1][2], sc[2 * j + 1][3]);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const bf16* vb = Vt + (n * 8 + g) * VS + j * 16 + 2 * t;
        mma_bf16(oc[n], a0, a1, a2, a3, lds32(vb), lds32(vb + 8));
      }
    }
  }

  const float d0 = fmaxf(quad_sum(l0), 1e-30f);
  const float d1 = fmaxf(quad_sum(l1), 1e-30f);
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int col = n * 8 + 2 * t;
    if (row0 < p.Sq)
      *reinterpret_cast<uint32_t*>(og + row0 * p.o_ss + col) =
          pack_bf16(oc[n][0] / d0, oc[n][1] / d0);
    if (row1 < p.Sq)
      *reinterpret_cast<uint32_t*>(og + row1 * p.o_ss + col) =
          pack_bf16(oc[n][2] / d1, oc[n][3] / d1);
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int bq, int smem, const Params& p,
                   cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.Sq + bq - 1) / bq, p.B * p.H);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dh(int dtype, const Params& p, cudaStream_t stream) {
  if (dtype == 0)
    return launch(fa_fwd_simt_f32<DH>, kBQ,
                  smem_floats<DH>() * (int)sizeof(float), p, stream);
  return launch(fa_fwd_mma_bf16<DH>, kMmaBQ, mma_smem_bytes<DH>(), p,
                stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. strides: 12 element strides, (batch,
// seq, head) for q, k, v, o in that order. Returns a cudaError_t.
extern "C" int fa_fwd(const void* q, const void* k, const void* v, void* o,
                      int B, int Sq, int Skv, int H, int KV, int dh,
                      const long long* strides, int causal, int window,
                      float softcap, float scale, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || KV <= 0 || H % KV != 0 ||
      B * H > 65535)
    return cudaErrorInvalidValue;
  Params p{q, k, v, o, B, Sq, Skv, H, KV, H / KV,
           strides[0], strides[1], strides[2], strides[3], strides[4],
           strides[5], strides[6], strides[7], strides[8], strides[9],
           strides[10], strides[11], causal, window, softcap, scale};
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16: return launch_dh<16>(dtype, p, s);
    case 32: return launch_dh<32>(dtype, p, s);
    case 64: return launch_dh<64>(dtype, p, s);
    case 128: return launch_dh<128>(dtype, p, s);
    case 256: return launch_dh<256>(dtype, p, s);
    default: return cudaErrorInvalidValue;
  }
}
