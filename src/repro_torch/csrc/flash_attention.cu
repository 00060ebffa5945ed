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
// - bf16, dh 64 and 128 (the serving path): Hopper's own design. One block
//   of three warpgroups per (q tile of 128 rows, batch * head). A producer
//   warpgroup, its registers lowered with setmaxnreg, has one thread issue
//   TMA loads: Q once, then 128-key K and V tiles into a two-stage ring
//   guarded by full / empty mbarriers, so the next tile is in flight while
//   the current one computes. Two consumer warpgroups of 64 q rows each run
//   S = Q K^T on wgmma (m64n128k16, both operands from shared memory), the
//   online softmax on the accumulator registers, and O += P V on wgmma
//   (m64n64k16) with P taken straight from the accumulators into the
//   register A operand and V read MN-major through wgmma's transpose bit:
//   P never goes through shared memory and V is never transposed. A group
//   issues the next tile's S right behind this tile's P V, and the two
//   groups take turns at the tensor cores through named barriers
//   (FlashAttention-3's ping-pong), so that one group's softmax overlaps
//   the other's products. The softmax keeps the running max on the raw
//   logits and takes each probability as ex2 of one FMA (scale and
//   log2(e) folded in). P is rounded to bf16 before it is normalized and
//   l is summed in fp32 from the unrounded p, as on the mma.sync path.
//   Tiles are loaded by 4-d tensor maps (dh, heads, S, batch) in the
//   128-byte swizzle, so strided views are read as they are and rows past
//   S arrive as zeros; O goes back through the Q tile's shared memory and
//   one TMA store per 64-column block, which clips rows past Sq. Blocks
//   are issued heaviest q tile first under a causal mask, with the G q
//   heads of one kv head on neighbouring indices so that their K / V tiles
//   are read from L2. Not done: TMA multicast over a cluster, a persistent
//   grid (each block's Q load and O store are exposed; 1 block per SM).
// - bf16, dh 16, 32 and 256: each warp owns 16 q rows of a 64-row tile and
//   runs both products on the tensor cores with mma.sync m16n8k16 (bf16 in,
//   fp32 accumulate). The score fragments are the A operand of P @ V, so
//   probabilities go from accumulator registers straight back into the
//   tensor cores, rounded to bf16 before they are normalized (the plain
//   path rounds the normalized probabilities); V is stored
//   transposed in shared memory so its fragments are 32-bit loads. Tiles
//   are loaded synchronously.
// - fp32: SIMT on the CUDA cores in full fp32 (the reference's 2e-5), each
//   warp owning 8 q rows of a 32-row tile. Scores: lane j computes key j of a
//   32-key tile against the warp's rows (K transposed in shared memory, q
//   broadcast as float4). P @ V: lane owns output columns lane, lane + 32, ...
//   and reads P back as broadcast float4. Bound by fp32 FMA issue and
//   shared-memory reads.
//
// C interface (loaded with ctypes): fa_fwd(...) launches on the given stream,
// allocates nothing, and returns cudaGetLastError().

#include <cuda.h>
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

// ---------------------------------------------------------------------------
// bf16, dh 64 / 128: Hopper's own path, wgmma fed by TMA
// ---------------------------------------------------------------------------

constexpr int kWgBQ = 128;        // q rows per block, 64 per consumer group
constexpr int kWgBK = 128;        // keys per KV tile
constexpr int kWgStages = 2;      // KV tiles in flight
constexpr int kWgThreads = 384;   // producer warpgroup + 2 consumer groups
constexpr int kBox = 64;          // bf16 in one 128-byte swizzled row
constexpr float kLog2e = 1.4426950408889634f;

struct WgParams {
  int B, Sq, Skv, H, G, n_qt;
  int causal, window;             // window <= 0: no window
  float softcap, scale;           // softcap <= 0: no softcap
};

// Shared memory: the Q tile (later the O tile), then per stage a K and a V
// tile, each stored as DH / 64 column blocks of rows x 128 bytes in TMA's
// 128-byte swizzle (the canonical layout of wgmma's SW128 descriptors),
// then the barriers. Every tile starts on a 1024-byte boundary.
template <int DH>
struct WgSmem {
  static constexpr int kQ = kWgBQ * DH * 2;
  static constexpr int kKV = kWgBK * DH * 2;
  static constexpr int kBar = kQ + 2 * kWgStages * kKV;
  static constexpr int kBytes = kBar + 64 + 1024;   // + alignment slack
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// one box of a 4-d tensor map, coordinates innermost first (dh, head, seq,
// batch); rows past the tensor's edge arrive as zeros
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// rows past the tensor's edge are not written
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (each >> 4), layout type 1 in bits 62-63
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// named barriers of the two consumer groups (256 threads each)
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of wgmma's registers
// across the asynchronous product, and the registers of an A operand
// from being reused while the product in flight still reads them
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&a)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[j][i])::"memory");
}

// D(64 x 128) (+)= A(64 x 16, shared, K-major) * B(128 x 16, shared,
// K-major)^T; bf16 in, fp32 accumulate; scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      " %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D(64 x 64) += A(64 x 16, registers) * B(16 x 64, shared, MN-major:
// the transpose bit set); bf16 in, fp32 accumulate.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// S = Q K^T of tile `it` (stage it % kWgStages) into sc: waits for the
// tile to land, issues and commits the products, does not wait for them.
// q: this group's 64 rows of the Q tile.
template <int DH>
__device__ __forceinline__ void issue_s(float (&sc)[64],
                                        const unsigned char* q,
                                        const unsigned char* kv_s,
                                        uint32_t full0, int it) {
  constexpr int KD = DH / 16;
  const int s = it % kWgStages;
  mbar_wait(full0 + 8 * s, (it / kWgStages) & 1);
  const unsigned char* ks = kv_s + 2 * s * WgSmem<DH>::kKV;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    const int c = kk / 4, off = (kk % 4) * 32;   // 16 bf16 = 32 bytes
    wgmma_ss_n128(sc, sw128_desc(q + c * kWgBQ * 128 + off, 16, 1024),
                  sw128_desc(ks + c * kWgBK * 128 + off, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

// Warp specialised: warpgroup 0 is the producer (one thread issues TMA:
// the Q tile once, then K and V tiles into a 2-stage ring guarded by
// full / empty mbarriers); warpgroups 1 and 2 each own 64 q rows and run
// S = Q K^T (wgmma m64n128k16, both operands from shared memory), the
// online softmax on the accumulator registers, and O += P V (wgmma
// m64n64k16 with P from registers and V MN-major through the transpose
// bit). The accumulator fragment of S is, pair by pair, the register
// fragment of P, so P never touches shared memory. Accumulator layout
// (thread = 32 warp + 4 g + t of its group): S[4n + e] holds row
// 16 warp + g (+ 8 for e >= 2), key 8n + 2t + (e & 1).
template <int DH>
__global__ void __launch_bounds__(kWgThreads, 1)
    fa_fwd_wgmma_bf16(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap to,
                      const WgParams p) {
  using Sm = WgSmem<DH>;
  constexpr int NB = DH / kBox;          // 128-byte column blocks of a row
  constexpr int QB = kWgBQ * 128;        // bytes of one column block of Q
  constexpr int KB = kWgBK * 128;        // ... of K or V
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  unsigned char* smem =
      wg_smem + ((1024 - (smem_u32(wg_smem) & 1023)) & 1023);
  unsigned char* q_s = smem;
  unsigned char* kv_s = smem + Sm::kQ;   // stage s: K, then V
  const uint32_t qbar = smem_u32(smem + Sm::kBar);
  const uint32_t full0 = qbar + 8, empty0 = qbar + 8 + 8 * kWgStages;

  // heaviest q tiles first; the G q heads of one kv head on neighbouring
  // blocks, so that their K / V tiles are read from L2
  const int nbh = p.B * p.H;
  const int qt = p.n_qt - 1 - static_cast<int>(blockIdx.x) / nbh;
  const int bh = static_cast<int>(blockIdx.x) % nbh;
  const int b = bh / p.H, h = bh % p.H, kvh = h / p.G;
  const int q0 = qt * kWgBQ;
  const int q_last = min(q0 + kWgBQ, p.Sq) - 1;
  int k_lo = 0, k_hi = p.Skv;
  if (p.causal) k_hi = min(k_hi, q_last + 1);
  if (p.window > 0) k_lo = max(0, q0 - p.window + 1);
  const int t_lo = k_lo / kWgBK;
  const int t_hi = k_hi > k_lo ? (k_hi + kWgBK - 1) / kWgBK : t_lo;

  const int tid = threadIdx.x, wg = tid / 128;
  if (tid == 0) {   // the tensor maps' descriptors, fetched ahead of use
    for (const CUtensorMap* map : {&tq, &tk, &tv, &to})
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(map))
                   : "memory");
    mbar_init(qbar, 1);
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2);      // one arrival per consumer group
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {
      mbar_expect_tx(qbar, Sm::kQ);
      for (int c = 0; c < NB; ++c)
        tma_load(q_s + c * QB, &tq, qbar, c * kBox, h, q0, b);
      for (int t = t_lo, it = 0; t < t_hi; ++t, ++it) {
        const int s = it % kWgStages;
        mbar_wait(empty0 + 8 * s, ((it / kWgStages) & 1) ^ 1);
        mbar_expect_tx(full0 + 8 * s, 2 * Sm::kKV);
        unsigned char* ks = kv_s + 2 * s * Sm::kKV;
        for (int c = 0; c < NB; ++c) {
          tma_load(ks + c * KB, &tk, full0 + 8 * s, c * kBox, kvh,
                   t * kWgBK, b);
          tma_load(ks + Sm::kKV + c * KB, &tv, full0 + 8 * s, c * kBox, kvh,
                   t * kWgBK, b);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int w = wg - 1;                  // this group's rows: 64 w ..
  const int ctid = tid - 128 * wg;
  const int warp = ctid >> 5, lane = ctid & 31, g = lane >> 2, t4 = lane & 3;
  const int row0 = q0 + 64 * w + 16 * warp + g, row1 = row0 + 8;
  const int wrow_lo = q0 + 64 * w, wrow_hi = wrow_lo + 63;
  const float neg_inf = __int_as_float(0xff800000);

  float o[NB][32];
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // l: partial sums
  const float sl2 = p.scale * kLog2e;    // logits to base-2 exponents
  mbar_wait(qbar, 0);

  float sc[64];
  uint32_t pa[8][4];    // P of the tile whose P V is in flight
#pragma unroll
  for (int i = 0; i < 64; ++i) sc[i] = 0.f;

  // Per tile: wait for S (and the previous tile's P V), softmax, issue
  // P V, then issue the next tile's S behind it, so that the tensor cores
  // go from one product to the next without waiting for this thread.
  // The two groups take turns at the tensor cores (FlashAttention-3's
  // ping-pong): a group issues its products only after the other group
  // has issued its own, so one group's softmax runs while the other's
  // products do. Named barrier 3 + w is group w's turn.
  const int n_t = t_hi - t_lo;
  if (w == 1) named_arrive(3);          // group 0 goes first
  if (n_t > 0) {
    named_sync(3 + w);
    issue_s<DH>(sc, q_s + w * 64 * 128, kv_s, full0, 0);
    named_arrive(4 - w);
  }
  for (int it = 0; it < n_t; ++it) {
    const int s = it % kWgStages;
    wgmma_wait0();
    fence_regs(sc);
    fence_regs(pa);
#pragma unroll
    for (int c = 0; c < NB; ++c) fence_regs(o[c]);
    if (it > 0 && ctid == 0)      // the previous tile's stage is free again
      mbar_arrive(empty0 + 8 * ((it - 1) % kWgStages));

    // softcap and mask (only where the tile crosses an edge of this
    // group's rows), then the running max on the raw logits: scale and
    // log2(e) go into one FMA per exponent
    const int kbase = (t_lo + it) * kWgBK;
    const bool inside = kbase + kWgBK <= p.Skv &&
                        (!p.causal || kbase + kWgBK - 1 <= wrow_lo) &&
                        (p.window <= 0 || wrow_hi - kbase < p.window);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * n + e];
        if (p.softcap > 0.f)
          x = tanhf(x * p.scale / p.softcap) * (p.softcap / p.scale);
        if (!inside) {
          const int qpos = e < 2 ? row0 : row1;
          const int kpos = kbase + n * 8 + 2 * t4 + (e & 1);
          bool vis = kpos < p.Skv;
          if (p.causal) vis = vis && qpos >= kpos;
          if (p.window > 0) vis = vis && (qpos - kpos) < p.window;
          x = vis ? x : neg_inf;
        }
        sc[4 * n + e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x);
        else mx1 = fmaxf(mx1, x);
      }
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float al0 = ex2((m0 - mn0) * sl2), al1 = ex2((m1 - mn1) * sl2);
    const float b0 = -mn0 * sl2, b1 = -mn1 * sl2;
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pr = ex2(fmaf(sc[4 * n + e], sl2, e < 2 ? b0 : b1));
        sc[4 * n + e] = pr;
        if (e < 2) rs0 += pr;
        else rs1 += pr;
      }
    }
    l0 = l0 * al0 + rs0;
    l1 = l1 * al1 + rs1;
#pragma unroll
    for (int c = 0; c < NB; ++c) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        o[c][4 * n + 0] *= al0;
        o[c][4 * n + 1] *= al0;
        o[c][4 * n + 2] *= al1;
        o[c][4 * n + 3] *= al1;
      }
    }

    // P (rounded to bf16, unnormalized) @ V
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      pa[j][0] = pack_bf16(sc[8 * j + 0], sc[8 * j + 1]);
      pa[j][1] = pack_bf16(sc[8 * j + 2], sc[8 * j + 3]);
      pa[j][2] = pack_bf16(sc[8 * j + 4], sc[8 * j + 5]);
      pa[j][3] = pack_bf16(sc[8 * j + 6], sc[8 * j + 7]);
    }
    const unsigned char* vs = kv_s + (2 * s + 1) * Sm::kKV;
    named_sync(3 + w);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int c = 0; c < NB; ++c)
        wgmma_rs_n64(o[c], pa[j][0], pa[j][1], pa[j][2], pa[j][3],
                     sw128_desc(vs + c * KB + j * 16 * 128, KB, 1024));
    }
    wgmma_commit();
    if (it + 1 < n_t)
      issue_s<DH>(sc, q_s + w * 64 * 128, kv_s, full0, it + 1);
    named_arrive(4 - w);
  }
  if (w == 0) named_sync(3);            // group 1's last turn
  wgmma_wait0();
  fence_regs(pa);
#pragma unroll
  for (int c = 0; c < NB; ++c) fence_regs(o[c]);

  // O / max(l, 1e-30) in bf16, into this group's rows of the Q tile in the
  // same swizzled layout, then one TMA store per column block; rows past
  // Sq are clipped by TMA. One reciprocal a row and a multiply an element:
  // 64 fp32 divisions a thread cost more than a short tile's products,
  // and take their slow path where l is tiny (a row that sees no key)
  const float d0 = 1.f / fmaxf(quad_sum(l0), 1e-30f);
  const float d1 = 1.f / fmaxf(quad_sum(l1), 1e-30f);
  const int r0 = 16 * warp + g, r1 = r0 + 8;
#pragma unroll
  for (int c = 0; c < NB; ++c) {
    unsigned char* blk = q_s + c * QB + w * 64 * 128;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      *reinterpret_cast<uint32_t*>(blk + r0 * 128 + ((n ^ (r0 & 7)) << 4) +
                                   4 * t4) =
          pack_bf16(o[c][4 * n + 0] * d0, o[c][4 * n + 1] * d0);
      *reinterpret_cast<uint32_t*>(blk + r1 * 128 + ((n ^ (r1 & 7)) << 4) +
                                   4 * t4) =
          pack_bf16(o[c][4 * n + 2] * d1, o[c][4 * n + 3] * d1);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + w) : "memory");
  if (ctid == 0) {
    for (int c = 0; c < NB; ++c)
      tma_store(&to, q_s + c * QB + w * 64 * 128, c * kBox, h, wrow_lo, b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// cuTensorMapEncodeTiled, a driver-API function, resolved through the
// runtime so that nothing new is linked
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &res);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                            cudaEnableDefault, &res);
#endif
    if (e == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// a (B, S, heads, dh) bf16 tensor as a 4-d map, boxes of 64 x 1 x rows x 1
bool encode(EncodeTiled fn, CUtensorMap* map, const void* base, int dh,
            int heads, int S, int B, long long sh, long long ss,
            long long sb, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kBox, 1, (cuuint32_t)rows, 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
            const_cast<void*>(base), dims, strides, box, one,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// cudaFuncSetAttribute for kernel K, once per device
template <auto K>
cudaError_t allow_smem(int smem) {
  static unsigned long long done = 0;   // one bit a device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < 64 && (done >> dev & 1))) return e;
  e = cudaFuncSetAttribute(K, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e == cudaSuccess && dev < 64) done |= 1ull << dev;
  return e;
}

template <int DH>
cudaError_t launch_wgmma(const Params& p, cudaStream_t stream) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv, to;
  if (!encode(fn, &tq, p.q, DH, p.H, p.Sq, p.B, p.q_sh, p.q_ss, p.q_sb,
              kWgBQ) ||
      !encode(fn, &tk, p.k, DH, p.KV, p.Skv, p.B, p.k_sh, p.k_ss, p.k_sb,
              kWgBK) ||
      !encode(fn, &tv, p.v, DH, p.KV, p.Skv, p.B, p.v_sh, p.v_ss, p.v_sb,
              kWgBK) ||
      !encode(fn, &to, p.o, DH, p.H, p.Sq, p.B, p.o_sh, p.o_ss, p.o_sb,
              kWgBQ / 2))
    return cudaErrorInvalidValue;
  const WgParams w{p.B, p.Sq, p.Skv, p.H, p.G, (p.Sq + kWgBQ - 1) / kWgBQ,
                   p.causal, p.window, p.softcap, p.scale};
  const int smem = WgSmem<DH>::kBytes;
  const cudaError_t e = allow_smem<fa_fwd_wgmma_bf16<DH>>(smem);
  if (e != cudaSuccess) return e;
  fa_fwd_wgmma_bf16<DH><<<w.n_qt * p.B * p.H, kWgThreads, smem, stream>>>(
      tq, tk, tv, to, w);
  return cudaGetLastError();
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

// path: 0 = SIMT fp32, 1 = mma.sync bf16, 2 = wgmma bf16 (dh 64 / 128)
template <int DH>
cudaError_t launch_dh(int dtype, int path, const Params& p,
                      cudaStream_t stream) {
  if (path == 0 && dtype == 0)
    return launch(fa_fwd_simt_f32<DH>, kBQ,
                  smem_floats<DH>() * (int)sizeof(float), p, stream);
  if (path == 1 && dtype == 1)
    return launch(fa_fwd_mma_bf16<DH>, kMmaBQ, mma_smem_bytes<DH>(), p,
                  stream);
  if constexpr (DH == 64 || DH == 128) {
    if (path == 2 && dtype == 1) return launch_wgmma<DH>(p, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; path: the kernel to launch (see
// launch_dh), chosen by the caller from dtype and dh; a path that does not
// take (dtype, dh) is refused. strides: 12 element strides, (batch, seq,
// head) for q, k, v, o in that order. Returns a cudaError_t.
extern "C" int fa_fwd(const void* q, const void* k, const void* v, void* o,
                      int B, int Sq, int Skv, int H, int KV, int dh,
                      const long long* strides, int causal, int window,
                      float softcap, float scale, int dtype, int path,
                      void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || KV <= 0 || H % KV != 0 ||
      B * H > 65535)
    return cudaErrorInvalidValue;
  Params p{q, k, v, o, B, Sq, Skv, H, KV, H / KV,
           strides[0], strides[1], strides[2], strides[3], strides[4],
           strides[5], strides[6], strides[7], strides[8], strides[9],
           strides[10], strides[11], causal, window, softcap, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16: return launch_dh<16>(dtype, path, p, s);
    case 32: return launch_dh<32>(dtype, path, p, s);
    case 64: return launch_dh<64>(dtype, path, p, s);
    case 128: return launch_dh<128>(dtype, path, p, s);
    case 256: return launch_dh<256>(dtype, path, p, s);
    default: return cudaErrorInvalidValue;
  }
}
