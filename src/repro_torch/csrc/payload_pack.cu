// Payload pack / unpack (K1, K2) for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels of
// src/repro/kernels/payload_pack/payload_pack.py:
//   pp_pack   -> pack_kernel   (:60, body _pack_kernel :35-57)
//   pp_unpack -> unpack_kernel (:93, body _unpack_kernel :87-90)
//
// What they compute. R rows (endpoints) of N buffers, buffer j of
// shape (R, s_j) uint8 with its own row stride. pp_pack writes each
// row as [buf_0 | 0-pad to p_0 | buf_1 | 0-pad to p_1 | ...] into one
// contiguous (R, sum p_j) buffer (p_j >= s_j; the paper's serialized
// mode: one contiguous transfer instead of N). pp_unpack is the inverse
// split: buffer j of each row is packed[off_j : off_j + s_j].
//
// What bounds them: HBM bytes. Every payload byte is read once and
// written once, and there is no arithmetic, so the least time is
// (bytes read + bytes written) / 3.35 TB/s.
//
// What the design does about it:
//  - One launch covers every buffer and every row: the grid is
//    (chunk of the packed row, row). The Pallas kernel scans every
//    input for each output block; here a table of
//    (ptr, row stride, s_j, p_j, off_j) travels by value in the kernel's
//    parameters (__grid_constant__, read through the constant cache,
//    no host-to-device copy per call), and each block finds the first
//    entry of its chunk by binary search over off_j.
//  - Copies move 16 bytes a thread where source and destination share
//    their alignment modulo 16, four vectors in flight per thread, with
//    single bytes at the ragged head and tail of a span; buffers whose
//    alignment differs are copied byte by byte (serialization of
//    unaligned sizes; the paper's path is 128-byte aligned).
//  - pp_pack writes the zero pad [s_j, p_j) itself: the wrapper
//    allocates the output with torch.empty.
//  - The table holds 512 entries (20 KB of parameters), which needs the
//    32,764-byte parameter limit of CUDA >= 12.1.
// The wrapper (kernels/payload_pack/ops.py) checks devices, types,
// strides and the entry limit before it calls in.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecPerThread = 4;
// bytes of one packed row that one block covers
constexpr long long kChunk = 16LL * kThreads * kVecPerThread;   // 16 KiB
constexpr int kMaxEntries = 512;

struct Entry {
  unsigned long long ptr;   // buffer j, row 0
  long long stride;         // bytes between rows of buffer j
  long long size;           // s_j: payload bytes
  long long padded;         // p_j >= s_j: bytes it takes in the packed row
  long long off;            // where it starts in the packed row
};

struct Params {
  unsigned long long packed;  // packed row 0
  long long packed_stride;    // bytes between packed rows
  long long total;            // bytes of one packed row (sum of p_j)
  int n;                      // entries in use
  Entry e[kMaxEntries];
};

__device__ __forceinline__ void copy_span(uint8_t* __restrict__ dst,
                                          const uint8_t* __restrict__ src,
                                          long long n) {
  const int t = threadIdx.x;
  if (((reinterpret_cast<uintptr_t>(dst) ^ reinterpret_cast<uintptr_t>(src))
       & 15) != 0) {
    for (long long i = t; i < n; i += kThreads) dst[i] = src[i];
    return;
  }
  long long head = (16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15;
  if (head > n) head = n;
  if (t < head) dst[t] = src[t];
  const long long nv = (n - head) >> 4;
  uint4* dv = reinterpret_cast<uint4*>(dst + head);
  const uint4* sv = reinterpret_cast<const uint4*>(src + head);
  for (long long i = t; i < nv; i += kThreads * kVecPerThread) {
    uint4 r[kVecPerThread];
#pragma unroll
    for (int k = 0; k < kVecPerThread; ++k) {
      const long long v = i + k * kThreads;
      if (v < nv) r[k] = __ldg(sv + v);
    }
#pragma unroll
    for (int k = 0; k < kVecPerThread; ++k) {
      const long long v = i + k * kThreads;
      if (v < nv) dv[v] = r[k];
    }
  }
  for (long long i = head + (nv << 4) + t; i < n; i += kThreads)
    dst[i] = src[i];
}

__device__ __forceinline__ void zero_span(uint8_t* dst, long long n) {
  const int t = threadIdx.x;
  long long head = (16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15;
  if (head > n) head = n;
  if (t < head) dst[t] = 0;
  const long long nv = (n - head) >> 4;
  uint4* dv = reinterpret_cast<uint4*>(dst + head);
  for (long long i = t; i < nv; i += kThreads) dv[i] = make_uint4(0, 0, 0, 0);
  for (long long i = head + (nv << 4) + t; i < n; i += kThreads) dst[i] = 0;
}

// kPack: table buffers -> packed rows (K1); else packed rows -> table
// buffers (K2), pad bytes skipped.
template <bool kPack>
__global__ void __launch_bounds__(kThreads)
pp_kernel(const __grid_constant__ Params p) {
  const long long row = blockIdx.y;
  const long long c0 = static_cast<long long>(blockIdx.x) * kChunk;
  const long long c1 = c0 + kChunk < p.total ? c0 + kChunk : p.total;
  uint8_t* packed = reinterpret_cast<uint8_t*>(p.packed) +
                    row * p.packed_stride;
  // last entry starting at or before c0 (entries before it end by c0)
  int lo = 0, hi = p.n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (p.e[mid].off <= c0) lo = mid; else hi = mid - 1;
  }
  for (int j = lo; j < p.n && p.e[j].off < c1; ++j) {
    const Entry& e = p.e[j];
    uint8_t* buf = reinterpret_cast<uint8_t*>(e.ptr) + row * e.stride;
    const long long end = e.off + e.size;
    const long long a = c0 > e.off ? c0 : e.off;
    const long long b = c1 < end ? c1 : end;
    if (a < b) {
      if (kPack) copy_span(packed + a, buf + (a - e.off), b - a);
      else copy_span(buf + (a - e.off), packed + a, b - a);
    }
    if (kPack) {
      const long long pend = e.off + e.padded;
      const long long za = c0 > end ? c0 : end;
      const long long zb = c1 < pend ? c1 : pend;
      if (za < zb) zero_span(packed + za, zb - za);
    }
  }
}

template <bool kPack>
int launch(void* packed, long long packed_stride, long long total, int rows,
           int n, const long long* table, void* stream) {
  if (n < 1 || n > kMaxEntries || rows < 1 || rows > 65535 || total < 1 ||
      (total + kChunk - 1) / kChunk > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.packed = reinterpret_cast<unsigned long long>(packed);
  p.packed_stride = packed_stride;
  p.total = total;
  p.n = n;
  for (int j = 0; j < n; ++j) {
    const long long* t = table + 5 * j;
    p.e[j] = Entry{static_cast<unsigned long long>(t[0]), t[1], t[2], t[3],
                   t[4]};
  }
  const dim3 grid(static_cast<unsigned>((total + kChunk - 1) / kChunk),
                  static_cast<unsigned>(rows));
  pp_kernel<kPack><<<grid, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// table: n rows of (ptr, row stride, s_j, p_j, off_j), int64, host memory.
// Returns the cudaError_t of the launch (0 when it was accepted).
int pp_pack(void* packed, long long packed_stride, long long total,
            int rows, int n, const long long* table, void* stream) {
  return launch<true>(packed, packed_stride, total, rows, n, table, stream);
}

int pp_unpack(void* packed, long long packed_stride, long long total,
              int rows, int n, const long long* table, void* stream) {
  return launch<false>(packed, packed_stride, total, rows, n, table, stream);
}

}  // extern "C"
