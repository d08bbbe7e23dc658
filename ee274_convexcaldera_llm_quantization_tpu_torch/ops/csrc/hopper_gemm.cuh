// Hopper (sm_90a) building blocks of a TMA + wgmma matrix product, for the
// port's tensor-core kernels: host-side tensor-map encoding and the raise of
// a kernel's shared memory limit, the mbarrier
// ring, the TMA tile load, and the wgmma shared-memory descriptors, fences
// and m64nNk16 bf16 x bf16 -> f32 instructions. For packed codes: a map of
// uint8 rows in 64-byte swizzled boxes and its offsets (sw64_u8), a 3-d map
// of a bf16 matrix cut into planes, and its 3-d TMA load. For f32 operands
// on the tensor cores (3xTF32): a map of 4-d f32 tensors in 128-byte swizzled boxes
// of 32-value rows, its 4-d TMA load and element offsets, the tf32 split,
// the m64nNk8 tf32 instructions and the async-proxy fence. For int8
// products: a map of uint8 rows in 128-byte swizzled boxes, a 3-d map of an
// int8 matrix cut into planes, the m64n144k32 s8 x u8 -> s32 instruction
// and the m64nNk32 s8 x s8 -> s32 ones (a 128-byte swizzled row of an 8-bit
// tile is 128 k, and k32 slice kk starts 32 kk bytes in, as a bf16 k16
// slice does). For f32 outputs: a map of f32 rows in 128-byte swizzled boxes
// and the TMA store with its bulk-group commit and waits.
//
// Every tile these pieces describe is a stack of K-major rows of 64 bf16
// (128 bytes), loaded by TMA with the 128-byte swizzle into shared memory at
// a 1024-byte boundary: 8 rows make one 1024-byte swizzle atom, which is the
// layout desc_sw128 describes (leading offset unused, 1024 bytes between
// 8-row groups). Within a tile, k slice kk of 16 values starts 32 * kk bytes
// in. Both wgmma operands are read that way (A and B "K-major", no
// transpose), so D (64 x n) = A (64 x k) * B (n x k)^T: the layout of
// y = x @ W.T with x (M, K) and W (N, K) both row-major.
#pragma once

#include <atomic>
#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

namespace hopper {

// ---------------------------------------------------------------------------
// Host: tensor maps
// ---------------------------------------------------------------------------

// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime's
// entry-point query, so that no -lcuda link is needed.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    return err == cudaSuccess && status == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The map of a row-major bf16 matrix (rows, cols) with a row stride of ld
// elements, in boxes of box_rows rows x 64 columns (128-byte swizzle). TMA
// fills the part of a box outside the matrix with zeros. The base must be
// 16-byte aligned and ld % 8 == 0 (16-byte row strides). False on failure.
inline bool map_bf16_rows(CUtensorMap* map, const void* base, uint64_t rows,
                          uint64_t cols, uint64_t ld, uint32_t box_rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {ld * 2};
  const cuuint32_t box[2] = {64, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The map of a row-major f32 tensor of 4 dims, dims[0] innermost (dense),
// ld[i] the element stride of dims[i + 1], in boxes of 32 x box[0] x box[1]
// x box[2] values (128-byte swizzle: one box row is 32 f32). TMA fills the
// part of a box outside the tensor with zeros, and still counts its bytes.
// The base must be 16-byte aligned and each ld a multiple of 4. False on
// failure.
inline bool map_f32_4d(CUtensorMap* map, const void* base,
                       const uint64_t (&dims)[4], const uint64_t (&ld)[3],
                       const uint32_t (&box)[3]) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t gdims[4] = {dims[0], dims[1], dims[2], dims[3]};
  const cuuint64_t strides[3] = {ld[0] * 4, ld[1] * 4, ld[2] * 4};
  const cuuint32_t gbox[4] = {32, box[0], box[1], box[2]};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(base),
             gdims, strides, gbox, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The map of a row-major f32 matrix (rows, cols) with a row stride of ld
// values, in boxes of box_rows rows x 32 values (128-byte swizzle: the
// layout sw128_f32 addresses), for TMA stores: a box's values outside the
// matrix are not written. The base must be 16-byte aligned and ld % 4 == 0.
// False on failure.
inline bool map_f32_rows(CUtensorMap* map, const void* base, uint64_t rows,
                         uint64_t cols, uint64_t ld, uint32_t box_rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {ld * 4};
  const cuuint32_t box[2] = {32, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The map of a row-major uint8 matrix (rows, cols) with a row stride of ld
// bytes, in boxes of box_rows rows x 64 bytes with the 64-byte swizzle (the
// 16-byte chunk c of row r lands at chunk c ^ ((r / 2) % 4): sw64_u8). TMA
// fills the part of a box outside the matrix with zeros. The base must be
// 16-byte aligned and ld % 16 == 0. False on failure.
inline bool map_u8_rows(CUtensorMap* map, const void* base, uint64_t rows,
                        uint64_t cols, uint64_t ld, uint32_t box_rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {ld};
  const cuuint32_t box[2] = {64, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The map of a row-major uint8 matrix (rows, cols) with a row stride of ld
// bytes, in boxes of box_rows rows x 128 bytes with the 128-byte swizzle
// (the layout desc_sw128 describes, one byte a value). TMA fills the part of
// a box outside the matrix with zeros. The base must be 16-byte aligned and
// ld % 16 == 0. False on failure.
inline bool map_u8_rows128(CUtensorMap* map, const void* base, uint64_t rows,
                           uint64_t cols, uint64_t ld, uint32_t box_rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {ld};
  const cuuint32_t box[2] = {128, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The map of a row-major int8 matrix (rows, planes * P) viewed as (rows,
// planes, P), the int8 counterpart of map_bf16_planes: boxes of box_rows
// rows x 1 plane x 128 bytes (128-byte swizzle), zero-filled past the end of
// a plane or past the last row. The base must be 16-byte aligned and
// P % 16 == 0. False on failure.
inline bool map_i8_planes(CUtensorMap* map, const void* base, uint64_t rows,
                          uint64_t planes, uint64_t P, uint32_t box_rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {P, planes, rows};
  const cuuint64_t strides[2] = {P, planes * P};
  const cuuint32_t box[3] = {128, 1, box_rows};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(base),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The map of a row-major bf16 matrix (rows, planes * P) viewed as (rows,
// planes, P): plane p of row m is columns p P .. p P + P - 1. Boxes of
// box_rows rows x 1 plane x 64 values (128-byte swizzle, the layout
// desc_sw128 describes). TMA fills the part of a box past the end of a plane
// (or past the last row) with zeros, so a box never reads the next plane's
// values. The base must be 16-byte aligned and P % 8 == 0. False on failure.
inline bool map_bf16_planes(CUtensorMap* map, const void* base, uint64_t rows,
                            uint64_t planes, uint64_t P, uint32_t box_rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {P, planes, rows};
  const cuuint64_t strides[2] = {P * 2, planes * P * 2};
  const cuuint32_t box[3] = {64, 1, box_rows};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Raises a kernel's dynamic shared memory limit once per device, where it
// needs more than the default 48 KB. Internal linkage (static): each library
// that includes this keeps its own record, also beside another build of the
// same source loaded in the process (a function-local static of a template
// with external linkage would be one symbol for all of them). Not an unnamed
// namespace: a source that puts `using namespace hopper` at file scope would
// then see two, and nvcc's registration of its own unnamed-namespace kernels
// would no longer compile.
template <auto Kernel>
static cudaError_t allow_smem(int bytes) {
  static std::atomic<unsigned long long> done{0};
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

// ---------------------------------------------------------------------------
// Device: shared memory, mbarriers, TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The block's dynamic shared memory from its first 1024-byte boundary (ask
// for 1024 bytes more than the tiles need).
__device__ __forceinline__ uint8_t* smem_1k() {
  extern __shared__ uint8_t dyn_smem[];
  const uint32_t a = smem_u32(dyn_smem);
  return dyn_smem + ((1024u - (a & 1023u)) & 1023u);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// After every mbar_init of the block, before any thread uses the barriers.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also expects `bytes` of TMA transactions on the barrier.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Spin until the barrier's phase of the given parity has completed. A fresh
// barrier is in phase 0, so waiting on parity 1 returns at once: a ring's
// producer waits on (round & 1) ^ 1 for its free slots, its consumers on
// round & 1 for the full ones.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// One thread: TMA-load the box at (column c0, row c1) of `map` into `dst`,
// completing its bytes on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// One thread: TMA-load the box at (c0, c1, c2) of a 3-d `map` into `dst`,
// completing its bytes on `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// One thread: TMA-load the box at (c0, c1, c2, c3) of a 4-d `map` into
// `dst`, completing its bytes on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// One thread: TMA-store the box at `src` (shared memory, written by the
// generic proxy, then fence_proxy_async and a barrier) to (column c0, row c1)
// of a 2-d `map`, in this thread's current bulk group; the part of the box
// outside the tensor is not written.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], "
      "[%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}

// Closes this thread's bulk group of TMA stores.
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's bulk groups still read their
// shared-memory sources (the sources may then be written again).
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Waits until at most N of this thread's bulk groups are incomplete (their
// writes done).
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// The offset, in f32 values, of (row, col) in a tile of 32-value rows that
// TMA stored with the 128-byte swizzle at a 1024-byte boundary: the 16-byte
// chunk col / 4 of a row sits at chunk (col / 4) ^ (row % 8).
__device__ __forceinline__ int sw128_f32(int row, int col) {
  return row * 32 + ((((col >> 2) ^ row) & 7) << 2) + (col & 3);
}

// The byte offset of (row, col) in a tile of 64-byte rows that TMA stored
// with the 64-byte swizzle at a 512-byte boundary: the 16-byte chunk col / 16
// of a row sits at chunk (col / 16) ^ ((row / 2) % 4).
__device__ __forceinline__ int sw64_u8(int row, int col) {
  return row * 64 + ((((col >> 4) ^ (row >> 1)) & 3) << 4) + (col & 15);
}

// The named barrier `id` (1..15) over `threads` threads of the block.
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Split-K: called by the `threads` consumer threads (thread 0 among them) of
// a CTA once its partial tile is in the workspace: true in the last of the
// tile's `splits` CTAs to get here, which then reads every partial (and has
// set the tile's counter back to 0 for the next launch on the stream).
__device__ __forceinline__ bool last_split(int* counter, int splits,
                                           int threads, int* flag) {
  __threadfence();
  bar_sync(1, threads);
  if (threadIdx.x == 0) {
    *flag = atomicAdd(counter, 1) == splits - 1;
    if (*flag) *counter = 0;
  }
  bar_sync(1, threads);
  const bool last = *flag;
  if (last) __threadfence();
  return last;
}

// Split-K's epilogue for a swap-AB tile of ROWS x NT f32 held in wgmma's D
// fragments, transposed: a thread's accumulator e = 4 c + 2 i + j is row
// rl + 8 i, column 8 c + 2 t + j of the tile (t = lane % 4). Stores v, the
// CTA's partial, to split `split`'s slot of ws (splits x tiles x ROWS x NT
// f32), then (last_split over `threads` threads) in the last of the tile's
// CTAs to arrive sets v to the partials summed in split order and returns
// true, so the sum does not depend on which CTA came last.
template <int ROWS, int NT>
__device__ __forceinline__ bool splitk_sum(float (&v)[NT / 2], float* ws,
                                           int* counters, int tile, int tiles,
                                           int split, int splits, int rl,
                                           int t, int threads, int* flag) {
  float* part = ws + ((size_t)split * tiles + tile) * ROWS * NT;
#pragma unroll
  for (int c = 0; c < NT / 8; ++c)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<float2*>(part + (rl + 8 * i) * NT + 8 * c + 2 * t) =
          make_float2(v[4 * c + 2 * i], v[4 * c + 2 * i + 1]);
  if (!last_split(counters + tile, splits, threads, flag)) return false;
#pragma unroll
  for (int e = 0; e < NT / 2; ++e) v[e] = 0.f;
  for (int sp = 0; sp < splits; ++sp) {
    const float* p = ws + ((size_t)sp * tiles + tile) * ROWS * NT;
#pragma unroll
    for (int c = 0; c < NT / 8; ++c)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float2 q2 = __ldcg(reinterpret_cast<const float2*>(
            p + (rl + 8 * i) * NT + 8 * c + 2 * t));
        v[4 * c + 2 * i] = __fadd_rn(v[4 * c + 2 * i], q2.x);
        v[4 * c + 2 * i + 1] = __fadd_rn(v[4 * c + 2 * i + 1], q2.y);
      }
  }
  return true;
}

// ---------------------------------------------------------------------------
// Device: wgmma
// ---------------------------------------------------------------------------

// The descriptor of a K-major, 128-byte-swizzled tile at p (see the top).
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFFu) >> 4) | (uint64_t)1 << 16 |
         (uint64_t)(1024 >> 4) << 32 | (uint64_t)1 << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous wgmma that owns them.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The same for s32 accumulators.
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D (64 x 144, s32, 72 registers a thread) += A (64 x 32, s8) *
// B (144 x 32, u8)^T, both in shared memory, K-major, 128-byte swizzle.
__device__ __forceinline__ void wgmma_m64n144k32_s8u8(int (&d)[72],
    uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %74, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k32.s32.s8.u8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71"
      "}, %72, %73, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71])
      : "l"(a), "l"(b), "r"(1));
}

// D (64 x 64, s32, 32 registers a thread) += A (64 x 32, s8) *
// B (64 x 32, s8)^T, both in shared memory, K-major, 128-byte swizzle.
__device__ __forceinline__ void wgmma_m64n64k32_s8s8(int (&d)[32], uint64_t a,
    uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// D (64 x 128, s32, 64 registers a thread) += A (64 x 32, s8) *
// B (128 x 32, s8)^T, both in shared memory, K-major, 128-byte swizzle.
__device__ __forceinline__ void wgmma_m64n128k32_s8s8(int (&d)[64], uint64_t a,
    uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// D (64 x 256, s32, 128 registers a thread) += A (64 x 32, s8) *
// B (256 x 32, s8)^T, both in shared memory, K-major, 128-byte swizzle.
__device__ __forceinline__ void wgmma_m64n256k32_s8s8(int (&d)[128], uint64_t a,
    uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
        "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),
        "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
        "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

// The s8 x s8 instruction of width n (64, 128 or 256).
template <int N>
__device__ __forceinline__ void wgmma_m64k32_s8s8(int (&d)[N / 2], uint64_t a,
                                                  uint64_t b) {
  if constexpr (N == 64) {
    wgmma_m64n64k32_s8s8(d, a, b);
  } else if constexpr (N == 128) {
    wgmma_m64n128k32_s8s8(d, a, b);
  } else {
    static_assert(N == 256, "wgmma width: 64, 128 or 256");
    wgmma_m64n256k32_s8s8(d, a, b);
  }
}

// D (64 x 8, f32, 4 registers a thread) += A (64 x 16) * B (8 x 16)^T,
// both operands bf16 in shared memory, K-major, 128-byte swizzle.
__device__ __forceinline__ void wgmma_m64n8k16(float (&d)[4], uint64_t a,
    uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(1));
}

// D (64 x 16, f32, 8 registers a thread) += A (64 x 16) * B (16 x 16)^T,
// both operands bf16 in shared memory, K-major, 128-byte swizzle.
__device__ __forceinline__ void wgmma_m64n16k16(float (&d)[8], uint64_t a,
    uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(1));
}

// D (64 x 64, f32, 32 registers a thread) += A (64 x 16) * B (64 x 16)^T,
// both operands bf16 in shared memory, K-major, 128-byte swizzle.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t a,
    uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// D (64 x 128, f32, 64 registers a thread) += A (64 x 16) * B (128 x 16)^T,
// both operands bf16 in shared memory, K-major, 128-byte swizzle.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a,
    uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}


// The instruction of width n (8, 16 or 128).
template <int N>
__device__ __forceinline__ void wgmma_m64k16(float (&d)[N / 2], uint64_t a,
                                             uint64_t b) {
  if constexpr (N == 8) {
    wgmma_m64n8k16(d, a, b);
  } else if constexpr (N == 16) {
    wgmma_m64n16k16(d, a, b);
  } else {
    static_assert(N == 128, "wgmma width: 8, 16 or 128");
    wgmma_m64n128k16(d, a, b);
  }
}

// bf16 wgmma with A from registers: lane 4 g + t of warp w holds rows
// 16 w + g and 16 w + g + 8 of the 64 x 16 A slice, two bf16 a register (the
// lower column in the low half): a[0] (row 16 w + g, columns 2 t, 2 t + 1),
// a[1] (row + 8, the same columns), a[2] (row 16 w + g, columns 2 t + 8,
// 2 t + 9), a[3] (row + 8, those columns). B bf16 in shared memory, K-major,
// 128-byte swizzle; D is overwritten when `accumulate` is 0. ptxas
// serializes a product whose register inputs are written while another
// product is in flight (warning C7513), so write every A register of a batch
// before its first product.

// D (64 x 8, f32, 4 registers a thread) += A (64 x 16, registers) *
// B (8 x 16)^T.
__device__ __forceinline__ void wgmma_m64n8k16_rs(float (&d)[4],
    const uint32_t (&a)[4], uint64_t b, int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// D (64 x 16, f32, 8 registers a thread) += A (64 x 16, registers) *
// B (16 x 16)^T.
__device__ __forceinline__ void wgmma_m64n16k16_rs(float (&d)[8],
    const uint32_t (&a)[4], uint64_t b, int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// D (64 x 64, f32, 32 registers a thread) += A (64 x 16, registers) *
// B (64 x 16)^T.
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
    const uint32_t (&a)[4], uint64_t b, int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// D (64 x 128, f32, 64 registers a thread) += A (64 x 16, registers) *
// B (128 x 16)^T.
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
    const uint32_t (&a)[4], uint64_t b, int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// The A-in-registers bf16 instruction of width n (8, 16, 64 or 128).
template <int N>
__device__ __forceinline__ void wgmma_m64k16_rs(float (&d)[N / 2],
                                                const uint32_t (&a)[4],
                                                uint64_t b,
                                                int accumulate = 1) {
  if constexpr (N == 8) {
    wgmma_m64n8k16_rs(d, a, b, accumulate);
  } else if constexpr (N == 16) {
    wgmma_m64n16k16_rs(d, a, b, accumulate);
  } else if constexpr (N == 64) {
    wgmma_m64n64k16_rs(d, a, b, accumulate);
  } else {
    static_assert(N == 128, "wgmma width: 8, 16, 64 or 128");
    wgmma_m64n128k16_rs(d, a, b, accumulate);
  }
}

// wgmma in tf32 (m64nNk8: 8 f32 values, 32 bytes, per k slice, so the
// k-slice offsets and descriptors are those of the bf16 k16 slices above).

// D (64 x 32, f32, 16 registers a thread) (+)= A (64 x 8) * B (32 x 8)^T, both
// tf32 in shared memory, K-major, 128-byte swizzle; D is overwritten when
// `accumulate` is 0.
__device__ __forceinline__ void wgmma_m64n32k8_tf32_ss(float (&d)[16],
    uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D (64 x 32, f32, 16 registers a thread) (+)= A (64 x 8) * B (32 x 8)^T, A
// tf32 in registers (lane 4 g + t of warp w holds rows 16 w + g, + 8 at
// columns t, then t + 4), B tf32 in shared memory, K-major, 128-byte
// swizzle; D is overwritten when `accumulate` is 0.
__device__ __forceinline__ void wgmma_m64n32k8_tf32_rs(float (&d)[16],
    const uint32_t (&a)[4], uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// D (64 x 64, f32, 32 registers a thread) (+)= A (64 x 8) * B (64 x 8)^T, A
// tf32 in registers (lane 4 g + t of warp w holds rows 16 w + g, + 8 at
// columns t, then t + 4), B tf32 in shared memory, K-major, 128-byte
// swizzle; D is overwritten when `accumulate` is 0.
__device__ __forceinline__ void wgmma_m64n64k8_tf32_rs(float (&d)[32],
    const uint32_t (&a)[4], uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// D (64 x 128, f32, 64 registers a thread) (+)= A (64 x 8) * B (128 x 8)^T, A
// tf32 in registers (lane 4 g + t of warp w holds rows 16 w + g, + 8 at
// columns t, then t + 4), B tf32 in shared memory, K-major, 128-byte
// swizzle; D is overwritten when `accumulate` is 0.
__device__ __forceinline__ void wgmma_m64n128k8_tf32_rs(float (&d)[64],
    const uint32_t (&a)[4], uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// The A-in-registers instruction of width n (32, 64 or 128).
template <int N>
__device__ __forceinline__ void wgmma_m64k8_tf32_rs(float (&d)[N / 2],
                                                    const uint32_t (&a)[4],
                                                    uint64_t b,
                                                    int accumulate) {
  if constexpr (N == 32) {
    wgmma_m64n32k8_tf32_rs(d, a, b, accumulate);
  } else if constexpr (N == 64) {
    wgmma_m64n64k8_tf32_rs(d, a, b, accumulate);
  } else {
    static_assert(N == 128, "wgmma width: 32, 64 or 128");
    wgmma_m64n128k8_tf32_rs(d, a, b, accumulate);
  }
}

// Orders this thread's generic-proxy writes to shared memory before later
// reads of it by the async proxy (wgmma, TMA).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// Device: tf32 (3xTF32 products of f32 operands)
// ---------------------------------------------------------------------------

// x rounded to tf32 (10-bit mantissa, to nearest, ties away from zero), as
// f32 bits with the low 13 bits clear: cvt.rna.tf32.f32, taken as two
// integer operations on the bits (half of the dropped 13 bits added to the
// magnitude, then cleared). On an H100 the two gave the same bits, and the
// integer form ran faster.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small + O(2^-22 |x|): big = tf32_rna(x), small = tf32_rna(x -
// big) (the difference is exact in f32). A product a * b is then taken as
// a.big b.small + a.small b.big + a.big b.big: three tf32 products, each
// exact; the dropped a.small b.small is O(2^-22 |a b|). The tensor cores
// round their f32 sums toward zero, so a long chain of products on one
// accumulator drifts toward zero: keep chains short, on fresh accumulators
// added to the running sum in f32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

}  // namespace hopper
