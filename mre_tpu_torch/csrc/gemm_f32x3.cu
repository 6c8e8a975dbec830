// Float32 matrix product y[M, N] = x[M, K] · W[N, K]ᵀ (+ b[N]) for Hopper
// (sm_90a), on the tensor cores at float32 accuracy: three TF32 passes.
//
// It replaces no TPU kernel: the JAX package leaves its Dense products to
// XLA's dot, which the TPU's MXU runs in float32 passes of its own. The port
// ran them as cuBLAS SGEMM on the CUDA cores (TF32 off, core/device.py),
// about 46 TFLOP/s against their 67 peak, and they take most of a serving
// round's device time. This kernel is the float32 `Dense` of the encoder
// (models/initializers.py::dense) and of the LFM2 experts when autograd
// needs nothing from the product (ops/linear.py routes).
//
// Three passes (3xTF32): each operand value v splits into hi = v rounded to
// the nearest TF32 (an integer add and a mask, as csrc/attention_fwd.cu's
// split_tf32) and lo = the exact rest v - hi, which the tensor core reads as
// TF32 (its top 19 bits); hi·hi + hi·lo + lo·hi in float32 accumulators keeps
// about 21 bits of each operand, where one TF32 pass keeps 11 and misses the
// float32 tolerances of the serving cells by an order of magnitude
// (tests/test_torch_port_linear.py emulates both).
//
// What bounds it on an H100 (SXM, 700 W): the operations. At M3AE-huge's
// entity sweep (M 164,352 rows; K, N of 1280, 3840 and 5120) a product reads
// and writes ~1 ms of bytes at 3.35 TB/s against 1.1-4.4 ms of operations at
// the 495 TFLOP/s TF32 peak, counted once; the three passes make the floor
// three times that, 165 TFLOP/s of float32 work.
//
// Design (the hopper-kernels guide's shape): one output tile of BM 128 rows
// by BN 128 columns per block, warp-specialised. A producer warpgroup hands
// its registers to the consumers (`setmaxnreg`); one of its threads keeps a
// ring of STAGES k-slices in flight with TMA (`cp.async.bulk.tensor`,
// completion on `mbarrier`s): the x tile [BM, 32] and the hi and lo tiles
// [BN, 32] of W, each row one 128-byte swizzled box of 32 floats. Two
// consumer warpgroups of 64 rows each run `wgmma` m64n128k8: B (W's hi or
// lo) from shared memory, K-major as TF32 `wgmma` requires; A (x) from
// registers, read from the landed tile and split into hi and lo there, the
// next slice's A while the current slice's products run. W is split once per
// call, by a pass of its own (gemm_tf32_split_kernel) into a [2, N, K]
// scratch that the wrapper allocates: the split then costs one pass over W
// instead of one per row block (M / BM of them), and no weight copy outlives
// the call. x's K tail and the rows past M and N are zero-filled by TMA; the
// stores are masked. Blocks walk the tiles GROUP_N column tiles at a time,
// all row tiles of a group before the next, so the blocks in flight share a
// few of W's column tiles in L2. No split of K: a row's sums run in one order
// whatever M is, so a row's result does not depend on the rows beside it.
// The bias is added in the epilogue, which stores from the accumulators.
//
// Each slice's 12 `wgmma`s sum into a fresh accumulator, which the consumers
// then add to the tile's own in float32 on the CUDA cores. Summed across all
// of K on the tensor core instead, the error against float64 grew linearly
// with K, to 1.1e-5 of the largest output at K 1280 and 5.5e-5 at 7168
// against cuBLAS SGEMM's 1.9e-6 and 4.6e-6 (the tensor core's additions
// into its accumulator are not float32's rounded ones); per slice it is
// 4.7e-7 and 9.7e-7, under SGEMM's, for ~5% of the time. Those second
// accumulators are why BN is 128: at 256 they do not fit in registers.
// Measured on an H100 80GB HBM3 at 700 W (PERF.md §6): 111-120 TFLOP/s of
// float32 work at the serving shapes, 0.68-0.73 of the three-pass floor,
// against cuBLAS SGEMM's 49-51.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include "hopper.cuh"

namespace {

constexpr int SMEM_MAX = 232448;          // a block's dynamic shared memory on sm_90

// The tile: BM 128 rows (2 consumer warpgroups of 64) by BN 128 columns, BK
// 32 floats (one 128-byte swizzled row) a slice, a ring of 4 slices; blocks
// in raster groups of GROUP_N column tiles.
constexpr int BN = 128;
constexpr int GROUP_N = 4;
constexpr int BM = 128;
constexpr int BK = 32;
constexpr int CONSUMERS = 256;
constexpr int THREADS = CONSUMERS + 128;
constexpr int CONSUMER_REGS = 240;        // 2 × 128 × 240 + 128 × 24 = 64512 of 65536
constexpr int A_TILE = BM * BK * 4;
constexpr int B_TILE = BN * BK * 4;
constexpr int STAGE = A_TILE + 2 * B_TILE;                 // x, W hi, W lo
constexpr int STAGES = 4;
constexpr int BARS = STAGES * STAGE;
constexpr int BYTES = BARS + 2 * STAGES * 8 + 1024;        // + alignment slack
constexpr int ACC = BN / 2;                                // accumulators per thread
constexpr int KSTEPS = BK / 8;                             // k8 steps per slice
static_assert(BYTES <= SMEM_MAX, "the ring fits in shared memory");
static_assert(STAGE % 1024 == 0, "each tile on the 128-byte swizzle's 1024-byte period");

// box {c0 (k), c1 (row)} of a 2-D tensor map -> shared, completing on bar
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
    asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
                 "[%0], [%1, {%3, %4}], [%2];\n"
                 :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
                 : "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

#define GEMM_D8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                   "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// D (+)= A·B, m64n128k8, TF32 in, f32 accumulate; A from registers, B K-major from
// shared memory; scale_d 0 overwrites D
__device__ __forceinline__ void mma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
                 "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
                 "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
                 "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
                 : GEMM_D8(0), GEMM_D8(8), GEMM_D8(16), GEMM_D8(24), GEMM_D8(32),
                   GEMM_D8(40), GEMM_D8(48), GEMM_D8(56)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// W's hi and lo, once per call: w [N·K] -> split [2][N·K] (hi, then lo
// masked to TF32), four floats a thread per step
__global__ void gemm_tf32_split_kernel(const float4* __restrict__ w, float4* __restrict__ split,
                                       size_t n4) {
    for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n4;
         i += (size_t)gridDim.x * blockDim.x) {
        const float4 v = w[i];
        uint4 hi, lo;
        split_tf32(v.x, hi.x, lo.x);
        split_tf32(v.y, hi.y, lo.y);
        split_tf32(v.z, hi.z, lo.z);
        split_tf32(v.w, hi.w, lo.w);
        reinterpret_cast<uint4*>(split)[i] = hi;
        reinterpret_cast<uint4*>(split)[n4 + i] = lo;
    }
}

// two columns c, c + 1 of one row (c < N); float2 where N is even (8-byte
// aligned pairs)
__device__ __forceinline__ void store_pair(float* row, int c, int N, float a, float b) {
    if ((N & 1) == 0) {
        *reinterpret_cast<float2*>(row + c) = make_float2(a, b);
    } else {
        row[c] = a;
        if (c + 1 < N) row[c + 1] = b;
    }
}

__global__ void __launch_bounds__(THREADS, 1)
gemm_f32x3_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                  const float* __restrict__ bias, float* __restrict__ y, int M, int N, int K) {
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    const uint32_t bars = smem_addr(smem + BARS);
    auto full = [&](int s) { return bars + 8 * s; };               // slice landed
    auto empty = [&](int s) { return bars + 8 * (STAGES + s); };   // slice read

    // the block's tile: GROUP_N column tiles at a time, every row tile of a
    // group before the next group
    const int tiles_m = (M + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
    const int group = blockIdx.x / (GROUP_N * tiles_m);
    const int first_n = group * GROUP_N;
    const int width = min(GROUP_N, tiles_n - first_n);
    const int local = blockIdx.x - group * GROUP_N * tiles_m;
    const int n0 = (first_n + local % width) * BN;
    const int m0 = (local / width) * BM;
    const int slices = (K + BK - 1) / BK;
    const int tid = threadIdx.x;

    if (tid == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full(s), 1);                 // the producer's arrival (+ TMA bytes)
            mbar_init(empty(s), CONSUMERS / 32);   // one arrival per consumer warp
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (tid >= CONSUMERS) {
        // ---- producer: one thread's TMA loads of x, W hi and W lo ----
        asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
        if (tid != CONSUMERS) return;
        for (int kb = 0; kb < slices; ++kb) {
            const int s = kb % STAGES;
            mbar_wait(empty(s), ((kb / STAGES) & 1) ^ 1);
            mbar_arrive_expect_tx(full(s), STAGE);
            const uint32_t dst = smem_addr(smem + s * STAGE);
            tma_load_2d(dst, &tx, full(s), kb * BK, m0);
            tma_load_3d(dst + A_TILE, &tw, full(s), kb * BK, n0, 0);
            tma_load_3d(dst + A_TILE + B_TILE, &tw, full(s), kb * BK, n0, 1);
        }
        return;
    }

    // ---- consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the tile ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
    const int wg = tid / 128;
    const int warp = (tid % 128) / 32;
    const int lane = tid & 31;
    const int g = lane >> 2;        // fragment row of this lane (and g + 8)
    const int t = lane & 3;         // lane within its quad

    // A fragments of one slice, hi and lo: k-step s holds columns 8s + t and
    // 8s + t + 4 of rows g and g + 8 of this warp's 16. The x tile's rows are
    // 128-byte boxes, 16-byte chunk c of row r at c ^ (r % 8) (TMA's 128-byte
    // swizzle); rows g and g + 8 share r % 8 = g, and the quad's 4 lanes read
    // one chunk, so a warp's loads hit 32 distinct banks.
    auto load_a = [&](int s, uint32_t (&ah)[KSTEPS][4], uint32_t (&al)[KSTEPS][4]) {
        const unsigned char* a = smem + s * STAGE + (64 * wg + 16 * warp + g) * 128 + 4 * t;
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
            const int c0 = ((2 * kk) ^ g) << 4, c1 = ((2 * kk + 1) ^ g) << 4;
            split_tf32(*reinterpret_cast<const float*>(a + c0), ah[kk][0], al[kk][0]);
            split_tf32(*reinterpret_cast<const float*>(a + 8 * 128 + c0), ah[kk][1], al[kk][1]);
            split_tf32(*reinterpret_cast<const float*>(a + c1), ah[kk][2], al[kk][2]);
            split_tf32(*reinterpret_cast<const float*>(a + 8 * 128 + c1), ah[kk][3], al[kk][3]);
        }
    };

    float acc[ACC];
    float part[ACC];                // one slice's sums, on the tensor core
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[i] = 0.f;
    uint32_t ah0[KSTEPS][4], al0[KSTEPS][4], ah1[KSTEPS][4], al1[KSTEPS][4];

    // slice kb's products with its A fragments (ah, al), the next slice's A
    // into (nh, nl) while they run; then the slice's stage goes back to the
    // producer
    auto slice = [&](int kb, uint32_t (&ah)[KSTEPS][4], uint32_t (&al)[KSTEPS][4],
                     uint32_t (&nh)[KSTEPS][4], uint32_t (&nl)[KSTEPS][4]) {
        const int s = kb % STAGES;
        const uint32_t whi = smem_addr(smem + s * STAGE + A_TILE), wlo = whi + B_TILE;
        // the slice's products, from 0 (the tensor core's own sums over many
        // slices drift from float32's: see the head of the file)
        fence_regs(part);
        fence_regs(ah);
        fence_regs(al);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
            // k-step kk: bytes 32 kk of each swizzled row of W's tiles
            const uint64_t bh = smem_desc(whi + 32 * kk, 16, 1024, 1);
            const uint64_t bl = smem_desc(wlo + 32 * kk, 16, 1024, 1);
            mma_tf32(part, al[kk], bh, kk > 0);
            mma_tf32(part, ah[kk], bl, 1);
            mma_tf32(part, ah[kk], bh, 1);
        }
        wgmma_commit();
        if (kb + 1 < slices) {
            const int s1 = (kb + 1) % STAGES;
            mbar_wait(full(s1), ((kb + 1) / STAGES) & 1);
            load_a(s1, nh, nl);
        }
        wgmma_wait_all();
        fence_regs(part);
#pragma unroll
        for (int i = 0; i < ACC; ++i) acc[i] += part[i];   // float32 adds, rounded to nearest
        fence_regs(ah);
        fence_regs(al);
        if (lane == 0) mbar_arrive(empty(s));
    };

    mbar_wait(full(0), 0);
    load_a(0, ah0, al0);
    for (int kb = 0; kb < slices; kb += 2) {
        slice(kb, ah0, al0, ah1, al1);
        if (kb + 1 < slices) slice(kb + 1, ah1, al1, ah0, al0);
    }

    // epilogue: accumulator j of m64nBN holds rows g and g + 8, columns
    // 8j + 2t and 8j + 2t + 1 (acc[4j .. 4j + 3])
    const int r0 = m0 + 64 * wg + 16 * warp + g, r1 = r0 + 8;
    float* y0 = y + (size_t)r0 * N;
    float* y1 = y0 + (size_t)8 * N;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
        const int c = n0 + 8 * j + 2 * t;
        if (c >= N) continue;
        float b0 = 0.f, b1 = 0.f;
        if (bias != nullptr) {
            b0 = bias[c];
            if (c + 1 < N) b1 = bias[c + 1];
        }
        if (r0 < M) store_pair(y0, c, N, acc[4 * j + 0] + b0, acc[4 * j + 1] + b1);
        if (r1 < M) store_pair(y1, c, N, acc[4 * j + 2] + b0, acc[4 * j + 3] + b1);
    }
}

// float32 [depth, rows, K] with K innermost; boxes of [1, box_rows, 32] in
// the 128-byte swizzle; K past its end and rows past theirs zero-filled
int encode(CUtensorMap* map, const void* ptr, int depth, int rows, int K, int box_rows) {
    EncodeTiled fn = encoder();
    if (fn == nullptr) return -2;
    const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)rows, (cuuint64_t)depth};
    const cuuint64_t strides[2] = {(cuuint64_t)K * 4, (cuuint64_t)rows * K * 4};
    const cuuint32_t box[3] = {(cuuint32_t)BK, (cuuint32_t)box_rows, 1};
    const cuuint32_t step[3] = {1, 1, 1};
    CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, depth > 1 ? 3 : 2,
                    const_cast<void*>(ptr), dims, strides, box, step,
                    CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                    CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : -3;
}

}  // namespace

// Plain C entry point, loaded with ctypes. x: contiguous float32 [M, K]; w:
// contiguous float32 [N, K]; bias: float32 [N] or null; split: float32
// scratch of 2·N·K (W's hi and lo, written here); y: float32 [M, N]. x, w and
// split 16-byte aligned, K % 4 == 0 (TMA's 16-byte strides). Returns
// cudaGetLastError() after the launches (0 = launched), -1 on a shape it does
// not take, -2 when the driver has no cuTensorMapEncodeTiled, -3 when it
// refuses a tensor map, -4 when the tile does not fit in shared memory.
extern "C" int gemm_f32x3(const void* x, const void* w, const void* bias, void* split, void* y,
                          int M, int N, int K, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (M <= 0 || N <= 0 || K <= 0 || K % 4 != 0) return -1;
    const long long tiles = (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
    if (tiles > 0x7fffffffLL) return -1;
    if (BYTES > SMEM_MAX) return -4;
    CUtensorMap tx, tw;
    int rc = encode(&tx, x, 1, M, K, BM);
    if (rc == 0) rc = encode(&tw, split, 2, N, K, BN);
    if (rc != 0) return rc;
    const cudaError_t attr = cudaFuncSetAttribute(
        gemm_f32x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
    if (attr != cudaSuccess) return (int)attr;
    const size_t n4 = (size_t)N * K / 4;
    const int split_blocks = (int)((n4 + 255) / 256 < 132 * 8 ? (n4 + 255) / 256 : 132 * 8);
    gemm_tf32_split_kernel<<<split_blocks, 256, 0, s>>>(
        static_cast<const float4*>(w), static_cast<float4*>(split), n4);
    gemm_f32x3_kernel<<<(unsigned)tiles, THREADS, BYTES, s>>>(
        tx, tw, static_cast<const float*>(bias), static_cast<float*>(y), M, N, K);
    return (int)cudaGetLastError();
}
