// Masked multi-head attention forward for Hopper (sm_90a), on the tensor cores.
//
// Replaces both TPU kernel bodies of mre_tpu/ops/pallas/attention.py, each
// launched by `_pallas_forward` through `pl.pallas_call` at line 170:
//
// * `_attention_kernel` (lines 81-91), head_dim >= 64: the M3AE encoder
//   (6 heads of 64 at the `small` preset; 80 at `huge`);
// * `_attention_kernel_packed` (lines 94-136), head_dim < 64: the M3AE decoder
//   (16 heads of 32 at every preset). On the TPU it stacks four 32-wide heads
//   block-diagonally into one 128-lane MXU operand; its output is, head for
//   head, the same function as `_attention_kernel`. The packing is a TPU lane
//   trick with nothing to fill here: the port runs the same kernel at HD = 32.
//
// Same function, per (b, h):
//
//     out = softmax(where(pad > 0, -1e7, (q . k^T) * scale)) . v
//
// with the logit scaled after the dot product, the exact where-select value
// -1e7 at PAD keys (so a fully masked row is a uniform average, as in the
// reference), keys at N and beyond excluded with -inf, softmax and sums in
// float32, and the output in the input type (float32 or bfloat16).
//
// What bounds it on an H100 (SXM, 700 W). At the entity-sweep shape of
// M3AE-small (B 512, H 6, N 321, hd 64) the work is 4·B·H·N²·hd = 81 GFLOP
// against 1.01 GB of q, k, v and out in float32: 0.30 ms of memory at
// 3.35 TB/s, 0.16 ms of arithmetic at the TF32 tensor-core peak. bfloat16 is
// bound by bytes (0.15 ms against 0.08 ms at 989 TFLOP/s, 0.12 ms with the
// second P·V pass below). float32 runs three TF32 passes (below) and so is
// bound by operations: 3 × 81 GFLOP / 495 TFLOP/s = 0.49 ms, about 0.64 ms
// with the float32 tiles below over N 321 (384 · 352 / 321² of the products).
// At M3AE-huge's entity shape (B 512, H 16, N 321, hd 80: 270 GFLOP, 3.37 GB
// in float32) the bound is 1.01 ms of bytes, the three-pass floor 1.64 ms;
// bfloat16 0.50 ms of bytes.
//
// One design for every head_dim (32, 64, 80) and both types, Hopper's own.
// Warp-specialised blocks: WG consumer warpgroups of 64 query rows each and
// one producer warp (with 2 consumer warpgroups, a whole producer warpgroup
// that hands its registers to them with `setmaxnreg`; one of its warps
// works). The producer keeps a ring of STAGES K/V tiles of BK keys in flight
// with TMA (`cp.async.bulk.tensor`, 3-D tensor maps [B·H, N, hd] with hd
// innermost, so a tile past N is zero-filled inside its own (b, h)),
// completion on `mbarrier`s, and writes each key's code beside its tile: the
// (mul, add) that turns q·k into the logit in log2 units with one FMA
// (scale·log2 e at a real key, the where-select -1e7 at PAD, -inf past N), so
// the softmax runs on ex2. The consumers run warpgroup MMA
// (`wgmma.mma_async`) with A from registers: S = Q·K^T (m64nBKk16 /
// m64nBKk8), the online softmax on the accumulators, O += P·V (m64nHDk16 /
// m64nHDk8) with P taken from S's accumulators as the next A fragment (each
// warp owns 16 rows, each quad of lanes two of them, so a row's max and sum
// are two shuffles across its quad). The loop is pipelined
// inside each warpgroup, as in FlashAttention-3: tile i's S is issued
// together with tile i-1's P·V, and tile i's exponentials run while that P·V
// is on the tensor cores.
// - bfloat16: K and V are read by `wgmma` where TMA lands them (128-byte
//   swizzle at hd 64 and 80, 64-byte at hd 32): K as the K-major B of Q·K^T,
//   V as the MN-major B of P·V (the transpose bit). P is split into bf16
//   hi + lo and multiplied in two passes, so P·V keeps float32 precision.
// - float32: three TF32 passes (3xTF32): each operand x splits into
//   hi = tf32(x) and lo = tf32(x - hi) (split_tf32) and hi·hi + hi·lo +
//   lo·hi is summed in f32, about 21 bits of each operand; one TF32 pass
//   keeps 10 and leaves errors of 1e-4..1e-3 at these shapes, outside the
//   float32 tolerance (tests/test_torch_port_attention.py emulates both).
//   TF32 `wgmma` takes K-major operands only, and B from shared memory, so
//   the consumers split every raw tile in shared memory into hi and lo
//   tiles in the 128-byte-swizzled layout `wgmma` reads: K as it is, V
//   transposed to [hd][key]. The transpose writes each 8-key group in the
//   order of P's register fragment (A column t = key 2t, column t + 4 =
//   key 2t + 1): a sum over keys does not care about their order, so P
//   never leaves registers. The split costs a pass over each tile per
//   block; the 2 consumer warpgroups share it (named barriers), and the
//   split tiles are double-buffered.
//
// head_dim 80 (M3AE-huge). Its rows, 160 bytes in bf16 and 320 in float32,
// fill no swizzle mode whole. Each row is cut into boxes of one swizzle
// width (64 bf16 or 32 floats, 128 bytes), ⌈80 / box⌉ of them: 2 in bf16,
// 3 in float32, the last one only partly real. The tensor map's inner
// extent stays 80, so TMA zero-fills the pad columns of the last box and
// reads nothing for them; the transaction bytes an `mbarrier` expects count
// whole boxes, pad included. One box width for every box keeps one tensor
// map per tensor and one swizzle per operand; the other choice (bf16 only:
// a second, 16-wide box with 32-byte swizzle) would save 48 bytes of shared
// memory per key row for a second map and a second descriptor form. No
// `wgmma` step reads the pad: S = Q·K^T takes 5 k16 (10 k8) steps, steps
// 0-3 (0-7) in box 0 (boxes 0-1) and the rest in the last box's real
// columns, and P·V's N is 80 (m64n80k16 / m64n80k8): in bf16 its MN-major V
// spans two swizzle atoms, the descriptor's leading byte offset stepping from
// box 0 to box 1; in float32 V^T has 80 rows of 32 keys.
//
// The tile (ATTN_BLOCK_K keys per tile, ATTN_WG consumer warpgroups,
// ATTN_STAGES ring stages) is chosen by `python -m
// mre_tpu_torch.tools.tile_sweep`, which builds this file with those -D
// defines (they override both types and every head_dim). Chosen, on an H100
// 80GB HBM3 at 700 W (PERF.md §6):
// * bfloat16: 32-key tiles, 1 consumer warpgroup, 4 stages (entity shape
//   0.543 ms against 0.566-1.12 for the other tiles; 2 warpgroups were slower
//   at every shape, with or without `setmaxnreg`, and 2 stages starve the
//   pipelined loop, which holds a tile until its P·V has landed);
// * float32: 32-key tiles, 2 consumer warpgroups (128 query rows per block,
//   3 query tiles per (b, h) at N 321; the split is shared by twice the
//   rows), 2 stages: entity shape 1.50 ms against 1.60 with 64-key tiles,
//   training nodes 0.200 against 0.211, decoder 0.325 against 0.318 (the
//   `mma.sync` body this design replaced, timed by its own sweep in the same
//   call: entity 2.02, decoder 0.36). One block per SM (its 240-register
//   consumers). At hd 80 a 64-key float32 tile outgrows shared memory.
//
// The causal variant with grouped KV heads (LFM2-8B-A1B's attention layers:
// 32 query heads over 8 KV heads of 64; `attention_fwd_causal_kernel`, its
// own instantiations, the same body): compile-time CAUSAL and GROUP (query
// heads per KV head). K and V are [B·H/GROUP, N, hd]: query head h of batch
// row b loads KV head b·H/GROUP + h/GROUP through its TMA coordinate, so no
// copy of K and V spreads them over the query heads. A block stops at the key
// tile holding its last query row, so the tiles wholly above its diagonal are
// neither loaded nor multiplied; in the tiles it does run, a key after a row's
// own position gets -inf after the codes' FMA (only the diagonal tiles have
// such keys). A row's first tile holds key 0, so its running max is finite
// from the first tile on. The non-causal instantiations compile the same body
// with both switches off, to the code they had.
//
// What bounds the design, as far as switching its parts off tells (PERF.md
// §6): the memory pipeline alone (TMA ring, Q loads, O stores; each of a
// (b, h)'s query tiles reads all its K and V) takes 0.24 ms of bf16's 0.54
// at the entity shape, the products and the softmax the rest. The pipelining
// hides the exponentials behind P·V; float32's split pass runs with no
// product in flight. Tried and slower: the split on the producer
// warpgroup's idle warps (before the pipelining), the V split under the
// products (it spills), 2 bf16 warpgroups per block.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

namespace {

// ---------------------------------------------------------------------------
// Helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// x = hi + lo to about 21 bits, both TF32. hi is x rounded to the nearest
// TF32, ties away from zero: the value cvt.rna.tf32.f32 gives for every finite
// x, made with an integer add and a mask (cvt.rna lowers to a longer
// sequence on sm_90a). lo is the exact rest x - hi, truncated to TF32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
    hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo_half, float hi_half) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo_half, hi_half);
    return *reinterpret_cast<uint32_t*>(&v);
}
// (a, b) = hi + lo, both bf16x2, to about 16 bits
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
    __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    hi = *reinterpret_cast<uint32_t*>(&h);
    lo = pack_bf16(a - __low2float(h), b - __high2float(h));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

// Rows g and g + 8 of a warp's 16 (the D fragment layout of `wgmma` m64nN,
// o[4d + ..]), normalised and stored (rows at or past N are not stored).
template <int HD, typename T>
__device__ __forceinline__ void store_rows(T* out, size_t base, int row0, int N, int g, int t,
                                           const float* o, float l0, float l1) {
    constexpr int DT = HD / 8;
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    const bool in0 = row0 + g < N, in1 = row0 + g + 8 < N;
    T* o0 = out + base + (size_t)(row0 + g) * HD + 2 * t;
    T* o1 = o0 + 8 * HD;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
        if (in0) store2(o0 + 8 * d, o[4 * d + 0] * inv0, o[4 * d + 1] * inv0);
        if (in1) store2(o1 + 8 * d, o[4 * d + 2] * inv1, o[4 * d + 3] * inv1);
    }
}

// ---------------------------------------------------------------------------
// The kernel: warp-specialised, TMA ring + `wgmma`
// ---------------------------------------------------------------------------

namespace wgmma {

constexpr int SMEM_MAX = 232448;          // a block's dynamic shared memory on sm_90
constexpr float LOG2E = 1.4426950408889634f;

// The tile of each type: keys per TMA tile (BK, the N of S's wgmma), consumer
// warpgroups of 64 query rows each (WG), tiles in the TMA ring (STAGES). A
// sweep's ATTN_BLOCK_K / ATTN_WG / ATTN_STAGES override both types.
//
// Registers: ptxas and the SM size a block in whole warpgroups (2 consumer
// warpgroups beside one producer warp get 168 registers a thread, which
// spills float32's Q hi/lo, S, O and P hi/lo fragments). So with 2
// consumer warpgroups the producer is a whole warpgroup that drops to 24
// registers with `setmaxnreg` and gives the rest to the consumers; one of its
// warps issues the loads. A lone consumer warpgroup keeps ptxas's own count
// beside a lone producer warp.
template <typename T> struct Cfg {
    static constexpr bool F32 = std::is_same<T, float>::value;
#ifdef ATTN_BLOCK_K
    static constexpr int BK = ATTN_BLOCK_K;
#else
    static constexpr int BK = 32;
#endif
#ifdef ATTN_WG
    static constexpr int WG = ATTN_WG;
#else
    static constexpr int WG = F32 ? 2 : 1;
#endif
#ifdef ATTN_STAGES
    static constexpr int STAGES = ATTN_STAGES;
#else
    static constexpr int STAGES = F32 ? 2 : 4;
#endif
    static constexpr int CONSUMERS = 128 * WG;
    static constexpr int BLOCK_Q = 64 * WG;
    static constexpr int THREADS = CONSUMERS + (WG > 1 ? 128 : 32);
    // 2 × 128 × 240 + 128 × 24 = 64512 of the SM's 65536 registers
    static constexpr int CONSUMER_REGS = WG == 1 ? 0 : 240;
    static_assert(BK == 32 || BK == 64, "ATTN_BLOCK_K: 32 or 64 (the wgmma N of S)");
    static_assert(WG == 1 || WG == 2, "ATTN_WG: 1 or 2 consumer warpgroups");
    static_assert(STAGES >= 2 && STAGES <= 4, "ATTN_STAGES: 2 to 4");
};

// Shared-memory layout of one (HD, T) instantiation, in bytes from a
// 1024-aligned base (the period of the 128-byte swizzle):
//   raw  [STAGES][K, V][BOXES][BK][ROW]   tiles as TMA lands them
//   split[2][K hi, K lo][BOXES][BK][128]  float32 only, 128-byte swizzle
//        [2][V hi, V lo][BK/32][HD][128]  V^T, keys relabelled (within a
//                                         K tile's bytes: HD·4 <= BOXES·128)
//   codes[STAGES][BK] (mul, add) pairs beside the raw tiles, [2][BK] beside
//   the split tiles (float32); mbarriers full[STAGES], empty[STAGES]
// A row of HD elements is BOXES boxes of one swizzle width; at hd 80 the
// last box is part pad (zero-filled by TMA, never read by `wgmma`).
template <int HD, typename T> struct Layout : Cfg<T> {
    using C = Cfg<T>;
    static constexpr int ES = sizeof(T);
    static constexpr int ROW = HD * ES > 128 ? 128 : HD * ES;   // bytes per swizzled box row
    static constexpr int BOX = ROW / ES;                        // elements per TMA box row
    static constexpr int BOXES = (HD + BOX - 1) / BOX;
    static constexpr int STEPS_PER_BOX = ROW / 32;              // 32-byte k-steps of Q·K^T
    static constexpr int SWIZZLE = ROW == 128 ? 1 : 2;          // wgmma layout: 128B / 64B
    static constexpr int TILE = BOXES * C::BK * ROW;            // one tensor's tile, pad included
    static constexpr int RAW = 0;
    static constexpr int SPLIT = RAW + C::STAGES * 2 * TILE;
    static constexpr int SPLIT_TILE = TILE;
    static constexpr int CODES = SPLIT + (C::F32 ? 2 * 4 * SPLIT_TILE : 0);
    static constexpr int SPLIT_CODES = CODES + C::STAGES * C::BK * 8;
    static constexpr int BARS = SPLIT_CODES + (C::F32 ? 2 * C::BK * 8 : 0);
    static constexpr int BYTES = BARS + 2 * C::STAGES * 8 + 1024;  // + alignment slack
    static_assert(ROW == 64 || ROW == 128, "rows of 64 or 128 swizzled bytes");
    static_assert(HD % (32 / ES) == 0, "head_dim in whole 32-byte k-steps");
    static_assert(!C::F32 || ROW == 128, "float32 rows are 128-byte boxes");
    static_assert(!C::F32 || HD * 4 * C::BK <= SPLIT_TILE, "V^T fits a split tile");
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    do {
        asm volatile("{\n.reg .pred p;\n"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     "selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    } while (!done);
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}
// box {c0 (hd), c1 (key), c2 (b·h)} of a 3-D tensor map -> shared, completing on bar
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
    asm volatile("cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
                 "[%0], [%1, {%3, %4, %5}], [%2];\n"
                 :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
                    "r"(c0), "r"(c1), "r"(c2) : "memory");
}
__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
    asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until at most N of this warpgroup's committed wgmma groups are pending
template <int N> __device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of r across a wgmma fence or wait
template <int R> __device__ __forceinline__ void fence_regs(float (&r)[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int P> __device__ __forceinline__ void fence_regs(uint32_t (&r)[P][4]) {
#pragma unroll
    for (int i = 0; i < P; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}
__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle mode (1 = 128B, 2 = 64B)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint32_t swizzle) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
           ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | ((uint64_t)swizzle << 62);
}

#define ATTN_D8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                   "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define ATTN_REGS16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define ATTN_REGS32 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
                    "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
                    "%30, %31}"
#define ATTN_REGS40 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
                    "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
                    "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39}"

// D (+)= A·B, m64nNk16, bf16 in, f32 accumulate; A from registers, B from
// shared memory (TRANS: MN-major B); scale_d 0 overwrites D
template <int TRANS>
__device__ __forceinline__ void mma_bf16(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " ATTN_REGS16
                 ", {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
                 : ATTN_D8(0), ATTN_D8(8)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
                   "n"(TRANS));
}
template <int TRANS>
__device__ __forceinline__ void mma_bf16(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ATTN_REGS32
                 ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
                 : ATTN_D8(0), ATTN_D8(8), ATTN_D8(16), ATTN_D8(24)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
                   "n"(TRANS));
}
template <int TRANS>
__device__ __forceinline__ void mma_bf16(float (&d)[40], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 " ATTN_REGS40
                 ", {%40, %41, %42, %43}, %44, p, 1, 1, %46;\n}\n"
                 : ATTN_D8(0), ATTN_D8(8), ATTN_D8(16), ATTN_D8(24), ATTN_D8(32)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
                   "n"(TRANS));
}
// D (+)= A·B, m64nNk8, TF32 in, f32 accumulate; both K-major
__device__ __forceinline__ void mma_tf32(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " ATTN_REGS16
                 ", {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
                 : ATTN_D8(0), ATTN_D8(8)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}
__device__ __forceinline__ void mma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " ATTN_REGS32
                 ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
                 : ATTN_D8(0), ATTN_D8(8), ATTN_D8(16), ATTN_D8(24)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}
__device__ __forceinline__ void mma_tf32(float (&d)[40], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 " ATTN_REGS40
                 ", {%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
                 : ATTN_D8(0), ATTN_D8(8), ATTN_D8(16), ATTN_D8(24), ATTN_D8(32)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// float32: split a raw K or V tile into the hi/lo tiles `wgmma` reads. Raw
// rows are 128-byte boxes of 32 floats, 16-byte chunk c of row r at chunk
// c ^ (r % 8) (TMA's 128-byte swizzle; only the real columns are split, a
// last box's pad is left as it is); K's split tiles keep that layout, V's
// are V^T: row d holds the keys of each 32-key block, 8-key group order
// relabelled for P's fragment (key 2p at position p, key 2p + 1 at p + 4).
// Consecutive threads take consecutive keys of one 4-float chunk: the reads
// and the transposed writes hit 32 distinct banks.
template <int HD, int BK, int NTHREADS, bool V>
__device__ __forceinline__ void split_tile(const unsigned char* raw, unsigned char* hi_tile,
                                           unsigned char* lo_tile, int tid) {
    constexpr int CHUNKS = BK * HD / 4;
#pragma unroll
    for (int i = 0; i < (CHUNKS + NTHREADS - 1) / NTHREADS; ++i) {
        const int c = tid + i * NTHREADS;
        if (CHUNKS % NTHREADS != 0 && c >= CHUNKS) break;
        const int key = c % BK, dc = c / BK;       // key, 4-float chunk of hd
        const uint32_t off = (dc / 8) * BK * 128 + key * 128 + (((dc % 8) ^ (key & 7)) << 4);
        const float4 x = *reinterpret_cast<const float4*>(raw + off);
        if constexpr (!V) {
            uint4 hi, lo;
            split_tf32(x.x, hi.x, lo.x);
            split_tf32(x.y, hi.y, lo.y);
            split_tf32(x.z, hi.z, lo.z);
            split_tf32(x.w, hi.w, lo.w);
            *reinterpret_cast<uint4*>(hi_tile + off) = hi;
            *reinterpret_cast<uint4*>(lo_tile + off) = lo;
        } else {
            const float xs[4] = {x.x, x.y, x.z, x.w};
            const int kl = key % 32;
            const int pos = (kl & ~7) | ((kl & 7) >> 1) | ((kl & 1) << 2);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int d = 4 * dc + e;
                const uint32_t voff = (key / 32) * HD * 128 + d * 128 +
                                      ((((pos >> 2) ^ (d & 7)) << 4) | ((pos & 3) << 2));
                uint32_t h, l;
                split_tf32(xs[e], h, l);
                *reinterpret_cast<uint32_t*>(hi_tile + voff) = h;
                *reinterpret_cast<uint32_t*>(lo_tile + voff) = l;
            }
        }
    }
}

// The kernel's body; tk and tv point at the launching kernel's __grid_constant__
// tensor maps. CAUSAL and GROUP: the causal variant with grouped KV heads
// (above); off, the body of the plain masked attention.
template <int HD, typename T, bool CAUSAL, int GROUP>
__device__ __forceinline__ void attention_fwd_body(const CUtensorMap* tk, const CUtensorMap* tv,
                                                   const T* __restrict__ q,
                                                   const float* __restrict__ mask,
                                                   T* __restrict__ out, int H, int N,
                                                   float scale) {
    using L = Layout<HD, T>;
    constexpr bool F32 = L::F32;
    constexpr int BK = L::BK, STAGES = L::STAGES, CONSUMERS = L::CONSUMERS;
    constexpr int NT = BK / 8;              // 8-key column tiles of S
    constexpr int DT = HD / 8;              // 8-wide column tiles of O
    constexpr int KS = F32 ? HD / 8 : HD / 16;   // k-steps of Q·K^T (32 bytes each)

    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    float* codes = reinterpret_cast<float*>(smem + L::CODES);
    const uint32_t bars = smem_addr(smem + L::BARS);
    auto full = [&](int s) { return bars + 8 * s; };               // tile landed
    auto empty = [&](int s) { return bars + 8 * (STAGES + s); };   // tile read

    const int bh = blockIdx.y;
    const int b = bh / H;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    int kvh, tiles;                         // K/V's TMA coordinate, key tiles to run
    if constexpr (GROUP == 1) {
        kvh = bh;
    } else {
        kvh = b * (H / GROUP) + (bh - b * H) / GROUP;
    }
    if constexpr (CAUSAL) {
        const int last = min(N, (int)(blockIdx.x + 1) * L::BLOCK_Q);   // past the block's last row
        tiles = (last + BK - 1) / BK;
    } else {
        tiles = (N + BK - 1) / BK;
    }

    if (tid == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full(s), 32);                // the loading warp's lanes (+ TMA bytes)
            mbar_init(empty(s), CONSUMERS / 32);   // one arrival per consumer warp
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (tid >= CONSUMERS) {
        // ---- producer: one warp's TMA loads of K and V, key codes beside them ----
        if constexpr (L::CONSUMER_REGS > 0) {
            asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
            if (tid >= CONSUMERS + 32) return;
        }
        const float* pad = mask != nullptr ? mask + (size_t)b * N : nullptr;
        for (int it = 0; it < tiles; ++it) {
            const int s = it % STAGES;
            mbar_wait(empty(s), ((it / STAGES) & 1) ^ 1);
            const int k0 = it * BK;
            for (int i = lane; i < BK; i += 32) {
                // the logit in log2 units is fma(q·k, mul, add): scale·log2(e) at
                // a real key, the where-select -1e7 at PAD, -inf past N
                const int key = k0 + i;
                const float2 c = key >= N ? make_float2(0.f, -INFINITY)
                                 : pad != nullptr && pad[key] > 0.f
                                     ? make_float2(0.f, -1e7f * LOG2E)
                                     : make_float2(scale * LOG2E, 0.f);
                reinterpret_cast<float2*>(codes)[s * BK + i] = c;
            }
            __syncwarp();
            if (lane == 0) {
                mbar_arrive_expect_tx(full(s), 2 * L::TILE);
                const uint32_t kdst = smem_addr(smem + L::RAW + s * 2 * L::TILE);
#pragma unroll
                for (int x = 0; x < L::BOXES; ++x) {
                    tma_load_3d(kdst + x * BK * L::ROW, tk, full(s), x * L::BOX, k0, kvh);
                    tma_load_3d(kdst + L::TILE + x * BK * L::ROW, tv, full(s), x * L::BOX,
                                k0, kvh);
                }
            } else {
                mbar_arrive(full(s));
            }
        }
        return;
    }

    // ---- consumers: warpgroup wg owns query rows [64 wg, 64 wg + 64) of the block ----
    if constexpr (L::CONSUMER_REGS > 0)
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(L::CONSUMER_REGS));
    const int wg = tid / 128;
    const int g = lane >> 2;        // fragment row of this lane
    const int t = lane & 3;         // lane within its quad
    const int wg_row0 = blockIdx.x * L::BLOCK_Q + wg * 64;
    const int row0 = wg_row0 + ((tid % 128) >> 5) * 16;   // this warp's first row
    const bool active = wg_row0 < N;                      // uniform over the warpgroup
    const size_t base = (size_t)bh * N * HD;

    // Q fragments (A of Q·K^T from registers), rows row0+g and row0+g+8; rows
    // at or past N read 0. float32: hi and lo of each value.
    const T* q0 = q + base + (size_t)(row0 + g) * HD;
    const T* q1 = q0 + 8 * HD;
    const bool in0 = row0 + g < N, in1 = row0 + g + 8 < N;
    uint32_t qa[KS][4];                     // float32: hi; bf16: the pairs
    uint32_t ql[F32 ? KS : 1][4];           // float32: lo
#pragma unroll
    for (int s = 0; s < KS; ++s) {
        if constexpr (F32) {
            const int c = 8 * s + t;
            split_tf32(in0 ? q0[c] : 0.f, qa[s][0], ql[s][0]);
            split_tf32(in1 ? q1[c] : 0.f, qa[s][1], ql[s][1]);
            split_tf32(in0 ? q0[c + 4] : 0.f, qa[s][2], ql[s][2]);
            split_tf32(in1 ? q1[c + 4] : 0.f, qa[s][3], ql[s][3]);
        } else {
            const int c = 16 * s + 2 * t;
            qa[s][0] = in0 ? *reinterpret_cast<const uint32_t*>(q0 + c) : 0u;
            qa[s][1] = in1 ? *reinterpret_cast<const uint32_t*>(q1 + c) : 0u;
            qa[s][2] = in0 ? *reinterpret_cast<const uint32_t*>(q0 + c + 8) : 0u;
            qa[s][3] = in1 ? *reinterpret_cast<const uint32_t*>(q1 + c + 8) : 0u;
        }
    }

    // The loop is pipelined inside the warpgroup: tile i's S = Q·K^T is issued
    // with tile i-1's O += P·V, and tile i's exponentials run while that P·V
    // is on the tensor cores; O is rescaled once it has landed.
    constexpr int NP = F32 ? NT : BK / 16;  // A fragments of P·V (k8 / k16 steps)
    float s[4 * NT];                        // S, then P: the wgmma D fragment of m64nBK
    float o[4 * DT];                        // O: the D fragment of m64nHD
    uint32_t ph[NP][4], pl[NP][4];          // the previous tile's P, hi and lo
#pragma unroll
    for (int i = 0; i < 4 * NT; ++i) s[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 4 * DT; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < NP; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) ph[i][j] = pl[i][j] = 0u;
    float m0 = -INFINITY, m1 = -INFINITY;   // running max of rows g, g+8 (log2 units)
    float l0 = 0.f, l1 = 0.f;               // this lane's part of the running sums

    // O += P·V of the tile whose V (bf16: the raw stage; float32: its split
    // V^T tiles, hi then lo) starts at shared address v
    auto pv = [&](uint32_t v) {
        if constexpr (F32) {
#pragma unroll
            for (int n = 0; n < NT; ++n) {
                // keys 8n..8n+7: key block n / 4, bytes 32 (n % 4) of its rows
                const uint32_t off = (n / 4) * HD * 128 + (n % 4) * 32;
                const uint64_t vh = smem_desc(v + off, 16, 1024, L::SWIZZLE);
                const uint64_t vl = smem_desc(v + L::SPLIT_TILE + off, 16, 1024, L::SWIZZLE);
                mma_tf32(o, pl[n], vh, 1);
                mma_tf32(o, ph[n], vl, 1);
                mma_tf32(o, ph[n], vh, 1);
            }
        } else {
#pragma unroll
            for (int kk = 0; kk < NP; ++kk) {
                // keys 16kk..16kk+15: two 8-row groups of the MN-major V tile;
                // hd past a box's 128 bytes in the next box (leading offset)
                const uint64_t bv = smem_desc(v + kk * 16 * L::ROW, BK * L::ROW, 8 * L::ROW,
                                              L::SWIZZLE);
                mma_bf16<1>(o, pl[kk], bv, 1);
                mma_bf16<1>(o, ph[kk], bv, 1);
            }
        }
        wgmma_commit();
    };
    // float32 splits each tile into double-buffered hi/lo tiles shared by the
    // consumer warpgroups, its key codes beside them
    auto split_of = [&](int it) { return smem + L::SPLIT + (it & 1) * 4 * L::SPLIT_TILE; };
    auto raw_of = [&](int it) { return smem + L::RAW + (it % STAGES) * 2 * L::TILE; };
    // where the V operand of tile it lies (float32: its V^T hi, then lo)
    auto v_of = [&](int it) {
        return F32 ? smem_addr(split_of(it)) + 2 * L::SPLIT_TILE : smem_addr(raw_of(it)) + L::TILE;
    };
    // Tile it has landed; float32 splits it and hands the raw stage back to
    // the producer. Returns the tile's key codes.
    auto stage_in = [&](int it) -> const float* {
        const int st = it % STAGES;
        mbar_wait(full(st), (it / STAGES) & 1);
        const float* ct = codes + st * 2 * BK;
        if constexpr (F32) {
            float* sc = reinterpret_cast<float*>(smem + L::SPLIT_CODES) + (it & 1) * 2 * BK;
            if (tid < 2 * BK) sc[tid] = ct[tid];
            unsigned char* split = split_of(it);
            split_tile<HD, BK, CONSUMERS, false>(raw_of(it), split, split + L::SPLIT_TILE, tid);
            split_tile<HD, BK, CONSUMERS, true>(raw_of(it) + L::TILE, split + 2 * L::SPLIT_TILE,
                                                split + 3 * L::SPLIT_TILE, tid);
            fence_proxy_async();            // the generic writes, visible to wgmma
            named_barrier_sync(1, CONSUMERS);
            if (lane == 0) mbar_arrive(empty(st));
            return sc;
        }
        return ct;
    };
    // S = Q·K^T of tile it. k-step kk covers the 32 bytes of hd at box
    // kk / STEPS_PER_BOX, bytes 32 (kk % STEPS_PER_BOX) of its rows
    auto k_step = [&](int kk) {
        return (kk / L::STEPS_PER_BOX) * BK * L::ROW + (kk % L::STEPS_PER_BOX) * 32;
    };
    auto qk = [&](int it) {
        if constexpr (F32) {
            const uint32_t khi = smem_addr(split_of(it));
            const uint32_t klo = khi + L::SPLIT_TILE;
#pragma unroll
            for (int kk = 0; kk < KS; ++kk) {
                const uint64_t kh = smem_desc(khi + k_step(kk), 16, 1024, L::SWIZZLE);
                const uint64_t kl = smem_desc(klo + k_step(kk), 16, 1024, L::SWIZZLE);
                mma_tf32(s, ql[kk], kh, kk > 0);
                mma_tf32(s, qa[kk], kl, 1);
                mma_tf32(s, qa[kk], kh, 1);
            }
        } else {
            const uint32_t kt = smem_addr(raw_of(it));
#pragma unroll
            for (int kk = 0; kk < KS; ++kk)
                mma_bf16<0>(s, qa[kk], smem_desc(kt + k_step(kk), 16, 8 * L::ROW, L::SWIZZLE),
                            kk > 0);
        }
        wgmma_commit();
    };
    // S's logits in log2 units (the where-select through the codes), the
    // running max, this tile's probabilities and sums; c: O's rescale. k0:
    // the tile's first key (causal: keys after a row's own position -> -inf)
    auto softmax = [&](const float* ct, int k0, float& c0, float& c1) {
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
            const float4 c = reinterpret_cast<const float4*>(ct)[4 * n + t];  // keys 8n+2t, +1
            s[4 * n + 0] = fmaf(s[4 * n + 0], c.x, c.y);
            s[4 * n + 1] = fmaf(s[4 * n + 1], c.z, c.w);
            s[4 * n + 2] = fmaf(s[4 * n + 2], c.x, c.y);
            s[4 * n + 3] = fmaf(s[4 * n + 3], c.z, c.w);
            if constexpr (CAUSAL) {
                const int key = k0 + 8 * n + 2 * t, r0 = row0 + g, r1 = r0 + 8;
                if (key > r0) s[4 * n + 0] = -INFINITY;
                if (key + 1 > r0) s[4 * n + 1] = -INFINITY;
                if (key > r1) s[4 * n + 2] = -INFINITY;
                if (key + 1 > r1) s[4 * n + 3] = -INFINITY;
            }
            mx0 = fmaxf(mx0, fmaxf(s[4 * n + 0], s[4 * n + 1]));
            mx1 = fmaxf(mx1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
        }
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
        // a tile always holds a key below N (causal: the first tile holds key
        // 0), so the new max is finite
        const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
        c0 = ex2(m0 - mn0);                 // 0 on the first tile
        c1 = ex2(m1 - mn1);
        m0 = mn0;
        m1 = mn1;
        l0 *= c0;
        l1 *= c1;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
            s[4 * n + 0] = ex2(s[4 * n + 0] - mn0);
            s[4 * n + 1] = ex2(s[4 * n + 1] - mn0);
            s[4 * n + 2] = ex2(s[4 * n + 2] - mn1);
            s[4 * n + 3] = ex2(s[4 * n + 3] - mn1);
            l0 += s[4 * n + 0] + s[4 * n + 1];
            l1 += s[4 * n + 2] + s[4 * n + 3];
        }
    };
    // this tile's P as the A fragments of its P·V
    auto make_p = [&]() {
#pragma unroll
        for (int n = 0; n < NP; ++n) {
            if constexpr (F32) {
                // keys 8n..8n+7 relabelled: A column t = key 2t, column t+4 = key 2t+1
                split_tf32(s[4 * n + 0], ph[n][0], pl[n][0]);
                split_tf32(s[4 * n + 2], ph[n][1], pl[n][1]);
                split_tf32(s[4 * n + 1], ph[n][2], pl[n][2]);
                split_tf32(s[4 * n + 3], ph[n][3], pl[n][3]);
            } else {
                // keys 16n..16n+15: S tiles 2n and 2n+1 are the A fragment
                split_bf16(s[8 * n + 0], s[8 * n + 1], ph[n][0], pl[n][0]);
                split_bf16(s[8 * n + 2], s[8 * n + 3], ph[n][1], pl[n][1]);
                split_bf16(s[8 * n + 4], s[8 * n + 5], ph[n][2], pl[n][2]);
                split_bf16(s[8 * n + 6], s[8 * n + 7], ph[n][3], pl[n][3]);
            }
        }
    };

    float c0, c1;
    const float* ct = stage_in(0);
    if (active) {
        fence_regs(s);
        wgmma_fence();
        qk(0);
        wgmma_wait<0>();
        fence_regs(s);
        softmax(ct, 0, c0, c1);             // O is still 0: nothing to rescale
        make_p();
    }
    for (int it = 1; it < tiles; ++it) {
        // float32: every warpgroup is done with the P·V of tile it - 2, whose
        // split buffer tile it overwrites
        if constexpr (F32) named_barrier_sync(2, CONSUMERS);
        ct = stage_in(it);
        if (active) {
            fence_regs(s);
            fence_regs(o);
            fence_regs(ph);
            fence_regs(pl);
            wgmma_fence();
            qk(it);
            pv(v_of(it - 1));               // the previous tile's P·V
            wgmma_wait<1>();                // S has landed, P·V may still run
            fence_regs(s);
            softmax(ct, it * BK, c0, c1);
            wgmma_wait<0>();                // the previous tile's P·V has landed
            fence_regs(o);
#pragma unroll
            for (int d = 0; d < DT; ++d) {
                o[4 * d + 0] *= c0; o[4 * d + 1] *= c0;
                o[4 * d + 2] *= c1; o[4 * d + 3] *= c1;
            }
            make_p();
        }
        // bf16: the previous tile's stage is read (its P·V has landed)
        if (!F32 && lane == 0) mbar_arrive(empty((it - 1) % STAGES));
    }

    if (active) {
        fence_regs(o);
        fence_regs(ph);
        fence_regs(pl);
        wgmma_fence();
        pv(v_of(tiles - 1));
        wgmma_wait<0>();
        fence_regs(o);
    }
    if (!F32 && lane == 0) mbar_arrive(empty((tiles - 1) % STAGES));

    if (active) store_rows<HD, T>(out, base, row0, N, g, t, o, l0, l1);
}

template <int HD, typename T>
__global__ void __launch_bounds__(Cfg<T>::THREADS, 1)
attention_fwd_kernel(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                     const T* __restrict__ q, const float* __restrict__ mask,
                     T* __restrict__ out, int H, int N, float scale) {
    attention_fwd_body<HD, T, false, 1>(&tk, &tv, q, mask, out, H, N, scale);
}

// causal, GROUP query heads per KV head; tk and tv over [B·H/GROUP, N, HD]
template <int HD, typename T, int GROUP>
__global__ void __launch_bounds__(Cfg<T>::THREADS, 1)
attention_fwd_causal_kernel(const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv, const T* __restrict__ q,
                            const float* __restrict__ mask, T* __restrict__ out, int H, int N,
                            float scale) {
    attention_fwd_body<HD, T, true, GROUP>(&tk, &tv, q, mask, out, H, N, scale);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found once through the runtime (no
// link against libcuda)
EncodeTiled encoder() {
    static EncodeTiled fn = [] {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
        cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &found);
#endif
        return err == cudaSuccess && found == cudaDriverEntryPointSuccess
                   ? reinterpret_cast<EncodeTiled>(p) : nullptr;
    }();
    return fn;
}

// [B·H, N, HD] with HD innermost; boxes of [1, BK, BOX], swizzled as wgmma reads
// them; rows past N zero-filled
template <int HD, typename T>
int encode(CUtensorMap* map, const void* ptr, int BH, int N) {
    using L = Layout<HD, T>;
    EncodeTiled fn = encoder();
    if (fn == nullptr) return -2;
    const cuuint64_t dims[3] = {(cuuint64_t)HD, (cuuint64_t)N, (cuuint64_t)BH};
    const cuuint64_t strides[2] = {(cuuint64_t)HD * L::ES, (cuuint64_t)N * HD * L::ES};
    const cuuint32_t box[3] = {(cuuint32_t)L::BOX, (cuuint32_t)L::BK, 1};
    const cuuint32_t step[3] = {1, 1, 1};
    CUresult r = fn(map, L::F32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                    3, const_cast<void*>(ptr), dims, strides, box, step,
                    CU_TENSOR_MAP_INTERLEAVE_NONE,
                    L::ROW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                    CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : -3;
}

// GROUP 0: the plain masked kernel; else the causal one with GROUP query heads
// per KV head (k and v hold B·H/GROUP heads)
template <int HD, typename T, int GROUP>
int launch(const void* q, const void* k, const void* v, const float* mask,
           void* out, int B, int H, int N, float scale, cudaStream_t stream) {
    using L = Layout<HD, T>;
    using Kernel = void (*)(const CUtensorMap, const CUtensorMap, const T*, const float*, T*,
                            int, int, float);
    if (L::BYTES > SMEM_MAX) return -4;     // a sweep's tile too large for this head_dim
    Kernel kernel;
    int kv_heads;
    if constexpr (GROUP == 0) {
        kernel = attention_fwd_kernel<HD, T>;
        kv_heads = B * H;
    } else {
        kernel = attention_fwd_causal_kernel<HD, T, GROUP>;
        kv_heads = B * (H / GROUP);
    }
    CUtensorMap tk, tv;
    int rc = encode<HD, T>(&tk, k, kv_heads, N);
    if (rc == 0) rc = encode<HD, T>(&tv, v, kv_heads, N);
    if (rc != 0) return rc;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((N + L::BLOCK_Q - 1) / L::BLOCK_Q, B * H);
    kernel<<<grid, L::THREADS, L::BYTES, stream>>>(
        tk, tv, static_cast<const T*>(q), mask, static_cast<T*>(out), H, N, scale);
    return (int)cudaGetLastError();
}

}  // namespace wgmma

}  // namespace

// Plain C entry point, loaded with ctypes. q, k, v, out: contiguous
// [B, H, N, head_dim], each base 16-byte aligned (TMA); mask:
// contiguous float32 [B, N] (1.0 = PAD) or null. dtype: 0 = float32,
// 1 = bfloat16. Returns cudaGetLastError() after the launch (0 = launched), -1
// for a head_dim/dtype with no instantiation, -2 when the driver has no
// cuTensorMapEncodeTiled, -3 when it refuses a tensor map, -4 when the tile
// does not fit in shared memory.
extern "C" int attention_fwd(const void* q, const void* k, const void* v,
                             const void* mask, void* out, int B, int H, int N,
                             int head_dim, int dtype, float scale, void* stream) {
    const float* m = static_cast<const float*>(mask);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (B <= 0 || H <= 0 || N <= 0) return -1;
#define ATTN_LAUNCH(HD, T) \
    if (head_dim == HD) return wgmma::launch<HD, T, 0>(q, k, v, m, out, B, H, N, scale, s)
    if (dtype == 0) {
        ATTN_LAUNCH(32, float);
        ATTN_LAUNCH(64, float);
        ATTN_LAUNCH(80, float);
    } else if (dtype == 1) {
        ATTN_LAUNCH(32, __nv_bfloat16);
        ATTN_LAUNCH(64, __nv_bfloat16);
        ATTN_LAUNCH(80, __nv_bfloat16);
    }
#undef ATTN_LAUNCH
    return -1;
}

// The causal kernel with grouped KV heads: q, out [B, H, N, head_dim]; k, v
// [B, H_kv, N, head_dim], query head h reading KV head h / (H / H_kv); mask as
// above. Returns as attention_fwd; -1 also when no instantiation has this
// head_dim, dtype and H / H_kv.
extern "C" int attention_fwd_causal(const void* q, const void* k, const void* v,
                                    const void* mask, void* out, int B, int H, int H_kv,
                                    int N, int head_dim, int dtype, float scale,
                                    void* stream) {
    const float* m = static_cast<const float*>(mask);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (B <= 0 || H <= 0 || H_kv <= 0 || N <= 0 || H % H_kv != 0) return -1;
    if (head_dim == 64 && H / H_kv == 4) {
        if (dtype == 0) return wgmma::launch<64, float, 4>(q, k, v, m, out, B, H, N, scale, s);
        if (dtype == 1)
            return wgmma::launch<64, __nv_bfloat16, 4>(q, k, v, m, out, B, H, N, scale, s);
    }
    return -1;
}
