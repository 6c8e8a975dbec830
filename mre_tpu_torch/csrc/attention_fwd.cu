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
// reference), softmax and sums in float32, and the output in the input type
// (float32 or bfloat16).
//
// What bounds it on an H100 (SXM, 700 W). At the entity-sweep shape of
// M3AE-small (B 512, H 6, N 321, hd 64) the work is 4·B·H·N²·hd = 81 GFLOP
// against 1.01 GB of q, k, v and out in float32: 0.30 ms of memory at
// 3.35 TB/s, 0.16 ms of arithmetic at the TF32 tensor-core peak (495 TFLOP/s),
// so the function is bound by bytes; in bfloat16 too (0.15 ms of memory,
// 0.08 ms at 989 TFLOP/s). Every main-path shape is bound by bytes in the
// same way. The three TF32 passes below triple the float32 tensor-core work
// (0.49 ms at peak), so this kernel's own floor lies above the bytes. The
// design reads q, k and v once per block from device memory, keeps the
// logits in registers, overlaps the K/V copies with the products, and moves
// the products to the tensor cores:
//
// * Work split. One block per (b·h, BLOCK_Q query rows); each warp owns 16
//   query rows, the m of `mma.sync` m16n8k*. N = 321 does not divide: a warp
//   whose 16 rows all lie beyond N computes nothing but still helps load.
// * Products on the tensor cores with `mma.sync`. bfloat16: m16n8k16, bf16 in,
//   f32 accumulate, V through `ldmatrix.trans`. float32: m16n8k8 TF32 in three
//   passes (3xTF32): each operand x splits into hi = tf32(x) and
//   lo = tf32(x - hi) (split_tf32), and hi·hi + hi·lo + lo·hi is summed in f32,
//   about 21 bits of each operand. One TF32 pass keeps 10 and leaves errors of
//   1e-4..1e-3 in the output at these shapes, outside the float32 tolerance
//   (tests/test_torch_port_attention.py emulates both). P is split the same
//   way in bfloat16 (hi + lo, two passes), so P·V keeps float32 precision
//   there too, as the Pallas kernel's float32 dot does.
// * TF32 P·V without a relayout. The C fragment of Q·K^T holds keys 2t, 2t+1
//   of each 8-key tile in lane t of a quad, where the A fragment of m16n8k8
//   wants keys t and t+4. A sum over keys does not care about their order, so
//   the kernel relabels them: A column t is key 2t, column t+4 key 2t+1, and
//   the V fragment reads rows 2t and 2t+1 to match. P never leaves registers.
// * K/V tiles of BLOCK_K keys through shared memory with `cp.async` (16
//   bytes, zero-filled past N), two stages: tile i+1 loads while tile i is
//   computed. Rows are padded (float32: hd + 4 floats, bfloat16: hd + 8
//   halves) so that the fragment loads of K (as B in Q·K^T) and of V (as B
//   in P·V, and the rows ldmatrix reads) hit 32 distinct banks.
// * Online softmax in registers: each lane holds two rows of the 16; the row
//   max reduces across the quad with shuffles, the row sum at the end.
//   exp is __expf (ex2.approx): its relative error, a few 1e-7 for the
//   logit gaps here, is far inside the float32 tolerance. Keys beyond N (the
//   ragged last tile) are excluded with -inf, never -1e7.
//
// The tile, as measured on an H100 80GB HBM3 at 700 W (PERF.md):
// 32-key tiles and 4 warps (64 query rows) per block. The float32 loop body
// is fully unrolled (the fragments live in registers), so its size grows with
// the key tile: 64-key tiles (entity shape, float32: 2.85 ms against 1.99,
// tools/tile_sweep.py), or a second copy of the body that skips the empty
// column tiles of the ragged last tile, each made the kernel slower, though
// they compute fewer keys. 8 warps per block and 16-key tiles were slower
// too. So were a split of K and V into (hi, lo) once per block in shared
// memory, in place of each warp splitting its fragments (an extra pass and
// barrier per tile, twice the shared memory), and cvt.rna for the split.
// Loading the mask with cp.async, one barrier per tile and 3-4 stages moved
// nothing. As far as these trials tell, what is left is the tensor-core work
// itself (three TF32 passes through the `mma.sync` path) with the splits and
// the softmax around it: the float32 kernel reaches about a seventh of its
// bound, bfloat16 about a fifth.
//
// Why `mma.sync` and not `wgmma`: the per-block work is small (hd <= 80,
// eleven 32-key tiles at N 321), and TF32 `wgmma` takes only K-major
// operands, so V would have to be transposed in shared memory. `wgmma` and
// TMA are the next step (PERF.md).
//
// ATTN_BLOCK_K (keys per tile) and ATTN_WARPS (warps per block, 16 query rows
// each) override the tile for a sweep (`python -m mre_tpu_torch.tools.tile_sweep`).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

namespace {

#ifndef ATTN_BLOCK_K
#define ATTN_BLOCK_K 32
#endif
#ifndef ATTN_WARPS
#define ATTN_WARPS 4
#endif

constexpr int BLOCK_K = ATTN_BLOCK_K;   // keys per shared-memory tile
constexpr int WARPS = ATTN_WARPS;
constexpr int THREADS = 32 * WARPS;
constexpr int BLOCK_Q = 16 * WARPS;     // query rows per block
constexpr int STAGES = 2;
static_assert(BLOCK_K % 16 == 0 && BLOCK_K >= 16, "BLOCK_K: a multiple of 16");

// Row stride of a K or V tile in shared memory, in elements of T: 16 bytes of
// padding keeps rows 16-byte aligned for cp.async and ldmatrix and spreads
// the fragment loads over all 32 banks.
template <int HD, typename T> __host__ __device__ constexpr int row_stride() {
    return HD + 16 / (int)sizeof(T);
}

template <int HD, typename T> __host__ __device__ constexpr size_t smem_bytes() {
    return STAGES * (2 * BLOCK_K * row_stride<HD, T>() * sizeof(T) + BLOCK_K * sizeof(float));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !full.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(full ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_one() {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// x = hi + lo to about 21 bits, both TF32. hi is x rounded to the nearest
// TF32, ties away from zero: the value cvt.rna.tf32.f32 gives for every finite
// x, made with an integer add and a mask (cvt.rna lowers to a longer
// sequence on sm_90a, and the float32 kernel was slower with it). lo is the
// exact rest x - hi, truncated to TF32.
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

// D += A·B, m16n8k8, TF32 in, float32 accumulate
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// D += A·B, m16n8k16, bfloat16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// four 8x8 b16 matrices, transposed; lanes 8i..8i+7 give matrix i's rows
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p))
                 : "memory");
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

// Key codes in shared memory beside each tile: a real key, a PAD key (logit
// -1e7), a key beyond N (excluded: -inf).
constexpr float KEY_REAL = 0.f, KEY_PAD = 1.f, KEY_OUT = 2.f;

template <int HD, typename T>
__global__ void __launch_bounds__(THREADS)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ mask,
                     T* __restrict__ out, int H, int N, float scale) {
    constexpr bool F32 = std::is_same<T, float>::value;
    constexpr int LD = row_stride<HD, T>();
    constexpr int NT = BLOCK_K / 8;         // 8-key column tiles of S
    constexpr int DT = HD / 8;              // 8-wide column tiles of O
    constexpr int KS = F32 ? HD / 8 : HD / 16;   // k-steps of Q·K^T
    // float32 keeps Q's hi and lo fragments in registers up to hd 64; at hd
    // 80 it keeps Q as is and splits it at each use, to stay clear of spills
    constexpr bool Q_SPLIT = F32 && HD <= 64;
    constexpr int CHUNKS = HD * (int)sizeof(T) / 16;   // 16-byte chunks per row
    constexpr int CHUNK = 16 / (int)sizeof(T);         // elements per chunk

    extern __shared__ __align__(16) unsigned char smem[];
    T* ks = reinterpret_cast<T*>(smem);                           // [STAGES][BLOCK_K][LD]
    T* vs = ks + STAGES * BLOCK_K * LD;                           // [STAGES][BLOCK_K][LD]
    float* codes = reinterpret_cast<float*>(vs + STAGES * BLOCK_K * LD);  // [STAGES][BLOCK_K]

    const int bh = blockIdx.y;
    const int b = bh / H;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int g = lane >> 2;        // fragment row (and B column) of this lane
    const int t = lane & 3;         // lane within its quad
    const int row0 = blockIdx.x * BLOCK_Q + (tid >> 5) * 16;   // this warp's first row
    const bool active = row0 < N;
    const size_t base = (size_t)bh * N * HD;
    const T* kg = k + base;
    const T* vg = v + base;
    const float* pad = mask != nullptr ? mask + (size_t)b * N : nullptr;

    auto load_tile = [&](int tile, int stage) {
        const int k0 = tile * BLOCK_K;
        T* kd = ks + stage * BLOCK_K * LD;
        T* vd = vs + stage * BLOCK_K * LD;
        for (int i = tid; i < BLOCK_K * CHUNKS; i += THREADS) {
            const int r = i / CHUNKS, c = (i % CHUNKS) * CHUNK;
            const bool in = k0 + r < N;
            const size_t off = (size_t)(in ? k0 + r : 0) * HD + c;
            cp_async16(kd + r * LD + c, kg + off, in);
            cp_async16(vd + r * LD + c, vg + off, in);
        }
        for (int i = tid; i < BLOCK_K; i += THREADS) {
            const int key = k0 + i;
            codes[stage * BLOCK_K + i] =
                key >= N ? KEY_OUT : (pad != nullptr && pad[key] > 0.f ? KEY_PAD : KEY_REAL);
        }
    };

    // Q fragments (A of Q·K^T), rows row0+g and row0+g+8; rows beyond N read 0
    const T* q0 = q + base + (size_t)(row0 + g) * HD;
    const T* q1 = q0 + 8 * HD;
    const bool in0 = row0 + g < N, in1 = row0 + g + 8 < N;
    float qf[F32 ? KS : 1][4];              // float32, as is
    uint32_t qa[KS][4];                     // float32: hi (Q_SPLIT); bf16: the pairs
    uint32_t ql[Q_SPLIT ? KS : 1][4];       // float32: lo (Q_SPLIT)
#pragma unroll
    for (int s = 0; s < KS; ++s) {
        if constexpr (F32) {
            const int c = 8 * s + t;
            qf[s][0] = in0 ? q0[c] : 0.f;
            qf[s][1] = in1 ? q1[c] : 0.f;
            qf[s][2] = in0 ? q0[c + 4] : 0.f;
            qf[s][3] = in1 ? q1[c + 4] : 0.f;
            if constexpr (Q_SPLIT) {
#pragma unroll
                for (int i = 0; i < 4; ++i) split_tf32(qf[s][i], qa[s][i], ql[s][i]);
            }
        } else {
            const int c = 16 * s + 2 * t;
            qa[s][0] = in0 ? *reinterpret_cast<const uint32_t*>(q0 + c) : 0u;
            qa[s][1] = in1 ? *reinterpret_cast<const uint32_t*>(q1 + c) : 0u;
            qa[s][2] = in0 ? *reinterpret_cast<const uint32_t*>(q0 + c + 8) : 0u;
            qa[s][3] = in1 ? *reinterpret_cast<const uint32_t*>(q1 + c + 8) : 0u;
        }
    }

    float o[DT][4];
#pragma unroll
    for (int d = 0; d < DT; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY;   // running max of rows g, g+8
    float l0 = 0.f, l1 = 0.f;               // this lane's part of the running sums

    const int tiles = (N + BLOCK_K - 1) / BLOCK_K;
    load_tile(0, 0);
    cp_async_commit();
    for (int it = 0; it < tiles; ++it) {
        const int stage = it & 1;
        if (it + 1 < tiles) load_tile(it + 1, stage ^ 1);
        cp_async_commit();          // an empty group on the last tile keeps the count
        cp_async_wait_one();        // this tile has landed (for this thread) ...
        __syncthreads();            // ... and for every thread
        if (active) {
            const T* kt = ks + stage * BLOCK_K * LD;
            const T* vt = vs + stage * BLOCK_K * LD;
            const float* ct = codes + stage * BLOCK_K;

            // S = Q·K^T: lane holds S[g][8n+2t, +1] in s[n][0..1], S[g+8][..] in s[n][2..3]
            float s[NT][4];
#pragma unroll
            for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
            for (int kk = 0; kk < KS; ++kk) {
                if constexpr (F32) {
                    uint32_t ah[4], al[4];
                    if constexpr (Q_SPLIT) {
#pragma unroll
                        for (int i = 0; i < 4; ++i) { ah[i] = qa[kk][i]; al[i] = ql[kk][i]; }
                    } else {
#pragma unroll
                        for (int i = 0; i < 4; ++i) split_tf32(qf[kk][i], ah[i], al[i]);
                    }
#pragma unroll
                    for (int n = 0; n < NT; ++n) {
                        // B[d][key] = K[key][d]: d = 8kk + t (+4), key = 8n + g
                        const float* kr = kt + (8 * n + g) * LD + 8 * kk + t;
                        uint32_t bh0, bl0, bh1, bl1;
                        split_tf32(kr[0], bh0, bl0);
                        split_tf32(kr[4], bh1, bl1);
                        mma_tf32(s[n], al, bh0, bh1);
                        mma_tf32(s[n], ah, bl0, bl1);
                        mma_tf32(s[n], ah, bh0, bh1);
                    }
                } else {
#pragma unroll
                    for (int n = 0; n < NT; ++n) {
                        // B[d][key] = K[key][d]: d = 16kk + 2t, +1 (+8), key = 8n + g
                        const T* kr = kt + (8 * n + g) * LD + 16 * kk + 2 * t;
                        mma_bf16(s[n], qa[kk], *reinterpret_cast<const uint32_t*>(kr),
                                 *reinterpret_cast<const uint32_t*>(kr + 8));
                    }
                }
            }

            // scale, then the where-select; this tile's row maxima
            float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
            for (int n = 0; n < NT; ++n) {
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                    const float code = ct[8 * n + 2 * t + j];
                    float x0 = s[n][j] * scale, x1 = s[n][2 + j] * scale;
                    if (code == KEY_PAD) x0 = x1 = -1e7f;
                    else if (code == KEY_OUT) x0 = x1 = -INFINITY;
                    s[n][j] = x0;
                    s[n][2 + j] = x1;
                    mx0 = fmaxf(mx0, x0);
                    mx1 = fmaxf(mx1, x1);
                }
            }
            mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
            mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
            mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
            mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
            // a tile always holds a key below N, so the new max is finite
            const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
            const float c0 = __expf(m0 - mn0), c1 = __expf(m1 - mn1);   // 0 on the first tile
            m0 = mn0;
            m1 = mn1;
            l0 *= c0;
            l1 *= c1;
#pragma unroll
            for (int d = 0; d < DT; ++d) {
                o[d][0] *= c0; o[d][1] *= c0;
                o[d][2] *= c1; o[d][3] *= c1;
            }
#pragma unroll
            for (int n = 0; n < NT; ++n) {
                s[n][0] = __expf(s[n][0] - mn0);
                s[n][1] = __expf(s[n][1] - mn0);
                s[n][2] = __expf(s[n][2] - mn1);
                s[n][3] = __expf(s[n][3] - mn1);
                l0 += s[n][0] + s[n][1];
                l1 += s[n][2] + s[n][3];
            }

            // O += P·V
            if constexpr (F32) {
#pragma unroll
                for (int n = 0; n < NT; ++n) {
                    // keys 8n..8n+7 relabelled: A column t = key 2t, column t+4 = key 2t+1
                    uint32_t ah[4], al[4];
                    split_tf32(s[n][0], ah[0], al[0]);
                    split_tf32(s[n][2], ah[1], al[1]);
                    split_tf32(s[n][1], ah[2], al[2]);
                    split_tf32(s[n][3], ah[3], al[3]);
                    const float* vr = vt + (8 * n + 2 * t) * LD + g;
#pragma unroll
                    for (int d = 0; d < DT; ++d) {
                        uint32_t bh0, bl0, bh1, bl1;
                        split_tf32(vr[8 * d], bh0, bl0);        // V[8n + 2t][8d + g]
                        split_tf32(vr[8 * d + LD], bh1, bl1);   // V[8n + 2t + 1][8d + g]
                        mma_tf32(o[d], al, bh0, bh1);
                        mma_tf32(o[d], ah, bl0, bl1);
                        mma_tf32(o[d], ah, bh0, bh1);
                    }
                }
            } else {
                const int mi = lane >> 3, r = lane & 7;   // ldmatrix: matrix and row
#pragma unroll
                for (int kk = 0; kk < BLOCK_K / 16; ++kk) {
                    // keys 16kk..16kk+15: S tiles 2kk and 2kk+1 are the A fragment
                    uint32_t ah[4], al[4];
                    split_bf16(s[2 * kk][0], s[2 * kk][1], ah[0], al[0]);
                    split_bf16(s[2 * kk][2], s[2 * kk][3], ah[1], al[1]);
                    split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ah[2], al[2]);
                    split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ah[3], al[3]);
                    const T* vr = vt + (16 * kk + (mi & 1) * 8 + r) * LD + (mi >> 1) * 8;
#pragma unroll
                    for (int d = 0; d < DT; d += 2) {
                        uint32_t bv[4];   // b0, b1 of column tiles d and d + 1
                        ldmatrix_x4_trans(bv, vr + 8 * d);
                        mma_bf16(o[d], al, bv[0], bv[1]);
                        mma_bf16(o[d], ah, bv[0], bv[1]);
                        mma_bf16(o[d + 1], al, bv[2], bv[3]);
                        mma_bf16(o[d + 1], ah, bv[2], bv[3]);
                    }
                }
            }
        }
        __syncthreads();            // every warp is done with this stage
    }

    if (active) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
        l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
        l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
        l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
        const float inv0 = 1.f / l0, inv1 = 1.f / l1;
        T* o0 = out + base + (size_t)(row0 + g) * HD + 2 * t;
        T* o1 = o0 + 8 * HD;
#pragma unroll
        for (int d = 0; d < DT; ++d) {
            if (in0) store2(o0 + 8 * d, o[d][0] * inv0, o[d][1] * inv0);
            if (in1) store2(o1 + 8 * d, o[d][2] * inv1, o[d][3] * inv1);
        }
    }
}

template <int HD, typename T>
int launch(const void* q, const void* k, const void* v, const float* mask,
           void* out, int B, int H, int N, float scale, cudaStream_t stream) {
    constexpr size_t smem = smem_bytes<HD, T>();
    cudaError_t err = cudaFuncSetAttribute(
        attention_fwd_kernel<HD, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((N + BLOCK_Q - 1) / BLOCK_Q, B * H);
    attention_fwd_kernel<HD, T><<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        mask, static_cast<T*>(out), H, N, scale);
    return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. q, k, v, out: contiguous
// [B, H, N, head_dim], each base 16-byte aligned (cp.async); mask: contiguous
// float32 [B, N] (1.0 = PAD) or null. dtype: 0 = float32, 1 = bfloat16.
// Returns cudaGetLastError() after the launch (0 = launched), or -1 for a
// head_dim/dtype with no instantiation.
extern "C" int attention_fwd(const void* q, const void* k, const void* v,
                             const void* mask, void* out, int B, int H, int N,
                             int head_dim, int dtype, float scale, void* stream) {
    const float* m = static_cast<const float*>(mask);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (B <= 0 || H <= 0 || N <= 0) return -1;
    if (dtype == 0) {
        if (head_dim == 32) return launch<32, float>(q, k, v, m, out, B, H, N, scale, s);
        if (head_dim == 64) return launch<64, float>(q, k, v, m, out, B, H, N, scale, s);
        if (head_dim == 80) return launch<80, float>(q, k, v, m, out, B, H, N, scale, s);
    } else if (dtype == 1) {
        if (head_dim == 32) return launch<32, __nv_bfloat16>(q, k, v, m, out, B, H, N, scale, s);
        if (head_dim == 64) return launch<64, __nv_bfloat16>(q, k, v, m, out, B, H, N, scale, s);
        if (head_dim == 80) return launch<80, __nv_bfloat16>(q, k, v, m, out, B, H, N, scale, s);
    }
    return -1;
}
