// Masked multi-head attention forward for Hopper (sm_90a).
//
// Replaces both TPU kernel bodies of mre_tpu/ops/pallas/attention.py, each
// launched by `_pallas_forward` through `pl.pallas_call` at line 170:
//
// * `_attention_kernel` (lines 81-91), head_dim >= 64: the M3AE encoder
//   (6 heads of 64 at the `small` preset; 80 at `huge`);
// * `_attention_kernel_packed` (lines 94-136), head_dim < 64: the M3AE decoder
//   (16 heads of 32 at every preset). On the TPU it stacks four 32-wide heads
//   block-diagonally into one 128-lane MXU operand; its output is, head for
//   head, the same function as `_attention_kernel`. A Hopper thread has no
//   128-lane operand to fill, so the packing does not carry over: the port
//   runs the same kernel at HD = 32.
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
// Memory plan. The TPU kernel holds whole [N, N] rows in VMEM. A Hopper block
// has at most 227 KB of shared memory, which whole rows of K and V do not fit
// at hd = 80, so this kernel streams key tiles instead: one block per
// (b, h, BLOCK_Q query rows), one thread per query row, key tiles of BLOCK_K
// rows staged through shared memory in float32, and an online softmax
// (running max and running sum in float32) across tiles. The sequence is not
// padded: the last query and key tiles are ragged and masked here.
//
// What bounds it on an H100. At the entity-sweep shape of M3AE-small
// (B 512, H 6, N 321, hd 64) the work is 4·B·H·N²·hd = 81 GFLOP against
// 1.01 GB of q, k, v and out in float32: at 67 TFLOP/s (float32 outside the
// tensor cores) and 3.35 TB/s that is 1.21 ms of arithmetic against 0.30 ms
// of memory, so float32 is bound by operations; in bfloat16 (0.50 GB) memory
// would bind first on the tensor cores. At the decoder shape of the training
// step (B 60, H 16, N 321, hd 32) it is 12.7 GFLOP against 158 MB: bound by
// operations too (0.19 ms). This first version computes on the float32 cores
// in both types (no wgmma, no TMA, no pipelining) and is right before it is
// fast.
//
// Tiles at HD = 32. K and V tiles take half the shared memory of HD = 64, but
// the logit tile [BLOCK_K][BLOCK_Q] does not shrink with HD: a block needs
// 16.5 KB at BLOCK_K = 32, 33 KB at 64 and 66 KB at 128, so 13, 6 or 3 blocks
// fit an SM's shared memory; at 95 registers per thread (ptxas, no spills)
// the register file holds 10. Each thread's q.k is a chain of dependent FMAs,
// so the kernel lives on the warps the SM can switch between, and the
// smallest tile that keeps 10 blocks resident is the fastest: at the decoder
// shape, float32, BLOCK_K 32 / 64 / 128 take 0.747 / 0.839 / 1.276 ms on an
// H100 80GB HBM3 at 700 W (`python -m mre_tpu_torch.tools.tile_sweep`).
// BLOCK_K_HD32 overrides the choice for such a sweep; HD 64 and 80 keep 64.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

#ifndef BLOCK_K_HD32
#define BLOCK_K_HD32 32
#endif

constexpr int BLOCK_Q = 64;   // query rows per block = threads per block

// key rows per shared-memory tile
template <int HD> __host__ __device__ constexpr int block_k() {
    return HD <= 32 ? BLOCK_K_HD32 : 64;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <int HD, typename T>
__global__ void __launch_bounds__(BLOCK_Q)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ mask,
                     T* __restrict__ out, int H, int N, float scale) {
    constexpr int BLOCK_K = block_k<HD>();
    extern __shared__ float smem[];
    float* ks = smem;                    // [BLOCK_K][HD]
    float* vs = ks + BLOCK_K * HD;       // [BLOCK_K][HD]
    float* ss = vs + BLOCK_K * HD;       // [BLOCK_K][BLOCK_Q] logits of this tile
    float* pad = ss + BLOCK_K * BLOCK_Q; // [BLOCK_K] 1.0 = PAD

    const int bh = blockIdx.y;           // b * H + h
    const int b = bh / H;
    const int t = threadIdx.x;
    const int qi = blockIdx.x * BLOCK_Q + t;
    const bool live = qi < N;
    const size_t base = (size_t)bh * N * HD;

    float qr[HD];
    float acc[HD];
#pragma unroll
    for (int d = 0; d < HD; ++d) {
        qr[d] = live ? to_f32(q[base + (size_t)qi * HD + d]) : 0.f;
        acc[d] = 0.f;
    }
    float m = -INFINITY;   // running max of this row's logits
    float l = 0.f;         // running sum of exp(logit - m)

    for (int k0 = 0; k0 < N; k0 += BLOCK_K) {
        const int nk = min(BLOCK_K, N - k0);
        __syncthreads();   // every thread is done with the previous tile
        const size_t tile = base + (size_t)k0 * HD;
        for (int i = t; i < nk * HD; i += BLOCK_Q) {
            ks[i] = to_f32(k[tile + i]);
            vs[i] = to_f32(v[tile + i]);
        }
        for (int j = t; j < nk; j += BLOCK_Q) {
            pad[j] = mask != nullptr ? mask[(size_t)b * N + k0 + j] : 0.f;
        }
        __syncthreads();

        float tmax = -INFINITY;
        for (int j = 0; j < nk; ++j) {
            const float* kj = ks + j * HD;
            float s = 0.f;
#pragma unroll
            for (int d = 0; d < HD; ++d) s = fmaf(qr[d], kj[d], s);
            s *= scale;
            if (pad[j] > 0.f) s = -1e7f;
            ss[j * BLOCK_Q + t] = s;
            tmax = fmaxf(tmax, s);
        }
        const float m_new = fmaxf(m, tmax);
        const float corr = expf(m - m_new);   // 0 on the first tile (m = -inf)
        l *= corr;
#pragma unroll
        for (int d = 0; d < HD; ++d) acc[d] *= corr;
        for (int j = 0; j < nk; ++j) {
            const float p = expf(ss[j * BLOCK_Q + t] - m_new);
            const float* vj = vs + j * HD;
            l += p;
#pragma unroll
            for (int d = 0; d < HD; ++d) acc[d] = fmaf(p, vj[d], acc[d]);
        }
        m = m_new;
    }

    if (live) {
        const float inv = 1.f / l;
        T* o = out + base + (size_t)qi * HD;
#pragma unroll
        for (int d = 0; d < HD; ++d) store(o + d, acc[d] * inv);
    }
}

template <int HD, typename T>
int launch(const void* q, const void* k, const void* v, const float* mask,
           void* out, int B, int H, int N, float scale, cudaStream_t stream) {
    constexpr int BLOCK_K = block_k<HD>();
    const size_t smem = sizeof(float) * (2 * BLOCK_K * HD + BLOCK_K * BLOCK_Q + BLOCK_K);
    cudaError_t err = cudaFuncSetAttribute(
        attention_fwd_kernel<HD, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((N + BLOCK_Q - 1) / BLOCK_Q, B * H);
    attention_fwd_kernel<HD, T><<<grid, BLOCK_Q, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        mask, static_cast<T*>(out), H, N, scale);
    return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. q, k, v, out: contiguous
// [B, H, N, head_dim]; mask: contiguous float32 [B, N] (1.0 = PAD) or null.
// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 = launched), or -1 for a head_dim/dtype with no instantiation.
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
