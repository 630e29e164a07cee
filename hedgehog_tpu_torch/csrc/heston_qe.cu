// QE mixing kernels for sm_90a: per-path values (K7) and the accumulating
// serving price (K8).
//
// Replaces hedgehog_tpu/ops/heston_qe_kernel.py:
//   heston_qe_mixing_values         (pallas_call at :774 QMC, :794 PRNG;
//                                    bodies _qe_mixing_values_kernel[_qmc])
//   heston_qe_mixing_vanilla_price  (pallas_call at :904 QMC, :925 PRNG;
//                                    bodies _qe_mixing_price_kernel[_qmc])
//
// Per step a path draws one normal and one uniform, moves V by the QE
// scheme (quadratic or exponential branch), adds the trapezoid to IV and
// the exact-identity increment to J; the path closes with the conditional
// Black-Scholes formula.  The plain PyTorch twin is
// hedgehog_tpu_torch/ops/heston_qe_kernel.py; keep the two in step.
//
// What bounds it on this card: FP32 and special-function issue (per step
// and path two or three polished reciprocals, a square root or a log, and
// for the stream a Sobol' XOR walk or half a Philox call and Box-Muller),
// not memory: K7 writes 4 bytes per path, K8 one double per block.  The
// design keeps one antithetic pair per thread with (v, IV, J) of both paths
// in registers, evaluates only the QE branch a lane takes (the TPU kernel
// computes both and selects), and for K8 runs one resident wave of blocks
// that each walk a fixed stride of pairs.  K8 sums in fp32 per thread and in
// float64 per block (heston_qe.cuh block_sums, the tree the greek kernel
// K10 uses for its price column), so K10's price equals K8's to the bit.

#include "heston_qe.cuh"

namespace {

constexpr int kThreads = 256;

// The (value, antithetic value) of global pair `pair`.
__device__ __forceinline__ void mix_pair(unsigned long long pair, const hh::MixParams& c,
                                         const int* sobol, int steps, bool antithetic,
                                         uint32_t seed, uint32_t device_id,
                                         long long point_offset, float& val, float& val_a) {
  float v = c.v0, iv = 0.0f, j = 0.0f, va = c.v0, iva = 0.0f, ja = 0.0f;
  hh::mix_draws(pair, sobol, steps, seed, device_id, point_offset, [&](float z, float u) {
    hh::mix_advance(v, iv, j, z, u, c);
    if (antithetic) hh::mix_advance(va, iva, ja, -z, 1.0f - u, c);
  });
  val = hh::cond_bs_value(iv, j, c.close);
  val_a = antithetic ? hh::cond_bs_value(iva, ja, c.close) : 0.0f;
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
qe_values_kernel(const float* __restrict__ params, const int* __restrict__ sobol,
                 float* __restrict__ out, long long n_paths, int steps, int antithetic,
                 uint32_t seed, uint32_t device_id, long long point_offset) {
  __shared__ hh::MixParams sp;
  extern __shared__ int ssob[];
  const int* table =
      hh::stage_inputs<0, 2, hh::MixParams, kStaged>(params, nullptr, sobol, steps, sp, nullptr, ssob);
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_paths) return;
  float val, val_a;
  mix_pair((unsigned long long)i, sp, table, steps, antithetic != 0, seed, device_id,
           point_offset, val, val_a);
  out[i] = val;
  if (antithetic) out[n_paths + i] = val_a;
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
qe_price_kernel(const float* __restrict__ params, const int* __restrict__ sobol,
                double* __restrict__ partials, long long total_pairs, int steps, uint32_t seed,
                uint32_t device_id, long long point_offset) {
  __shared__ hh::MixParams sp;
  __shared__ double red[kThreads];
  extern __shared__ int ssob[];
  const int* table =
      hh::stage_inputs<0, 2, hh::MixParams, kStaged>(params, nullptr, sobol, steps, sp, nullptr, ssob);
  float acc[1] = {0.0f};
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x; g < total_pairs;
       g += stride) {
    float val, val_a;
    mix_pair((unsigned long long)g, sp, table, steps, true, seed, device_id, point_offset, val,
             val_a);
    acc[0] += val + val_a;
  }
  hh::block_sums<kThreads>(acc, red, partials);
}

size_t sobol_smem(const int* sobol, int steps) {
  return sobol ? sizeof(int) * 2 * steps * (hh::kSobolBits + 1) : 0;
}

}  // namespace

// Per-path undiscounted values: out is (1 or 2, n_paths) float32.
extern "C" int hh_qe_values(const float* params, const int* sobol, float* out, long long n_paths,
                            int steps, int antithetic, unsigned seed, unsigned device_id,
                            long long point_offset, void* stream) {
  const long long blocks = (n_paths + kThreads - 1) / kThreads;
  const size_t smem = sobol_smem(sobol, steps);
  if (smem <= hh::smem_room(qe_values_kernel<true>)) {
    const cudaError_t err = hh::allow_dynamic_smem(qe_values_kernel<true>, smem);
    if (err != cudaSuccess) return (int)err;
    qe_values_kernel<true><<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
        params, sobol, out, n_paths, steps, antithetic, seed, device_id, point_offset);
  } else {
    qe_values_kernel<false><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        params, sobol, out, n_paths, steps, antithetic, seed, device_id, point_offset);
  }
  return (int)cudaGetLastError();
}

// Sums of (value + antithetic value): partials is (grid,) float64, one per block.
extern "C" int hh_qe_price(const float* params, const int* sobol, double* partials, int grid,
                           long long total_pairs, int steps, unsigned seed, unsigned device_id,
                           long long point_offset, void* stream) {
  const size_t smem = sobol_smem(sobol, steps);
  if (smem <= hh::smem_room(qe_price_kernel<true>)) {
    const cudaError_t err = hh::allow_dynamic_smem(qe_price_kernel<true>, smem);
    if (err != cudaSuccess) return (int)err;
    qe_price_kernel<true><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        params, sobol, partials, total_pairs, steps, seed, device_id, point_offset);
  } else {
    qe_price_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        params, sobol, partials, total_pairs, steps, seed, device_id, point_offset);
  }
  return (int)cudaGetLastError();
}

// The price kernels' grid (K8, and K10, which must walk the same pairs per
// thread for its price to equal K8's): one resident wave of K8 on the
// current device with `smem` bytes of Sobol' table per block (staged where
// it fits a block, else none: the table is then read from global memory).
extern "C" int hh_qe_price_grid(int smem, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    if ((size_t)smem <= hh::smem_room(qe_price_kernel<true>)) {
      err = hh::allow_dynamic_smem(qe_price_kernel<true>, (size_t)smem);
      if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, qe_price_kernel<true>,
                                                            kThreads, (size_t)smem);
      }
    } else {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, qe_price_kernel<false>,
                                                          kThreads, 0);
    }
  }
  *grid = sms * (per_sm > 0 ? per_sm : 1);
  return (int)err;
}
