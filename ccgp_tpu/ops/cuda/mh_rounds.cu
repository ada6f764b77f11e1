// R speculative Metropolis rounds of the SE/SE convex-combination GP in
// one launch, one thread block per chain.
//
// Per round and candidate k (one group of `tpc` threads each):
//   z_k   = state + delta[r, k]                  (unconstrained candidate)
//   rates = transform(z_k), extra = log-Jacobian + log-prior
//   A     = [[R_mix + jitter I], [y'], [1']]     ((n+2) x n, shared memory)
//   square-root-free blocked right-looking elimination of A's first n
//   columns: pivots d_j give log det R = sum log d_j, and the two border
//   rows give y'R^-1y, 1'R^-1y, 1'R^-1 1 = sum_j b_j c_j / d_j.
// Then one thread applies the first-acceptance rule over the K candidates
// and writes the round's post-state row, exactly as the XLA scan in
// models/likelihood.py (make_mh_rounds) does. Random inputs (deltas,
// log_u) come from jax.random outside the kernel.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC -I<jax.ffi.include_dir()>
// (ccgp_tpu/ops/mh_rounds_gpu.py builds it at first use).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <string>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kMaxK = 8;             // candidates per round
constexpr int kMaxD = 16;            // input dimensions
constexpr int kMaxDim = kMaxD + 2;   // unconstrained parameters
// consts: sigma2, jitter, then (a, b) of the theta1, theta2 and p priors
constexpr int kNConsts = 8;
constexpr float kLog2Pi = 1.8378770664093453f;
constexpr int kPanel = 4;            // columns per elimination panel
constexpr int kTileCols = 8;         // columns per trailing-update tile
constexpr int kRowSlots = 4;         // 32-row slots per lane: n + 2 <= 128

// prior codes (ccgp_tpu/ops/mh_rounds_gpu.py: _prior_code)
constexpr int kPriorNone = 0;
constexpr int kPriorInverseGamma = 1;
constexpr int kPriorLogNormal = 2;
constexpr int kPriorJeffreys = 3;

// rough-component modes (mh_rounds_gpu.ROUGH_CODES): only "tied" scales
// theta1; "free" and "lambda" train on theta2 directly
constexpr int kRoughTied = 1;

__device__ __forceinline__ float prior_log_kernel(int code, float a, float b,
                                                  float x) {
  if (code == kPriorInverseGamma) return -(a + 1.0f) * logf(x) - b / x;
  if (code == kPriorLogNormal) {
    float lx = logf(x);
    float u = (lx - a) / b;
    return -lx - 0.5f * u * u;
  }
  if (code == kPriorJeffreys) return -0.5f * (logf(x) + log1pf(-x));
  return 0.0f;
}

__device__ __forceinline__ float log_sigmoid(float x) {
  // -softplus(-x), stable for large |x|
  return -(fmaxf(-x, 0.0f) + log1pf(expf(-fabsf(x))));
}

__host__ __device__ __forceinline__ int round4(int v) { return (v + 3) & ~3; }

// barrier over one candidate's thread group (ids 1..K; 0 is __syncthreads)
__device__ __forceinline__ void group_sync(int id, int nthreads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(nthreads) : "memory");
}

struct Model {
  int n, d, dim, kk, rr, tpc;
  int aniso, rough, prior1, prior2, prior_p;
};

__global__ void __launch_bounds__(1024) mh_rounds_kernel(Model m, const float* __restrict__ x_all,
                                 const float* __restrict__ y_all,
                                 const float* __restrict__ state_all,
                                 const float* __restrict__ consts_all,
                                 const float* __restrict__ deltas_all,
                                 const float* __restrict__ logu_all,
                                 float* __restrict__ rec_all,
                                 int32_t* __restrict__ info_all,
                                 float* __restrict__ vals_all,
                                 float* __restrict__ betas_all) {
  extern __shared__ float smem[];
  __shared__ float s_state[kMaxDim + 2];   // z | beta | logpost
  __shared__ float s_zc[kMaxK][kMaxDim];
  __shared__ float s_r1[kMaxK][kMaxD];
  __shared__ float s_r2[kMaxK][kMaxD];
  __shared__ float s_w[kMaxK][3];          // w1, w2, w1 + w2
  __shared__ float s_extra[kMaxK];
  __shared__ float s_lscale[kMaxK];
  __shared__ float s_val[kMaxK];
  __shared__ float s_beta[kMaxK];

  const int n = m.n, d = m.d, dim = m.dim, kk = m.kk, rr = m.rr;
  const int ld = n + 2;                    // column stride (rows 0..n+1)
  const int b = blockIdx.x;
  const float* x = x_all + (size_t)b * n * d;
  const float* y = y_all + (size_t)b * n;
  const float* consts = consts_all + (size_t)b * kNConsts;
  const float* deltas = deltas_all + (size_t)b * rr * kk * dim;
  const float* logu = logu_all + (size_t)b * rr * kk;
  float* rec = rec_all + (size_t)b * rr * (dim + 2);
  int32_t* info = info_all + (size_t)b * rr * 2;
  float* vals_out = vals_all + (size_t)b * rr * kk;
  float* betas_out = betas_all + (size_t)b * rr * kk;

  const float sigma2 = consts[0];
  const float jitter = consts[1];

  // dynamic shared memory: x, then per candidate its bordered Gram A
  // (n columns of ld rows), the unscaled panel U (n + 2 rows) and the
  // scaled panel S (n rows); every part starts 16-byte aligned
  const int x_len = round4(n * d), a_len = round4(ld * n);
  const int per_cand = a_len + 4 * (n + 2) + 4 * n;
  float* s_x = smem;                       // (n, d) row-major

  const int tid = threadIdx.x;
  const int g = tid / m.tpc;               // candidate of this thread
  const int t = tid % m.tpc;               // thread within the group
  const int lane = t & 31;
  const int warp = t >> 5;
  const int nwarps = m.tpc >> 5;
  float* A = smem + x_len + (size_t)g * per_cand;
  float4* U = reinterpret_cast<float4*>(A + a_len);
  float4* S = U + (n + 2);

  for (int i = tid; i < n * d; i += blockDim.x) s_x[i] = x[i];
  if (tid < dim + 2) s_state[tid] = state_all[(size_t)b * (dim + 2) + tid];
  __syncthreads();

  for (int r = 0; r < rr; ++r) {
    // ---- candidate transform, rates and prior terms (one thread each)
    if (t == 0) {
      float cz[kMaxDim];
      const float* dr = deltas + ((size_t)r * kk + g) * dim;
      for (int i = 0; i < dim; ++i) {
        cz[i] = s_state[i] + dr[i];
        s_zc[g][i] = cz[i];
      }
      float th1[kMaxD];
      float th2, phi, log_jac = 0.0f;
      if (m.aniso) {
        for (int a = 0; a < d; ++a) {
          th1[a] = expf(cz[a]);
          log_jac += cz[a];
        }
        phi = cz[d];
        th2 = expf(cz[d + 1]);
        log_jac += cz[d + 1];
      } else {
        float t1 = expf(cz[0]);
        for (int a = 0; a < d; ++a) th1[a] = t1;
        th2 = expf(cz[1]);
        phi = cz[2];
        log_jac += cz[0] + cz[1];
      }
      const float p = 1.0f / (1.0f + expf(-phi));
      log_jac += log_sigmoid(phi) + log_sigmoid(-phi);
      float lp = 0.0f;
      if (m.prior1 != kPriorNone) {
        if (m.aniso) {
          for (int a = 0; a < d; ++a)
            lp += prior_log_kernel(m.prior1, consts[2], consts[3], th1[a]);
        } else {
          lp += prior_log_kernel(m.prior1, consts[2], consts[3], th1[0]);
        }
      }
      lp += prior_log_kernel(m.prior2, consts[4], consts[5], th2);
      lp += prior_log_kernel(m.prior_p, consts[6], consts[7], p);
      for (int a = 0; a < d; ++a) {
        s_r1[g][a] = th1[a];
        s_r2[g][a] = (m.rough == kRoughTied) ? (1.0f + th2) * th1[a] : th2;
      }
      const float w1 = p * p, w2 = (1.0f - p) * (1.0f - p);
      s_w[g][0] = w1;
      s_w[g][1] = w2;
      s_w[g][2] = w1 + w2;
      s_extra[g] = log_jac + lp;
      s_lscale[g] = logf((w1 + w2) * sigma2);
    }
    group_sync(1 + g, m.tpc);

    // ---- bordered mixture Gram, lower part, column-major: warps take
    // columns, lanes take rows
    {
      const float w1 = s_w[g][0], w2 = s_w[g][1], inv_ws = 1.0f / s_w[g][2];
      for (int c = warp; c < n; c += nwarps) {
#pragma unroll
        for (int q = 0; q < kRowSlots; ++q) {
          const int i = c + lane + 32 * q;
          if (i > n + 1) break;
          float v;
          if (i < n) {
            float d1 = 0.0f, d2 = 0.0f;
            for (int a = 0; a < d; ++a) {
              const float df = s_x[i * d + a] - s_x[c * d + a];
              const float sq = df * df;
              d1 = fmaf(s_r1[g][a], sq, d1);
              d2 = fmaf(s_r2[g][a], sq, d2);
            }
            v = (w1 * expf(-d1) + w2 * expf(-d2)) * inv_ws;
            if (i == c) v += jitter;
          } else {
            v = (i == n) ? y[c] : 1.0f;
          }
          A[c * ld + i] = v;
        }
      }
    }

    // ---- blocked elimination, panels of kPanel columns. Per panel:
    // warp 0 factors the panel with its rows in registers (lane l holds
    // rows jb + l + 32 q), writes the unscaled panel U (rows >= jb + w)
    // and the scaled panel S = U / pivot (rows < n); then all warps apply
    // A[i][c] -= sum_q U[i][q] S[c][q] to the trailing lower triangle in
    // 32-row x kTileCols-column tiles.
    float logdet = 0.0f, qyy = 0.0f, qoy = 0.0f, qoo = 0.0f;
    bool bad = false;
    for (int jb = 0; jb < n; jb += kPanel) {
      const int width = min(kPanel, n - jb);
      group_sync(1 + g, m.tpc);
      if (warp == 0) {
        float p[kRowSlots][kPanel];
#pragma unroll
        for (int q = 0; q < kRowSlots; ++q) {
          const int i = jb + lane + 32 * q;
#pragma unroll
          for (int c = 0; c < kPanel; ++c)
            p[q][c] = (i <= n + 1 && c < width) ? A[(jb + c) * ld + i] : 0.0f;
        }
        float dinv[kPanel];
#pragma unroll
        for (int c = 0; c < kPanel; ++c) {
          const float piv = __shfl_sync(0xffffffffu, p[0][c], c);
          dinv[c] = (c < width) ? 1.0f / piv : 0.0f;
          if (c < width && lane == 0) {
            bad |= !(piv > 0.0f);
            logdet += logf(piv);
          }
#pragma unroll
          for (int c2 = c + 1; c2 < kPanel; ++c2) {
            const float f = __shfl_sync(0xffffffffu, p[0][c], c2) * dinv[c];
            if (c2 < width) {
#pragma unroll
              for (int q = 0; q < kRowSlots; ++q) p[q][c2] = fmaf(-p[q][c], f, p[q][c2]);
            }
          }
        }
#pragma unroll
        for (int q = 0; q < kRowSlots; ++q) {
          const int i = jb + lane + 32 * q;
          if (i >= jb + width && i <= n + 1) {
            U[i] = make_float4(p[q][0], p[q][1], p[q][2], p[q][3]);
            if (i < n)
              S[i] = make_float4(p[q][0] * dinv[0], p[q][1] * dinv[1],
                                 p[q][2] * dinv[2], p[q][3] * dinv[3]);
          }
        }
        __syncwarp();
        if (lane == 0) {
          const float4 by = U[n], bo = U[n + 1];
          const float byv[4] = {by.x, by.y, by.z, by.w};
          const float bov[4] = {bo.x, bo.y, bo.z, bo.w};
#pragma unroll
          for (int c = 0; c < kPanel; ++c) {
            qyy = fmaf(byv[c] * byv[c], dinv[c], qyy);
            qoy = fmaf(byv[c] * bov[c], dinv[c], qoy);
            qoo = fmaf(bov[c] * bov[c], dinv[c], qoo);
          }
        }
      }
      group_sync(1 + g, m.tpc);

      const int lo = jb + width;          // first trailing row / column
      if (lo < n) {
        const int nrt = (n + 2 - lo + 31) / 32;
        const int nct = (n - lo + kTileCols - 1) / kTileCols;
        for (int tile = warp; tile < nrt * nct; tile += nwarps) {
          const int rt = tile / nct, ct = tile - rt * nct;
          const int r0 = lo + 32 * rt, c0 = lo + kTileCols * ct;
          if (r0 + 31 < c0) continue;     // above the diagonal
          const int i = r0 + lane;
          const bool row_ok = i <= n + 1;
          const float4 u = row_ok ? U[i] : make_float4(0.f, 0.f, 0.f, 0.f);
          float av[kTileCols];
#pragma unroll
          for (int q = 0; q < kTileCols; ++q) {
            const int c = c0 + q;
            av[q] = (row_ok && c < n && c <= i) ? A[c * ld + i] : 0.0f;
          }
#pragma unroll
          for (int q = 0; q < kTileCols; ++q) {
            const float4 sv = S[min(c0 + q, n - 1)];
            float acc = u.x * sv.x;
            acc = fmaf(u.y, sv.y, acc);
            acc = fmaf(u.z, sv.z, acc);
            acc = fmaf(u.w, sv.w, acc);
            av[q] -= acc;
          }
#pragma unroll
          for (int q = 0; q < kTileCols; ++q) {
            const int c = c0 + q;
            if (row_ok && c < n && c <= i) A[c * ld + i] = av[q];
          }
        }
      }
    }
    if (t == 0) {
      const float beta = qoy / qoo;
      const float quad = qyy - qoy * qoy / qoo;
      const float ls = s_lscale[g];
      float val = -0.5f * (n * kLog2Pi + logdet + n * ls + quad * expf(-ls)) +
                  s_extra[g];
      if (bad || !isfinite(val)) val = -INFINITY;
      s_val[g] = val;
      s_beta[g] = beta;
    }
    __syncthreads();

    // ---- first acceptance, state update, round outputs
    if (tid == 0) {
      const float lpv = s_state[dim + 1];
      int first = kk;
      for (int k = 0; k < kk; ++k) {
        if ((s_val[k] - lpv) > logu[(size_t)r * kk + k]) {
          first = k;
          break;
        }
      }
      if (first < kk) {
        for (int i = 0; i < dim; ++i) s_state[i] = s_zc[first][i];
        s_state[dim] = s_beta[first];
        s_state[dim + 1] = s_val[first];
      }
      for (int i = 0; i < dim + 2; ++i) rec[(size_t)r * (dim + 2) + i] = s_state[i];
      info[2 * r] = first < kk;
      info[2 * r + 1] = first < kk ? first + 1 : kk;
      for (int k = 0; k < kk; ++k) {
        vals_out[(size_t)r * kk + k] = s_val[k];
        betas_out[(size_t)r * kk + k] = s_beta[k];
      }
    }
    __syncthreads();
  }
}

ffi::Error MhRoundsImpl(cudaStream_t stream, ffi::Buffer<ffi::F32> x,
                        ffi::Buffer<ffi::F32> y, ffi::Buffer<ffi::F32> state,
                        ffi::Buffer<ffi::F32> consts,
                        ffi::Buffer<ffi::F32> deltas,
                        ffi::Buffer<ffi::F32> log_u,
                        ffi::ResultBuffer<ffi::F32> rec,
                        ffi::ResultBuffer<ffi::S32> info,
                        ffi::ResultBuffer<ffi::F32> vals,
                        ffi::ResultBuffer<ffi::F32> betas, int64_t aniso,
                        int64_t rough, int64_t prior1, int64_t prior2,
                        int64_t prior_p) {
  auto xd = x.dimensions();
  auto dd = deltas.dimensions();
  if (xd.size() < 2 || dd.size() < 3)
    return ffi::Error::InvalidArgument("x must be (..., n, d), deltas (..., R, K, dim)");
  Model m;
  m.n = static_cast<int>(xd[xd.size() - 2]);
  m.d = static_cast<int>(xd[xd.size() - 1]);
  m.rr = static_cast<int>(dd[dd.size() - 3]);
  m.kk = static_cast<int>(dd[dd.size() - 2]);
  m.dim = static_cast<int>(dd[dd.size() - 1]);
  m.aniso = static_cast<int>(aniso);
  m.rough = static_cast<int>(rough);
  m.prior1 = static_cast<int>(prior1);
  m.prior2 = static_cast<int>(prior2);
  m.prior_p = static_cast<int>(prior_p);
  m.tpc = m.kk <= 4 ? 256 : 128;
  if (m.kk < 1 || m.kk > kMaxK || m.d < 1 || m.d > kMaxD ||
      m.dim != (m.aniso ? m.d + 2 : 3) || m.n < 1 || m.n + 2 > 32 * kRowSlots)
    return ffi::Error::InvalidArgument("mh_rounds: shape outside the kernel envelope");
  const int64_t batch = static_cast<int64_t>(x.element_count()) / (m.n * m.d);
  if (batch < 1) return ffi::Error::Success();
  const size_t smem =
      sizeof(float) * ((size_t)round4(m.n * m.d) +
                       (size_t)m.kk * (round4((m.n + 2) * m.n) + 8 * m.n + 8));
  cudaError_t err = cudaFuncSetAttribute(
      mh_rounds_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess)
    return ffi::Error::Internal(std::string("mh_rounds smem attribute: ") +
                                cudaGetErrorString(err));
  mh_rounds_kernel<<<static_cast<unsigned>(batch), m.kk * m.tpc, smem, stream>>>(
      m, x.typed_data(), y.typed_data(), state.typed_data(),
      consts.typed_data(), deltas.typed_data(), log_u.typed_data(),
      rec->typed_data(), info->typed_data(), vals->typed_data(),
      betas->typed_data());
  err = cudaGetLastError();
  if (err != cudaSuccess)
    return ffi::Error::Internal(std::string("mh_rounds launch: ") +
                                cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(CcgpMhRounds, MhRoundsImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()  // x
                                  .Arg<ffi::Buffer<ffi::F32>>()  // y
                                  .Arg<ffi::Buffer<ffi::F32>>()  // state
                                  .Arg<ffi::Buffer<ffi::F32>>()  // consts
                                  .Arg<ffi::Buffer<ffi::F32>>()  // deltas
                                  .Arg<ffi::Buffer<ffi::F32>>()  // log_u
                                  .Ret<ffi::Buffer<ffi::F32>>()  // rec
                                  .Ret<ffi::Buffer<ffi::S32>>()  // info
                                  .Ret<ffi::Buffer<ffi::F32>>()  // vals
                                  .Ret<ffi::Buffer<ffi::F32>>()  // betas
                                  .Attr<int64_t>("aniso")
                                  .Attr<int64_t>("rough")
                                  .Attr<int64_t>("prior1")
                                  .Attr<int64_t>("prior2")
                                  .Attr<int64_t>("prior_p"));
