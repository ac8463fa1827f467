// The GRU's gate math (nn/recurrent.py gru_update), forward and backward, one
// launch each: the DialogueRNN scan's three cells a time step, GRUCell, GRU.
//
// No TPU kernel is replaced: the JAX package leaves the gates to XLA, which
// fuses them.  In eager PyTorch the same math is 11 elementwise kernels
// forward and about 30 backward a cell and step (ops/gru.py gru_gates_plain).
//
// Forward, with torch's gate order over gi = x W_ih^T + b_ih and
// gh = h W_hh^T + b_hh, each (..., 3H):
//   r = sigmoid(i_r + h_r), z = sigmoid(i_z + h_z), n = tanh(i_n + r h_n),
//   h' = (1 - z) n + z h.
// Backward, from dh': dgi, dgh and the direct part of dh (dh' z); the part
// through gh is the caller's product.  r, z and n are recomputed from the
// forward's inputs, with the same bits.
//
// Rounding: each value is rounded where the chain of torch ops rounds it.  At
// f32 every add and multiply is a separate __f*_rn (nothing contracts into an
// FMA), with full-precision expf and tanhf, as torch's sigmoid (1 / (1 +
// exp(-x))) and tanh compute; tanh_backward's a (1 - b b) is the FMA that
// torch's kernel contracts it into, sigmoid_backward's a (1 - b) b two
// products.  At bf16 each op's result is also rounded to bf16 (round()), as
// each op of the chain writes a bf16 tensor, and so is each step inside
// torch's sigmoid_backward and tanh_backward, which compute in bf16 (the
// other ops compute in f32 and round once); the party sum adds in f32 and
// rounds once, as torch's sum.
//
// The party axis: gi may hold one row for every `parties` consecutive rows of
// gh and h (the DialogueRNN's party cell, whose input is the same for every
// party), as the chain broadcasts it.  The backward thread of a gi element
// walks those rows and sums their dgi in party order.
//
// What bounds it: launch latency.  The scan's largest call moves about 1.4 MB
// (X = 2, B = 30, P = 2, H = 500, backward), a microsecond at 3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
  static __device__ __forceinline__ float round(float v) { return v; }
  // tanh_backward's 1 - b b: torch's f32 kernel contracts it into one FMA
  static __device__ __forceinline__ float one_minus_square(float b) {
    return fmaf(-b, b, 1.0f);
  }
};

template <>
struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  // torch's bf16 tanh_backward rounds b b and 1 - b b
  static __device__ __forceinline__ float one_minus_square(float b) {
    return round(__fsub_rn(1.0f, round(__fmul_rn(b, b))));
  }
};

__device__ __forceinline__ float sigmoid(float a) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-a)));
}

// torch's sigmoid_backward, a (1 - b) b, each step rounded at bf16
template <typename T>
__device__ __forceinline__ float sigmoid_backward(float a, float b) {
  using R = Io<T>;
  return R::round(__fmul_rn(R::round(__fmul_rn(a, R::round(__fsub_rn(1.0f, b)))), b));
}

// r, z, n and 1 - z of one element, each rounded where the chain rounds it.
template <typename T>
struct Gates {
  float r, z, n, omz;

  __device__ __forceinline__ Gates(float ir, float iz, float in, float hr, float hz, float hn) {
    using R = Io<T>;
    r = R::round(sigmoid(R::round(__fadd_rn(ir, hr))));
    z = R::round(sigmoid(R::round(__fadd_rn(iz, hz))));
    n = R::round(tanhf(R::round(__fadd_rn(in, R::round(__fmul_rn(r, hn))))));
    omz = R::round(__fsub_rn(1.0f, z));
  }
};

template <typename T>
__global__ void gru_gates_fwd_kernel(const T* __restrict__ gi, const T* __restrict__ gh,
                                     const T* __restrict__ h, T* __restrict__ out,
                                     long long rows, int parties, int hidden) {
  using R = Io<T>;
  const long long total = rows * hidden;
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x; idx < total;
       idx += (long long)gridDim.x * blockDim.x) {
    const long long row = idx / hidden;
    const int j = (int)(idx - row * hidden);
    const T* gi_row = gi + (row / parties) * 3 * hidden;
    const T* gh_row = gh + row * 3 * hidden;
    const Gates<T> g(R::load(gi_row + j), R::load(gi_row + hidden + j),
                     R::load(gi_row + 2 * hidden + j), R::load(gh_row + j),
                     R::load(gh_row + hidden + j), R::load(gh_row + 2 * hidden + j));
    const float p1 = R::round(__fmul_rn(g.omz, g.n));
    const float p2 = R::round(__fmul_rn(g.z, R::load(h + idx)));
    R::store(out + idx, __fadd_rn(p1, p2));
  }
}

// One thread per element of gi: its `parties` rows of gh, h and dout in turn.
template <typename T>
__global__ void gru_gates_bwd_kernel(const T* __restrict__ gi, const T* __restrict__ gh,
                                     const T* __restrict__ h, const T* __restrict__ dout,
                                     T* __restrict__ dgi, T* __restrict__ dgh,
                                     T* __restrict__ dh, long long gi_rows, int parties,
                                     int hidden) {
  using R = Io<T>;
  const long long total = gi_rows * hidden;
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x; idx < total;
       idx += (long long)gridDim.x * blockDim.x) {
    const long long gi_row = idx / hidden;
    const int j = (int)(idx - gi_row * hidden);
    const T* gi_at = gi + gi_row * 3 * hidden + j;
    const float ir = R::load(gi_at), iz = R::load(gi_at + hidden), in = R::load(gi_at + 2 * hidden);
    float sum_r = 0.0f, sum_z = 0.0f, sum_n = 0.0f;
    for (int p = 0; p < parties; ++p) {
      const long long row = gi_row * parties + p;
      const long long at = row * hidden + j;
      const long long at3 = row * 3 * hidden + j;
      const float hr = R::load(gh + at3), hz = R::load(gh + at3 + hidden);
      const float hn = R::load(gh + at3 + 2 * hidden);
      const Gates<T> g(ir, iz, in, hr, hz, hn);
      const float go = R::load(dout + at), hv = R::load(h + at);
      // (1 - z) n + z h: the products' and the rsub's gradients
      const float d_omz = R::round(__fmul_rn(go, g.n));
      const float dn = R::round(__fmul_rn(go, g.omz));
      const float dz = R::round(__fadd_rn(R::round(__fmul_rn(go, hv)), -d_omz));
      R::store(dh + at, __fmul_rn(go, g.z));
      // n = tanh(i_n + r h_n); r, z = sigmoid(...)
      const float da_n = R::round(__fmul_rn(dn, R::one_minus_square(g.n)));
      const float dr = R::round(__fmul_rn(da_n, hn));
      const float dhn = R::round(__fmul_rn(da_n, g.r));
      const float da_r = sigmoid_backward<T>(dr, g.r);
      const float da_z = sigmoid_backward<T>(dz, g.z);
      R::store(dgh + at3, da_r);
      R::store(dgh + at3 + hidden, da_z);
      R::store(dgh + at3 + 2 * hidden, dhn);
      if (p == 0) {
        sum_r = da_r, sum_z = da_z, sum_n = da_n;
      } else {
        sum_r = __fadd_rn(sum_r, da_r), sum_z = __fadd_rn(sum_z, da_z);
        sum_n = __fadd_rn(sum_n, da_n);
      }
    }
    T* dgi_at = dgi + gi_row * 3 * hidden + j;
    R::store(dgi_at, sum_r);
    R::store(dgi_at + hidden, sum_z);
    R::store(dgi_at + 2 * hidden, sum_n);
  }
}

unsigned blocks_for(long long n) {
  const long long b = (n + kThreads - 1) / kThreads;
  return (unsigned)(b < 65535 * 32 ? b : 65535 * 32);  // the grid-stride loop takes the rest
}

template <typename T>
void launch_fwd(const void* gi, const void* gh, const void* h, void* out, long long gi_rows,
                int parties, int hidden, cudaStream_t stream) {
  const long long rows = gi_rows * parties;
  gru_gates_fwd_kernel<T><<<blocks_for(rows * hidden), kThreads, 0, stream>>>(
      (const T*)gi, (const T*)gh, (const T*)h, (T*)out, rows, parties, hidden);
}

template <typename T>
void launch_bwd(const void* gi, const void* gh, const void* h, const void* dout, void* dgi,
                void* dgh, void* dh, long long gi_rows, int parties, int hidden,
                cudaStream_t stream) {
  gru_gates_bwd_kernel<T><<<blocks_for(gi_rows * hidden), kThreads, 0, stream>>>(
      (const T*)gi, (const T*)gh, (const T*)h, (const T*)dout, (T*)dgi, (T*)dgh, (T*)dh,
      gi_rows, parties, hidden);
}

}  // namespace

extern "C" {

// gi (gi_rows, 3H); gh (gi_rows * parties, 3H); h, out (gi_rows * parties, H);
// contiguous, on the current device, float32 (bf16 = 0) or bfloat16 (bf16 =
// 1).  Launches on `stream`; returns cudaGetLastError() after the launch.
int gan_gru_gates_fwd(const void* gi, const void* gh, const void* h, void* out,
                      long long gi_rows, int parties, int hidden, int bf16,
                      cudaStream_t stream) {
  if (gi_rows <= 0 || parties <= 0 || hidden <= 0) return (int)cudaErrorInvalidValue;
  if (bf16) {
    launch_fwd<__nv_bfloat16>(gi, gh, h, out, gi_rows, parties, hidden, stream);
  } else {
    launch_fwd<float>(gi, gh, h, out, gi_rows, parties, hidden, stream);
  }
  return (int)cudaGetLastError();
}

// The forward's operands, dout like h; writes dgi like gi, dgh like gh, dh
// like h (the direct part, dout z).
int gan_gru_gates_bwd(const void* gi, const void* gh, const void* h, const void* dout,
                      void* dgi, void* dgh, void* dh, long long gi_rows, int parties,
                      int hidden, int bf16, cudaStream_t stream) {
  if (gi_rows <= 0 || parties <= 0 || hidden <= 0) return (int)cudaErrorInvalidValue;
  if (bf16) {
    launch_bwd<__nv_bfloat16>(gi, gh, h, dout, dgi, dgh, dh, gi_rows, parties, hidden, stream);
  } else {
    launch_bwd<float>(gi, gh, h, dout, dgi, dgh, dh, gi_rows, parties, hidden, stream);
  }
  return (int)cudaGetLastError();
}

const char* gan_gru_gates_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
