// In-kernel gather micro-benchmark for Hopper (sm_90a): what do the
// gathers and rotations a texture fetch is built from cost inside a kernel,
// and how much on-chip scratch can a block hold?
//
// Replaces the TPU probe tools/gather_probe3.py (its pallas_calls :63 in
// _time_kernel, :166 in probe_tex128 and :229 in probe_vmem), on (R, 128)
// arrays, K = 32 rounds per launch (a run-time argument):
//   dg0   out[r, l] = sum_{i<K} tbl[(idx[r, l] + i) & (R - 1), l]
//         (take_along_axis on axis 0, R in {1024, 4096}; probe_dg :82-108);
//   dg1   out[r, l] = sum_{i<K} tbl[r, (idx[r, l] + i) & 127] (axis 1);
//   roll  out = sum_{i<K} roll(x, s, axis=1) with s = 1 or s = i, in
//         jnp.roll's direction: out[r, l] += x[r, (l - s) & 127]
//         (probe_roll :111-130);
//   tex   out[i, l] = tbl[q[i, l], c[i, l]] on an int32 (R, 128) table
//         (probe_tex128 :133-189; R = 1024, and 8192 at the bounce kernel's
//         2^20 lanes). The tool's 128-round rotate-gather was TPU machinery
//         for a 2-D gather Mosaic could not lower; here the kernel reads the
//         element directly;
//   scratch  the on-chip scratch capacity (probe_vmem :218-243): a block
//         with S bytes of dynamic shared memory writes row 0 and row n - 1
//         of its (n, 128) f32 scratch and returns their sum. The TPU's VMEM
//         megabytes have no counterpart; a block's shared memory does, up
//         to the card's opt-in limit (232,448 B on an H100), above which
//         cudaFuncSetAttribute refuses the request.
//
// Design (redesigned for Hopper). The parent ran one thread per element,
// each round a 4-byte __ldg of a random row, so every warp load went to
// 32 different 32-byte sectors: dg0 moved 134 MB (R = 1024) and 537 MB
// (R = 4096) of L2 sectors a launch to read 1.5 and 6 MB. Now:
//   dg0   a block owns a slab of C columns (C = 8: a slab row is one
//         32-byte sector) and copies the slab, all R rows and U = 8 more
//         that repeat rows 0 .. 7, into shared memory in [row][col] layout
//         with cp.async, each block starting at its own share of the rows,
//         while its threads load their first ids; it then sums a share of
//         the slab's elements, ELEMS at a time a thread. A warp's lanes sit
//         on the C columns, M = 32 / C lanes a column; a lane's bank is
//         C * (row mod M) + col, so lanes of one column reading rows of
//         equal residue mod M would meet in one bank. Each lane therefore
//         runs its rounds staggered by p = (id + k) mod M steps (k: its
//         place among its column's lanes): at step s it reads round s - p,
//         row (id - p + s), whose residue (s - k) mod M differs for every
//         k, so every load of a warp is free of conflicts, at the cost of
//         M - 1 steps at either end where some lanes idle. Steps go in
//         trips of U: one mask a trip, then loads at immediate offsets (the
//         repeated rows catch a trip that wraps). The slab path takes R up
//         to 32,768 (C = 8 up to R = 4,096, then 4, 2, 1); a launch is
//         about one block an SM, 16 slabs of 8 columns times 8 parts at R
//         <= 4,096. Above that (R >= 65,536) the launch keeps the parent's
//         per-element L2 kernel;
//   dg1   a block stages 4 rows, each with its first 8 columns repeated,
//         and sums their elements, two a thread, in trips of U rounds at
//         immediate offsets. A warp is 32 columns of one row, so its random
//         columns meet in banks (about three ways); the stagger that keeps
//         them apart costs 31 more steps and lost;
//   tex, roll  the parent's designs (tex: one fetch a thread, bound by L2
//         sectors; four lanes a thread lost 2-4%. roll: its row in shared
//         memory, one 128-thread block per row, 1.3-1.7x its launch floor).
//
// What bounds it: the bytes that must move (the table, the ids and the
// output: 1.5-6 MB for dg0, 2-16 MB for tex) take 0.5-5 us at 3.35 TB/s,
// and the launches' floors (an empty kernel on the same grid) are 1.1-3.2
// us. On an H100 80GB HBM3 at 700 W the slab path spends most of its time
// copying the slab: dg0 takes 0.0039 and 0.0100 ms at 1,024 and 4,096
// rows, and 0.0030 and 0.0076 ms with no round at all. That copy runs at
// about 11 bytes a clock an SM (32-byte pieces of 128-byte lines), and
// neither TMA boxes (the same time) nor a cluster of 4 blocks that copies
// whole lines and scatters their pieces through distributed shared memory
// (1.9-2.2x slower) moved it.
//
// Numerics: the adds run in the tool's order (round 0 first), separately
// rounded, as the plain version does, so both agree bit for bit; the
// stagger changes when a lane adds, not what or in which order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int L = 128;
constexpr int BLOCK = 256;
constexpr int SMEM_DEFAULT = 48 * 1024;  // dynamic shared memory without opting in
constexpr int ELEMS = 2;                 // elements a thread of dg0 / dg1 sums at once
constexpr int U = 8;                     // steps a trip of a staggered sum
constexpr int SLAB_COLS = 8;             // a slab row: one 32-byte sector
constexpr int SLAB_BYTES = 232448;       // the H100's opt-in limit of shared memory a block
constexpr int SLAB_THREADS = 1024;
constexpr int DG1_ROWS = BLOCK * ELEMS / L;  // rows a dg1 block stages
constexpr int DG1_W = L + U;             // a staged dg1 row and its wrapped columns

enum Mode { DG0, DG1, ROLL, ROLL_DYN, TEX, N_MODES };

template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* src) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst), "l"(src), "n"(BYTES)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// ELEMS staggered K-round sums read from shared memory (dg0 and dg1). At
// step s element j adds the word at byte ((start[j] + s) & mask) * STEP +
// fixed[j] when 0 <= s - p[j] < rounds, p[j] in [0, M): its round s - p[j].
// The staged rows are padded by U wrapped rows (dg0: rows R .. R + U - 1
// repeat rows 0 .. U - 1; dg1: columns 128 .. 135 repeat 0 .. 7), so a
// trip of U steps masks once and then reads at immediate offsets. Trips
// inside steps M - 1 .. rounds - 1 hold every lane's rounds and test
// nothing; the others test each step.
template <int M, int STEP>
__device__ __forceinline__ void staggered_sums(const char* smem, const unsigned (&start)[ELEMS],
                                               const unsigned (&fixed)[ELEMS],
                                               const int (&p)[ELEMS], unsigned mask, int rounds,
                                               float (&acc)[ELEMS]) {
  for (int s0 = 0; s0 < rounds + M - 1; s0 += U) {
    const char* at[ELEMS];
#pragma unroll
    for (int j = 0; j < ELEMS; ++j) at[j] = smem + ((start[j] + s0) & mask) * STEP + fixed[j];
    if (s0 >= M - 1 && s0 + U <= rounds) {
#pragma unroll
      for (int i = 0; i < U; ++i) {
#pragma unroll
        for (int j = 0; j < ELEMS; ++j)
          acc[j] = acc[j] + *reinterpret_cast<const float*>(at[j] + i * STEP);
      }
    } else {
#pragma unroll
      for (int i = 0; i < U; ++i) {
#pragma unroll
        for (int j = 0; j < ELEMS; ++j) {
          const float v = *reinterpret_cast<const float*>(at[j] + i * STEP);
          if ((unsigned)(s0 + i - p[j]) < (unsigned)rounds) acc[j] = acc[j] + v;
        }
      }
    }
  }
}

// dg0's slab path: block b sums slab b % (128 / C), element rows
// [part * rows_per_block, ...) with part = b / (128 / C). Dynamic shared
// memory: (rows + U) x C floats, row r holding table row r & (rows - 1),
// copied with cp.async, each block starting at its own share of the rows
// so that the blocks do not all ask for the same lines at once; the first
// group's ids are loaded while the slab lands. tbl 16-byte aligned.
template <int C>
__global__ void __launch_bounds__(SLAB_THREADS)
dg0_slab_kernel(const float* __restrict__ tbl, const int* __restrict__ idx,
                float* __restrict__ out, int rows, int rounds, int rows_per_block) {
  extern __shared__ float4 slab4[];
  float* slab = reinterpret_cast<float*>(slab4);
  constexpr int M = 32 / C, NSLAB = L / C;
  constexpr int CHUNK = C < 4 ? C : 4;  // floats a copy
  const int c0 = (blockIdx.x % NSLAB) * C, part = blockIdx.x / NSLAB;
  const int chunks = (rows + U) * (C / CHUNK);
  const int first = (int)((long long)blockIdx.x * chunks / gridDim.x);
  for (int q = threadIdx.x + first; q < chunks + first; q += blockDim.x) {
    const int qq = q < chunks ? q : q - chunks;
    const int r = (qq / (C / CHUNK)) & (rows - 1);
    cp_async<CHUNK * 4>(slab + qq * CHUNK, tbl + (size_t)r * L + c0 + (qq % (C / CHUNK)) * CHUNK);
  }
  const int warps = blockDim.x / 32, w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col = lane % C, k = lane / C;
  const int r0 = part * rows_per_block;
  const int r1 = min(rows, r0 + rows_per_block);
  int er[ELEMS];
  unsigned id[ELEMS];
  auto load_ids = [&](int g) {  // group g's element rows and ids
#pragma unroll
    for (int j = 0; j < ELEMS; ++j) {
      er[j] = r0 + ((g * ELEMS + j) * warps + w) * M + k;
      id[j] = er[j] < r1 ? (unsigned)idx[er[j] * L + c0 + col] : 0u;
    }
  };
  load_ids(0);  // in flight while the slab lands
  cp_async_wait_all();
  __syncthreads();
  for (int g = 0; (g * ELEMS * warps + w) * M < r1 - r0; ++g) {
    if (g > 0) load_ids(g);
    int p[ELEMS];
    unsigned start[ELEMS], fixed[ELEMS];
    float acc[ELEMS];
#pragma unroll
    for (int j = 0; j < ELEMS; ++j) {
      p[j] = (int)((id[j] + k) & (M - 1));
      start[j] = id[j] - p[j];
      fixed[j] = col * 4;
      acc[j] = 0.0f;
    }
    staggered_sums<M, C * 4>(reinterpret_cast<const char*>(slab), start, fixed, p, rows - 1,
                             rounds, acc);
#pragma unroll
    for (int j = 0; j < ELEMS; ++j)
      if (er[j] < r1) out[er[j] * L + c0 + col] = acc[j];
  }
}

// The L2 path (dg0 where no slab fits; the parent's design): one thread
// per element, each round a 4-byte __ldg of a random row.
__global__ void __launch_bounds__(BLOCK)
dg0_l2_kernel(const float* __restrict__ tbl, const int* __restrict__ idx, float* __restrict__ out,
              int rows, int rounds) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= rows * L) return;
  const int l = e % L;
  const int id = idx[e];
  float acc = 0.0f;
  for (int i = 0; i < rounds; ++i)
    acc = acc + __ldg(tbl + (size_t)((id + i) & (rows - 1)) * L + l);
  out[e] = acc;
}

// dg1: a block of BLOCK threads stages DG1_ROWS rows, each padded by its
// first U columns (a row of DG1_W floats), and sums their elements,
// ELEMS a thread (element t + BLOCK * j of the block), in trips of U
// rounds at immediate offsets. Lanes of a warp share a row, so their
// random columns meet in banks (about three ways); a stagger that keeps
// them apart costs 31 more steps and lost (PERF.md).
__global__ void __launch_bounds__(BLOCK)
dg1_kernel(const float* __restrict__ tbl, const int* __restrict__ idx, float* __restrict__ out,
           int rows, int rounds) {
  __shared__ float stage[DG1_ROWS * DG1_W];
  const int r0 = blockIdx.x * DG1_ROWS;
  const int nrows = min(DG1_ROWS, rows - r0);
  const float* src = tbl + (size_t)r0 * L;
  for (int q = threadIdx.x; q < nrows * DG1_W; q += BLOCK) {
    const int rr = q / DG1_W, cc = q % DG1_W;
    cp_async<4>(stage + q, src + rr * L + (cc & (L - 1)));
  }
  int p[ELEMS] = {};
  unsigned start[ELEMS], fixed[ELEMS];
  float acc[ELEMS];
#pragma unroll
  for (int j = 0; j < ELEMS; ++j) {
    const int e = threadIdx.x + BLOCK * j, rr = e / L;
    start[j] = rr < nrows ? (unsigned)idx[(size_t)r0 * L + e] : 0u;
    fixed[j] = rr * DG1_W * 4;
    acc[j] = 0.0f;
  }
  cp_async_wait_all();
  __syncthreads();
  staggered_sums<1, 4>(reinterpret_cast<const char*>(stage), start, fixed, p, L - 1, rounds, acc);
#pragma unroll
  for (int j = 0; j < ELEMS; ++j) {
    const int e = threadIdx.x + BLOCK * j;
    if (e / L < nrows) out[(size_t)r0 * L + e] = acc[j];
  }
}

template <bool DYNAMIC>
__global__ void __launch_bounds__(L)
roll_kernel(const float* __restrict__ x, float* __restrict__ out, int rounds) {
  __shared__ float row[L];
  const int l = threadIdx.x;
  const size_t base = (size_t)blockIdx.x * L;
  row[l] = x[base + l];
  __syncthreads();
  float acc = 0.0f;
  for (int i = 0; i < rounds; ++i) acc = acc + row[(l - (DYNAMIC ? i : 1)) & (L - 1)];
  out[base + l] = acc;
}

__global__ void __launch_bounds__(BLOCK)
tex_kernel(const int* __restrict__ tbl, const int* __restrict__ q, const int* __restrict__ c,
           int* __restrict__ out, int rows) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= rows * L) return;
  out[e] = __ldg(tbl + (size_t)(q[e] & (rows - 1)) * L + (c[e] & (L - 1)));
}

// one block of L threads; n_rows rows of L floats of dynamic shared memory
__global__ void __launch_bounds__(L)
scratch_kernel(const float* __restrict__ x, float* __restrict__ out, int n_rows) {
  extern __shared__ float scratch[];
  volatile float* s = scratch;  // keep the stores and loads in shared memory
  const int l = threadIdx.x;
  s[l] = x[l];
  s[(size_t)(n_rows - 1) * L + l] = x[l] * 2.0f;
  __syncthreads();
  const int m = (l + 1) & (L - 1);  // read a neighbour's column
  out[m] = s[(size_t)(n_rows - 1) * L + m] + s[m];
}

// The launch floor: a kernel that does nothing, launched with a probe
// launch's grid, block and dynamic shared memory.
__global__ void floor_kernel() {}

// Dynamic shared memory above 48 KB must be opted into per kernel and
// device; each kernel's granted size is kept here, so the attribute is set
// once per size (outside any timed CUDA graph) and a refused request is
// returned, not retried.
constexpr int MAX_DEVICES = 64;

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int (&granted)[MAX_DEVICES], int nbytes) {
  if (nbytes <= SMEM_DEFAULT) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (nbytes <= granted[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, nbytes);
  if (err != cudaSuccess) {
    cudaGetLastError();  // not sticky, but leave nothing for a later check
    return err;
  }
  granted[dev] = nbytes;
  return cudaSuccess;
}

int scratch_granted[MAX_DEVICES], floor_granted[MAX_DEVICES], slab_granted[4][MAX_DEVICES];

struct Config {
  int grid, block, smem, cols, rows_per_block;  // cols 0: dg0's L2 path
};

// Columns of dg0's slab on a table of rows rows: SLAB_COLS or fewer, its
// rows + U rows within SLAB_BYTES; 0 where not one column fits.
int slab_cols(int rows) {
  for (int c = SLAB_COLS; c >= 1; c /= 2)
    if ((long long)(rows + U) * c * 4 <= SLAB_BYTES) return c;
  return 0;
}

cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return err;
}

cudaError_t config(int mode, int rows, Config* c) {
  const int n = rows * L;
  *c = {(n + BLOCK - 1) / BLOCK, BLOCK, 0, 0, 0};
  if (mode == ROLL || mode == ROLL_DYN) {
    *c = {rows, L, 0, 0, 0};
  } else if (mode == DG1) {
    c->grid = (rows + DG1_ROWS - 1) / DG1_ROWS;
  } else if (mode == DG0) {
    int sms = 0;
    const cudaError_t err = sm_count(&sms);
    if (err != cudaSuccess) return err;
    if ((c->cols = slab_cols(rows)) > 0) {
      // about one block an SM: L / cols slabs, each cut into parts
      const int nslab = L / c->cols;
      const int parts = max(1, min(rows, sms / nslab));
      c->rows_per_block = (rows + parts - 1) / parts;
      const int per_thread = ELEMS * (32 / c->cols);  // rows of a warp's group: M per element
      const int warps = (c->rows_per_block + per_thread - 1) / per_thread;
      c->block = min(SLAB_THREADS, 32 * max(1, warps));
      c->grid = nslab * parts;
      c->smem = (rows + U) * c->cols * 4;
    }
  }
  return cudaSuccess;
}

bool valid(int mode, int rows, int rounds) {
  return mode >= 0 && mode < N_MODES && rows >= 0 && (rows & (rows - 1)) == 0 && rounds >= 0 &&
         (long long)rows * L < (1LL << 31);
}

template <int C>
cudaError_t launch_slab(const Config& c, const float* tbl, const int* idx, float* out, int rows,
                        int rounds, cudaStream_t s) {
  constexpr int slot = C == 8 ? 3 : C == 4 ? 2 : C == 2 ? 1 : 0;
  const cudaError_t err = allow_smem(dg0_slab_kernel<C>, slab_granted[slot], c.smem);
  if (err != cudaSuccess) return err;
  dg0_slab_kernel<C><<<c.grid, c.block, c.smem, s>>>(tbl, idx, out, rows, rounds,
                                                       c.rows_per_block);
  return cudaSuccess;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// mode: index into zraytrace_tpu_torch/probes/gather_probe3.py MODES; rows
// a power of two. DG0 / DG1: tbl (rows, 128) f32, idx int32, out f32;
// ROLL / ROLL_DYN: tbl is x (rows, 128) f32, idx unused; TEX: tbl (rows,
// 128) int32, idx = q, idx2 = c, out int32. tbl, idx, idx2 and out must be
// 16-byte aligned (cudaErrorMisalignedAddress otherwise; nothing runs).
extern "C" int zr_probe_gather3_launch(int mode, const void* tbl, const int* idx,
                                       const int* idx2, void* out, int rows, int rounds,
                                       void* stream) {
  if (!valid(mode, rows, rounds)) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  if (!aligned16(tbl) || !aligned16(idx) || !aligned16(idx2) || !aligned16(out))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  Config c;
  cudaError_t err = config(mode, rows, &c);
  if (err != cudaSuccess) return (int)err;
  const float* t = (const float*)tbl;
  switch (mode) {
    case DG0:
      switch (c.cols) {
        case 8: err = launch_slab<8>(c, t, idx, (float*)out, rows, rounds, s); break;
        case 4: err = launch_slab<4>(c, t, idx, (float*)out, rows, rounds, s); break;
        case 2: err = launch_slab<2>(c, t, idx, (float*)out, rows, rounds, s); break;
        case 1: err = launch_slab<1>(c, t, idx, (float*)out, rows, rounds, s); break;
        default: dg0_l2_kernel<<<c.grid, c.block, 0, s>>>(t, idx, (float*)out, rows, rounds);
      }
      if (err != cudaSuccess) return (int)err;
      break;
    case DG1:
      dg1_kernel<<<c.grid, c.block, 0, s>>>(t, idx, (float*)out, rows, rounds);
      break;
    case ROLL:
      roll_kernel<false><<<c.grid, c.block, 0, s>>>(t, (float*)out, rounds);
      break;
    case ROLL_DYN:
      roll_kernel<true><<<c.grid, c.block, 0, s>>>(t, (float*)out, rounds);
      break;
    default:
      tex_kernel<<<c.grid, c.block, 0, s>>>((const int*)tbl, idx, idx2, (int*)out, rows);
  }
  return (int)cudaGetLastError();
}

// The launch floor of a probe launch: floor_kernel with the grid, block
// and shared memory zr_probe_gather3_launch gives (mode, rows), or, for
// mode N_MODES, the scratch probe's one block with nbytes.
extern "C" int zr_probe_gather3_floor(int mode, int rows, int nbytes, void* stream) {
  Config c{1, L, nbytes, 0, 0};
  if (mode != N_MODES) {
    if (!valid(mode, rows, 0)) return (int)cudaErrorInvalidValue;
    if (rows == 0) return 0;
    const cudaError_t err = config(mode, rows, &c);
    if (err != cudaSuccess) return (int)err;
  }
  const cudaError_t err = allow_smem(floor_kernel, floor_granted, c.smem);
  if (err != cudaSuccess) return (int)err;
  floor_kernel<<<c.grid, c.block, c.smem, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

// The scratch probe: x and out (128,) f32, nbytes of dynamic shared memory
// (a multiple of 512, at least two rows). Above 48 KB it opts in with
// cudaFuncSetAttribute, once per size; a refused request launches nothing
// and its error is returned.
extern "C" int zr_probe_scratch_launch(const float* x, float* out, int nbytes, void* stream) {
  if (nbytes < 2 * L * 4 || nbytes % (L * 4) != 0) return (int)cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(scratch_kernel, scratch_granted, nbytes);
  if (err != cudaSuccess) return (int)err;
  scratch_kernel<<<1, L, nbytes, (cudaStream_t)stream>>>(x, out, nbytes / (L * 4));
  return (int)cudaGetLastError();
}

// The current device's opt-in limit of shared memory per block, in bytes;
// a negative CUDA error code on failure.
extern "C" int zr_probe_smem_optin(void) {
  int dev = 0, bytes = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return err == cudaSuccess ? bytes : -(int)err;
}

extern "C" const char* zr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
