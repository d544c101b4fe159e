// The fused session's on-device block switch, for sm_90a.
//
// graph_switch_kernel replaces no Pallas kernel: it is the counterpart of
// the `jax.lax.switch(blocks_now[0], branches, ...)` of the JAX fused
// session (real_time_self_adaptive_deep_stereo_tpu/adapt/fused.py:495-509),
// which XLA compiles into a conditional inside the one device program of
// a frame. The port captures one CUDA graph per branch, the step that
// trains one sorted set of `m` sampled blocks out of `n` (C(n, m) graphs).
// This source builds a parent graph over them in which the device picks
// the branch, so a frame under the ARGMAX, RANDOM and PROBABILITY samplers
// is one launch and the host reads nothing:
//
//   [switch kernel] -> [SWITCH node: body k = branch k's graph]    (slot 0)
//   [switch kernel] -> [SWITCH node ...]                           (slot 1)
//   ...
//
// A slot is one stream of the session; the slots run in order. The kernel
// of a slot reads the stream's `m` sampled ids (int32, on the device),
// forms the bitmask of the ids (OR of 1 << id), looks the mask up in a
// table of 2**n int32 entries (the branch index of every mask of m bits,
// -1 elsewhere) and sets the slot's conditional value to that index.
// It also counts the branches it took, per slot, so that the host can
// turn them into kernel launches when it next syncs. A mask with no
// branch (an id outside [0, n), a repeated id) must not pass unseen: a
// SWITCH whose value is at or past its size runs no body, so the kernel
// sets that value, runs nothing and adds one to an error counter, on
// which the session raises at its next sync.
//
// What bounds it: the kernel reads m ids and one table entry and writes
// one count (16-20 bytes at one or two ids) with one thread: a launch and
// a dependent load or two, a few microseconds of latency and no bandwidth. A body runs
// as the device's own launch of its graph; on the H100 a switched MAD
// step takes a few hundredths of a millisecond more than a direct replay
// of the same graph (chip_smoke.py phase 6; PERF.md).
//
// The bodies are the cudaGraph_t of graphs PyTorch captured
// (`torch.cuda.CUDAGraph(keep_graph=True).raw_cuda_graph()`), added as
// child graph nodes, which copy them: the parent lives on after the
// CUDAGraph objects are no longer used to replay, but the memory their
// kernels address stays theirs, so the caller keeps them alive.
// cudaGraphSetConditional is a device-runtime builtin and needs no
// relocatable device code. The SWITCH node came with CUDA 12.8: an older
// toolkit fails the build.

#include <cuda_runtime.h>

#include <cstring>

#if CUDART_VERSION < 12080
#error "graph_switch.cu needs CUDA 12.8 or later (cudaGraphCondTypeSwitch)"
#endif

namespace {

// One thread: the slot's sampled ids to the branch index, by the table.
__global__ void graph_switch_kernel(cudaGraphConditionalHandle handle,
                                    const int* __restrict__ blocks, int m,
                                    int n, const int* __restrict__ table,
                                    int n_branches, int* __restrict__ counts,
                                    int* __restrict__ error) {
  unsigned int mask = 0;
  bool valid = true;
  for (int j = 0; j < m; ++j) {
    const int b = blocks[j];
    if (b < 0 || b >= n)
      valid = false;
    else
      mask |= 1u << b;
  }
  const int k = valid ? table[mask] : -1;
  const bool taken = k >= 0 && k < n_branches;
  if (taken)
    counts[k] += 1;  // the slot's kernel is the only writer of its counts
  else
    atomicAdd(error, 1);
  cudaGraphSetConditional(handle,
                          static_cast<unsigned>(taken ? k : n_branches));
}

struct SwitchGraph {
  cudaGraph_t graph = nullptr;
  cudaGraphExec_t exec = nullptr;
};

void destroy(SwitchGraph* sg) {
  if (sg->exec) cudaGraphExecDestroy(sg->exec);
  if (sg->graph) cudaGraphDestroy(sg->graph);
  delete sg;
}

// The SWITCH node of `size` bodies after `dep`; body k holds bodies[k] as
// a child graph.
cudaError_t add_switch(cudaGraph_t graph, cudaGraphNode_t dep,
                       cudaGraphConditionalHandle handle, int size,
                       void* const* bodies, cudaGraphNode_t* node) {
  // aggregate-initialised: the union's members delete the default constructor
  cudaGraphNodeParams p = {cudaGraphNodeTypeConditional};
  p.conditional.handle = handle;
  p.conditional.type = cudaGraphCondTypeSwitch;
  p.conditional.size = static_cast<unsigned>(size);
#if CUDART_VERSION >= 13000
  cudaError_t e = cudaGraphAddNode(node, graph, &dep, nullptr, 1, &p);
#else
  cudaError_t e = cudaGraphAddNode(node, graph, &dep, 1, &p);
#endif
  if (e != cudaSuccess) return e;
  for (int k = 0; k < size; ++k) {
    cudaGraphNode_t child;
    e = cudaGraphAddChildGraphNode(&child, p.conditional.phGraph_out[k],
                                   nullptr, 0,
                                   static_cast<cudaGraph_t>(bodies[k]));
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

cudaError_t build(SwitchGraph* sg, void* const* bodies, int n_slots,
                  int n_branches, void* const* blocks, int m, int n,
                  const int* table, int* counts, int* error, int* info) {
  cudaError_t e = cudaGraphCreate(&sg->graph, 0);
  if (e != cudaSuccess) return e;
  cudaGraphNode_t prev = nullptr;
  for (int s = 0; s < n_slots; ++s) {
    // reset at every launch to "no body": only the kernel opens one
    cudaGraphConditionalHandle handle;
    e = cudaGraphConditionalHandleCreate(&handle, sg->graph,
                                         static_cast<unsigned>(n_branches),
                                         cudaGraphCondAssignDefault);
    if (e != cudaSuccess) return e;
    const int* slot_blocks = static_cast<const int*>(blocks[s]);
    int* slot_counts = counts + static_cast<size_t>(s) * n_branches;
    void* args[] = {&handle, &slot_blocks, &m, &n,
                    &table, &n_branches, &slot_counts, &error};
    cudaKernelNodeParams kp;
    std::memset(&kp, 0, sizeof kp);
    kp.func = reinterpret_cast<void*>(graph_switch_kernel);
    kp.gridDim = dim3(1);
    kp.blockDim = dim3(1);
    kp.kernelParams = args;
    cudaGraphNode_t kernel;
    e = cudaGraphAddKernelNode(&kernel, sg->graph, prev ? &prev : nullptr,
                               prev ? 1 : 0, &kp);
    if (e != cudaSuccess) return e;
    e = add_switch(sg->graph, kernel, handle, n_branches,
                   bodies + static_cast<size_t>(s) * n_branches, &prev);
    if (e != cudaSuccess) return e;
  }
  cudaGraphInstantiateParams ip;
  std::memset(&ip, 0, sizeof ip);
  e = cudaGraphInstantiateWithParams(&sg->exec, sg->graph, &ip);
  if (e != cudaSuccess) {
    // what the instantiation refused, and the type of the node it names
    info[0] = static_cast<int>(ip.result_out);
    cudaGraphNodeType type;
    if (ip.errNode_out && cudaGraphNodeGetType(ip.errNode_out, &type) == cudaSuccess)
      info[1] = static_cast<int>(type);
    sg->exec = nullptr;
  }
  return e;
}

}  // namespace

extern "C" {

// Builds and instantiates the parent graph. bodies: n_slots * n_branches
// cudaGraph_t, slot-major; blocks: n_slots device pointers to int32 [m]
// ids; table: device int32 [2**n]; counts: device int32 [n_slots *
// n_branches]; error: device int32 [1]. The device buffers must outlive
// the parent. On success *out holds it; on a refused instantiation
// info[0] is the cudaGraphInstantiateResult and info[1] the type of the
// node it names (-1: none). Returns a cudaError_t (0 on success).
int graph_switch_build(void* const* bodies, int n_slots, int n_branches,
                       void* const* blocks, int m, int n, const int* table,
                       int* counts, int* error, void** out, int* info) {
  info[0] = info[1] = -1;
  if (n_slots < 1 || n_branches < 1 || m < 1 || n < m || n > 16)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* sg = new SwitchGraph;
  const cudaError_t e = build(sg, bodies, n_slots, n_branches, blocks, m, n,
                              table, counts, error, info);
  if (e != cudaSuccess) {
    destroy(sg);
    return static_cast<int>(e);
  }
  *out = sg;
  return 0;
}

// One launch of the parent on `stream`: every slot's kernel, then its
// branch.
int graph_switch(void* handle, cudaStream_t stream) {
  return static_cast<int>(
      cudaGraphLaunch(static_cast<SwitchGraph*>(handle)->exec, stream));
}

int graph_switch_destroy(void* handle) {
  destroy(static_cast<SwitchGraph*>(handle));
  return 0;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
