// CUDA graphs with conditional (IF) nodes, assembled by hand.
//
// Replaces no TPU kernel: the JAX package's solve loops are while_loops and
// lax.conds that XLA runs on the device. On the card the port enqueues the
// same loops as CUDA graphs whose bodies run or not by a flag in device
// memory (gmres_qr.cu sets the flags), so the host never waits inside an
// implicit step. The installed PyTorch need not expose conditional nodes:
// the device work is captured by PyTorch as plain graphs (each in the
// runner's private memory pool, so every temporary stays in that pool),
// and this file joins them: each captured piece's nodes copied one by one
// into the level under construction (its edges kept, its roots after the
// node before it), and per IF a one-thread kernel node that copies the
// flag into the node's handle (cudaGraphSetConditional) followed by the
// conditional node whose body holds the gated pieces; a SWITCH node the
// same way with one body per value. Conditional nodes need CUDA 12.4 or
// later, SWITCH nodes 12.8. The pieces are copied rather than embedded as
// child-graph nodes: the card's profiler (CUPTI) records the kernels of a
// child graph inside a conditional body at most once a launch, however
// often the body runs.
//
// Every entry point returns a cudaError_t or a CUresult (0 on success);
// handles travel as void*. The node copies go through the driver API (the
// pieces' kernels are PyTorch's and this library's, each registered with
// its own runtime), reached by cudaGetDriverEntryPoint.

#include <cuda.h>

#include <unordered_map>
#include <vector>

#include "common.cuh"

#if !defined(CUDART_VERSION) || CUDART_VERSION < 12040
#error "conditional graph nodes need CUDA 12.4 or later"
#endif

namespace {

// one thread: copy the flag (or value) into the conditional node's handle
__global__ void set_if_kernel(cudaGraphConditionalHandle handle,
                              const bool* flag) {
  cudaGraphSetConditional(handle, *flag ? 1u : 0u);
}

__global__ void set_switch_kernel(cudaGraphConditionalHandle handle,
                                  const double* value) {
  cudaGraphSetConditional(handle, static_cast<unsigned int>(*value));
}

// after ``dep``: a one-thread kernel node ``set`` (a kernel reading the
// handle's value from device memory), then a conditional node of ``type``
// with ``size`` bodies
int add_conditional(cudaGraph_t g, void* dep, void* set_fn, void* value,
                    cudaGraphConditionalNodeType type, int size,
                    void** node, void** bodies,
                    unsigned long long* handle_out = nullptr) {
  cudaGraphConditionalHandle handle;
  cudaError_t err = cudaGraphConditionalHandleCreate(&handle, g, 0, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaKernelNodeParams kp = {};
  void* args[] = {&handle, &value};
  kp.func = set_fn;
  kp.gridDim = dim3(1);
  kp.blockDim = dim3(1);
  kp.sharedMemBytes = 0;
  kp.kernelParams = args;
  cudaGraphNode_t set = nullptr;
  const cudaGraphNode_t d = static_cast<cudaGraphNode_t>(dep);
  err = cudaGraphAddKernelNode(&set, g, dep ? &d : nullptr, dep ? 1 : 0, &kp);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphNodeParams cp = {};
  cp.type = cudaGraphNodeTypeConditional;
  cp.conditional.handle = handle;
  cp.conditional.type = type;
  cp.conditional.size = size;
  cudaGraphNode_t cn = nullptr;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&cn, g, &set, nullptr, 1, &cp);
#else
  err = cudaGraphAddNode(&cn, g, &set, 1, &cp);
#endif
  if (err != cudaSuccess) return static_cast<int>(err);
  *node = cn;
  for (int i = 0; i < size; ++i) bodies[i] = cp.conditional.phGraph_out[i];
  if (handle_out) *handle_out = handle;
  return 0;
}

// the driver entry points the node copies use (their CUDA 12.0 forms)
struct Driver {
  CUresult (*ctx_get)(CUcontext*);
  CUresult (*get_nodes)(CUgraph, CUgraphNode*, size_t*);
  CUresult (*get_edges)(CUgraph, CUgraphNode*, CUgraphNode*, size_t*);
  CUresult (*node_type)(CUgraphNode, CUgraphNodeType*);
  CUresult (*kernel_get)(CUgraphNode, CUDA_KERNEL_NODE_PARAMS_v2*);
  CUresult (*kernel_add)(CUgraphNode*, CUgraph, const CUgraphNode*, size_t,
                         const CUDA_KERNEL_NODE_PARAMS_v2*);
  CUresult (*kernel_attrs)(CUgraphNode, CUgraphNode);
  CUresult (*memcpy_get)(CUgraphNode, CUDA_MEMCPY3D*);
  CUresult (*memcpy_add)(CUgraphNode*, CUgraph, const CUgraphNode*, size_t,
                         const CUDA_MEMCPY3D*, CUcontext);
  CUresult (*memset_get)(CUgraphNode, CUDA_MEMSET_NODE_PARAMS*);
  CUresult (*memset_add)(CUgraphNode*, CUgraph, const CUgraphNode*, size_t,
                         const CUDA_MEMSET_NODE_PARAMS*, CUcontext);
  CUresult (*empty_add)(CUgraphNode*, CUgraph, const CUgraphNode*, size_t);
};

int entry(const char* name, void** fn) {
  cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
  const cudaError_t err = cudaGetDriverEntryPointByVersion(
      name, fn, 12000, cudaEnableDefault, &q);
#else
  const cudaError_t err =
      cudaGetDriverEntryPoint(name, fn, cudaEnableDefault, &q);
#endif
  if (err != cudaSuccess) return static_cast<int>(err);
  return q == cudaDriverEntryPointSuccess
             ? 0
             : static_cast<int>(cudaErrorSymbolNotFound);
}

int driver(const Driver** out) {
  static Driver d;
  static int rc = -1;
  if (rc < 0) {
    void** slots[] = {reinterpret_cast<void**>(&d.ctx_get),
                      reinterpret_cast<void**>(&d.get_nodes),
                      reinterpret_cast<void**>(&d.get_edges),
                      reinterpret_cast<void**>(&d.node_type),
                      reinterpret_cast<void**>(&d.kernel_get),
                      reinterpret_cast<void**>(&d.kernel_add),
                      reinterpret_cast<void**>(&d.kernel_attrs),
                      reinterpret_cast<void**>(&d.memcpy_get),
                      reinterpret_cast<void**>(&d.memcpy_add),
                      reinterpret_cast<void**>(&d.memset_get),
                      reinterpret_cast<void**>(&d.memset_add),
                      reinterpret_cast<void**>(&d.empty_add)};
    const char* names[] = {
        "cuCtxGetCurrent",           "cuGraphGetNodes",
        "cuGraphGetEdges",           "cuGraphNodeGetType",
        "cuGraphKernelNodeGetParams", "cuGraphAddKernelNode",
        "cuGraphKernelNodeCopyAttributes", "cuGraphMemcpyNodeGetParams",
        "cuGraphAddMemcpyNode",      "cuGraphMemsetNodeGetParams",
        "cuGraphAddMemsetNode",      "cuGraphAddEmptyNode"};
    rc = 0;
    for (size_t i = 0; i < sizeof(names) / sizeof(names[0]) && rc == 0; ++i)
      rc = entry(names[i], slots[i]);
  }
  *out = &d;
  return rc;
}

// the nodes of ``src`` (a PyTorch capture: kernels, copies, fills) copied
// into ``dst`` in an order their edges allow, its roots after ``dep``
// (null: none); ``*last`` the one node every copy precedes: the sink, an
// empty node joining several, or ``dep`` when ``src`` is empty
int copy_graph(const Driver& D, CUgraph dst, CUgraphNode dep, CUgraph src,
               CUcontext ctx, CUgraphNode* last) {
  size_t n = 0, ne = 0;
  CUresult r = D.get_nodes(src, nullptr, &n);
  if (r == CUDA_SUCCESS) r = D.get_edges(src, nullptr, nullptr, &ne);
  if (r != CUDA_SUCCESS) return static_cast<int>(r);
  std::vector<CUgraphNode> nodes(n), from(ne), to(ne);
  if (n) r = D.get_nodes(src, nodes.data(), &n);
  if (r == CUDA_SUCCESS && ne)
    r = D.get_edges(src, from.data(), to.data(), &ne);
  if (r != CUDA_SUCCESS) return static_cast<int>(r);
  std::unordered_map<CUgraphNode, size_t> at;
  for (size_t i = 0; i < n; ++i) at[nodes[i]] = i;
  std::vector<std::vector<size_t>> preds(n), succs(n);
  for (size_t e = 0; e < ne; ++e) {
    preds[at[to[e]]].push_back(at[from[e]]);
    succs[at[from[e]]].push_back(at[to[e]]);
  }
  std::vector<size_t> order, waiting(n);
  for (size_t i = 0; i < n; ++i) {
    waiting[i] = preds[i].size();
    if (!waiting[i]) order.push_back(i);
  }
  for (size_t k = 0; k < order.size(); ++k)
    for (size_t s : succs[order[k]])
      if (--waiting[s] == 0) order.push_back(s);
  if (order.size() != n) return static_cast<int>(cudaErrorInvalidValue);
  std::vector<CUgraphNode> made(n, nullptr), sinks;
  for (size_t i : order) {
    std::vector<CUgraphNode> d;
    for (size_t p : preds[i]) d.push_back(made[p]);
    if (d.empty() && dep) d.push_back(dep);
    const CUgraphNode* dp = d.empty() ? nullptr : d.data();
    CUgraphNodeType type;
    r = D.node_type(nodes[i], &type);
    if (r != CUDA_SUCCESS) return static_cast<int>(r);
    switch (type) {
      case CU_GRAPH_NODE_TYPE_KERNEL: {
        CUDA_KERNEL_NODE_PARAMS_v2 p = {};
        r = D.kernel_get(nodes[i], &p);
        if (r == CUDA_SUCCESS)
          r = D.kernel_add(&made[i], dst, dp, d.size(), &p);
        if (r == CUDA_SUCCESS) r = D.kernel_attrs(made[i], nodes[i]);
        break;
      }
      case CU_GRAPH_NODE_TYPE_MEMCPY: {
        CUDA_MEMCPY3D p = {};
        r = D.memcpy_get(nodes[i], &p);
        if (r == CUDA_SUCCESS)
          r = D.memcpy_add(&made[i], dst, dp, d.size(), &p, ctx);
        break;
      }
      case CU_GRAPH_NODE_TYPE_MEMSET: {
        CUDA_MEMSET_NODE_PARAMS p = {};
        r = D.memset_get(nodes[i], &p);
        if (r == CUDA_SUCCESS)
          r = D.memset_add(&made[i], dst, dp, d.size(), &p, ctx);
        break;
      }
      case CU_GRAPH_NODE_TYPE_EMPTY:
        r = D.empty_add(&made[i], dst, dp, d.size());
        break;
      default:   // child graphs, events, host work: no capture holds them
        return static_cast<int>(cudaErrorNotSupported);
    }
    if (r != CUDA_SUCCESS) return static_cast<int>(r);
    if (succs[i].empty()) sinks.push_back(made[i]);
  }
  if (sinks.size() > 1)
    return static_cast<int>(D.empty_add(last, dst, sinks.data(),
                                        sinks.size()));
  *last = sinks.empty() ? dep : sinks[0];
  return 0;
}

}  // namespace

PD_EXPORT int pd_cg_runtime_version() { return CUDART_VERSION; }

PD_EXPORT int pd_cg_create(void** graph) {
  cudaGraph_t g = nullptr;
  const cudaError_t err = cudaGraphCreate(&g, 0);
  *graph = g;
  return static_cast<int>(err);
}

// a copy of ``child``'s nodes after ``dep`` (null: none) on ``device``;
// ``*node`` the node every copy precedes
PD_EXPORT int pd_cg_add_copy(void* graph, void* dep, void* child, int device,
                             void** node) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Driver* D = nullptr;
  int rc = driver(&D);
  if (rc) return rc;
  CUcontext ctx = nullptr;
  const CUresult r = D->ctx_get(&ctx);
  if (r != CUDA_SUCCESS) return static_cast<int>(r);
  CUgraphNode last = nullptr;
  rc = copy_graph(*D, static_cast<CUgraph>(graph),
                  static_cast<CUgraphNode>(dep), static_cast<CUgraph>(child),
                  ctx, &last);
  *node = last;
  return rc;
}

// after ``dep``: a kernel node that reads *flag into a new handle, then an
// IF node on it; returns the IF node and its (empty) body graph
PD_EXPORT int pd_cg_add_if(void* graph, void* dep, const bool* flag,
                           void** node, void** body) {
  return add_conditional(static_cast<cudaGraph_t>(graph), dep,
                         reinterpret_cast<void*>(set_if_kernel),
                         const_cast<bool*>(flag), cudaGraphCondTypeIf, 1,
                         node, body);
}

// after ``dep``: a kernel node that reads *flag into a new handle, then a
// WHILE node on it (its body runs while the handle is non-zero, evaluated
// at the node and after each run of the body); returns the node, its body
// and the handle, which the body's last node must set again
// (``pd_cg_add_set``)
PD_EXPORT int pd_cg_add_while(void* graph, void* dep, const bool* flag,
                              void** node, void** body,
                              unsigned long long* handle) {
  return add_conditional(static_cast<cudaGraph_t>(graph), dep,
                         reinterpret_cast<void*>(set_if_kernel),
                         const_cast<bool*>(flag), cudaGraphCondTypeWhile, 1,
                         node, body, handle);
}

// after ``dep``: a kernel node that copies *flag into ``handle``
PD_EXPORT int pd_cg_add_set(void* graph, void* dep, unsigned long long handle,
                            const bool* flag, void** node) {
  cudaGraphConditionalHandle h = handle;
  cudaKernelNodeParams kp = {};
  void* args[] = {&h, &flag};
  kp.func = reinterpret_cast<void*>(set_if_kernel);
  kp.gridDim = dim3(1);
  kp.blockDim = dim3(1);
  kp.sharedMemBytes = 0;
  kp.kernelParams = args;
  cudaGraphNode_t n = nullptr;
  const cudaGraphNode_t d = static_cast<cudaGraphNode_t>(dep);
  const cudaError_t err = cudaGraphAddKernelNode(
      &n, static_cast<cudaGraph_t>(graph), dep ? &d : nullptr, dep ? 1 : 0,
      &kp);
  *node = n;
  return static_cast<int>(err);
}

// after ``dep``: a kernel node that reads *value (a whole number held as a
// double) into a new handle, then a SWITCH node of ``n`` bodies on it
// (body i runs when the value is i; none at n or above); CUDA 12.8 or
// later
PD_EXPORT int pd_cg_add_switch(void* graph, void* dep, const double* value,
                               int n, void** node, void** bodies) {
#if CUDART_VERSION >= 12080
  return add_conditional(static_cast<cudaGraph_t>(graph), dep,
                         reinterpret_cast<void*>(set_switch_kernel),
                         const_cast<double*>(value), cudaGraphCondTypeSwitch,
                         n, node, bodies);
#else
  return static_cast<int>(cudaErrorNotSupported);
#endif
}

PD_EXPORT int pd_cg_instantiate(void* graph, void** exec, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphExec_t e = nullptr;
  err = cudaGraphInstantiate(&e, static_cast<cudaGraph_t>(graph), 0);
  *exec = e;
  return static_cast<int>(err);
}

PD_EXPORT int pd_cg_launch(void* exec, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                        static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

PD_EXPORT int pd_cg_destroy(void* graph, void* exec) {
  cudaError_t err = cudaSuccess;
  if (exec) err = cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
  if (graph) {
    const cudaError_t e2 = cudaGraphDestroy(static_cast<cudaGraph_t>(graph));
    if (err == cudaSuccess) err = e2;
  }
  return static_cast<int>(err);
}
