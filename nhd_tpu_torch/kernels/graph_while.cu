// graph_while: the CUDA runtime calls that put a WHILE node into a stream
// capture, for the megaround's graph (solver/speculate.py).
//
// Not a kernel: nothing here runs on the card. PyTorch exposes only an IF
// node whose predicate its own kernel sets (CUDAGraph.begin_capture_to_if_node);
// the megaround needs the reference's lax.while_loop
// (nhd_tpu/solver/speculate.py:533-535) as one node whose condition a kernel
// of the graph sets: spec_gate.cu, through cudaGraphSetConditional. A WHILE
// node runs its body graph on the card while its condition is not 0, tested
// before every pass, so no pass runs after the loop's exit.
//
// The capture goes as the megaround's capture calls it, on the stream
// PyTorch's CUDAGraph captures (`capture`), with a second stream for the
// body (`body`):
//   nhd_graph_while_handle  a conditional handle on the capture's graph
//                           (cudaStreamGetCaptureInfo,
//                           cudaGraphConditionalHandleCreate; 0 at each
//                           launch of the graph until a kernel sets it);
//   ...                     the kernels before the node, spec_gate among
//                           them with the handle, so the first pass runs
//                           only where the loop is alive;
//   nhd_graph_while_open    a cudaGraphCondTypeWhile node after everything
//                           captured so far (cudaGraphAddNode), the capture
//                           continuing after it
//                           (cudaStreamUpdateCaptureDependencies), and the
//                           body stream capturing into the node's body graph
//                           (cudaStreamBeginCaptureToGraph);
//   ...                     one pass of the loop on the body stream, ending
//                           with spec_gate, which sets the handle for the
//                           next pass;
//   nhd_graph_while_close   the body's capture ended (cudaStreamEndCapture).
// Every call returns a cudaError_t code (0 on success); the wrapper raises
// KernelLaunchError on any other. The body stream's capture has no pool in
// PyTorch's caching allocator, so nothing captured on it may allocate.
//
// Needs the CUDA 12.3 runtime and driver at least (conditional nodes and
// capture into a given graph came in 12.3). CUDA 13 gave the
// capture-info, add-node and update-dependency calls an edge-data argument;
// both forms are written below.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

cudaError_t capture_graph(cudaStream_t stream, cudaGraph_t* graph,
                          const cudaGraphNode_t** deps, size_t* n_deps)
{
    cudaStreamCaptureStatus status;
#if CUDART_VERSION >= 13000
    cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, graph,
                                               deps, nullptr, n_deps);
#else
    cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, graph,
                                               deps, n_deps);
#endif
    if (err != cudaSuccess) return err;
    return status == cudaStreamCaptureStatusActive ? cudaSuccess
                                                   : cudaErrorStreamCaptureUnmatched;
}

}  // namespace

extern "C" int nhd_graph_while_handle(void* capture, unsigned long long* handle,
                                      int device)
{
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaGraph_t graph;
    const cudaGraphNode_t* deps = nullptr;
    size_t n_deps = 0;
    err = capture_graph((cudaStream_t)capture, &graph, &deps, &n_deps);
    if (err != cudaSuccess) return (int)err;
    cudaGraphConditionalHandle h;
    err = cudaGraphConditionalHandleCreate(&h, graph, 0, cudaGraphCondAssignDefault);
    if (err != cudaSuccess) return (int)err;
    *handle = (unsigned long long)h;
    return 0;
}

extern "C" int nhd_graph_while_open(void* capture, unsigned long long handle,
                                    void* body, int device)
{
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaGraph_t graph;
    const cudaGraphNode_t* deps = nullptr;
    size_t n_deps = 0;
    err = capture_graph((cudaStream_t)capture, &graph, &deps, &n_deps);
    if (err != cudaSuccess) return (int)err;
    cudaGraphNodeParams params = {};
    params.type = cudaGraphNodeTypeConditional;
    params.conditional.handle = (cudaGraphConditionalHandle)handle;
    params.conditional.type = cudaGraphCondTypeWhile;
    params.conditional.size = 1;
    cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
    err = cudaGraphAddNode(&node, graph, deps, nullptr, n_deps, &params);
    if (err != cudaSuccess) return (int)err;
    err = cudaStreamUpdateCaptureDependencies((cudaStream_t)capture, &node, nullptr,
                                              1, cudaStreamSetCaptureDependencies);
#else
    err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
    if (err != cudaSuccess) return (int)err;
    err = cudaStreamUpdateCaptureDependencies((cudaStream_t)capture, &node, 1,
                                              cudaStreamSetCaptureDependencies);
#endif
    if (err != cudaSuccess) return (int)err;
    return (int)cudaStreamBeginCaptureToGraph(
        (cudaStream_t)body, params.conditional.phGraph_out[0], nullptr, nullptr,
        0, cudaStreamCaptureModeThreadLocal);
}

extern "C" int nhd_graph_while_close(void* body, int device)
{
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaGraph_t graph;
    return (int)cudaStreamEndCapture((cudaStream_t)body, &graph);
}

extern "C" const char* nhd_graph_while_error(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
