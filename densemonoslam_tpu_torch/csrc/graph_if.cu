// Conditional IF nodes inside a CUDA stream capture: the device-side
// `lax.cond` of the port's captured programs (`utils/graphs.py:branch`).
//
// PyTorch's CUDAGraph binds these only in later releases; this plain C
// interface does the same with the runtime API (CUDA 12.4 or later).
// `graph_if_begin` is called while `stream` captures: it creates a
// conditional handle in the graph being captured, captures a one-thread
// kernel that sets the handle from a device bool, adds an IF node after it
// and makes the stream's capture continue after the node, then starts
// `body_stream` capturing into the node's body graph.  `graph_if_end` ends
// the body's capture.  The body runs, at each launch of the graph, only
// where the bool held when the setter ran.

#include <cuda_runtime.h>

__global__ void set_condition(cudaGraphConditionalHandle handle, const bool* pred) {
    cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

extern "C" {

// Returns a cudaError_t; -1 when `stream` is not capturing.
int graph_if_begin(void* stream, const void* pred, void* body_stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaStreamCaptureStatus status;
    cudaGraph_t graph;
    const cudaGraphNode_t* deps = nullptr;
    size_t n_deps = 0;
    cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n_deps);
    if (err != cudaSuccess) return err;
    if (status != cudaStreamCaptureStatusActive) return -1;
    cudaGraphConditionalHandle handle;
    err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
    if (err != cudaSuccess) return err;
    set_condition<<<1, 1, 0, s>>>(handle, static_cast<const bool*>(pred));
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    // the node goes after the setter: the stream's dependencies now
    err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n_deps);
    if (err != cudaSuccess) return err;
    cudaGraphNodeParams params = {};
    params.type = cudaGraphNodeTypeConditional;
    params.conditional.handle = handle;
    params.conditional.type = cudaGraphCondTypeIf;
    params.conditional.size = 1;
    cudaGraphNode_t node;
    err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
    if (err != cudaSuccess) return err;
    err = cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies);
    if (err != cudaSuccess) return err;
    return cudaStreamBeginCaptureToGraph(static_cast<cudaStream_t>(body_stream),
                                         params.conditional.phGraph_out[0], nullptr, nullptr,
                                         0, cudaStreamCaptureModeRelaxed);
}

int graph_if_end(void* body_stream) {
    cudaGraph_t body;
    return cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream), &body);
}

}  // extern "C"
