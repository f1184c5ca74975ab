// Conditional (IF) nodes in CUDA graphs captured by PyTorch: the card side
// of `mpc/graph.py::device_cond`, JAX's `lax.cond` inside a captured step.
//
// bp_graph_add_if(stream, pred, body) appends to the graph that `stream`
// is capturing: a one-thread kernel that copies the bool at `pred` into a
// conditional handle, then an IF node whose body is a copy of the graph
// `body` (captured apart, with its own memory pool), and makes that node
// the stream's only dependency. A replay runs the body only where `*pred`
// is true when the node is reached; the host reads nothing.
//
// Returns a cudaError_t (cudaErrorIllegalState when `stream` is not
// capturing).

#include <cuda_runtime.h>

__global__ void bp_set_condition(cudaGraphConditionalHandle handle, const unsigned char* pred) {
    cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

extern "C" int bp_graph_add_if(void* stream_ptr, const void* pred, void* body) {
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    cudaStreamCaptureStatus status;
    cudaGraph_t graph;
    const cudaGraphNode_t* deps;
    size_t n_deps;
    cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, &graph, &deps, &n_deps);
    if (err != cudaSuccess) return err;
    if (status != cudaStreamCaptureStatusActive) return cudaErrorIllegalState;

    cudaGraphConditionalHandle handle;
    err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
    if (err != cudaSuccess) return err;
    bp_set_condition<<<1, 1, 0, stream>>>(handle, static_cast<const unsigned char*>(pred));
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;

    // the dependencies now end at the kernel just captured
    err = cudaStreamGetCaptureInfo(stream, &status, nullptr, &graph, &deps, &n_deps);
    if (err != cudaSuccess) return err;
    cudaGraphNodeParams params = {};
    params.type = cudaGraphNodeTypeConditional;
    params.conditional.handle = handle;
    params.conditional.type = cudaGraphCondTypeIf;
    params.conditional.size = 1;
    cudaGraphNode_t node;
    err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
    if (err != cudaSuccess) return err;
    cudaGraphNode_t child;
    err = cudaGraphAddChildGraphNode(&child, params.conditional.phGraph_out[0], nullptr, 0,
                                     static_cast<cudaGraph_t>(body));
    if (err != cudaSuccess) return err;
    return cudaStreamUpdateCaptureDependencies(stream, &node, 1,
                                               cudaStreamSetCaptureDependencies);
}

// Phase marks (`telemetry.mark`, `telemetry.device_phase`): one empty
// one-thread kernel per phase of the tick, named after its phase. A mark
// launched on a capturing stream becomes a node of the graph, so every
// replay carries the phase boundaries on the card's clock, in the
// profiler's device events by name. bp_phase_mark(stream, id) launches
// the mark of phase `id` (the order of `telemetry.PHASES`) on `stream`;
// returns a cudaError_t.

extern "C" __global__ void bp_phase_tick() {}
extern "C" __global__ void bp_phase_link() {}
extern "C" __global__ void bp_phase_ocp() {}
extern "C" __global__ void bp_phase_qp() {}
extern "C" __global__ void bp_phase_line_search() {}
extern "C" __global__ void bp_phase_rest() {}

extern "C" int bp_phase_mark(void* stream_ptr, int id) {
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    switch (id) {
        case 0: bp_phase_tick<<<1, 1, 0, stream>>>(); break;
        case 1: bp_phase_link<<<1, 1, 0, stream>>>(); break;
        case 2: bp_phase_ocp<<<1, 1, 0, stream>>>(); break;
        case 3: bp_phase_qp<<<1, 1, 0, stream>>>(); break;
        case 4: bp_phase_line_search<<<1, 1, 0, stream>>>(); break;
        case 5: bp_phase_rest<<<1, 1, 0, stream>>>(); break;
        default: return cudaErrorInvalidValue;
    }
    return cudaGetLastError();
}
