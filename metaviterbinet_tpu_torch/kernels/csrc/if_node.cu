// CUDA graph IF nodes for online/graphs.py::when, the counterpart of the JAX
// engine's lax.cond inside its scan (metaviterbinet_tpu/online/engine.py:
// the gate's buffer append, meta slot and self-supervised loop). It is no
// port of a TPU kernel: on the TPU the condition is a branch of the one
// compiled program; here it is a node of the captured graph whose body the
// device runs or skips by a flag it reads at each replay, so the host never
// reads the flag. The port makes the node itself, as PyTorch does: a kernel
// that sets the node's condition from the flag, the conditional node after
// it, and a second stream that captures into the node's body graph.
// (PyTorch 2.11 does not bind this; 2.13 does, as
// CUDAGraph.begin_capture_to_if_node.)
//
// Needs CUDA 12.4 or later to build and to run (conditional nodes with
// kernel, memcpy and memset nodes in their bodies).
#include <cuda_runtime.h>

namespace {

__global__ void set_condition(cudaGraphConditionalHandle handle, const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

cudaError_t begin(const bool* pred, cudaStream_t stream, cudaStream_t body) {
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive) return cudaErrorStreamCaptureInvalidated;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  set_condition<<<1, 1, 0, stream>>>(handle, pred);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the node depends on the kernel that sets its condition
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
  err = cudaStreamUpdateCaptureDependencies(stream, &node, 1, cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return err;
  return cudaStreamBeginCaptureToGraph(body, params.conditional.phGraph_out[0], nullptr, nullptr,
                                       0, cudaStreamCaptureModeThreadLocal);
}

}  // namespace

// begin != 0: in the graph that `stream` is capturing, add an IF node taken
// where *pred (a bool on the device) holds at a replay, and start `body` (a
// stream not capturing) capturing into its body; what is enqueued on `body`
// until the end call runs only where the node is taken. begin == 0: end the
// body's capture (`stream` and `pred` unused). Returns the CUDA error.
extern "C" int if_node(int begin_node, const bool* pred, cudaStream_t stream, cudaStream_t body) {
  if (begin_node) return static_cast<int>(begin(pred, stream, body));
  cudaGraph_t graph;
  return static_cast<int>(cudaStreamEndCapture(body, &graph));
}
