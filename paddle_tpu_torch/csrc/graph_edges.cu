// graph_edges — counts the dependency edges of a captured CUDA graph by
// type. Not a kernel: a host helper for the smoke's check that a
// captured serving step kept its programmatic dependent launches (K7 and
// paged_decode's merge are launched with programmatic stream
// serialization; under stream capture CUDA 12.3+ records each as a
// programmatic edge instead of a full dependency).
#include <cuda_runtime.h>
#include <stdlib.h>

// graph: a cudaGraph_t (torch.cuda.CUDAGraph(keep_graph=True)
// .raw_cuda_graph()). Writes the number of edges and how many of them
// are programmatic. Returns a cudaError_t code.
extern "C" int graph_edge_counts(void* graph, long long* total,
                                 long long* programmatic) {
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  size_t n = 0;
  cudaError_t e = cudaGraphGetEdges_v2(g, nullptr, nullptr, nullptr, &n);
  if (e != cudaSuccess) return (int)e;
  *total = (long long)n;
  *programmatic = 0;
  if (n == 0) return 0;
  cudaGraphNode_t* from =
      static_cast<cudaGraphNode_t*>(malloc(n * sizeof(cudaGraphNode_t)));
  cudaGraphNode_t* to =
      static_cast<cudaGraphNode_t*>(malloc(n * sizeof(cudaGraphNode_t)));
  cudaGraphEdgeData* data =
      static_cast<cudaGraphEdgeData*>(malloc(n * sizeof(cudaGraphEdgeData)));
  if (from == nullptr || to == nullptr || data == nullptr) {
    free(from);
    free(to);
    free(data);
    return (int)cudaErrorMemoryAllocation;
  }
  e = cudaGraphGetEdges_v2(g, from, to, data, &n);
  if (e == cudaSuccess)
    for (size_t i = 0; i < n; ++i)
      if (data[i].type == cudaGraphDependencyTypeProgrammatic)
        ++*programmatic;
  free(from);
  free(to);
  free(data);
  return (int)e;
}

extern "C" const char* graph_edges_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
