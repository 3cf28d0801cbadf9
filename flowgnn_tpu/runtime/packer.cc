// Native host runtime: dataset reading, graph transforms, and static-shape
// bucket packing.
//
// This is the framework's counterpart of the reference's host-side data
// path (graph fetch + packed-array append, GIN/src/host_load.cc:100-143 and
// GIN/src/host.cc:119-138) plus the host-side augmentations (GIN-VN virtual
// node, GIN-VN/src/host_load.cc:129-153; GAT self edges,
// GAT/src/load_inputs.cc:144-149). The packer produces exactly the
// PackedGraphs layout of core/graphs.py: flat node/edge arrays with one
// trailing pad node and pad graph, so buckets stream straight into jit'd
// device programs with no Python in the per-bucket loop.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstdio>
#include <cstring>

namespace {

constexpr int kAtomFeatures = 9;
constexpr int kBondFeatures = 3;

struct GraphView {
  const int32_t* node_feat;  // [n, 9]
  const int32_t* edge_index; // [e, 2]
  const int32_t* edge_attr;  // [e, 3] or nullptr
  int32_t n;
  int32_t e;
};

}  // namespace

extern "C" {

// Pack a run of graphs (concatenated arrays + per-graph counts) into one
// fixed-capacity bucket. Returns the number of graphs consumed (those that
// fit), or -1 if the first graph alone exceeds capacity. Output arrays must
// be pre-allocated by the caller with the PackedGraphs shapes:
//   out_node_feat [node_cap+1, 9]   out_node_graph [node_cap+1]
//   out_senders/out_receivers [edge_cap]   out_edge_attr [edge_cap, 3]
//   out_n_node/out_n_edge [graph_cap+1]
int32_t fg_pack_bucket(
    const int32_t* node_feat, const int32_t* edge_index,
    const int32_t* edge_attr,  // nullable
    const int32_t* n_nodes, const int32_t* n_edges, int32_t num_graphs,
    int32_t node_cap, int32_t edge_cap, int32_t graph_cap,
    int32_t* out_node_feat, int32_t* out_node_graph, int32_t* out_senders,
    int32_t* out_receivers, int32_t* out_edge_attr, int32_t* out_n_node,
    int32_t* out_n_edge) {
  // Initialise padding: zero features, pad-graph ids, pad-node edge targets.
  std::memset(out_node_feat, 0, sizeof(int32_t) * (node_cap + 1) * kAtomFeatures);
  std::memset(out_edge_attr, 0, sizeof(int32_t) * edge_cap * kBondFeatures);
  std::memset(out_n_node, 0, sizeof(int32_t) * (graph_cap + 1));
  std::memset(out_n_edge, 0, sizeof(int32_t) * (graph_cap + 1));
  for (int32_t i = 0; i <= node_cap; ++i) out_node_graph[i] = graph_cap;
  for (int32_t i = 0; i < edge_cap; ++i) {
    out_senders[i] = node_cap;
    out_receivers[i] = node_cap;
  }

  int32_t node_off = 0, edge_off = 0, g = 0;
  int64_t in_node_off = 0, in_edge_off = 0;
  for (; g < num_graphs && g < graph_cap; ++g) {
    const int32_t n = n_nodes[g], e = n_edges[g];
    if (node_off + n > node_cap || edge_off + e > edge_cap) break;
    std::memcpy(out_node_feat + (int64_t)node_off * kAtomFeatures,
                node_feat + in_node_off * kAtomFeatures,
                sizeof(int32_t) * n * kAtomFeatures);
    for (int32_t i = 0; i < n; ++i) out_node_graph[node_off + i] = g;
    const int32_t* ei = edge_index + in_edge_off * 2;
    for (int32_t i = 0; i < e; ++i) {
      out_senders[edge_off + i] = ei[2 * i] + node_off;
      out_receivers[edge_off + i] = ei[2 * i + 1] + node_off;
    }
    if (edge_attr != nullptr) {
      std::memcpy(out_edge_attr + (int64_t)edge_off * kBondFeatures,
                  edge_attr + in_edge_off * kBondFeatures,
                  sizeof(int32_t) * e * kBondFeatures);
    }
    out_n_node[g] = n;
    out_n_edge[g] = e;
    node_off += n;
    edge_off += e;
    in_node_off += n;
    in_edge_off += e;
  }
  if (g == 0) return -1;
  out_n_node[graph_cap] = node_cap + 1 - node_off;
  out_n_edge[graph_cap] = edge_cap - edge_off;
  return g;
}

// Virtual-node augmentation in place of the GIN-VN host
// (GIN-VN/src/host_load.cc:129-153): appends one zero-feature node and the
// bidirectional star of zero-attr edges. Output capacities must be at least
// n+1 nodes and e+2n edges.
void fg_add_virtual_node(const int32_t* node_feat, const int32_t* edge_index,
                         const int32_t* edge_attr, int32_t n, int32_t e,
                         int32_t* out_node_feat, int32_t* out_edge_index,
                         int32_t* out_edge_attr) {
  std::memcpy(out_node_feat, node_feat, sizeof(int32_t) * n * kAtomFeatures);
  std::memset(out_node_feat + (int64_t)n * kAtomFeatures, 0,
              sizeof(int32_t) * kAtomFeatures);
  std::memcpy(out_edge_index, edge_index, sizeof(int32_t) * e * 2);
  for (int32_t nd = 0; nd < n; ++nd) {
    out_edge_index[2 * (e + 2 * nd)] = nd;
    out_edge_index[2 * (e + 2 * nd) + 1] = n;
    out_edge_index[2 * (e + 2 * nd + 1)] = n;
    out_edge_index[2 * (e + 2 * nd + 1) + 1] = nd;
  }
  if (edge_attr != nullptr) {
    std::memcpy(out_edge_attr, edge_attr, sizeof(int32_t) * e * kBondFeatures);
    std::memset(out_edge_attr + (int64_t)e * kBondFeatures, 0,
                sizeof(int32_t) * 2 * n * kBondFeatures);
  }
}

// Self-loop augmentation (GAT/src/load_inputs.cc:144-149): self edges first.
void fg_add_self_loops(const int32_t* edge_index, int32_t n, int32_t e,
                       int32_t* out_edge_index) {
  for (int32_t nd = 0; nd < n; ++nd) {
    out_edge_index[2 * nd] = nd;
    out_edge_index[2 * nd + 1] = nd;
  }
  std::memcpy(out_edge_index + (int64_t)n * 2, edge_index,
              sizeof(int32_t) * e * 2);
}

// Read one reference-layout graph (g%d_info.txt + g%d_*.bin,
// GIN/src/host.cc:126-137). Two-phase: call with null outputs to get counts,
// then with allocated buffers. Returns 0 on success.
int32_t fg_read_graph(const char* dataset_dir, int32_t index,
                      int32_t* out_counts,  // [2] = n, e
                      int32_t* node_feat, int32_t* edge_index,
                      int32_t* edge_attr) {
  char path[1024];
  std::snprintf(path, sizeof(path), "%s/graph_info/g%d_info.txt", dataset_dir,
                index);
  FILE* f = std::fopen(path, "r");
  if (!f) return 1;
  int n = 0, e = 0;
  if (std::fscanf(f, "%d%d", &n, &e) != 2) {
    std::fclose(f);
    return 2;
  }
  std::fclose(f);
  out_counts[0] = n;
  out_counts[1] = e;
  if (node_feat == nullptr) return 0;

  auto read_bin = [&](const char* suffix, int32_t* dst, size_t count) {
    std::snprintf(path, sizeof(path), "%s/graph_bin/g%d_%s.bin", dataset_dir,
                  index, suffix);
    FILE* bf = std::fopen(path, "rb");
    if (!bf) return false;
    const size_t got = std::fread(dst, sizeof(int32_t), count, bf);
    std::fclose(bf);
    return got == count;
  };
  if (!read_bin("node_feature", node_feat, (size_t)n * kAtomFeatures)) return 3;
  if (!read_bin("edge_list", edge_index, (size_t)e * 2)) return 4;
  if (edge_attr != nullptr &&
      !read_bin("edge_attr", edge_attr, (size_t)e * kBondFeatures))
    return 5;
  return 0;
}

}  // extern "C"
