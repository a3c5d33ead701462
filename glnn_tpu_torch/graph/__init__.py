from glnn_tpu_torch.graph.container import Graph, build_graph, graph_from_csr
from glnn_tpu_torch.graph.datasets import load_data, load_out_t
from glnn_tpu_torch.graph.host import HostGraph

__all__ = ["Graph", "build_graph", "graph_from_csr", "HostGraph",
           "load_data", "load_out_t"]
