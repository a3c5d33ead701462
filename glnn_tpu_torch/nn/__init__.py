from glnn_tpu_torch.nn.convert import from_jax_variables
from glnn_tpu_torch.nn.layers import (BatchNorm1d, GATConv, GraphConv,
                                      LayerNorm1d, SAGEConvGCN,
                                      appnp_propagate, make_norm)
from glnn_tpu_torch.nn.models import APPNP, GAT, GCN, MLP, SAGE, Model

__all__ = ["MLP", "SAGE", "GCN", "GAT", "APPNP", "Model", "SAGEConvGCN",
           "GraphConv", "GATConv", "appnp_propagate", "BatchNorm1d",
           "LayerNorm1d", "make_norm", "from_jax_variables"]
