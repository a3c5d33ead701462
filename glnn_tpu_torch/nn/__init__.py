from glnn_tpu_torch.nn.convert import from_jax_variables
from glnn_tpu_torch.nn.layers import (BatchNorm1d, GATConv, LayerNorm1d,
                                      SAGEConvGCN, make_norm)
from glnn_tpu_torch.nn.models import GAT, MLP, SAGE, Model

__all__ = ["MLP", "SAGE", "GAT", "Model", "SAGEConvGCN", "GATConv",
           "BatchNorm1d", "LayerNorm1d", "make_norm", "from_jax_variables"]
