"""The sharded paths of `--n_shards` (`glnn_tpu/distributed/`): host-side
partitioners, the process group and its collectives, the halo-sharded
graph, and the data-parallel sampled SAGE epoch."""
