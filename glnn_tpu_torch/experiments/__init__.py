"""The paper's experiments on the port's CLIs (`experiments/` of the
repository, which drives the JAX CLIs): `run_experiments` (the paper and
ablation runs), `aggregate_table3` (Table 3 against the published
accuracies) and `reproduce_all` (the paper families, then the table). Each
runs as `python -m glnn_tpu_torch.experiments.<name>`."""
