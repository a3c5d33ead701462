"""Data-parallel neighbour-sampled SAGE training
(`glnn_tpu/distributed/sampling.py`).

Each rank samples the blocks of its slice of every global batch from the
replicated structure graph, while the node features stay in row blocks,
one per rank (the halo path's layout). The input rows of a rank's blocks
are fetched from their owners (`fetch_rows`, each distinct id once): the
request counts, then the row ids, then the rows, each an uneven
all_to_all with exact splits. So no
bucket can overflow, and the epoch's fetch-overflow flag, which JAX's
bucketed fetch needs, is always False; it stays in the return beside the
sampler's frontier flag, as the runner reads both.

The global batch layout is JAX's: the shuffled train ids, ghost-padded to
num_batches x P x ceil(b / P), batch k's slice of rank r at [k, r]. The
loss is the global masked mean: each rank's sum over its real seeds over
the global batch's count of real seeds (known to every rank), and the
gradients are summed over the ranks, so Adam steps identically on every
rank, one step per global batch as in the single-device epoch. With
fanouts at least the largest in-degree the sampling takes every neighbour
and the epoch reproduces the single-device one; below that each rank
samples from its own generator (JAX folds the rank into its key: a
documented divergence).

Batch norm: statistics over each rank's own sub-batch, and the running
statistics averaged over the ranks after every step (JAX's pmean of the
batch stats, its documented deviation from the global batch).
"""

from __future__ import annotations

import torch

from glnn_tpu_torch.distributed import mesh as _mesh
from glnn_tpu_torch.nn.layers import BatchNorm1d
from glnn_tpu_torch.sampling.sampler import sample_blocks
from glnn_tpu_torch.train.engine import host_float
from glnn_tpu_torch.train.losses import log_softmax


def fetch_rows(block: torch.Tensor, idx: torch.Tensor, rows: int,
               n_real: int) -> torch.Tensor:
    """Rows `idx` (global ids) of the matrix whose row block `block`
    ([rows, F], ids rank * rows ..) this rank holds; every rank calls it
    together. Ids >= n_real (ghosts) fetch zero rows. Each distinct id is
    asked for once: a concat-mode frontier repeats many."""
    size = _mesh.current().size
    uniq, inv = torch.unique(idx.long(), return_inverse=True)
    real = uniq[uniq < n_real]              # sorted, so grouped by owner
    owner = real // rows
    send_counts = torch.bincount(owner, minlength=size)
    recv_counts = _mesh.all_to_all(send_counts, [1] * size, [1] * size)
    send, recv = send_counts.tolist(), recv_counts.tolist()
    asked = _mesh.all_to_all(real - owner * rows, send, recv)
    rows_back = _mesh.all_to_all(block.index_select(0, asked), recv, send)
    pad = block.new_zeros((uniq.shape[0] - real.shape[0],)
                          + tuple(block.shape[1:]))
    return torch.cat([rows_back, pad]).index_select(0, inv)


def make_dp_sampled_sage_epoch_fn(model, optimizer, batch_size: int, fanouts,
                                  sampler_tier: str = "floyd"):
    fanouts = tuple(int(f) for f in fanouts)

    def epoch(g, x_block, labels, idx_train, gen, rank_gen, perm=None):
        """-> (mean loss, (frontier overflow, fetch overflow)). g: the
        replicated structure Graph; x_block: this rank's feature rows;
        labels, idx_train: replicated; gen: the shuffle's generator (alike
        on every rank); rank_gen: this rank's sampling and dropout
        generator; perm: the shuffle, when given."""
        mesh = _mesh.current()
        n, dev = g.n_nodes, x_block.device
        rows = x_block.shape[0]
        n_train = idx_train.shape[0]
        b = min(batch_size, n_train)
        b_local = -(-b // mesh.size)
        num_batches = -(-n_train // b)
        if perm is None:
            perm = torch.randperm(n_train, generator=gen, device=dev)
        seeds_flat = torch.full((num_batches * mesh.size * b_local,), n,
                                dtype=torch.int32, device=dev)
        seeds_flat[:n_train] = idx_train[perm.to(dev)].to(torch.int32)
        seed_mat = seeds_flat.view(num_batches, mesh.size, b_local)
        dens = (seed_mat < n).flatten(1).sum(1).float().clamp(min=1.0)
        labels_ext = torch.cat([labels, labels.new_zeros((1,))])
        mdtype = getattr(model.module, "dtype", None)
        params = list(model.parameters())
        stats = [t for m in model.modules() if isinstance(m, BatchNorm1d)
                 for t in (m.running_mean, m.running_var)]

        losses, overflow = [], False
        for seeds, den in zip(seed_mat[:, mesh.rank], dens):
            blocks = sample_blocks(g, seeds, fanouts, rank_gen,
                                   method=sampler_tier)
            x_in = fetch_rows(x_block, blocks.input_nodes, rows, n)
            if mdtype is not None:
                x_in = x_in.to(mdtype)
            y = labels_ext[seeds.long()]
            mask = (seeds < n).float()
            model.train()
            optimizer.zero_grad(set_to_none=True)
            h = model(blocks, x_in, rank_gen)[1]
            per = -log_softmax(h).gather(1, y.long()[:, None])[:, 0]
            num = (per * mask).sum()
            (num / den).backward()
            # the running statistics ride along: the ranks' mean of them
            total, *summed = _mesh.all_reduce_grads(params, num.detach(),
                                                    *stats)
            for t, s in zip(stats, summed):
                t.copy_(s / mesh.size)
            optimizer.step()
            losses.append(total / den)
            overflow = overflow or bool(blocks.overflowed)
        return host_float(torch.stack(losses).mean()), (overflow, False)

    return epoch
