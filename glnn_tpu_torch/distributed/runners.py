"""The runners' work on a shard (`glnn_tpu/train/engine.py`'s halo and
data-parallel branches, :250-286, :333-420, :480-560, :641, :721), run by
every rank together inside `mesh.launch`. The engine's four runners are
written once; a rank passes them a `RankPlacement`, which answers what
differs on a shard: the row blocks, the generators, batch norm over the
ranks, and which epoch and eval functions run.

Layout on rank r of P: node rows in blocks of rows = ceil(n / P) (ghost
rows past n zero); labels and index sets replicated (global ids).

* Halo path (full-batch GCN, SAGE, GAT and APPNP, and every GNN eval):
  the model runs unchanged on this rank's HaloGraph and row block; the
  step's loss is the rank's NLL sum over its own train rows over the
  global train count; the gradients are summed over the ranks, so Adam
  steps alike everywhere.
  Batch norm takes its statistics over all n_pad rows of all ranks, and
  dropout draws the n_pad-row mask and keeps this rank's rows, as JAX's
  sharded forward over n_pad rows does.
* Sampled SAGE: `sampling.make_dp_sampled_sage_epoch_fn` on the replicated
  structure graph; its evals run on the HaloGraph.
* MLP (teacher and student): each global batch is split over the ranks;
  a rank gets its rows from their owners in one all_to_all
  (`fetch_batch_rows`: every rank knows the whole batch), draws
  the global batch's dropout mask and keeps its rows, and takes batch-norm
  statistics over the global batch; the loss is its share of the global
  batch mean, the gradients summed. So the epoch is the single-device
  epoch's, up to summation order (JAX's GSPMD epoch on row-sharded data).
* Evals all-gather the row blocks and cut them to [:n]; every rank then
  holds the same log-probs, scores and early-stopping decisions.

The shuffle and the dropout masks of the halo and MLP paths come from one
generator seeded alike on every rank; the sampled SAGE epoch samples and
drops out from a generator of its own per rank. Every epoch reads its
loss through `engine.host_float`, as the single-device epochs do.
"""

from __future__ import annotations

import numpy as np
import torch

from glnn_tpu_torch.distributed import mesh as _mesh
from glnn_tpu_torch.distributed.sampling import make_dp_sampled_sage_epoch_fn
from glnn_tpu_torch.nn.layers import BatchNorm1d, global_rows
from glnn_tpu_torch.train import engine
from glnn_tpu_torch.train.losses import log_softmax


def _sync_batch_norm(model, on: bool) -> None:
    for m in model.modules():
        if isinstance(m, BatchNorm1d):
            m.group_sum = _mesh.all_reduce_sum if on else None


def _own_rows(idx: torch.Tensor, rows: int) -> torch.Tensor:
    """This rank's positions of the global ids idx that it owns."""
    lo = _mesh.current().rank * rows
    mine = (idx >= lo) & (idx < lo + rows)
    return idx[mine] - lo


def make_halo_train_step(model, optimizer):
    """step(hg, x, labels, idx_train, gen) -> the global loss: the halo
    counterpart of engine.make_gnn_train_step."""
    params = list(model.parameters())

    def step(hg, x, labels, idx_train, gen):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        mine = _own_rows(idx_train, hg.rows)
        with global_rows(hg.n_pad, _mesh.current().rank * hg.rows):
            out = log_softmax(model(hg, x, gen)[1])
        y = labels[mine + _mesh.current().rank * hg.rows]
        num = -out[mine].gather(1, y.long()[:, None]).sum()
        (num / idx_train.shape[0]).backward()
        total, = _mesh.all_reduce_grads(params, num.detach())
        optimizer.step()
        return engine.host_float(total) / idx_train.shape[0]

    return step


def make_halo_eval_fn(model, exact: bool = False):
    """evaluate(hg, x) -> all-node log-probs [n] (every rank)."""
    local = engine.make_eval_fn(model, exact)

    def evaluate(hg, x):
        return _mesh.all_gather_rows(local(hg, x))[: hg.n_nodes]

    return evaluate


def fetch_batch_rows(block: torch.Tensor, batch: torch.Tensor, lo: int,
                     hi: int, b_local: int) -> torch.Tensor:
    """Rows batch[lo:hi] (global ids) of the matrix whose row block `block`
    this rank holds, where every rank holds the same global `batch` and
    rank q takes its slice q * b_local ..: each rank works out what every
    other one needs of it, so one all_to_all moves the rows."""
    mesh = _mesh.current()
    rows = block.shape[0]
    owner = batch // rows
    mine = torch.nonzero(owner == mesh.rank)[:, 0]
    send_counts = torch.bincount(mine // b_local, minlength=mesh.size)
    own = owner[lo:hi]
    order = torch.argsort(own, stable=True)
    recv_counts = torch.bincount(own, minlength=mesh.size)
    rows_in = _mesh.all_to_all(
        block.index_select(0, batch[mine] - mesh.rank * rows),
        send_counts.tolist(), recv_counts.tolist())
    return torch.empty_like(rows_in).index_copy_(0, order, rows_in)


def make_dp_mlp_epoch_fn(model, optimizer, batch_size: int, criterion: str,
                         lamb: float = 1.0):
    """epoch(block, ids, labels, feat_dim, gen, perm=None) -> mean unscaled
    loss: the data-parallel engine.make_mlp_epoch_fn. block: this rank's
    rows of the features (feat_dim columns; the teacher's log-probs after
    them for "kl"); ids: the training rows' global ids, shuffled by `perm`
    or by a draw from gen; labels: replicated (for "nll")."""
    use_kl = criterion == "kl"
    params = list(model.parameters())

    def epoch(block, ids, labels, feat_dim, gen, perm=None):
        mesh = _mesh.current()
        n = ids.shape[0]
        num_batches = max(1, n // batch_size)
        eff = batch_size if n >= batch_size else n
        if perm is None:
            perm = torch.randperm(n, generator=gen, device=block.device)
        b_local = -(-eff // mesh.size)
        lo = min(mesh.rank * b_local, eff)
        hi = min(lo + b_local, eff)
        batches = ids[perm[: num_batches * eff].to(ids.device)].view(
            num_batches, eff)
        model.train()
        losses = []
        for batch in batches:
            mine = batch[lo:hi]
            rows = fetch_batch_rows(block, batch, lo, hi, b_local)
            x, t = rows[:, :feat_dim], rows[:, feat_dim:]
            optimizer.zero_grad(set_to_none=True)
            with global_rows(eff, lo):
                out = log_softmax(model(None, x, gen)[1])
            if use_kl:
                num = (t.exp() * (t - out)).sum()
            else:
                num = -out.gather(1, labels[mine].long()[:, None]).sum()
            (num / eff * lamb).backward()
            total, = _mesh.all_reduce_grads(params, num.detach())
            optimizer.step()
            losses.append(total / eff)
        return engine.host_float(torch.stack(losses).mean())

    return epoch


def make_dp_mlp_eval_fn(model, batch_size=None):
    """evaluate(x_block, n) -> all-node log-probs [n] (every rank)."""
    local = engine.make_mlp_eval_fn(model, batch_size)

    def evaluate(x_block, n):
        return _mesh.all_gather_rows(local(x_block))[:n]

    return evaluate


class RankPlacement:
    """engine.LocalPlacement's counterpart on a rank: the engine's four
    runners take it as `place` (cli/sharded.py) and run on this rank's
    shard. g_struct: the replicated structure Graph a sampled SAGE teacher
    samples from; obs_feats: this rank's row block of the observed
    features (an inductive GNN teacher)."""

    def __init__(self, g_struct=None, obs_feats=None):
        self.g_struct, self.obs_feats = g_struct, obs_feats

    def generators(self, conf, device):
        """(shared, this rank's): the first alike on every rank."""
        mesh = _mesh.current()
        seed = int(conf["seed"])
        return (torch.Generator(device=device).manual_seed(seed),
                torch.Generator(device=device).manual_seed(
                    seed * mesh.size + mesh.rank + 1))

    def observed_rows(self, x, idx_obs):
        """This rank's own block of the observed rows."""
        return torch.as_tensor(np.asarray(self.obs_feats, np.float32),
                               device=x.device)

    def teacher_epoch(self, conf, model, optimizer, logger, g, x, labels,
                      idx_train, gens):
        """epoch(epoch) -> loss on this shard: the data-parallel MLP epoch
        over idx_train's global ids, the data-parallel sampled SAGE epoch
        on g_struct, or the halo step on g. Batch norm takes its
        statistics over the ranks, except in the sampled SAGE epoch."""
        sampled = engine._use_sampled_sage(conf, model)
        _sync_batch_norm(model, not sampled)
        if model.is_mlp:
            epoch_fn = make_dp_mlp_epoch_fn(model, optimizer,
                                            conf["batch_size"], "nll")
            return lambda epoch: epoch_fn(x, idx_train, labels, x.shape[1],
                                          gens[0])
        if sampled:
            if self.g_struct is None:
                raise ValueError("sampled SAGE on a HaloGraph needs g_struct "
                                 "(the replicated structure Graph) for the "
                                 "sampler")
            epoch_fn = make_dp_sampled_sage_epoch_fn(
                model, optimizer, conf["batch_size"], engine._fanouts(conf),
                sampler_tier=conf.get("sampler_tier", "floyd") or "floyd")

            def sampled_epoch(epoch):
                loss, (frontier, fetch) = epoch_fn(self.g_struct, x, labels,
                                                   idx_train, *gens)
                if frontier:
                    logger.warning(f"Ep {epoch}: sampler frontier cap "
                                   f"overflow")
                if fetch:
                    logger.warning(f"Ep {epoch}: fetch overflow")
                return loss
            return sampled_epoch
        step_fn = make_halo_train_step(model, optimizer)
        return lambda epoch: step_fn(g, x, labels, idx_train, gens[0])

    def distill_epoch(self, conf, model, optimizer, x, t, labels, ids_l,
                      ids_t, gens):
        """The two passes on this shard, over the [x, t] row block: hard
        labels on the global ids ids_l scaled by lamb, then the teacher's
        log-probs on ids_t scaled by 1 - lamb."""
        _sync_batch_norm(model, True)
        lamb, batch_size = conf["lamb"], conf["batch_size"]
        hard = make_dp_mlp_epoch_fn(model, optimizer, batch_size, "nll", lamb)
        soft = make_dp_mlp_epoch_fn(model, optimizer, batch_size, "kl",
                                    1.0 - lamb)
        block, f = torch.cat([x, t], 1), x.shape[1]
        return lambda epoch: (hard(block, ids_l, labels, f, gens[0])
                              + soft(block, ids_t, labels, f, gens[0]))

    def evaluators(self, conf, model, n):
        """(eval, final eval), each evaluate(g, x) -> all-node log-probs
        [n] on every rank."""
        if model.is_mlp:
            mlp_eval = make_dp_mlp_eval_fn(
                model, conf.get("eval_batch_size", conf["batch_size"]))

            def evaluate(g, x):
                return mlp_eval(x, n)
            return evaluate, evaluate
        return make_halo_eval_fn(model), make_halo_eval_fn(model, exact=True)
