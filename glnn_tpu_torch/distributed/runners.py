"""The runners on a shard (`glnn_tpu/train/engine.py`'s halo and data-parallel
branches, :250-286, :333-420, :480-560, :641, :721), run by every rank
together inside `mesh.launch`; the engine's four runners hand over to them
when they are called inside a rank.

Layout on rank r of P: node rows in blocks of rows = ceil(n / P) (ghost
rows past n zero); labels and index sets replicated (global ids).

* Halo path (full-batch GCN and SAGE, and every GNN eval): the model runs
  unchanged on this rank's HaloGraph and row block; the step's loss is the
  rank's NLL sum over its own train rows over the global train count; the
  gradients are summed over the ranks, so Adam steps alike everywhere.
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
drops out from a generator of its own per rank.
"""

from __future__ import annotations

import numpy as np
import torch

from glnn_tpu_torch.distributed import mesh as _mesh
from glnn_tpu_torch.distributed.sampling import make_dp_sampled_sage_epoch_fn
from glnn_tpu_torch.nn.layers import BatchNorm1d, global_rows
from glnn_tpu_torch.train import engine
from glnn_tpu_torch.train.engine import _tensors
from glnn_tpu_torch.train.losses import log_softmax


def _sync_batch_norm(model, on: bool) -> None:
    for m in model.modules():
        if isinstance(m, BatchNorm1d):
            m.group_sum = _mesh.all_reduce_sum if on else None


def _generators(conf, device):
    """(shared, this rank's): the first alike on every rank."""
    mesh = _mesh.current()
    seed = int(conf["seed"])
    return (torch.Generator(device=device).manual_seed(seed),
            torch.Generator(device=device).manual_seed(
                seed * mesh.size + mesh.rank + 1))


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
        return float(total) / idx_train.shape[0]

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
        return float(torch.stack(losses).mean())

    return epoch


def make_dp_mlp_eval_fn(model, batch_size=None):
    """evaluate(x_block, n) -> all-node log-probs [n] (every rank)."""
    local = engine.make_mlp_eval_fn(model, batch_size)

    def evaluate(x_block, n):
        return _mesh.all_gather_rows(local(x_block))[:n]

    return evaluate


def _teacher_epoch(conf, model, optimizer, logger, g, x, labels, idx_train,
                   gens, g_struct):
    """epoch(epoch) -> loss for a teacher on this shard."""
    if model.is_mlp:
        epoch_fn = make_dp_mlp_epoch_fn(model, optimizer, conf["batch_size"],
                                        "nll")
        return lambda epoch: epoch_fn(x, idx_train, labels, x.shape[1],
                                      gens[0])
    if engine._use_sampled_sage(conf, model):
        if g_struct is None:
            raise ValueError("sampled SAGE on a HaloGraph needs g_struct (the "
                             "replicated structure Graph) for the sampler")
        epoch_fn = make_dp_sampled_sage_epoch_fn(
            model, optimizer, conf["batch_size"], engine._fanouts(conf),
            sampler_tier=conf.get("sampler_tier", "floyd") or "floyd")

        def sampled(epoch):
            loss, (frontier, fetch) = epoch_fn(g_struct, x, labels, idx_train,
                                               *gens)
            if frontier:
                logger.warning(f"Ep {epoch}: sampler frontier cap overflow")
            if fetch:
                logger.warning(f"Ep {epoch}: fetch overflow")
            return loss
        return sampled
    _sync_batch_norm(model, True)
    step_fn = make_halo_train_step(model, optimizer)
    return lambda epoch: step_fn(g, x, labels, idx_train, gens[0])


def _evaluators(conf, model, n):
    """(eval, final eval): (graph, x) -> all-node log-probs [n]."""
    if model.is_mlp:
        mlp_eval = make_dp_mlp_eval_fn(
            model, conf.get("eval_batch_size", conf["batch_size"]))

        def fn(g, x):
            return mlp_eval(x, n)
        return fn, fn
    return make_halo_eval_fn(model), make_halo_eval_fn(model, exact=True)


def run_transductive(conf, model, g, feats, labels, indices, optimizer,
                     logger, loss_and_score, device, state_out=None,
                     g_struct=None):
    """engine.run_transductive on a shard: g this rank's HaloGraph (None
    for an MLP), feats its row block, g_struct the replicated structure
    Graph of a sampled SAGE teacher."""
    n = np.asarray(labels).shape[0]
    x, labels = _tensors(device, np.asarray(feats, np.float32), labels)
    idx_train, idx_val, idx_test = _tensors(device, *indices)
    gens = _generators(conf, device)
    _sync_batch_norm(model, model.is_mlp)
    train_epoch = _teacher_epoch(conf, model, optimizer, logger, g, x, labels,
                                 idx_train, gens, g_struct)
    eval_fn, final_fn = _evaluators(conf, model, n)

    def eval_row():
        out = eval_fn(g, x)
        return engine._metrics_row((out, labels, idx)
                                   for idx in (idx_train, idx_val, idx_test))

    best = engine._fit(conf, model, logger, loss_and_score, train_epoch,
                       eval_row, ("s_train", "s_val", "s_test"),
                       "teacher tran runner", state_out)
    out = final_fn(g, x)
    _, score_val = engine._subset_metrics(out, labels, idx_val)
    _, score_test = engine._subset_metrics(out, labels, idx_test)
    engine._log_final(logger, best, score_val=score_val, score_test=score_test)
    return out.cpu().numpy(), score_val, score_test


def run_inductive(conf, model, g, obs_g, feats, labels, indices, optimizer,
                  logger, loss_and_score, device, state_out=None,
                  g_struct=None, obs_feats=None):
    """engine.run_inductive on a shard: g and obs_g this rank's HaloGraphs
    of the full and the observed graph (None for an MLP), feats and
    obs_feats this rank's row blocks of the full and the observed
    features, g_struct the replicated observed structure Graph of a sampled
    SAGE teacher. An MLP trains on the observed train rows (global ids
    idx_obs[obs_idx_train]) of the full feature blocks."""
    n = np.asarray(labels).shape[0]
    x, labels = _tensors(device, np.asarray(feats, np.float32), labels)
    (obs_idx_train, obs_idx_val, obs_idx_test, idx_obs,
     idx_test_ind) = _tensors(device, *indices)
    obs_labels = labels[idx_obs]
    gens = _generators(conf, device)
    _sync_batch_norm(model, model.is_mlp)
    if model.is_mlp:
        obs_x, train_ids = None, idx_obs[obs_idx_train]
        train_epoch = _teacher_epoch(conf, model, optimizer, logger, None, x,
                                     labels, train_ids, gens, None)
    else:
        obs_x, = _tensors(device, np.asarray(obs_feats, np.float32))
        train_epoch = _teacher_epoch(conf, model, optimizer, logger, obs_g,
                                     obs_x, obs_labels, obs_idx_train, gens,
                                     g_struct)
    eval_fns = _evaluators(conf, model, n)

    def evaluate(exact=False):
        """(obs_out, out_all)."""
        fn = eval_fns[exact]
        out_all = fn(g, x)
        if model.is_mlp:
            return out_all[idx_obs], out_all
        return fn(obs_g, obs_x), out_all

    def eval_row():
        obs_out, out_all = evaluate()
        return engine._metrics_row(
            [(obs_out, obs_labels, idx)
             for idx in (obs_idx_train, obs_idx_val, obs_idx_test)]
            + [(out_all, labels, idx_test_ind)])

    best = engine._fit(conf, model, logger, loss_and_score, train_epoch,
                       eval_row, ("s_train", "s_val", "s_tt", "s_ti"),
                       "teacher ind runner", state_out)
    obs_out, out_all = evaluate(exact=True)
    _, score_val = engine._subset_metrics(obs_out, obs_labels, obs_idx_val)
    _, score_test_tran = engine._subset_metrics(obs_out, obs_labels,
                                                obs_idx_test)
    _, score_test_ind = engine._subset_metrics(out_all, labels, idx_test_ind)
    engine._log_final(logger, best, score_val=score_val,
                      score_test_tran=score_test_tran,
                      score_test_ind=score_test_ind)
    out = out_all.clone()
    out[idx_obs] = obs_out
    return out.cpu().numpy(), score_val, score_test_tran, score_test_ind


def _distill_epoch(conf, model, optimizer, block, feat_dim, labels, ids_l,
                   ids_t, gen):
    """The two passes on a shard: hard labels on ids_l scaled by lamb, then
    the teacher's log-probs on ids_t scaled by 1 - lamb."""
    lamb, batch_size = conf["lamb"], conf["batch_size"]
    hard = make_dp_mlp_epoch_fn(model, optimizer, batch_size, "nll", lamb)
    soft = make_dp_mlp_epoch_fn(model, optimizer, batch_size, "kl", 1.0 - lamb)
    return lambda epoch: (hard(block, ids_l, labels, feat_dim, gen)
                          + soft(block, ids_t, labels, feat_dim, gen))


def distill_run_transductive(conf, model, feats, labels, out_t, indices,
                             optimizer, logger, loss_and_score, device,
                             state_out=None):
    """engine.distill_run_transductive on a shard: feats and out_t this
    rank's row blocks of the features and the teacher's log-probs."""
    n = np.asarray(labels).shape[0]
    x, t, labels = _tensors(device, np.asarray(feats, np.float32),
                            np.asarray(out_t, np.float32), labels)
    idx_l, idx_t, idx_val, idx_test = _tensors(device, *indices)
    gen = _generators(conf, device)[0]
    _sync_batch_norm(model, True)
    train_epoch = _distill_epoch(conf, model, optimizer, torch.cat([x, t], 1),
                                 x.shape[1], labels, idx_l, idx_t, gen)
    eval_fn = make_dp_mlp_eval_fn(model, conf.get("eval_batch_size",
                                                  conf["batch_size"]))

    def eval_row():
        out = eval_fn(x, n)
        return engine._metrics_row((out, labels, idx)
                                   for idx in (idx_l, idx_val, idx_test))

    best = engine._fit(conf, model, logger, loss_and_score, train_epoch,
                       eval_row, ("s_l", "s_val", "s_test"), "distill runner",
                       state_out)
    out = eval_fn(x, n)
    _, score_val = engine._subset_metrics(out, labels, idx_val)
    _, score_test = engine._subset_metrics(out, labels, idx_test)
    engine._log_final(logger, best, score_val=score_val, score_test=score_test)
    return out.cpu().numpy(), score_val, score_test


def distill_run_inductive(conf, model, feats, labels, out_t, indices,
                          optimizer, logger, loss_and_score, device,
                          state_out=None):
    """engine.distill_run_inductive on a shard (`indices` as there; the
    passes train on the observed rows' global ids)."""
    n = np.asarray(labels).shape[0]
    x, t, labels = _tensors(device, np.asarray(feats, np.float32),
                            np.asarray(out_t, np.float32), labels)
    (obs_idx_l, obs_idx_t, obs_idx_val, obs_idx_test, idx_obs,
     idx_test_ind) = _tensors(device, *indices)
    obs_labels = labels[idx_obs]
    gen = _generators(conf, device)[0]
    _sync_batch_norm(model, True)
    train_epoch = _distill_epoch(conf, model, optimizer, torch.cat([x, t], 1),
                                 x.shape[1], labels, idx_obs[obs_idx_l],
                                 idx_obs[obs_idx_t], gen)
    eval_fn = make_dp_mlp_eval_fn(model, conf.get("eval_batch_size",
                                                  conf["batch_size"]))

    def eval_row():
        out_all = eval_fn(x, n)
        obs_out = out_all[idx_obs]
        return engine._metrics_row(
            [(obs_out, obs_labels, idx)
             for idx in (obs_idx_l, obs_idx_val, obs_idx_test)]
            + [(out_all, labels, idx_test_ind)])

    best = engine._fit(conf, model, logger, loss_and_score, train_epoch,
                       eval_row, ("s_l", "s_val", "s_tt", "s_ti"),
                       "distill runner", state_out)
    out = eval_fn(x, n)
    obs_out = out[idx_obs]
    _, score_val = engine._subset_metrics(obs_out, obs_labels, obs_idx_val)
    _, score_test_tran = engine._subset_metrics(obs_out, obs_labels,
                                                obs_idx_test)
    _, score_test_ind = engine._subset_metrics(out, labels, idx_test_ind)
    engine._log_final(logger, best, score_val=score_val,
                      score_test_tran=score_test_tran,
                      score_test_ind=score_test_ind)
    return out.cpu().numpy(), score_val, score_test_tran, score_test_ind
