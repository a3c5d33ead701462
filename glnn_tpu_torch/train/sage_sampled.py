"""Fanout-sampled SAGE training: one epoch as a Python loop over batches
(`glnn_tpu/train/sage_sampled.py`).

Shuffle the train ids, cut them into batches (the last one ghost-padded,
with its loss masked, as NodeDataLoader(drop_last=False)), and per batch:
sample concat-mode blocks on the `sampler_tier` ("floyd" or "window"),
gather the input features, forward with dropout, NLL on the batch, Adam
step. Returns the mean per-batch loss. Under a bf16 compute dtype the
features are cast once per epoch, before the per-batch gather, so the
gathered frontier rows are bf16 (`glnn_tpu/train/sage_sampled.py:46-53`);
parameters, the Adam state and the loss stay f32.
"""

from __future__ import annotations

import torch

from glnn_tpu_torch.sampling.sampler import sample_blocks
from glnn_tpu_torch.train.losses import log_softmax


def sage_sampled_step(model, optimizer, blocks, x_in, y, mask,
                      gen=None) -> torch.Tensor:
    """One Adam step on one sampled batch; returns the loss."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    h = model(blocks, x_in, gen)[1]
    per = -log_softmax(h).gather(1, y.long()[:, None])[:, 0]
    loss = (per * mask).sum() / mask.sum().clamp(min=1.0)
    loss.backward()
    optimizer.step()
    return loss.detach()


def make_sage_sampled_epoch_fn(model, optimizer, batch_size: int, fanouts,
                               sampler_tier: str = "floyd"):
    # engine imports this module, so its helper is taken at call time
    from glnn_tpu_torch.train.engine import host_float

    fanouts = tuple(int(f) for f in fanouts)

    def epoch(g, feats, labels, idx_train, gen):
        """-> (mean loss, overflowed). feats/labels/idx_train on g's device;
        gen a generator on that device."""
        n = g.n_nodes
        n_train = idx_train.shape[0]
        b = min(batch_size, n_train)
        num_batches = -(-n_train // b)
        perm = torch.randperm(n_train, generator=gen, device=feats.device)
        seeds_flat = torch.full((num_batches * b,), n, dtype=torch.int32,
                                device=feats.device)
        seeds_flat[:n_train] = idx_train[perm].to(torch.int32)
        x_ext = torch.cat([feats, feats.new_zeros((1, feats.shape[1]))])
        mdtype = getattr(model.module, "dtype", None)
        if mdtype is not None:
            x_ext = x_ext.to(mdtype)
        labels_ext = torch.cat([labels, labels.new_zeros((1,))])

        losses, overflow = [], False
        for seeds in seeds_flat.view(num_batches, b):
            blocks = sample_blocks(g, seeds, fanouts, gen,
                                   method=sampler_tier)
            x_in = x_ext[blocks.input_nodes.long()]
            y = labels_ext[seeds.long()]
            mask = (seeds < n).float()
            losses.append(sage_sampled_step(model, optimizer, blocks, x_in, y,
                                            mask, gen))
            overflow = overflow or blocks.overflowed
        return host_float(torch.stack(losses).mean()), overflow

    return epoch
