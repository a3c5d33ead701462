"""Process groups for the sharded paths (`glnn_tpu/distributed/mesh.py`).

The JAX package runs one program over a mesh of devices; the port runs one
process per shard under `torch.distributed`. This module holds:

* `launch(fn, payloads, ordinal)`: spawns one rank per payload (the
  `spawn` start method), runs `fn(mesh, payload)` in each, and returns rank
  0's result. A rank's exception ends the run: the parent stops every rank
  and raises with the rank's traceback. The rendezvous is a `file://` in a
  temporary directory; the process group times out after `PG_TIMEOUT`
  seconds, and the parent waits at most `timeout` seconds in all.
* the rank -> device rule: rank r runs on cuda:<ordinal + r> (the CPU for
  ordinal -1). Fewer GPUs than ranks raises ("need N devices, have M")
  unless the environment variable GLNN_SHARE_DEVICE is "1": then every
  rank runs on cuda:<ordinal>, the counterpart of the 8 virtual CPU
  devices that `--xla_force_host_platform_device_count=8` gives JAX.
* the backend rule: nccl when every rank has a GPU of its own, gloo
  otherwise (the CPU, and ranks sharing one GPU, which NCCL refuses).
* the collectives the sharded paths use: an uneven `all_to_all`, an
  all-reduce (in place, and a differentiable sum for the batch-norm
  statistics), and an all-gather of row blocks. Each one takes tensors on
  the rank's device: gloo takes CUDA tensors for every one of them (f32,
  bf16 and int64, uneven and empty splits; checked on an H100 with two
  ranks on one GPU), so nothing is staged through host memory.

Inside a rank `current()` is the rank's `Mesh`; outside every rank it is
None.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

SHARE_DEVICE_ENV = "GLNN_SHARE_DEVICE"
PG_TIMEOUT = 120.0


@dataclasses.dataclass(frozen=True)
class Mesh:
    rank: int
    size: int
    device: torch.device
    backend: str


_CURRENT: Mesh | None = None


def current() -> Mesh | None:
    return _CURRENT


def plan_devices(ordinal: int, n_ranks: int) -> tuple[list, str]:
    """(device of each rank, backend) for n_ranks ranks from `ordinal`."""
    if ordinal < 0:
        return [torch.device("cpu")] * n_ranks, "gloo"
    if os.environ.get(SHARE_DEVICE_ENV) == "1":
        return [torch.device(f"cuda:{ordinal}")] * n_ranks, "gloo"
    have = torch.cuda.device_count() - ordinal
    if have < n_ranks:
        raise ValueError(f"need {n_ranks} devices, have {max(have, 0)} (set "
                         f"{SHARE_DEVICE_ENV}=1 to run the ranks on one GPU)")
    return ([torch.device(f"cuda:{ordinal + r}") for r in range(n_ranks)],
            "nccl")


def _rank_main(rank, size, device, backend, tmp, fn, payload) -> None:
    global _CURRENT
    try:
        dev = torch.device(device)
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // size))
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=f"file://{tmp}/rendezvous", world_size=size,
            rank=rank, timeout=datetime.timedelta(seconds=PG_TIMEOUT))
        _CURRENT = Mesh(rank, size, dev, backend)
        result = fn(_CURRENT, payload)
        if rank == 0:
            torch.save(result, os.path.join(tmp, "result.pt"))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        # the traceback goes to the parent, which stops the other ranks;
        # _exit does not wait for the process group's threads
        with open(os.path.join(tmp, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)


def launch(fn, payloads: list, ordinal: int, timeout: float = 86400.0):
    """Run fn(mesh, payloads[r]) on rank r of len(payloads) ranks (fn must
    be importable by name); returns rank 0's result. The CUDA kernels are
    built here first, so that the ranks do not race nvcc."""
    import multiprocessing

    devices, backend = plan_devices(ordinal, len(payloads))
    if devices[0].type == "cuda":
        from glnn_tpu_torch.ops import cuda_build

        cuda_build.build()
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="glnn_ranks_") as tmp:
        procs = [ctx.Process(target=_rank_main,
                             args=(r, len(payloads), str(devices[r]), backend,
                                   tmp, fn, payload))
                 for r, payload in enumerate(payloads)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while any(p.exitcode is None for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(f"the ranks ran past {timeout} s")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.exitcode is None:
                    p.terminate()
            for p in procs:
                p.join()
        failed = sorted(os.listdir(tmp))
        errors = [f for f in failed if f.startswith("error_")]
        if errors or any(p.exitcode != 0 for p in procs):
            text = "".join(open(os.path.join(tmp, f)).read() for f in errors)
            raise RuntimeError(f"a rank failed (exit codes "
                               f"{[p.exitcode for p in procs]}):\n{text}")
        return torch.load(os.path.join(tmp, "result.pt"), weights_only=False)


def all_to_all(x: torch.Tensor, send_splits, recv_splits) -> torch.Tensor:
    """Rows x[sum(send_splits[:q]):][:send_splits[q]] go to rank q; returns
    the rows received, rank by rank (recv_splits[q] from rank q)."""
    x = x.contiguous()
    out = x.new_empty((sum(recv_splits),) + tuple(x.shape[1:]))
    dist.all_to_all_single(out, x, list(recv_splits), list(send_splits))
    return out


def all_reduce_(t: torch.Tensor) -> torch.Tensor:
    """In-place sum over the ranks; returns t."""
    dist.all_reduce(t)
    return t


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone())


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Differentiable sum over the ranks: with the total loss the sum of
    every rank's loss, the gradient of each rank's input is the sum of the
    ranks' output gradients."""
    return _AllReduceSum.apply(x)


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The ranks' equal row blocks, concatenated in rank order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x)
    return torch.cat(parts)


def all_reduce_grads(params, *extra: torch.Tensor) -> list:
    """Sum every parameter's gradient over the ranks in one flat all-reduce
    (a missing gradient counts as zero), with the `extra` tensors
    alongside; returns the summed extras."""
    params = [p for p in params if p.requires_grad]
    flat = torch.cat([(p.grad if p.grad is not None
                       else torch.zeros_like(p)).reshape(-1) for p in params]
                     + [e.reshape(-1).to(params[0].dtype) for e in extra])
    all_reduce_(flat)
    pos = 0
    for p in params:
        n = p.numel()
        p.grad = flat[pos:pos + n].view_as(p).clone()
        pos += n
    out = []
    for e in extra:
        out.append(flat[pos:pos + e.numel()].view_as(e))
        pos += e.numel()
    return out
