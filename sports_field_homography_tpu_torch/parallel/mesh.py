"""Data parallelism over ranks and over local devices (port of
``parallel/mesh.py``'s data axis).

* ``check_batch_divisible``: the JAX package's message for a batch that
  does not split evenly.
* ``local_devices``: the ``--num_devices`` cards of this host, refused
  before anything starts where the machine has fewer.
* ``average_gradients`` (in place of ``shard_train_step``'s ``pmean``):
  every gradient, the step's logs and the stop flag in one flat buffer,
  one all-reduce, divided by the number of ranks.
* ``shard_predict_fn`` (in place of ``shard_predict_fn``): each batch cut
  into one shard a device, each shard through that device's copy of the
  predict program, the outputs put back in order.  No collective: the
  outputs equal the one-device program's.

GSPMD spatial partitioning (``spatial_forward_fn``) is not ported: this
CNN's activations fit one card, and the port's kernels take whole images.
"""
from __future__ import annotations

import copy
from dataclasses import replace
from typing import Callable, Dict, Iterable, List, Sequence, Tuple

import torch

__all__ = ["check_batch_divisible", "local_devices", "average_gradients",
           "shard_predict_fn"]


def check_batch_divisible(batchsize: int, num_devices: int, flag: str = "--batchsize"):
    """Fail fast, with a clear message, where the batch does not split into
    equal per-device shards (the JAX package's check and wording)."""
    if batchsize % num_devices:
        ok = batchsize - batchsize % num_devices
        raise SystemExit(
            f"{flag} {batchsize} is not divisible by num_devices "
            f"{num_devices}: data-parallel sharding needs equal per-device "
            f"shards. Use e.g. {flag} {ok or num_devices} or "
            f"{ok + num_devices}.")


def local_devices(device: str, num_devices: int) -> List[torch.device]:
    """The ``num_devices`` devices of this host for ``--device``: N CPU
    ranks for ``cpu``, else cards 0..N-1, refused (before any rank starts)
    where the machine has fewer."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return [dev] * num_devices
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if num_devices > have:
        raise SystemExit(f"--num_devices {num_devices}: a multi-device run needs "
                         f"{num_devices} CUDA devices and this machine has {have}; run "
                         f"fewer, or several processes with --num_hosts/--host_id/"
                         f"--coordinator")
    return [torch.device("cuda", i) for i in range(num_devices)]


def average_gradients(params: Iterable[torch.nn.Parameter], replicas,
                      extra: Sequence[torch.Tensor] = ()) -> List[torch.Tensor]:
    """Replace every ``.grad`` by its mean over the ranks, with one
    all-reduce of one flat f32 buffer; ``extra`` scalars (the step's logs,
    a stop flag) ride in the same buffer and come back summed over the
    ranks (not divided)."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads and not extra:
        return []
    dev = grads[0].device if grads else replicas.device
    parts = [g.reshape(-1).float() for g in grads]
    parts += [torch.as_tensor(e, dtype=torch.float32, device=dev).reshape(-1) for e in extra]
    flat = replicas.all_reduce_(torch.cat(parts))
    n_grad = sum(g.numel() for g in grads)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g).div_(replicas.world))
        offset += g.numel()
    return list(flat[n_grad:].unbind()) if extra else []


def _bundle_on(bundle, device: torch.device):
    """A copy of a ``cli/engine.ModelBundle`` with its model and court
    constants on ``device``."""
    if device == bundle.device:
        return bundle
    return replace(bundle, model=copy.deepcopy(bundle.model).to(device),
                   court_labels=bundle.court_labels.to(device),
                   value_table=bundle.value_table.to(device), device=device)


def shard_predict_fn(bundle, devices: Sequence[torch.device], consistency: bool,
                     keep: Iterable[str]) -> Callable[[torch.Tensor], Dict[str, torch.Tensor]]:
    """The predict program of ``cli/engine.predict_fn`` over ``devices``:
    a batch of B frames (B a multiple of the device count) becomes one
    shard of B / N frames a device, each on its own copy of the model;
    the outputs come back concatenated on the first device."""
    from ..cli.engine import predict_fn

    keep = list(keep)
    fns: List[Tuple[torch.device, Callable]] = [
        (d, predict_fn(_bundle_on(bundle, d), consistency, keep)) for d in devices]
    first = fns[0][0]

    def fn(frames: torch.Tensor) -> Dict[str, torch.Tensor]:
        check_batch_divisible(frames.shape[0], len(fns))
        outs = [f(shard.to(d, non_blocking=True))
                for (d, f), shard in zip(fns, frames.chunk(len(fns)))]
        return {k: torch.cat([o[k].to(first, non_blocking=True) for o in outs])
                for k in outs[0]}

    return fn
