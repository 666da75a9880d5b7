"""Multi-process runtime (port of ``parallel/distributed.py``).

The JAX package runs one process per host and a mesh over that host's
chips; PyTorch's idiom is one process per device, so here every rank is a
process and owns one device.  The ranks meet in a ``torch.distributed``
process group whose address is given, never discovered: ``--coordinator
host:port`` with ``--num_hosts`` and ``--host_id`` (or the JAX package's
environment variables ``SFH_COORDINATOR`` / ``SFH_NUM_HOSTS`` /
``SFH_HOST_ID``), and ``--num_devices`` local ranks on each host.  The
coordinator's host runs the TCP store of rank 0.

The backend is picked once, before any collective, by a rule, and logged:
NCCL where every rank has a card of its own, gloo on the CPU or where two
ranks share a card (NCCL refuses that).  The ranks find out by writing
their device's UUID into the store and reading everyone's.  The group has a
timeout, so a collective that waits on a dead rank raises instead of
hanging, and the run fails: the backend is never switched after a failure.

Each rank takes its contiguous slice of every global batch
(``process_slice``); a full batch splits evenly, a ragged tail as evenly as
it can (5 over 2 ranks: 3 + 2), with the global counts all-reduced where
the losses and the BatchNorm moments need them.

``python -m sports_field_homography_tpu_torch.parallel.distributed --smoke
<pid> <nprocs> <port> [--steps k] [--grad_accum k] ...`` runs one rank of a
seeded data-parallel train step (``_smoke``) or of the JAX package's
multi-step contract (``_multistep``: equal digests, a bit-equal resume,
and the one-process run on the full batches up to reduction order); the
tests start it in two processes.
"""
from __future__ import annotations

import os
import socket
from datetime import timedelta
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Replicas", "initialize_distributed", "resolve_hosts", "choose_backend",
           "process_slice", "free_port", "DEFAULT_TIMEOUT_S"]

DEFAULT_TIMEOUT_S = 600.0      # a collective waits this long on a missing rank


def resolve_hosts(coordinator: Optional[str] = None, num_hosts: Optional[int] = None,
                  host_id: Optional[int] = None) -> Optional[Tuple[str, int, int]]:
    """``(coordinator, num_hosts, host_id)`` from the flags, else from
    ``SFH_COORDINATOR`` / ``SFH_NUM_HOSTS`` / ``SFH_HOST_ID``; None for a
    run on one host.  The JAX package can leave them to a TPU pod's own
    discovery; here all three must be given."""
    coordinator = coordinator or os.environ.get("SFH_COORDINATOR")
    if num_hosts is None and os.environ.get("SFH_NUM_HOSTS"):
        num_hosts = int(os.environ["SFH_NUM_HOSTS"])
    if host_id is None and os.environ.get("SFH_HOST_ID"):
        host_id = int(os.environ["SFH_HOST_ID"])
    if coordinator is None and num_hosts is None and host_id is None:
        return None
    if coordinator is None or num_hosts is None or host_id is None:
        raise ValueError("a multi-device run across hosts needs --coordinator host:port, "
                         "--num_hosts and --host_id (or SFH_COORDINATOR, SFH_NUM_HOSTS, "
                         "SFH_HOST_ID)")
    if not 0 <= host_id < num_hosts:
        raise ValueError(f"--host_id {host_id} is not in [0, {num_hosts})")
    _split_address(coordinator)
    return coordinator, int(num_hosts), int(host_id)


def _split_address(address: str) -> Tuple[str, int]:
    host, sep, port = address.rpartition(":")
    if not sep or not host or not port.isdigit():
        raise ValueError(f"--coordinator {address!r} is not host:port")
    return host, int(port)


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _device_identity(device: torch.device) -> str:
    if device.type != "cuda":
        return "cpu"
    return str(torch.cuda.get_device_properties(device).uuid)


def choose_backend(store, rank: int, world: int, device: torch.device) -> str:
    """``"nccl"`` when every rank's device is a card of its own, else
    ``"gloo"`` (a rank on the CPU, or two ranks on one card), from the
    device UUIDs the ranks write into ``store``."""
    store.set(f"sfh/device/{rank}", _device_identity(device))
    ids = [store.get(f"sfh/device/{r}").decode() for r in range(world)]
    if "cpu" in ids or len(set(ids)) < world:
        return "gloo"
    return "nccl"


class _AllReduceSum(torch.autograd.Function):
    """Differentiable sum over the ranks: the backward sums the output's
    gradient over the ranks, which is the gradient of the sum of every
    rank's objective (``torch.distributed.nn.functional.all_reduce``,
    deprecated in current PyTorch)."""

    @staticmethod
    def forward(ctx, tensor):
        out = tensor.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad)


class Replicas:
    """This process's rank among ``world`` data-parallel ranks (the
    default process group), its device, and the counts of the batch in
    flight.

    The models' BatchNorm layers reach it as ``bn_sync``
    (``models/layers.set_bn_sync``): they all-reduce their per-channel sums
    (``all_reduce_`` in the fused DoubleConv, differentiable ``all_reduce``
    in the ResNet's BatchNorm) and divide by ``count``, the global number
    of values a channel has, from the global batch size ``set_batch``
    recorded.
    """

    def __init__(self, rank: int, world: int, backend: str, device: torch.device):
        self.rank, self.world, self.backend = int(rank), int(world), backend
        self.device = torch.device(device)
        self.batch_local = self.batch_total = None

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place; returns it."""
        dist.all_reduce(t)
        return t

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks, differentiable."""
        return _AllReduceSum.apply(t)

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        dist.broadcast(t, src)
        return t

    def barrier(self) -> None:
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()

    def any(self, flag: bool) -> bool:
        """True on every rank when ``flag`` is true on any."""
        t = torch.tensor([float(bool(flag))], device=self.device)
        return bool(self.all_reduce_(t).item() > 0)

    def set_batch(self, n_local: int, weight_sum: Optional[torch.Tensor] = None):
        """Record this rank's and the global batch size (one all-reduce of
        ``[n_local, weight_sum]``); returns ``(n_total, global weight sum)``
        as an int and an f32 scalar (None without ``weight_sum``)."""
        w = (torch.zeros((), device=self.device) if weight_sum is None
             else weight_sum.detach().float().reshape(()))
        t = self.all_reduce_(torch.stack([torch.tensor(float(n_local), device=w.device), w]))
        self.batch_local, self.batch_total = int(n_local), int(round(float(t[0])))
        return self.batch_total, (None if weight_sum is None else t[1])

    def count(self, m_local: int) -> int:
        """The global count of a per-channel reduction over ``m_local``
        values of this rank's batch (``m_local / n_local * n_total``)."""
        if self.batch_local is None:
            raise RuntimeError("Replicas.set_batch was not called for this batch")
        return int(m_local) // self.batch_local * self.batch_total

    def close(self) -> None:
        if dist.is_initialized():
            dist.destroy_process_group()


def initialize_distributed(coordinator: str, world_size: int, rank: int,
                           device: torch.device) -> Replicas:
    """Join the process group of ``world_size`` ranks at ``coordinator``
    (``host:port``; rank 0 runs the TCP store there) as ``rank`` on
    ``device``, with the backend ``choose_backend`` picks."""
    host, port = _split_address(coordinator)
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    wait = timedelta(seconds=DEFAULT_TIMEOUT_S)
    store = dist.TCPStore(host, port, world_size, is_master=rank == 0, timeout=wait)
    backend = choose_backend(store, rank, world_size, device)
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("every rank has a card of its own, but this PyTorch has no NCCL")
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size,
                            timeout=wait)
    return Replicas(rank, world_size, backend, device)


def process_slice(global_batch_size: int, rank: int, world: int) -> Tuple[int, int]:
    """``(start, size)`` of ``rank``'s contiguous slice of a global batch:
    ``global_batch_size / world`` rows for a full batch, and for a ragged
    tail the first ``n % world`` ranks one row more (5 over 2: 3 + 2)."""
    per, extra = divmod(int(global_batch_size), int(world))
    start = rank * per + min(rank, extra)
    return start, per + (rank < extra)


# --- the two-process harness -------------------------------------------------

# the JAX harness's losses (CE seg, MSE rec, RRMSE reproj, CE consistency,
# default lambdas, the gate open)
_LOSSES = dict(seg_loss="CE", rec_loss="MSE", reproj_loss="RRMSE", consist_loss="CE",
               consist_start_iter=0)
_BATCH = 4          # the harness's global batch (with --batch, that file's)
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_COURT = os.path.join(_REPO, "assets", "mask_ncaa_v4_nc4_m_onehot.png")
_POI = os.path.join(_REPO, "assets", "template_ncaa_v4_points.json")


def _seeded_batch(n: int, size, seed: int, num_poi: int) -> Dict[str, np.ndarray]:
    """The JAX harness's global batch from ``seed``: uniform frames, random
    masks and points, unit weights (every rank makes the same batch, then
    takes its slice)."""
    w, h = size
    rng = np.random.RandomState(seed)
    return {"image": rng.rand(n, h, w, 3).astype(np.float32),
            "mask": rng.randint(0, 4, size=(n, h, w)).astype(np.int64),
            "poi": rng.rand(n, num_poi, 2).astype(np.float32),
            "nonzeros": np.ones((n, num_poi), np.float32),
            "num_nonzero": np.full((n,), float(num_poi), np.float32),
            "weight": np.ones((n, 1), np.float32)}


class _Harness:
    """The model, court constants and step of the harness on one device."""

    def __init__(self, size, device, load=None):
        from ..data.assets import open_court_template
        from ..geometry.court import load_court_poi
        from ..models import Reconstructor, ReconstructorConfig
        from ..models.layers import init_weights

        self.size, self.device = tuple(size), torch.device(device)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        # a run repeats bit for bit only on cuDNN's deterministic algorithms:
        # the UNet stem's weight gradient (``conv2d_weight`` on cuDNN,
        # ``ops/double_conv.py``) otherwise varies in its last bits from run
        # to run (the port's kernels repeat), and no resume could equal it
        torch.backends.cudnn.benchmark = False
        torch.backends.cudnn.deterministic = True
        w, h = self.size
        self.cfg = ReconstructorConfig(target_size=(w, h), unet_size=(w, h),
                                       warp_size=(w, h), resnet_name="resnet18",
                                       resnet_input="img+mask")
        model = Reconstructor(self.cfg)
        if load is None:
            init_weights(model, torch.Generator().manual_seed(0))
        else:
            model.load_state_dict(torch.load(load, map_location="cpu", weights_only=True))
        self.init_state = {k: v.clone() for k, v in model.state_dict().items()}
        self.model = model.to(self.device).train()
        labels = open_court_template(_COURT, 4, size=(w, h))
        self.court = (torch.from_numpy(labels).float() / 4).to(self.device)
        self.poi = torch.from_numpy(load_court_poi(_POI).astype(np.float32)).to(self.device)

    def fresh(self, opt: str, lr: float, wd: float):
        """The model back at its initial state, and a new optimizer."""
        from ..train.optim import make_optimizer

        self.model.load_state_dict(self.init_state)
        return make_optimizer(opt, self.model.parameters(), lr, wd)

    def step(self, optimizer, batch, step_no, global_batch, replicas=None,
             return_grads=False):
        from ..train.loop import LossConfig, train_step

        def dev(b):
            return {k: torch.from_numpy(v).to(self.device) for k, v in b.items()}

        from ..models.layers import set_bn_sync

        micro = [dev(b) for b in batch] if isinstance(batch, list) else dev(batch)
        cfg = LossConfig(**dict(_LOSSES, batch_size=global_batch))
        set_bn_sync(self.model, replicas)
        return train_step(self.model, optimizer, micro, step_no, self.court, self.poi, cfg,
                          return_grads=return_grads, replicas=replicas)


def _params_digest(model) -> str:
    import hashlib

    h = hashlib.sha256()
    for _, v in sorted(model.state_dict().items()):
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def _rank_of(batch, rank: int, world: int):
    """``rank``'s rows of a global batch, or of each micro-batch of a list."""
    if isinstance(batch, list):
        return [_rank_of(m, rank, world) for m in batch]
    start, size = process_slice(len(batch["image"]), rank, world)
    return {k: v[start:start + size] for k, v in batch.items()}


def _smoke(pid: int, nprocs: int, port: int, device: str = "cpu", size=(64, 32),
           grad_accum: int = 1, load: Optional[str] = None,
           batch_path: Optional[str] = None, out: Optional[str] = None) -> None:
    """One data-parallel RMSprop train step of the seeded
    flagship on this rank's slice, then, on rank 0, the same step in this
    process alone on the full batch.  Prints ``DIST_SMOKE`` with the
    loss, the digest of the parameters, and the one-process run's distance
    (the worst gradient leaf's rel-L2 beside ``order_floor``, the same
    one-process step's with the ranks' rows swapped: reduction order alone);
    with ``out``, instead of that run, saves this rank's logs, averaged
    gradients and state for the caller to hold."""
    import time

    replicas = initialize_distributed(f"127.0.0.1:{port}", nprocs, pid, torch.device(device))
    try:
        h = _Harness(size, device, load)
        k = max(1, grad_accum)
        if batch_path is not None:
            full = dict(np.load(batch_path))
            full = ([{key: v[i] for key, v in full.items()} for i in range(k)]
                    if k > 1 else full)
        else:
            full = ([_seeded_batch(_BATCH, size, 100 + i, len(h.poi)) for i in range(k)]
                    if k > 1 else _seeded_batch(_BATCH, size, 100, len(h.poi)))
        local = _rank_of(full, pid, nprocs)
        optimizer = h.fresh("RMSprop", 1e-4, 1e-8)
        if device.startswith("cuda"):
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        n_global = len((full[0] if k > 1 else full)["image"])
        logs, grads = h.step(optimizer, local, 0, n_global, replicas, return_grads=True)
        if device.startswith("cuda"):
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        state = {n: v.detach().cpu().clone() for n, v in h.model.state_dict().items()}
        digest = _params_digest(h.model)
        line = (f"DIST_SMOKE pid={pid} backend={replicas.backend} "
                f"loss={float(logs['Tot_loss']):.6f} digest={digest} seconds={seconds:.4f}")
        if pid == 0 and out is None:     # with ``out`` the caller holds the step
            one_opt = h.fresh("RMSprop", 1e-4, 1e-8)
            one_logs, one_grads = h.step(one_opt, full, 0, n_global, return_grads=True)
            one_state = {n: v.clone() for n, v in h.model.state_dict().items()}
            worst_grad, worst = _worst_leaf(one_grads, grads)
            maxabs = max(float((state[n].double() - v.detach().cpu().double()).abs().max())
                         for n, v in h.model.named_parameters())
            stats = max(float(((state[n].double() - v.cpu().double()).abs()
                               / (1e-5 + 1e-3 * v.cpu().double().abs())).max())
                        for n, v in one_state.items() if "running_" in n)
            # the same step on the same samples, the ranks' slices in the
            # other order: how far reduction order alone moves the gradients
            swapped = _rank_order_swapped(full, nprocs)
            _, swap_grads = h.step(h.fresh("RMSprop", 1e-4, 1e-8), swapped, 0, n_global,
                                   return_grads=True)
            floor, floor_leaf = _worst_leaf(one_grads, swap_grads)
            line += (f" local={float(one_logs['Tot_loss']):.6f} grad_rel_l2={worst_grad:.3e}"
                     f" grad_worst={worst} order_floor={floor:.3e} order_worst={floor_leaf}"
                     f" params_maxabs={maxabs:.3e} stats_vs_bound={stats:.3e}")
        print(line, flush=True)
        if out is not None:
            os.makedirs(out, exist_ok=True)
            torch.save({"logs": {n: float(v) for n, v in logs.items()},
                        "grads": {n: g.cpu() for n, g in grads.items()}, "state": state,
                        "digest": digest}, os.path.join(out, f"rank{pid}.pt"))
        replicas.barrier()
    finally:
        replicas.close()


def _rel_l2(ref: torch.Tensor, got: torch.Tensor) -> float:
    ref, got = ref.detach().cpu().double(), got.detach().cpu().double()
    return float((ref - got).norm() / ref.norm().clamp_min(1e-30))


def _worst_leaf(ref: Dict[str, torch.Tensor], got: Dict[str, torch.Tensor]):
    """(rel-L2, name) of the gradient leaf farthest from ``ref``'s, over
    the leaves with a gradient (the convolution biases in front of a
    BatchNorm have none: theirs is rounding noise)."""
    return max((_rel_l2(ref[n], g), n) for n, g in got.items()
               if float(ref[n].norm()) > 1e-6
               and not n.endswith(("double_conv.0.bias", "double_conv.3.bias")))


def _rank_order_swapped(batch, world: int):
    """The global batch with the ranks' slices in reverse order (the same
    samples), or each micro-batch of a list so."""
    if isinstance(batch, list):
        return [_rank_order_swapped(m, world) for m in batch]
    n = len(batch["image"])
    slices = [process_slice(n, r, world) for r in reversed(range(world))]
    rows = np.concatenate([np.arange(start, start + size) for start, size in slices])
    return {k: v[rows] for k, v in batch.items()}


def _multistep(pid: int, nprocs: int, port: int, steps: int = 4, device: str = "cpu",
               size=(64, 32)) -> None:
    """The JAX package's multi-step contract, one rank of it: ``steps`` SGD
    steps on this rank's slices of seeded global batches, saving the train
    state after step ``steps // 2`` (rank 0 writes it, every rank reads it
    after a barrier); the resumed run must be bit-equal to the
    uninterrupted one, both ranks must print one parameter digest, and the
    run must match this process's one-rank run on the full batches up to
    reduction order (``maxabs``).  SGD, because an adaptive optimizer turns
    reduction-order noise in near-zero gradients into whole updates.
    Rank 0 alone runs the one-process reference and prints ``maxabs``."""
    import tempfile

    from ..train.optim import make_scheduler
    from ..utils.checkpoint import load_train_state, save_train_state, train_state

    if steps < 2:
        raise ValueError(f"--steps must be >= 2, got {steps}")
    replicas = initialize_distributed(f"127.0.0.1:{port}", nprocs, pid, torch.device(device))
    try:
        h = _Harness(size, device)
        batches = [_seeded_batch(_BATCH, size, 1000 + s, len(h.poi)) for s in range(steps)]
        # one file every rank can read: rank 0 writes it
        path = os.path.join(tempfile.gettempdir(), f"dist_multistep_{port}.pth")
        half = steps // 2

        def run(optimizer, first, replicas=None, save_at=-1):
            for s in range(first, steps):
                b = batches[s] if replicas is None else _rank_of(batches[s], pid, nprocs)
                logs = h.step(optimizer, b, s, _BATCH, replicas)
                if s == save_at:
                    if replicas.is_main:
                        save_train_state(path, train_state(
                            h.model, optimizer, make_scheduler(optimizer), s + 1))
                    replicas.barrier()
            return logs

        optimizer = h.fresh("SGD", 1e-3, 0.0)
        logs = run(optimizer, 0, replicas, save_at=half - 1)
        final = {n: v.detach().cpu().clone() for n, v in h.model.state_dict().items()}
        digest = _params_digest(h.model)

        optimizer = h.fresh("SGD", 1e-3, 0.0)
        load_train_state(path, h.model, optimizer, make_scheduler(optimizer))
        run(optimizer, half, replicas)
        resumed = h.model.state_dict()
        bit_equal = all(torch.equal(final[n], v.detach().cpu()) for n, v in resumed.items())

        line = (f"DIST_MULTISTEP pid={pid} backend={replicas.backend} digest={digest} "
                f"resume_bit_equal={bit_equal} loss={float(logs['Tot_loss']):.6f}")
        replicas.barrier()
        if replicas.is_main:      # the one-process run, on rank 0 alone
            os.remove(path)
            optimizer = h.fresh("SGD", 1e-3, 0.0)
            run(optimizer, 0)
            maxabs = max(float((final[n].double() - v.detach().cpu().double()).abs().max())
                         for n, v in h.model.named_parameters())
            line += f" maxabs={maxabs:.3e}"
        print(line, flush=True)
        replicas.barrier()
    finally:
        replicas.close()


def _main(argv) -> None:
    import argparse

    p = argparse.ArgumentParser(prog="python -m sports_field_homography_tpu_torch."
                                "parallel.distributed")
    p.add_argument("--smoke", nargs=3, type=int, metavar=("PID", "NPROCS", "PORT"),
                   required=True)
    p.add_argument("--steps", type=int, default=None,
                   help="the multi-step contract over this many SGD steps")
    p.add_argument("--grad_accum", type=int, default=1)
    p.add_argument("--device", default="cuda",
                   help="this rank's device (cuda: the current card; cpu)")
    p.add_argument("--size", nargs=2, type=int, default=(64, 32), metavar=("W", "H"))
    p.add_argument("--load", default=None, help="initial state_dict (.pth)")
    p.add_argument("--batch", default=None,
                   help=".npz of the global batch ((K, B, ...) with --grad_accum K)")
    p.add_argument("--out", default=None, help="directory for rank{pid}.pt")
    a = p.parse_args(argv)
    pid, nprocs, port = a.smoke
    if a.steps is not None:
        _multistep(pid, nprocs, port, a.steps, a.device, a.size)
    else:
        _smoke(pid, nprocs, port, a.device, a.size, a.grad_accum, a.load, a.batch, a.out)


if __name__ == "__main__":
    import sys

    _main(sys.argv[1:])
