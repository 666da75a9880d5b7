"""Faults planted under the timed path, to show that ``correct`` comes out
false when the program goes wrong: the tests plant them at tiny shapes on
the CPU, ``tools/calibrate.py --fault`` on the card at the cell's size.

    half_batch  half of each batch left out: predict answers the first
                half and repeats it; training runs its step on the first
                half (its means over those rows)
    altered     an answer altered where it is produced: theta's x shift
                +0.05 in predict, the step's loss x1.05 in
                training
    unchanged   training only: the optimizer step leaves the state as it was
    warp_shift  predict only: K1's warp labels moved by one pixel along x
                where they are produced
"""
from __future__ import annotations

import torch

import program

__all__ = ["plant", "FAULTS"]

FAULTS = ("half_batch", "altered", "unchanged", "warp_shift")


def _predict(real, fault):
    def predict_program(bundle, keep):
        fn = real(bundle, keep)

        def broken(frames):
            if fault == "half_batch" and frames.shape[0] > 1:
                half = (frames.shape[0] + 1) // 2
                out = fn(frames[:half])
                idx = torch.arange(frames.shape[0]) % half
                return {k: v[idx.to(v.device)] for k, v in out.items()}
            out = fn(frames)
            if fault == "altered":
                out["theta"] = out["theta"].clone()
                out["theta"][..., 0, 2] += 0.05
            if fault == "warp_shift":
                out["warp_mask"] = torch.roll(out["warp_mask"], 1, dims=-1)
            return out
        return broken
    return predict_program


def _train(real, fault):
    def train_program(*args, **kwargs):
        model, opt, loss_cfg, step = real(*args, **kwargs)
        if fault == "unchanged":
            opt.step = lambda *a, **k: None

        def broken(model, opt, batch, *rest, **kw):
            if fault == "half_batch":
                half = batch["image"].shape[0] // 2
                batch = {k: v[:half] for k, v in batch.items()}
            logs = step(model, opt, batch, *rest, **kw)
            if fault == "altered":
                logs = dict(logs, Tot_loss=logs["Tot_loss"] * 1.05)
            return logs
        return model, opt, loss_cfg, broken
    return train_program


def plant(fault: str, train: bool):
    """Replace the entry in ``program`` with a broken one; returns a
    function that puts the real one back."""
    if fault not in FAULTS or (fault == "unchanged" and not train) or (
            fault == "warp_shift" and train):
        raise ValueError(fault)
    name = "train_program" if train else "predict_program"
    real = getattr(program, name)
    setattr(program, name, (_train if train else _predict)(real, fault))
    return lambda: setattr(program, name, real)
