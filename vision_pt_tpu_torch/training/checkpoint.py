"""Full train-state checkpoint and restore (port of
``vision_pt_tpu/training/checkpoint.py``, which uses orbax).

A step's checkpoint is a directory ``step_<n>`` under ``save_dir`` holding
``state.pt`` (``torch.save`` of the trainable's state dict, the optimizer's
state dict, the EMA and any extra tensors) and ``metadata.json`` (step,
epoch, generator counter, ...). It is written into a temporary directory
and renamed, so an interrupted save never leaves a partial step; saving a
step that exists does nothing; the newest ``keep`` steps stay. The format
is the port's own: no interchange with orbax. Under a mesh every rank
gathers its shards whole for the save, one rank writes, and a restore
under the same mesh puts each rank's shard back.
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path

import torch
from torch import nn

from ..parallel.mesh import distribute_like, full_tensors

_PREFIX = "step_"


class TrainStateCheckpointer:
    def __init__(self, save_dir: str, keep: int = 2):
        self.save_dir = Path(save_dir).resolve()
        self.save_dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    def _path(self, step: int) -> Path:
        return self.save_dir / f"{_PREFIX}{step:08d}"

    def all_steps(self) -> list[int]:
        return sorted(int(p.name[len(_PREFIX):]) for p in self.save_dir.iterdir()
                      if p.is_dir() and p.name.startswith(_PREFIX)
                      and p.name[len(_PREFIX):].isdigit())

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, trainable: nn.Module, optimizer: torch.optim.Optimizer,
             ema_state: dict[str, torch.Tensor] | None = None,
             metadata: dict | None = None,
             extra: dict[str, object] | None = None,
             write: bool = True) -> Path | None:
        """Write step ``step``; returns its directory, or None if it existed
        or ``write`` is False (a rank that only joins the gather)."""
        final = self._path(step)
        if final.exists():
            return None
        state = full_tensors({"params": trainable.state_dict(),
                              "opt_state": optimizer.state_dict(),
                              "ema": ema_state, "extra": extra or {}})
        if not write:
            return None
        tmp = self.save_dir / f".{final.name}.tmp-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        torch.save(state, tmp / "state.pt")
        (tmp / "metadata.json").write_text(json.dumps(metadata or {}))
        os.replace(tmp, final)
        for old in self.all_steps()[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(self._path(old))
        return final

    def restore(self, trainable: nn.Module, optimizer: torch.optim.Optimizer,
                step: int | None = None) -> dict:
        """Load a step (the latest by default) into ``trainable`` and
        ``optimizer`` in place. Returns the metadata with ``_restored_step``,
        ``_ema`` (on the trainable's device, or None) and ``_extra``."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.save_dir}")
        path = self._path(step)
        state = torch.load(path / "state.pt", map_location="cpu", weights_only=True)
        current = trainable.state_dict()
        trainable.load_state_dict(
            {k: distribute_like(v, current[k]) for k, v in state["params"].items()},
            strict=True)
        params = [p for group in optimizer.param_groups for p in group["params"]]
        opt_state = state["opt_state"]
        for index, entry in opt_state["state"].items():
            if isinstance(index, int):
                like = params[index]
                entry.update({k: distribute_like(v, like) for k, v in entry.items()
                              if isinstance(v, torch.Tensor) and v.shape == like.shape})
        optimizer.load_state_dict(opt_state)
        meta = json.loads((path / "metadata.json").read_text())
        device = next(trainable.parameters()).device
        named = dict(trainable.named_parameters())
        ema = state["ema"]
        meta["_restored_step"] = step
        meta["_ema"] = (None if ema is None
                        else {k: distribute_like(v, named[k]).to(device)
                              for k, v in ema.items()})
        extra = state["extra"]
        if extra.get("accumulation") is not None:
            trained = [p for p in trainable.parameters() if p.requires_grad]
            extra["accumulation"] = [distribute_like(a, p).to(device)
                                     for a, p in zip(extra["accumulation"], trained)]
        meta["_extra"] = extra
        return meta
