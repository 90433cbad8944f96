"""Full train-state checkpoint and restore (port of
``vision_pt_tpu/training/checkpoint.py``, which uses orbax).

A step's checkpoint is a directory ``step_<n>`` under ``save_dir`` holding
``state.pt`` (``torch.save`` of the trainable's state dict, the optimizer's
state dict, the EMA and any extra tensors) and ``metadata.json`` (step,
epoch, generator counter, ...). It is written into a temporary directory
and renamed, so an interrupted save never leaves a partial step; saving a
step that exists does nothing; the newest ``keep`` steps stay. The format
is the port's own: no interchange with orbax.
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path

import torch
from torch import nn

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
             extra: dict[str, object] | None = None) -> Path | None:
        """Write step ``step``; returns its directory, or None if it existed."""
        final = self._path(step)
        if final.exists():
            return None
        tmp = self.save_dir / f".{final.name}.tmp-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        torch.save({"params": trainable.state_dict(),
                    "opt_state": optimizer.state_dict(),
                    "ema": ema_state, "extra": extra or {}}, tmp / "state.pt")
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
        trainable.load_state_dict(state["params"], strict=True)
        optimizer.load_state_dict(state["opt_state"])
        meta = json.loads((path / "metadata.json").read_text())
        device = next(trainable.parameters()).device
        ema = state["ema"]
        meta["_restored_step"] = step
        meta["_ema"] = (None if ema is None
                        else {k: v.to(device) for k, v in ema.items()})
        meta["_extra"] = state["extra"]
        return meta
