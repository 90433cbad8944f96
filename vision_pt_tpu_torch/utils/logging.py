"""Metric trackers (the port's own copy of ``vision_pt_tpu/utils/logging.py``).

jsonl, tensorboard and wandb, selected by TrackerConfig; a tracker whose
package is missing is skipped with a warning. The jsonl tracker needs
nothing beyond the standard library.
"""

from __future__ import annotations

import json
import time
from pathlib import Path


class Tracker:
    def log(self, values: dict, step: int) -> None:
        raise NotImplementedError

    def log_image(self, name: str, image, step: int) -> None:
        pass

    def finish(self) -> None:
        pass


class JsonlTracker(Tracker):
    def __init__(self, log_dir: str, project_name: str):
        self.path = Path(log_dir) / f"{project_name}.metrics.jsonl"
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.path, "a")

    def log(self, values: dict, step: int) -> None:
        record = {"step": step, "time": time.time()}
        for k, v in values.items():
            record[k] = float(v) if hasattr(v, "__float__") else v
        self._fh.write(json.dumps(record) + "\n")
        self._fh.flush()

    def finish(self) -> None:
        self._fh.close()


class TensorBoardTracker(Tracker):
    def __init__(self, log_dir: str, project_name: str):
        from torch.utils.tensorboard import SummaryWriter

        self.writer = SummaryWriter(log_dir=str(Path(log_dir) / project_name))

    def log(self, values: dict, step: int) -> None:
        for k, v in values.items():
            try:
                self.writer.add_scalar(k, float(v), step)
            except (TypeError, ValueError):
                pass

    def log_image(self, name: str, image, step: int) -> None:
        import numpy as np

        self.writer.add_image(
            name, np.asarray(image).transpose(2, 0, 1), step
        )

    def finish(self) -> None:
        self.writer.close()


class WandbTracker(Tracker):
    def __init__(self, log_dir: str, project_name: str):
        import wandb  # optional; skipped when missing

        self.run = wandb.init(project=project_name, dir=log_dir)
        self._wandb = wandb

    def log(self, values: dict, step: int) -> None:
        self.run.log(values, step=step)

    def log_image(self, name: str, image, step: int) -> None:
        self.run.log({name: self._wandb.Image(image)})

    def finish(self) -> None:
        self.run.finish()


def get_trackers(config) -> list[Tracker]:
    """Build trackers from TrackerConfig; unavailable backends are skipped
    with a warning rather than crashing the run."""
    if config is None:
        return []
    out: list[Tracker] = []
    for name in config.loggers:
        try:
            if name == "jsonl":
                out.append(JsonlTracker(config.log_dir, config.project_name))
            elif name == "tensorboard":
                out.append(TensorBoardTracker(config.log_dir, config.project_name))
            elif name == "wandb":
                out.append(WandbTracker(config.log_dir, config.project_name))
        except Exception as e:
            print(f"[tracker] {name} unavailable, skipping: {e}")
    return out
