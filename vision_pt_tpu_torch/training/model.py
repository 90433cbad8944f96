"""ModelForTraining: the workload contract (port of
``vision_pt_tpu/training/model.py``).

The Trainer drives a workload through lifecycle hooks. The hot path is split
in three: a host-side ``prepare_batch`` (tokenisation, arrays to the device),
``draw_randoms`` (the step's timesteps and noise from a ``torch.Generator``)
and ``compute_loss(trainable, batch, draws)``, which the Trainer
differentiates. Keeping the draws apart lets a test hand in the JAX
package's.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any

import numpy as np
import torch
from pydantic import BaseModel
from torch import nn

from ..config import TrainConfig
from ..parallel.mesh import shard_batch


class ModelForTraining(ABC):
    model_config: BaseModel
    model_config_class: type[BaseModel]

    _current_step: int = 0
    # the draws with one row per sample, which a ``trainer.mesh`` run takes
    # this rank's rows of with the batch; None: the workload does not run
    # under a mesh (ROADMAP Queue 1 item 5)
    mesh_draws: tuple[str, ...] | None = None
    # the draws every rank takes whole (one for the whole batch, such as
    # TREAD's route permutation); every rank draws the same from the
    # trainer's generator
    mesh_whole_draws: tuple[str, ...] = ()
    # the mesh axes it runs over; another axis of size > 1 raises
    mesh_axes: tuple[str, ...] = ("data", "fsdp", "tensor", "seq")
    # the trainer's DeviceMesh under ``trainer.mesh`` (set before the model
    # is built), else None
    mesh = None

    def __init__(self, config: TrainConfig, device: torch.device) -> None:
        self.config = config
        self.device = device
        self._logs_at_step: dict = {}
        self._logs_at_epoch: dict[str, list] = {}
        self._is_peft = False
        self._trackers: list = []
        self.validate_config()

    # ------------------------------------------------------------- config

    def validate_config(self):
        self.model_config = self.model_config_class.model_validate(self.config.model)

    # ------------------------------------------------------------ lifecycle

    def before_setup_model(self):
        pass

    @abstractmethod
    def setup_model(self):
        """Build the model on ``self.device`` (construction initialises)."""

    def after_setup_model(self):
        if self.config.trainer.gradient_checkpointing:
            self.enable_gradient_checkpointing()

    def enable_gradient_checkpointing(self):
        pass

    @abstractmethod
    def sanity_check(self):
        pass

    # ------------------------------------------------------------- training

    @abstractmethod
    def trainable(self) -> nn.Module:
        """The module holding every trainable parameter."""

    @abstractmethod
    def prepare_batch(self, batch: dict) -> dict[str, torch.Tensor]:
        """Host-side batch preparation; tensors on ``self.device``."""

    @abstractmethod
    def draw_randoms(self, batch: dict, generator: torch.Generator) -> dict:
        """The step's random draws (timesteps, noise)."""

    def shard_rows(self, batch: dict, mesh) -> dict:
        """This rank's rows of the prepared batch under ``trainer.mesh``: a
        block of every array's leading axis (``shard_batch``)."""
        return shard_batch(batch, mesh)

    @abstractmethod
    def compute_loss(self, trainable: nn.Module, batch: dict, draws: dict
                     ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """Loss and metrics; the Trainer differentiates the loss."""

    def eval_step(self, batch) -> Any:
        raise NotImplementedError

    def preview_step(self, preview_args, preview_index: int) -> list:
        raise NotImplementedError

    # hooks
    def before_train_step(self):
        self._current_step += 1

    def after_train_step(self):
        self._send_logs_at_step()

    def before_train_epoch(self):
        pass

    def after_train_epoch(self):
        self._send_logs_at_epoch()

    def before_save_model(self):
        pass

    def after_save_model(self):
        pass

    def before_preview(self):
        pass

    def after_preview(self):
        pass

    # ------------------------------------------------------------- saving

    def get_state_dict_to_save(self) -> dict[str, torch.Tensor]:
        if hasattr(self.model, "state_dict"):
            return self.model.state_dict()
        raise NotImplementedError

    def get_metadata_to_save(self) -> dict[str, str]:
        return {}

    def peft_keys_to_paths(self, state_dict: dict) -> dict:
        """An adapter file's keys -> module paths of the trainable (the
        saved layout may rename them)."""
        return state_dict

    # ------------------------------------------------------------- resume

    def get_host_rng_state(self) -> dict:
        """The state of the workload's host-side generators, JSON-able, for
        train-state checkpoints."""
        return {}

    def set_host_rng_state(self, state: dict) -> None:
        pass

    # ------------------------------------------------------------- logging

    def print(self, *args, **kwargs):
        print(*args, **kwargs)

    def log(self, name: str, value, on_step: bool = True, on_epoch: bool = False):
        """Buffer a metric. Device tensors are kept as they are and read only
        when the buffer is flushed: reading one synchronises the card."""
        if on_step:
            self._logs_at_step[name] = value
        if on_epoch:
            self._logs_at_epoch.setdefault(name, []).append(value)

    @staticmethod
    def _to_float(value):
        if isinstance(value, torch.Tensor):
            return float(value.detach().float().mean())
        if isinstance(value, np.ndarray):
            return float(value.mean())
        return value

    def _send_logs_at_step(self):
        if self._logs_at_step:
            fetched = {k: self._to_float(v) for k, v in self._logs_at_step.items()}
            for tracker in self._trackers:
                tracker.log(fetched, step=self._current_step)
        self._logs_at_step = {}

    def _send_logs_at_epoch(self):
        for name, values in self._logs_at_epoch.items():
            values = [self._to_float(v) for v in values]
            if values and isinstance(values[0], (int, float)):
                for tracker in self._trackers:
                    tracker.log({f"{name}_epoch": sum(values) / len(values)},
                                step=self._current_step)
        self._logs_at_epoch = {}
