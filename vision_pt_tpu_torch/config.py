"""Train configuration schema (the port's own copy of
``vision_pt_tpu/config.py``).

Pydantic v2 with two-stage validation: ``TrainConfig.model`` and
``.dataset`` are plain dicts, validated later by the workload's model config
class and the dataset config class, so one Trainer serves every workload. The
same YAML files load in both packages.
"""

from __future__ import annotations

from pathlib import Path
from typing import Literal

import yaml
from pydantic import BaseModel

from .data import PreviewDatasetAlias
from .preview import LocalPreviewCallbackConfig, PreviewCallbackConfigAlias
from .preview import PreviewStrategyConfig
from .saving import (
    ModelSavingCallbackConfigAlias,
    ModelSavingStrategyConfig,
    SafetensorsSavingCallbackConfig,
)


class OptimizerConfig(BaseModel):
    name: str = "adamw"
    args: dict = {"lr": 1e-3}


class SchedulerConfig(BaseModel):
    name: str = "constant"
    args: dict = {}


class SavingConfig(BaseModel):
    strategy: ModelSavingStrategyConfig = ModelSavingStrategyConfig()
    callbacks: list[ModelSavingCallbackConfigAlias] = [
        SafetensorsSavingCallbackConfig(name="model", save_dir="./output")
    ]
    rename_key_map: dict[str, str] = {}


class PreviewConfig(BaseModel):
    strategy: PreviewStrategyConfig = PreviewStrategyConfig()
    callbacks: list[PreviewCallbackConfigAlias] = [
        LocalPreviewCallbackConfig(save_dir="./output/preview")
    ]
    data: PreviewDatasetAlias


class TrackerConfig(BaseModel):
    project_name: str
    loggers: list[Literal["wandb", "tensorboard", "jsonl"]]
    log_dir: str = "./output/logs"


DEBUG_MODE_TYPE = Literal[False, "sanity_check", "1step", "dataset"]


class CheckpointingConfig(BaseModel):
    """Full train-state checkpoints under ``save_dir`` every ``per_steps``
    steps (and on SIGTERM and at the end), the newest ``keep`` kept; with
    ``resume`` a run continues from the newest."""

    save_dir: str | None = None
    per_steps: int | None = None
    keep: int = 2
    resume: bool = True


class TrainerConfig(BaseModel):
    debug_mode: DEBUG_MODE_TYPE = False

    # accepted for config compatibility; the port runs eagerly
    torch_compile: bool = False
    torch_compile_args: dict = {}

    gradient_checkpointing: bool = False
    gradient_accumulation_steps: int = 1

    clip_grad_norm: float | None = None
    clip_grad_value: float | None = None

    # torch.set_float32_matmul_precision; None leaves torch's setting alone
    fp32_matmul_precision: Literal["highest", "high", "medium"] | None = None
    allow_tf32: bool = False  # True lets fp32 matmuls on the card use TF32
    # torch.use_deterministic_algorithms (warn-only) while ``train`` runs:
    # ops with an atomic-add backward (an embedding's, an index's) sum in a
    # fixed order, so two runs of one config give the same bits
    deterministic: bool = False

    use_ema: bool = False
    ema_decay: float = 0.9999

    # multi-device layout (parallel.mesh.MeshConfig) and process-group setup
    mesh: dict | None = None
    distributed_init: bool = False

    checkpointing: CheckpointingConfig = CheckpointingConfig()

    # flush metrics every N steps; reading device scalars synchronises the
    # card, so raising this lets the host run ahead
    log_every_n_steps: int = 1

    debug_nans: bool = False  # anomaly detection in the backward
    profile_dir: str | None = None  # a chrome trace per rank of the profiled steps
    profile_steps: int = 5


class TrainConfig(BaseModel):
    model: dict | BaseModel
    dataset: dict | BaseModel
    peft: dict | list[dict] | None = None

    optimizer: OptimizerConfig = OptimizerConfig()
    scheduler: SchedulerConfig | None = None
    saving: SavingConfig | None = SavingConfig()
    preview: PreviewConfig | None = None
    tracker: TrackerConfig | None = None
    trainer: TrainerConfig = TrainerConfig()

    seed: int = 42
    num_train_epochs: int = 1

    def to_dict(self) -> dict:
        return self.model_dump()

    def save_to(self, dir: Path | str, filename: str = "config.yaml"):
        dir = Path(dir)
        dir.mkdir(parents=True, exist_ok=True)
        with open(dir / filename, "w") as f:
            yaml.dump(self.to_dict(), f)

    @staticmethod
    def from_config_file(path: str) -> "TrainConfig":
        with open(path) as f:
            config = yaml.safe_load(f)
        return TrainConfig.model_validate(config, strict=True)
