"""When-to-save policy (the port's own copy of
``vision_pt_tpu/saving/strategy.py``).

``per_epochs`` may be an int (every N epochs), a float < 1 (a fraction of an
epoch, i.e. multiple times per epoch), or None; ``per_steps`` saves every N
steps.
"""

from __future__ import annotations

from pydantic import BaseModel


class ModelSavingStrategyConfig(BaseModel):
    per_epochs: int | float | None = 1
    per_steps: int | None = None
    save_last: bool = True


class ModelSavingStrategy:
    def __init__(
        self,
        total_epochs: int,
        steps_per_epoch: int,
        per_epochs: int | float | None,
        per_steps: int | None,
        save_last: bool = True,
    ):
        self.per_epochs = per_epochs
        self.per_steps = per_steps
        self.save_last = save_last
        self._total_epochs = total_epochs
        self._steps_per_epoch = steps_per_epoch
        self.check_strategy()

    @classmethod
    def from_config(
        cls,
        config: ModelSavingStrategyConfig,
        total_epochs: int,
        steps_per_epoch: int,
    ) -> "ModelSavingStrategy":
        return cls(
            total_epochs=total_epochs,
            steps_per_epoch=steps_per_epoch,
            **config.model_dump(),
        )

    @property
    def _total_steps(self) -> int:
        return self._total_epochs * self._steps_per_epoch

    def check_strategy(self) -> bool:
        if self.per_epochs is None and self.per_steps is None:
            return True
        if self.per_epochs is not None:
            if self.per_epochs <= 0:
                raise ValueError("per_epochs must be greater than 0")
            if isinstance(self.per_epochs, float):
                if self.per_epochs >= 1:
                    raise ValueError("per_epochs must be less than 1 if float")
                if self.per_steps is not None:
                    raise ValueError(
                        "per_epochs and per_steps cannot be set together"
                    )
            elif self.per_epochs > self._total_epochs:
                raise ValueError("per_epochs must be <= total_epochs")
        if self.per_steps is not None:
            if self.per_steps <= 0:
                raise ValueError("per_steps must be greater than 0")
            if self.per_steps > self._total_steps:
                raise ValueError("per_steps must be <= total_steps")
        return True

    @property
    def _per_steps(self) -> int | None:
        if isinstance(self.per_epochs, float):
            return int(self.per_epochs * self._steps_per_epoch)
        return self.per_steps

    def should_save(self, epoch: int, steps: int) -> bool:
        if epoch == 0 and steps == 0:
            return False
        if (
            self.per_epochs is not None
            and not isinstance(self.per_epochs, float)
            and epoch != 0
        ):
            if steps % (self._steps_per_epoch * self.per_epochs) == 0:
                return True
        if self._per_steps is not None and steps != 0:
            if steps % self._per_steps == 0:
                return True
        return False
