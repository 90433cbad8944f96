"""When-to-preview policy (the port's own copy of
``vision_pt_tpu/preview/strategy.py``); the same truth table as the saving
strategy."""

from __future__ import annotations

from pydantic import BaseModel


class PreviewStrategyConfig(BaseModel):
    per_epochs: int | float | None = 1
    per_steps: int | None = None


class PreviewStrategy:
    def __init__(
        self,
        total_epochs: int,
        steps_per_epoch: int,
        per_epochs: int | float | None,
        per_steps: int | None,
    ):
        self.per_epochs = per_epochs
        self.per_steps = per_steps
        self._total_epochs = total_epochs
        self._steps_per_epoch = steps_per_epoch
        self.check_strategy()

    @classmethod
    def from_config(
        cls, config: PreviewStrategyConfig, total_epochs: int, steps_per_epoch: int
    ) -> "PreviewStrategy":
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
    def _per_epochs(self) -> int | None:
        if self.per_epochs is None or isinstance(self.per_epochs, float):
            return None
        return self.per_epochs

    @property
    def _per_steps(self) -> int | None:
        if isinstance(self.per_epochs, float):
            return int(self.per_epochs * self._steps_per_epoch)
        return self.per_steps

    def should_preview(self, epoch: int, steps: int) -> bool:
        if epoch == 0 and steps == 0:
            return False
        if self._per_epochs is not None and epoch != 0:
            if steps % (self._steps_per_epoch * self._per_epochs) == 0:
                return True
        if self._per_steps is not None and steps != 0:
            if steps % self._per_steps == 0:
                return True
        return False
