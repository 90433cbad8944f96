"""The port's train-state checkpointing (``training/checkpoint.py`` and the
Trainer's resume, periodic saves and SIGTERM handling), on the CPU, at a
tiny JiT size: the counterpart of ``tests/training/test_checkpoint_resume.py``
and ``tests/training/test_preemption.py``.

A run killed mid-epoch and resumed must give the unbroken run's losses,
parameters and EMA bit for bit: the checkpoint holds the parameters, the
optimizer state, the EMA, the accumulation window, the step, epoch and
generator counters and the workload's host generator (the context drops).
"""

import json
import os
import signal

import numpy as np
import pytest
import torch

from vision_pt_tpu_torch.config import TrainConfig
from vision_pt_tpu_torch.data.square_class_image import SyntheticClassImageDatasetConfig
from vision_pt_tpu_torch.training.checkpoint import TrainStateCheckpointer
from vision_pt_tpu_torch.training.trainer import Trainer
from vision_pt_tpu_torch.workloads.jit_class_to_image import JiTForClassToImageTraining
from tests.test_torch_sdxl_distributed import one_torch_thread  # noqa: F401,E402

TINY = dict(patch_size=8, hidden_size=32, depth=2, num_heads=1, bottleneck_dim=8,
            context_dim=16, context_start_block=1, rope_axes_dims=[8, 12, 12],
            num_time_tokens=2)


def make_trainer(tmp_path, resume=True, epochs=2, per_steps=None, num_items=16,
                 accumulation=1, optimizer="adamw", keep=2, save_dir="ckpt"):
    label2id = tmp_path / "label2id.json"
    label2id.write_text(json.dumps({f"c{i}": i for i in range(4)}))
    config = TrainConfig.model_validate({
        "model": {"context_encoder": {"type": "class",
                                      "label2id_map_path": str(label2id)},
                  "denoiser": TINY, "max_token_length": 4,
                  "drop_context_rate": 0.3},
        "dataset": {"num_classes": 4, "num_items": num_items, "image_size": 16,
                    "batch_size": 4},
        "optimizer": {"name": optimizer, "args": {"lr": 1e-3}},
        "scheduler": {"name": "cosine", "args": {"num_warmup_steps": 2}},
        "saving": None,
        "seed": 0,
        "num_train_epochs": epochs,
        "trainer": {"use_ema": True, "ema_decay": 0.9, "clip_grad_norm": 1.0,
                    "gradient_accumulation_steps": accumulation,
                    "checkpointing": {"save_dir": str(tmp_path / save_dir),
                                      "per_steps": per_steps, "resume": resume,
                                      "keep": keep}},
    })
    trainer = Trainer(config, device="cpu")
    trainer.register_train_dataset_class(SyntheticClassImageDatasetConfig)
    trainer.register_model_class(JiTForClassToImageTraining)
    trainer.before_train()
    return trainer


def record_losses(trainer) -> list[float]:
    losses = []
    inner = trainer.train_step

    def recording(*args, **kwargs):
        loss, metrics = inner(*args, **kwargs)
        losses.append(float(loss))
        return loss, metrics

    trainer.train_step = recording
    return losses


def sigterm_before_step(trainer, step: int):
    """Deliver a real SIGTERM while step ``step`` (1-based) is prepared; the
    step still completes."""
    inner = trainer.model.prepare_batch

    def prepare_and_preempt(batch):
        if trainer.global_step == step - 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return inner(batch)

    trainer.model.prepare_batch = prepare_and_preempt


def state(trainer):
    return ({k: v.detach().clone() for k, v in trainer.model.trainable().state_dict().items()},
            {k: v.clone() for k, v in trainer.ema_state.items()})


@pytest.mark.parametrize("accumulation,killed_at", [(1, 3), (2, 3)])
@pytest.mark.parametrize("optimizer", ["adamw", "bitsandbytes.optim.AdamW8bit",
                                       "schedulefree.RAdamScheduleFree"])
def test_killed_run_resumes_to_the_unbroken_loss_curve(tmp_path, accumulation,
                                                       killed_at, optimizer):
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    unbroken = make_trainer(tmp_path / "a", accumulation=accumulation,
                            optimizer=optimizer)
    losses = record_losses(unbroken)
    unbroken.training_loop()
    assert unbroken.global_step == 8 and len(losses) == 8

    killed = make_trainer(tmp_path / "b", accumulation=accumulation,
                          optimizer=optimizer)
    first = record_losses(killed)
    sigterm_before_step(killed, killed_at)
    killed.training_loop()  # returns after the step that saw the signal
    assert killed._preempted and killed.global_step == killed_at
    assert killed.checkpointer.latest_step() == killed_at
    assert signal.getsignal(signal.SIGTERM) in (signal.SIG_DFL,
                                                signal.Handlers.SIG_DFL)

    resumed = make_trainer(tmp_path / "b", accumulation=accumulation,
                           optimizer=optimizer)
    assert (resumed.global_step, resumed.current_epoch) == (killed_at, 0)
    rest = record_losses(resumed)
    resumed.training_loop()
    assert first + rest == losses  # bit for bit
    ours, theirs = state(resumed), state(unbroken)
    for a, b in zip(ours, theirs):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_sigterm_on_a_periodic_save_step_saves_once(tmp_path):
    trainer = make_trainer(tmp_path, per_steps=2, epochs=5)
    sigterm_before_step(trainer, 2)
    trainer.training_loop()
    assert trainer._preempted and trainer.global_step == 2
    assert trainer.checkpointer.all_steps() == [2]
    assert make_trainer(tmp_path, per_steps=2, epochs=5).global_step == 2


def test_sigterm_during_epoch_teardown_still_checkpoints(tmp_path):
    trainer = make_trainer(tmp_path, epochs=1)
    inner = trainer.model.after_train_epoch

    def after_and_preempt():
        os.kill(os.getpid(), signal.SIGTERM)
        return inner()

    trainer.model.after_train_epoch = after_and_preempt
    trainer.training_loop()
    assert trainer._preempted and trainer.global_step == 4
    assert trainer.checkpointer.latest_step() == 4


def test_sigterm_without_checkpointer_stops_without_saving(tmp_path):
    trainer = make_trainer(tmp_path, epochs=5)
    trainer.checkpointer = None
    sigterm_before_step(trainer, 2)
    trainer.training_loop()
    assert trainer._preempted and trainer.global_step == 2
    assert not any((tmp_path / "ckpt").iterdir())


def test_periodic_saves_keep_the_newest(tmp_path):
    trainer = make_trainer(tmp_path, per_steps=1, keep=3)
    trainer.training_loop()
    assert trainer.checkpointer.all_steps() == [6, 7, 8]
    names = sorted(p.name for p in (tmp_path / "ckpt").iterdir())
    assert names == ["step_00000006", "step_00000007", "step_00000008"]


def test_resume_false_starts_over(tmp_path):
    make_trainer(tmp_path, per_steps=2).training_loop()
    fresh = make_trainer(tmp_path, resume=False)
    assert fresh.global_step == 0 and fresh._key_counter == 0


def test_saving_a_step_twice_does_nothing(tmp_path):
    trainer = make_trainer(tmp_path)
    trainer.save_train_state()
    path = tmp_path / "ckpt" / "step_00000000"
    before = (path / "state.pt").stat().st_mtime_ns
    with torch.no_grad():
        next(trainer.model.trainable().parameters()).add_(1.0)
    trainer.save_train_state()
    assert (path / "state.pt").stat().st_mtime_ns == before
    assert trainer.checkpointer.all_steps() == [0]


def test_an_interrupted_save_leaves_no_step(tmp_path, monkeypatch):
    trainer = make_trainer(tmp_path)

    def failing_save(obj, path):
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", failing_save)
    with pytest.raises(OSError):
        trainer.save_train_state()
    assert trainer.checkpointer.latest_step() is None
    monkeypatch.undo()
    trainer.save_train_state()
    assert trainer.checkpointer.all_steps() == [0]


def test_restore_round_trips_every_tensor(tmp_path):
    trainer = make_trainer(tmp_path)
    batch = trainer.model.prepare_batch(next(iter(trainer.train_dataset)))
    trainer.train_step(batch, trainer._next_generator())
    trainer.global_step = 1
    trainer.save_train_state()
    params, ema = state(trainer)
    other = make_trainer(tmp_path)
    assert other.global_step == 1 and other._key_counter == 1 and other._updates == 1
    ours, _ = state(other)
    assert all(torch.equal(params[k], ours[k]) for k in params)
    assert all(torch.equal(ema[k], other.ema_state[k]) for k in ema)
    for p, q in zip(trainer._params, other._params):
        for key, value in trainer.optimizer.state[p].items():
            restored = other.optimizer.state[q][key]
            assert torch.equal(torch.as_tensor(restored), torch.as_tensor(value))
    assert (other.model.get_host_rng_state() == trainer.model.get_host_rng_state())
    with pytest.raises(FileNotFoundError):
        TrainStateCheckpointer(str(tmp_path / "empty")).restore(
            trainer.model.trainable(), trainer.optimizer)
    np.testing.assert_equal(trainer.checkpointer.all_steps(), [1])


def make_lora_trainer(tmp_path):
    """The tiny SDXL LoRA trainer of ``test_torch_sdxl_training`` (2 images,
    2 repeats, batch 2, 2 epochs: 4 steps) with train-state checkpointing."""
    import yaml

    from tests.test_torch_sdxl_training import write_config
    from vision_pt_tpu_torch.data.text_to_image import TextToImageDatasetConfig
    from vision_pt_tpu_torch.workloads.sdxl_text_to_image import (
        SDXLForTextToImageTraining,
    )

    path = write_config(tmp_path, "configs/sdxl/text_to_image_lora.yml",
                        checkpointing={"save_dir": str(tmp_path / "ckpt")})
    cfg = yaml.safe_load(path.read_text())
    cfg.update(saving=None, preview=None, tracker=None, num_train_epochs=2)
    trainer = Trainer(TrainConfig.model_validate(cfg), device="cpu")
    trainer.register_train_dataset_class(TextToImageDatasetConfig)
    trainer.register_model_class(SDXLForTextToImageTraining)
    trainer.before_train()
    return trainer


def test_lora_trainer_resumes_and_only_the_adapters_move(tmp_path):
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    unbroken = make_lora_trainer(tmp_path / "a")
    initial = {k: v.clone() for k, v in unbroken.model.trainable().state_dict().items()}
    losses = record_losses(unbroken)
    unbroken.training_loop()
    assert unbroken.global_step == 4

    killed = make_lora_trainer(tmp_path / "b")
    first = record_losses(killed)
    sigterm_before_step(killed, 2)
    killed.training_loop()
    assert killed.global_step == 2 and killed.checkpointer.all_steps() == [2]
    resumed = make_lora_trainer(tmp_path / "b")
    rest = record_losses(resumed)
    resumed.training_loop()
    assert first + rest == losses

    final = resumed.model.trainable().state_dict()
    moved = {k for k in final if not torch.equal(final[k], initial[k])}
    assert moved and all(".lora_" in k for k in moved)
    assert all(".lora_" in n for n, p in resumed.model.trainable().named_parameters()
               if p.requires_grad)
    assert len(resumed.optimizer.state) == len(resumed._params) == 2 * 70
    expected = unbroken.model.trainable().state_dict()
    assert all(torch.equal(final[k], expected[k]) for k in final)
