"""Trainer: the epoch/step loop with gradient accumulation, clipping, EMA,
saving, previews and trackers (port of ``vision_pt_tpu/training/trainer.py``).

The update matches the JAX package's optax chain step for step:
- ``gradient_accumulation_steps`` k is ``optax.MultiSteps``: the running mean
  of k micro-step gradients is applied at every k-th micro-step, and the
  parameters stay as they are in between;
- ``clip_grad_value`` clips each element, ``clip_grad_norm`` scales the
  gradient by ``c / max(|g|, c)`` (optax's formula, not ``clip_grad_norm_``'s
  ``c / (|g| + 1e-6)``), both on the averaged gradient;
- the learning rate of update n is ``schedule(n - 1)`` (optax's count);
- the EMA advances only at accumulation boundaries;
- ``grad_norm`` is the global norm of the micro-step gradient, before
  clipping.
Each step's random draws come from a ``torch.Generator`` seeded from
(``seed``, step counter), so a resumed run draws what an unbroken one does.
Under PEFT the optimizer takes the adapters only, every other parameter
frozen. Schedule-free optimizers train on y; previews and saves see the x
parameters (``eval_params``), swapped in and back. Train-state checkpoints
(``trainer.checkpointing``) hold the trainable, the optimizer, the EMA, the
accumulation window, the step, epoch and generator counters and the
workload's host generators; SIGTERM finishes the current step, saves and
stops.

Multi-device runs (``trainer.mesh``, ``trainer.distributed_init``) compute
the one-device step: every rank reads the whole batch and draws the whole
batch's timesteps and noise from the trainer's generator, then takes its
rows (``shard_batch`` over data x fsdp; a draw for the whole batch, the
workload's ``mesh_whole_draws``, stays whole); the model is placed by
``parallel.shard_module``; a seq axis puts self-attention on the ring for
the step. Rank 0 alone writes trackers, saved models, previews and train
states, between barriers; saved tensors are gathered whole first.
``trainer.profile_dir`` traces steps [1, 1 + ``profile_steps``) with
``torch.profiler``, one chrome trace per rank. ``trainer.deterministic``
(the port's own) runs the loop under torch's deterministic algorithms.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import signal
import time
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from tqdm import tqdm

from ..config import TrainConfig
from ..data.bucket import prefetch_iterator
from ..parallel.mesh import (
    batch_mean,
    flax_perms,
    full_parameters,
    global_norm,
    make_mesh,
    reduce_replicated_grads,
    reshard,
    shard_batch,
    shard_module,
)
from ..preview import PreviewStrategy, get_preview_callback
from ..saving import ModelSavingStrategy, get_saving_callback
from ..utils import resolve_device
from ..utils.logging import get_trackers
from . import ema as ema_lib
from .checkpoint import TrainStateCheckpointer
from .model import ModelForTraining
from .optimizer import get_optimizer, is_schedule_free, resolve_name
from .scheduler import get_lr_schedule


def initialize_distributed(device: torch.device) -> torch.device:
    """The process group from the ``torchrun`` environment (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK): NCCL on
    ``cuda:LOCAL_RANK`` for a CUDA device, gloo on the CPU; raises when the
    group cannot be built. Returns the device this rank trains on."""
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        if device.type == "cuda":
            dist.init_process_group("nccl", device_id=device)
        else:
            dist.init_process_group("gloo")
    print(f"[distributed] {dist.get_backend()} group: rank {dist.get_rank()} of "
          f"{dist.get_world_size()}, device {device}", flush=True)
    return device


def is_main_process() -> bool:
    """True on the rank that owns saving, preview and tracker output."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier(name: str) -> None:
    """Every rank waits here (around rank 0's writes); ``name`` says which."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


class Trainer:
    """Runs a registered workload: on CUDA unless ``device`` says otherwise
    (the tests pass ``device="cpu"``), on one device or, with
    ``trainer.mesh``, on every rank of the process group."""

    def __init__(self, config: TrainConfig,
                 device: str | torch.device | None = None):
        self.config = config
        self.device = resolve_device(device)
        tcfg = config.trainer
        if tcfg.distributed_init:
            self.device = initialize_distributed(self.device)
        self._configure_precision()
        self.mesh = None
        if tcfg.mesh is not None:
            self.mesh = make_mesh(tcfg.mesh)

        self.model: ModelForTraining | None = None
        self.model_class: type[ModelForTraining] | None = None
        self.train_dataset = None
        self.train_dataset_class = None
        self.preview_dataset_class = None

        self.optimizer: torch.optim.Optimizer | None = None
        self.lr_schedule: Callable[[int], float] | None = None
        self.ema_state: dict[str, torch.Tensor] | None = None
        # one writer: the other ranks keep no trackers
        self.trackers = get_trackers(config.tracker) if is_main_process() else []

        self.saving_strategy = None
        self.saving_callbacks = []
        self.preview_strategy = None
        self.preview_callbacks = []

        self.global_step = 0
        self.current_epoch = 0
        self._key_counter = 0
        self._updates = 0  # optimizer updates applied: the schedule's count
        self._mini_step = 0
        self._acc: list[torch.Tensor] | None = None
        self._schedule_free = False
        self.checkpointer: TrainStateCheckpointer | None = None
        self._preempted = False
        self._profiler = None

    # ------------------------------------------------------------ setup

    def _configure_precision(self):
        tcfg = self.config.trainer
        if tcfg.fp32_matmul_precision is not None:
            torch.set_float32_matmul_precision(tcfg.fp32_matmul_precision)
        if tcfg.allow_tf32:
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True

    def register_train_dataset_class(self, dataset_config_class):
        self.train_dataset_class = dataset_config_class

    def register_preview_dataset_class(self, dataset_config_class):
        self.preview_dataset_class = dataset_config_class

    def register_model_class(self, model_class: type[ModelForTraining]):
        self.model_class = model_class
        self.model = model_class(self.config, self.device)
        self.model._trackers = self.trackers

    def prepare_dataloaders(self):
        if self.train_dataset_class is None:
            raise RuntimeError("register_train_dataset_class first")
        dataset_config = self.train_dataset_class.model_validate(self.config.dataset)
        self.train_dataset = dataset_config.get_dataset()
        # every rank reads the whole batch and takes its rows in the step
        # (the JAX package strides hosts over the batch order instead)
        if self.mesh is not None and hasattr(self.train_dataset, "host_index"):
            self.train_dataset.host_index, self.train_dataset.host_count = 0, 1
        self.steps_per_epoch = len(self.train_dataset)
        self.preview_args = []
        if self.config.preview is not None:
            self.preview_args = self.config.preview.data.get_preview_args()

    def prepare_model(self):
        if self.model is None:
            raise RuntimeError("register_model_class first")
        if self.mesh is not None:
            self._check_mesh_support()
            self.model.mesh = self.mesh
        self.model.before_setup_model()
        self.model.setup_model()
        self.setup_peft_if_needed()
        self.model.after_setup_model()
        if self.mesh is not None:
            shard_module(self.model.trainable(), self.mesh)

    def _peft_targets(self) -> list:
        from ..peft import PeftTargetConfig

        raw = self.config.peft
        if raw is None:
            return []
        return [PeftTargetConfig.model_validate(t)
                for t in (raw if isinstance(raw, list) else [raw])]

    def _check_mesh_support(self):
        """Refuse, before any surgery, what the mesh path does not hold
        against one device: a workload with no ``mesh_draws``, an axis
        outside its ``mesh_axes``."""
        name = type(self.model).__name__
        if self.model.mesh_draws is None:
            raise NotImplementedError(f"{name} under trainer.mesh is not ported: "
                                      "ROADMAP Queue 1 item 5")
        for axis in ("tensor", "seq"):
            if self.mesh[axis].size() > 1 and axis not in self.model.mesh_axes:
                raise NotImplementedError(
                    f"the {axis} axis of trainer.mesh for {name} is not ported: "
                    "ROADMAP Queue 1 item 5")

    def setup_peft_if_needed(self):
        """Adapter surgery on the trainable, optional adapter weights to
        resume from, and every other parameter frozen."""
        if self.config.peft is None:
            return
        from safetensors.torch import load_file

        from ..peft import (
            freeze_all_but_adapters,
            load_peft_weight,
            print_trainable_parameters,
            replace_to_peft_layer,
        )

        trainable = self.model.trainable()
        for target in self._peft_targets():
            replaced = replace_to_peft_layer(trainable, target.include_keys,
                                             target.exclude_keys, target.config,
                                             seed=self.config.seed)
            print(f"[peft] replaced {len(replaced)} layers ({target.config.type})")
            if target.resume_weight_path:
                sd = load_file(target.resume_weight_path)
                for old, new in target.resume_rename_key_map.items():
                    sd = {k.replace(old, new): v for k, v in sd.items()}
                loaded = load_peft_weight(trainable, self.model.peft_keys_to_paths(sd))
                print(f"[peft] resumed {len(loaded)} layers from "
                      f"{target.resume_weight_path}")
        freeze_all_but_adapters(trainable)
        self.model._is_peft = True
        print_trainable_parameters(trainable)

    def prepare_optimizer(self):
        cfg = self.config
        args = cfg.optimizer.args
        base_lr = args.get("lr", args.get("learning_rate", 1e-3))
        self.lr_schedule = get_lr_schedule(
            base_lr,
            cfg.scheduler.name if cfg.scheduler else None,
            cfg.scheduler.args if cfg.scheduler else None,
            total_steps=self.steps_per_epoch * cfg.num_train_epochs,
        )
        trainable = self.model.trainable()
        self._params = [p for p in trainable.parameters() if p.requires_grad]
        opt_args = {k: v for k, v in args.items() if k not in ("lr", "learning_rate")}
        if self.mesh is not None:
            name = resolve_name(cfg.optimizer.name)
            if name in ("adamw", "adam", "sgd") and any(isinstance(p, DTensor)
                                                       for p in self._params):
                # torch's: one parameter at a time, the foreach kernels take
                # no mix of sharded and whole parameters
                opt_args["foreach"] = False
        # schedule-free takes the schedule itself (optax's two counts)
        self._schedule_free = is_schedule_free(cfg.optimizer.name)
        self.optimizer = get_optimizer(
            cfg.optimizer.name, self._params, opt_args, lr=self.lr_schedule(0),
            lr_schedule=self.lr_schedule if self._schedule_free else None,
            layouts=flax_perms(trainable))
        if cfg.trainer.use_ema:
            self.ema_state = ema_lib.init_ema(trainable)

    def prepare_saving_strategy(self):
        if self.config.saving is None:
            return
        self.saving_strategy = ModelSavingStrategy.from_config(
            self.config.saving.strategy,
            total_epochs=self.config.num_train_epochs,
            steps_per_epoch=self.steps_per_epoch,
        )
        self.saving_callbacks = [
            get_saving_callback(c) for c in self.config.saving.callbacks
        ]

    def prepare_preview_strategy(self):
        if self.config.preview is None:
            return
        self.preview_strategy = PreviewStrategy.from_config(
            self.config.preview.strategy,
            total_epochs=self.config.num_train_epochs,
            steps_per_epoch=self.steps_per_epoch,
        )
        self.preview_callbacks = [
            get_preview_callback(c) for c in self.config.preview.callbacks
        ]

    def before_train(self):
        if self.config.trainer.debug_nans:
            torch.autograd.set_detect_anomaly(True)
        self.prepare_dataloaders()
        self.prepare_model()
        self.prepare_saving_strategy()
        self.prepare_preview_strategy()
        self.prepare_optimizer()
        self.prepare_checkpointing()

    # ------------------------------------------------------------ train state

    def prepare_checkpointing(self):
        """Open the checkpoint directory and, with ``resume``, continue from
        its latest step."""
        ckpt_cfg = self.config.trainer.checkpointing
        if ckpt_cfg.save_dir is None:
            return
        self.checkpointer = TrainStateCheckpointer(ckpt_cfg.save_dir, keep=ckpt_cfg.keep)
        if not ckpt_cfg.resume or self.checkpointer.latest_step() is None:
            return
        meta = self.checkpointer.restore(self.model.trainable(), self.optimizer)
        if meta["_ema"] is not None:
            self.ema_state = meta["_ema"]
        self._acc = meta["_extra"].get("accumulation")
        self.global_step = int(meta["global_step"])
        self.current_epoch = int(meta["epoch"])
        self._key_counter = int(meta["key_counter"])
        self._updates = int(meta["updates"])
        self._mini_step = int(meta["mini_step"])
        self.model.set_host_rng_state(meta["host_rng"])
        if hasattr(self.train_dataset, "set_epoch"):
            self.train_dataset.set_epoch(self.current_epoch)
        print(f"[checkpoint] resumed from step {self.global_step}")

    def save_train_state(self):
        """Checkpoint the whole train state at the current step (nothing if
        that step is saved already)."""
        if self.checkpointer is None:
            return
        path = self.checkpointer.save(
            self.global_step, self.model.trainable(), self.optimizer, self.ema_state,
            metadata={"global_step": self.global_step, "epoch": self.current_epoch,
                      "key_counter": self._key_counter, "updates": self._updates,
                      "mini_step": self._mini_step,
                      "host_rng": self.model.get_host_rng_state()},
            extra={"accumulation": self._acc},
            write=is_main_process(),
        )
        barrier("save_train_state")
        if path is not None:
            print(f"[checkpoint] wrote {path}")

    def _install_preemption_handler(self) -> Callable[[], None]:
        """SIGTERM -> finish the current step, save the train state, leave
        the loop. Returns the function that puts the previous handler back."""
        try:
            prev = signal.getsignal(signal.SIGTERM)

            def handler(signum, frame):
                self._preempted = True
                print("[preemption] SIGTERM received: will checkpoint and stop "
                      "after the current step", flush=True)

            signal.signal(signal.SIGTERM, handler)
            return lambda: signal.signal(signal.SIGTERM, prev)
        except ValueError:  # not the main thread
            return lambda: None

    def _handle_preemption(self) -> bool:
        """Save and stop if a SIGTERM arrived; True means stop."""
        if not self._preempted:
            return False
        if self.checkpointer is not None:
            self.save_train_state()
            print(f"[preemption] train state saved at step {self.global_step}; "
                  "resume with trainer.checkpointing.resume=true", flush=True)
        else:
            print("[preemption] no checkpointer configured: stopping without "
                  "saving train state", flush=True)
        return True

    # ------------------------------------------------------------ step

    def _next_generator(self) -> torch.Generator:
        """Counter-derived generators: step n draws the same numbers in every
        run with the same seed."""
        self._key_counter += 1
        seed = np.random.SeedSequence((self.config.seed, self._key_counter))
        return torch.Generator(device=self.device).manual_seed(
            int(seed.generate_state(1, np.uint64)[0] >> np.uint64(1))
        )

    def _apply_update(self, grads: list[torch.Tensor]):
        tcfg = self.config.trainer
        if tcfg.clip_grad_value is not None:
            c = tcfg.clip_grad_value
            grads = [g.clamp(-c, c) for g in grads]
        if tcfg.clip_grad_norm is not None:
            c = tcfg.clip_grad_norm
            scale = c / torch.clamp_min(global_norm(grads), c)
            grads = [g * scale.to(g.dtype) for g in grads]
        for p, g in zip(self._params, grads):
            p.grad = g
        if not self._schedule_free:
            lr = float(self.lr_schedule(self._updates))
            for group in self.optimizer.param_groups:
                group["lr"] = lr
        self.optimizer.step()
        self._updates += 1

    def _seq_parallel_scope(self):
        """Ring-attention dispatch around a step when the mesh's seq axis has
        more than one rank."""
        if self.mesh is not None and self.mesh["seq"].size() > 1:
            from ..ops.attention import sequence_parallel

            return sequence_parallel(self.mesh)
        return contextlib.nullcontext()

    def _local_rows(self, batch: dict, draws: dict) -> tuple[dict, dict]:
        """This rank's rows of the batch and of the per-sample draws; the
        workload's whole draws stay whole."""
        whole = set(self.model.mesh_whole_draws)
        other = set(draws) - set(self.model.mesh_draws) - whole
        if other:
            raise NotImplementedError(
                f"draws {sorted(other)} under trainer.mesh are not ported: "
                "ROADMAP Queue 1 item 5")
        return self.model.shard_rows(batch, self.mesh), {
            k: v if k in whole else shard_batch(v, self.mesh) for k, v in draws.items()}

    def train_step(self, batch: dict, generator: torch.Generator,
                   at_accum_boundary: bool = True):
        """One micro-step: draws, loss, backward, and the update when the
        accumulation window closes. Returns the loss and the metrics (under
        a mesh, their means over the batch ranks)."""
        trainable = self.model.trainable()
        draws = self.model.draw_randoms(batch, generator)
        if self.mesh is not None:
            batch, draws = self._local_rows(batch, draws)
        with self._seq_parallel_scope():
            loss, metrics = self.model.compute_loss(trainable, batch, draws)
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        metrics = dict(metrics)
        if self.mesh is not None:
            reduce_replicated_grads(trainable)
            names = [k for k, v in metrics.items()
                     if isinstance(v, torch.Tensor) and v.dim() == 0]
            loss, *values = batch_mean([loss, *(metrics[k] for k in names)], self.mesh)
            metrics.update(zip(names, values))
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self._params]
        metrics["grad_norm"] = global_norm(grads)
        accum = self.config.trainer.gradient_accumulation_steps
        if accum > 1:
            # optax.MultiSteps: a running mean of the micro-step gradients
            if self._acc is None:
                self._acc = [torch.zeros_like(p) for p in self._params]
            n = self._mini_step
            for a, g in zip(self._acc, grads):
                a.add_((g - a) / (n + 1))
            self._mini_step = (n + 1) % accum
            if self._mini_step == 0:
                self._apply_update(self._acc)
                self._acc = None
        else:
            self._apply_update(grads)
        if self.ema_state is not None and at_accum_boundary:
            ema_lib.update_ema(self.ema_state, trainable,
                               self.config.trainer.ema_decay)
        return loss.detach(), metrics

    # ------------------------------------------------------------ loop

    def training_loop(self):
        cfg = self.config
        debug = cfg.trainer.debug_mode
        if debug == "dataset":
            for i, batch in enumerate(self.train_dataset):
                print(f"batch {i}: " + ", ".join(
                    f"{k}={getattr(v, 'shape', type(v).__name__)}"
                    for k, v in batch.items()
                ))
            return
        # a global_step set before the loop resumes mid-run: finished epochs
        # are skipped, then the trained batches of the current one
        start_epoch = skip_steps = 0
        if self.global_step and self.steps_per_epoch:
            start_epoch = min(self.global_step // self.steps_per_epoch,
                              cfg.num_train_epochs)
            skip_steps = self.global_step - start_epoch * self.steps_per_epoch
        total = self.steps_per_epoch * (cfg.num_train_epochs - start_epoch)
        pbar = tqdm(total=total, desc="train", initial=skip_steps,
                    disable=not is_main_process())
        self._preempted = False
        restore_sigterm = self._install_preemption_handler()
        try:
            completed = self._training_epochs(cfg, debug, start_epoch, skip_steps,
                                              pbar)
            if completed:  # a SIGTERM after the last step's check
                self._handle_preemption()
        finally:
            restore_sigterm()
            self._stop_profile()
        if not completed:
            return
        pbar.close()
        self.save_train_state()  # the last step, so the run can be extended
        if self.saving_strategy is not None and self.saving_strategy.save_last:
            self._save_model(self.current_epoch + 1, self.global_step)

    def _training_epochs(self, cfg, debug, start_epoch, skip_steps, pbar) -> bool:
        for epoch in range(start_epoch, cfg.num_train_epochs):
            self.current_epoch = epoch
            if hasattr(self.train_dataset, "set_epoch"):
                self.train_dataset.set_epoch(epoch)
            self.model.before_train_epoch()
            if skip_steps and hasattr(self.train_dataset, "iter_from"):
                epoch_iter = self.train_dataset.iter_from(skip_steps)
            else:
                epoch_iter = itertools.islice(iter(self.train_dataset),
                                              skip_steps, None)
            skip_steps = 0

            for batch in prefetch_iterator(epoch_iter):
                self.model.before_train_step()
                self._maybe_profile()
                step_t0 = time.perf_counter()
                generator = self._next_generator()
                arrays = self.model.prepare_batch(batch)
                # the EMA tracks optimizer updates, not micro-steps
                accum = cfg.trainer.gradient_accumulation_steps
                at_boundary = accum <= 1 or (self.global_step + 1) % accum == 0
                loss, metrics = self.train_step(arrays, generator,
                                                at_accum_boundary=at_boundary)
                self.global_step += 1
                if self.global_step >= 1 + cfg.trainer.profile_steps:
                    self._stop_profile()  # the trace holds the steps alone

                self.model.log("train/loss", loss, on_step=True, on_epoch=True)
                self.model.log("train/step_time", time.perf_counter() - step_t0,
                               on_step=True)
                for name, value in metrics.items():
                    self.model.log(f"train/{name}", value, on_step=True)
                self.model.log("train/lr", float(self.lr_schedule(self.global_step)))
                pbar.update()
                # flushing reads device scalars (a synchronisation)
                if self.global_step % cfg.trainer.log_every_n_steps == 0:
                    self.model.after_train_step()
                    pbar.set_postfix(loss=float(loss))

                self.call_saving_callbacks()
                self.call_preview_callbacks()
                per_steps = cfg.trainer.checkpointing.per_steps
                if per_steps and self.global_step % per_steps == 0:
                    self.save_train_state()
                if debug == "1step":
                    print("debug_mode=1step: stopping after one step")
                    return False
                if self._handle_preemption():
                    return False
            self.model.after_train_epoch()
        return True

    def _maybe_profile(self):
        """``torch.profiler`` over steps [1, 1 + profile_steps) when
        ``profile_dir`` is set (step 0 holds the first calls' set-up), stopped
        right after the last of them, before any save or preview; on the
        card the trace holds the device's kernels."""
        cfg = self.config.trainer
        if cfg.profile_dir is not None and self.global_step == 1 and self._profiler is None:
            from torch.profiler import ProfilerActivity, profile

            activity = (ProfilerActivity.CUDA if self.device.type == "cuda"
                        else ProfilerActivity.CPU)
            self._profiler = profile(activities=[activity])
            self._profiler.start()

    def _stop_profile(self):
        """Close the trace and write this rank's chrome trace."""
        if self._profiler is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._profiler.stop()
        rank = dist.get_rank() if dist.is_initialized() else 0
        os.makedirs(self.config.trainer.profile_dir, exist_ok=True)
        path = os.path.join(self.config.trainer.profile_dir,
                            f"trace_rank{rank}.json")
        self._profiler.export_chrome_trace(path)
        self._profiler = None
        print(f"[profiler] trace written to {path}")

    # ------------------------------------------------------------ callbacks

    def call_saving_callbacks(self):
        if self.saving_strategy is None:
            return
        if self.saving_strategy.should_save(self.current_epoch + 1, self.global_step):
            self._save_model(self.current_epoch + 1, self.global_step)

    def _state_dict_to_save(self) -> dict[str, torch.Tensor]:
        """The model's file contents; every rank gathers its sharded
        parameters whole for it."""
        with full_parameters(self.model.trainable()):
            state_dict = self.model.get_state_dict_to_save()
        for old, new in (self.config.saving.rename_key_map or {}).items():
            state_dict = {k.replace(old, new): v for k, v in state_dict.items()}
        return state_dict

    def _swap_in_schedule_free_eval_params(self) -> dict | None:
        """Put the schedule-free x parameters in place of y; returns y to
        restore, or None for other optimizers."""
        if not self._schedule_free:
            return None
        original = {}
        with torch.no_grad():
            for p, x in self.optimizer.eval_params().items():
                original[p] = p.detach().clone()
                p.copy_(x)
        return original

    @staticmethod
    @torch.no_grad()
    def _restore_params(original: dict | None):
        for p, value in (original or {}).items():
            p.copy_(value)

    def _save_model(self, epoch: int, steps: int):
        # each file is written before the parameters are put back: a state
        # dict's tensors may be the parameters themselves (``.cpu()`` of a
        # CPU tensor is no copy)
        self.model.before_save_model()
        metadata = self.model.get_metadata_to_save() or None
        original = self._swap_in_schedule_free_eval_params()
        try:
            state_dict = self._state_dict_to_save()
            for cb in self.saving_callbacks if is_main_process() else []:
                path = cb.save(state_dict, epoch, steps, metadata=metadata)
                print(f"[saving] wrote {path}")
        finally:
            self._restore_params(original)
        if self.ema_state is not None:
            # the EMA copy goes to an ema_-prefixed file
            trainable = self.model.trainable()
            original = ema_lib.swap_in_ema_params(trainable, self.ema_state)
            try:
                ema_sd = self._state_dict_to_save()
                for cb in self.saving_callbacks if is_main_process() else []:
                    template = cb.save_name_template
                    cb.save_name_template = "ema_" + template
                    cb.save(ema_sd, epoch, steps, metadata=metadata)
                    cb.save_name_template = template
            finally:
                ema_lib.restore_params(trainable, original)
        barrier("save_model")
        self.model.after_save_model()

    def call_preview_callbacks(self):
        if self.preview_strategy is None or not self.preview_args:
            return
        if not self.preview_strategy.should_preview(self.current_epoch + 1,
                                                    self.global_step):
            return
        self.model.before_preview()
        original = self._swap_in_schedule_free_eval_params()
        try:
            for i, args in enumerate(self.preview_args):
                # every rank samples (sharded parameters need them all);
                # rank 0 writes
                images = self.model.preview_step(args, i)
                for cb in self.preview_callbacks if is_main_process() else []:
                    cb.preview(images, self.current_epoch + 1, self.global_step, i)
                for tracker in self.trackers:
                    for j, img in enumerate(images):
                        tracker.log_image(f"preview/{i}_{j}", img, self.global_step)
        finally:
            if self.mesh is not None:
                reshard(self.model.trainable())
            self._restore_params(original)
        barrier("preview")
        self.model.after_preview()

    # ------------------------------------------------------------ entry

    def train(self):
        start = time.time()
        self.before_train()
        if self.config.trainer.debug_mode == "sanity_check":
            self.model.sanity_check()
            print("sanity check passed")
            return
        self.model.sanity_check()
        was = (torch.are_deterministic_algorithms_enabled(),
               torch.is_deterministic_algorithms_warn_only_enabled())
        if self.config.trainer.deterministic:
            torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            self.training_loop()
        finally:
            torch.use_deterministic_algorithms(was[0], warn_only=was[1])
            for tracker in self.trackers:
                tracker.finish()
        print(f"training finished in {time.time() - start:.1f}s")
