"""The port's JiT variant workloads and entry points under ``trainer.mesh`` on
a 4-rank gloo group on the CPU, against the port's one-process run and, for
latent ARB and TREAD, the JAX package's one-device step.

Eleven variants at a tiny size (hidden 64, 4 heads, a few blocks, fp32 under
``attention_dtype(None)``, clip_grad_norm 1.0, batch 8, two steps): ARB with
the x-loss config's ``loss_target: image`` and a ``lowres_loss`` (per-sample
size fields in the batch), latent ARB (4 channels, patch 2, the cache
reader), U-JiT, ARB U-JiT, Cross with RoPE and with PoPE, IG, LoIG, TREAD,
and the base workload with ``pope`` and with ``n-pope``; each under
{data 2, fsdp 2}, {fsdp 2, tensor 2} and {data 2, seq 2}, with FSDP sharding
from 1024 elements (``MIN_SHARD``), so the tiny weights are split:
- the trainer's own draws (every rank draws the whole batch's, takes its
  rows, and keeps TREAD's permutation whole): losses within 1e-5, step-1
  gradients within 1e-4 relative L2 (the whole gradient, and each tensor
  whose norm is above FP32_NOISE of the whole's), parameters after two steps
  within PARAM_ATOL of the one-process run; rank 0's saved file that of the
  one-process run; a run resumed from the step-1 train state the unbroken
  run's bits; TREAD's permutation the same on every rank and in the
  one-process run;
- latent ARB and TREAD also from the JAX trainer's weights and draws
  (timesteps, noise, TREAD's permutation), against the JAX one-device step
  to the same limits;
- under seq, the ring's dispatch count over the two steps is twice the
  number of attention calls for which JAX's ``_ring_eligible`` holds in one
  JAX ``compute_loss`` (traced with ``nnx.eval_shape``), and 0 under the
  other meshes.
Also the tensor-parallel rules over each variant's tree against JAX's; the
refusals that stay (SDXL ``tensor`` / ``seq``, also with an adapter
workload, LoHa or an optax-family optimizer), every one naming ROADMAP
Queue 1 item 5;
and every ``train/jit`` entry point under a 2-rank ``torchrun``-style group
(``trainer.distributed_init``, {data 2}, two steps so the profiler's trace
holds one, rank 0's save).

One spawn of 4 processes runs every case; each rank writes its results to a
file, and the tests read them. After the 4-rank cases, ranks 0-1 and 2-3
form two 2-rank groups of their own for the entry points. The JAX side and
the one-process runs go in this process meanwhile; the ranks import no JAX.
"""

import functools
import glob
import importlib
import json
import os
import shutil
import socket
import time
import types
from typing import ClassVar

import numpy as np
import pytest
import torch

from vision_pt_tpu_torch.data.bucket import ConcatBucketDataset
from vision_pt_tpu_torch.data.square_class_image import (
    SyntheticClassImageDatasetConfig,
    _SyntheticClassBucket,
)
from tests.test_torch_sdxl_distributed import one_torch_thread  # noqa: F401,E402

WORLD, SEED, BATCH, SIZE, STEPS, MIN_SHARD = 4, 0, 8, 16, 2, 1024
LATENT_SIDE = 8  # 8 x 8 x 4 latents, patch 2: the square variants' 16 patches
MESHES = {"data2_fsdp2": {"data": 2, "fsdp": 2}, "fsdp2_tensor2": {"fsdp": 2, "tensor": 2},
          "data2_seq2": {"data": 2, "seq": 2}}
LOSS_RTOL, GRAD_RTOL, PARAM_ATOL, FP32_NOISE = 1e-5, 1e-4, 1e-4, 1e-6
TINY = dict(patch_size=4, hidden_size=64, depth=4, num_heads=4, bottleneck_dim=16,
            context_dim=32, context_start_block=1, rope_axes_dims=[4, 6, 6],
            num_time_tokens=2)
# variant -> (workload class, module; denoiser fields; model fields; data)
VARIANTS = {
    "x_loss": ("JiTForArbClassToImageTraining", "jit_variants", {},
               {"loss_target": "image", "lowres_loss": [0.5]}, "arb"),
    "latent_arb": ("JiTForArbClassToImageTraining", "jit_variants",
                   {"patch_size": 2, "in_channels": 4, "out_channels": 4}, {}, "latent"),
    "ujit": ("JiTForUJiTTraining", "jit_variants", {"depth": 1, "num_blocks": 4}, {},
             "square"),
    "arb_ujit": ("JiTForArbUJiTTraining", "jit_variants",
                 {"depth": 1, "num_blocks": 3, "norm_position": "pre"},
                 {"lowres_loss": [0.5]}, "arb"),
    "cross": ("JiTForCrossTraining", "jit_variants", {}, {}, "tags"),
    "cross_pope": ("JiTForCrossTraining", "jit_variants", {"positional_encoding": "pope"},
                   {}, "tags"),
    "ig": ("JiTForIGTraining", "jit_variants", {"intermediate_output_idx": 1},
           {"ig_scale": 1.5, "intermediate_loss_weight": 0.7}, "square"),
    "loig": ("JiTForLoIGTraining", "jit_variants", {"internal_rank": 4},
             {"loig_loss_weight": 0.6}, "square"),
    "tread": ("JiTForTreadTraining", "jit_variants",
              {"tread_start_block": 1, "tread_end_block": 3}, {}, "square"),
    "pope": ("JiTForClassToImageTraining", "jit_class_to_image",
             {"positional_encoding": "pope"}, {}, "square"),
    "npope": ("JiTForClassToImageTraining", "jit_class_to_image",
              {"positional_encoding": "n-pope"}, {}, "square"),
}
JAX_VARIANTS = ("latent_arb", "tread")
CASES = [(v, m) for v in VARIANTS for m in MESHES]
# entry point -> the 2-rank group (ranks 0-1 or 2-3) that runs it
ENTRY_POINTS = {"arb_class_to_image": 0, "arb_class_to_image_ujit": 0,
                "latent_class_to_image": 0, "class_to_image": 0,
                "class_to_image_cross": 0, "class_to_image_ig": 1,
                "class_to_image_loig": 1, "class_to_image_tread": 1,
                "class_to_image_ujit": 1}
# the refusals that stay: the tensor and seq axes of the SDXL workloads, with
# an adapter workload, LoHa and an optax-family optimizer among them
REFUSALS = ("sdxl_tensor", "sdxl_seq", "sdxl_adapter", "loha", "optax")


# ------------------------------------------------------------------ data


class _TaggedBucket(_SyntheticClassBucket):
    """The synthetic images captioned with 1-3 class tags, so a
    cross-attention has more than one key to weigh (over a single key its
    query has no gradient)."""

    def load_item(self, idx: int) -> dict:
        item = super().load_item(idx)
        item["caption"] = " ".join(f"c{(idx + j) % self.num_classes}"
                                   for j in range(1 + idx % 3))
        return item


class _ArbBucket(_TaggedBucket):
    """The tagged images with per-sample size conditioning, as an
    aspect-ratio bucket gives it."""

    def load_item(self, idx: int) -> dict:
        item = super().load_item(idx)
        s = self.image_size
        item.update(original_size=np.array([s + 8 * (idx % 3), s + 4 * (idx % 2)], np.int32),
                    target_size=np.array([s, s], np.int32),
                    crop_coords_top_left=np.array([4 * (idx % 2), 2 * (idx % 3)], np.int32))
        return item


class TaggedSyntheticDatasetConfig(SyntheticClassImageDatasetConfig):
    bucket_class: ClassVar[type] = _TaggedBucket

    def get_dataset(self) -> ConcatBucketDataset:
        bucket = self.bucket_class(num_classes=self.num_classes, num_items=self.num_items,
                                   image_size=self.image_size, batch_size=self.batch_size,
                                   seed=self.seed)
        return ConcatBucketDataset([bucket], shuffle=self.shuffle, seed=self.seed)


class ArbSyntheticDatasetConfig(TaggedSyntheticDatasetConfig):
    bucket_class: ClassVar[type] = _ArbBucket


def _dataset_class(name: str):
    from vision_pt_tpu_torch.data.latent_cache import CachedLatentDatasetConfig

    return {"square": SyntheticClassImageDatasetConfig, "tags": TaggedSyntheticDatasetConfig,
            "arb": ArbSyntheticDatasetConfig,
            "latent": CachedLatentDatasetConfig}[VARIANTS[name][4]]


def write_latent_cache(cache_dir: str, num_items: int, side: int) -> str:
    """A latent cache in the JAX package's layout (``manifest.jsonl`` and
    fp16 ``mean`` / ``std`` files), captions over four classes."""
    import hashlib

    rng = np.random.default_rng(0)
    os.makedirs(cache_dir, exist_ok=True)
    rows = []
    for i in range(num_items):
        name = hashlib.sha1(f"{i}".encode()).hexdigest() + ".npz"
        np.savez(os.path.join(cache_dir, name),
                 mean=rng.normal(size=(side, side, 4)).astype(np.float16),
                 std=rng.uniform(0.05, 0.3, size=(side, side, 4)).astype(np.float16))
        rows.append({"caption": " ".join(f"c{(i + j) % 4}" for j in range(1 + i % 3)),
                     "height": 8 * side, "width": 8 * side,
                     "original_size": [8 * side + 8 * (i % 2), 8 * side],
                     "target_size": [8 * side, 8 * side],
                     "crop_coords_top_left": [4 * (i % 2), 0], "scaling_factor": 0.13025,
                     "dtype": "float16", "file": name, "latent_height": side,
                     "latent_width": side})
    with open(os.path.join(cache_dir, "manifest.jsonl"), "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)
    return cache_dir


def _config(name, inputs, mesh=None, out=None, ckpt=None):
    _, _, denoiser, model, data = VARIANTS[name]
    dataset = ({"cache_dir": inputs["latent_cache"], "batch_size": BATCH, "seed": 2}
               if data == "latent" else
               {"num_classes": 4, "num_items": BATCH * STEPS, "image_size": SIZE,
                "batch_size": BATCH, "seed": 0})
    trainer = {"mesh": mesh, "clip_grad_norm": 1.0}
    if ckpt is not None:
        trainer["checkpointing"] = {"save_dir": ckpt, "per_steps": 1, "resume": True}
    return {
        "model": {"context_encoder": {"type": "class",
                                      "label2id_map_path": inputs["label2id"]},
                  "denoiser": {**TINY, **denoiser}, "max_token_length": 4, **model},
        "dataset": dataset,
        "optimizer": {"name": "adamw", "args": {"lr": 1e-3}},
        "saving": None if out is None else {
            "strategy": {"per_epochs": None},
            "callbacks": [{"type": "safetensors", "name": "jit", "save_dir": out}]},
        "seed": SEED, "num_train_epochs": 1, "trainer": trainer,
    }


def step_seed(n: int) -> int:
    """The seed of the trainer's generator for step n (``_next_generator``)."""
    seed = np.random.SeedSequence((SEED, n))
    return int(seed.generate_state(1, np.uint64)[0] >> np.uint64(1))


def _workload(name, injected=None):
    """The variant's workload class, recording TREAD's permutation as
    ``compute_loss`` sees it; with ``injected`` ({"init", "draws"}) it
    starts from the JAX weights and takes the JAX draws of the step (looked
    up by the generator's seed, so a resumed run draws what the unbroken one
    did)."""
    cls_name, module = VARIANTS[name][:2]
    base = getattr(importlib.import_module(f"vision_pt_tpu_torch.workloads.{module}"),
                   cls_name)

    class Workload(base):
        perms: list = []

        def compute_loss(self, trainable, batch, draws):
            if "route_perm" in draws:
                type(self).perms.append(draws["route_perm"].tolist())
            return super().compute_loss(trainable, batch, draws)

    if injected is None:
        return Workload

    class Injected(Workload):
        def setup_model(self):
            from vision_pt_tpu_torch.models.jit.convert import from_jax_state

            super().setup_model()
            self.trainable().load_state_dict(from_jax_state(injected["init"]), strict=True)

        def draw_randoms(self, batch, generator):
            from vision_pt_tpu_torch.ops.timestep.sampling import sample_timestep

            d = injected["draws"][[step_seed(n) for n in range(1, STEPS + 1)].index(
                generator.initial_seed())]
            draws = {"timesteps": sample_timestep(
                         generator, BATCH, self.model_config.timestep_sampling,
                         draw=torch.from_numpy(d["timesteps"])),
                     "noise": torch.from_numpy(d["noise"])}
            if "route_perm" in d:
                draws["route_perm"] = torch.from_numpy(d["route_perm"])
            return draws

    return Injected


def _train(name, config, workload):
    """Run the trainer; returns its losses, step-1 gradients (pre-clip,
    gathered whole), final parameters (whole) and the permutations TREAD's
    steps saw."""
    from vision_pt_tpu_torch.config import TrainConfig
    from vision_pt_tpu_torch.ops.attention import attention_dtype
    from vision_pt_tpu_torch.parallel.mesh import full_tensors
    from vision_pt_tpu_torch.training.trainer import Trainer

    trainer = Trainer(TrainConfig.model_validate(config), device="cpu")
    trainer.register_train_dataset_class(_dataset_class(name))
    trainer.register_model_class(workload)
    workload.perms = []
    losses, grads = [], {}
    inner_step, inner_update = trainer.train_step, trainer._apply_update

    def step(*args, **kwargs):
        loss, metrics = inner_step(*args, **kwargs)
        losses.append(float(loss))
        return loss, metrics

    def update(gs):
        if not grads:
            names = [n for n, p in trainer.model.trainable().named_parameters()
                     if p.requires_grad]
            grads.update({n: g.numpy() for n, g in zip(names, full_tensors(list(gs)))})
        inner_update(gs)

    trainer.train_step, trainer._apply_update = step, update
    with attention_dtype(None):
        trainer.train()
    params = {k: v.numpy() for k, v in full_tensors(
        trainer.model.trainable().state_dict()).items()}
    return {"losses": losses, "grads": grads, "params": params,
            "perms": list(workload.perms), "steps": trainer.global_step}


# ------------------------------------------------------------------ ranks


def _mesh_case(name, mesh_name, inputs, work, rank):
    """The unbroken run (trainer's draws, files, train states at each step),
    a run resumed from its step-1 state, and, for the JAX variants, the run
    on the JAX weights and draws."""
    import torch.distributed as dist

    from vision_pt_tpu_torch.ops.attention import ring_dispatch_count

    mesh = MESHES[mesh_name]
    tag = f"{name}_{mesh_name}"
    ckpt = os.path.join(work, f"ckpt_{tag}")
    before = ring_dispatch_count()
    run = _train(name, _config(name, inputs, mesh, os.path.join(work, f"out_{tag}"), ckpt),
                 _workload(name))
    run["rings"] = ring_dispatch_count() - before
    if rank == 0:
        shutil.rmtree(os.path.join(ckpt, f"step_{STEPS:08d}"))
    dist.barrier()
    run["resumed"] = _train(name, _config(name, inputs, mesh, None, ckpt), _workload(name))
    if name in JAX_VARIANTS:
        injected = _received(work, "injected.pt")[name]
        run["injected"] = _train(name, _config(name, inputs, mesh), _workload(name, injected))
    return run


def _refusal(name, inputs):
    """Build the trainer and prepare it: returns the NotImplementedError's
    message, or None if nothing raised."""
    from vision_pt_tpu_torch.config import TrainConfig
    from vision_pt_tpu_torch.training.trainer import Trainer
    from vision_pt_tpu_torch.workloads.sdxl_rope_distill import SDXLRoPEDistillTraining
    from vision_pt_tpu_torch.workloads.sdxl_text_to_image import SDXLForTextToImageTraining

    lora = {"config": {"type": "lora", "rank": 2, "alpha": 1.0, "dtype": "float32"},
            "include_keys": ["attn1"], "exclude_keys": ["text_encoder", "vae"]}
    sdxl = {"model": {**inputs["sdxl_model"], "tokenizer": "word-hash"}, "dataset": {},
            "seed": 0, "peft": lora}
    config, workload = {
        "sdxl_tensor": ({**sdxl, "trainer": {"mesh": {"fsdp": 2, "tensor": 2}}},
                        SDXLForTextToImageTraining),
        "sdxl_seq": ({**sdxl, "trainer": {"mesh": {"data": 2, "seq": 2}}},
                     SDXLForTextToImageTraining),
        "sdxl_adapter": ({**sdxl, "trainer": {"mesh": {"data": 2, "seq": 2}}},
                         SDXLRoPEDistillTraining),
        "loha": ({**sdxl, "peft": {**lora, "config": {**lora["config"], "type": "loha"}},
                  "trainer": {"mesh": {"data": 2, "tensor": 2}}}, SDXLForTextToImageTraining),
        "optax": ({**sdxl, "optimizer": {"name": "lion", "args": {"lr": 1e-3}},
                   "trainer": {"mesh": {"fsdp": 2, "tensor": 2}}}, SDXLRoPEDistillTraining),
    }[name]
    trainer = Trainer(TrainConfig.model_validate(config), device="cpu")
    trainer.register_train_dataset_class(SyntheticClassImageDatasetConfig)
    trainer.register_model_class(workload)
    try:
        trainer.prepare_model()  # raises before the model is built
    except NotImplementedError as e:
        return {"raised": str(e)}
    return {"raised": None}


def _entry_point(module, path):
    """One entry point's ``run`` on a config with ``distributed_init`` and
    {data 2}: the group, the steps, the files and the trace."""
    import torch.distributed as dist
    import yaml

    trainer = importlib.import_module(f"vision_pt_tpu_torch.train.jit.{module}").run(
        path, device="cpu")
    with open(path) as f:
        cfg = yaml.safe_load(f)
    out = cfg["saving"]["callbacks"][0]["save_dir"]
    rank = dist.get_rank()
    return {"backend": dist.get_backend(), "rank": rank, "world": dist.get_world_size(),
            "mesh": trainer.mesh.shape if trainer.mesh is not None else None,
            "steps": trainer.global_step,
            "saved": sorted(os.listdir(out)) if os.path.isdir(out) else [],
            "trace": os.path.exists(os.path.join(cfg["trainer"]["profile_dir"],
                                                 f"trace_rank{rank}.json"))}


def _rank_main(rank, ports, work):
    import torch.distributed as dist

    import vision_pt_tpu_torch.training.trainer as trainer_module
    from vision_pt_tpu_torch.parallel.mesh import make_mesh, mesh_sizes, shard_module

    torch.set_num_threads(1)
    # FSDP splits the tiny weights too
    trainer_module.shard_module = functools.partial(shard_module,
                                                    min_size_to_shard=MIN_SHARD)
    # one DeviceMesh (and one set of gloo groups) a mesh shape, not one a
    # trainer: a process that built a hundred trainers' groups stalled
    meshes = {}

    def cached_mesh(config=None, devices=None):
        key = (dist.get_world_size(), tuple(mesh_sizes(config, dist.get_world_size())))
        if key not in meshes:
            meshes[key] = make_mesh(config, devices)
        return meshes[key]

    trainer_module.make_mesh = cached_mesh
    inputs = _received(work, "inputs.pt")
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(WORLD),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(ports[0]))
    dist.init_process_group("gloo")
    results = {}

    def case(key, fn):
        try:
            results[key] = fn()
        except Exception as e:  # recorded; the test of the case reports it
            results[key] = {"error": f"{type(e).__name__}: {e}"}

    for name, mesh_name in CASES:
        case((name, mesh_name), functools.partial(_mesh_case, name, mesh_name, inputs,
                                                  work, rank))
        dist.barrier()
    for name in REFUSALS:
        case(("refusal", name), functools.partial(_refusal, name, inputs))
    meshes.clear()
    dist.destroy_process_group()
    # a 2-rank group of its own for each pair of ranks, from torchrun-style
    # variables, built by the entry points' trainer.distributed_init
    pair = rank // 2
    os.environ.update(RANK=str(rank % 2), LOCAL_RANK=str(rank % 2), WORLD_SIZE="2",
                      MASTER_PORT=str(ports[1 + pair]))
    configs = _received(work, "entry_configs.pt")
    for module, group in ENTRY_POINTS.items():
        if group == pair:
            case(("entry", module), functools.partial(_entry_point, module, configs[module]))
    torch.save(results, os.path.join(work, f"rank{rank}.pt"))
    if dist.is_initialized():
        dist.destroy_process_group()


def _publish(work: str, name: str, value) -> None:
    """Hand ``value`` to the ranks as the file ``name`` (written whole, then
    renamed into place)."""
    torch.save(value, os.path.join(work, name + ".part"))
    os.replace(os.path.join(work, name + ".part"), os.path.join(work, name))


def _received(work: str, name: str):
    """The value ``_publish`` hands over as ``name``, once it is there (this
    process started before it was made)."""
    path = os.path.join(work, name)
    deadline = time.monotonic() + 600
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{name} never came")
        time.sleep(0.1)
    return torch.load(path, weights_only=False)


def _free_ports(n: int) -> list[int]:
    """``n`` distinct free localhost ports (each held until all are taken)."""
    sockets = [socket.socket() for _ in range(n)]
    try:
        for s in sockets:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in sockets]
    finally:
        for s in sockets:
            s.close()


def _spawn(work, inputs):
    """Start the ranks on ``inputs`` (handed over in a file: an argument
    larger than a pipe's buffer holds each start until the child has
    imported); returns a function that waits for them (at most 600 s) and
    loads their results."""
    import torch.multiprocessing as mp

    _publish(work, "inputs.pt", inputs)
    ports = _free_ports(3)
    ctx = mp.start_processes(_rank_main, args=(ports, work), nprocs=WORLD,
                             join=False, start_method="spawn")

    def wait():
        deadline = time.monotonic() + 600
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError("the gloo ranks did not finish in 600 s")
        return [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
                for r in range(WORLD)]

    return wait


# ------------------------------------------------------------------ JAX side


def _jax_config(name, inputs):
    from vision_pt_tpu.config import TrainConfig

    config = _config(name, inputs)
    config["trainer"].pop("mesh")
    return TrainConfig.model_validate(config)


def _jax_workload(name, inputs):
    import vision_pt_tpu.workloads.jit_class_to_image as jbase
    import vision_pt_tpu.workloads.jit_variants as jvariants

    cls_name, module = VARIANTS[name][:2]
    return getattr(jvariants if module == "jit_variants" else jbase, cls_name)


def _jax_trainer(name, inputs):
    from vision_pt_tpu.data.latent_cache import CachedLatentDatasetConfig
    from vision_pt_tpu.data.square_class_image import (
        SyntheticClassImageDatasetConfig as JaxSynthetic,
    )
    from vision_pt_tpu.training.trainer import Trainer

    trainer = Trainer(_jax_config(name, inputs))
    trainer.register_train_dataset_class(
        CachedLatentDatasetConfig if VARIANTS[name][4] == "latent" else JaxSynthetic)
    trainer.register_model_class(_jax_workload(name, inputs))
    trainer.before_train()
    return trainer


def _jax_draws(name):
    """The timesteps, noise (and TREAD's permutation) of JAX trainer steps
    1..STEPS, as the workloads split the step key."""
    import jax
    import jax.numpy as jnp

    side, channels = (LATENT_SIDE, 4) if name == "latent_arb" else (SIZE, 3)
    draws = []
    for n in range(1, STEPS + 1):
        key = jax.random.fold_in(jax.random.fold_in(jax.random.key(SEED), n), 1)
        keys = jax.random.split(key, 3 if name == "tread" else 2)
        d = {"timesteps": np.array(jax.random.normal(keys[0], (BATCH,), jnp.float32)),
             "noise": np.array(jax.random.normal(keys[1], (BATCH, side, side, channels),
                                                 jnp.float32))}
        if name == "tread":
            d["route_perm"] = np.array(jax.random.permutation(keys[2], (SIZE // 4) ** 2))
        draws.append(d)
    return draws


def _jax_run(trainer):
    """The JAX trainer's step-1 gradients (its first batch and key, the
    trainer's key counter and drop generator put back after), then its
    losses and final parameters over STEPS steps, in the port's names."""
    import jax
    from flax import nnx

    from vision_pt_tpu.ops.attention import attention_dtype
    from vision_pt_tpu.utils.state_dict import _path_to_key, flatten_state
    from vision_pt_tpu_torch.models.jit.convert import from_jax_state

    losses, inner = [], trainer.train_step

    def recording(*args, **kwargs):
        loss, metrics = inner(*args, **kwargs)
        losses.append(float(loss))
        return loss, metrics

    trainer.train_step = recording
    workload = trainer.model
    counter, drop = trainer._key_counter, workload._drop_rng.bit_generator.state
    with attention_dtype(None):
        key = trainer._next_key()
        arrays = workload.prepare_batch(next(iter(trainer.train_dataset)), key)
        graphdef, params, rest = nnx.split(workload.trainable(), nnx.Param, ...)

        def loss_fn(params):
            return workload.compute_loss(nnx.merge(graphdef, params, rest), arrays, key)[0]

        grads = jax.jit(jax.grad(loss_fn))(params)
        trainer._key_counter, workload._drop_rng.bit_generator.state = counter, drop
        trainer.training_loop()
    trainer.sync_module_state()
    flat = lambda state: {_path_to_key(tuple(p)): np.asarray(getattr(v, "value", v))  # noqa: E731
                          for p, v in nnx.to_flat_state(state)}
    to_port = lambda tree: {k: v.numpy() for k, v in from_jax_state(tree).items()}  # noqa: E731
    final = {k: np.asarray(v) for k, v in flatten_state(trainer.model.trainable()).items()}
    return {"losses": losses, "grads": to_port(flat(grads)), "params": to_port(final)}


def _first_batch(name, inputs) -> dict:
    config = _config(name, inputs)
    return next(iter(_dataset_class(name).model_validate(config["dataset"]).get_dataset()))


def _jax_ring_calls(workload, batch) -> int:
    """How many attention calls of one JAX ``compute_loss`` JAX's
    ``_ring_eligible`` admits on a seq axis of 2 (traced abstractly; the
    check is recorded and the call goes on unsharded)."""
    import jax
    from flax import nnx

    import vision_pt_tpu.ops.attention as jattn

    class SeqMesh:
        shape = {"seq": 2}

    key = jax.random.key(0)
    arrays = workload.prepare_batch(batch, key)
    calls, real, prev = [], jattn._ring_eligible, jattn._SEQ_PARALLEL
    jattn._ring_eligible = lambda *a, **k: calls.append(real(*a, **k)) and False
    jattn._SEQ_PARALLEL = (SeqMesh(), "seq", ())
    try:
        with jattn.attention_dtype(None):
            nnx.eval_shape(lambda t: workload.compute_loss(t, arrays, key)[0],
                           workload.trainable())
    finally:
        jattn._ring_eligible, jattn._SEQ_PARALLEL = real, prev
    return sum(calls)


def _tp_sets(name, inputs, jax_workload) -> tuple[dict, dict, dict]:
    """The tensor-parallel rule hits of the port's and the JAX denoiser of
    the variant, and the port's plan over 2 tensor ranks."""
    from tests.test_torch_parallel import _jax_tp_set, _port_tp_set
    from vision_pt_tpu_torch.config import TrainConfig
    from vision_pt_tpu_torch.parallel.mesh import _tensor_plan

    config = TrainConfig.model_validate(_config(name, inputs))
    workload = _workload(name)(config, torch.device("cpu"))
    workload.setup_model()
    denoiser = workload.model.denoiser
    return (_port_tp_set(denoiser), _jax_tp_set(jax_workload.model.denoiser),
            _tensor_plan(denoiser, 2))


def _entry_configs(work: str, label2id: str) -> dict[str, str]:
    """The configs of the entry point cases: the tests' tiny copies of the
    shipped configs (``test_torch_jit_variants``, ``test_torch_latent``),
    two steps with {data 2}, ``distributed_init``, ``profile_dir`` over one
    step, and no preview."""
    import pathlib

    import yaml

    from tests.test_torch_jit_variants import (
        SQUARE_ENTRY_POINTS,
        write_square_config,
        write_x_loss_config,
    )
    from tests.test_torch_latent import TINY_LATENT

    paths = {}
    for module in ENTRY_POINTS:
        folder = pathlib.Path(work) / f"entry_{module}"
        folder.mkdir()
        if module.startswith("arb_"):
            denoiser = {"depth": 2} if module == "arb_class_to_image" else {
                "depth": 1, "num_blocks": 4}
            path = write_x_loss_config(folder, denoiser)
            for image in sorted((folder / "images").glob("*.webp"))[4:]:
                image.unlink()
                (folder / "images" / f"{image.stem}.tags.json").unlink()
        elif module == "latent_class_to_image":
            cfg = yaml.safe_load((pathlib.Path(__file__).parent.parent
                                  / "configs/jit/latent_arb_1024.yml").read_text())
            cfg["model"]["denoiser"].update(TINY_LATENT)
            cfg["model"].update(max_token_length=4)
            cfg["model"]["context_encoder"]["label2id_map_path"] = label2id
            cfg["dataset"].update(cache_dir=write_latent_cache(
                str(folder / "cache"), 4, LATENT_SIDE), batch_size=2)
            cfg["saving"]["callbacks"][0]["save_dir"] = str(folder / "out")
            cfg["tracker"]["log_dir"] = str(folder / "logs")
            cfg["num_train_epochs"] = 1
            path = folder / "config.yml"
        else:
            path = write_square_config(folder, SQUARE_ENTRY_POINTS.get(module, {}))
        cfg = yaml.safe_load(path.read_text()) if module != "latent_class_to_image" else cfg
        cfg["preview"] = None
        cfg["trainer"] = {**(cfg.get("trainer") or {}), "mesh": {"data": 2},
                          "distributed_init": True, "profile_steps": 1,
                          "profile_dir": str(folder / "profile")}
        path.write_text(yaml.safe_dump(cfg))
        paths[module] = str(path)
    return paths


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results, the JAX runs, the one-process runs, the JAX ring
    counts, the work directory, the inputs and the JAX workloads. The ranks
    start first; the JAX weights and draws and the entry points' configs
    reach them in files as they are made, and the rest runs beside them."""
    from tests.test_torch_sdxl_training import TINY_MODEL
    from vision_pt_tpu.utils.state_dict import flatten_state

    work = str(tmp_path_factory.mktemp("variants_mesh"))
    label2id = os.path.join(work, "label2id.json")
    with open(label2id, "w") as f:
        json.dump({f"c{i}": i for i in range(4)}, f)
    inputs = {"label2id": label2id, "sdxl_model": TINY_MODEL,
              "latent_cache": write_latent_cache(os.path.join(work, "latent_cache"),
                                                 BATCH * STEPS, LATENT_SIDE)}
    wait = _spawn(work, inputs)
    jax_trainers = {name: _jax_trainer(name, inputs) for name in JAX_VARIANTS}
    inputs["injected"] = {
        name: {"init": {k: np.asarray(v) for k, v in
                        flatten_state(t.model.trainable()).items()},
               "draws": _jax_draws(name)}
        for name, t in jax_trainers.items()}
    _publish(work, "injected.pt", inputs["injected"])
    _publish(work, "entry_configs.pt", _entry_configs(work, label2id))
    # this process's torch work beside the ranks' takes one core
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    jax_runs = {name: _jax_run(t) for name, t in jax_trainers.items()}
    workloads, rings = {}, {}
    for name in VARIANTS:
        workloads[name] = _jax_workload(name, inputs)(_jax_config(name, inputs))
        workloads[name].setup_model()
        rings[name] = _jax_ring_calls(workloads[name], _first_batch(name, inputs))
    one = {}
    for name in VARIANTS:
        one[name] = _train(name, _config(name, inputs, out=os.path.join(work, f"one_{name}")),
                           _workload(name))
        if name in JAX_VARIANTS:
            one[f"{name}_injected"] = _train(name, _config(name, inputs),
                                             _workload(name, inputs["injected"][name]))
    torch.set_num_threads(threads)
    return types.SimpleNamespace(ranks=wait(), jax=jax_runs, one=one, rings=rings, work=work,
                                 inputs=inputs, workloads=workloads)


# ------------------------------------------------------------------ tests


def _ok(result):
    assert "error" not in result, result["error"]
    return result


def _assert_tree(ours, theirs, atol, what):
    assert ours.keys() == theirs.keys(), what
    for key in theirs:
        err = float(np.abs(ours[key] - theirs[key]).max())
        assert err <= atol, (what, key, err)


def _assert_grads(ours, theirs, what):
    """The whole step-1 gradient within GRAD_RTOL relative L2, and each
    tensor's too, against the larger of its norm and FP32_NOISE of the
    whole's: a tensor whose gradient is a millionth of the step's is fp32
    rounding of sums that cancel (the cross block's pre-norm gain at init:
    2e-12 against 0.05)."""
    assert ours.keys() == theirs.keys(), what
    norm = lambda x: float(np.linalg.norm(np.asarray(x, np.float64)))  # noqa: E731
    whole = norm([norm(v) for v in theirs.values()])
    diffs = {key: norm(ours[key] - theirs[key]) for key in theirs}
    assert norm(list(diffs.values())) <= GRAD_RTOL * whole, what
    for key, diff in diffs.items():
        assert diff <= GRAD_RTOL * max(norm(theirs[key]), FP32_NOISE * whole), (what, key)


def _assert_step(ours, theirs, what):
    assert len(ours["losses"]) == STEPS, what
    np.testing.assert_allclose(ours["losses"], theirs["losses"], rtol=LOSS_RTOL, err_msg=what)
    _assert_grads(ours["grads"], theirs["grads"], f"{what} step-1 gradient")
    _assert_tree(ours["params"], theirs["params"], PARAM_ATOL, f"{what} params")


@pytest.mark.parametrize("name,mesh", CASES)
def test_mesh_step_matches_the_one_process_step(runs, name, mesh):
    for rank in runs.ranks:
        _assert_step(_ok(rank[name, mesh]), runs.one[name], f"{name} {mesh}")


@pytest.mark.parametrize("name,mesh", [(n, m) for n in JAX_VARIANTS for m in MESHES])
def test_mesh_step_matches_jax(runs, name, mesh):
    """From the JAX trainer's weights and draws: the JAX one-device step
    and the port's one-process step on the same."""
    for rank in runs.ranks:
        ours = _ok(rank[name, mesh])["injected"]
        _assert_step(ours, runs.jax[name], f"{name} {mesh} against JAX")
        _assert_step(ours, runs.one[f"{name}_injected"], f"{name} {mesh} against one process")


@pytest.mark.parametrize("name,mesh", CASES)
def test_rank_zero_saves_the_one_process_files(runs, name, mesh):
    from safetensors.numpy import load_file

    _ok(runs.ranks[0][name, mesh])
    ours = glob.glob(os.path.join(runs.work, f"out_{name}_{mesh}", "*.safetensors"))
    theirs = glob.glob(os.path.join(runs.work, f"one_{name}", "*.safetensors"))
    assert len(ours) == len(theirs) == 1, (ours, theirs)
    _assert_tree(load_file(ours[0]), load_file(theirs[0]), PARAM_ATOL, "file")


@pytest.mark.parametrize("name,mesh", CASES)
def test_resume_under_the_mesh_matches_the_unbroken_run(runs, name, mesh):
    for rank in runs.ranks:
        unbroken = _ok(rank[name, mesh])
        resumed = unbroken["resumed"]
        assert resumed["steps"] == STEPS and len(resumed["losses"]) == 1
        assert resumed["losses"] == unbroken["losses"][1:]
        _assert_tree(resumed["params"], unbroken["params"], 0.0, "resumed params")


@pytest.mark.parametrize("name", list(VARIANTS))
def test_the_seq_axis_takes_the_ring_where_jax_would(runs, name):
    """Two steps: the ring's dispatches are twice the calls JAX's
    ``_ring_eligible`` admits in one step, and none off the seq axis."""
    for rank in runs.ranks:
        assert _ok(rank[name, "data2_seq2"])["rings"] == STEPS * runs.rings[name], runs.rings[name]
        assert all(_ok(rank[name, m])["rings"] == 0 for m in MESHES if m != "data2_seq2")
    # PoPE's attention runs the plain backend in both packages; every other
    # variant has self-attention over an even sequence
    assert (runs.rings[name] > 0) == (name not in ("pope", "npope", "cross_pope")), runs.rings


@pytest.mark.parametrize("mesh", list(MESHES))
def test_tread_permutation_is_whole_on_every_rank(runs, mesh):
    perms = [_ok(rank["tread", mesh])["perms"] for rank in runs.ranks]
    assert len(perms[0]) == STEPS and sorted(perms[0][0]) == list(range((SIZE // 4) ** 2))
    assert all(p == runs.one["tread"]["perms"] for p in perms)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_tensor_parallel_rules_match_jax_over_the_variant(runs, name):
    ours, theirs, plan = _tp_sets(name, runs.inputs, runs.workloads[name])
    assert ours == theirs, sorted(set(ours) ^ set(theirs))
    assert set(plan) == {n.removesuffix(".weight") for n in ours if n.endswith(".weight")}


@pytest.mark.parametrize("module", list(ENTRY_POINTS))
def test_entry_point_trains_under_torchrun_on_two_ranks(runs, module):
    pair = runs.ranks[2 * ENTRY_POINTS[module]:2 * ENTRY_POINTS[module] + 2]
    results = [_ok(rank["entry", module]) for rank in pair]
    assert [r["rank"] for r in results] == [0, 1]
    for r in results:
        assert r["backend"] == "gloo" and r["world"] == 2 and r["steps"] == 2
        assert tuple(r["mesh"]) == (2, 1, 1, 1) and r["trace"]
    assert len([f for f in results[0]["saved"] if not f.startswith("ema_")]) == 1


@pytest.mark.parametrize("name", REFUSALS)
def test_the_remaining_refusals_still_raise(runs, name):
    for rank in runs.ranks:
        raised = _ok(rank["refusal", name])["raised"]
        assert raised is not None and "ROADMAP Queue 1 item 5" in raised, raised


def test_no_jit_workload_refuses_the_mesh():
    import vision_pt_tpu_torch.workloads.jit_variants as variants
    from vision_pt_tpu_torch.training.model import ModelForTraining

    classes = [c for c in vars(variants).values()
               if isinstance(c, type) and issubclass(c, ModelForTraining)]
    assert len(classes) == 8
    for cls in classes:
        assert cls.mesh_draws == ("timesteps", "noise"), cls
        assert cls.mesh_axes == ("data", "fsdp", "tensor", "seq"), cls
    assert variants.JiTForTreadTraining.mesh_whole_draws == ("route_perm",)
