"""The port's SDXL adapter trainers (IP-Adapter, PFG, RoPE distillation,
DRaFT+, the style tokenizer), LoHa over an NF4 base and the optax-family
optimizers under ``trainer.mesh`` on a 4-rank gloo group on the CPU, against
the port's one-process run and, for IP-Adapter, DRaFT+ and the style
tokenizer, the JAX package's one-device step.

Eight kinds at the tiny SDXL of ``tests/test_torch_sdxl_training.py`` (the
adapter kinds with the tiny UNet and towers of their own tests), batch 4,
fp32 under ``attention_dtype(None)``, each under {data 4} and
{data 2, fsdp 2}, FSDP splitting arrays from MIN_SHARD elements:
- ip: ``SDXLIPAdapterRefTraining`` (a reference image a sample, the image
  drop from the host generator), AdamW;
- pfg: ``SDXLPFGRefTraining`` (the timm tower), AdamW;
- rope: ``SDXLRoPEDistillTraining`` with LoRA, its four UNet passes and the
  low-res draws, at 128² (at 64² its bottom stage's GroupNorm groups hold 2
  values and fp32 gradients are ill-conditioned), AdamW;
- draft: ``SDXLDRaFTPlusTraining`` with LoRA, 3 sampler steps, the tiny
  PickScore (the reward reads each rank's own captions), distinct negative
  prompts, AdamW;
- style: ``SDXLStyleTokenizerTraining``, captions holding 2, 0, 1 and 1
  placeholders, so a rank's first placeholder takes a row of another rank's
  sample, AdamW;
- loha_nf4: the QLoRA config (AdamW8bit, per-layer recompute) with
  ``peft.type: loha`` over the UNet's linears in NF4;
- prodigy, adafactor: the LoRA config under each (adafactor factoring from
  dim 2, so the rank-2 LoRA factors are factored and split).

The weights of ip, draft and style are the JAX workloads' (``from_jax_state``;
draft's LoRA through ``peft.resume_weight_path``), those of the other kinds
the port's seeded init with every adapter drawn nonzero. Each step's draws
are the same arrays on every side, looked up by the step generator's seed.
Limits: losses within LOSS_RTOL relative, every trained tensor's step-1
gradient within GRAD_RTOL relative L2, the trained tensors after the run
within PARAM_RTOL relative L2 taken over all of them together (prodigy and
adafactor: each element within OPTAX_ATOL after 3 steps); prodigy's d the
same bits on every rank; rank 0's file the one-process run's; under
{data 2, fsdp 2} a run resumed from the last-but-one step the unbroken
run's bits.

One spawn of 4 processes runs every case; each rank writes its results to a
file, and the tests read them. The JAX side and the one-process runs go in
this process meanwhile; the ranks import no JAX.
"""

import functools
import glob
import importlib
import os
import shutil
import types

import numpy as np
import pytest
import torch
from pydantic import BaseModel

from tests.test_torch_sdxl_distributed import (  # noqa: F401 (one_torch_thread)
    _free_port,
    _ok,
    _rel_l2,
    _whole_rel_l2,
    one_torch_thread,
)

WORLD, SEED, BATCH, MIN_SHARD = 4, 0, 4, 128
LOSS_RTOL, GRAD_RTOL, PARAM_RTOL, OPTAX_ATOL = 1e-5, 1e-4, 1e-4, 1e-5
MESHES = {"data4": {"data": 4}, "data2_fsdp2": {"data": 2, "fsdp": 2}}
# kind -> (workload module, class, steps, image side)
KINDS = {
    "ip": ("sdxl_ip_adapter", "SDXLIPAdapterRefTraining", 2, 64),
    "pfg": ("sdxl_prompt_free", "SDXLPFGRefTraining", 2, 64),
    "rope": ("sdxl_rope_distill", "SDXLRoPEDistillTraining", 2, 128),
    "draft": ("sdxl_draft_plus", "SDXLDRaFTPlusTraining", 2, 64),
    "style": ("sdxl_style_tokenizer", "SDXLStyleTokenizerTraining", 2, 64),
    "loha_nf4": ("sdxl_text_to_image", "SDXLForTextToImageTraining", 2, 64),
    "prodigy": ("sdxl_text_to_image", "SDXLForTextToImageTraining", 3, 64),
    "adafactor": ("sdxl_text_to_image", "SDXLForTextToImageTraining", 3, 64),
}
JAX_KINDS = ("ip", "draft", "style")
OPTAX_KINDS = ("prodigy", "adafactor")
# the kinds that need no JAX weights first: the ranks run them while this
# process builds the JAX workloads
CASES = [(kind, mesh) for kind in sorted(KINDS, key=lambda k: k in JAX_KINDS)
         for mesh in MESHES]
# the mesh whose runs are also resumed from the last-but-one step's train state
RESUME_MESH = "data2_fsdp2"
QUANT_KEYS = ["attn1", "attn2", ".ff."]
CAPTIONS = ["a red fox in the snow", "portrait of a cat", "a lighthouse at dusk",
            "a bowl of ramen, top view"]
NEGATIVES = ["blurry", "", "lowres, watermark", "oversaturated"]
STYLE_CAPTIONS = ["a <|style|> photo, <|style|> colours", "portrait of a cat",
                  "<|style|>, a lighthouse", "a bowl of ramen <|style|>"]
DRAFT_STEPS = 3  # sampler steps


# ------------------------------------------------------------------ data


def make_batch(kind: str, step: int) -> dict:
    """Step ``step``'s batch of ``kind`` (the same captions every step: the
    JAX DRaFT+ reward reads them at trace time)."""
    side = KINDS[kind][3]
    rng = np.random.default_rng(100 + step)
    if kind == "draft":
        return {"caption": list(CAPTIONS), "negative_prompt": list(NEGATIVES)}
    batch = {
        "image": rng.uniform(-1, 1, size=(BATCH, side, side, 3)).astype(np.float32),
        "caption": list(STYLE_CAPTIONS if kind == "style" else CAPTIONS),
        "original_size": rng.integers(48, 2 * side, size=(BATCH, 2)).astype(np.int32),
        "target_size": np.full((BATCH, 2), side, np.int32),
        "crop_coords_top_left": rng.integers(0, 16, size=(BATCH, 2)).astype(np.int32),
    }
    if kind in ("ip", "pfg", "style"):
        batch["reference_image"] = rng.uniform(-1, 1, size=(BATCH, 40, 40, 3)).astype(
            np.float32)
    return batch


def draft_timesteps() -> int:
    from vision_pt_tpu_torch.models.sdxl import Scheduler

    return len(Scheduler().get_timesteps(DRAFT_STEPS))


def make_draws(kind: str, step: int) -> dict:
    """Step ``step``'s draws of ``kind`` in the JAX package's form."""
    side = KINDS[kind][3]
    rng = np.random.default_rng(200 + step)
    latent = (BATCH, side // 8, side // 8, 4)
    if kind == "draft":
        return {"latents": rng.normal(size=latent).astype(np.float32),
                "step_noise": [rng.normal(size=latent).astype(np.float32)
                               for _ in range(draft_timesteps())]}
    draws = {"vae_noise": rng.normal(size=latent).astype(np.float32),
             "timesteps": rng.integers(0, 1000, size=BATCH).astype(np.int32),
             "noise": rng.normal(size=latent).astype(np.float32)}
    if kind == "rope":
        lowres = (BATCH, side // 16, side // 16, 4)
        draws.update(lowres_vae_noise=rng.normal(size=lowres).astype(np.float32),
                     lowres_noise=rng.normal(size=lowres).astype(np.float32))
    return draws


class BatchesConfig(BaseModel):
    """The batches of make_batch for one kind, as a dataset."""

    kind: str
    steps: int

    def get_dataset(self) -> list[dict]:
        return [make_batch(self.kind, n) for n in range(self.steps)]


# ------------------------------------------------------------------ workloads


class _Injected:
    """A workload over the test's weights and draws: ``inputs`` (set in each
    process) holds each kind's trainable state (the JAX weights, or none)
    and its draws by step-generator seed."""

    inputs: dict = {}
    kind = ""

    def setup_model(self):
        super().setup_model()
        spec = self.inputs["kinds"][self.kind]
        if spec.get("state") is not None:
            missing, unexpected = self._full_trainable.load_state_dict(spec["state"],
                                                                       strict=False)
            assert not unexpected, unexpected[:4]
        if self.kind == "loha_nf4":
            from vision_pt_tpu_torch.ops.quant import quantize_inplace

            quantize_inplace(self.model.denoiser, "bnb_nf4", include_keys=QUANT_KEYS)

    def draw_randoms(self, batch, generator):
        draws = self.inputs["draws"][self.kind][generator.initial_seed()]
        return {k: [torch.from_numpy(a) for a in v] if isinstance(v, list)
                else torch.from_numpy(v) for k, v in draws.items()}


@functools.cache
def workload_class(kind: str) -> type:
    module, name, _, _ = KINDS[kind]
    base = getattr(importlib.import_module(f"vision_pt_tpu_torch.workloads.{module}"), name)
    return type(f"Injected_{kind}", (_Injected, base), {"kind": kind})


def _step_seeds(steps: int) -> list[int]:
    """The seeds of the trainer's first ``steps`` step generators."""
    from vision_pt_tpu_torch.training.trainer import Trainer

    seeds = []
    for n in range(steps):
        probe = types.SimpleNamespace(config=types.SimpleNamespace(seed=SEED),
                                      _key_counter=n, device=torch.device("cpu"))
        seeds.append(Trainer._next_generator(probe).initial_seed())
    return seeds


def _set_inputs(inputs: dict) -> None:
    """The draws of each kind's step n under the seed of the trainer's n-th
    step generator, for the injected workloads."""
    seeds = _step_seeds(max(spec[2] for spec in KINDS.values()))
    _Injected.inputs = {"kinds": inputs["kinds"], "draws": {
        kind: dict(zip(seeds, draws)) for kind, draws in inputs["draws"].items()}}


def _config(inputs, kind, mesh=None, out=None, ckpt=None):
    spec = inputs["kinds"][kind]
    cfg = {
        "model": {**spec["model"], "tokenizer": "word-hash"},
        "dataset": {"kind": kind, "steps": KINDS[kind][2]},
        "peft": spec["peft"],
        "optimizer": spec["optimizer"],
        "saving": None if out is None else {
            "strategy": {"per_epochs": None},
            "callbacks": [{"type": "safetensors", "name": "sdxl", "save_dir": out}]},
        "seed": SEED, "num_train_epochs": 1,
        "trainer": {"mesh": mesh, "distributed_init": mesh is not None,
                    "gradient_checkpointing": kind == "loha_nf4"},
    }
    if ckpt is not None:
        cfg["trainer"]["checkpointing"] = {"save_dir": ckpt, "per_steps": 1, "resume": True}
    return cfg


def _trained(trainable) -> tuple[list[str], list[torch.nn.Parameter]]:
    named = [(n, p) for n, p in trainable.named_parameters() if p.requires_grad]
    return [n for n, _ in named], [p for _, p in named]


def _train(config, kind) -> dict:
    """Run the trainer: its losses, step-1 gradients, final trained tensors
    (gathered whole), the sharded parameters' placements, and what each step
    saw of the batch (DRaFT+'s captions and prompt rows, the style rows'
    offsets) and prodigy's d."""
    from torch.distributed.tensor import DTensor

    from vision_pt_tpu_torch.config import TrainConfig
    from vision_pt_tpu_torch.ops.attention import attention_dtype
    from vision_pt_tpu_torch.parallel.mesh import full_tensors
    from vision_pt_tpu_torch.training.trainer import Trainer

    trainer = Trainer(TrainConfig.model_validate(config), device="cpu")
    trainer.register_train_dataset_class(BatchesConfig)
    trainer.register_model_class(workload_class(kind))
    losses, grads, seen = [], [], []
    inner_step, inner_update = trainer.train_step, trainer._apply_update
    inner_loss = trainer.model.compute_loss

    def step(*args, **kwargs):
        loss, metrics = inner_step(*args, **kwargs)
        losses.append(float(loss))
        return loss, metrics

    def update(gs):
        if not grads:
            grads.append([g.numpy().copy() for g in full_tensors(list(gs))])
        inner_update(gs)

    def compute_loss(trainable, batch, draws):
        seen.append({"prompts": list(getattr(trainer.model, "_current_prompts", [])),
                     "ids2": batch["ids2"].numpy().copy(),
                     "offsets": [int(batch[f"style_offset_{i}"][0]) for i in (1, 2)
                                 if f"style_offset_{i}" in batch]})
        return inner_loss(trainable, batch, draws)

    trainer.train_step, trainer._apply_update = step, update
    trainer.model.compute_loss = compute_loss
    with attention_dtype(None):
        trainer.train()
    tree = trainer.model.trainable()
    names, params = _trained(tree)
    shared = trainer.optimizer.state.get("prodigy", {})
    run = {"losses": losses, "grads": dict(zip(names, grads[0])) if grads else {},
           "params": {n: v.detach().numpy().copy()
                      for n, v in zip(names, full_tensors([p.detach() for p in params]))},
           "sharded": {n: (p.requires_grad, [(type(pl).__name__, getattr(pl, "dim", None))
                                              for pl in p.placements])
                       for n, p in tree.named_parameters() if isinstance(p, DTensor)},
           "buffers": sorted(n for n, _ in tree.named_buffers()),
           "seen": seen, "steps": trainer.global_step,
           "d": shared["estim_lr"].numpy().copy() if "estim_lr" in shared else None}
    return run


# ------------------------------------------------------------------ ranks


def _mesh_case(kind, mesh_name, inputs, work, rank):
    import torch.distributed as dist

    tag = f"{kind}_{mesh_name}"
    ckpt = os.path.join(work, f"ckpt_{tag}")
    resume = mesh_name == RESUME_MESH
    run = _train(_config(inputs, kind, MESHES[mesh_name], os.path.join(work, f"out_{tag}"),
                         ckpt if resume else None), kind)
    if resume:
        if rank == 0:
            shutil.rmtree(os.path.join(ckpt, f"step_{KINDS[kind][2]:08d}"))
        dist.barrier()
        run["resumed"] = _train(_config(inputs, kind, MESHES[mesh_name], None, ckpt), kind)
    return run


def _publish(work: str, name: str, value) -> None:
    """Hand ``value`` to the ranks as ``name`` (written, then renamed into
    place)."""
    torch.save(value, os.path.join(work, name + ".part"))
    os.replace(os.path.join(work, name + ".part"), os.path.join(work, name))


def _received(work: str, name: str):
    """The value ``_publish`` hands over as ``name``, once it is there."""
    import time

    path = os.path.join(work, name)
    deadline = time.monotonic() + 420
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{name} never came")
        time.sleep(0.1)
    return torch.load(path, weights_only=False)


def _rank_main(rank, port, work):
    """One rank: every case, in order, each in one DeviceMesh a mesh shape;
    the JAX kinds' weights come in ``jax_inputs.pt`` once they are made.
    Each case is announced on stdout; a fatal signal, or SIGUSR1
    (``_spawn``'s wait sends it before killing a rank), dumps every
    thread's stack to stderr."""
    import faulthandler
    import signal

    import torch.distributed as dist

    import vision_pt_tpu_torch.training.trainer as trainer_module
    from vision_pt_tpu_torch.parallel.mesh import make_mesh, mesh_sizes, shard_module

    torch.set_num_threads(1)
    faulthandler.enable(all_threads=True)
    faulthandler.register(signal.SIGUSR1, all_threads=True)
    trainer_module.shard_module = functools.partial(shard_module,
                                                    min_size_to_shard=MIN_SHARD)
    meshes = {}

    def cached_mesh(config=None, devices=None):
        key = tuple(mesh_sizes(config, dist.get_world_size()))
        if key not in meshes:
            meshes[key] = make_mesh(config, devices)
        return meshes[key]

    trainer_module.make_mesh = cached_mesh
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(WORLD),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    inputs = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
    _set_inputs(inputs)
    dist.init_process_group("gloo")
    results = {}
    for kind, mesh_name in CASES:
        if kind in JAX_KINDS and "state" not in inputs["kinds"][kind]:
            for name, spec in _received(work, "jax_inputs.pt").items():
                inputs["kinds"][name].update(spec)
        print(f"[rank {rank}] case {kind} {mesh_name}", flush=True)
        try:
            results[kind, mesh_name] = _mesh_case(kind, mesh_name, inputs, work, rank)
        except Exception as e:  # recorded; the test of the case reports it
            results[kind, mesh_name] = {"error": f"{type(e).__name__}: {e}"}
        dist.barrier()
    torch.save(results, os.path.join(work, f"rank{rank}.pt"))
    meshes.clear()
    dist.destroy_process_group()


def _spawn(work, inputs):
    """Start the ranks; returns a function that waits for them (at most
    600 s; then each rank's stacks go to its stderr before it is killed)
    and loads their results."""
    import signal
    import time

    import torch.multiprocessing as mp

    torch.save(inputs, os.path.join(work, "inputs.pt"))
    ctx = mp.start_processes(_rank_main, args=(_free_port(), work), nprocs=WORLD,
                             join=False, start_method="spawn")

    def wait():
        deadline = time.monotonic() + 600
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for p in ctx.processes:  # one at a time: the dumps do not interleave
                    if p.is_alive():
                        os.kill(p.pid, signal.SIGUSR1)
                        time.sleep(1)
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError("the gloo ranks did not finish in 600 s (their stacks "
                                   "and last cases are in the captured output)")
        return [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
                for r in range(WORLD)]

    return wait


# ------------------------------------------------------------------ inputs


def _port_state(trees: dict) -> dict[str, torch.Tensor]:
    """{trainable path prefix: a JAX tree or its flat state} -> the port's
    state dict."""
    from vision_pt_tpu.utils.state_dict import flatten_state
    from vision_pt_tpu_torch.models.sdxl.convert import from_jax_state

    out = {}
    for prefix, tree in trees.items():
        flat = tree if isinstance(tree, dict) else flatten_state(tree)
        flat = {k: np.array(v) for k, v in flat.items()}
        out.update({f"{prefix}.{k}": v for k, v in from_jax_state(flat).items()})
    return out


def _jax_text_trees(model) -> dict:
    te = model.text_encoder
    return {"denoiser": model.denoiser, "vae": model.vae,
            "text_encoder.text_encoder_1": te.text_encoder_1,
            "text_encoder.text_encoder_2": te.text_encoder_2}


def _drawn_adapters(inputs, kind, path) -> str:
    """The port's adapters of ``kind`` (after the trainer's surgery over its
    seeded init) with every zero-initialised factor drawn nonzero, written
    as the workload saves them."""
    from safetensors.torch import save_file

    from vision_pt_tpu_torch.config import TrainConfig
    from vision_pt_tpu_torch.training.trainer import Trainer

    trainer = Trainer(TrainConfig.model_validate(_config(inputs, kind)), device="cpu")
    trainer.register_model_class(workload_class(kind))
    trainer.prepare_model()
    rng = np.random.default_rng(7)
    with torch.no_grad():
        for p in _trained(trainer.model.trainable())[1]:
            if not p.any():
                p.copy_(torch.from_numpy(rng.normal(size=p.shape).astype(np.float32) * 0.1))
    save_file({k: v.contiguous() for k, v in trainer.model.get_state_dict_to_save().items()},
              path)
    return path


def make_inputs(work: str) -> tuple[dict, object]:
    """Every kind's model config, PEFT, optimizer and draws (the state of the
    JAX kinds comes later), and a function that builds the JAX workloads of
    JAX_KINDS, adds their weights to the inputs and returns them with their
    draw patches."""
    from tests import test_torch_draft_plus as tdraft
    from tests import test_torch_ip_adapter as tip
    from tests import test_torch_prompt_free as tpfg
    from tests import test_torch_sdxl_rope as trope
    from tests import test_torch_style_tokenizer as tstyle
    from tests.test_torch_reward import write_pickscore_dir
    from tests.test_torch_sdxl_training import PEFT, TINY_MODEL
    from tests.test_torch_vision_towers import hf_clip_state, write_clip_dir
    from tests.models.test_timm_vit import _timm_state_dict

    from safetensors.numpy import save_file as save_numpy

    clip = write_clip_dir(_mkdir(work, "towers") / "clip", hf_clip_state("quick_gelu", seed=9),
                          "quick_gelu")
    timm = os.path.join(work, "towers", "vit_timm.safetensors")
    save_numpy(_timm_state_dict(np.random.default_rng(8)), timm)
    pickscore = write_pickscore_dir(_mkdir(work, "pickscore") / "clip")
    adamw = {"name": "adamw", "args": {"lr": 1e-3}}
    draft_model = {**tdraft.DRAFT_MODEL, "total_steps": DRAFT_STEPS,
                   "reward_models": [{"type": "pickscore", "weights_path": pickscore,
                                      "tokenizer": "word-hash"}]}
    loha = {**PEFT, "config": {**PEFT["config"], "type": "loha"}}
    kinds = {
        "ip": {"model": tip.ip_model_config(clip), "peft": None, "optimizer": adamw},
        "pfg": {"model": tpfg.pfg_model_config(timm), "peft": None, "optimizer": adamw},
        "rope": {"model": trope.ROPE_MODEL, "peft": PEFT, "optimizer": adamw},
        "draft": {"model": draft_model, "peft": PEFT, "optimizer": adamw},
        "style": {"model": tstyle.style_model_config(clip), "peft": None, "optimizer": adamw},
        "loha_nf4": {"model": TINY_MODEL, "peft": loha,
                     "optimizer": {"name": "bitsandbytes.optim.AdamW8bit",
                                   "args": {"lr": 1e-3}}},
        # a large estim_lr_coef, so d grows from its 1e-6 within the 3 steps
        "prodigy": {"model": TINY_MODEL, "peft": PEFT,
                    "optimizer": {"name": "prodigy",
                                  "args": {"lr": 1.0, "estim_lr_coef": 1e4}}},
        "adafactor": {"model": TINY_MODEL, "peft": PEFT,
                      "optimizer": {"name": "adafactor",
                                    "args": {"lr": 1e-2, "min_dim_size_to_factor": 2}}},
    }
    inputs = {"kinds": kinds, "draws": {kind: [make_draws(kind, n) for n in range(spec[2])]
                                        for kind, spec in KINDS.items()}}
    _set_inputs(inputs)
    for kind in ("rope", "loha_nf4", "prodigy", "adafactor"):
        path = _drawn_adapters(inputs, kind, os.path.join(work, f"adapters_{kind}.safetensors"))
        kinds[kind]["peft"] = {**kinds[kind]["peft"], "resume_weight_path": path}
    return inputs, functools.partial(_jax_workloads, inputs, clip, pickscore, work)


def _mkdir(work, name):
    import pathlib

    path = pathlib.Path(work) / name
    path.mkdir(exist_ok=True)
    return path


def _jax_workloads(inputs, clip, pickscore, work) -> dict:
    """The JAX workloads of JAX_KINDS over their tiny configs (every
    zero-initialised adapter weight drawn nonzero); their weights go into
    ``inputs`` for the port (draft's LoRA as a file); returns {kind:
    (workload, patches of one step's draws)}."""
    from safetensors.numpy import save_file

    import vision_pt_tpu.models.sdxl.scheduler as jscheduler
    import vision_pt_tpu.models.sdxl.vae as jvae
    import vision_pt_tpu.ops.loss.diffusion as jdiffusion
    import vision_pt_tpu.workloads.sdxl_draft_plus as jdraft
    import vision_pt_tpu.workloads.sdxl_ip_adapter as jip
    import vision_pt_tpu.workloads.sdxl_style_tokenizer as jstyle
    from tests import test_torch_draft_plus as tdraft
    from tests import test_torch_ip_adapter as tip
    from tests import test_torch_sdxl_rope as trope
    from tests.test_torch_sdxl_training import _JaxWithDraws
    from vision_pt_tpu.reward.pickscore import PickScoreRewardModel
    from vision_pt_tpu_torch.models.sdxl import WordHashTokenizer

    kinds = inputs["kinds"]

    def base_patches(module):
        return lambda d: ((module, "uniform_randint", lambda *a, **k: d["timesteps"]),
                          (jvae, "jax", _JaxWithDraws([d["vae_noise"]])),
                          (jdiffusion, "jax", _JaxWithDraws([d["noise"]])))

    out = {}
    ip = tip.jax_workload(jip.SDXLIPAdapterRefTraining, kinds["ip"]["model"])
    tip.draw_zero_init(ip.model.denoiser)
    kinds["ip"]["state"] = _port_state({**_jax_text_trees(ip.model),
                                        "image_proj": ip.model.image_proj})
    out["ip"] = (ip, base_patches(jip), ip.model.encoder)

    style = tip.jax_workload(jstyle.SDXLStyleTokenizerTraining, kinds["style"]["model"])
    style.model.setup_style_token()
    kinds["style"]["state"] = _port_state({**_jax_text_trees(style.model),
                                           "projector_1": style.model.projector_1,
                                           "projector_2": style.model.projector_2})
    out["style"] = (style, base_patches(jstyle), style.model.vision_encoder)

    brightness = {**kinds["draft"]["model"], "reward_models": [{"type": "brightness"}]}
    draft, dense, _ = trope.jax_lora_workload(jdraft.SDXLDRaFTPlusTraining, brightness)
    draft.reward_models = [PickScoreRewardModel(weights_path=pickscore,
                                                tokenizer=WordHashTokenizer())]
    # the dense weights from before the LoRA surgery, under the trainable's paths
    prefixes = dict(zip(("denoiser", "vae", "text_encoder_1", "text_encoder_2"),
                        _jax_text_trees(draft.model)))
    kinds["draft"]["state"] = _port_state({prefixes[k]: v for k, v in dense.items()})
    path = os.path.join(work, "adapters_draft.safetensors")
    save_file({k: np.ascontiguousarray(v) for k, v in draft.get_state_dict_to_save().items()},
              path)
    kinds["draft"]["peft"] = {**kinds["draft"]["peft"], "resume_weight_path": path}
    out["draft"] = (draft, lambda d: (
        (jdraft, "jax", tdraft._JaxWithNormals([d["latents"]])),
        (jscheduler, "jax", tdraft._JaxWithNormals(d["step_noise"]))), None)
    return out


def _jax_run(kind, workload, patches, encoder) -> dict:
    """The JAX workload's steps of ``kind`` under one ``nnx.jit`` (the draws
    arguments of it) with optax's AdamW: losses, step-1 gradients and the
    trained tensors after the run, under the port's names."""
    import jax
    import jax.numpy as jnp
    import optax
    from flax import nnx

    from tests.test_torch_ip_adapter import _adapter_keys
    from tests.test_torch_sdxl_training import _flat_grads
    from vision_pt_tpu.ops.attention import attention_dtype
    from vision_pt_tpu.peft import AdapterParam
    from vision_pt_tpu.training.optimizer import get_optimizer
    from vision_pt_tpu.training.scheduler import get_lr_schedule
    from vision_pt_tpu.utils.state_dict import flatten_state
    from vision_pt_tpu_torch.models.sdxl.convert import from_jax_state

    key = jax.random.key(0)
    tree = workload._full_trainable
    steps = KINDS[kind][2]
    draws = [make_draws(kind, n) for n in range(steps)]
    modules = {(m, name) for m, name, _ in patches(draws[0])}
    saved = {(m, name): getattr(m, name) for m, name in modules}

    @nnx.jit
    def grad_step(tree, arrays, d):
        for module, name, value in patches(d):
            setattr(module, name, value)
        return nnx.value_and_grad(lambda t: workload.compute_loss(t, arrays, key)[0],
                                  argnums=nnx.DiffState(0, AdapterParam))(tree)

    tx = get_optimizer("adamw", {}, learning_rate_schedule=get_lr_schedule(
        1e-3, None, None, total_steps=steps))
    params = nnx.state(tree, AdapterParam)
    opt_state = tx.init(params)
    losses, first = [], None
    to_port = lambda flat: {k: v.numpy() for k, v in from_jax_state(flat).items()}  # noqa: E731
    try:
        with attention_dtype(None):
            for n, d in enumerate(draws):
                arrays = workload.prepare_batch(make_batch(kind, n), key)
                if encoder is not None:
                    encoder(arrays["reference_pixels"])  # built outside the trace
                loss, grads = grad_step(tree, arrays, jax.tree.map(jnp.asarray, d))
                first = to_port(_flat_grads(grads)) if first is None else first
                updates, opt_state = tx.update(grads, opt_state, params)
                params = optax.apply_updates(params, updates)
                nnx.update(tree, params)
                losses.append(float(loss))
    finally:
        for (m, name), value in saved.items():
            setattr(m, name, value)
    keys = _adapter_keys(tree)
    final = {k: np.asarray(v) for k, v in flatten_state(tree).items() if k in keys}
    return {"losses": losses, "grads": first, "params": to_port(final)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results by case, the JAX runs and the one-process runs by
    kind, and the work directory."""
    work = str(tmp_path_factory.mktemp("sdxl_adapters_mesh"))
    inputs, jax_workloads = make_inputs(work)
    wait = _spawn(work, inputs)
    jax_side = jax_workloads()
    _publish(work, "jax_inputs.pt", {kind: {k: v for k, v in inputs["kinds"][kind].items()
                                            if k in ("state", "peft")}
                                     for kind in JAX_KINDS})
    jax_runs = {kind: _jax_run(kind, *jax_side[kind]) for kind in JAX_KINDS}
    one = {}
    for kind in KINDS:
        out = os.path.join(work, f"out_one_{kind}")
        one[kind] = {**_train(_config(inputs, kind, out=out), kind), "out": out}
    return types.SimpleNamespace(ranks=wait(), jax=jax_runs, one=one, work=work)


# ------------------------------------------------------------------ checks


def check_against(ours: dict, theirs: dict, kind: str, what: str) -> None:
    """Losses, step-1 gradients (each trained tensor) and the trained
    tensors after the run (all together; each element for the optax
    kinds) of a run against a reference run."""
    np.testing.assert_allclose(ours["losses"], theirs["losses"], rtol=LOSS_RTOL,
                               err_msg=what)
    grads, want = ours["grads"], theirs["grads"]
    assert want.keys() == grads.keys() and want, (what, sorted(set(want) ^ set(grads))[:4])
    for key, value in want.items():
        assert np.abs(value).max() > 0, (what, key)
        assert _rel_l2(grads[key], value) <= GRAD_RTOL, (what, key, _rel_l2(grads[key], value))
    params = {k: v for k, v in theirs["params"].items() if k in ours["params"]}
    assert params.keys() == ours["params"].keys(), what
    if kind in OPTAX_KINDS:
        for key, value in params.items():
            np.testing.assert_allclose(ours["params"][key], value, rtol=0, atol=OPTAX_ATOL,
                                       err_msg=f"{what}: {key}")
    else:
        err = _whole_rel_l2(ours["params"], params)
        assert err <= PARAM_RTOL, (what, err)


# ------------------------------------------------------------------ tests


@pytest.mark.parametrize("kind,mesh", CASES)
def test_mesh_run_matches_the_one_process_run(runs, kind, mesh):
    for rank in runs.ranks:
        ours = _ok(rank[kind, mesh])
        assert len(ours["losses"]) == KINDS[kind][2]
        check_against(ours, runs.one[kind], kind, f"{kind} {mesh} against one process")


@pytest.mark.parametrize("kind,mesh", [(k, m) for k, m in CASES if k in JAX_KINDS])
def test_mesh_run_matches_jax(runs, kind, mesh):
    for rank in runs.ranks:
        check_against(_ok(rank[kind, mesh]), runs.jax[kind], kind, f"{kind} {mesh} against JAX")


@pytest.mark.parametrize("kind", JAX_KINDS)
def test_one_process_run_matches_jax(runs, kind):
    check_against(runs.one[kind], runs.jax[kind], kind, f"{kind} one process against JAX")


@pytest.mark.parametrize("kind,mesh", CASES)
def test_rank_zero_saves_the_one_process_file(runs, kind, mesh):
    """Rank 0's file has the one-process file's keys, shapes and dtypes, and
    its values to PARAM_RTOL over all of them (OPTAX_ATOL each for the
    optax kinds); the other ranks write nothing."""
    from safetensors.numpy import load_file

    _ok(runs.ranks[0][kind, mesh])
    ours = glob.glob(os.path.join(runs.work, f"out_{kind}_{mesh}", "sdxl*.safetensors"))
    theirs = glob.glob(os.path.join(runs.one[kind]["out"], "sdxl*.safetensors"))
    assert len(ours) == len(theirs) == 1, (ours, theirs)
    ours, theirs = load_file(ours[0]), load_file(theirs[0])
    assert ours.keys() == theirs.keys() and ours
    assert all(ours[k].shape == v.shape and ours[k].dtype == v.dtype
               for k, v in theirs.items())
    if kind in OPTAX_KINDS:
        for key, value in theirs.items():
            np.testing.assert_allclose(ours[key], value, rtol=0, atol=OPTAX_ATOL, err_msg=key)
    else:
        assert _whole_rel_l2(ours, theirs) <= PARAM_RTOL, _whole_rel_l2(ours, theirs)


@pytest.mark.parametrize("kind,mesh", [(k, m) for k, m in CASES if m == RESUME_MESH])
def test_resume_under_the_mesh_matches_the_unbroken_run(runs, kind, mesh):
    """The run resumed from the last-but-one step's train state trains the
    last step as the unbroken run did, to the bit."""
    for rank in runs.ranks:
        run = _ok(rank[kind, mesh])
        resumed = run["resumed"]
        assert resumed["steps"] == KINDS[kind][2] and len(resumed["losses"]) == 1
        np.testing.assert_allclose(resumed["losses"], run["losses"][-1:], rtol=1e-6)
        for key, value in run["params"].items():
            np.testing.assert_array_equal(resumed["params"][key], value, err_msg=key)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_prodigy_d_is_the_same_on_every_rank(runs, mesh):
    """One all-reduce of each sum gives every rank the same d, which grew
    from its initial 1e-6, and the one-process d to fp32 rounding."""
    ds = [_ok(rank["prodigy", mesh])["d"] for rank in runs.ranks]
    assert all(d.tobytes() == ds[0].tobytes() for d in ds), ds
    assert float(ds[0]) > 1e-6
    np.testing.assert_allclose(ds[0], runs.one["prodigy"]["d"], rtol=1e-5)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_draft_plus_ranks_hold_their_own_prompts_positive_and_negative_rows(runs, mesh):
    """Each rank's rows are [its caption; its negative prompt], and the
    reward reads its caption."""
    whole = runs.one["draft"]["seen"][0]
    ids = whole["ids2"].reshape(2 * BATCH, -1, whole["ids2"].shape[-1])
    assert whole["prompts"] == CAPTIONS
    for r, rank in enumerate(runs.ranks):
        for seen in _ok(rank["draft", mesh])["seen"]:
            assert seen["prompts"] == [CAPTIONS[r]]
            local = seen["ids2"].reshape(2, -1, ids.shape[-1])
            np.testing.assert_array_equal(local[0], ids[r])
            np.testing.assert_array_equal(local[1], ids[BATCH + r])


def test_style_rank_reads_another_ranks_style_rows(runs):
    """Under every mesh each rank starts its placeholders at the whole
    batch's offset, and some rank's first placeholder falls in another
    sample's style rows (encoder 1's expansion is 4 rows a placeholder,
    encoder 2's one)."""
    tokens = 4
    whole = runs.one["style"]["seen"][0]
    assert whole["offsets"] == [0, 0]
    for mesh in MESHES:
        starts = [_ok(rank["style", mesh])["seen"][0]["offsets"] for rank in runs.ranks]
        assert starts == [[0, 0], [8, 2], [8, 2], [12, 3]], starts
        # encoder 2: rank 2's first placeholder takes row 2, of sample 0's
        # rows (rank 0's), not its own sample's (from row 8)
        assert starts[2][1] // tokens == 0
        # encoder 1: rank 0's 8 placeholder rows run into sample 1's rows
        assert starts[1][0] == 2 * tokens


def test_loha_factors_and_nf4_codes_are_placed_as_the_jax_rule_places_them(runs):
    """Under {data 2, fsdp 2} FSDP splits LoHa factors on the first divisible
    axis of their (JAX) layout; the NF4 codes and scales stay whole buffers."""
    for rank in runs.ranks:
        run = _ok(rank["loha_nf4", "data2_fsdp2"])
        trains = {n: place for n, (grad, place) in run["sharded"].items() if grad}
        assert trains and all(".hada_w" in n for n in trains), sorted(trains)[:4]
        # (in 64, rank 2): split on the 64
        name = "denoiser.middle_block.blocks.1.transformer_blocks.0.attn1.to_q.hada_w1_a"
        assert trains[name] == [("Replicate", None), ("Shard", 0)]
        assert not [n for n in run["sharded"] if ".to_q.linear." in n]
        assert any(".to_q.linear." in n for n in run["buffers"])


def test_every_sdxl_workload_declares_the_data_and_fsdp_mesh():
    """Every SDXL workload runs under data and fsdp, and names the draws a
    rank takes its rows of."""
    import vision_pt_tpu_torch.workloads as workloads
    from vision_pt_tpu_torch.training.model import ModelForTraining

    base = ("vae_noise", "timesteps", "noise")
    want = {"SDXLRoPEDistillTraining": base + ("lowres_vae_noise", "lowres_noise"),
            "SDXLDRaFTPlusTraining": ("latents", "step_noise")}
    classes = []
    for name in ("sdxl_text_to_image", "sdxl_flow_match", "sdxl_ip_adapter",
                 "sdxl_prompt_free", "sdxl_rope_distill", "sdxl_draft_plus",
                 "sdxl_style_tokenizer"):
        module = importlib.import_module(f"{workloads.__name__}.{name}")
        classes += [c for c in vars(module).values() if isinstance(c, type)
                    and issubclass(c, ModelForTraining) and c.__module__ == module.__name__]
    assert len(classes) == 10, classes
    for cls in classes:
        assert cls.mesh_draws == want.get(cls.__name__, base), cls
        assert cls.mesh_axes == ("data", "fsdp"), cls
