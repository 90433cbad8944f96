"""The port's SDXL LoRA trainer under ``trainer.mesh`` on a 4-rank gloo
group on the CPU, against the port's one-process run and the JAX package's
one-device step; the helpers here also serve
``tests/test_torch_sdxl_distributed_qlora_flow.py`` (QLoRA with AdamW8bit,
flow-match), which spawns its own ranks.

The tiny SDXL of ``tests/test_torch_sdxl_training.py`` (``TINY_MODEL``, LoRA
rank 2 on attn1, attn2 and .ff., every ``lora_up`` drawn nonzero), batch 4 at
64², two steps, fp32 under ``attention_dtype(None)``. The weights are the JAX
workload's (``from_jax_state``), the adapters reach the port's trainer
through ``peft.resume_weight_path``, and each step's draws (the VAE sample's
noise, the timesteps, the latent noise) are the same arrays on both sides:
the port's workload looks them up by its step generator's seed, so a resumed
run draws what the unbroken one drew. Here: LoRA + schedule-free under
{data 4} and {data 2, fsdp 2}. The ranks split arrays of MIN_SHARD elements
or more (2**14 in a run), so LoRA factors and frozen base weights are
FSDP-sharded; the test names some.

Each case, against the one-process run and the JAX run: the losses within
LOSS_RTOL relative, every adapter's step-1 gradient within GRAD_RTOL
relative L2, and the adapters after the two steps within ADAPTER_RTOL
relative L2, taken over all of them together (one tensor alone is not held
to it: a component whose step-1 gradient is fp32 noise, 1.7e-9 against
3.7e-9 here, takes schedule-free's normalised step g / (|g| + eps) at 0.14
or 0.27 of the rate, which puts single tensors up to 1.8e-4 apart; all
together the measured gaps are 6.5e-6 against the one-process run and
9.6e-6 against JAX). Rank 0's adapter file is the one-process run's within
ADAPTER_RTOL; a run resumed from the step-1 train state equals the unbroken
one. The tensor and seq axes raise under a mesh, with LoHa and prodigy too.

One spawn of 4 processes runs every case of a file; each rank writes its
results to a file, and the tests read them. The JAX side and the
one-process runs go in this process meanwhile; the ranks import no JAX.
"""

import functools
import glob
import os
import shutil
import socket
import time
import types

import numpy as np
import pytest
import torch
from pydantic import BaseModel

from vision_pt_tpu_torch.workloads.sdxl_flow_match import SDXLForFlowMatchingTraining
from vision_pt_tpu_torch.workloads.sdxl_text_to_image import SDXLForTextToImageTraining

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for torch in this module's process (imported by
    the heavy port test files, it applies to each of them): the suite runs
    in several worker processes at once, and on a shared host torch's
    threads beyond one wait on each other (the trainer's entry-point test
    took 67 s with 8 threads beside 6 busy processes, 3.2 s with one)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


WORLD, SEED, BATCH, SIDE, STEPS = 4, 0, 4, 64, 2
MIN_SHARD = 128
LOSS_RTOL, GRAD_RTOL, ADAPTER_RTOL = 1e-5, 1e-4, 1e-4
QUANT_KEYS = ["attn1", "attn2", ".ff."]
PEFT = {"config": {"type": "lora", "rank": 2, "alpha": 1.0, "dtype": "float32"},
        "include_keys": ["attn1", "attn2", ".ff."],
        "exclude_keys": ["text_encoder", "vae"]}
# case -> (workload kind, mesh); each kind trains with its shipped config's
# optimizer
CASES = {
    "lora_data4": ("lora", {"data": 4}),
    "lora_data2_fsdp2": ("lora", {"data": 2, "fsdp": 2}),
    "qlora_data2_fsdp2": ("qlora", {"data": 2, "fsdp": 2}),
    "flow_data2_fsdp2": ("flow", {"data": 2, "fsdp": 2}),
}
LORA_CASES = ["lora_data4", "lora_data2_fsdp2"]
KINDS = {"lora": "schedulefree.RAdamScheduleFree", "qlora": "bitsandbytes.optim.AdamW8bit",
         "flow": "schedulefree.RAdamScheduleFree"}
REFUSALS = {  # name -> (config changes, mesh): LoHa and prodigy under the axes that stay
    "loha": ({"peft": {**PEFT, "config": {**PEFT["config"], "type": "loha"}}},
             {"data": 2, "tensor": 2}),
    "tensor": ({}, {"data": 2, "tensor": 2}),
    "seq": ({}, {"data": 2, "seq": 2}),
    "prodigy": ({"optimizer": {"name": "prodigy", "args": {"lr": 1.0}}}, {"data": 2, "seq": 2}),
}
CAPTIONS = ["a red fox in the snow " * 12, "portrait of a cat", "a lighthouse at dusk",
            "a bowl of ramen, top view"]


def make_batch(step: int) -> dict:
    rng = np.random.default_rng(100 + step)
    return {
        "image": rng.uniform(-1, 1, size=(BATCH, SIDE, SIDE, 3)).astype(np.float32),
        "caption": CAPTIONS[step:] + CAPTIONS[:step],
        "original_size": rng.integers(48, 128, size=(BATCH, 2)).astype(np.int32),
        "target_size": np.full((BATCH, 2), SIDE, np.int32),
        "crop_coords_top_left": rng.integers(0, 16, size=(BATCH, 2)).astype(np.int32),
    }


def make_draws(kind: str, step: int) -> dict:
    """The step's draws in the JAX package's form: integer timesteps, or the
    flow-match sampler's t in (0, 1)."""
    rng = np.random.default_rng(200 + step)
    latent = (BATCH, SIDE // 8, SIDE // 8, 4)
    timesteps = (rng.uniform(0.05, 0.95, size=BATCH).astype(np.float32) if kind == "flow"
                 else rng.integers(0, 1000, size=BATCH).astype(np.int32))
    return {"vae_noise": rng.normal(size=latent).astype(np.float32),
            "timesteps": timesteps,
            "noise": rng.normal(size=latent).astype(np.float32)}


class BatchesConfig(BaseModel):
    """The STEPS batches of make_batch, as a dataset."""

    steps: int = STEPS

    def get_dataset(self) -> list[dict]:
        return [make_batch(n) for n in range(self.steps)]


class _Injected:
    """The JAX workload's dense weights (NF4-quantized for QLoRA) and each
    step's draws, keyed by the step generator's seed (class attributes, set
    in each process)."""

    dense: dict = {}
    draws: dict = {}
    quantized = False

    def setup_model(self):
        from vision_pt_tpu_torch.models.sdxl.convert import from_jax_state
        from vision_pt_tpu_torch.ops.quant import quantize_inplace

        super().setup_model()
        model = self.model
        model.denoiser.load_state_dict(from_jax_state(self.dense["denoiser"]))
        model.vae.load_state_dict(from_jax_state(self.dense["vae"]))
        for name in ("text_encoder_1", "text_encoder_2"):
            getattr(model.text_encoder, name).load_state_dict(
                from_jax_state(self.dense[name]))
        if self.quantized:
            quantize_inplace(model.denoiser, "bnb_nf4", include_keys=QUANT_KEYS)

    def draw_randoms(self, batch, generator):
        return {k: torch.from_numpy(v) for k, v in
                self.draws[generator.initial_seed()].items()}


class _LoRA(_Injected, SDXLForTextToImageTraining):
    pass


class _QLoRA(_Injected, SDXLForTextToImageTraining):
    quantized = True


class _Flow(_Injected, SDXLForFlowMatchingTraining):
    pass


WORKLOADS = {"lora": _LoRA, "qlora": _QLoRA, "flow": _Flow}


def _set_inputs(inputs: dict, kind: str) -> None:
    """Point the injected workloads at ``kind``'s weights and draws: the
    draws of step n under the seed of the trainer's n-th step generator."""
    from vision_pt_tpu_torch.training.trainer import Trainer

    seeds = []
    for n in range(STEPS):
        probe = types.SimpleNamespace(config=types.SimpleNamespace(seed=SEED),
                                      _key_counter=n, device=torch.device("cpu"))
        seeds.append(Trainer._next_generator(probe).initial_seed())
    _Injected.dense = inputs[kind]["dense"]
    _Injected.draws = {}
    for seed, d in zip(seeds, inputs[kind]["draws"]):
        port = dict(d)
        if kind == "flow":  # the port's workload draws t * 1000
            port["timesteps"] = d["timesteps"] * np.float32(1000.0)
        _Injected.draws[seed] = port


def _config(inputs, kind, mesh=None, out=None, ckpt=None, **changes):
    model = {**inputs["model"], "tokenizer": "word-hash"}
    if kind == "flow":
        model.update(model_prediction="velocity", loss_type="velocity")
    cfg = {
        "model": model,
        "dataset": {"steps": STEPS},
        "peft": {**PEFT, "resume_weight_path": inputs[kind]["adapters"]},
        "optimizer": {"name": KINDS[kind], "args": {"lr": 1e-3}},
        "saving": None if out is None else {
            "strategy": {"per_epochs": None},
            "callbacks": [{"type": "safetensors", "name": "sdxl", "save_dir": out}]},
        # a preview before the final save leaves FSDP's root groups gathered
        "preview": None if out is None else {
            "strategy": {"per_epochs": 1},
            "callbacks": [{"type": "local", "save_dir": os.path.join(out, "preview")}],
            "data": {"data": [{"prompt": "a fox", "width": SIDE, "height": SIDE,
                               "num_steps": 2, "cfg_scale": 2.0, "seed": 42}]}},
        "seed": SEED, "num_train_epochs": 1,
        "trainer": {"mesh": mesh, "distributed_init": mesh is not None,
                    "gradient_checkpointing": kind == "qlora"},
    }
    if ckpt is not None:
        cfg["trainer"]["checkpointing"] = {"save_dir": ckpt, "per_steps": 1, "resume": True}
    cfg.update(changes)
    return cfg


def _trainer(config, kind):
    from vision_pt_tpu_torch.config import TrainConfig
    from vision_pt_tpu_torch.data.preview import TextToImagePreviewConfig
    from vision_pt_tpu_torch.training.trainer import Trainer

    trainer = Trainer(TrainConfig.model_validate(config), device="cpu")
    trainer.register_train_dataset_class(BatchesConfig)
    trainer.register_preview_dataset_class(TextToImagePreviewConfig)
    trainer.register_model_class(WORKLOADS[kind])
    return trainer


def _adapters(trainable) -> dict[str, np.ndarray]:
    """The LoRA factors, gathered whole (a collective under a mesh)."""
    from vision_pt_tpu_torch.parallel.mesh import full_tensors

    names = [n for n, p in trainable.named_parameters() if p.requires_grad]
    params = [p.detach() for p in trainable.parameters() if p.requires_grad]
    return {n: v.numpy().copy() for n, v in zip(names, full_tensors(params))}


def _train(config, kind, replay=False):
    """Run the trainer; returns its losses, final adapters (whole) and
    sharded parameters, and with ``replay`` the first step's adapters, every
    update's gradients and the 8-bit state, gathered whole."""
    from torch.distributed.tensor import DTensor

    from vision_pt_tpu_torch.ops.attention import attention_dtype
    from vision_pt_tpu_torch.parallel.mesh import flax_perms, full_tensors

    trainer = _trainer(config, kind)
    losses, grads, start = [], [], {}
    inner_step, inner_update = trainer.train_step, trainer._apply_update

    def step(*args, **kwargs):
        if not start:
            start.update(_adapters(trainer.model.trainable()))
        loss, metrics = inner_step(*args, **kwargs)
        losses.append(float(loss))
        return loss, metrics

    def update(gs):
        grads.append([g.numpy().copy() for g in full_tensors(list(gs))])
        inner_update(gs)

    trainer.train_step, trainer._apply_update = step, update
    with attention_dtype(None):
        trainer.train()
    tree = trainer.model.trainable()
    sharded = {n: (p.requires_grad, [(type(pl).__name__, getattr(pl, "dim", None))
                                      for pl in p.placements])
               for n, p in tree.named_parameters() if isinstance(p, DTensor)}
    names = [n for n, p in tree.named_parameters() if p.requires_grad]
    params = [p for p in tree.parameters() if p.requires_grad]
    opt = trainer.optimizer
    # what a save writes: schedule-free's x, else the parameters
    evaluated = opt.eval_params() if hasattr(opt, "eval_params") else {}
    run = {"losses": losses, "adapters": _adapters(tree), "sharded": sharded,
           "start": start, "grads": [dict(zip(names, step)) for step in grads],
           "saved_values": {n: v.detach().numpy().copy() for n, v in zip(
               names, full_tensors([evaluated.get(p, p) for p in params]))}}
    if replay:
        perms = flax_perms(tree)
        run.update(perms={n: perms[p] for n, p in zip(names, params)},
                   state={n: {k: (v.numpy().copy() if isinstance(v, torch.Tensor) else v)
                              for k, v in full_tensors(dict(opt.state[p])).items()}
                          for n, p in zip(names, params)},
                   blocks={n: sorted(set(opt._layout(p).blocks.tolist()))
                           for n, p in zip(names, params) if isinstance(p, DTensor)})
    return run, trainer


# ------------------------------------------------------------------ ranks


def _case(name, inputs, work, rank):
    import torch.distributed as dist

    kind, mesh = CASES[name]
    _set_inputs(inputs, kind)
    ckpt = os.path.join(work, f"ckpt_{name}")
    cfg = _config(inputs, kind, mesh, os.path.join(work, f"out_{name}"), ckpt)
    run, trainer = _train(cfg, kind, replay=kind == "qlora")
    run.update(backend=dist.get_backend(), world=dist.get_world_size(),
               rank=dist.get_rank(), device=str(trainer.device))
    del trainer
    if rank == 0:
        shutil.rmtree(os.path.join(ckpt, "step_00000002"))
    dist.barrier()
    resumed, trainer = _train(_config(inputs, kind, mesh, None, ckpt), kind)
    run["resumed"] = {**resumed, "steps": trainer.global_step}
    return run


def _refusal(name, inputs):
    changes, mesh = REFUSALS[name]
    _set_inputs(inputs, "lora")
    trainer = _trainer(_config(inputs, "lora", mesh, **changes), "lora")
    try:
        trainer.before_train()
    except NotImplementedError as e:
        return {"raised": str(e)}
    return {"raised": None}


def _rank_main(rank, port, work):
    """One rank: every case and refusal ``inputs.pt`` names, in order."""
    import torch.distributed as dist

    from vision_pt_tpu_torch.parallel.mesh import shard_module
    from vision_pt_tpu_torch.training import trainer as trainer_module

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(WORLD),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    inputs = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
    trainer_module.shard_module = functools.partial(shard_module,
                                                    min_size_to_shard=MIN_SHARD)
    results = {}

    def case(name, fn):
        try:
            results[name] = fn()
        except Exception as e:  # recorded; the test of the case reports it
            results[name] = {"error": f"{type(e).__name__}: {e}"}

    for name in inputs["cases"]:
        case(name, lambda name=name: _case(name, inputs, work, rank))
    for name in inputs["refusals"]:
        case(f"refuse_{name}", lambda name=name: _refusal(name, inputs))
    torch.save(results, os.path.join(work, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(work, inputs):
    """Start the ranks on ``inputs`` (handed over in a file); returns a
    function that waits for them (at most 300 s) and loads their results."""
    import torch.multiprocessing as mp

    torch.save(inputs, os.path.join(work, "inputs.pt"))
    ctx = mp.start_processes(_rank_main, args=(_free_port(), work), nprocs=WORLD,
                             join=False, start_method="spawn")

    def wait():
        deadline = time.monotonic() + 300
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError("the gloo ranks did not finish in 300 s")
        return [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
                for r in range(WORLD)]

    return wait


# ------------------------------------------------------------------ JAX side


def _jax_tree(kind):
    """The JAX workload over the tiny model with its adapters (every
    ``lora_up`` nonzero), its dense weights, and its adapter file's
    contents (the JAX workload's keys)."""
    from tests import test_torch_sdxl_flow_match as fm
    from tests import test_torch_sdxl_training as t2i

    if kind == "flow":
        fields = {**t2i.TINY_MODEL, "model_prediction": "velocity", "loss_type": "velocity"}
        workload, dense, _ = fm.jax_tree(fields)
    else:
        workload, dense, _ = t2i.jax_tree(kind == "qlora")
    adapters = {k: torch.from_numpy(np.array(v, order="C"))
                for k, v in workload.get_state_dict_to_save().items()}
    return workload, dense, adapters


def _jax_run(workload, kind, batches, draws) -> dict:
    """The JAX workload's STEPS steps (jitted value-and-grad over the
    adapters, the JAX package's optimizer): losses, step-1 gradients and
    final adapters."""
    import jax
    import jax.numpy as jnp
    import optax
    from flax import nnx

    import vision_pt_tpu.models.sdxl.vae as jvae
    from tests import test_torch_sdxl_flow_match as fm
    from tests import test_torch_sdxl_training as t2i
    from vision_pt_tpu.ops.attention import attention_dtype
    from vision_pt_tpu.peft import AdapterParam
    from vision_pt_tpu.training.optimizer import get_optimizer
    from vision_pt_tpu.training.scheduler import get_lr_schedule
    from vision_pt_tpu.utils.state_dict import flatten_state

    if kind == "flow":
        module, sampler, noise_module = fm.jworkload, "sample_timestep", fm.jflow
    else:
        module, sampler, noise_module = t2i.jworkload, "uniform_randint", t2i.jdiffusion
    key = jax.random.key(0)
    tree = workload._full_trainable

    @nnx.jit
    def grad_step(tree, batch, vae_noise, timesteps, noise):
        with pytest.MonkeyPatch.context() as patch:
            patch.setattr(module, sampler, lambda *a, **k: timesteps)
            patch.setattr(jvae, "jax", t2i._JaxWithDraws([vae_noise]))
            patch.setattr(noise_module, "jax", t2i._JaxWithDraws([noise]))
            return nnx.value_and_grad(
                lambda t: workload.compute_loss(t, batch, key)[0],
                argnums=nnx.DiffState(0, AdapterParam))(tree)

    schedule = get_lr_schedule(1e-3, None, None, total_steps=STEPS)
    tx = get_optimizer(KINDS[kind], {}, learning_rate_schedule=schedule)
    params = nnx.state(tree, AdapterParam)
    opt_state = tx.init(params)
    losses, first = [], None
    with attention_dtype(None):
        for batch, d in zip(batches, draws):
            arrays = workload.prepare_batch(batch, key)
            loss, grads = grad_step(tree, arrays, *(jnp.asarray(d[k]) for k in
                                                    ("vae_noise", "timesteps", "noise")))
            first = t2i._flat_grads(grads) if first is None else first
            updates, opt_state = tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            nnx.update(tree, params)
            losses.append(float(loss))
    final = {k: np.asarray(v) for k, v in flatten_state(tree).items() if ".lora_" in k}
    return {"losses": losses, "grads": first, "adapters": final}


def make_runs(tmp_path_factory, cases, refusals=()):
    """The ranks' results for ``cases`` and ``refusals``, the JAX runs and
    the one-process runs of their kinds (the adapters and step-1 gradients
    under the port's names), and the work directory."""
    from vision_pt_tpu_torch.models.sdxl.convert import from_jax_state

    from safetensors.torch import save_file

    from tests.test_torch_sdxl_training import TINY_MODEL

    work = str(tmp_path_factory.mktemp("sdxl_mesh"))
    kinds = sorted({CASES[c][0] for c in cases})
    assert not refusals or "lora" in kinds  # the refusals take the LoRA config
    batches = [make_batch(n) for n in range(STEPS)]
    trees, inputs = {}, {"model": TINY_MODEL, "cases": list(cases),
                         "refusals": list(refusals)}
    for kind in kinds:
        workload, dense, adapters = _jax_tree(kind)
        path = os.path.join(work, f"adapters_{kind}.safetensors")
        save_file(adapters, path)
        trees[kind] = workload
        inputs[kind] = {"dense": dense, "adapters": path,
                        "draws": [make_draws(kind, n) for n in range(STEPS)]}
    wait = _spawn(work, inputs)
    to_port = lambda tree: {k: v.numpy() for k, v in from_jax_state(tree).items()}  # noqa: E731
    jax_runs, one = {}, {}
    for kind in kinds:
        run = _jax_run(trees[kind], kind, batches, inputs[kind]["draws"])
        jax_runs[kind] = {"losses": run["losses"], "grads": [to_port(run["grads"])],
                          "adapters": to_port(run["adapters"])}
        _set_inputs(inputs, kind)
        out = os.path.join(work, f"out_one_{kind}")
        one[kind] = _train(_config(inputs, kind, out=out), kind, replay=kind == "qlora")[0]
        one[kind]["out"] = out
    return wait(), jax_runs, one, work


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return make_runs(tmp_path_factory, LORA_CASES, REFUSALS)


# ------------------------------------------------------------------ checks


def _ok(result):
    assert "error" not in result, result["error"]
    return result


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _whole_rel_l2(ours: dict, theirs: dict) -> float:
    """Relative L2 over every tensor of ``theirs`` together."""
    keys = sorted(theirs)
    return _rel_l2(np.concatenate([np.ravel(ours[k]) for k in keys]),
                   np.concatenate([np.ravel(theirs[k]) for k in keys]))


def check_against(ours: dict, theirs: dict, what: str) -> None:
    """Losses, step-1 gradients (each adapter) and final adapters (all
    together) of a run against a reference run."""
    np.testing.assert_allclose(ours["losses"], theirs["losses"], rtol=LOSS_RTOL,
                               err_msg=what)
    grads, want = ours["grads"][0], theirs["grads"][0]
    assert want.keys() == grads.keys(), (what, sorted(set(want) ^ set(grads))[:4])
    for key, value in want.items():
        assert np.abs(value).max() > 0, (what, key)
        assert _rel_l2(grads[key], value) <= GRAD_RTOL, (what, key, _rel_l2(grads[key], value))
    adapters = {k: v for k, v in theirs["adapters"].items() if k in ours["adapters"]}
    assert adapters.keys() == ours["adapters"].keys(), what
    assert _whole_rel_l2(ours["adapters"], adapters) <= ADAPTER_RTOL, (
        what, _whole_rel_l2(ours["adapters"], adapters))


def check_mesh_case(runs, case: str) -> None:
    """A mesh case on every rank against the one-process and the JAX runs."""
    ranks, jax_runs, one, _ = runs
    kind = CASES[case][0]
    for rank in ranks:
        ours = _ok(rank[case])
        assert len(ours["losses"]) == STEPS
        check_against(ours, one[kind], f"{case} against one process")
        check_against(ours, jax_runs[kind], f"{case} against JAX")


def check_file(runs, case: str) -> None:
    """Rank 0's adapter file (after a preview) against the one-process run's,
    which holds what the run ended on (schedule-free: x) bit for bit."""
    from safetensors.numpy import load_file

    from vision_pt_tpu_torch.models.sdxl.convert import convert_to_comfy_key

    ranks, _, one, work = runs
    _ok(ranks[0][case])
    kind = CASES[case][0]
    out = os.path.join(work, f"out_{case}")
    assert len(os.listdir(os.path.join(out, "preview"))) == 1
    ours = glob.glob(os.path.join(out, "sdxl*.safetensors"))
    theirs = glob.glob(os.path.join(one[kind]["out"], "sdxl*.safetensors"))
    assert len(ours) == len(theirs) == 1, (ours, theirs)
    ours, theirs = load_file(ours[0]), load_file(theirs[0])
    for name, value in one[kind]["saved_values"].items():
        np.testing.assert_array_equal(theirs[convert_to_comfy_key(name)], value, err_msg=name)
    assert ours.keys() == theirs.keys()
    assert all(k.startswith("diffusion_model.") for k in ours)
    assert all(ours[k].shape == v.shape and ours[k].dtype == v.dtype
               for k, v in theirs.items())
    assert _whole_rel_l2(ours, theirs) <= ADAPTER_RTOL, _whole_rel_l2(ours, theirs)


def check_resume(runs, case: str) -> None:
    """The run resumed from the step-1 train state (the shards gathered,
    written once and put back: the schedule-free z and nu, the 8-bit codes
    and scales) trains step 2 as the unbroken run did, to the bit."""
    ranks, _, _, _ = runs
    for rank in ranks:
        run = _ok(rank[case])
        resumed = run["resumed"]
        assert resumed["steps"] == STEPS and len(resumed["losses"]) == 1
        np.testing.assert_allclose(resumed["losses"], run["losses"][1:], rtol=1e-6)
        for key, value in run["adapters"].items():
            np.testing.assert_array_equal(resumed["adapters"][key], value, err_msg=key)


# a LoRA factor (2, 64): the flax kernel (64, 2), split on its 64 (torch
# dim 1), and frozen weights: a text tower's token table, a conv, a dense
# base linear (NF4 under QLoRA: a buffer, never sharded)
SHARDED_ADAPTER = "denoiser.middle_block.blocks.1.transformer_blocks.0.attn1.to_q.lora_down.weight"
SHARDED_FROZEN = ("text_encoder.text_encoder_1.text_model.embeddings.token_embedding.weight",
                  "denoiser.input_blocks.blocks.1.0.in_conv.weight")
SHARDED_BASE = "denoiser.middle_block.blocks.1.transformer_blocks.0.attn1.to_q.linear.weight"


def check_sharded(runs, case: str) -> None:
    """Under the case's fsdp 2, FSDP splits a LoRA factor and frozen weights
    on the first divisible axis of their flax layout; only adapters train."""
    ranks, _, _, _ = runs
    for rank in ranks:
        sharded = _ok(rank[case])["sharded"]
        trains = {n for n, (grad, _) in sharded.items() if grad}
        frozen = {n for n, (grad, _) in sharded.items() if not grad}
        assert sharded[SHARDED_ADAPTER] == (True, [("Replicate", None), ("Shard", 1)])
        assert trains and all(".lora_" in n for n in trains)
        assert set(SHARDED_FROZEN) <= frozen, sorted(frozen)[:6]
        assert (SHARDED_BASE in frozen) == (CASES[case][0] != "qlora")


# ------------------------------------------------------------------ tests


@pytest.mark.parametrize("case", LORA_CASES)
def test_mesh_step_matches_the_one_process_and_jax_steps(runs, case):
    check_mesh_case(runs, case)


def test_one_process_step_matches_jax(runs):
    _, jax_runs, one, _ = runs
    check_against(one["lora"], jax_runs["lora"], "one process against JAX")


@pytest.mark.parametrize("case", LORA_CASES)
def test_rank_zero_saves_the_one_process_file(runs, case):
    check_file(runs, case)


@pytest.mark.parametrize("case", LORA_CASES)
def test_resume_under_the_mesh_matches_the_unbroken_run(runs, case):
    check_resume(runs, case)


def test_fsdp_shards_adapters_and_frozen_weights(runs):
    """{data 2, fsdp 2} splits a LoRA factor and frozen weights (the JAX
    rule); {data 4} splits nothing."""
    ranks, _, _, _ = runs
    for rank in ranks:
        assert _ok(rank["lora_data4"])["sharded"] == {}
    check_sharded(runs, "lora_data2_fsdp2")


def test_distributed_init_builds_the_group_from_the_torchrun_environment(runs):
    ranks, _, _, _ = runs
    first = [_ok(rank["lora_data4"]) for rank in ranks]
    assert [r["rank"] for r in first] == list(range(WORLD))
    assert all(r["backend"] == "gloo" and r["world"] == WORLD and r["device"] == "cpu"
               for r in first)


@pytest.mark.parametrize("name", list(REFUSALS))
def test_not_ported_under_a_mesh_raises(runs, name):
    ranks, _, _, _ = runs
    for rank in ranks:
        raised = _ok(rank[f"refuse_{name}"])["raised"]
        assert raised is not None and "ROADMAP Queue 1 item 5" in raised, raised


def test_prepared_batch_and_draws_split_on_the_batch_axis():
    """Every tensor of the prepared batch and every draw has the batch's
    rows on its leading axis, where shard_batch splits it."""
    from tests.test_torch_sdxl_training import TINY_MODEL
    from vision_pt_tpu_torch.config import TrainConfig

    for workload_class in (SDXLForTextToImageTraining, SDXLForFlowMatchingTraining):
        config = TrainConfig.model_validate(
            {"model": {**TINY_MODEL, "tokenizer": "word-hash"}, "dataset": {}, "seed": 0})
        workload = workload_class(config, torch.device("cpu"))
        workload.setup_model()
        arrays = workload.prepare_batch(make_batch(0))
        draws = workload.draw_randoms(arrays, torch.Generator().manual_seed(0))
        assert set(draws) <= set(workload.mesh_draws)
        for name, value in {**arrays, **draws}.items():
            assert value.shape[0] == BATCH, (name, tuple(value.shape))
