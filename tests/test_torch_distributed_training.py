"""The port's trainer under ``trainer.mesh`` on a 4-rank gloo group on the
CPU, against the JAX package's one-device step and the port's own
one-process step.

The tiny JiT config of ``tests/ops/test_seq_parallel.py:125-153`` (context
from block 0, so every attention is a self-attention over kv_lens), fp32
(``attention_dtype(None)``), clip_grad_norm 1.0 and EMA on, two steps, under
{data 4}, {data 2, fsdp 2}, {fsdp 2, tensor 2} and {data 2, seq 2}:
- from the JAX weights (``from_jax_state``) and the JAX draws of each step,
  the losses within 1e-5 relative and every step-1 gradient within 1e-4 of
  the JAX step; the same against the port's one-process run. The final
  parameters, EMA and rank 0's saved files are held within PARAM_ATOL, 1%
  of one Adam step at lr 1e-3: where a gradient component is near zero,
  Adam's normalised update moves with its last bits (measured: 2.4e-6 at
  most, one element of ``time_embedder.linear_2.bias``);
- with the trainer's own draws (every rank draws the whole batch's, then
  takes its rows), the losses of the one-process run, and a run resumed
  from its step-1 train state equal to the unbroken one;
- the process group built by ``distributed_init`` from torchrun-style
  variables; the ring taken under seq; Adam and SGD under {data 2, fsdp 2};
  a column -> row pair under {fsdp 2, tensor 2} equal to the unsharded one.

One spawn of 4 processes runs every case; each rank writes its results to a
file, and the tests read them. The JAX side runs in this process meanwhile;
the ranks import no JAX.
"""

import glob
import json
import os
import shutil
import socket
import time

import numpy as np
import pytest
import torch

from vision_pt_tpu_torch.workloads.jit_class_to_image import JiTForClassToImageTraining

WORLD, SEED, BATCH, SIZE, STEPS = 4, 0, 8, 16, 2
MESHES = {"data4": {"data": 4}, "data2_fsdp2": {"data": 2, "fsdp": 2},
          "fsdp2_tensor2": {"fsdp": 2, "tensor": 2}, "data2_seq2": {"data": 2, "seq": 2}}
OPTIMIZERS = ("adam", "sgd")
PARAM_ATOL = 1e-5


def _config(label2id, mesh=None, out=None, optimizer="adamw", **trainer):
    return {
        "model": {"context_encoder": {"type": "class", "label2id_map_path": label2id},
                  "denoiser": {"patch_size": 8, "hidden_size": 64, "depth": 2,
                               "num_heads": 2, "bottleneck_dim": 16, "context_dim": 32,
                               "context_start_block": 0, "rope_axes_dims": [16, 8, 8],
                               "num_time_tokens": 2},
                  "max_token_length": 4},
        "dataset": {"num_classes": 4, "num_items": BATCH * STEPS, "image_size": SIZE,
                    "batch_size": BATCH, "seed": 0},
        "optimizer": {"name": optimizer, "args": {"lr": 1e-3}},
        "saving": None if out is None else {
            "strategy": {"per_epochs": None},
            "callbacks": [{"type": "safetensors", "name": "jit", "save_dir": out}]},
        # a preview before the final save leaves FSDP's groups unsharded
        "preview": None if out is None else {
            "strategy": {"per_epochs": 1},
            "callbacks": [{"type": "local", "save_dir": os.path.join(out, "preview")}],
            "data": {"data": [{"prompt": "c1", "width": SIZE, "height": SIZE,
                               "num_steps": 2, "cfg_scale": 2.0, "seed": 42}]}},
        "seed": SEED, "num_train_epochs": 1,
        "trainer": {"mesh": mesh, "clip_grad_norm": 1.0, "use_ema": True,
                    "ema_decay": 0.9, **trainer},
    }


class _Injected(JiTForClassToImageTraining):
    """The JAX trainer's initial weights and draws (class attributes, set in
    each process)."""

    init: dict = {}
    draws: list = []

    def setup_model(self):
        from vision_pt_tpu_torch.models.jit.convert import from_jax_state

        super().setup_model()
        self.trainable().load_state_dict(from_jax_state(self.init), strict=True)

    def draw_randoms(self, batch, generator):
        from vision_pt_tpu_torch.ops.timestep.sampling import sample_timestep

        d = self.draws[self._current_step - 1]
        return {"timesteps": sample_timestep(
                    generator, BATCH, self.model_config.timestep_sampling,
                    draw=torch.from_numpy(d["timesteps"])),
                "noise": torch.from_numpy(d["noise"])}


def _train(config, workload=_Injected, device="cpu"):
    """Run the trainer; returns its losses, step-1 gradients (pre-clip,
    gathered whole), final parameters and EMA (whole) and the trainer."""
    from vision_pt_tpu_torch.config import TrainConfig
    from vision_pt_tpu_torch.data.square_class_image import SyntheticClassImageDatasetConfig
    from vision_pt_tpu_torch.ops.attention import attention_dtype
    from vision_pt_tpu_torch.parallel.mesh import full_tensors
    from vision_pt_tpu_torch.training.trainer import Trainer

    trainer = Trainer(TrainConfig.model_validate(config), device=device)
    trainer.register_train_dataset_class(SyntheticClassImageDatasetConfig)
    trainer.register_model_class(workload)
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
    ema = {k: v.numpy() for k, v in full_tensors(trainer.ema_state).items()}
    return {"losses": losses, "grads": grads, "params": params, "ema": ema}, trainer


# ------------------------------------------------------------------ ranks


def _column_row_pair(mesh):
    """A to_q -> gelu -> to_o pair, tensor-parallel and FSDP-sharded
    (min_size_to_shard 1), against the same pair unsharded."""
    from torch import nn
    from torch.distributed.tensor import DTensor

    from vision_pt_tpu_torch.ops.linear import Linear
    from vision_pt_tpu_torch.parallel.mesh import shard_batch, shard_module

    class Block(nn.Module):
        supports_tensor_parallel = True  # elementwise between the pair

        def __init__(self):
            super().__init__()
            gen = torch.Generator().manual_seed(0)
            self.to_q = Linear(64, 128, generator=gen, std=None)
            self.to_o = Linear(128, 64, generator=gen, std=None)

        def forward(self, x):
            return self.to_o(torch.nn.functional.gelu(self.to_q(x)))

    x = torch.randn(8, 16, 64, generator=torch.Generator().manual_seed(1))
    block = Block()
    expected = block(x)
    shard_module(block, mesh, min_size_to_shard=1)
    out = block(shard_batch(x, mesh))
    placements = {n: [(type(p).__name__, getattr(p, "dim", None)) for p in v.placements]
                  for n, v in block.named_parameters() if isinstance(v, DTensor)}
    return {"err": float((out - shard_batch(expected, mesh)).abs().max()),
            "placements": placements}


def _rank_main(rank, port, work):
    import torch.distributed as dist

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(WORLD),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    inputs = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
    _Injected.init, _Injected.draws = inputs["init"], inputs["draws"]
    label2id = inputs["label2id"]
    from vision_pt_tpu_torch.ops.attention import ring_dispatch_count
    from vision_pt_tpu_torch.parallel.mesh import make_mesh

    results = {}

    def case(name, fn):
        try:
            results[name] = fn()
        except Exception as e:  # recorded; the test of the case reports it
            results[name] = {"error": f"{type(e).__name__}: {e}"}

    def first_run():  # builds the group from the environment
        run, trainer = _train(_config(label2id, MESHES["data4"], distributed_init=True))
        return {"backend": dist.get_backend(), "world": dist.get_world_size(),
                "rank": dist.get_rank(), "device": str(trainer.device), **run}

    def resume(name, mesh):
        ckpt = os.path.join(work, f"ckpt_{name}")
        cfg = _config(label2id, mesh, checkpointing={"save_dir": ckpt, "per_steps": 1,
                                                     "resume": True})
        unbroken, _ = _train(cfg, JiTForClassToImageTraining)
        if rank == 0:
            shutil.rmtree(os.path.join(ckpt, "step_00000002"))
        dist.barrier()
        resumed, trainer = _train(cfg, JiTForClassToImageTraining)
        return {"unbroken": unbroken, "resumed": resumed, "steps": trainer.global_step}

    for name, mesh in MESHES.items():
        def injected(name=name, mesh=mesh):
            before = ring_dispatch_count()
            if name == "data4":
                run = first_run()
            else:
                run, _ = _train(_config(label2id, mesh, os.path.join(work, f"out_{name}")))
            return {**run, "rings": ring_dispatch_count() - before}

        case(name, injected)
        case(f"resume_{name}", lambda name=name, mesh=mesh: resume(name, mesh))
    for opt in OPTIMIZERS:
        case(f"optimizer_{opt}", lambda opt=opt: _train(
            _config(label2id, MESHES["data2_fsdp2"], optimizer=opt))[0])
    case("column_row", lambda: _column_row_pair(make_mesh({"fsdp": 2, "tensor": 2})))
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


def _jax_trainer(label2id):
    from vision_pt_tpu.config import TrainConfig
    from vision_pt_tpu.data.square_class_image import SyntheticClassImageDatasetConfig
    from vision_pt_tpu.training.trainer import Trainer
    from vision_pt_tpu.workloads.jit_class_to_image import JiTForClassToImageTraining as W

    trainer = Trainer(TrainConfig.model_validate(_config(label2id)))
    trainer.register_train_dataset_class(SyntheticClassImageDatasetConfig)
    trainer.register_model_class(W)
    trainer.before_train()
    return trainer


def _jax_draws():
    """The timestep and noise draws of JAX trainer steps 1..STEPS."""
    import jax
    import jax.numpy as jnp

    draws = []
    for n in range(1, STEPS + 1):
        key = jax.random.fold_in(jax.random.key(SEED), n)
        k_t, k_noise = jax.random.split(jax.random.fold_in(key, 1))
        draws.append({
            "timesteps": np.array(jax.random.normal(k_t, (BATCH,), jnp.float32)),
            "noise": np.array(jax.random.normal(k_noise, (BATCH, SIZE, SIZE, 3),
                                                jnp.float32)),
        })
    return draws


def _jax_run(trainer, grad_trainer):
    """The JAX trainer's losses, final parameters and EMA over STEPS steps,
    and the gradients of its first step (from a second trainer, whose first
    batch and key are the same)."""
    import jax
    from flax import nnx

    from vision_pt_tpu.ops.attention import attention_dtype
    from vision_pt_tpu.utils.state_dict import _path_to_key, flatten_state

    losses, inner = [], trainer.train_step

    def recording(*args, **kwargs):
        loss, metrics = inner(*args, **kwargs)
        losses.append(float(loss))
        return loss, metrics

    trainer.train_step = recording
    with attention_dtype(None):
        trainer.training_loop()
        g = grad_trainer
        key = g._next_key()
        arrays = g.model.prepare_batch(next(iter(g.train_dataset)), key)
        graphdef, params, rest = nnx.split(g.model.trainable(), nnx.Param, ...)

        def loss_fn(params):
            return g.model.compute_loss(nnx.merge(graphdef, params, rest), arrays, key)[0]

        grads = jax.jit(jax.grad(loss_fn))(params)
    trainer.sync_module_state()
    flat = lambda state: {_path_to_key(tuple(p)): np.asarray(getattr(v, "value", v))  # noqa: E731
                          for p, v in nnx.to_flat_state(state)}
    final = {k: np.asarray(v) for k, v in flatten_state(trainer.model.trainable()).items()}
    return {"losses": losses, "grads": flat(grads), "params": final,
            "ema": flat(trainer.ema_state)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from vision_pt_tpu.utils.state_dict import flatten_state
    from vision_pt_tpu_torch.models.jit.convert import from_jax_state

    work = str(tmp_path_factory.mktemp("mesh"))
    label2id = os.path.join(work, "label2id.json")
    with open(label2id, "w") as f:
        json.dump({f"c{i}": i for i in range(4)}, f)
    jax_trainer = _jax_trainer(label2id)
    init = {k: np.asarray(v) for k, v in flatten_state(jax_trainer.model.trainable()).items()}
    draws = _jax_draws()
    wait = _spawn(work, {"init": init, "draws": draws, "label2id": label2id})
    jax_run = _jax_run(jax_trainer, _jax_trainer(label2id))
    to_port = lambda tree: {k: v.numpy() for k, v in from_jax_state(tree).items()}  # noqa: E731
    jax_run = {"losses": jax_run["losses"],
               **{k: to_port(jax_run[k]) for k in ("grads", "params", "ema")}}
    _Injected.init, _Injected.draws = init, draws
    one = {"injected": _train(_config(label2id, out=os.path.join(work, "out_one")))[0],
           "natural": _train(_config(label2id), JiTForClassToImageTraining)[0]}
    for opt in OPTIMIZERS:
        one[opt] = _train(_config(label2id, optimizer=opt))[0]
    return wait(), jax_run, one, work


def _ok(result):
    assert "error" not in result, result["error"]
    return result


def _assert_tree(ours, theirs, atol, what):
    assert ours.keys() == theirs.keys(), what
    for key in theirs:
        err = float(np.abs(ours[key] - theirs[key]).max())
        assert err <= atol, (what, key, err)


def _assert_grads(ours, theirs, what):
    assert ours.keys() == theirs.keys(), what
    for key in theirs:
        np.testing.assert_allclose(ours[key], theirs[key], rtol=1e-4, atol=1e-4 * max(
            np.abs(theirs[key]).max(), 1e-6), err_msg=f"{what} {key}")


@pytest.mark.parametrize("mesh", list(MESHES))
def test_mesh_step_matches_jax(runs, mesh):
    ranks, jax_run, _, _ = runs
    for rank in ranks:
        ours = _ok(rank[mesh])
        assert len(ours["losses"]) == STEPS
        np.testing.assert_allclose(ours["losses"], jax_run["losses"], rtol=1e-5)
        _assert_grads(ours["grads"], jax_run["grads"], "step-1 gradient")
        _assert_tree(ours["params"], jax_run["params"], PARAM_ATOL, "params")
        _assert_tree(ours["ema"], jax_run["ema"], PARAM_ATOL, "ema")


@pytest.mark.parametrize("mesh", list(MESHES))
def test_mesh_step_matches_the_one_process_step(runs, mesh):
    ranks, _, one, _ = runs
    for rank in ranks:
        ours = _ok(rank[mesh])
        np.testing.assert_allclose(ours["losses"], one["injected"]["losses"], rtol=1e-5)
        _assert_grads(ours["grads"], one["injected"]["grads"], "step-1 gradient")
        _assert_tree(ours["params"], one["injected"]["params"], PARAM_ATOL, "params")
        _assert_tree(ours["ema"], one["injected"]["ema"], PARAM_ATOL, "ema")


@pytest.mark.parametrize("mesh", ["data2_fsdp2", "fsdp2_tensor2", "data2_seq2"])
def test_rank_zero_saves_the_one_process_files(runs, mesh):
    from safetensors.numpy import load_file

    ranks, _, _, work = runs
    _ok(ranks[0][mesh])
    for prefix in ("", "ema_"):
        assert len(os.listdir(os.path.join(work, f"out_{mesh}", "preview"))) == 1
        ours = glob.glob(os.path.join(work, f"out_{mesh}", f"{prefix}jit*.safetensors"))
        theirs = glob.glob(os.path.join(work, "out_one", f"{prefix}jit*.safetensors"))
        assert len(ours) == len(theirs) == 1, (ours, theirs)
        _assert_tree(load_file(ours[0]), load_file(theirs[0]), PARAM_ATOL, prefix + "file")


@pytest.mark.parametrize("mesh", list(MESHES))
def test_resume_under_the_mesh_matches_the_unbroken_run(runs, mesh):
    """With the trainer's own draws: the unbroken mesh run is the
    one-process run, and a run resumed from its step-1 train state (the
    shards gathered, written once and put back) finishes it."""
    ranks, _, one, _ = runs
    for rank in ranks:
        r = _ok(rank[f"resume_{mesh}"])
        unbroken, resumed = r["unbroken"], r["resumed"]
        np.testing.assert_allclose(unbroken["losses"], one["natural"]["losses"], rtol=1e-5)
        _assert_tree(unbroken["params"], one["natural"]["params"], PARAM_ATOL, "params")
        assert r["steps"] == STEPS and len(resumed["losses"]) == 1
        np.testing.assert_allclose(resumed["losses"], unbroken["losses"][1:], rtol=1e-6)
        _assert_tree(resumed["params"], unbroken["params"], 0.0, "resumed params")
        _assert_tree(resumed["ema"], unbroken["ema"], 0.0, "resumed ema")


def test_distributed_init_builds_the_group_from_the_torchrun_environment(runs):
    ranks, _, _, _ = runs
    first = [_ok(rank["data4"]) for rank in ranks]
    assert [r["rank"] for r in first] == list(range(WORLD))
    assert all(r["backend"] == "gloo" and r["world"] == WORLD and r["device"] == "cpu"
               for r in first)


def test_the_seq_axis_takes_the_ring(runs):
    ranks, _, _, _ = runs
    for rank in ranks:
        # 2 blocks x 2 steps, the context in every block: all self-attention
        assert _ok(rank["data2_seq2"])["rings"] == 2 * STEPS
        assert all(_ok(rank[m])["rings"] == 0 for m in MESHES if m != "data2_seq2")


@pytest.mark.parametrize("opt", OPTIMIZERS)
def test_torch_optimizers_give_the_one_process_update(runs, opt):
    ranks, _, one, _ = runs
    for rank in ranks:
        ours = _ok(rank[f"optimizer_{opt}"])
        np.testing.assert_allclose(ours["losses"], one[opt]["losses"], rtol=1e-5)
        _assert_tree(ours["params"], one[opt]["params"], PARAM_ATOL, opt)


def test_column_row_pair_matches_the_unsharded_pair(runs):
    ranks, _, _, _ = runs
    for rank in ranks:
        r = _ok(rank["column_row"])
        assert r["err"] <= 1e-5
        assert r["placements"]["to_q.weight"] == [("Shard", 0)]
        assert r["placements"]["to_q.bias"] == [("Shard", 0)]
        assert r["placements"]["to_o.weight"] == [("Shard", 1)]
        assert r["placements"]["to_o.bias"] == [("Replicate", None)]
