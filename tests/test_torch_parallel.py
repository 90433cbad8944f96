"""The port's mesh and placement rules (``parallel/mesh.py``) against the
JAX package's, with no process spawned: mesh sizes and -1 inference against
JAX ``make_mesh`` on the 8-device CPU mesh, the FSDP and tensor-parallel
specs over the same shapes, the exact rule-matched parameter sets of the
JiT, SDXL UNet and CogView4 trees (``tests/test_parallel.py:171-216``), the
flax-layout FSDP dim, the refusals (tensor parallelism of SDXL / CogView4
attention, optimizers and workloads not held under a mesh), the one-rank
group a mesh makes on its own (and its refusal in a multi-process launch),
and the trainer's ``profile_dir`` trace.
The sharded computations run on 4 gloo ranks in
``test_torch_distributed_training.py``.
"""

import json

import pytest
import torch
import torch.distributed as dist

from vision_pt_tpu_torch.parallel import mesh as tmesh

MESHES = [None, {"data": 2, "fsdp": -1, "tensor": 2}, {"data": -1, "seq": 4},
          {"data": 1, "fsdp": 8}, {"fsdp": 2, "tensor": 2, "seq": 2},
          {"data": 2, "fsdp": 2, "tensor": 2, "seq": 1}]


@pytest.mark.parametrize("config", MESHES, ids=str)
def test_mesh_sizes_match_jax(config):
    from vision_pt_tpu.parallel.mesh import make_mesh

    jmesh = make_mesh(config)
    assert tmesh.mesh_sizes(config, 8) == [jmesh.shape[a] for a in tmesh.AXES]


def test_mesh_assertion_matches_jax():
    from vision_pt_tpu.parallel.mesh import make_mesh

    with pytest.raises(AssertionError) as jax_error:
        make_mesh({"data": 3})
    with pytest.raises(AssertionError) as port_error:
        tmesh.mesh_sizes({"data": 3}, 8)
    assert str(port_error.value) == str(jax_error.value)


@pytest.fixture
def one_rank_group():
    """The process has no group; whatever the test makes is torn down."""
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_a_mesh_on_one_process_makes_a_one_rank_group(one_rank_group):
    mesh = tmesh.make_mesh({"data": 1, "fsdp": 1, "tensor": 1, "seq": 1})
    assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
    assert mesh.mesh_dim_names == tmesh.AXES and tuple(mesh.shape) == (1, 1, 1, 1)
    with pytest.raises(AssertionError, match="does not cover 1 devices"):
        tmesh.make_mesh({"data": 2})


def test_a_mesh_in_a_multi_process_launch_without_a_group_raises(one_rank_group,
                                                                  monkeypatch):
    """Under ``torchrun --nproc_per_node 2`` without ``distributed_init`` each
    process would make its own one-rank world and train alone."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="trainer.distributed_init"):
        tmesh.make_mesh({"data": -1})
    assert not dist.is_initialized()


SHAPES = [(1024, 256), (16, 16), (1023, 255), (768,), (3072, 768), (4, 4, 16, 64),
          (130, 64), (1000, 768)]


@pytest.mark.parametrize("size", [2, 4, 8])
def test_fsdp_specs_match_jax(size):
    from vision_pt_tpu.parallel.mesh import fsdp_partition_spec, make_mesh

    jmesh = make_mesh({"data": 8 // size, "fsdp": size})
    for shape in SHAPES:
        for min_size in (2**14, 1):
            theirs = tuple(fsdp_partition_spec(shape, jmesh, min_size_to_shard=min_size))
            ours = tmesh.fsdp_partition_spec(shape, {"fsdp": size},
                                             min_size_to_shard=min_size)
            assert ours == theirs, (shape, min_size)


TP_PARAMS = [  # JAX path, flax shape
    ("blocks.0.attn.to_q.kernel", (128, 128)), ("blocks.0.attn.to_q.bias", (128,)),
    ("blocks.0.mlp.w_1.kernel", (128, 342)), ("blocks.0.mlp.w_1.bias", (342,)),
    ("blocks.0.attn.to_o.kernel", (128, 128)), ("blocks.0.attn.to_o.bias", (128,)),
    ("blocks.0.mlp.w_3.kernel", (342, 128)), ("blocks.0.norm1.scale", (128,)),
    ("x.geglu.proj.kernel", (64, 512)), ("x.ff.out.kernel", (256, 64)),
    ("x.out_conv.kernel", (64, 64)), ("x.dropout.kernel", (64, 64)),
    ("x.to_out.kernel", (63, 64)),
]


@pytest.mark.parametrize("size", [1, 2, 4])
def test_tensor_specs_match_jax(size):
    """The port's spec is the JAX one on the torch layout: a Linear weight
    is the transposed kernel, so a 2-D spec reads backwards."""
    from vision_pt_tpu.parallel.mesh import make_mesh, tensor_partition_spec

    jmesh = make_mesh({"data": 8 // size, "tensor": size})
    for path, shape in TP_PARAMS:
        theirs = tensor_partition_spec(path, shape, jmesh)
        port_path = path.replace(".kernel", ".weight")
        ours = tmesh.tensor_partition_spec(port_path, shape[::-1], {"tensor": size})
        if theirs is None:
            assert ours is None, path
        else:
            assert ours == tuple(theirs)[::-1], path


def _jax_tp_set(model) -> dict[str, str]:
    from flax import nnx

    from vision_pt_tpu.parallel.mesh import tp_classification
    from vision_pt_tpu.utils.state_dict import _path_to_key

    out = {}
    for path, _ in nnx.to_flat_state(nnx.state(model, nnx.Param)):
        key = _path_to_key(tuple(path))
        kind = tp_classification(key)
        if kind is not None:
            out[key.removesuffix(".kernel") + (".weight" if key.endswith(".kernel") else "")] = kind
    return out


def _port_tp_set(model) -> dict[str, str]:
    return {name: kind for name, _ in model.named_parameters()
            if (kind := tmesh.tp_classification(name)) is not None}


def _trees(name):
    from flax import nnx

    if name == "jit":
        from vision_pt_tpu.models.jit.config import DenoiserConfig as J
        from vision_pt_tpu.models.jit.denoiser import Denoiser as JD
        from vision_pt_tpu_torch.models.jit.config import DenoiserConfig as T
        from vision_pt_tpu_torch.models.jit.denoiser import Denoiser as TD

        cfg = dict(patch_size=8, hidden_size=64, depth=3, num_heads=2,
                   bottleneck_dim=16, context_dim=32, context_start_block=1,
                   rope_axes_dims=[16, 8, 8], num_time_tokens=2)
        return JD(J(**cfg), rngs=nnx.Rngs(0)), TD(T(**cfg)), (3 * 6 + 2, 3 * 3 + 1)
    if name == "sdxl":
        from vision_pt_tpu.models.sdxl.config import DenoiserConfig as J
        from vision_pt_tpu.models.sdxl.denoiser import Denoiser as JD
        from vision_pt_tpu_torch.models.sdxl.config import DenoiserConfig as T
        from vision_pt_tpu_torch.models.sdxl.denoiser import Denoiser as TD

        cfg = dict(hidden_dim=32, block_out_channels=[32, 32, 64],
                   num_transformers_per_block=[1, 2, 10], num_head_channels=16,
                   context_dim=32, layers_per_block=2)
        return JD(J(**cfg), rngs=nnx.Rngs(0)), TD(T(**cfg)), (20, 10)
    from vision_pt_tpu.models.cogview4.config import DenoiserConfig as J
    from vision_pt_tpu.models.cogview4.denoiser import Denoiser as JD
    from vision_pt_tpu_torch.models.cogview4.config import DenoiserConfig as T
    from vision_pt_tpu_torch.models.cogview4.denoiser import Denoiser as TD

    cfg = dict(patch_size=2, in_channels=4, out_channels=4, num_layers=2,
               attention_head_dim=16, num_attention_heads=4, text_embed_dim=32,
               time_embed_dim=32, condition_dim=8, rope_axes_dim=[16, 16])
    return JD(J(**cfg), rngs=nnx.Rngs(0)), TD(T(**cfg)), (2 * 4, 2 * 2)


@pytest.mark.parametrize("tree", ["jit", "sdxl", "cogview4"])
def test_tp_rules_match_the_same_parameters_as_jax(tree):
    jmodel, tmodel, (min_column, min_row) = _trees(tree)
    ours, theirs = _port_tp_set(tmodel), _jax_tp_set(jmodel)
    assert ours == theirs, (sorted(set(ours) ^ set(theirs))[:10])
    kinds = list(ours.values())
    assert kinds.count("column") >= min_column and kinds.count("row") >= min_row
    if tree == "jit":  # the JiT attention and SwiGLU split by heads / features
        plan = tmesh._tensor_plan(tmodel, 2)
        assert set(plan) == {n.removesuffix(".weight") for n in ours if n.endswith(".weight")}
        with pytest.raises(NotImplementedError, match="do not split"):
            tmesh._tensor_plan(tmodel, 4)  # 2 heads over 4 ranks
    else:  # their attention counts whole heads: refused, not miscomputed
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 5"):
            tmesh._tensor_plan(tmodel, 2)


def test_fsdp_splits_the_flax_layouts_first_divisible_axis():
    from vision_pt_tpu_torch.ops.linear import Conv2d, Linear

    mesh = {"fsdp": 2}
    lin = Linear(64, 512)  # flax (64, 512): in_features first -> torch dim 1
    assert tmesh.fsdp_shard_dim(lin, lin.weight, mesh) == 1
    odd_in = Linear(63, 512)  # flax (63, 512): out_features -> torch dim 0
    assert tmesh.fsdp_shard_dim(odd_in, odd_in.weight, mesh) == 0
    conv = Conv2d(64, 128, 3)  # flax (3, 3, 64, 128): in channels -> torch dim 1
    assert tmesh.fsdp_shard_dim(conv, conv.weight, mesh) == 1
    assert tmesh.fsdp_shard_dim(lin, lin.bias, mesh) is None  # 512 < 2**14
    assert tmesh.fsdp_shard_dim(lin, lin.weight, {"fsdp": 1}) is None


def _tiny_config(tmp_path, **trainer):
    label2id = tmp_path / "label2id.json"
    label2id.write_text(json.dumps({f"c{i}": i for i in range(4)}))
    return {
        "model": {"context_encoder": {"type": "class", "label2id_map_path": str(label2id)},
                  "denoiser": {"patch_size": 8, "hidden_size": 64, "depth": 2,
                               "num_heads": 2, "bottleneck_dim": 16, "context_dim": 32,
                               "context_start_block": 0, "rope_axes_dims": [16, 8, 8],
                               "num_time_tokens": 2},
                  "max_token_length": 4},
        "dataset": {"num_classes": 4, "num_items": 24, "image_size": 16,
                    "batch_size": 8, "seed": 0},
        "optimizer": {"name": "adamw", "args": {"lr": 1e-3}},
        "saving": None, "seed": 0, "num_train_epochs": 1, "trainer": trainer,
    }


def _trainer(config, workload=None):
    from vision_pt_tpu_torch.config import TrainConfig
    from vision_pt_tpu_torch.data.square_class_image import SyntheticClassImageDatasetConfig
    from vision_pt_tpu_torch.training.trainer import Trainer
    from vision_pt_tpu_torch.workloads.jit_class_to_image import JiTForClassToImageTraining

    trainer = Trainer(TrainConfig.model_validate(config), device="cpu")
    trainer.register_train_dataset_class(SyntheticClassImageDatasetConfig)
    trainer.register_model_class(workload or JiTForClassToImageTraining)
    return trainer


def _one_rank_step(tmp_path, config, workload=None, batch=None):
    """One step of the trainer on ``config`` without a mesh and under
    {1, 1, 1, 1}: each side's loss and trained tensors after it (on the
    first batch of the dataset unless ``batch`` is given)."""
    from vision_pt_tpu_torch.ops.attention import attention_dtype

    runs = []
    for mesh in (None, {"data": 1, "fsdp": 1, "tensor": 1, "seq": 1}):
        trainer = _trainer({**config, "trainer": {**config["trainer"], "mesh": mesh}},
                           workload)
        trainer.before_train()
        arrays = trainer.model.prepare_batch(
            batch if batch is not None else next(iter(trainer.train_dataset)))
        with attention_dtype(None):
            loss, _ = trainer.train_step(arrays, torch.Generator().manual_seed(0))
        runs.append((float(loss), {n: p.detach().clone() for n, p in
                                   trainer.model.trainable().named_parameters()
                                   if p.requires_grad}))
    (loss, params), (mesh_loss, mesh_params) = runs
    assert mesh_loss == loss and params.keys() == mesh_params.keys() and params
    assert all(torch.equal(params[k], mesh_params[k]) for k in params)


@pytest.mark.parametrize("name", ["prodigy", "lion", "rmsprop", "adafactor"])
def test_optimizers_not_held_under_a_mesh_raise(tmp_path, one_rank_group, name):
    """Each optax rule runs under a mesh (the name is from when they were
    refused there): under a one-rank mesh each takes the one-device update
    to the bit."""
    config = _tiny_config(tmp_path)
    config["optimizer"] = {"name": name, "args": {"lr": 1e-3}}
    _one_rank_step(tmp_path, config)


def test_workloads_not_held_under_a_mesh_raise(tmp_path, one_rank_group):
    """RoPE distillation runs under a mesh (the name is from when the
    adapter workloads were refused there): under a one-rank mesh the loss
    and the trained tensors are the one-device step's, the low-res draws
    taken with the rows."""
    from tests.test_torch_sdxl_rope import make_batch
    from tests.test_torch_sdxl_training import PEFT, TINY_MODEL
    from vision_pt_tpu_torch.workloads.sdxl_rope_distill import SDXLRoPEDistillTraining

    assert {"lowres_vae_noise", "lowres_noise"} <= set(SDXLRoPEDistillTraining.mesh_draws)
    config = _tiny_config(tmp_path)
    config.update(model={**TINY_MODEL, "denoiser": {**TINY_MODEL["denoiser"],
                                                    "rope_dims": [8, 8]},
                         "tokenizer": "word-hash"}, peft=PEFT)
    _one_rank_step(tmp_path, config, SDXLRoPEDistillTraining, make_batch())


def test_one_rank_mesh_trains_as_one_device(tmp_path, one_rank_group):
    """The trainer under {1, 1, 1, 1}: the same losses and parameters."""
    from vision_pt_tpu_torch.ops.attention import attention_dtype

    runs = []
    for mesh in (None, {"data": 1, "fsdp": 1, "tensor": 1, "seq": 1}):
        trainer = _trainer(_tiny_config(tmp_path, mesh=mesh, clip_grad_norm=1.0,
                                        use_ema=True))
        losses, inner = [], trainer.train_step

        def recording(*args, inner=inner, losses=losses, **kwargs):
            loss, metrics = inner(*args, **kwargs)
            losses.append(float(loss))
            return loss, metrics

        trainer.train_step = recording
        trainer.before_train()
        with attention_dtype(None):
            trainer.training_loop()
        runs.append((losses, trainer.model.trainable().state_dict()))
    (losses, params), (mesh_losses, mesh_params) = runs
    assert len(losses) == 3 and mesh_losses == losses
    assert all(torch.equal(params[k], mesh_params[k]) for k in params)


def test_profile_dir_writes_a_chrome_trace_of_the_profiled_steps(tmp_path):
    trace_dir = tmp_path / "profile"
    trainer = _trainer(_tiny_config(tmp_path, profile_dir=str(trace_dir),
                                    profile_steps=1))
    trainer.train()
    trace = json.loads((trace_dir / "trace_rank0.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("aten::" in n for n in names)  # the step's operators
    assert trainer._profiler is None and trainer.global_step == 3


def test_deterministic_holds_for_the_loop_and_is_restored(tmp_path):
    """``trainer.deterministic`` turns torch's deterministic algorithms on
    (warn-only) for every step and puts the caller's setting back after."""
    trainer = _trainer(_tiny_config(tmp_path, deterministic=True))
    seen, inner = [], trainer.train_step

    def recording(*args, **kwargs):
        seen.append((torch.are_deterministic_algorithms_enabled(),
                     torch.is_deterministic_algorithms_warn_only_enabled()))
        return inner(*args, **kwargs)

    trainer.train_step = recording
    assert not torch.are_deterministic_algorithms_enabled()
    trainer.train()
    assert seen == [(True, True)] * 3
    assert not torch.are_deterministic_algorithms_enabled()
