"""The port's PEFT package against ``vision_pt_tpu.peft``, on the CPU: the
LoRA cases of ``tests/test_peft.py`` on both sides, the replaced-layer names
of the SDXL config's include/exclude keys on the tiny SDXL tree, and the
kohya LoRA file both ways. Weights cross by ``convert.from_jax_state``;
forwards in fp32 agree within 1e-6 (one product order apart).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from vision_pt_tpu.models.sdxl import SDXLModel as JSDXLModel
from vision_pt_tpu.models.sdxl.config import SDXLConfig as JSDXLConfig
from vision_pt_tpu.models.sdxl.convert import convert_to_comfy_key as jconvert_to_comfy
from vision_pt_tpu.ops.quant.layers import QuantLinear4bit as JQuantLinear4bit
from vision_pt_tpu.peft import LoRAConfig as JLoRAConfig
from vision_pt_tpu.peft import LoRALinear as JLoRALinear
from vision_pt_tpu.peft import get_adapter_parameters as jget_adapter_parameters
from vision_pt_tpu.peft import load_peft_weight as jload_peft_weight
from vision_pt_tpu.peft import replace_to_peft_layer as jreplace_to_peft_layer
from vision_pt_tpu.utils.state_dict import flatten_state
from vision_pt_tpu.workloads.sdxl_text_to_image import SDXLTrainable as JSDXLTrainable
from vision_pt_tpu_torch.models.sdxl import SDXLConfig, SDXLModel
from vision_pt_tpu_torch.models.sdxl.convert import (
    convert_from_comfy_key,
    convert_to_comfy_key,
    from_jax_state,
)
from vision_pt_tpu_torch.ops.linear import Linear
from vision_pt_tpu_torch.ops.quant.layers import QuantLinear4bit
from vision_pt_tpu_torch.peft import (
    LoRAConfig,
    LoRALinear,
    PeftTargetConfig,
    RegexMatch,
    adapter_parameters,
    calculate_trainable_parameters,
    detect_peft_method,
    freeze_all_but_adapters,
    get_adapter_parameters,
    load_peft_weight,
    replace_to_peft_layer,
    while_peft_disabled,
    while_peft_enabled,
)
from vision_pt_tpu_torch.workloads.sdxl_text_to_image import SDXLTrainable

from tests.test_torch_sdxl_training import PEFT, TINY_MODEL


class JTinyNet(nnx.Module):
    def __init__(self, rngs):
        self.to_q = nnx.Linear(8, 8, rngs=rngs)
        self.to_k = nnx.Linear(8, 8, rngs=rngs)
        self.blocks = nnx.List([nnx.Linear(8, 8, rngs=rngs) for _ in range(2)])
        self.out_proj = nnx.Linear(8, 4, rngs=rngs)

    def __call__(self, x):
        h = self.to_q(x) + self.to_k(x)
        for b in self.blocks:
            h = b(h)
        return self.out_proj(h)


class TinyNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.to_q = Linear(8, 8)
        self.to_k = Linear(8, 8)
        self.blocks = torch.nn.ModuleList([Linear(8, 8) for _ in range(2)])
        self.out_proj = Linear(8, 4)

    def forward(self, x):
        h = self.to_q(x) + self.to_k(x)
        for b in self.blocks:
            h = b(h)
        return self.out_proj(h)


def _x(shape=(2, 8), seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _carried_lora(alpha=2.0, rank=4, quantized=False):
    """A JAX LoRALinear with nonzero lora_up and its port twin."""
    rngs = nnx.Rngs(0)
    jlin = nnx.Linear(256, 16, rngs=rngs)
    lin = Linear(256, 16)
    lin.load_state_dict(from_jax_state(flatten_state(jlin)))
    if quantized:
        jlin = JQuantLinear4bit.from_linear(jlin, quant_type="nf4")
        lin = QuantLinear4bit.from_linear(lin, quant_type="nf4")
    jlora = JLoRALinear(JLoRAConfig(rank=rank, alpha=alpha, dtype="float32"), jlin,
                        rngs=rngs)
    jlora.lora_up.value = jnp.asarray(
        np.random.default_rng(1).normal(size=(rank, 16)).astype(np.float32))
    lora = LoRALinear(LoRAConfig(rank=rank, alpha=alpha, dtype="float32"), lin)
    sd = {k: v for k, v in from_jax_state(flatten_state(jlora)).items()
          if k.startswith("lora_")}
    lora.load_state_dict({**lora.state_dict(), **sd})
    return jlora, lora


@pytest.mark.parametrize("quantized", [False, True])
def test_lora_forward_matches_jax(quantized):
    jlora, lora = _carried_lora(quantized=quantized)
    x = _x((3, 5, 256))
    want = np.asarray(jlora(jnp.asarray(x)))
    with torch.no_grad():
        got = lora(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
    with torch.no_grad():
        base = lora.linear(torch.from_numpy(x)).numpy()
    assert np.abs(got - base).max() > 1e-2  # the adapter contributes


def test_lora_starts_as_identity():
    lin = Linear(8, 8)
    lora = LoRALinear(LoRAConfig(rank=4, alpha=2.0, dtype="float32"), lin,
                      generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(_x())
    with torch.no_grad():
        torch.testing.assert_close(lora(x), lin(x), rtol=0, atol=0)
        bound = (6.0 / 8) ** 0.5
        assert float(lora.lora_down.weight.abs().max()) <= bound
        assert float(lora.lora_down.weight.abs().max()) > 0
        lora.lora_up.weight.fill_(1.0)
        assert float((lora(x) - lin(x)).abs().max()) > 1e-3


def test_replace_targets_include_exclude():
    net = TinyNet()
    replaced = replace_to_peft_layer(
        net, include_keys=["to_", RegexMatch(regex=r"blocks\.\d+")],
        exclude_keys=["to_k"], config=LoRAConfig(rank=2, dtype="float32"))
    assert set(replaced) == {"to_q", "blocks.0", "blocks.1"}
    assert isinstance(net.to_q, LoRALinear) and isinstance(net.to_k, Linear)
    assert isinstance(net.blocks[0], LoRALinear)
    assert net(torch.from_numpy(_x())).shape == (2, 4)
    # a replaced layer is not replaced again
    assert replace_to_peft_layer(net, ["to_q"], [], LoRAConfig(rank=2)) == []


def _sdxl_trees():
    jmodel = JSDXLModel.from_config(JSDXLConfig(**TINY_MODEL), rngs=nnx.Rngs(0))
    jtree = JSDXLTrainable(jmodel.denoiser, jmodel.text_encoder.text_encoder_1,
                           jmodel.text_encoder.text_encoder_2, jmodel.vae)
    model = SDXLModel.from_config(SDXLConfig(**TINY_MODEL), device="cpu")
    tree = SDXLTrainable(model.denoiser, model.text_encoder.text_encoder_1,
                         model.text_encoder.text_encoder_2, model.vae)
    return jtree, tree


def test_sdxl_replaced_layers_match_jax():
    """The LoRA configs' keys (attn1, attn2, .ff.; not text_encoder, vae)
    pick the same layers by the same names in both trees."""
    jtree, tree = _sdxl_trees()
    cfg = JLoRAConfig(rank=2, dtype="float32")
    theirs = jreplace_to_peft_layer(jtree, PEFT["include_keys"], PEFT["exclude_keys"],
                                    cfg, seed=0)
    ours = replace_to_peft_layer(tree, PEFT["include_keys"], PEFT["exclude_keys"],
                                 LoRAConfig(rank=2, dtype="float32"), seed=0)
    assert ours == theirs
    # 7 transformers (2 down, 1 middle, 4 up), 10 linears each
    assert len(ours) == 7 * 10
    assert all(p.startswith("denoiser.") for p in ours)
    # the adapters' parameter names are the JAX ones in the torch layout
    theirs_names = {k for k in from_jax_state(flatten_state(jtree)) if ".lora_" in k}
    assert {n for n, _ in tree.named_parameters() if ".lora_" in n} == theirs_names


def test_kohya_file_both_ways():
    """A file that JAX writes (``get_adapter_parameters`` under
    ``convert_to_comfy_key``) loads into the port, and the port's into JAX:
    the same keys, the same values."""
    jtree, tree = _sdxl_trees()
    jreplace_to_peft_layer(jtree, PEFT["include_keys"], PEFT["exclude_keys"],
                           JLoRAConfig(rank=2, alpha=3.0, dtype="float32"), seed=0)
    replace_to_peft_layer(tree, PEFT["include_keys"], PEFT["exclude_keys"],
                          LoRAConfig(rank=2, dtype="float32"), seed=5)
    rng = np.random.default_rng(2)
    from vision_pt_tpu.peft.functional import iter_named_modules

    for _, module in iter_named_modules(jtree):
        if isinstance(module, JLoRALinear):
            module.lora_up.value = jnp.asarray(
                rng.normal(size=module.lora_up.value.shape).astype(np.float32))
    jax_file = {jconvert_to_comfy(k): np.asarray(v)
                for k, v in jget_adapter_parameters(jtree).items()}
    assert detect_peft_method(jax_file) == "lora"
    affected = load_peft_weight(
        tree, {convert_from_comfy_key(k): v for k, v in jax_file.items()})
    assert len(affected) == 70
    port_file = {convert_to_comfy_key(k): v for k, v in get_adapter_parameters(tree).items()}
    assert port_file.keys() == jax_file.keys()
    for key, value in jax_file.items():
        np.testing.assert_array_equal(port_file[key].numpy(), value)
    assert float(port_file[next(k for k in port_file if k.endswith("alpha"))]) == 3.0

    # and back: the port's file into a fresh JAX tree
    jfresh, _ = _sdxl_trees()
    jreplace_to_peft_layer(jfresh, PEFT["include_keys"], PEFT["exclude_keys"],
                           JLoRAConfig(rank=2, dtype="float32"), seed=1)
    with torch.no_grad():
        for p in adapter_parameters(tree):
            p.add_(0.5)
    port_file = {convert_to_comfy_key(k): v.numpy()
                 for k, v in get_adapter_parameters(tree).items()}
    jload_peft_weight(jfresh, {convert_from_comfy_key(k): v for k, v in port_file.items()})
    back = {jconvert_to_comfy(k): np.asarray(v)
            for k, v in jget_adapter_parameters(jfresh).items()}
    assert back.keys() == port_file.keys()
    for key, value in port_file.items():
        np.testing.assert_array_equal(back[key], value)


def test_loading_wraps_plain_linears_and_loha_waits():
    net = TinyNet()
    replace_to_peft_layer(net, ["to_q"], [], LoRAConfig(rank=2, alpha=4.0, dtype="float32"))
    with torch.no_grad():
        net.to_q.lora_up.weight.fill_(1.0)
    sd = get_adapter_parameters(net)
    assert sd["to_q.lora_down.weight"].shape == (2, 8)  # (rank, in)
    assert float(sd["to_q.alpha"]) == 4.0 and detect_peft_method(sd) == "lora"
    fresh = TinyNet()
    fresh.load_state_dict({k: v for k, v in net.state_dict().items()
                           if not k.startswith("to_q.")} |
                          {"to_q." + k[len("to_q.linear."):]: v
                           for k, v in net.state_dict().items()
                           if k.startswith("to_q.linear.")})
    assert load_peft_weight(fresh, sd) == ["to_q"]
    assert isinstance(fresh.to_q, LoRALinear) and fresh.to_q.rank == 2
    x = torch.from_numpy(_x(seed=1))
    with torch.no_grad():
        torch.testing.assert_close(fresh.to_q(x), net.to_q(x), rtol=0, atol=1e-6)
    assert detect_peft_method({"a.hada_w1_a": np.zeros(1)}) == "loha"
    assert detect_peft_method({"a.weight": np.zeros(1)}) == "none"
    # a LoHa file wraps its linears in LoHa adapters (tests/test_torch_loha.py)
    rng = np.random.default_rng(2)
    loha_sd = {f"to_k.{name}": rng.normal(size=shape).astype(np.float32)
               for name, shape in (("hada_w1_a", (8, 2)), ("hada_w1_b", (2, 8)),
                                   ("hada_w2_a", (8, 2)), ("hada_w2_b", (2, 8)))}
    loha_sd["to_k.alpha"] = np.float32(1.0)
    assert load_peft_weight(fresh, loha_sd) == ["to_k"]
    assert type(fresh.to_k).__name__ == "LoHaLinear" and fresh.to_k.rank == 2
    loha = PeftTargetConfig(include_keys=["to_k"],
                            config={"type": "loha", "rank": 2}).config
    assert replace_to_peft_layer(TinyNet(), ["to_k"], [], loha) == ["to_k"]
    with pytest.raises(ValueError):
        load_peft_weight(fresh, {"a.weight": np.zeros(1)})


def test_enable_disable():
    net = TinyNet()
    replace_to_peft_layer(net, ["to_q"], [], LoRAConfig(rank=2, dtype="float32"))
    with torch.no_grad():
        net.to_q.lora_up.weight.fill_(1.0)
    x = torch.from_numpy(_x())
    with torch.no_grad():
        with_lora = net.to_q(x)
        with while_peft_disabled(net):
            without = net.to_q(x)
            torch.testing.assert_close(without, net.to_q.linear(x), rtol=0, atol=0)
        again = net.to_q(x)
        assert float((with_lora - without).abs().max()) > 1e-4
        assert torch.equal(with_lora, again)
        with while_peft_enabled(net):
            assert torch.equal(net.to_q(x), with_lora)
        torch.testing.assert_close(net.to_q(x), without, rtol=0, atol=0)


def test_trainable_parameter_counting():
    net = TinyNet()
    full = calculate_trainable_parameters(net)
    assert full.trainable_params == full.all_param
    replace_to_peft_layer(net, ["to_q"], [], LoRAConfig(rank=2, dtype="float32"))
    peft = calculate_trainable_parameters(net)
    assert peft.trainable_params == 2 * 8 * 2  # down + up; alpha is a buffer
    assert peft.trainable_percent < 100.0


def test_gradients_flow_only_into_the_adapters():
    net = TinyNet()
    replace_to_peft_layer(net, ["to_q"], [], LoRAConfig(rank=2, dtype="float32"))
    freeze_all_but_adapters(net)
    loss = net(torch.from_numpy(_x())).square().sum()
    loss.backward()
    with_grad = [n for n, p in net.named_parameters() if p.grad is not None]
    assert with_grad == ["to_q.lora_down.weight", "to_q.lora_up.weight"]
    assert all(torch.isfinite(p.grad).all() for p in adapter_parameters(net))


def test_peft_target_config_validation():
    with pytest.raises(ValueError):
        PeftTargetConfig(include_keys=[], config=LoRAConfig(rank=2))
    cfg = PeftTargetConfig(include_keys=["to_q"], config={"type": "lora", "rank": 4})
    assert cfg.config.rank == 4 and cfg.config.dtype == "bfloat16"


def test_lora_merged_weight():
    jlora, lora = _carried_lora(alpha=2.0, rank=2)
    x = torch.from_numpy(_x((4, 256)))
    with torch.no_grad():
        merged = torch.nn.functional.linear(x, lora.merged_weight(), lora.linear.bias)
        torch.testing.assert_close(lora(x), merged, rtol=0, atol=1e-5)
    want = np.asarray(jlora.merged_kernel()).T
    np.testing.assert_allclose(lora.merged_weight().numpy(), want, rtol=0, atol=1e-6)
