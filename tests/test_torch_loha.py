"""The port's LoHa adapter (``peft/loha.py``) against ``vision_pt_tpu.peft.loha``,
on the CPU: the forward and the factors' gradients over a dense and an NF4
base (the NF4 gate opened, so kernel #9's plain version takes the base
product) within 1e-6 of the largest value (one product order apart, fp32);
a new adapter is the identity; the SDXL trees adapt the same layers; the
kohya file of the JAX workload loads into the port and the port writes the
same keys and shapes; ``detect_peft_method`` names the file. Weights cross
by ``convert.from_jax_state`` (LoHa factors keep their layout).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from tests.test_torch_sdxl_training import PEFT, TINY_MODEL
from vision_pt_tpu.config import TrainConfig as JTrainConfig
from vision_pt_tpu.models.sdxl import SDXLModel as JSDXLModel
from vision_pt_tpu.models.sdxl.config import SDXLConfig as JSDXLConfig
from vision_pt_tpu.ops.quant.layers import QuantLinear4bit as JQuantLinear4bit
from vision_pt_tpu.peft import AdapterParam
from vision_pt_tpu.peft import LoHaConfig as JLoHaConfig
from vision_pt_tpu.peft import replace_to_peft_layer as jreplace_to_peft_layer
from vision_pt_tpu.peft.loha import LoHaLinear as JLoHaLinear
from vision_pt_tpu.utils.state_dict import flatten_state
from vision_pt_tpu.workloads import sdxl_text_to_image as jworkload
from vision_pt_tpu_torch.config import TrainConfig
from vision_pt_tpu_torch.models.sdxl import SDXLConfig, SDXLModel
from vision_pt_tpu_torch.models.sdxl.convert import convert_from_comfy_key, from_jax_state
from vision_pt_tpu_torch.ops.linear import Linear
from vision_pt_tpu_torch.ops.quant import layers as qlayers
from vision_pt_tpu_torch.ops.quant.layers import QuantLinear4bit
from vision_pt_tpu_torch.peft import (
    LoHaConfig,
    LoHaLinear,
    PeftTargetConfig,
    adapter_parameters,
    detect_peft_method,
    freeze_all_but_adapters,
    get_adapter_parameters,
    load_peft_weight,
    replace_to_peft_layer,
)
from vision_pt_tpu_torch.workloads.sdxl_text_to_image import (
    SDXLForTextToImageTraining,
    SDXLTrainable,
)

LOHA_PEFT = {**PEFT, "config": {"type": "loha", "rank": 2, "alpha": 1.0,
                                "dtype": "float32"}}
FACTORS = ("hada_w1_a", "hada_w1_b", "hada_w2_a", "hada_w2_b")


def _carried_loha(quantized, alpha=2.0, rank=4):
    """A JAX LoHaLinear with every factor nonzero and its port twin."""
    rngs = nnx.Rngs(0)
    jlin = nnx.Linear(256, 16, rngs=rngs)
    lin = Linear(256, 16)
    lin.load_state_dict(from_jax_state(flatten_state(jlin)))
    if quantized:
        jlin = JQuantLinear4bit.from_linear(jlin, quant_type="nf4")
        lin = QuantLinear4bit.from_linear(lin, quant_type="nf4")
    jloha = JLoHaLinear(JLoHaConfig(rank=rank, alpha=alpha, dtype="float32"), jlin,
                        rngs=rngs)
    jloha.hada_w2_a.value = jnp.asarray(
        np.random.default_rng(1).normal(size=(256, rank)).astype(np.float32) * 0.1)
    loha = LoHaLinear(LoHaConfig(rank=rank, alpha=alpha, dtype="float32"), lin)
    sd = {k: v for k, v in from_jax_state(flatten_state(jloha)).items()
          if k.startswith("hada_")}
    assert sd.keys() == set(FACTORS)
    loha.load_state_dict({**loha.state_dict(), **sd,
                          "alpha": torch.tensor(np.asarray(jloha.alpha.value))})
    return jloha, loha


@pytest.mark.parametrize("quantized", [False, True])
def test_loha_forward_and_gradients_match_jax(quantized, monkeypatch):
    calls = []
    if quantized:
        monkeypatch.setattr(qlayers, "_on_cuda", lambda x: True)
        real = qlayers.dequant_matmul_4bit
        monkeypatch.setattr(qlayers, "dequant_matmul_4bit",
                            lambda *a, **k: calls.append(1) or real(*a, **k))
    jloha, loha = _carried_loha(quantized)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 5, 256)).astype(np.float32)
    weight = rng.normal(size=(3, 5, 16)).astype(np.float32)

    def jloss(module):
        return jnp.sum(module(jnp.asarray(x)) * weight)

    jvalue, jgrads = nnx.value_and_grad(jloss, argnums=nnx.DiffState(0, AdapterParam))(jloha)
    want = np.asarray(jloha(jnp.asarray(x)))
    got = loha(torch.from_numpy(x))
    torch.sum(got * torch.from_numpy(weight)).backward()
    got = got.detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
    with torch.no_grad():
        base = loha.linear(torch.from_numpy(x)).numpy()
    assert np.abs(got - base).max() > 1e-2  # the adapter contributes
    theirs = {k: np.asarray(v) for k, v in from_jax_state(flatten_state(jgrads)).items()}
    assert {n for n, p in loha.named_parameters() if p.requires_grad
            and not n.startswith("linear.")} == set(FACTORS)
    for name in FACTORS:
        ours = getattr(loha, name).grad.numpy()
        np.testing.assert_allclose(ours, theirs[name], rtol=0,
                                   atol=1e-6 * np.abs(theirs[name]).max())
    assert bool(calls) == quantized


def test_loha_starts_as_identity():
    lin = Linear(8, 8)
    loha = LoHaLinear(LoHaConfig(rank=4, alpha=2.0, dtype="float32"), lin,
                      generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 8, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        torch.testing.assert_close(loha(x), lin(x), rtol=0, atol=0)
        assert loha.hada_w1_a.shape == (8, 4) and loha.hada_w1_b.shape == (4, 8)
        assert 0 < float(loha.hada_w1_a.std()) < 0.3 < float(loha.hada_w1_b.std())
        loha.hada_w2_a.fill_(0.1)
        assert float((loha(x) - lin(x)).abs().max()) > 1e-3
        loha.set_enabled(False)
        torch.testing.assert_close(loha(x), lin(x), rtol=0, atol=0)


def _trees():
    jmodel = JSDXLModel.from_config(JSDXLConfig(**TINY_MODEL), rngs=nnx.Rngs(0))
    jtree = jworkload.SDXLTrainable(jmodel.denoiser, jmodel.text_encoder.text_encoder_1,
                                    jmodel.text_encoder.text_encoder_2, jmodel.vae)
    model = SDXLModel.from_config(SDXLConfig(**TINY_MODEL), device="cpu")
    model.denoiser.load_state_dict(from_jax_state(flatten_state(jmodel.denoiser)))
    tree = SDXLTrainable(model.denoiser, model.text_encoder.text_encoder_1,
                         model.text_encoder.text_encoder_2, model.vae)
    return jmodel, jtree, tree


def test_sdxl_loha_file_both_ways(tmp_path):
    """The JAX workload's LoHa file (kohya keys) loads into a plain port
    tree, wrapping the same 70 linears with the same factors; the port
    writes it back with the same keys, shapes and values."""
    jmodel, jtree, tree = _trees()
    theirs_paths = jreplace_to_peft_layer(jtree, LOHA_PEFT["include_keys"],
                                          LOHA_PEFT["exclude_keys"],
                                          JLoHaConfig(rank=2, dtype="float32"), seed=0)
    assert len(theirs_paths) == 7 * 10
    jwork = jworkload.SDXLForTextToImageTraining(
        JTrainConfig(model=TINY_MODEL, dataset={}, peft=LOHA_PEFT, seed=0))
    jwork.model, jwork._full_trainable = jmodel, jtree
    jwork._set_is_peft(True)
    saved = {k: np.asarray(v) for k, v in jwork.get_state_dict_to_save().items()}
    assert detect_peft_method(saved) == "loha"
    assert all(k.startswith("diffusion_model.") for k in saved)

    affected = load_peft_weight(tree, {convert_from_comfy_key(k): v
                                       for k, v in saved.items()})
    assert sorted(affected) == sorted(theirs_paths)
    work = SDXLForTextToImageTraining(
        TrainConfig.model_validate({"model": {**TINY_MODEL, "tokenizer": "word-hash"},
                                    "dataset": {}, "peft": LOHA_PEFT, "seed": 0}),
        torch.device("cpu"))
    work._full_trainable, work._is_peft = tree, True
    ours = {k: v.numpy() for k, v in work.get_state_dict_to_save().items()}
    assert ours.keys() == saved.keys()
    for key, value in saved.items():
        np.testing.assert_array_equal(ours[key], value)


def test_detection_replacement_and_config():
    """``peft.config.type: loha`` builds LoHa adapters on the layers the
    JAX package picks; only their factors train."""
    jmodel, jtree, tree = _trees()
    config = PeftTargetConfig.model_validate(LOHA_PEFT).config
    assert isinstance(config, LoHaConfig)
    theirs = jreplace_to_peft_layer(jtree, LOHA_PEFT["include_keys"],
                                    LOHA_PEFT["exclude_keys"],
                                    JLoHaConfig(rank=2, dtype="float32"), seed=0)
    ours = replace_to_peft_layer(tree, LOHA_PEFT["include_keys"],
                                 LOHA_PEFT["exclude_keys"], config)
    assert ours == theirs
    freeze_all_but_adapters(tree)
    names = {n.rpartition(".")[2] for n, p in tree.named_parameters() if p.requires_grad}
    assert names == set(FACTORS)
    assert len(adapter_parameters(tree)) == 4 * len(ours)
    sd = get_adapter_parameters(tree)
    assert detect_peft_method(sd) == "loha" and len(sd) == 5 * len(ours)
    assert detect_peft_method({"a.hada_w2_b": np.zeros(1)}) == "none"
