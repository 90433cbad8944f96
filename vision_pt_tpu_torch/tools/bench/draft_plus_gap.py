"""Where a DRaFT+ step's fp32 gradient gap between the card and the CPU
comes from.

The step is ``chip_smoke.py``'s ``sdxl_slice14_parity`` DRaFT+ case, built
as that phase builds it: SDXL-base widths with one layer and one transformer
per stage, random weights from seed 1 in bf16, ``configs/sdxl/
text_to_image_lora.yml``'s LoRA with ``lora_up`` drawn nonzero, 512^2, one
differentiated sampler step at CFG 5, a 2-layer random PickScore drawn on
the device from seed 6, the phase's draws (numpy seed 14, in its order).
Its fp32 witness (the same weights in fp32, TF32 off, ``attention_dtype
(None)``) runs

- ``card``: on the card, through the flash kernels;
- ``cpu_open``: on the CPU with the attention gate open, through the flash
  kernels' plain versions, as ``chip_smoke.py`` runs its CPU halves;
- ``cpu_closed``: on the CPU with the gate closed (``plain_attention``);
- ``cpu64_open``: as ``cpu_open`` in fp64 (up to the workload's own fp32
  casts: the CFG combination and the reward tower's input).

For each pair it prints one JSON line: the LoRA gradients' largest and
median relative L2 gap and the worst leaves, and the gaps of what the step
passes through: the guided noise prediction, the latents the VAE decodes,
the decoded image and the gradients that reach each of them; and, for the
reward's ``clamp`` to [-1, 1], the share of pixels inside it and the share
whose side differs between the two runs.

    python -m vision_pt_tpu_torch.tools.bench.draft_plus_gap

On an H100's host the CPU steps take about 25 s (fp32) and 90 s (fp64).
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
SIDE = 512
SMALL_PICKSCORE = {"projection_dim": 128,
                   "text_config": dict(vocab_size=49408, hidden_size=128, intermediate_size=512,
                                       num_hidden_layers=2, num_attention_heads=2,
                                       max_position_embeddings=77, hidden_act="gelu"),
                   "vision_config": dict(hidden_size=128, intermediate_size=512,
                                         num_hidden_layers=2, num_attention_heads=2,
                                         image_size=224, patch_size=14, hidden_act="gelu")}
CAPTION = "a red fox in the snow, detailed fur"
PAIRS = (("card", "cpu_open"), ("card", "cpu_closed"), ("card", "cpu64_open"),
         ("cpu_open", "cpu64_open"), ("cpu_closed", "cpu64_open"))


def _rel_l2(ours: np.ndarray, theirs: np.ndarray) -> float:
    return float(np.linalg.norm(ours - theirs) / max(np.linalg.norm(theirs), 1e-30))


def write_pickscore(path: str, shape: dict, seed: int, device: torch.device) -> str:
    """A random CLIP dual tower drawn on ``device`` as an HF CLIP directory
    (config.json and fp16 safetensors with HF's key names)."""
    from safetensors.torch import save_file

    from ...models import clip_vision
    from ...models.sdxl import text_encoder

    gen = torch.Generator(device=device).manual_seed(seed)
    sd = {}
    with torch.device(device):
        text = text_encoder.CLIPTextModel(
            text_encoder.CLIPTextConfig(**shape["text_config"],
                                        projection_dim=shape["projection_dim"]),
            with_projection=True, generator=gen)
        vision = clip_vision.CLIPVisionModel(
            clip_vision.CLIPVisionConfig(**shape["vision_config"],
                                         projection_dim=shape["projection_dim"]),
            with_projection=True, generator=gen)
    for tower, layers in ((text, "text_model.layers."), (vision, "vision_model.layers.")):
        sd.update({k.replace(layers, layers.replace(".layers.", ".encoder.layers.")):
                   v.detach().half().cpu().contiguous() for k, v in tower.state_dict().items()})
    sd["logit_scale"] = torch.tensor(4.6052, dtype=torch.float16)
    os.makedirs(path, exist_ok=True)
    save_file(sd, os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"model_type": "clip", **shape}, f)
    return path


def _workload(device: torch.device, dtype: str, peft: dict, pickscore: str, model: dict):
    """The DRaFT+ workload in ``dtype`` on ``device``, its LoRA attached
    (seed 1, ``lora_up`` drawn from seed 2), the base frozen."""
    from ...config import TrainConfig
    from ...peft import PeftTargetConfig, freeze_all_but_adapters, replace_to_peft_layer
    from ...workloads.sdxl_draft_plus import SDXLDRaFTPlusTraining

    peft = {**peft, "config": {**peft["config"], "dtype": dtype}}
    config = TrainConfig.model_validate({
        "model": {"checkpoint_path": None, "dtype": dtype, "tokenizer": "word-hash",
                  "max_token_length": 75, "total_steps": 1, "sample_height": SIDE,
                  "sample_width": SIDE, "reward_models": [
                      {"type": "pickscore", "weights_path": pickscore,
                       "tokenizer": "word-hash"}], **model},
        "dataset": {}, "peft": peft, "seed": 1})
    workload = SDXLDRaFTPlusTraining(config, device)
    workload.setup_model()
    tree = workload._full_trainable
    replace_to_peft_layer(tree, peft["include_keys"], peft["exclude_keys"],
                          PeftTargetConfig.model_validate(peft).config, seed=1)
    gen = torch.Generator(device=device).manual_seed(2)
    with torch.no_grad():
        for name, p in tree.named_parameters():
            if name.endswith("lora_up.weight"):
                p.copy_(torch.randn(p.shape, generator=gen, device=device) * 0.05)
    freeze_all_but_adapters(tree)
    workload._is_peft = True
    return workload


def build(device: torch.device, pickscore: str, model: dict | None = None):
    """The fp32 witness of the bf16 card workload: built in bf16, then its
    weights and adapters loaded into an fp32 twin."""
    import yaml

    with open(os.path.join(ROOT, "configs", "sdxl", "text_to_image_lora.yml")) as f:
        peft = yaml.safe_load(f)["peft"]
    model = model or {"denoiser": {"layers_per_block": 1,
                                   "num_transformers_per_block": [1, 1, 1]}}
    low = _workload(device, "bfloat16", peft, pickscore, model)
    witness = _workload(device, "float32", peft, pickscore, model)
    witness._full_trainable.load_state_dict(
        {k: v.float() for k, v in low._full_trainable.state_dict().items()}, strict=True)
    return witness


def twin(card, dtype: torch.dtype):
    """``card``'s model, training tree and reward towers on the CPU in
    ``dtype``."""
    host = type(card)(card.config, torch.device("cpu"))
    host.model, host._full_trainable = copy.deepcopy((card.model, card._full_trainable))
    host.model.to("cpu")
    for module in host.model._submodules().values():
        module.to(dtype)
    host._is_peft = True
    host.reward_models = copy.deepcopy(card.reward_models)
    for reward in host.reward_models:
        reward.model.to("cpu")
    return host


def step(workload, draws: dict, gate_open: bool) -> dict:
    """Loss, LoRA gradients and the intermediates of one step (float64
    numpy)."""
    from ...ops import attention

    dtype = next(workload.model.denoiser.parameters()).dtype
    seen = {}

    def keep(name, tensor):
        seen[name] = tensor.detach()
        if tensor.requires_grad:
            tensor.register_hook(lambda g: seen.__setitem__(f"d_{name}", g.detach()))

    vae, scheduler = workload.model.vae, workload.model.scheduler
    decode, ancestral = vae.decode, scheduler.ancestral_step

    def decoding(z):
        keep("latents", z)
        image = decode(z)
        keep("image", image)
        return image

    def stepping(latents, noise_pred, *args, **kwargs):
        keep("noise_pred", noise_pred)
        return ancestral(latents, noise_pred, *args, **kwargs)

    arrays = workload.prepare_batch({"caption": [CAPTION]})
    arrays = {k: v.to(dtype) if v.is_floating_point() else v for k, v in arrays.items()}
    trainable = workload.trainable()
    trainable.zero_grad(set_to_none=True)
    vae.decode, scheduler.ancestral_step = decoding, stepping
    gate = attention._on_cuda
    if gate_open:
        attention._on_cuda = lambda x: True
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    try:
        with attention.attention_dtype(None):
            loss, _ = workload.compute_loss(trainable, arrays, {
                "latents": draws["latents"].to(workload.device, dtype),
                "step_noise": [n.to(workload.device, dtype) for n in draws["step_noise"]]})
            loss.backward()
    finally:
        del vae.decode, scheduler.ancestral_step
        attention._on_cuda = gate
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    seconds = time.perf_counter() - t0
    grads = {n.removeprefix("denoiser.").removesuffix(".weight"):
             p.grad.double().cpu().numpy() for n, p in trainable.named_parameters()
             if p.requires_grad}
    return {"loss": float(loss.detach()), "grads": grads, "seconds": seconds,
            "seen": {k: v.double().cpu().numpy() for k, v in seen.items()}}


def compare(ours: dict, theirs: dict) -> dict:
    gaps = {n: _rel_l2(ours["grads"][n], g) for n, g in theirs["grads"].items()}
    worst = sorted(gaps, key=gaps.get, reverse=True)
    inside = [np.abs(run["seen"]["image"]) < 1.0 for run in (ours, theirs)]
    return {"loss_rel_err": abs(ours["loss"] - theirs["loss"]) / abs(theirs["loss"]),
            "grad_rel_l2_max": gaps[worst[0]],
            "grad_rel_l2_median": float(np.median(list(gaps.values()))),
            "worst": {n: gaps[n] for n in worst[:6]},
            "intermediates": {k: _rel_l2(ours["seen"][k], v)
                              for k, v in theirs["seen"].items()},
            "pixels_inside_clamp": [float(m.mean()) for m in inside],
            "pixels_across_clamp": float((inside[0] != inside[1]).mean())}


def smoke_draws() -> dict:
    """sdxl_slice14_parity's DRaFT+ draws: numpy seed 14 after the phase's
    image noise and the RoPE case's four draws."""
    rng = np.random.default_rng(14)
    latent, lowres = (1, SIDE // 8, SIDE // 8, 4), (1, SIDE // 16, SIDE // 16, 4)
    rng.normal(0, 0.05, size=(SIDE, SIDE, 3))
    for shape in (latent, latent, lowres, lowres):
        rng.normal(size=shape)

    def normal(shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    return {"latents": normal(latent), "step_noise": [normal(latent)]}


def run(device: str = "cuda", model: dict | None = None, out=print) -> dict:
    torch.set_num_threads(os.cpu_count() or 1)
    draws = smoke_draws()
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        card = build(torch.device(device), write_pickscore(
            os.path.join(tmp, "pickscore"), SMALL_PICKSCORE, 6, torch.device(device)), model)
        host32, host64 = twin(card, torch.float32), twin(card, torch.float64)
        runs = {"card": step(card, draws, gate_open=False),
                "cpu_open": step(host32, draws, gate_open=True),
                "cpu_closed": step(host32, draws, gate_open=False),
                "cpu64_open": step(host64, draws, gate_open=True)}
    for a, b in PAIRS:
        line = {"ours": a, "theirs": b, **compare(runs[a], runs[b]),
                "seconds": {a: runs[a]["seconds"], b: runs[b]["seconds"]}}
        results[(a, b)] = line
        out(json.dumps(line))
    return results


def main() -> int:
    if sys.argv[1:]:
        print("usage: python -m vision_pt_tpu_torch.tools.bench.draft_plus_gap",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("draft_plus_gap needs a CUDA device", file=sys.stderr)
        return 1
    with contextlib.suppress(BrokenPipeError):
        run("cuda")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
