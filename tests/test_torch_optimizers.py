"""The port's schedule-free AdamW and 8-bit Adam against the JAX package's
optimizers, on the CPU, with numpy-made parameters and gradients.

- ``ScheduleFreeAdamW`` against ``optax.contrib.schedule_free_adamw`` (what
  the JAX package builds for ``schedulefree.*ScheduleFree``) over 20 steps,
  warmup 0 and 5, with and without weight decay: parameters and eval
  parameters within 1e-6 (fp32 elementwise ops, pow and sqrt in another
  library);
- ``AdamW8bit`` / ``Adam8bit`` against ``vision_pt_tpu.training.optim8bit``
  over 20 steps: parameters within 1e-6, the int8 moments and their fp32
  scales equal;
- both through the port's ``Trainer`` on a tiny JiT trainer against the JAX
  ``Trainer`` (the lr schedule applied as each package applies it), and a
  checkpoint round trip that keeps the states' dtypes.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vision_pt_tpu.training import optim8bit as joptim8bit
from vision_pt_tpu.training.optimizer import get_optimizer as jax_get_optimizer
from vision_pt_tpu_torch.training.optimizer import ScheduleFreeAdamW, get_optimizer

STEPS = 20
SHAPES = [(7, 5), (300,)]


def _grads(seed):
    rng = np.random.default_rng(seed)
    return [[rng.normal(size=s).astype(np.float32) for s in SHAPES]
            for _ in range(STEPS)]


def _params(seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in SHAPES]


def _run_optax(tx, params, grads):
    jparams = [jnp.asarray(p) for p in params]
    state = tx.init(jparams)
    for g in grads:
        updates, state = tx.update([jnp.asarray(x) for x in g], state, jparams)
        jparams = optax.apply_updates(jparams, updates)
    return jparams, state


def _run_port(opt, params, grads):
    for g in grads:
        for p, x in zip(params, g):
            p.grad = torch.from_numpy(x)
        opt.step()


@pytest.mark.parametrize("warmup,weight_decay", [(0, 0.0), (5, 0.0), (0, 1e-2),
                                                 (5, 1e-2)])
def test_schedule_free_matches_optax(warmup, weight_decay):
    init, grads = _params(0), _grads(1)
    tx = optax.contrib.schedule_free_adamw(
        learning_rate=3e-2, warmup_steps=warmup or None, b1=0.9, b2=0.99,
        weight_decay=weight_decay)
    jparams, state = _run_optax(tx, init, grads)
    jeval = optax.contrib.schedule_free_eval_params(state, jparams)

    params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in init]
    opt = get_optimizer("schedulefree.RAdamScheduleFree", params,
                        {"lr": 3e-2, "warmup_steps": warmup, "betas": (0.9, 0.99),
                         "weight_decay": weight_decay})
    assert isinstance(opt, ScheduleFreeAdamW)
    _run_port(opt, params, grads)
    evals = opt.eval_params()
    for p, jp, je in zip(params, jparams, jeval):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=0, atol=1e-6)
        np.testing.assert_allclose(evals[p].numpy(), np.asarray(je), rtol=0, atol=1e-6)
        assert not np.allclose(p.detach().numpy(), evals[p].numpy())


def test_schedule_free_follows_a_schedule_at_optax_counts():
    """The Trainer hands its schedule in: z moves at schedule(n), the
    average weighs at schedule(n + 1), as optax counts."""
    init, grads = _params(2), _grads(3)

    def schedule(count):
        return 1e-2 * (1 + count) / (1 + 0.5 * count)

    tx = jax_get_optimizer("schedulefree.AdamWScheduleFree", {},
                           learning_rate_schedule=schedule)
    jparams, state = _run_optax(tx, init, grads)
    params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in init]
    opt = get_optimizer("schedulefree.AdamWScheduleFree", params, {},
                        lr_schedule=lambda n: float(np.float32(schedule(n))))
    _run_port(opt, params, grads)
    for p, jp in zip(params, jparams):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=0, atol=1e-6)
    # optax ramps a float rate only; a schedule with a warmup is refused
    with pytest.raises(ValueError, match="warmup"):
        get_optimizer("schedulefree.AdamWScheduleFree", params, {"warmup_steps": 3},
                      lr_schedule=schedule)


@pytest.mark.parametrize("name,weight_decay", [("bitsandbytes.optim.AdamW8bit", 1e-2),
                                               ("bitsandbytes.optim.Adam8bit", None)])
def test_8bit_adam_matches_jax(name, weight_decay):
    init, grads = _params(4), _grads(5)
    kwargs = {} if weight_decay is None else {"weight_decay": weight_decay}
    fn = joptim8bit.adamw8bit if "AdamW" in name else joptim8bit.adam8bit
    jparams, state = _run_optax(fn(learning_rate=2e-2, b1=0.9, b2=0.99, **kwargs),
                                init, grads)
    params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in init]
    opt = get_optimizer(name, params, {"lr": 2e-2, "betas": (0.9, 0.99)})
    _run_port(opt, params, grads)
    inner = state[0]
    for i, (p, jp) in enumerate(zip(params, jparams)):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=0, atol=1e-6)
        st = opt.state[p]
        assert st["m_q"].dtype == torch.int8 and st["count"] == STEPS
        for ours, theirs in (("m_q", inner.m_q), ("m_scale", inner.m_scale),
                             ("v_q", inner.v_q), ("v_scale", inner.v_scale)):
            np.testing.assert_array_equal(st[ours].numpy(), np.asarray(theirs[i]))


@pytest.mark.parametrize("name", ["bitsandbytes.optim.AdamW8bit",
                                  "schedulefree.RAdamScheduleFree"])
def test_state_dict_round_trip_keeps_dtypes(name):
    """torch's load_state_dict casts floating state to the parameter's
    dtype; the port's optimizers restore int8 moments, fp32 scales and the
    z sequence exactly."""
    params = [torch.nn.Parameter(torch.from_numpy(p).to(torch.bfloat16))
              for p in _params(7)]
    opt = get_optimizer(name, params, {"lr": 1e-2})
    for step in _grads(6)[:3]:
        for p, g in zip(params, step):
            p.grad = torch.from_numpy(g).to(torch.bfloat16)
        opt.step()
    saved = opt.state_dict()
    twin = [torch.nn.Parameter(p.detach().clone()) for p in params]
    other = get_optimizer(name, twin, {"lr": 1e-2})
    other.load_state_dict(saved)
    for p, q in zip(params, twin):
        for key, value in opt.state[p].items():
            restored = other.state[q][key]
            if isinstance(value, torch.Tensor):
                assert restored.dtype == value.dtype and torch.equal(restored, value)
                assert restored.data_ptr() != value.data_ptr()
            else:
                assert restored == value


# ------------------------------------------------------------------ trainer


def test_trainer_steps_match_jax(tmp_path):
    """Five steps of each package's Trainer with schedule-free AdamW (clip
    1.0, cosine with warmup handed to the optimizer, EMA, class-context
    drops) from the same weights and batches with the JAX draws: the loss
    of every step and the final parameters and EMA within 1e-4 relative, as
    ``test_torch_training`` holds AdamW."""
    name = "schedulefree.RAdamScheduleFree"
    from flax import nnx

    from tests import test_torch_training as tt
    from vision_pt_tpu.config import TrainConfig as JaxTrainConfig
    from vision_pt_tpu.ops import attention as jattn
    from vision_pt_tpu.training.trainer import Trainer as JaxTrainer
    from vision_pt_tpu.utils.state_dict import _path_to_key, flatten_state
    from vision_pt_tpu.workloads.jit_class_to_image import (
        JiTForClassToImageTraining as JaxWorkload,
    )
    from vision_pt_tpu_torch.config import TrainConfig
    from vision_pt_tpu_torch.ops import attention as tattn

    label2id = tmp_path / "label2id.json"
    label2id.write_text(__import__("json").dumps({f"c{i}": i for i in range(4)}))
    cfg = tt._config_dict(str(label2id), 1)
    cfg["optimizer"] = {"name": name, "args": {"lr": 2e-3}}

    jtrainer = JaxTrainer(JaxTrainConfig.model_validate(cfg))
    jtrainer.register_train_dataset_class(tt.JaxSynthetic)
    jtrainer.register_model_class(JaxWorkload)
    jtrainer.before_train()
    init = {k: np.asarray(v) for k, v in flatten_state(jtrainer.model.trainable()).items()}
    jlosses = []
    tt._record_losses(jtrainer, jlosses)
    with jattn.attention_dtype(None):
        jtrainer.training_loop()
    jtrainer.sync_module_state()
    jfinal = {k: np.asarray(v) for k, v in flatten_state(jtrainer.model.trainable()).items()}
    jema = {_path_to_key(tuple(path)): np.asarray(getattr(v, "value", v))
            for path, v in nnx.to_flat_state(jtrainer.ema_state)}

    draws = tt._jax_draws()

    class Injected(tt.JiTForClassToImageTraining):
        def setup_model(self):
            super().setup_model()
            self.trainable().load_state_dict(tt.from_jax_state(init), strict=True)

        def draw_randoms(self, batch, generator):
            d = draws[self._current_step - 1]
            return {"timesteps": tt.tsampling.sample_timestep(
                        generator, tt.BATCH, self.model_config.timestep_sampling,
                        draw=torch.from_numpy(d["timesteps"])),
                    "noise": torch.from_numpy(d["noise"])}

    trainer = tt.Trainer(TrainConfig.model_validate(cfg), device="cpu")
    trainer.register_train_dataset_class(tt.SyntheticClassImageDatasetConfig)
    trainer.register_model_class(Injected)
    trainer.before_train()
    losses = []
    tt._record_losses(trainer, losses)
    with tattn.attention_dtype(None):
        trainer.training_loop()
    assert len(losses) == len(jlosses) == tt.STEPS
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    params = {k: v.detach().numpy() for k, v in trainer.model.trainable().state_dict().items()}
    tt._assert_close_tree(params, jfinal, "params")
    tt._assert_close_tree({k: v.numpy() for k, v in trainer.ema_state.items()}, jema, "ema")


def test_trainer_applies_the_schedule_to_8bit_adam_as_optax(tmp_path):
    """The port's Trainer with AdamW8bit (clip 1.0, cosine with warmup) on
    the tiny JiT trainer; its clipped gradients, replayed through the JAX
    package's ``adamw8bit`` under the JAX schedule, give the same parameters
    (1e-6) and the same int8 moments. (Two trainers cannot be compared
    directly: gradients 1e-6 apart move an int8 code where it sits at a
    rounding edge, and a second moment rounded to 0 makes that element's
    step m / eps.)"""
    from tests import test_torch_training as tt
    from vision_pt_tpu.training import scheduler as jscheduler
    from vision_pt_tpu_torch.config import TrainConfig

    label2id = tmp_path / "label2id.json"
    label2id.write_text(__import__("json").dumps({f"c{i}": i for i in range(4)}))
    cfg = tt._config_dict(str(label2id), 1)
    cfg["optimizer"] = {"name": "bitsandbytes.optim.AdamW8bit", "args": {"lr": 2e-3}}
    trainer = tt.Trainer(TrainConfig.model_validate(cfg), device="cpu")
    trainer.register_train_dataset_class(tt.SyntheticClassImageDatasetConfig)
    trainer.register_model_class(tt.JiTForClassToImageTraining)
    trainer.before_train()
    params = trainer._params
    init = [p.detach().numpy().copy() for p in params]
    replay = []
    step = trainer.optimizer.step

    def recording():
        replay.append([p.grad.numpy().copy() for p in params])
        step()

    trainer.optimizer.step = recording
    trainer.training_loop()
    assert len(replay) == tt.STEPS

    schedule = jscheduler.get_lr_schedule(2e-3, "cosine", {"num_warmup_steps": 2},
                                          total_steps=tt.STEPS)
    jparams, state = _run_optax(joptim8bit.adamw8bit(learning_rate=schedule),
                                init, replay)
    inner = state[0]
    for i, (p, jp) in enumerate(zip(params, jparams)):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(trainer.optimizer.state[p]["m_q"].numpy(),
                                      np.asarray(inner.m_q[i]))
        np.testing.assert_array_equal(trainer.optimizer.state[p]["v_q"].numpy(),
                                      np.asarray(inner.v_q[i]))
