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
  checkpoint round trip that keeps the states' dtypes;
- ``prodigy``, ``lion``, ``adafactor``, ``rmsprop`` and ``adagrad``
  (``optax_optimizers``) against the optax transformations the JAX package's
  ``get_optimizer`` returns, 20 steps over a linear weight, a 4-D conv
  weight, a bias and two weights that adafactor factors (their two largest
  dims differing, and tied), each in the JAX package's layout on the JAX side
  and the port's on the port's: every parameter within 1e-5 relative L2
  (fp32 elementwise ops, sqrt, pow and sums in another library), adafactor's
  factored moments mapped across the layouts within the same; each through
  both Trainers as above; ``came`` raises the JAX package's reason.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vision_pt_tpu.training import optim8bit as joptim8bit
from vision_pt_tpu.training.optimizer import get_optimizer as jax_get_optimizer
from vision_pt_tpu_torch.training import optax_optimizers
from vision_pt_tpu_torch.training.optimizer import ScheduleFreeAdamW, get_optimizer
from tests.test_torch_sdxl_distributed import one_torch_thread  # noqa: F401,E402

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
    _trainers_match(tmp_path, "schedulefree.RAdamScheduleFree", {"lr": 2e-3})


def _trainers_match(tmp_path, name, args):
    """Five steps of both Trainers with optimizer ``name`` (``args``) on the
    tiny JiT trainer, compared as ``test_trainer_steps_match_jax`` says."""
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
    cfg["optimizer"] = {"name": name, "args": args}
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
    package's ``adamw8bit`` under the JAX schedule in the JAX layout (a
    linear's kernel (in, out), a conv's (kh, kw, in, out): the blocks run
    over that order), give the same parameters (1e-6) and the same int8
    moments. (Two trainers cannot be compared directly: gradients 1e-6
    apart move an int8 code where it sits at a rounding edge, and a second
    moment rounded to 0 makes that element's step m / eps.)"""
    from tests import test_torch_training as tt
    from vision_pt_tpu.training import scheduler as jscheduler
    from vision_pt_tpu_torch.config import TrainConfig
    from vision_pt_tpu_torch.parallel.mesh import flax_perms

    label2id = tmp_path / "label2id.json"
    label2id.write_text(__import__("json").dumps({f"c{i}": i for i in range(4)}))
    cfg = tt._config_dict(str(label2id), 1)
    cfg["optimizer"] = {"name": "bitsandbytes.optim.AdamW8bit", "args": {"lr": 2e-3}}
    trainer = tt.Trainer(TrainConfig.model_validate(cfg), device="cpu")
    trainer.register_train_dataset_class(tt.SyntheticClassImageDatasetConfig)
    trainer.register_model_class(tt.JiTForClassToImageTraining)
    trainer.before_train()
    params = trainer._params
    perms = [flax_perms(trainer.model.trainable())[p] for p in params]
    assert (1, 0) in perms  # the linears
    init = [np.transpose(p.detach().numpy(), perm).copy() for p, perm in zip(params, perms)]
    replay = []
    step = trainer.optimizer.step

    def recording():
        replay.append([np.transpose(p.grad.numpy(), perm).copy()
                       for p, perm in zip(params, perms)])
        step()

    trainer.optimizer.step = recording
    trainer.training_loop()
    assert len(replay) == tt.STEPS

    schedule = jscheduler.get_lr_schedule(2e-3, "cosine", {"num_warmup_steps": 2},
                                          total_steps=tt.STEPS)
    jparams, state = _run_optax(joptim8bit.adamw8bit(learning_rate=schedule),
                                init, replay)
    inner = state[0]
    for i, (p, jp, perm) in enumerate(zip(params, jparams, perms)):
        np.testing.assert_allclose(np.transpose(p.detach().numpy(), perm), np.asarray(jp),
                                   rtol=0, atol=1e-6)
        np.testing.assert_array_equal(trainer.optimizer.state[p]["m_q"].numpy(),
                                      np.asarray(inner.m_q[i]))
        np.testing.assert_array_equal(trainer.optimizer.state[p]["v_q"].numpy(),
                                      np.asarray(inner.v_q[i]))


# ------------------------------------------------------------------ optax rules

# (shape in the JAX package's layout, axis map port -> JAX): a linear (in,
# out) is (out, in) in the port, a conv HWIO is OIHW
OPTAX_PARAMS = [((7, 5), (1, 0)), ((3, 3, 4, 6), (3, 2, 0, 1)), ((300,), (0,)),
                ((256, 160), (1, 0)), ((128, 128), (1, 0))]
OPTAX_CASES = {  # port name -> (the name the JAX package resolves to it, args)
    "prodigy": ("prodigy", {"lr": 1.0, "weight_decay": 1e-2}),
    "lion": ("bitsandbytes.optim.Lion8bit", {"lr": 1e-3}),
    "adafactor": ("transformers.optimization.Adafactor", {"lr": 1e-2}),
    "rmsprop": ("torch.optim.RMSprop", {"lr": 1e-3}),
    "adagrad": ("torch.optim.Adagrad", {"lr": 1e-2}),
}
# the rules' other options, as optax takes them
OPTAX_OPTIONS = {
    "prodigy-safeguard": ("prodigy", {"lr": 0.5, "safeguard_warmup": True,
                                      "betas": (0.9, 0.99)}),
    "lion-decay": ("lion", {"lr": 1e-3, "weight_decay": 0.1}),
    "adafactor-momentum": ("adafactor", {"lr": 1e-2, "momentum": 0.9,
                                         "weight_decay_rate": 1e-3,
                                         "clipping_threshold": 0.5}),
    "adafactor-unfactored": ("adafactor", {"lr": 1e-2, "factored": False,
                                           "multiply_by_parameter_scale": False}),
    "rmsprop-centered": ("rmsprop", {"lr": 1e-3, "centered": True, "momentum": 0.9,
                                     "nesterov": True, "bias_correction": True}),
    "rmsprop-eps-outside": ("rmsprop", {"lr": 1e-3, "eps_in_sqrt": False,
                                        "initial_scale": 0.5, "momentum": 0.5}),
    "adagrad-zero-start": ("adagrad", {"lr": 1e-2, "initial_accumulator_value": 0.0}),
}


def _optax_arrays(seed):
    """Parameters, and gradients with a steady direction under the noise (so
    prodigy's distance estimate grows)."""
    rng = np.random.default_rng(seed)
    params = [rng.normal(size=s).astype(np.float32) * 0.5 for s, _ in OPTAX_PARAMS]
    steady = [rng.normal(size=s).astype(np.float32) for s, _ in OPTAX_PARAMS]
    grads = [[(d + 0.5 * rng.normal(size=d.shape)).astype(np.float32) for d in steady]
             for _ in range(STEPS)]
    return params, grads


def _to_port(array, perm):
    """A JAX-layout array in the port's layout, a copy."""
    return np.transpose(array, perm).copy()


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _jax_moment(state, i, port_shape, axis, perm):
    """The JAX adafactor moment that averaged over the JAX axis the port's
    ``axis`` maps to, in the port's order."""
    jax_axis = perm[axis]
    jshape = OPTAX_PARAMS[i][0]
    d1, d0 = optax_optimizers._factored_dims(jshape, True, 128)
    moment = state.v_row[i] if d0 == jax_axis else state.v_col[i]
    assert jax_axis in (d0, d1)
    kept = [a for a in range(len(jshape)) if a != jax_axis]
    order = [kept.index(perm[b]) for b in range(len(port_shape)) if b != axis]
    return np.transpose(np.asarray(moment), order)


@pytest.mark.parametrize("name", [*OPTAX_CASES, *OPTAX_OPTIONS])
def test_optax_rules_match_jax(name):
    alias, args = {**OPTAX_CASES, **OPTAX_OPTIONS}[name]
    init, grads = _optax_arrays(8)
    jax_args = {("learning_rate" if k == "lr" else k): v for k, v in args.items()}
    if alias == "prodigy":  # the JAX factory would split betas into b1 / b2
        tx = optax.contrib.prodigy(**jax_args)
    else:
        tx = jax_get_optimizer(alias, jax_args)
    jparams, state = _run_optax(tx, init, grads)
    params = [torch.nn.Parameter(torch.from_numpy(_to_port(p, perm)))
              for p, (_, perm) in zip(init, OPTAX_PARAMS)]
    opt = get_optimizer(alias, params, dict(args))
    name = name.split("-")[0]
    assert type(opt).__name__.lower() == name
    port_grads = [[_to_port(g, perm) for g, (_, perm) in zip(step, OPTAX_PARAMS)]
                  for step in grads]
    _run_port(opt, params, port_grads)
    for p, jp, p0, (_, perm) in zip(params, jparams, init, OPTAX_PARAMS):
        want = _to_port(np.asarray(jp), perm)
        assert _rel_l2(p.detach().numpy(), want) <= 1e-5
        assert _rel_l2(want, _to_port(p0, perm)) > 1e-6  # the parameters moved
    if name == "adafactor" and args.get("factored", True):
        inner = state[0]
        factored = 0
        for i, (p, (_, perm)) in enumerate(zip(params, OPTAX_PARAMS)):
            st = opt.state[p]
            if "v" in st:
                np.testing.assert_allclose(st["v"].numpy(),
                                           _to_port(np.asarray(inner.v[i]), perm),
                                           rtol=1e-5)
                continue
            factored += 1
            d1, d0 = optax_optimizers._factored_dims(tuple(p.shape), True, 128)
            for ours, axis in ((st["v_row"], d0), (st["v_col"], d1)):
                theirs = _jax_moment(inner, i, tuple(p.shape), axis, perm)
                assert _rel_l2(ours.numpy(), theirs) <= 1e-5
        assert factored == 2
    if name == "prodigy":
        d = float(opt.state["prodigy"]["estim_lr"])
        assert d == pytest.approx(float(state.estim_lr), rel=1e-5) and d > 1e-6


@pytest.mark.parametrize("name", OPTAX_CASES)
def test_optax_rules_through_both_trainers(name, tmp_path):
    """Each optax rule in the Trainer: the schedule reaches it as optax
    reads ``learning_rate(count)``. Adafactor, RMSprop and Adagrad run both
    Trainers side by side. Lion and prodigy replay the port Trainer's
    clipped gradients through the JAX package's optimizer under the JAX
    schedule instead, parameters within 1e-5: Lion takes the sign of
    moments that sit at 0 for some elements, so gradients 1e-7 apart flip
    them, and the JAX Trainer cannot step prodigy at all (its state holds
    the initial parameters, and the jitted step donates that buffer twice)."""
    alias, _ = OPTAX_CASES[name]
    lr = 1.0 if name == "prodigy" else 2e-3
    if name not in ("lion", "prodigy"):
        _trainers_match(tmp_path, alias, {"lr": lr})
        return
    from tests import test_torch_training as tt
    from vision_pt_tpu.training import scheduler as jscheduler
    from vision_pt_tpu_torch.config import TrainConfig

    label2id = tmp_path / "label2id.json"
    label2id.write_text(__import__("json").dumps({f"c{i}": i for i in range(4)}))
    cfg = tt._config_dict(str(label2id), 1)
    cfg["optimizer"] = {"name": alias, "args": {"lr": lr}}
    trainer = tt.Trainer(TrainConfig.model_validate(cfg), device="cpu")
    trainer.register_train_dataset_class(tt.SyntheticClassImageDatasetConfig)
    trainer.register_model_class(tt.JiTForClassToImageTraining)
    trainer.before_train()
    params = trainer._params
    init = [p.detach().numpy().copy() for p in params]
    replay, step = [], trainer.optimizer.step

    def recording():
        replay.append([p.grad.numpy().copy() for p in params])
        step()

    trainer.optimizer.step = recording
    trainer.training_loop()
    assert len(replay) == tt.STEPS
    schedule = jscheduler.get_lr_schedule(lr, "cosine", {"num_warmup_steps": 2},
                                          total_steps=tt.STEPS)
    jparams, _ = _run_optax(jax_get_optimizer(alias, {}, learning_rate_schedule=schedule),
                            init, replay)
    moved = 0
    for p, jp, p0 in zip(params, jparams, init):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=0, atol=1e-5)
        moved += not np.array_equal(np.asarray(jp), p0)
    assert moved > len(params) // 2


def test_optax_state_round_trip():
    """Prodigy's shared d, count and numerator survive ``state_dict``."""
    params = [torch.nn.Parameter(torch.from_numpy(p)) for p in _params(9)]
    opt = get_optimizer("prodigy", params, {"lr": 1.0})
    for step in _grads(10)[:3]:
        for p, g in zip(params, step):
            p.grad = torch.from_numpy(g)
        opt.step()
    twin = [torch.nn.Parameter(p.detach().clone()) for p in params]
    other = get_optimizer("prodigy", twin, {"lr": 1.0})
    other.load_state_dict(opt.state_dict())
    assert other.state["prodigy"]["count"] == 3
    assert torch.equal(other.state["prodigy"]["estim_lr"], opt.state["prodigy"]["estim_lr"])
    for step in _grads(11)[:2]:
        for group in (params, twin):
            for p, g in zip(group, step):
                p.grad = torch.from_numpy(g)
        opt.step()
        other.step()
    for p, q in zip(params, twin):
        assert torch.equal(p, q)


def test_came_raises_as_jax_does():
    with pytest.raises(ValueError, match="came not available") as theirs:
        jax_get_optimizer("came", {})
    p = torch.nn.Parameter(torch.zeros(3))
    with pytest.raises(ValueError) as ours:
        get_optimizer("came", [p])
    assert str(ours.value) == str(theirs.value)
