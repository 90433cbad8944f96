"""The port's SDXL QLoRA trainer with AdamW8bit and flow-match trainer under
``trainer.mesh`` {data 2, fsdp 2} on a 4-rank gloo group on the CPU, against
the port's one-process run and the JAX package's one-device step; the setup
and the limits are ``tests/test_torch_sdxl_distributed.py``'s.

- QLoRA: the UNet's attention and feed-forward linears NF4 through the
  plain dequantization (their codes and scales whole on every rank), with
  per-layer recompute under FSDP. AdamW8bit's measured gaps over all the
  adapters: 1.9e-6 against the one-process run, 8.3e-6 against JAX, under
  ADAPTER_RTOL (1e-4). Its moments under FSDP are the whole array's: the
  mesh run's gathered gradients, replayed through a one-device AdamW8bit over
  the same layouts, give its parameters, int8 codes and block scales bit for
  bit, and the two fsdp ranks share blocks of split adapters (the shard
  boundary cuts a block).
- Flow-match LoRA with schedule-free.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_sdxl_distributed import (  # noqa: F401 (one_torch_thread)
    _ok,
    check_against,
    check_file,
    check_mesh_case,
    check_resume,
    check_sharded,
    make_runs,
    one_torch_thread,
)

CASES = ["qlora_data2_fsdp2", "flow_data2_fsdp2"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return make_runs(tmp_path_factory, CASES)


@pytest.mark.parametrize("case", CASES)
def test_mesh_step_matches_the_one_process_and_jax_steps(runs, case):
    check_mesh_case(runs, case)


@pytest.mark.parametrize("kind", ["qlora", "flow"])
def test_one_process_step_matches_jax(runs, kind):
    _, jax_runs, one, _ = runs
    check_against(one[kind], jax_runs[kind], f"{kind} one process against JAX")


@pytest.mark.parametrize("case", CASES)
def test_rank_zero_saves_the_one_process_file(runs, case):
    check_file(runs, case)


@pytest.mark.parametrize("case", CASES)
def test_resume_under_the_mesh_matches_the_unbroken_run(runs, case):
    check_resume(runs, case)


@pytest.mark.parametrize("case", CASES)
def test_fsdp_shards_adapters_and_frozen_weights(runs, case):
    check_sharded(runs, case)


def test_8bit_moments_are_the_whole_arrays_blocks(runs):
    from vision_pt_tpu_torch.training.optim8bit import AdamW8bit

    ranks, _, _, _ = runs
    run = _ok(ranks[0]["qlora_data2_fsdp2"])
    names = list(run["start"])
    params = [torch.nn.Parameter(torch.from_numpy(run["start"][n].copy())) for n in names]
    opt = AdamW8bit(params, lr=1e-3,
                    layouts={p: run["perms"][n] for n, p in zip(names, params)})
    for step in run["grads"]:
        for n, p in zip(names, params):
            p.grad = torch.from_numpy(step[n])
        opt.step()
    for n, p in zip(names, params):
        np.testing.assert_array_equal(p.detach().numpy(), run["adapters"][n], err_msg=n)
        ours, theirs = run["state"][n], opt.state[p]
        for key in ("m_scale", "v_scale"):
            np.testing.assert_array_equal(ours[key], theirs[key].numpy(), err_msg=n)
        for key in ("m_q", "v_q"):
            # the mesh keeps the codes in the parameter's shape; one device
            # in blocks over the flax order
            flat = np.transpose(ours[key], run["perms"][n]).reshape(-1)
            np.testing.assert_array_equal(flat, theirs[key].numpy().reshape(-1)[: flat.size],
                                          err_msg=n)
    # ranks 0 and 1 hold the two fsdp shards of data row 0
    blocks = [_ok(r["qlora_data2_fsdp2"])["blocks"] for r in ranks[:2]]
    assert [n for n in blocks[0] if set(blocks[0][n]) & set(blocks[1][n])], blocks[0]
