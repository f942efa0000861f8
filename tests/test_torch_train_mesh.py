"""Data-parallel training on a (2, 1) mesh over gloo on the CPU: two
ranks started by the port's launcher (``launch.mesh.spawn``), each
holding its FSDP blocks of the params and optimizer state (each leaf cut
over 'data', ``sharding.train_spec``) and stepping on its row block of
one global batch.

The ranks must end with bit-equal params when gathered from their blocks
(they apply the same averaged gradients), and the step's loss, MoE aux
loss and averaged gradients must equal the one-process step's on the
whole batch: f32, where the per-rank sums and the all-reduce
reassociate the batch sums, so within ``rtol`` 1e-5 and ``atol`` 1e-6.
Reduced olmo-1b and deepseek-moe-16b (whose aux loss is not linear in
the batch: the ranks sum their routing counts first), olmo-1b with
accumulation, and the training launcher through an injected fault;
about 18 s in one process, one spawn.
"""


import numpy as np
import pytest
import torch

import _torch_mesh_workers as W
from repro_torch.launch import train as launcher
from repro_torch.launch.mesh import spawn
from repro_torch.tree import leaves

torch.set_num_threads(1)

SPAWN_TIMEOUT_S = 240
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    return spawn(W.train_ranks, (2, 1), device="cpu", args=(ckpt,),
                 timeout_s=SPAWN_TIMEOUT_S)


def _bit_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))


@pytest.mark.parametrize("case", [*W.TRAIN_ARCHS, "accum"])
def test_ranks_end_bit_equal_and_match_one_process(ranks, case):
    r0, r1 = ranks[0][case], ranks[1][case]
    assert _bit_equal(r0["params"], r1["params"])
    assert _bit_equal(r0["grads"], r1["grads"])
    assert r0["metrics"] == r1["metrics"]
    arch = "olmo-1b" if case == "accum" else case
    one = W.train_one(arch, accum=2 if case == "accum" else 1)
    np.testing.assert_allclose(r0["loss"], one["loss"], rtol=RTOL)
    np.testing.assert_allclose(r0["aux"], one["aux"], rtol=RTOL, atol=1e-9)
    if arch == "deepseek-moe-16b":
        assert one["aux"] > 0
    for a, b in zip(leaves(one["grads"]), leaves(r0["grads"])):
        torch.testing.assert_close(b, a, rtol=RTOL, atol=ATOL)
    for k in ("loss", "aux_loss", "grad_norm"):
        np.testing.assert_allclose(r0["metrics"][k], one["metrics"][k],
                                   rtol=RTOL, atol=1e-9, err_msg=k)


def test_aux_loss_needs_the_global_counts(ranks):
    """Each rank's aux from its own rows' routing alone (no sum of the
    counts) differs from the global batch's, which the ranks report."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import lm

    cfg = get_config("deepseek-moe-16b").reduced()
    params = lm.init_lm(cfg, seed=0, device="cpu")
    tokens = SyntheticLM(cfg, DataConfig(global_batch=W.TRAIN_BATCH,
                                         seq_len=W.TRAIN_SEQ)).batch_at(0)
    tokens = torch.from_numpy(tokens["tokens"])
    half = W.TRAIN_BATCH // 2
    local = [float(lm.forward(params, cfg, t)[2])
             for t in (tokens[:half], tokens[half:])]
    assert abs(np.mean(local) - ranks[0]["deepseek-moe-16b"]["aux"]) > 1e-7


def test_launcher_on_the_mesh_recovers_and_only_rank0_writes(ranks, tmp_path):
    """``--mesh 2x1`` through a fault at step 3: both ranks restore step
    2 and replay; they end bit-equal, and near the one-process run's
    params; only rank 0 wrote checkpoints (keep 2: steps 4 and 6)."""
    l0, l1 = ranks[0]["launcher"], ranks[1]["launcher"]
    for r in (l0, l1):
        assert r["stats"].restarts == 1 and r["stats"].restored_steps == [2]
    assert _bit_equal(l0["params"], l1["params"])
    assert _bit_equal(l0["opt"], l1["opt"])
    assert l0["losses"] == l1["losses"]
    assert ranks[0]["ckpt_steps"] == ["step_0000000004", "step_0000000006"]
    one = launcher.main(W.train_launcher_argv(str(tmp_path)))
    np.testing.assert_allclose(l0["losses"][-1], one["losses"][-1],
                               rtol=1e-4)
