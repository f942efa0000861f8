"""One training step of every registered config, reduced, against the JAX
package: the counterpart of ``test_models.py::test_one_train_step_no_nans``
held to the reference's numbers.

Both packages get the same weights (the JAX ``init_lm`` tree through
``repro_torch.bridge``) and the same batch (tokens, and whisper's frames
or llama-vision's patches, from the port's ``SyntheticLM``, bit-equal to
the reference's).  The loss, the MoE aux loss and every gradient hold
against ``jax.value_and_grad`` of the reference's ``loss_fn``: f32 on
both sides, summed in other orders, so within ``rtol`` 1e-4 and ``atol``
1e-5.  Gradients are compared rather than the updated params: at step 1
Adam moves each weight by about ``sign(g) * lr``, so a gradient near zero
may flip its sign between two correct implementations.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

# the machine with the card has no JAX: there this file skips
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import ARCHS  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import train_step as tts  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
B, S = 2, 32


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_one_train_step_matches_the_reference(arch):
    jcfg, tcfg = ARCHS[arch].reduced(), get_config(arch).reduced()
    assert tcfg.optimizer == jcfg.optimizer and tcfg.remat == jcfg.remat
    jp = jlm.init_lm(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    batch = SyntheticLM(tcfg, DataConfig(global_batch=B, seq_len=S,
                                         seed=1)).batch_at(0)
    jt = jts.TrainConfig(opt=jopt.OptConfig(name=jcfg.optimizer, lr=1e-3,
                                            warmup_steps=1, total_steps=10))
    (_, (jl, ja)), jg = jax.jit(
        jax.value_and_grad(jts.loss_fn, has_aux=True),
        static_argnums=(1, 3))(jp, jcfg,
                               {k: jnp.asarray(v) for k, v in batch.items()},
                               jt)
    tt = tts.TrainConfig(opt=topt.OptConfig(name=tcfg.optimizer, lr=1e-3,
                                            warmup_steps=1, total_steps=10))
    step, opt_init = tts.build_train_step(tcfg, tt)
    tg, tl, ta = step.grads(tp, batch)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5, atol=1e-8)
    if tcfg.moe is not None:
        assert float(ta) > 0
    ref = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, jg))[0]
    got = jax.tree_util.tree_flatten_with_path(
        params_to_numpy(tg, tcfg))[0]
    assert [p for p, _ in ref] == [p for p, _ in got]
    for (path, a), (_, b) in zip(ref, got):
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL,
                                   err_msg=jax.tree_util.keystr(path))
    # every leaf the reference moves gets a gradient here too
    assert all(np.any(b != 0) for (_, a), (_, b) in zip(ref, got)
               if np.any(np.abs(a) > ATOL))
    # the whole step: finite, positive loss, every param leaf a tensor
    # of its own that no longer requires grad, and the params moved
    new, state, m = step(tp, opt_init(tp), batch)
    assert np.isfinite(float(m["loss"])) and float(m["loss"]) > 0
    assert np.isfinite(float(m["grad_norm"]))
    assert max(float((a - b).abs().max())
               for a, b in zip(leaves(tp), leaves(new))) > 0
    assert not any(t.requires_grad for t in leaves(new))
