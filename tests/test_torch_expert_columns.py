"""Expert stacks cut on ``f`` where E does not divide 'model'
(``sharding.serve_spec`` / ``train_spec``, ``layers.moe_partial``).

The placement: grok-1-314b's full expert stacks (8 experts) on a
``{data: 16, model: 16}`` description take 'model' on ``f``, where the
reference's ``_leaf_spec`` puts it on a per-layer leaf; deepseek-moe-16b's
64 experts stay cut on E; every registered config's stacks on the
meshes the tests and the card run ((1, 2), (2, 2), (2, 1, 2)) are cut on
E as before.

Then one 2-rank gloo spawn on a (1, 2) mesh (``launch.mesh.spawn``,
``_torch_expert_workers.ranks``) runs reduced grok-1-314b with 3 experts
and reduced deepseek-moe-16b with 5 (beside its shared expert), each
rank holding its half of every expert's ``f``:

* serving through each MoE decode route (ragged, grouped, einsum) with
  chunked prefill: greedy tokens equal to the JAX ``Engine``'s on the
  same params, every sampled logits row within 1e-4 of the port's
  unsharded engine (f32; the ranks' partial sums reassociate);
* int8 stacks cut by ``shard_packed`` (gate / up on M, down on K in whole
  scale blocks) through ``dispatch_ragged``: the summed partials against
  the unsharded stacks and the JAX dispatcher's (1e-5 relative, 1e-4
  absolute, as ``test_torch_gpu_backend``'s quantized stacks);
* training on the JAX package's params: loss and aux against
  ``jax.value_and_grad`` of the reference's ``loss_fn``, and every
  gathered gradient within 1e-3 of its leaf's max |g|;
* grok's stepped state saved from the mesh, which the reference's
  ``CheckpointManager`` restores bit for bit.

About 55 s in one process (one worker), the spawn's start-up and the JAX side
included.
"""

import dataclasses

import numpy as np
import pytest
import torch

import _torch_expert_workers as X
import _torch_mesh_workers as W
from repro_torch.configs.registry import ARCHS as TORCH_ARCHS
from repro_torch.configs.registry import get_config
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import spawn
from repro_torch.models import lm
from repro_torch.tree import flatten_with_paths

# the machine with the card has no JAX: there this file skips
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import ARCHS  # noqa: E402
from repro.distributed import sharding as jshd  # noqa: E402
from repro.kernels import dispatch as jdispatch  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch.bridge import params_to_numpy  # noqa: E402
from test_torch_graphs import _jax_tree  # noqa: E402

torch.set_num_threads(1)

SPAWN_TIMEOUT_S = 240
ROW_ATOL = 1e-4
GRAD_OF_MAX = 1e-3      # a gradient's error over its leaf's max |g|
STACKS = ("w_gate", "w_up", "w_down")


class FakeMesh:
    """Duck-typed mesh: shape mapping + axis names only."""

    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)

    def size(self, axes) -> int:
        axes = axes if isinstance(axes, tuple) else (axes,)
        return int(np.prod([self.shape.get(a, 1) for a in axes]))


def _stack_leaves(cfg):
    """(path, shape) of layer 0's expert stacks at ``cfg``'s widths."""
    p = lm.init_lm(dataclasses.replace(cfg, n_layers=1),
                   device="meta")["layers"][0]["moe"]
    return [(f"layers/0/moe/{k}", tuple(p[k].shape)) for k in STACKS
            if k in p]


def _model_dim(spec):
    return list(spec).index("model") if "model" in spec else None


def test_grok_stacks_take_model_on_f_as_the_references_leaf_spec():
    """grok-1-314b at full width on ``{data: 16, model: 16}``: 8 experts
    do not divide 16, so gate / up take 'model' on ``f`` (dim 2) and
    down on ``f`` (dim 1), the dim the reference's ``_leaf_spec`` of the
    same per-layer leaf gives; training adds 'data' on the first other
    dim 16 divides.  deepseek-moe-16b's 64 experts stay on E."""
    mesh = FakeMesh({"data": 16, "model": 16})
    for arch, want in (("grok-1-314b", {"w_gate": 2, "w_up": 2,
                                        "w_down": 1}),
                       ("deepseek-moe-16b", dict.fromkeys(STACKS, 0))):
        cfg = get_config(arch)
        for path, shape in _stack_leaves(cfg):
            name = path.split("/")[-1]
            served = shd.serve_spec(path, shape, mesh, cfg)
            ref = jshd._leaf_spec(path, shape, mesh, ARCHS[arch])
            assert _model_dim(served) == _model_dim(ref) == want[name], (
                arch, path, served, ref)
            train = shd.train_spec(path, shape, mesh, cfg)
            assert _model_dim(train) == want[name]
            free = [d for d in range(3) if d != want[name]]
            assert train.index("data") == next(
                d for d in free if shape[d] % 16 == 0), (path, train)
    # a whole expert's f a rank: 32768 / 16 columns, whole 32-row blocks
    g = get_config("grok-1-314b")
    shape = (8, g.d_model, g.moe.d_expert)
    assert shd.block_shape(shape, shd.serve_spec(
        "layers/0/moe/w_up", shape, mesh, g), mesh) == (8, 6144, 2048)


@pytest.mark.parametrize("mesh", [{"data": 1, "model": 2},
                                  {"data": 2, "model": 2},
                                  {"pod": 2, "data": 1, "model": 2}])
def test_every_registered_stack_stays_cut_on_e_on_the_meshes_that_run(mesh):
    """On (1, 2), (2, 2) and (2, 1, 2) every registered MoE config's
    expert stacks, reduced and full, are cut on E: the ``f`` fallback
    changes no placement the tests or the card run."""
    m = FakeMesh(mesh)
    seen = 0
    for arch in TORCH_ARCHS:
        for cfg in (get_config(arch), get_config(arch).reduced()):
            if cfg.moe is None:
                continue
            for path, shape in _stack_leaves(cfg):
                assert _model_dim(shd.serve_spec(path, shape, m, cfg)) == 0
                assert _model_dim(shd.train_spec(path, shape, m, cfg)) == 0
                seen += 1
    assert seen == 12


def test_f_falls_back_to_whole_where_neither_divides():
    """A stack whose E and ``f`` both leave the axis undivided stays whole
    (the reference would cut ``d``, split-K, which serving does not
    run); a shared experts' MLP is a dense FFN, not a stack."""
    cfg = get_config("grok-1-314b").reduced()
    m = FakeMesh({"data": 1, "model": 3})
    assert shd.serve_spec("layers/0/moe/w_up", (8, 64, 128), m, cfg) == \
        (None,) * 3
    assert not shd.is_expert_stack("layers/0/moe/shared/w_up", (64, 128))
    assert not shd.is_expert_stack("layers/mlp/w_up", (4, 64, 128))


# --------------------------------------------------------------------------
# the (1, 2) spawn
# --------------------------------------------------------------------------


def _jax_config(name: str):
    arch, n = X.ODD[name]
    cfg = ARCHS[arch].reduced()
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            n_experts=n))


@pytest.fixture(scope="module")
def bridged():
    """Each case's JAX ``init_lm`` tree as numpy."""
    init = jax.jit(jlm.init_lm, static_argnums=1)
    return {name: jax.tree.map(np.asarray, init(jax.random.PRNGKey(0),
                                                _jax_config(name)))
            for name in X.ODD}


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("expert_columns_ckpt"))


@pytest.fixture(scope="module")
def ranks(bridged, ckpt_dir):
    return spawn(X.ranks, (1, 2), device="cpu",
                 args=(bridged, ckpt_dir), timeout_s=SPAWN_TIMEOUT_S)


_JAX: dict = {}


def jax_tokens(name: str) -> dict:
    """The JAX ``Engine``'s greedy tokens on the case's weights (the
    port's seeded init, bridged), the mixed plan at chunk 8."""
    if name not in _JAX:
        tcfg = X.odd_config(name)
        clk = W.FakeClock()
        eng = JaxEngine(_jax_config(name),
                        _jax_tree(lm.init_lm(tcfg, seed=0, device="cpu")),
                        max_len=W.MAX_LEN, clock=clk, batch_slots=4,
                        prefill_chunk=8)
        reqs = W.drive(eng, JaxRequest, W.mix_plan(tcfg.vocab), clk)
        _JAX[name] = {rid: list(r.generated) for rid, r in reqs.items()}
    return _JAX[name]


@pytest.mark.parametrize("shape", X.EXPERT_SHAPES)
@pytest.mark.parametrize("name", list(X.ODD))
def test_tokens_equal_the_jax_engine_and_rows_the_unsharded(ranks, name,
                                                            shape):
    base = X.serve(name, shape)
    assert base["tokens"] == jax_tokens(name)
    cfg = X.odd_config(name)
    E, f, d = cfg.moe.n_experts, cfg.moe.d_expert, cfg.d_model
    for rank in ranks:
        got = rank[name, shape]
        assert got["tokens"] == base["tokens"]
        worst = 0.0
        for rid, rows in base["rows"].items():
            assert len(got["rows"][rid]) == len(rows)
            for a, b in zip(got["rows"][rid], rows):
                worst = max(worst, float(np.abs(a - b).max()))
        assert worst <= ROW_ATOL, worst
        # every expert, half of its f
        assert got["moe0"]["w_up"] == (E, d, f // 2)
        assert got["moe0"]["w_down"] == (E, f // 2, d)
        axes = got["stats"]["sharded_axes"]
        assert "E" not in axes
        if shape != "einsum":
            assert {"M", "K"} <= set(axes)
            picks = " ".join(got["stats"]["shard_picks"])
            assert f"{shape}[{f // 2}]x{d}" in picks and f"_e{E}_" in picks
    for rid, rows in ranks[0][name, shape]["rows"].items():
        for a, b in zip(rows, ranks[1][name, shape]["rows"][rid]):
            np.testing.assert_array_equal(a, b)


def _jax_quant_ffn(name: str) -> np.ndarray:
    """The JAX dispatcher's expert FFN over the same int8 codes and
    scales (its ``cpu`` backend; the reference's activations)."""
    cfg = X.odd_config(name)
    x, counts = X.quant_inputs(name)
    stacks = {k: jops.PackedWeights(w_t=jnp.asarray(pw.w_t.numpy()),
                                    scales=jnp.asarray(pw.scales.numpy()),
                                    bits=8, block=32)
              for k, pw in X.quant_stacks(name).items()}
    pol = jdispatch.DispatchPolicy(backend="cpu")
    xj, cj = jnp.asarray(x.numpy()), jnp.asarray(counts.numpy())

    def proj(t, w):
        return jdispatch.dispatch_ragged(t, cj, w, policy=pol)

    act = jax.nn.silu if cfg.act == "silu" else jax.nn.gelu
    h = act(proj(xj, stacks["w_gate"])) * proj(xj, stacks["w_up"])
    return np.asarray(proj(h, stacks["w_down"]))


@pytest.mark.parametrize("name", list(X.ODD))
def test_int8_stacks_cut_on_f_sum_to_the_whole_stacks(ranks, name):
    whole = X.quant_ffn(name)
    want = _jax_quant_ffn(name)
    np.testing.assert_allclose(whole["y"].numpy(), want, rtol=1e-5,
                               atol=1e-4)
    cfg = X.odd_config(name)
    E, f, d = cfg.moe.n_experts, cfg.moe.d_expert, cfg.d_model
    for rank in ranks:
        got = rank[name, "quant"]
        assert got["axes"] == {"w_gate": "M", "w_up": "M", "w_down": "K"}
        assert all(got["equals_own"].values())
        assert got["block_shapes"]["w_up"] == (E, d, f // 2)
        assert got["block_shapes"]["w_down"] == (E, f // 2, d)
        np.testing.assert_allclose(got["y"].numpy(), whole["y"].numpy(),
                                   rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(got["y"].numpy(), want, rtol=1e-5,
                                   atol=1e-4)
        assert set(got["stats"]["sharded_axes"]) == {"M", "K"}
    np.testing.assert_array_equal(ranks[0][name, "quant"]["y"].numpy(),
                                  ranks[1][name, "quant"]["y"].numpy())


@pytest.mark.parametrize("name", list(X.ODD))
def test_gradients_match_jax_value_and_grad(ranks, bridged, name):
    """The mesh's gathered gradients, loss and aux against
    ``jax.value_and_grad`` of the reference's ``loss_fn`` on the same
    params and batch."""
    jcfg = _jax_config(name)
    cfg = X.odd_config(name)
    batch = W.tp_batch(cfg)
    jt = jts.TrainConfig(opt=jopt.OptConfig(name=jcfg.optimizer))
    (_, (jl, ja)), jg = jax.jit(
        jax.value_and_grad(jts.loss_fn, has_aux=True),
        static_argnums=(1, 3))(jax.tree.map(jnp.asarray, bridged[name]),
                               jcfg, {k: jnp.asarray(v)
                                      for k, v in batch.items()}, jt)
    ref = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jg))[0]
    for rank in ranks:
        r = rank[name, "train"]
        np.testing.assert_allclose(r["loss"], float(jl), rtol=1e-6)
        np.testing.assert_allclose(r["aux"], float(ja), rtol=1e-5,
                                   atol=1e-8)
        # each rank stored its f block of every expert
        assert (cfg.moe.n_experts, cfg.d_model, cfg.moe.d_expert // 2) in \
            r["shapes"]
        got = jax.tree_util.tree_flatten_with_path(
            params_to_numpy(r["grads"], cfg))[0]
        assert [p for p, _ in ref] == [p for p, _ in got]
        for (path, a), (_, b) in zip(ref, got):
            np.testing.assert_allclose(
                b, a, rtol=0, atol=GRAD_OF_MAX * float(np.abs(a).max()),
                err_msg=jax.tree_util.keystr(path))


def test_the_reference_restores_the_meshs_checkpoint(ranks, ckpt_dir):
    """grok's stepped params and Adafactor state, saved from the (1, 2)
    mesh (full leaves, rank 0 writing), are in the reference's layout:
    the JAX package's ``CheckpointManager`` restores them bit for bit,
    the expert stacks whole."""
    from repro.checkpoint.manager import CheckpointManager as JaxManager

    saved = ranks[0][X.CKPT_CASE, "train"]["state"]
    for rank in ranks[1:]:
        assert all(torch.equal(a, b) for (_, a), (_, b) in zip(
            flatten_with_paths(saved),
            flatten_with_paths(rank[X.CKPT_CASE, "train"]["state"])))
    cfg = X.odd_config(X.CKPT_CASE)
    stack = saved["params"]["layers"][0]["moe"]["w_up"]
    assert tuple(stack.shape) == (cfg.moe.n_experts, cfg.d_model,
                                  cfg.moe.d_expert)
    as_numpy = jax.tree.map(lambda t: t.numpy(), saved)
    restored, _ = JaxManager(ckpt_dir).restore(as_numpy)
    a = jax.tree_util.tree_flatten_with_path(as_numpy)[0]
    b = jax.tree_util.tree_flatten_with_path(restored)[0]
    assert [p for p, _ in a] == [p for p, _ in b]
    assert all(np.array_equal(x, np.asarray(y))
               for (_, x), (_, y) in zip(a, b))
