"""Training on a 'pod' axis over gloo on the CPU: one spawn of four ranks
(``launch.mesh.spawn``), each building the spawn's (2, 2, 1) mesh over
``("pod", "data", "model")`` (pod x data: the FSDP entry ``("pod",
"data")`` over their product, 4 ranks) and a (2, 1, 2) mesh in the same
world (pod beside 'model'), each rank holding its stored blocks
(``sharding.train_spec``) and stepping on its row block of the global
batch over the data axes, pod-major.

Reduced olmo-1b and deepseek-moe-16b (AdamW) and hymba-1.5b with 5 heads
under Adafactor factored at 8 (``TP_CASES``'s).  As in
``test_torch_train_tp.py``: the gathered gradients, loss and aux equal
the one-process step's within ``rtol`` 1e-5 and ``atol`` 1e-6 (f32 sums
reassociated by the ranks' partials and the all-reduces), and JAX's
``value_and_grad`` of the reference's ``loss_fn`` on the JAX package's
params within 1e-4 / 1e-5; the update is held against the one-process
update of the mesh's own gradients and of the one-process gradients.
Also: the stored blocks against ``train_spec`` and the FSDP entry
against the reference's ``_leaf_spec``, whole blocks bit-equal across
ranks, the MoE routing counts summed over pod x data, the bf16 rule
(each rank's gradients rounded before the mean), and checkpoints from
(2, 1, 2) onto (1, 2) and one process and from (1, 2) onto (2, 1, 2).
About 40 s in one process, the spawn's start-up and the JAX side
included.
"""

import dataclasses

import numpy as np
import pytest
import torch

import _torch_mesh_workers as W
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.mesh import spawn
from repro_torch.tree import flatten_with_paths, leaves, path_str

# the machine with the card has no JAX: there this file skips
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import ARCHS  # noqa: E402
from repro.distributed import sharding as jshd  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch.bridge import params_to_numpy  # noqa: E402

torch.set_num_threads(1)

SPAWN_TIMEOUT_S = 300
RTOL, ATOL = 1e-5, 1e-6
JAX_RTOL, JAX_ATOL = 1e-4, 1e-5
MESHES = W.POD_MESHES
CASES = W.POD_CASES


def _jax_config(case: str):
    arch, over, _ = W.TP_CASES[case]
    return dataclasses.replace(ARCHS[arch].reduced(), **over)


@pytest.fixture(scope="module")
def bridged():
    """The JAX package's reduced params of each case, as numpy."""
    init = jax.jit(jlm.init_lm, static_argnums=1)
    return {case: jax.tree.map(np.asarray, init(jax.random.PRNGKey(0),
                                                _jax_config(case)))
            for case in CASES}


@pytest.fixture(scope="module")
def one():
    """Every case's one-process step."""
    return {case: W.tp_step(case) for case in CASES}


@pytest.fixture(scope="module")
def ckpt_dirs(tmp_path_factory):
    return (str(tmp_path_factory.mktemp("pod_ckpt")),
            str(tmp_path_factory.mktemp("pod_sub_ckpt")))


@pytest.fixture(scope="module")
def ranks(one, bridged, ckpt_dirs):
    return spawn(W.pod_ranks, (2, 2, 1), device="cpu", kwargs=dict(
        one_grads={c: one[c]["grads"] for c in CASES}, bridged=bridged,
        ckpt_dir=ckpt_dirs[0], sub_ckpt_dir=ckpt_dirs[1]),
        timeout_s=SPAWN_TIMEOUT_S)


def _close(got, want, rtol=RTOL, atol=ATOL):
    pw, pg = flatten_with_paths(want), flatten_with_paths(got)
    assert [p for p, _ in pw] == [p for p, _ in pg]
    for (path, a), (_, b) in zip(pw, pg):
        torch.testing.assert_close(b, a, rtol=rtol, atol=atol,
                                   msg=lambda m: f"{path_str(path)}: {m}")


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))


def _rank_mesh(shape, rank: int) -> tmesh.Mesh:
    """A rank's mesh without process groups (placement reads shapes and
    coordinates only)."""
    axes = tmesh.MULTI_POD_AXES
    return tmesh.Mesh(shape=dict(zip(axes, shape)), rank=rank,
                      coords=dict(zip(axes, tmesh._coords(rank, shape))))


def _axes_of(spec) -> set:
    """The mesh axes a spec cuts by (an entry over several, each)."""
    return {a for e in spec if e is not None
            for a in (e if isinstance(e, tuple) else (e,))}


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mesh", MESHES)
def test_gradients_loss_and_aux_match_one_process(ranks, one, mesh, case):
    want = one[case]
    for r in ranks:
        got = r[mesh][case]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=RTOL)
        np.testing.assert_allclose(got["aux"], want["aux"], rtol=RTOL,
                                   atol=1e-9)
        _close(got["grads"], want["grads"])
        assert _equal(got["grads"], ranks[0][mesh][case]["grads"])
    if W.tp_config(case).moe is not None:
        assert want["aux"] > 0
    for k in ("loss", "aux_loss", "grad_norm"):
        np.testing.assert_allclose(ranks[0][mesh][case]["metrics"][k],
                                   want["metrics"][k], rtol=RTOL,
                                   atol=1e-9, err_msg=k)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mesh", MESHES)
def test_the_step_updates_as_one_process_would_on_its_gradients(
        ranks, mesh, case):
    """The mesh step's params and optimizer state (gathered) against the
    one-process clip and update of the mesh's gathered gradients: the
    norm, AdamW over FSDP blocks cut over pod x data, Adafactor's means
    across those blocks."""
    r = ranks[0][mesh][case]
    want = W.tp_update(case, r["grads"])
    _close(r["params"], want["params"])
    _close(r["opt"], want["opt"])
    np.testing.assert_allclose(r["metrics"]["grad_norm"], want["norm"],
                               rtol=RTOL)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mesh", MESHES)
def test_the_update_across_shards_matches_one_process(ranks, one, mesh,
                                                      case):
    """The mesh's clip and update of the one-process gradients (each rank
    on its blocks of them) against the one-process update."""
    got = ranks[0][mesh][case]["same_grads"]
    want = W.tp_update(case, one[case]["grads"])
    _close(got["params"], want["params"])
    _close(got["opt"], want["opt"])
    np.testing.assert_allclose(got["norm"], want["norm"], rtol=RTOL)
    if case == "hymba":     # factored statistics cut over the data axes
        assert any("vr" in path_str(p)
                   for p, _ in flatten_with_paths(got["opt"]))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mesh", MESHES)
def test_gradients_match_jax_value_and_grad(ranks, bridged, mesh, case):
    """The mesh's gathered gradients of the JAX package's params against
    ``jax.value_and_grad`` of the reference's ``loss_fn`` on the same
    batch, every leaf in the reference's layout."""
    jcfg = _jax_config(case)
    cfg = W.tp_config(case)
    batch = W.tp_batch(cfg)
    jt = jts.TrainConfig(opt=jopt.OptConfig(name=jcfg.optimizer))
    _, jg = jax.jit(jax.value_and_grad(jts.loss_fn, has_aux=True),
                    static_argnums=(1, 3))(
        jax.tree.map(jnp.asarray, bridged[case]), jcfg,
        {k: jnp.asarray(v) for k, v in batch.items()}, jt)
    ref = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jg))[0]
    for r in ranks:
        got = jax.tree_util.tree_flatten_with_path(
            params_to_numpy(r[mesh][case]["bridged"], cfg))[0]
        assert [p for p, _ in ref] == [p for p, _ in got]
        for (path, a), (_, b) in zip(ref, got):
            np.testing.assert_allclose(b, a, rtol=JAX_RTOL, atol=JAX_ATOL,
                                       err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("mesh", MESHES)
def test_each_rank_stores_only_its_train_spec_blocks(ranks, one, mesh):
    """Each rank's params, gradients and optimizer state are its blocks
    under ``train_spec``: every cut dim divided by its entry's size (the
    product for ``("pod", "data")``), and the FSDP entry is that tuple."""
    shape = MESHES[mesh]
    for rank, r in enumerate(ranks):
        m = _rank_mesh(shape, rank)
        for case in CASES:
            cfg = W.tp_config(case)
            for key in ("grads", "params", "opt"):
                full = one[case][key]
                specs = shd.train_specs_of(full, m, cfg)
                want = [tuple(n // (m.size(a) if a else 1)
                              for n, a in zip(t.shape, s))
                        for t, s in zip(leaves(full), specs)]
                assert r[mesh][case]["shapes"][key] == want, (case, key)
                entries = {a for s in specs for a in s if a}
                assert ("pod", "data") in entries
                assert "data" not in entries and "pod" not in entries
                assert ("model" in entries) == (m.size("model") > 1)


@pytest.mark.parametrize("mesh", MESHES)
def test_the_fsdp_entry_is_where_the_references_leaf_spec_puts_it(mesh):
    """olmo-1b, deepseek-moe-16b and hymba-1.5b at full width (shapes on
    the meta device), each leaf at its per-layer shape.  Where the
    reference's ``_leaf_spec`` puts its data axes, it puts them as the
    entry ``("pod", "data")``, and so does the port's ``train_spec``, by
    the reference's rule: on the first dim, other than the one it cuts
    on 'model', that the product divides.  Wherever the two put 'model'
    on the same dim, the entry is on the same dim; elsewhere the pinned
    'model' placement differs (the reference also names 'model' on a
    size-1 axis, and so never agrees on (2, 2, 1))."""
    m = _rank_mesh(MESHES[mesh], 0)
    n = m.size(("pod", "data"))

    def model_dims(spec):
        return [d for d, a in enumerate(spec) if a == "model"]

    def rule(shape, spec):
        return next(d for d in range(len(shape))
                    if d not in model_dims(spec) and shape[d] % n == 0)

    placed = agreed = 0
    for arch in ("olmo-1b", "deepseek-moe-16b", "hymba-1.5b"):
        full, specs = shd.model_specs(W.get_config(arch), m)
        for (path, t), spec in zip(flatten_with_paths(full), specs):
            ref = tuple(jshd._leaf_spec(path_str(path), tuple(t.shape), m,
                                        None))
            if ("pod", "data") not in ref:
                continue
            where = (arch, path_str(path), spec, ref)
            assert spec.index(("pod", "data")) == rule(t.shape, spec), where
            assert ref.index(("pod", "data")) == rule(t.shape, ref), where
            placed += 1
            if model_dims(spec) == model_dims(ref):
                assert spec.index(("pod", "data")) == ref.index(
                    ("pod", "data")), where
                agreed += 1
    assert placed > 20
    assert agreed > 20 or m.size("model") == 1


@pytest.mark.parametrize("mesh", MESHES)
def test_leaves_held_whole_are_bit_equal_across_ranks(ranks, mesh):
    """A block two ranks both hold (the leaf is not cut along an axis on
    which they differ; ``("pod", "data")`` cuts along both) is the same
    bits on both: gradients, updated params and optimizer state."""
    shape = MESHES[mesh]
    checked = 0
    for case in CASES:
        cfg = W.tp_config(case)
        for key in ("grads", "params", "opt"):
            blocks = [r[mesh][case]["blocks"][key] for r in ranks]
            specs = shd.train_specs_of(blocks[0], _rank_mesh(shape, 0), cfg)
            for i in range(len(ranks)):
                for j in range(i + 1, len(ranks)):
                    ci, cj = ranks[i]["coords"][mesh], ranks[j]["coords"][mesh]
                    differ = {a for a in ci if ci[a] != cj[a]}
                    for a, b, s in zip(leaves(blocks[i]), leaves(blocks[j]),
                                       specs):
                        if not differ & _axes_of(s):
                            assert torch.equal(a, b), (case, key, s)
                            checked += 1
    assert checked > 0


@pytest.mark.parametrize("mesh", MESHES)
def test_the_data_group_is_pod_major(ranks, mesh):
    """The data axes' process group gathers its members in the order
    ``shard_tensor`` cuts by: pod-major, ``pod * D + data``."""
    shape = MESHES[mesh]
    want = torch.tensor([[p, d] for p in range(shape[0])
                         for d in range(shape[1])])
    for r in ranks:
        assert torch.equal(r[mesh]["data_group"], want)


@pytest.mark.parametrize("mesh", MESHES)
def test_moe_routing_counts_are_summed_over_pod_and_data(ranks, mesh):
    """deepseek's load-balance loss forms ``ce`` from the routing counts
    summed over the data axes' group (pod x data: 4 ranks on (2, 2, 1), 2
    on (2, 1, 2)): every layer's summed counts equal the one-process
    counts of the whole batch."""
    one = W.pod_counts(None)
    n = MESHES[mesh][0] * MESHES[mesh][1]
    for r in ranks:
        got = r[mesh]["counts"]
        assert len(got) == len(one) > 0
        for (c, size), (c1, _) in zip(got, one):
            assert size == n
            assert torch.equal(c, c1)


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp of each element of ``x`` (8 significant bits)."""
    return torch.ldexp(torch.ones_like(x), torch.frexp(x)[1] - 8)


def _bf16_per_rank(mesh: str) -> tuple[list, list]:
    """The bf16 rule worked out on one process: olmo's gradients on each
    rank's row block of the batch alone (pod-major over the data axes),
    each rounded to bf16, then their f32 mean; and beside each element
    the sum over the blocks of one bf16 ulp of its gradient over their
    count (what a block's f32 gradient on the mesh, a rounding of it
    away, can move when it lies at a rounding edge)."""
    from repro_torch.models import lm
    from repro_torch.train.train_step import build_train_step

    cfg = W.tp_config("olmo")
    step, _ = build_train_step(cfg, W.tp_train_config("olmo", cfg))
    params = lm.init_lm(cfg, seed=0, device="cpu")
    batch = W.tp_batch(cfg)
    n = MESHES[mesh][0] * MESHES[mesh][1]
    rows = W.TP_BATCH // n
    total = edge = None
    for r in range(n):
        g, _, _ = step.grads(params, {k: v[r * rows:(r + 1) * rows]
                                      for k, v in batch.items()})
        g = [t.to(torch.bfloat16).float() for t in leaves(g)]
        u = [_bf16_ulp(t) / n for t in g]
        total = g if total is None else [a + b for a, b in zip(total, g)]
        edge = u if edge is None else [a + b for a, b in zip(edge, u)]
    return [t / n for t in total], edge


@pytest.mark.parametrize("mesh", MESHES)
def test_bf16_compression_rounds_each_ranks_gradients(ranks, mesh):
    """With ``grad_compress="bf16"`` each rank's gradient blocks are
    rounded to bf16 before the f32 mean over pod x data, on every mesh
    (the port's rule; the reference rounds its one global gradient).
    Where every rank's row block is the same rows (the same gradient
    bits on each), the mean is the uncompressed gradients rounded, bit
    for bit.  On the usual batch the mean equals the one-process mean of
    each row block's rounded gradients within the file's f32 tolerance
    plus, where a block's f32 gradient lies at a rounding edge, that
    block's ulp over the count; and it differs from the rounded global
    gradient."""
    got = ranks[0][mesh]["bf16"]
    for a, b in zip(leaves(got["plain"]), leaves(got["bf16"])):
        assert torch.equal(b, a.to(torch.bfloat16).float())
    want, edge = _bf16_per_rank(mesh)
    for a, e, b in zip(want, edge, leaves(got["bf16_batch"])):
        assert torch.all((b - a).abs() <= RTOL * a.abs() + ATOL + e)
    glob = W.tp_step("olmo", compress="bf16", full_step=False)["grads"]
    assert not all(torch.allclose(a, b, rtol=RTOL, atol=ATOL)
                   for a, b in zip(leaves(glob), want))


def _saved(directory: str, case: str) -> dict:
    """The checkpoint in ``directory`` restored onto one process, over a
    template of ``case`` drawn from another seed."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.models import lm
    from repro_torch.train.optimizer import make_optimizer

    cfg = W.tp_config(case)
    init, _ = make_optimizer(W.tp_train_config(case, cfg).opt, cfg)
    params = lm.init_lm(cfg, seed=1, device="cpu")
    return CheckpointManager(directory).restore(
        {"params": params, "opt": init(params)})[0]


def test_a_pod_checkpoint_restores_onto_1x2_and_one_process(ranks,
                                                            ckpt_dirs):
    """hymba's stepped params and Adafactor state saved from (2, 1, 2)
    (full leaves, rank 0 of the world writing): restored onto (1, 2)
    meshes (ranks {0, 1} and {2, 3}, each cutting its own blocks) and
    onto one process, the full leaves bit-equal to the saved ones; the
    JAX package's manager reads them too."""
    from repro.checkpoint.manager import CheckpointManager as JaxManager

    case = W.POD_CKPT_CASE
    r0 = ranks[0]["2x1x2"][case]
    saved = {"params": r0["params"], "opt": r0["opt"]}
    for r in ranks:
        assert _equal(r["restored_12"]["full"], saved)
        assert r["restored_12"]["shapes"] != [tuple(t.shape)
                                              for t in leaves(saved)]
    restored = _saved(ckpt_dirs[0], case)
    assert _equal(restored, saved)
    assert [path_str(p) for p, _ in flatten_with_paths(restored)] == \
        [path_str(p) for p, _ in flatten_with_paths(saved)]
    as_numpy = jax.tree.map(lambda t: t.numpy(), saved)
    jrestored, _ = JaxManager(ckpt_dirs[0]).restore(as_numpy)
    assert all(np.array_equal(x, np.asarray(y)) for x, y in zip(
        jax.tree.leaves(as_numpy), jax.tree.leaves(jrestored)))


def test_a_1x2_checkpoint_restores_onto_a_pod_mesh(ranks, ckpt_dirs):
    """olmo-1b's stepped state saved from a (1, 2) mesh, restored onto
    (2, 1, 2): each rank's blocks of its own shapes (cut over pod and
    'model'), the full leaves gathered back bit-equal to the saved ones
    and to a one-process restore."""
    saved = ranks[0]["sub_saved"]
    assert _equal(ranks[1]["sub_saved"], saved)
    for r in ranks:
        assert _equal(r["restored_212"]["full"], saved)
        assert r["restored_212"]["shapes"] != [tuple(t.shape)
                                               for t in leaves(saved)]
    assert _equal(_saved(ckpt_dirs[1], W.POD_SUB_CKPT_CASE), saved)
