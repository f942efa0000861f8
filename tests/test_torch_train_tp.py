"""Model-parallel training on (1, 2) and (2, 2) meshes over gloo on the
CPU: ranks started by the port's launcher (``launch.mesh.spawn``), each
holding its stored blocks of the params and optimizer state
(``sharding.train_spec``: its 'model' block of each leaf, cut again over
'data') and stepping on its 'data' row block of one global batch.

Reduced olmo-1b and deepseek-moe-16b (AdamW), olmo-1b with one kv head
(K and V whole on every rank, each reading the kv head its query heads
share), grok-1-314b (Adafactor factored at 8, so that leaves a cut
splits factor), and whisper-small and llama-3.2-vision-11b at 2 groups
(every ``cross_gate`` at 0.75: whisper's encoder and each layer's
cross-attention as rank blocks, the context's gradient summed over the
ranks that read it, the shared branches -- norms, ``proj``, the gates --
whole on every rank).  The step's
gradients (gathered from every rank's blocks), loss and aux must equal
the one-process step's: f32, where the ranks' partial sums and the
all-reduces reassociate the sums, so within ``rtol`` 1e-5 and ``atol``
1e-6.  The update is held two ways: the mesh step's updated params and
state against the one-process update of the mesh's own gathered
gradients, and the mesh's update of the one-process gradients against
the one-process update of them.  Comparing the two steps' params
directly would not hold: at step 1 AdamW moves each weight by about
``sign(g) * lr``, so a gradient within its rounding of zero may move
either way in two correct runs.

One (2, 2) spawn and one (1, 2) spawn (which restores the (2, 2)
checkpoints, grok's and whisper's, and runs the launcher on deepseek,
whisper and llama-vision) carry every case; about 65 s in one process,
both spawns' start-up and the JAX side included.
"""

import dataclasses

import numpy as np
import pytest
import torch

import _torch_mesh_workers as W
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as launcher
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
# JAX against the port: f32 both, XLA's sums against ATen's
JAX_RTOL, JAX_ATOL = 1e-4, 1e-5
MESHES = {"1x2": (1, 2), "2x2": (2, 2)}
CASES = list(W.TP_CASES)


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("tp_ckpt"))


@pytest.fixture(scope="module")
def mm_ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("tp_mm_ckpt"))


@pytest.fixture(scope="module")
def state_ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("tp_state_ckpt"))


@pytest.fixture(scope="module")
def tp22(ckpt_dir, mm_ckpt_dir, state_ckpt_dir):
    return spawn(W.tp_ranks, (2, 2), device="cpu",
                 kwargs=dict(ckpt_dir=ckpt_dir, mm_ckpt_dir=mm_ckpt_dir,
                             state_ckpt_dir=state_ckpt_dir),
                 timeout_s=SPAWN_TIMEOUT_S)


@pytest.fixture(scope="module")
def bridged():
    """The JAX package's reduced deepseek-moe-16b params, as numpy."""
    jcfg = ARCHS["deepseek-moe-16b"].reduced()
    init = jax.jit(jlm.init_lm, static_argnums=1)
    return jcfg, jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), jcfg))


def _gated(tree, gate):
    """The numpy tree with every ``cross_gate`` leaf set to ``gate``."""
    if isinstance(tree, dict):
        return {k: (np.full_like(v, gate) if k == "cross_gate"
                    else _gated(v, gate)) for k, v in tree.items()}
    return tree


@pytest.fixture(scope="module")
def bridged_mm():
    """The JAX package's reduced whisper-small and llama-vision (2
    groups) params as numpy, every ``cross_gate`` at ``W.MM_GATE``:
    {case: (jcfg, tree)}."""
    init = jax.jit(jlm.init_lm, static_argnums=1)
    out = {}
    for name in W.TP_MM_CASES:
        arch, over, _ = W.TP_CASES[name]
        jcfg = dataclasses.replace(ARCHS[arch].reduced(), **over)
        out[name] = (jcfg, _gated(jax.tree.map(
            np.asarray, init(jax.random.PRNGKey(0), jcfg)), W.MM_GATE))
    return out


@pytest.fixture(scope="module")
def bridged_state():
    """The JAX package's reduced rwkv6-3b and hymba-1.5b params as numpy:
    {case: (jcfg, tree)}."""
    init = jax.jit(jlm.init_lm, static_argnums=1)
    out = {}
    for name in W.TP_STATE_CASES:
        arch, over, _ = W.TP_CASES[name]
        jcfg = dataclasses.replace(ARCHS[arch].reduced(), **over)
        out[name] = (jcfg, jax.tree.map(np.asarray,
                                        init(jax.random.PRNGKey(0), jcfg)))
    return out


MM_ARCHS = ("whisper-small", "llama-3.2-vision-11b")
STATE_ARCHS = ("rwkv6-3b", "hymba-1.5b")


@pytest.fixture(scope="module")
def tp12(tp22, ckpt_dir, mm_ckpt_dir, state_ckpt_dir, bridged, bridged_mm,
         bridged_state, tmp_path_factory):
    return spawn(W.tp_ranks, (1, 2), device="cpu", kwargs=dict(
        bridged=bridged[1], restore_from=ckpt_dir,
        launcher_dir=str(tmp_path_factory.mktemp("tp_launcher")),
        bridged_mm={k: v[1] for k, v in {**bridged_mm,
                                         **bridged_state}.items()},
        mm_restore_from=mm_ckpt_dir, state_restore_from=state_ckpt_dir,
        mm_launcher_dirs={a: str(tmp_path_factory.mktemp("tp_mm_launcher"))
                          for a in MM_ARCHS + STATE_ARCHS}),
        timeout_s=SPAWN_TIMEOUT_S)


@pytest.fixture(scope="module")
def one():
    """Every case's one-process step."""
    return {name: W.tp_step(name) for name in CASES}


def _ranks(request, mesh: str) -> list:
    return request.getfixturevalue({"1x2": "tp12", "2x2": "tp22"}[mesh])


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
    axes = ("data", "model")
    return tmesh.Mesh(shape=dict(zip(axes, shape)), rank=rank,
                      coords=dict(zip(axes, tmesh._coords(rank, shape))))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mesh", MESHES)
def test_gradients_loss_and_aux_match_one_process(request, one, mesh, case):
    ranks = _ranks(request, mesh)
    want = one[case]
    for r in ranks:
        got = r[case]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=RTOL)
        np.testing.assert_allclose(got["aux"], want["aux"], rtol=RTOL,
                                   atol=1e-9)
        _close(got["grads"], want["grads"])
        # every rank gathers the same bits
        assert _equal(got["grads"], ranks[0][case]["grads"])
    if W.tp_config(case).moe is not None:
        assert want["aux"] > 0
    for k in ("loss", "aux_loss", "grad_norm"):
        np.testing.assert_allclose(ranks[0][case]["metrics"][k],
                                   want["metrics"][k], rtol=RTOL,
                                   atol=1e-9, err_msg=k)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mesh", MESHES)
def test_the_step_updates_as_one_process_would_on_its_gradients(
        request, mesh, case):
    """The mesh step's params and optimizer state (gathered) against the
    one-process clip and update of the mesh's gathered gradients: the
    clip's norm and Adafactor's means across shards, and the FSDP blocks
    each rank updates."""
    r = _ranks(request, mesh)[0][case]
    want = W.tp_update(case, r["grads"])
    _close(r["params"], want["params"])
    _close(r["opt"], want["opt"])
    np.testing.assert_allclose(r["metrics"]["grad_norm"], want["norm"],
                               rtol=RTOL)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mesh", MESHES)
def test_the_update_across_shards_matches_one_process(request, mesh, case):
    """The mesh's clip and update of the one-process gradients (each rank
    on its blocks of them) against the one-process update."""
    r = _ranks(request, mesh)[0][case]
    want = W.tp_update(case, r["one_grads"])
    got = r["same_grads"]
    _close(got["params"], want["params"])
    _close(got["opt"], want["opt"])
    np.testing.assert_allclose(got["norm"], want["norm"], rtol=RTOL)
    if case == "grok":      # the cut leaves factor: vr / vc across shards
        assert any("vr" in path_str(p)
                   for p, _ in flatten_with_paths(got["opt"]))


@pytest.mark.parametrize("mesh", MESHES)
def test_each_rank_stores_only_its_train_spec_blocks(request, one, mesh):
    """Each rank's params, gradients and optimizer state are its blocks
    under ``train_spec`` (and the Adafactor statistics' specs): every
    cut dim divided by its axis's size, and some leaf is cut on each
    axis of the mesh."""
    shape = MESHES[mesh]
    for rank, r in enumerate(_ranks(request, mesh)):
        m = _rank_mesh(shape, rank)
        for case in CASES:
            cfg = W.tp_config(case)
            for key in ("grads", "params", "opt"):
                full = one[case][key]
                specs = shd.train_specs_of(full, m, cfg)
                want = [tuple(n // (m.size(a) if a else 1)
                              for n, a in zip(t.shape, s))
                        for t, s in zip(leaves(full), specs)]
                assert r[case]["shapes"][key] == want, (case, key)
                cut = {a for s in specs for a in s if a}
                assert cut == {a for a, n in m.shape.items() if n > 1}


@pytest.mark.parametrize("mesh", MESHES)
def test_leaves_held_whole_are_bit_equal_across_ranks(request, mesh):
    """A block that two ranks both hold (the leaf is not cut along the
    axis on which they differ) is the same bits on both, for the
    gradients, the updated params and the optimizer state."""
    shape = MESHES[mesh]
    ranks = _ranks(request, mesh)
    checked = 0
    for case in CASES:
        cfg = W.tp_config(case)
        for key in ("grads", "params", "opt"):
            blocks = [r[case]["blocks"][key] for r in ranks]
            specs = shd.train_specs_of(blocks[0], _rank_mesh(shape, 0), cfg)
            for i in range(len(ranks)):
                for j in range(i + 1, len(ranks)):
                    ci, cj = ranks[i]["coords"], ranks[j]["coords"]
                    differ = {a for a in ci if ci[a] != cj[a]}
                    for a, b, s in zip(leaves(blocks[i]), leaves(blocks[j]),
                                       specs):
                        if not differ & set(s):
                            assert torch.equal(a, b), (case, key, s)
                            checked += 1
    assert checked > 0


def test_gradients_match_jax_value_and_grad(tp12, bridged):
    """The mesh's gathered gradients, loss and aux of the JAX package's
    deepseek-moe-16b params against ``jax.value_and_grad`` of the
    reference's ``loss_fn`` on the same batch."""
    jcfg, jp = bridged
    cfg = W.tp_config("deepseek")
    batch = W.tp_batch(cfg)
    jt = jts.TrainConfig(opt=jopt.OptConfig(name=jcfg.optimizer))
    (_, (jl, ja)), jg = jax.jit(
        jax.value_and_grad(jts.loss_fn, has_aux=True),
        static_argnums=(1, 3))(jax.tree.map(jnp.asarray, jp), jcfg,
                               {k: jnp.asarray(v) for k, v in batch.items()},
                               jt)
    r = tp12[0]["bridged"]
    np.testing.assert_allclose(r["loss"], float(jl), rtol=1e-6)
    np.testing.assert_allclose(r["aux"], float(ja), rtol=1e-5, atol=1e-8)
    ref = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jg))[0]
    got = jax.tree_util.tree_flatten_with_path(
        params_to_numpy(r["grads"], cfg))[0]
    assert [p for p, _ in ref] == [p for p, _ in got]
    for (path, a), (_, b) in zip(ref, got):
        np.testing.assert_allclose(b, a, rtol=JAX_RTOL, atol=JAX_ATOL,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("case", W.TP_MM_CASES)
def test_multimodal_gradients_match_jax_value_and_grad(tp12, bridged_mm,
                                                       case):
    """The (1, 2) mesh's gathered gradients and loss of the JAX package's
    gated whisper-small (its encoder's gradients through every cross
    layer's) and llama-vision params against ``jax.value_and_grad`` of the
    reference's ``loss_fn`` on the same batch (frames or patches
    included)."""
    jcfg, jp = bridged_mm[case]
    cfg = W.tp_config(case)
    batch = W.tp_batch(cfg)
    assert ("frames" in batch) == (cfg.encoder is not None)
    jt = jts.TrainConfig(opt=jopt.OptConfig(name=jcfg.optimizer))
    (_, (jl, _)), jg = jax.jit(
        jax.value_and_grad(jts.loss_fn, has_aux=True),
        static_argnums=(1, 3))(jax.tree.map(jnp.asarray, jp), jcfg,
                               {k: jnp.asarray(v) for k, v in batch.items()},
                               jt)
    for r in tp12:
        got_r = r[f"bridged_{case}"]
        np.testing.assert_allclose(got_r["loss"], float(jl), rtol=1e-6)
        ref = jax.tree_util.tree_flatten_with_path(
            jax.tree.map(np.asarray, jg))[0]
        got = jax.tree_util.tree_flatten_with_path(
            params_to_numpy(got_r["grads"], cfg))[0]
        assert [p for p, _ in ref] == [p for p, _ in got]
        for (path, a), (_, b) in zip(ref, got):
            np.testing.assert_allclose(b, a, rtol=JAX_RTOL, atol=JAX_ATOL,
                                       err_msg=jax.tree_util.keystr(path))
        # llama-vision's gate and whisper's encoder get their gradients
        # (whisper's cross layers are ungated: its gates get none)
        names = [jax.tree_util.keystr(p) for p, _ in got]
        moved = {n for n, (_, b) in zip(names, got) if np.any(b != 0)}
        assert any("cross_gate" in n for n in moved) == bool(
            cfg.cross_attn_every)
        if cfg.encoder is not None:
            assert any("encoder" in n and "wq" in n for n in moved)


@pytest.mark.parametrize("case", W.TP_STATE_CASES)
def test_recurrent_gradients_match_jax_value_and_grad(tp12, bridged_state,
                                                      case):
    """The (1, 2) mesh's gathered gradients and loss of the JAX package's
    rwkv6-3b and hymba-1.5b params (each time-mix on a rank's heads, each
    Mamba mixer on its channels) against ``jax.value_and_grad`` of the
    reference's ``loss_fn`` on the same batch, every leaf in the
    reference's layout (``w_in`` as ``[x1 | z]``)."""
    jcfg, jp = bridged_state[case]
    cfg = W.tp_config(case)
    batch = W.tp_batch(cfg)
    jt = jts.TrainConfig(opt=jopt.OptConfig(name=jcfg.optimizer))
    (_, (jl, _)), jg = jax.jit(
        jax.value_and_grad(jts.loss_fn, has_aux=True),
        static_argnums=(1, 3))(jax.tree.map(jnp.asarray, jp), jcfg,
                               {k: jnp.asarray(v) for k, v in batch.items()},
                               jt)
    ref = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jg))[0]
    for r in tp12:
        got_r = r[f"bridged_{case}"]
        np.testing.assert_allclose(got_r["loss"], float(jl), rtol=1e-6)
        got = jax.tree_util.tree_flatten_with_path(
            params_to_numpy(got_r["grads"], cfg))[0]
        assert [p for p, _ in ref] == [p for p, _ in got]
        for (path, a), (_, b) in zip(ref, got):
            np.testing.assert_allclose(b, a, rtol=JAX_RTOL, atol=JAX_ATOL,
                                       err_msg=jax.tree_util.keystr(path))
        names = {jax.tree_util.keystr(p) for p, _ in got}
        assert any("w_in" in n for n in names) == (case == "hymba")


@pytest.mark.parametrize("case", ["olmo", "deepseek"])
def test_remat_on_is_bit_equal_to_remat_off(tp12, case):
    """Remat re-runs each layer's forward collectives in the backward;
    every rank issues them in the same order, and the gradients, loss and
    aux are the same bits either way."""
    assert W.tp_config(case).remat
    for r in tp12:
        on, off = r[case], r[f"{case}_remat_off"]
        assert on["loss"] == off["loss"] and on["aux"] == off["aux"]
        assert _equal(on["grads"], off["grads"])
        assert _equal(on["blocks"]["grads"], off["blocks"]["grads"])


def test_remat_recomputes_under_the_mesh_on_another_thread(tp12):
    """The backward of a loss formed under the mesh, taken on a thread
    where the mesh is not active (on the card the autograd engine's
    device thread runs it, and remat's recompute with it): the layers'
    recompute finds its mesh, and the gradients are the step's, bit for
    bit."""
    for r in tp12:
        got = r["thread_backward"]
        assert "error" not in got, got.get("error")
        assert _equal(got["grads"], r["olmo"]["blocks"]["grads"])


def test_accumulation_matches_one_process(tp12):
    want = W.tp_step("olmo", accum=2, full_step=False)
    got = tp12[0]["accum"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=RTOL)
    _close(got["grads"], want["grads"])


def test_bf16_compression_rounds_each_ranks_gradients(tp12):
    """With ``grad_compress="bf16"`` each rank's gradient blocks are
    rounded to bf16 before the mean (here over a 'data' axis of 1: the
    uncompressed gradients rounded, bit for bit), within one bf16 ulp of
    the one-process compressed step's beyond the file's f32 tolerance
    (the f32 gradients differ within it, and an element whose two f32
    values straddle a bf16 rounding edge rounds the other way; one ulp is
    at most 2^-7 of the value)."""
    got = tp12[0]["bf16"]["grads"]
    plain = tp12[0]["olmo"]["grads"]
    for a, b in zip(leaves(plain), leaves(got)):
        assert torch.equal(b, a.to(torch.bfloat16).float())
    want = W.tp_step("olmo", compress="bf16", full_step=False)["grads"]
    for a, b in zip(leaves(want), leaves(got)):
        torch.testing.assert_close(b, a, rtol=RTOL + 2.0 ** -7, atol=ATOL)


def test_enter_reduce_gather_follow_their_plain_rules(tp12):
    """enter: identity forward, the gradient summed over the ranks;
    reduce: the f32 sum forward, the gradient passed on unchanged (not
    multiplied by the ranks); gather: the blocks in rank order forward,
    this rank's block of the gradient backward."""
    for r in (rank["functions"] for rank in tp12):
        x, w, c, z, c2 = r["inputs"]
        i = r["rank"]
        torch.testing.assert_close(r["out"], x * w[0] + x * w[1],
                                   rtol=0, atol=1e-6)
        assert torch.equal(r["y_grad"], c)
        torch.testing.assert_close(r["x_grad"], c * w[0] + c * w[1],
                                   rtol=0, atol=1e-6)
        assert torch.equal(r["gathered"], torch.cat([z[0], z[1]], dim=-1))
        assert torch.equal(r["z_grad"], c2[:, 4 * i:4 * i + 4])


def test_shared_experts_beside_cut_experts_are_not_counted_twice(tp12):
    """An MoE layer whose experts are cut over 'model' and whose shared
    experts every rank computes whole: its output, and the gradients of
    its input, the router, the shared experts and the rank's experts,
    against the whole layer's.  An ``enter`` on the shared branch would
    double its share of the input's gradient."""
    for r in (rank["functions"] for rank in tp12):
        got, want = r["moe"], r["moe_whole"]
        i = r["rank"]
        _close(got["y"], want["y"])
        _close(got["h"], want["h"])
        _close(got["router"], want["router"])
        _close(got["shared"], want["shared"])
        _close(got["experts"], {k: v.chunk(2)[i]
                                for k, v in want["experts"].items()})


def test_a_2x2_checkpoint_restores_onto_1x2_and_one_process(
        tp22, tp12, ckpt_dir):
    """Grok's stepped params and Adafactor state, saved from the (2, 2)
    mesh (full leaves, rank 0 alone writing), restored onto a (1, 2) mesh
    (each rank cutting its blocks, of its own shapes) and onto one
    process: the full leaves bit-equal to the saved ones."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.models import lm
    from repro_torch.train.optimizer import make_optimizer

    case = W.TP_CKPT_CASE
    saved = {"params": tp22[0][case]["params"], "opt": tp22[0][case]["opt"]}
    for r in tp12:
        assert _equal(r["restored"], saved)
        assert r["restored_shapes"] != [tuple(t.shape)
                                        for t in leaves(saved)]
    cfg = W.tp_config(case)
    init, _ = make_optimizer(W.tp_train_config(case, cfg).opt, cfg)
    params = lm.init_lm(cfg, seed=1, device="cpu")
    restored, _ = CheckpointManager(ckpt_dir).restore(
        {"params": params, "opt": init(params)})
    assert _equal(restored, saved)
    assert [path_str(p) for p, _ in flatten_with_paths(restored)] == \
        [path_str(p) for p, _ in flatten_with_paths(saved)]


def test_a_multimodal_2x2_checkpoint_restores_onto_1x2_and_one_process(
        tp22, tp12, mm_ckpt_dir):
    """whisper-small's stepped params and AdamW state (its encoder's
    blocks among them), saved from the (2, 2) mesh, restored onto (1, 2)
    (each rank's own blocks) and onto one process: the full leaves
    bit-equal to the saved ones, in the reference's layout."""
    from repro.checkpoint.manager import CheckpointManager as JaxManager
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.models import lm
    from repro_torch.train.optimizer import make_optimizer

    case = W.TP_MM_CKPT_CASE
    saved = {"params": tp22[0][case]["params"], "opt": tp22[0][case]["opt"]}
    assert any(p[1] == "encoder" for p, _ in flatten_with_paths(saved))
    for r in tp12:
        assert _equal(r["mm_restored"]["full"], saved)
        assert r["mm_restored"]["shapes"] != [tuple(t.shape)
                                              for t in leaves(saved)]
    cfg = W.tp_config(case)
    init, _ = make_optimizer(W.tp_train_config(case, cfg).opt, cfg)
    params = lm.init_lm(cfg, seed=1, device="cpu")
    restored, _ = CheckpointManager(mm_ckpt_dir).restore(
        {"params": params, "opt": init(params)})
    assert _equal(restored, saved)
    as_numpy = jax.tree.map(lambda t: t.numpy(), saved)
    jrestored, _ = JaxManager(mm_ckpt_dir).restore(as_numpy)
    assert all(np.array_equal(x, np.asarray(y)) for x, y in zip(
        jax.tree.leaves(as_numpy), jax.tree.leaves(jrestored)))


def test_a_recurrent_2x2_checkpoint_restores_w_in_in_the_references_layout(
        tp22, tp12, state_ckpt_dir):
    """hymba-1.5b's stepped params and Adafactor state, saved from the (2,
    2) mesh: each rank's stored ``w_in`` block is its 'data' rows of
    ``[x1_r | z_r]`` (its own channels of both halves) of the saved
    ``[x1 | z]``, and so is the column statistic ``vc``; restored onto
    (1, 2) (other blocks) and onto one process, and read by the JAX
    manager, the full leaves bit-equal to the saved ones."""
    from repro.checkpoint.manager import CheckpointManager as JaxManager
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.models import lm
    from repro_torch.train.optimizer import make_optimizer

    case = W.TP_STATE_CKPT_CASE
    saved = {"params": tp22[0][case]["params"], "opt": tp22[0][case]["opt"]}
    paired = 0
    for r in tp22:
        dr, mr = r["coords"]["data"], r["coords"]["model"]
        blocks = {"params": r[case]["blocks"]["params"],
                  "opt": r[case]["blocks"]["opt"]}
        mine = dict((path_str(p), t) for p, t in flatten_with_paths(blocks))
        for path, full in flatten_with_paths(saved):
            key = path_str(path)
            if "w_in" not in key or key.endswith("vr"):
                continue
            x1, z = full.chunk(2, dim=-1)
            want = torch.cat([x1.chunk(2, dim=-1)[mr],
                              z.chunk(2, dim=-1)[mr]], dim=-1)
            if want.ndim == 2:      # 'data' on d
                want = want.chunk(2, dim=0)[dr]
            assert torch.equal(mine[key], want), key
            paired += 1
    # every rank: w_in and its vc, a layer
    assert paired == len(tp22) * 2 * W.tp_config(case).n_layers
    for r in tp12:
        assert _equal(r["state_restored"]["full"], saved)
        assert r["state_restored"]["shapes"] != [tuple(t.shape)
                                                 for t in leaves(saved)]
    cfg = W.tp_config(case)
    init, _ = make_optimizer(W.tp_train_config(case, cfg).opt, cfg)
    params = lm.init_lm(cfg, seed=1, device="cpu")
    restored, _ = CheckpointManager(state_ckpt_dir).restore(
        {"params": params, "opt": init(params)})
    assert _equal(restored, saved)
    as_numpy = jax.tree.map(lambda t: t.numpy(), saved)
    jrestored, _ = JaxManager(state_ckpt_dir).restore(as_numpy)
    assert all(np.array_equal(x, np.asarray(y)) for x, y in zip(
        jax.tree.leaves(as_numpy), jax.tree.leaves(jrestored)))


def test_the_reference_restores_a_checkpoint_written_from_a_mesh(
        tp22, ckpt_dir):
    """The (2, 2) mesh's checkpoint is in the reference's layout: the JAX
    package's ``CheckpointManager`` restores it, bit for bit."""
    from repro.checkpoint.manager import CheckpointManager as JaxManager

    case = W.TP_CKPT_CASE
    saved = {"params": tp22[0][case]["params"], "opt": tp22[0][case]["opt"]}
    as_numpy = jax.tree.map(lambda t: t.numpy(), saved)
    restored, _ = JaxManager(ckpt_dir).restore(as_numpy)
    a = jax.tree_util.tree_flatten_with_path(as_numpy)[0]
    b = jax.tree_util.tree_flatten_with_path(restored)[0]
    assert [p for p, _ in a] == [p for p, _ in b]
    assert all(np.array_equal(x, np.asarray(y)) for (_, x), (_, y) in zip(a, b))


def test_launcher_on_a_model_parallel_mesh_recovers(tp12, tmp_path):
    """``launch/train.py --mesh 1x2`` through a fault at step 3: both
    ranks restore step 2 onto their blocks and replay; their gathered
    params and state are the same bits, rank 0 alone wrote (keep 2: steps
    4 and 6), and the losses track the one-process run's."""
    l0, l1 = tp12[0]["launcher"], tp12[1]["launcher"]
    for r in (l0, l1):
        assert r["stats"].restarts == 1 and r["stats"].restored_steps == [2]
    assert _equal(l0["params"], l1["params"])
    assert _equal(l0["opt"], l1["opt"])
    assert l0["losses"] == l1["losses"]
    assert tp12[0]["ckpt_steps"] == ["step_0000000004", "step_0000000006"]
    one = launcher.main(W.train_launcher_argv(str(tmp_path)))
    np.testing.assert_allclose(l0["losses"][-1], one["losses"][-1],
                               rtol=1e-4)


@pytest.mark.parametrize("arch", MM_ARCHS)
def test_launcher_trains_a_multimodal_model_on_a_mesh_and_recovers(
        tp12, tmp_path, arch):
    """``launch/train.py --arch whisper-small`` / ``llama-3.2-vision-11b
    --mesh 1x2`` (frames or patches from the synthetic data) through a
    fault at step 3: both ranks restore step 2 and replay to the same
    bits, and the losses track the one-process run's."""
    l0, l1 = tp12[0][f"launcher {arch}"], tp12[1][f"launcher {arch}"]
    for r in (l0, l1):
        assert r["stats"].restarts == 1 and r["stats"].restored_steps == [2]
    assert _equal(l0["params"], l1["params"])
    assert _equal(l0["opt"], l1["opt"])
    assert l0["losses"] == l1["losses"]
    one = launcher.main(W.train_launcher_argv(str(tmp_path), arch))
    np.testing.assert_allclose(l0["losses"][-1], one["losses"][-1],
                               rtol=1e-4)


@pytest.mark.parametrize("arch", STATE_ARCHS)
def test_launcher_trains_a_recurrent_model_on_a_mesh_and_recovers(
        tp12, tmp_path, arch):
    """``launch/train.py --arch rwkv6-3b`` / ``hymba-1.5b --mesh 1x2``
    through a fault at step 3: both ranks restore step 2 onto their
    blocks (hymba's ``w_in`` cut as ``[x1_r | z_r]`` from the full
    ``[x1 | z]`` leaf) and replay to the same bits, and the losses track
    the one-process run's."""
    l0, l1 = tp12[0][f"launcher {arch}"], tp12[1][f"launcher {arch}"]
    for r in (l0, l1):
        assert r["stats"].restarts == 1 and r["stats"].restored_steps == [2]
    assert _equal(l0["params"], l1["params"])
    assert _equal(l0["opt"], l1["opt"])
    assert l0["losses"] == l1["losses"]
    one = launcher.main(W.train_launcher_argv(str(tmp_path), arch))
    np.testing.assert_allclose(l0["losses"][-1], one["losses"][-1],
                               rtol=1e-4)


def test_the_placement_against_the_references_plan_params():
    """olmo-1b at full width on a (2, 2) mesh, leaf by leaf: the port's
    ``train_spec`` of each layer's leaf beside the reference's
    ``plan_params`` of its stacked ``[L, ...]`` leaf.  The port puts
    'model' on the dim the layer computes its rank block over (heads,
    FFN columns, the down projection's rows, the vocab) and 'data' on the
    first other dim the data size divides.  The reference plans the
    stacked leaf as though it were unstacked: 'model' lands on ``d`` for
    ``wq`` and on the layer dim for ``w_gate``, ``w_down`` and ``wo``
    (the deliberate difference)."""
    cfg = ARCHS["olmo-1b"]
    tcfg = W.get_config("olmo-1b")
    mesh = _rank_mesh((2, 2), 0)
    ref_tree = jax.eval_shape(lambda: jlm.init_lm(jax.random.PRNGKey(0),
                                                  cfg))
    ref = {jshd._path_str(p): (tuple(leaf.shape), s) for (p, leaf), s in zip(
        jax.tree_util.tree_flatten_with_path(ref_tree)[0],
        jax.tree.leaves(jshd.plan_params(ref_tree, mesh, cfg),
                        is_leaf=lambda x: isinstance(
                            x, jax.sharding.PartitionSpec)))}
    full, specs = shd.model_specs(tcfg, mesh)
    table = []
    for (path, t), spec in zip(flatten_with_paths(full), specs):
        key = "/".join(str(p) for p in path if not isinstance(p, int))
        if path[0] == "layers" and path[1] != 0:
            continue
        rshape, rspec = ref[key]
        table.append((key, tuple(t.shape), tuple(spec), rshape,
                      tuple(rspec)))
        name = path[-1]
        if name in shd.SERVE_LEAVES:
            assert spec[shd._model_prefs(name, t.shape)[0]] == "model", key
        free = [d for d, a in enumerate(spec) if a != "model"]
        assert spec.index("data") == next(
            d for d in free if t.shape[d] % 2 == 0), key
    # in the reference's stacked coordinates: a layer's leaf gains dim 0
    rows = {k: ((None,) + ps if k.startswith("layers/") else ps, rs)
            for k, _, ps, _, rs in table}
    msg = "\n".join(f"{k:20s} port {s} {ps}   reference {rs} {rp}"
                     for k, s, ps, rs, rp in table)
    assert rows["embed"][0] == rows["embed"][1] == ("model", "data"), msg
    for k, (port, ref_spec) in rows.items():
        if not k.startswith("layers/"):
            continue
        # the reference: on d (wq, wk, wv) or on the layer dim
        want = 1 if k.split("/")[-1] in ("wq", "wk", "wv") else 0
        assert ref_spec.index("model") == want, (k, msg)
        assert port != ref_spec, (k, msg)
