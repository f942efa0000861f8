"""The port's mesh planner, anchors, collectives' arithmetic and sharded
selection keys, held against the JAX package's functions on the CPU with
no processes (a duck-typed mesh: shape mapping and axis names, as
``test_distributed.py`` uses).

Every spec of ``_leaf_spec`` / ``plan_params`` / ``plan_report`` over
every leaf of every registered family (reduced and full shapes, from
``jax.eval_shape``; the decode prepack's fused leaves too), the cache,
serving-cache, segment and batch specs, ``_resolve`` and
``constrain_first``'s choices, ``ShardedPlan``, and the reference's
per-shard GEMV and program keys (``_priced_placement`` with the seed
collective term and a fitted one) on the ``cpu`` backends, on meshes
(1, 2), (1, 4), (2, 2), (16, 16) and (2, 16, 16).  Then the launcher's
refusals, ``quantize_int8`` bit for bit, the placement of a rank's
blocks, and the two deliberate differences, pinned.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import ARCHS  # noqa: E402
from repro.distributed import axes as jaxes  # noqa: E402
from repro.distributed import collectives as jcoll  # noqa: E402
from repro.distributed import sharding as jshd  # noqa: E402
from repro.kernels import dispatch as jdispatch  # noqa: E402
from repro.kernels.backends import base as jbase  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.distributed import axes  # noqa: E402
from repro_torch.distributed import collectives as coll  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.backends import DispatchPolicy, GemvKey, \
    ProgramKey  # noqa: E402
from repro_torch.kernels.backends import get_backend  # noqa: E402
from repro_torch.kernels.backends.base import ShardedPlan  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving.kv_cache import SlotKVCache  # noqa: E402


class FakeMesh:
    """Duck-typed mesh: shape mapping + axis names only."""

    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = {
    "1x2": {"data": 1, "model": 2},
    "1x4": {"data": 1, "model": 4},
    "2x2": {"data": 2, "model": 2},
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
}


def _rank_mesh(shape: dict, rank: int) -> tmesh.Mesh:
    """The port's mesh of one rank, without process groups (the planner
    and the placement read shapes and coordinates only)."""
    coords = dict(zip(shape, tmesh._coords(rank, tuple(shape.values()))))
    return tmesh.Mesh(shape=dict(shape), rank=rank, coords=coords)


def _shape_tree(tree):
    """A ``jax.eval_shape`` tree as nested dicts of its leaves (each has
    ``.shape``), which both packages' planners walk."""
    if isinstance(tree, dict):
        return {k: _shape_tree(v) for k, v in tree.items()}
    return tree


_TREES: dict = {}


def _trees(arch: str, reduced: bool):
    """The reference's param tree of ``arch`` as shapes, and its decode
    prepack (``wqkv`` / ``w_gateup``) for the attention families."""
    key = (arch, reduced)
    if key not in _TREES:
        cfg = ARCHS[arch].reduced() if reduced else ARCHS[arch]
        init = jax.eval_shape(
            lambda: jlm.init_lm(jax.random.PRNGKey(0), cfg))
        packed = jax.eval_shape(
            lambda: jlm.prepack_decode_params(
                jlm.init_lm(jax.random.PRNGKey(0), cfg), cfg))
        _TREES[key] = (cfg, [init, packed])
    return _TREES[key]


def _leaves_with_paths(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_paths(v, path + (k,))
    elif tree is not None:
        yield "/".join(map(str, path)), tuple(tree.shape)


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_and_report_match_the_reference(arch, reduced):
    cfg, trees = _trees(arch, reduced)
    for mshape in MESHES.values():
        mesh = FakeMesh(mshape)
        for tree in trees:
            for path, shape in _leaves_with_paths(tree):
                assert shd._leaf_spec(path, shape, mesh, cfg) == \
                    jshd._leaf_spec(path, shape, mesh, cfg), (path, shape)
            ours = shd.plan_params(_shape_tree(tree), mesh, cfg)
            ref = jshd.plan_params(tree, mesh, cfg)
            got = dict(_spec_leaves(ours))
            want = {jshd._path_str(p): s for p, s in
                    jax.tree_util.tree_flatten_with_path(
                        ref, is_leaf=lambda x: isinstance(
                            x, jax.sharding.PartitionSpec))[0]}
            assert got == want
            assert sorted(shd.plan_report(_shape_tree(tree), mesh)) == \
                sorted(jshd.plan_report(tree, mesh))


def _spec_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _spec_leaves(v, path + (k,))
    elif tree is not None:
        yield "/".join(map(str, path)), tree


CACHE_ARCHS = ("olmo-1b", "deepseek-moe-16b", "grok-1-314b", "gemma3-1b",
               "rwkv6-3b", "hymba-1.5b")


@pytest.mark.parametrize("store", ["fp", "int8"])
@pytest.mark.parametrize("arch", CACHE_ARCHS)
def test_cache_segment_and_batch_specs_match_the_reference(arch, store):
    """``cache_spec`` / ``serve_cache_spec`` / ``segment_spec`` (kv and
    state) over every leaf of the reference's cache at full width (8
    slots, 1024 positions; a segment is a slot's 64 positions), and
    ``batch_spec``, on every mesh."""
    cfg = ARCHS[arch]
    cache = jax.eval_shape(lambda: jlm.init_cache(
        cfg, 8, 1024, per_slot_pos=True, kv_store=store))
    for mshape in MESHES.values():
        mesh = FakeMesh(mshape)
        for name, leaf in cache.items():
            shape = tuple(leaf.shape)
            for b in (1, 8, 32):
                assert shd.cache_spec(mesh, cfg, b, shape, name) == \
                    jshd.cache_spec(mesh, cfg, b, shape, name)
            assert shd.serve_cache_spec(mesh, cfg, shape, name) == \
                jshd.serve_cache_spec(mesh, cfg, shape, name)
            if len(shape) >= 3:
                kind = "kv" if name in ("k", "v", "k_scale",
                                        "v_scale") else "state"
                seg = (shape[0], 64) + shape[3:] if kind == "kv" \
                    else (shape[0],) + shape[2:]
                assert shd.segment_spec(mesh, cfg, seg, name, kind=kind) \
                    == jshd.segment_spec(mesh, cfg, seg, name, kind=kind)
        for b in (1, 2, 3, 16, 64):
            assert shd.batch_spec(mesh, b) == jshd.batch_spec(mesh, b)
        ours = shd.plan_serve_cache(dict(cache), mesh, cfg)
        ref = jshd.plan_serve_cache(cache, mesh, cfg)
        assert ours == {k: v for k, v in ref.items()}


def test_resolve_and_constrain_first_choose_as_the_reference(monkeypatch):
    """``_resolve`` for every name at many sizes, and the candidate
    ``constrain_first`` applies (the reference's, with its ``constrain``
    recording the names it is given)."""
    monkeypatch.setattr(jaxes, "constrain", lambda x, names: names)
    cands = [
        [("batch", "model", None, None), ("batch", None, "model", None)],
        [("batch", None, "model"), ("batch", None, None)],
        [(None, "model"), ("model", None)],
        [("batch", None, None, "model")],
    ]
    for mshape in MESHES.values():
        mesh = FakeMesh(mshape)
        for dim in (1, 2, 3, 4, 6, 8, 16, 24, 32, 48, 256, 4096):
            for name in (None, "batch", "model", "data", "pod", "vocab"):
                assert axes._resolve(dim, name, mesh) == \
                    jaxes._resolve(dim, name, mesh)
        with jaxes.activation_mesh(mesh):
            for shape in [(8, 1, 16, 64), (3, 5, 6, 2), (32, 7, 2048),
                          (2, 48), (16, 16, 16, 16)]:
                for c in cands:
                    x = np.zeros(shape)
                    assert axes.first_candidate(shape, c, mesh) == \
                        jaxes.constrain_first(x, c)
    x = torch.ones(2)
    assert axes.constrain(x, ("batch",)) is x
    assert axes.constrain_first(x, [("batch",)]) is x


def test_sharded_plan_matches_the_reference():
    for n in (1, 2, 3, 4, 8, 16):
        for M in (1, 6, 8, 12, 25, 48, 2048, 6144):
            for K in (1, 4, 7, 64, 8192):
                a, b = ShardedPlan.place(M, K, n), jbase.ShardedPlan.place(
                    M, K, n)
                assert (a.axis, a.n_shards) == (b.axis, b.n_shards)
                assert a.shard_shape(M, K) == b.shard_shape(M, K)
                for E in (1, 8, 64):
                    a = ShardedPlan.place_experts(E, M, K, n)
                    b = jbase.ShardedPlan.place_experts(E, M, K, n)
                    assert (a.axis, a.n_shards) == (b.axis, b.n_shards)
                    assert a.shard_shape(M, K) == b.shard_shape(M, K)


# olmo-1b's decode GEMVs (M, K) at batch 1 / 8, deepseek's and grok's head,
# and odd shapes that fall back to K or replicate
GEMV_SHAPES = [(6144, 2048), (16384, 2048), (2048, 8192), (50304, 2048),
               (102400, 2048), (131072, 6144), (25, 4096), (4096, 25),
               (7, 9)]


@pytest.fixture(params=["seed", "fitted"])
def backends(request):
    """The ``cpu`` backend of each package, on its seed constants or on a
    fitted collective term (the priced M-vs-K placement)."""
    ours, ref = get_backend("cpu"), jbase.get_backend("cpu")
    if request.param == "fitted":
        kw = dict(collective_gbps=50.0, collective_launch_us=8.0)
        ours.apply_calibration(ours.seed_cost_model.with_constants(**kw))
        ref.apply_calibration(ref.cost_model.with_constants(**kw))
    yield ours, ref
    ours.reset_calibration()
    ref.reset_calibration()


def test_shard_gemv_keys_match_the_reference(backends):
    ours, ref = backends
    for n in (2, 4, 16):
        pol = DispatchPolicy(model_shards=n)
        jpol = jdispatch.DispatchPolicy(model_shards=n)
        for M, K in GEMV_SHAPES:
            for B in (1, 8):
                key = GemvKey(M=M, K=K, batch=B, bits=16, block=32,
                              dtype="torch.bfloat16", backend="cpu")
                jkey = jbase.GemvKey(M=M, K=K, batch=B, bits=16, block=32,
                                     dtype="bfloat16", backend="cpu")
                got, sp = dispatch._shard_gemv_key(key, pol, ours)
                want, jsp = jdispatch._shard_gemv_key(jkey, jpol, ref)
                assert got.table_key() == want.table_key()
                assert (sp.axis, sp.n_shards) == (jsp.axis, jsp.n_shards)
                if M % n == 0 and K % n == 0:
                    a = dispatch._priced_placement(ours, key, pol)
                    b = jdispatch._priced_placement(ref, jkey, jpol)
                    assert a.axis == b.axis


PROGRAMS = [("fused", (2048, 2048, 2048), 2048, 1, 3, 0),
            ("fused", (8192, 8192), 2048, 8, 2, 0),
            ("fused", (6144, 1024, 1024), 6144, 4, 3, 0),
            ("fused", (25, 5, 5), 64, 1, 3, 0),
            ("ragged", (1408,), 2048, 2, 64, 48),
            ("ragged", (2048,), 1408, 2, 64, 48),
            ("ragged", (32768,), 6144, 1, 8, 16),
            ("grouped", (1408,), 2048, 8, 64, 0),
            ("grouped", (6144,), 32768, 8, 6, 0)]


def test_shard_program_keys_match_the_reference(backends):
    ours, ref = backends
    for n in (2, 4, 16):
        pol = DispatchPolicy(model_shards=n)
        jpol = jdispatch.DispatchPolicy(model_shards=n)
        for kind, Ms, K, batch, group, tokens in PROGRAMS:
            kw = dict(kind=kind, Ms=Ms, K=K, batch=batch, group=group,
                      bits=16, block=32, backend="cpu")
            extra = dict(tokens=tokens, hist="le2m2") if kind == "ragged" \
                else {}
            key = ProgramKey(dtype="torch.bfloat16", **kw, **extra)
            jkey = jbase.ProgramKey(dtype="bfloat16", **kw, **extra)
            got, ax = dispatch._shard_program_key(key, pol, ours)
            want, jax_ax = jdispatch._shard_program_key(jkey, jpol, ref)
            assert (got.table_key(), ax) == (want.table_key(), jax_ax)


def test_parse_mesh_arg_and_its_messages():
    for arg in ("1x4", "2X2", "16x16"):
        assert tmesh.parse_mesh_arg(arg) == jmesh.parse_mesh_arg(arg)
    for bad in ("4", "1x", "ax2", "1x2x3", ""):
        with pytest.raises(SystemExit) as ours:
            tmesh.parse_mesh_arg(bad)
        with pytest.raises(SystemExit) as ref:
            jmesh.parse_mesh_arg(bad)
        assert str(ours.value) == str(ref.value)


def test_make_mesh_refuses_a_world_of_another_size():
    """One process (no group): a (1, 2) mesh, the production meshes and a
    rank/axes mismatch are refused; (1, 1) is this process."""
    with pytest.raises(ValueError, match="needs 2 processes, have 1"):
        tmesh.make_mesh((1, 2), ("data", "model"), device="cpu")
    for multi in (False, True):
        with pytest.raises(ValueError, match="processes, have 1"):
            tmesh.make_production_mesh(multi_pod=multi, device="cpu")
    with pytest.raises(ValueError, match="does not match axes"):
        tmesh.make_mesh((1, 2), ("model",), device="cpu")
    m = tmesh.single_device_mesh(device="cpu")
    assert (m.shape, m.rank, m.coords, m.world_size) == (
        {"data": 1, "model": 1}, 0, {"data": 0, "model": 0}, 1)
    assert tmesh.data_axes(m) == jmesh.data_axes(FakeMesh(m.shape))
    for mshape in MESHES.values():
        fm = FakeMesh(mshape)
        assert tmesh.data_axes(fm) == jmesh.data_axes(fm)
        assert tmesh.model_axis_size(fm) == jmesh.model_axis_size(fm)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        tmesh.spawn(print, (1, 2))


def test_make_mesh_runs_on_a_card_unless_asked_for_the_cpu(monkeypatch):
    """With no device, ``make_mesh`` and ``single_device_mesh`` raise on a
    host without CUDA (no silent CPU); under ``torchrun`` the rank's card
    (``cuda:{rank % count}``) is resolved before the backend, so a card a
    rank gives NCCL."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: tmesh.make_mesh((1, 1), ("data", "model")),
                 tmesh.single_device_mesh,
                 lambda: tmesh.spawn(print, (1, 2))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert tmesh.single_device_mesh(device="cpu").device == \
        torch.device("cpu")

    joined = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device", joined.append)
    monkeypatch.setattr(tmesh.dist, "init_process_group",
                        lambda backend, **kw: joined.append(backend))
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("WORLD_SIZE", "2")
    # the stub joins no group: the world stays one process
    with pytest.raises(ValueError, match="needs 2 processes, have 1"):
        tmesh.make_mesh((1, 2), ("data", "model"))
    assert joined == [torch.device("cuda", 1), "nccl"]
    joined.clear()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError):
        tmesh.make_mesh((1, 2), ("data", "model"))
    assert joined == [torch.device("cuda", 0), "gloo"]


def test_mesh_coordinates_are_rank_major():
    shape = (2, 3, 4)
    seen = set()
    for r in range(24):
        c = tmesh._coords(r, shape)
        assert tmesh._rank_of(c, shape) == r
        seen.add(c)
    assert len(seen) == 24 and tmesh._coords(5, shape) == (0, 1, 1)


def test_quantize_int8_is_bit_equal_to_the_reference():
    rng = np.random.default_rng(0)
    for shape, scale in (((64,), 1.0), ((17, 33), 1e-3), ((8, 8, 8), 50.0),
                         ((5,), 0.0)):
        x = (rng.standard_normal(shape) * scale).astype(np.float32)
        q, s = coll.quantize_int8(torch.from_numpy(x))
        jq, js = jcoll.quantize_int8(jnp.asarray(x))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert s.numpy().tobytes() == np.asarray(js).tobytes()
        np.testing.assert_array_equal(
            coll.dequantize_int8(q, s).numpy(),
            np.asarray(jcoll.dequantize_int8(jq, js)))


@pytest.mark.parametrize("arch", ["olmo-1b", "deepseek-moe-16b",
                                  "grok-1-314b"])
def test_init_lm_on_a_mesh_draws_the_unsharded_values(arch):
    """``init_lm(mesh=)`` keeps each rank's blocks of the unsharded draws
    (what ``shard_params`` cuts from the whole tree), and the ranks'
    blocks put back together are the whole tensors."""
    cfg = get_config(arch).reduced()
    full = lm.init_lm(cfg, seed=3, device="cpu")
    shape = {"data": 1, "model": 2}
    ranks = []
    for r in range(2):
        mesh = _rank_mesh(shape, r)
        mine = lm.init_lm(cfg, seed=3, device="cpu", mesh=mesh)
        cut = shd.shard_params(full, mesh, cfg)
        assert mine[shd.SHARD_KEY] == cut[shd.SHARD_KEY] == (r, 2)
        assert shd.shard_params(mine, mesh, cfg) is mine
        for (p, a), (q, b) in zip(_tensors(mine), _tensors(cut)):
            assert p == q and torch.equal(a, b), p
        ranks.append(mine)
    whole = dict(_tensors(full))
    for path, a in _tensors(ranks[0]):
        b = dict(_tensors(ranks[1]))[path]
        w = whole[path]
        if a.shape == w.shape:
            assert torch.equal(a, w) and torch.equal(b, w), path
            continue
        dim = [i for i, (x, y) in enumerate(zip(a.shape, w.shape))
               if x != y]
        assert len(dim) == 1, path
        assert torch.equal(torch.cat([a, b], dim[0]), w), path


def _tensors(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tensors(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _tensors(v, path + (i,))
    elif isinstance(tree, torch.Tensor):
        yield "/".join(map(str, path)), tree


def test_fused_blocks_hold_the_ranks_own_heads_and_columns():
    """Deliberate difference 1: ``wqkv`` / ``w_gateup`` keep the
    reference's spec (model on the fused dim) and shard size, but a
    rank's block is ``[q_r | k_r | v_r]`` and ``[gate_r | up_r]``, not the
    spec's contiguous block (which GSPMD reshards at the anchors)."""
    cfg = get_config("olmo-1b").reduced()
    packed = lm.prepack_decode_params(lm.init_lm(cfg, seed=0, device="cpu"),
                                      cfg)
    d, hd, H, Hkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    layer = packed["layers"][0]
    for r in range(2):
        mesh = _rank_mesh({"data": 1, "model": 2}, r)
        mine = shd.shard_params(packed, mesh, cfg)["layers"][0]
        a, m = layer["attn"], layer["mlp"]
        spec = shd._leaf_spec("layers/0/attn/wqkv", tuple(a["wqkv"].shape),
                              mesh, cfg)
        assert spec == jshd._leaf_spec("layers/0/attn/wqkv",
                                       tuple(a["wqkv"].shape), mesh, cfg) \
            == shd.P("data", "model")     # 'data' of size 1: no split
        contiguous = shd.shard_tensor(a["wqkv"], spec, mesh)
        want = torch.cat([
            a["wq"][:, r * H // 2:(r + 1) * H // 2].reshape(d, -1),
            a["wk"][:, r * Hkv // 2:(r + 1) * Hkv // 2].reshape(d, -1),
            a["wv"][:, r * Hkv // 2:(r + 1) * Hkv // 2].reshape(d, -1)], 1)
        assert mine["attn"]["wqkv"].shape == contiguous.shape
        assert torch.equal(mine["attn"]["wqkv"], want)
        assert not torch.equal(mine["attn"]["wqkv"], contiguous)
        f = cfg.d_ff
        gu = torch.cat([m["w_gate"][:, r * f // 2:(r + 1) * f // 2],
                        m["w_up"][:, r * f // 2:(r + 1) * f // 2]], 1)
        assert torch.equal(mine["mlp"]["w_gateup"], gu)
        assert not torch.equal(
            gu, shd.shard_tensor(m["w_gateup"], shd.P("data", "model"),
                                 mesh))
        # the prepack of a rank's unpacked blocks packs the same
        local = lm.prepack_decode_params(
            lm.init_lm(cfg, seed=0, device="cpu", mesh=mesh), cfg)
        assert torch.equal(local["layers"][0]["attn"]["wqkv"], want)


def test_selection_runs_at_the_planners_shape_not_sharded_plan_place():
    """Deliberate difference 2, at olmo-1b's down projection (f 8192 -> d
    2048) on a (1, 2) mesh: the planner shards ``w_down`` on f (split-K,
    ``P('model', 'data')``), where the reference's ``ShardedPlan.place``
    prefers M; the reference selects at (M/2, K), the port at the block
    its rank holds, (M, K/2)."""
    cfg = get_config("olmo-1b")
    mesh = FakeMesh({"data": 1, "model": 2})
    shape = (cfg.d_ff, cfg.d_model)
    assert shd._leaf_spec("layers/0/mlp/w_down", shape, mesh, cfg) == \
        jshd._leaf_spec("layers/mlp/w_down", shape, mesh, cfg) == \
        ("model", "data")
    assert jbase.ShardedPlan.place(cfg.d_model, cfg.d_ff, 2).axis == "M"
    key = GemvKey(M=cfg.d_model, K=cfg.d_ff, batch=8, bits=16, block=32,
                  dtype="torch.bfloat16", backend="cpu")
    ref_key, sp = dispatch._shard_gemv_key(key, DispatchPolicy(
        model_shards=2), get_backend("cpu"))
    assert (ref_key.M, ref_key.K, sp.axis) == (1024, 8192, "M")
    w = torch.zeros(shape)
    block = shd.shard_tensor(w, ("model", "data"),
                             _rank_mesh({"data": 1, "model": 2}, 1))
    assert tuple(block.shape) == (4096, 2048)      # the port's (M, K/2)


@pytest.mark.parametrize("arch,kv_heads", [("olmo-1b", 2),
                                           ("olmo-1b", 1)])
def test_serving_cache_shard_is_the_spec_block(arch, kv_heads):
    """``SlotKVCache(mesh=)``: each leaf is ``shard_tensor`` of the whole
    leaf under ``serve_cache_spec`` (kv heads on 'model' when they
    divide, else every kv head), and the attention holds those heads."""
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              n_kv_heads=kv_heads)
    whole = lm.init_cache(cfg, 4, 32, per_slot_pos=True, kv_store="int8",
                          device="cpu")
    for r in range(2):
        mesh = _rank_mesh({"data": 1, "model": 2}, r)
        kv = SlotKVCache(cfg, 4, 32, kv_store="int8", device="cpu",
                         mesh=mesh)
        assert kv.scales["k"] == kv.scales["v_scale"] == (
            2 if kv_heads == 2 else 1)
        assert kv.scales["pos"] == 1
        assert shd.attention_shardable(cfg, 2)
        wk = shd.serve_spec("layers/0/attn/wk",
                            (cfg.d_model, kv_heads, cfg.hd), mesh, cfg)
        assert (wk[1] == "model") == (kv_heads == 2)
        for name, leaf in whole.items():
            spec = shd.serve_cache_spec(mesh, cfg, tuple(leaf.shape), name)
            assert spec == jshd.serve_cache_spec(
                FakeMesh(mesh.shape), ARCHS[arch].reduced(),
                tuple(leaf.shape), name)
            assert kv.cache[name].shape == shd.shard_tensor(
                leaf, spec, mesh).shape


def test_serve_plan_keeps_whole_what_does_not_divide():
    """Attention is sharded when the heads divide and either the kv heads
    do or a rank's heads share one kv head; experts when they divide,
    else every expert's ``f`` where that divides; the vocab when it
    does.  Otherwise the leaf stays whole on every rank."""
    def spec(cfg, n, path, shape):
        return shd.serve_spec(path, shape, FakeMesh({"data": 1,
                                                     "model": n}), cfg)

    g = get_config("grok-1-314b")
    d, H, Hkv, hd, E, f = (g.d_model, g.n_heads, g.n_kv_heads, g.hd,
                           g.moe.n_experts, g.moe.d_expert)
    assert shd.attention_shardable(g, 2)
    assert spec(g, 2, "layers/0/attn/wk", (d, Hkv, hd)) == (None, "model",
                                                            None)
    assert spec(g, 2, "layers/0/moe/w_up", (E, d, f)) == ("model", None,
                                                          None)
    assert spec(g, 2, "embed", (g.vocab, d)) == ("model", None)
    assert spec(g, 16, "layers/0/moe/w_up", (E, d, f)) == (None, None,
                                                           "model")
    assert spec(g, 16, "layers/0/attn/wk", (d, Hkv, hd)) == (None,) * 3
    # 3 query heads a rank, half of one kv head's group of 6: KV
    # replicated, the query heads sharded
    assert shd.attention_shardable(g, 16)
    assert spec(g, 16, "layers/0/attn/wq", (d, H, hd)) == (None, "model",
                                                           None)
    assert not shd.attention_shardable(g, 32)     # 48 heads over 32
    assert spec(g, 32, "layers/0/attn/wq", (d, H, hd)) == (None,) * 3
    assert spec(g, 2, "layers/0/moe/router", (d, E)) == (None, None)
    assert spec(g, 2, "layers/0/ln1", (d,)) == (None,)
    gem = get_config("gemma3-1b")                     # 4 heads over 1
    assert shd.attention_shardable(gem, 2)
    # its one kv head whole in the slot cache
    assert shd.slot_cache_spec(FakeMesh({"data": 1, "model": 2}), gem,
                               (26, 8, 64, 1, 256), "k") == (None,) * 5
    hym = get_config("hymba-1.5b")                    # 25 heads
    assert not shd.attention_shardable(hym, 2)
    # its attention whole, its Mamba mixer cut on di (3200 over 2)
    shd.check_mesh_family(hym)
    assert spec(hym, 2, "layers/0/attn/wq", (1600, 25, 64)) == (None,) * 3
    assert spec(hym, 2, "layers/0/mamba/w_out", (3200, 1600)) == (
        "model", None)
    assert not shd.attention_shardable(g, 1)
    assert spec(g, 1, "embed", (g.vocab, d)) == (None, None)


MESH_ARCHS = sorted(a for a in ARCHS if a in (
    "olmo-1b", "minitron-8b", "gemma3-1b", "gemma3-27b",
    "deepseek-moe-16b", "grok-1-314b", "whisper-small",
    "llama-3.2-vision-11b"))


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", MESH_ARCHS)
def test_the_placement_that_runs_is_the_planners(arch, reduced):
    """Every leaf a serving rank cuts (``serve_spec``) is cut on the
    reference ``_leaf_spec``'s 'model' dim, and every other leaf is whole
    for a named reason: the layer reads it whole (norms, the router), the
    planner placed it on a fallback dim (not its first choice), attention
    does not shard (``attention_shardable`` by the heads of the layer
    that holds it: the encoder's own under ``encoder/``), or the
    reference's tiny-leaf rule (which serving does not apply: the leaf is
    then cut on its first choice).  The fused prepack leaves are pinned in
    ``test_fused_blocks_hold_the_ranks_own_heads_and_columns``."""
    cfg, trees = _trees(arch, reduced)
    for mshape in MESHES.values():
        mesh = FakeMesh(mshape)
        n = mshape["model"]
        for path, shape in _leaves_with_paths(trees[1]):
            name = path.split("/")[-1]
            if name in shd.FUSED_LEAVES:
                continue
            got = shd.serve_spec(path, shape, mesh, cfg)
            want = jshd._leaf_spec(path, shape, mesh, cfg)
            assert set(got) <= {None, "model"}, path
            first = shd._model_prefs(name, shape)[0]
            if name not in shd.SERVE_LEAVES or (
                    name in shd.ATTN_LEAVES and not shd.attention_shardable(
                        shd.leaf_config(path, cfg), n)):
                assert "model" not in got, path
            elif len(want) == 0:            # tiny: replicated there
                assert max(shape) < 128
                assert (got[first] == "model") == (shape[first] % n == 0)
            elif "model" in want and list(want).index("model") == first:
                assert got.index("model") == first, path
            else:
                assert "model" not in got, path


@pytest.mark.parametrize("dec_heads, enc_heads", [(3, 4), (4, 3)])
def test_the_encoder_is_placed_by_its_own_heads(dec_heads, enc_heads):
    """Deliberate difference: whisper's encoder leaves are cut by the
    encoder's own heads and FFN width (``lm.encoder_config``), the cross
    layers' by the decoder's heads, each attention only where its heads
    divide; the reference's ``_leaf_spec`` plans every leaf by its dims
    alone (GSPMD partitions any placement), so it cuts an attention leaf
    whose heads do not divide on another dim.  Here a reduced whisper
    whose decoder and encoder heads differ, on (1, 2): where one side's
    3 heads do not divide its attention stays whole while the other's 4
    are cut, and both FFNs are cut by their own widths (widths of 128:
    past the reference's tiny-leaf rule)."""
    base = get_config("whisper-small").reduced()
    cfg = dataclasses.replace(
        base, d_model=128, n_heads=dec_heads, n_kv_heads=dec_heads,
        encoder=dataclasses.replace(base.encoder, d_model=128,
                                    n_heads=enc_heads, d_ff=96))
    mesh = FakeMesh({"data": 1, "model": 2})
    ecfg = lm.encoder_config(cfg)
    assert ecfg.d_ff == 96 and shd.leaf_config("encoder/layers/0/mlp/w_up",
                                               cfg) == ecfg
    full = lm.init_lm(cfg, device="meta")
    checked = 0
    for path, t in _tensors(full):
        shape = tuple(t.shape)
        got = shd.serve_spec(path, shape, mesh, cfg)
        name = path.split("/")[-1]
        heads = enc_heads if path.startswith("encoder/") else dec_heads
        if name in shd.ATTN_LEAVES:
            want_cut = heads % 2 == 0
            assert ("model" in got) == want_cut, path
            if not want_cut and "model" in jshd._leaf_spec(path, shape,
                                                           mesh, cfg):
                checked += 1    # the reference cuts it elsewhere
        elif name in ("w_up", "w_down"):
            dim = 1 if name == "w_up" else 0
            assert got[dim] == "model", path
            assert shape[dim] == (ecfg.d_ff if path.startswith("encoder/")
                                  else cfg.d_ff)
        else:
            assert "model" not in got or name == "embed", path
    assert checked > 0


def test_shard_params_cuts_every_leaf_by_its_serve_spec():
    """A rank's serving tree (prepacked): each leaf is ``shard_tensor`` of
    the whole leaf under ``serve_spec``, a whole leaf is the same tensor,
    and the fused leaves are their members' blocks concatenated."""
    for arch in ("olmo-1b", "deepseek-moe-16b"):
        cfg = get_config(arch).reduced()
        packed = lm.prepack_decode_params(
            lm.init_lm(cfg, seed=0, device="cpu"), cfg)
        for r in range(2):
            mesh = _rank_mesh({"data": 1, "model": 2}, r)
            mine = dict(_tensors(shd.shard_params(packed, mesh, cfg)))
            for path, t in _tensors(packed):
                name = path.split("/")[-1]
                if name in shd.FUSED_LEAVES:
                    continue
                spec = shd.serve_spec(path, tuple(t.shape), mesh, cfg)
                if "model" in spec:
                    assert torch.equal(mine[path],
                                       shd.shard_tensor(t, spec, mesh))
                else:
                    assert mine[path] is t, path
            head = mine["embed"].t() if cfg.tie_embeddings \
                else mine["lm_head"]
            assert torch.equal(mine["head_t"], head)
            assert mine["head_t"].shape[1] == cfg.vocab // 2


@pytest.mark.parametrize("kv_heads", [2, 1])
def test_prefix_segments_are_the_segment_spec_block(kv_heads):
    """A rank's ``extract_prefix`` payload is ``shard_tensor`` of the
    unsharded payload under ``segment_spec`` (the reference's placer of
    prefix segments), so a splice stays local to the shard; its store
    counts the unsharded bytes (``byte_scale``)."""
    from repro_torch.serving.prefix_cache import PrefixCache

    cfg = dataclasses.replace(get_config("olmo-1b").reduced(),
                              n_kv_heads=kv_heads)
    whole = SlotKVCache(cfg, 2, 32, kv_store="int8", device="cpu")
    for leaf in whole.cache.values():
        leaf.copy_(torch.randint(-100, 100, leaf.shape).to(leaf.dtype))
    want = whole.extract_prefix(1, 12)
    for r in range(2):
        mesh = _rank_mesh({"data": 1, "model": 2}, r)
        kv = SlotKVCache(cfg, 2, 32, kv_store="int8", device="cpu",
                         mesh=mesh)
        for name, leaf in kv.cache.items():
            spec = shd.serve_cache_spec(mesh, cfg, tuple(
                whole.cache[name].shape), name)
            leaf.copy_(shd.shard_tensor(whole.cache[name], spec, mesh))
        got = kv.extract_prefix(1, 12)
        for name, seg in want["kv"].items():
            spec = shd.segment_spec(mesh, cfg, tuple(seg.shape), name)
            assert spec == jshd.segment_spec(FakeMesh(mesh.shape), cfg,
                                             tuple(seg.shape), name)
            assert torch.equal(got["kv"][name],
                               shd.shard_tensor(seg, spec, mesh))
        store = PrefixCache(has_state=False, byte_scale=kv.scales)
        store.insert(np.arange(12), got)
        ref = PrefixCache(has_state=False)
        ref.insert(np.arange(12), want)
        assert store.bytes_used == ref.bytes_used


def test_a_ranks_blocks_own_their_memory():
    """Every leaf ``init_lm(mesh=)`` cuts holds only its block (a view,
    even a contiguous one along dim 0, would keep the whole tensor
    alive): the rank's tree stores about half of the unsharded bytes."""
    cfg = get_config("deepseek-moe-16b").reduced()
    full = lm.init_lm(cfg, seed=0, device="cpu")
    mine = lm.init_lm(cfg, seed=0, device="cpu",
                      mesh=_rank_mesh({"data": 1, "model": 2}, 1))

    def stored(tree):
        return sum(t.untyped_storage().nbytes() for _, t in _tensors(tree))

    for path, t in _tensors(mine):
        assert t.untyped_storage().nbytes() == t.numel() * t.element_size(), \
            path
    assert stored(mine) < 0.6 * stored(full)


# where a recurrent mixer's placement differs from the reference's
# ``_leaf_spec`` ('model' dim of the per-layer leaf; None: whole), and why
STATE_DIFFERENCES = {
    # the pair [x1_r | z_r]: the same dim, cut in two parts (the port's
    # P.pairs); contiguous columns would give x1 to one rank, z to another
    "mamba/w_in": 1,
    # multiplies the reduced k @ wv: whole (the reference cuts output d)
    "channel_mix/wr": None,
    # the down projection's d_ff rows, a partial sum (reference: d)
    "channel_mix/wv": 0,
    # the per-head bonus on its head rows (reference: the largest dim)
    "time_mix/u": 0,
    # the token-shift mixes and the decay LoRA's input side read the whole
    # input on every rank (the reference cuts their largest dim)
    "time_mix/mu": None, "channel_mix/mu": None, "time_mix/w_a": None,
    # hymba's combine weights: read whole, as the norm scales are
    "beta_attn": None, "beta_ssm": None,
}


@pytest.mark.parametrize("arch", ["rwkv6-3b", "hymba-1.5b"])
def test_recurrent_placement_against_the_references_plan(arch):
    """rwkv6-3b and hymba-1.5b at full width on (1, 2), (1, 4) and (2,
    2), leaf by leaf: each layer's leaf under ``serve_spec`` (and
    ``train_spec``, which adds 'data') beside the reference's
    ``plan_params`` of the same per-layer leaf.  'model' lands on the
    reference's dim except at the pinned differences
    (``STATE_DIFFERENCES``); ``w_in`` alone is paired.  The slot cache's
    state (``slot_cache_spec``) is the reference's ``serve_cache_spec``
    but for the token-shift carries, whole (the reference cuts their
    ``d``)."""
    cfg, jcfg = get_config(arch), ARCHS[arch]
    full = lm.init_lm(cfg, device="meta")
    cache = lm.init_cache(cfg, 8, 1024, per_slot_pos=True, device="meta")
    seen = set()
    for mshape in ({"data": 1, "model": 2}, {"data": 1, "model": 4},
                   {"data": 2, "model": 2}):
        mesh = FakeMesh(mshape)
        for path, t in _tensors(full):
            parts = path.split("/")
            if parts[0] != "layers" or parts[1] != "0":
                continue
            key = "/".join(parts[2:])
            shape = tuple(t.shape)
            got = shd.serve_spec(path, shape, mesh, cfg)
            ref = jshd._leaf_spec(path, shape, mesh, jcfg)
            dim = got.index("model") if "model" in got else None
            ref_dim = ref.index("model") if "model" in ref else None
            want = STATE_DIFFERENCES.get(key, ref_dim)
            if key.startswith(("attn/", "mlp/", "ln")):
                continue        # pinned by the dense families' tests
            assert dim == want, (key, got, ref)
            assert got.pairs == (2 if key == "mamba/w_in" else 1), key
            if key in STATE_DIFFERENCES and want != ref_dim:
                seen.add(key)
            train = shd.train_spec(path, shape, _rank_mesh(mshape, 0), cfg)
            assert tuple(train)[dim] == "model" if dim is not None \
                else "model" not in train
            assert train.pairs == got.pairs
        for name, leaf in cache.items():
            shape = tuple(leaf.shape)
            got = shd.slot_cache_spec(mesh, cfg, shape, name)
            ref = jshd.serve_cache_spec(mesh, jcfg, shape, name)
            if name in ("rwkv_x_tm", "rwkv_x_cm"):
                assert got == (None,) * 3 and "model" in ref, name
            else:
                assert got == ref, name
    assert seen == ({"channel_mix/wr", "channel_mix/wv", "time_mix/u",
                     "time_mix/mu", "channel_mix/mu", "time_mix/w_a"}
                    if arch == "rwkv6-3b" else {"beta_attn", "beta_ssm"})


@pytest.mark.parametrize("arch", ["rwkv6-3b", "hymba-1.5b"])
def test_recurrent_cache_and_segments_are_the_rank_blocks(arch):
    """``SlotKVCache(mesh=)`` of a recurrent model: each leaf is
    ``shard_tensor`` of the whole leaf under ``slot_cache_spec`` (the wkv
    state on the rank's heads, the Mamba state and window on its
    channels, the carries whole), the state rows a rank snapshots are its
    blocks of the unsharded snapshot (the slot cache's spec less the slot
    axis), and a store counting each leaf's bytes times its ``scales``
    counts the unsharded engine's bytes."""
    from repro_torch.serving.prefix_cache import PrefixCache

    cfg = get_config(arch).reduced()
    whole = SlotKVCache(cfg, 2, 32, device="cpu")
    for leaf in whole.cache.values():
        leaf.copy_(torch.randint(-100, 100, leaf.shape).to(leaf.dtype))
    want = whole.extract_prefix(1, 12)
    ref = PrefixCache(has_state=True)
    ref.insert(np.arange(12), want)
    for r in range(2):
        mesh = _rank_mesh({"data": 1, "model": 2}, r)
        kv = SlotKVCache(cfg, 2, 32, device="cpu", mesh=mesh)
        for name, leaf in kv.cache.items():
            spec = shd.slot_cache_spec(mesh, cfg, tuple(
                whole.cache[name].shape), name)
            block = shd.shard_tensor(whole.cache[name], spec, mesh)
            assert leaf.shape == block.shape, name
            assert kv.scales[name] == whole.cache[name].numel() \
                // leaf.numel(), name
            leaf.copy_(block)
        got = kv.extract_prefix(1, 12)
        for name, seg in want["state"].items():
            spec = shd.slot_cache_spec(mesh, cfg, tuple(
                whole.cache[name].shape), name)
            assert torch.equal(got["state"][name], shd.shard_tensor(
                seg, (spec[0],) + tuple(spec[2:]), mesh)), name
        cut = {n for n, s in kv.scales.items() if s > 1}
        assert cut == ({"rwkv_s"} if arch == "rwkv6-3b"
                       else {"k", "v", "mamba_conv", "mamba_h"})
        store = PrefixCache(has_state=True, byte_scale=kv.scales)
        store.insert(np.arange(12), got)
        assert store.bytes_used == ref.bytes_used
