"""Sharded serving of whisper-small and llama-3.2-vision-11b over
``torch.distributed`` on the CPU: one 2-rank gloo group on a (1, 2) mesh,
started by the port's launcher (``launch.mesh.spawn``), runs every case
of ``_torch_mesh_workers.MM_CASES``.

Reduced whisper (also with an encoder of width 32, so ``proj`` maps it to
the decoder's 64, and with an odd vocab of 255, whose embedding and head
stay whole on every rank) and llama-vision at 4 layers (2 groups; also
with one kv head, K / V whole on every rank), every ``cross_gate`` at
0.75; the port's seeded init, each rank drawing the
same values and keeping its blocks (the encoder's by the encoder's own
heads and FFN width, the cross layers' by their heads).  Each rank is held
against the port's unsharded engine (every sampled logits row within
1e-4: f32, the sharded sums reassociate) and the unsharded JAX ``Engine``
on the same weights through ``repro_torch.bridge`` (greedy tokens; the
reference's own sharded identity test fails on this jax).  The mixed plan
chunks at 8 and compacts once; the prefix cache stays off for both
families, as in both packages.  About 50 s in one process, the spawn and
the JAX engines included.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import _torch_mesh_workers as W  # noqa: E402

from repro.configs.registry import ARCHS  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro_torch.bridge import params_to_numpy  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch.mesh import Mesh, spawn  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402

torch.set_num_threads(1)

SPAWN_TIMEOUT_S = 240
ROW_ATOL = 1e-4
NAMES = tuple(W.MM_CASES)
MODEL_CASES = ["whisper", "whisper_enc32", "whisper_vocab255", "vision",
               "vision_kv1"]


@pytest.fixture(scope="module")
def ranks():
    return spawn(W.run_mm_cases, (1, 2), device="cpu", args=(NAMES,),
                 timeout_s=SPAWN_TIMEOUT_S)


_UNSHARDED: dict = {}


def unsharded(name: str) -> dict:
    """The port's engine without a mesh, on the case's weights."""
    if name not in _UNSHARDED:
        _UNSHARDED[name] = W.mm_serve(name)
    return _UNSHARDED[name]


def jax_tokens(name: str) -> dict:
    """The JAX ``Engine``'s greedy tokens on the case's weights."""
    arch, over, _ = W.MM_CASES[name]
    jcfg = ARCHS[arch].reduced()
    jcfg = dataclasses.replace(jcfg, **W.mm_overrides(jcfg, over))
    tcfg = W.mm_config(name)
    tree = jax.tree.map(jnp.asarray,
                        params_to_numpy(W.mm_params(name), tcfg))
    clk = W.FakeClock()
    eng = JaxEngine(jcfg, tree, max_len=W.MAX_LEN, clock=clk,
                    batch_slots=4, **W.MM_KW)
    reqs = W.drive(eng, JaxRequest, W.mix_plan(tcfg.vocab), clk)
    return {rid: list(r.generated) for rid, r in reqs.items()}


def _rows_close(got: dict, want: dict) -> float:
    assert got.keys() == want.keys()
    worst = 0.0
    for rid in want:
        assert len(got[rid]) == len(want[rid]), rid
        for a, b in zip(got[rid], want[rid]):
            worst = max(worst, float(np.abs(a - b).max()))
    assert worst <= ROW_ATOL, worst
    return worst


def _rows_equal(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for rid in a:
        assert len(a[rid]) == len(b[rid])
        for x, y in zip(a[rid], b[rid]):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name", MODEL_CASES)
def test_sharded_tokens_equal_the_jax_engine_and_rows_the_unsharded(
        ranks, name):
    base = unsharded(name)
    assert base["tokens"] == jax_tokens(name)
    for rank in ranks:
        got = rank[name]
        assert got["tokens"] == base["tokens"]
        _rows_close(got["rows"], base["rows"])
        assert got["counters"] == base["counters"]
    # every rank took the same host decisions: the same rows, bit for bit
    _rows_equal(ranks[0][name]["rows"], ranks[1][name]["rows"])


@pytest.mark.parametrize("name", ["whisper", "vision"])
def test_overlap_on_is_bit_equal_to_off_and_defers_nothing(ranks, name):
    """A decode step with a context (the encoder's output, the patches)
    defers no collective, as in the reference (``lm._forward_flat`` gates
    the deferral off under ``ctx``): on is off, bit for bit."""
    for rank in ranks:
        on, off = rank[f"{name}_overlap"], rank[name]
        assert on["tokens"] == off["tokens"]
        _rows_equal(on["rows"], off["rows"])
        assert on["counters"]["decode_steps"] > 0
        assert on["stats"]["overlap"]["deferred"]["collectives"] == 0


def _cut_dim(path: str, cfg) -> int | None:
    """The dim a rank's block of the encoder or cross leaf at ``path`` is
    cut on, by the heads and widths of the layer that holds it (K / V
    whole where the kv heads do not divide)."""
    name = path.split("/")[-1]
    if name in ("wk", "wv") and cfg.n_kv_heads % 2:
        return None
    if name in ("wq", "wk", "wv"):
        return 1
    if name in ("wo", "w_down"):
        return 0
    if name == "w_up":
        return 1
    return None     # norms, proj, cross_gate: whole


@pytest.mark.parametrize("name", ["whisper", "whisper_enc32", "vision",
                                  "vision_kv1"])
def test_each_rank_draws_and_holds_only_its_encoder_and_cross_heads(
        ranks, name):
    """``init_lm(mesh=)`` keeps, of every encoder and cross leaf, the
    rank's block of the unsharded init's (bit for bit): the encoder's
    heads (``wq`` / ``wk`` / ``wv`` on heads, ``wo`` on its head rows) and
    FFN columns (``w_down`` its rows), the cross layers' query and kv
    heads (with one kv head, ``wk`` / ``wv`` whole); norms, ``proj`` and
    ``cross_gate`` whole.  The engine holds those shapes."""
    cfg = W.mm_config(name)
    full = W.mm_blocks(W.mm_params(name))
    ecfg = lm.encoder_config(cfg) if cfg.encoder is not None else None
    cut = 0
    for r, rank in enumerate(ranks):
        drawn, held = rank[name]["drawn"], rank[name]["held"]
        assert drawn.keys() == full.keys()
        for path, t in full.items():
            dim = _cut_dim(path, cfg)
            want = t if dim is None else t.chunk(2, dim=dim)[r]
            assert torch.equal(drawn[path], want), path
            assert held[path] == tuple(want.shape), path
            cut += dim is not None
        if ecfg is not None:
            e = held["encoder/layers/0/attn/wq"]
            assert e[1] == ecfg.n_heads // 2
            assert held["encoder/layers/0/mlp/w_up"][1] == ecfg.d_ff // 2
        c = next(p for p in held if p.endswith("cross/wk"))
        assert held[c][1] == (cfg.n_kv_heads if cfg.n_kv_heads % 2
                              else cfg.n_kv_heads // 2)
    assert cut > 0
    if name == "whisper_enc32":
        assert full["encoder/proj"].shape == (32, cfg.d_model)


def test_an_odd_vocab_keeps_the_embedding_and_head_whole(ranks):
    """whisper-small's vocab (51865) does not split over two ranks: its
    embedding and head stay whole on every rank (the replicated head
    path); here at a vocab of 255."""
    cfg = W.mm_config("whisper_vocab255")
    assert cfg.vocab % 2
    for rank in ranks:
        held = rank["whisper_vocab255"]["held"]
        assert held["embed"] == (cfg.vocab, cfg.d_model)
        assert held["head_t"] == (cfg.d_model, cfg.vocab)
    held = ranks[0]["whisper"]["held"]
    assert held["embed"] == (W.mm_config("whisper").vocab // 2,
                             cfg.d_model)


@pytest.mark.parametrize("name", MODEL_CASES)
def test_a_compaction_moves_the_feature_rows_alike_on_every_rank(
        ranks, name):
    """Every rank draws the same feature rows (``default_rng(0)``) and
    compacts by the same moves: after the plan the rows are the unsharded
    engine's, bit for bit, a permutation of the rows drawn, and not the
    rows drawn (a move swapped some)."""
    base = unsharded(name)
    assert base["defrag_moves"] >= 1
    for rank in ranks:
        got = rank[name]
        assert got["defrag_moves"] == base["defrag_moves"]
        for k, v in base["features"].items():
            assert torch.equal(got["features_before"][k],
                               base["features_before"][k])
            assert torch.equal(got["features"][k], v)
            before = got["features_before"][k]
            assert not torch.equal(v, before)
            assert sorted(map(bytes, v.numpy())) == sorted(
                map(bytes, before.numpy()))


def test_gloo_ranks_run_eagerly_without_a_prefix_cache(ranks):
    for rank in ranks:
        for name in NAMES:
            assert rank[name]["graphs"] is None
            assert rank[name]["graphs_reason"] == "not a CUDA device"
            assert rank[name]["prefix"] is None
    assert [r["coords"] for r in ranks] == [{"data": 0, "model": 0},
                                            {"data": 0, "model": 1}]


@pytest.mark.parametrize("arch, item", [("rwkv6-3b", "2b"),
                                        ("hymba-1.5b", "2b")])
def test_recurrent_families_and_async_prefill_stay_refused(arch, item,
                                                           monkeypatch):
    """Since ROADMAP queue 1 item 2b ssm and hybrid run on a mesh: the
    family check passes and a rank's serving tree cuts their mixers (a
    time-mix on the rank's heads, a Mamba mixer on its channels), with no
    collective.  Since item 2c ``async_prefill`` runs on a mesh too: the
    engine builds for these two families and for whisper and
    llama-vision, and the prefill sub-cache its chains run on holds the
    rank's block of every leaf (``slot_cache_spec``), with a row more
    than the slots.  This mesh has no process groups: the chains' side
    mesh is the mesh itself, and construction's one collective, rank
    0's autotune table broadcast, is recorded instead of made (the
    engine on a gloo group: ``test_torch_sharded_async.py``)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.serving import engine as engine_mod

    shared = []
    monkeypatch.setattr(engine_mod, "share_autotune_table", shared.append)

    mesh = Mesh(shape={"data": 1, "model": 2}, rank=0,
                coords={"data": 0, "model": 0})
    cfg = get_config(arch).reduced()
    shd.check_mesh_family(cfg)
    params = lm.init_lm(cfg, seed=0, device="cpu")
    mine = shd.shard_params(params, mesh, cfg)
    layer, whole = mine["layers"][0], params["layers"][0]
    if item == "2b" and cfg.family == "ssm":
        assert layer["time_mix"]["wr"].shape[1] == cfg.d_model // 2
        assert layer["channel_mix"]["wr"] is whole["channel_mix"]["wr"]
    else:
        w_in = whole["mamba"]["w_in"]
        x1, z = w_in.chunk(2, dim=-1)
        assert torch.equal(layer["mamba"]["w_in"], torch.cat(
            [x1.chunk(2, dim=-1)[0], z.chunk(2, dim=-1)[0]], dim=-1))
    for c, p in [(cfg, params)] + [
            (W.mm_config(n), lm.init_lm(W.mm_config(n), seed=0,
                                        device="cpu"))
            for n in ("whisper", "vision")]:
        shd.check_mesh_family(c)
        eng = Engine(c, p, device="cpu", mesh=mesh, async_prefill=True,
                     batch_slots=2, max_len=W.MAX_LEN)
        assert eng.async_prefill and eng.chain_mesh is mesh
        whole_sub = lm.init_cache(c, 3, W.MAX_LEN, per_slot_pos=True,
                                  device="cpu")
        assert eng.sub.keys() == whole_sub.keys()
        cut = 0
        for name, leaf in whole_sub.items():
            spec = shd.slot_cache_spec(mesh, c, tuple(leaf.shape), name)
            assert eng.sub[name].shape == shd.block_shape(
                tuple(leaf.shape), spec, mesh), (c.name, name)
            cut += "model" in spec
        assert cut > 0, c.name
    assert shared == [mesh] * 3
