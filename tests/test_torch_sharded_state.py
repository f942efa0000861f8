"""Sharded serving of rwkv6-3b and hymba-1.5b over ``torch.distributed``
on the CPU: one (1, 2) gloo group and one (2, 2) group, started by the
port's launcher (``launch.mesh.spawn``), run the cases of
``_torch_mesh_workers.STATE_CASES``.

Reduced rwkv6 (2 heads: one a rank) and hymba (4 heads and 4 kv heads:
attention cut beside the Mamba channels), hymba with 5 heads and 5 kv
heads (attention whole on every rank, the Mamba mixer cut: the placement
the full width runs), each from the port's seeded init with the leaves
the init leaves constant drawn afresh (``perturb_state``); every rank
builds its engine from the whole tree, which the engine cuts to its
blocks.  The mixed plan runs a wave, chunks of 8 (with the state rows of
a row mid-prefill saved and restored around a decode step), a compaction
and a prefix hit on a state snapshot; the preemption plan evicts a
decoding request.  Each rank is held against the port's unsharded engine
(every sampled logits row within 1e-4 in f32: the sharded sums
reassociate; the same counters, prefix statistics and segment bytes;
each state leaf at the end its block of the unsharded leaf, within
1e-4) and against the unsharded JAX ``Engine`` on the same weights
through ``repro_torch.bridge`` (greedy tokens).  Both groups start on
threads with the module and serve while the JAX engines compile.
"""

import concurrent.futures
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
from repro.serving.scheduler import SchedulerConfig as JaxSched  # noqa: E402
from repro_torch.bridge import params_to_numpy  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch.mesh import Mesh, spawn  # noqa: E402

torch.set_num_threads(1)

SPAWN_TIMEOUT_S = 240
ROW_ATOL = 1e-4
NAMES = tuple(W.STATE_CASES)
NAMES_22 = ("rwkv", "hymba")        # the (2, 2) group's cases
MESHES = {"1x2": (1, 2), "2x2": (2, 2)}


@pytest.fixture(scope="module", autouse=True)
def groups():
    """Both gloo groups, started on threads when the module starts: their
    ranks serve while this process runs the JAX engines."""
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        yield {"1x2": pool.submit(spawn, W.run_state_cases, (1, 2),
                                  device="cpu", args=(NAMES,),
                                  timeout_s=SPAWN_TIMEOUT_S),
               "2x2": pool.submit(spawn, W.run_state_cases, (2, 2),
                                  device="cpu", args=(NAMES_22,),
                                  timeout_s=SPAWN_TIMEOUT_S)}


@pytest.fixture(scope="module")
def ranks12(groups):
    return groups["1x2"].result()


@pytest.fixture(scope="module")
def ranks22(groups):
    return groups["2x2"].result()


def _ranks(request, mesh: str) -> list:
    return request.getfixturevalue({"1x2": "ranks12",
                                    "2x2": "ranks22"}[mesh])


_UNSHARDED: dict = {}


def unsharded(name: str) -> dict:
    """The port's engine without a mesh, on the case's weights."""
    if name not in _UNSHARDED:
        _UNSHARDED[name] = W.state_serve(name)
    return _UNSHARDED[name]


def jax_tokens(name: str) -> dict:
    """The JAX ``Engine``'s greedy tokens on the case's weights (its
    config with the case's overrides)."""
    arch, over, plan = W.STATE_CASES[name]
    jcfg = dataclasses.replace(ARCHS[arch].reduced(), **over)
    tcfg = W.state_config(name)
    tree = jax.tree.map(jnp.asarray,
                        params_to_numpy(W.state_params(name), tcfg))
    clk = W.FakeClock()
    preempt = plan == "preempt"
    eng = JaxEngine(jcfg, tree, max_len=W.MAX_LEN, clock=clk,
                    batch_slots=2 if preempt else 4,
                    scheduler=JaxSched(**W.PREEMPT) if preempt else "fcfs",
                    **W.STATE_KW)
    reqs = W.drive(eng, JaxRequest, W.state_plan(name, tcfg.vocab), clk)
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


def _rank_mesh(shape, coords) -> Mesh:
    return Mesh(shape=dict(zip(("data", "model"), shape)), rank=0,
                coords=dict(coords))


@pytest.mark.parametrize("name", NAMES)
def test_sharded_tokens_equal_the_jax_engine_and_rows_the_unsharded(
        request, name):
    base = unsharded(name)
    assert base["tokens"] == jax_tokens(name)
    ranks12 = request.getfixturevalue("ranks12")    # after the JAX engine
    for rank in ranks12:
        got = rank[name]
        assert got["tokens"] == base["tokens"]
        _rows_close(got["rows"], base["rows"])
        assert got["counters"] == base["counters"]
        assert got["defrag_moves"] == base["defrag_moves"]
        assert got["saves"] == base["saves"]
    # every rank took the same host decisions: the same rows, bit for bit
    for a, b in zip(ranks12[0][name]["rows"].values(),
                    ranks12[1][name]["rows"].values()):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_the_plans_reach_every_path(ranks12):
    """The mixed plan compacts, chunks with state rows saved around a
    decode step and hits a state snapshot; the preemption plan evicts."""
    for name in NAMES:
        c = unsharded(name)["counters"]
        assert c["prefix_hits"] >= 1 and c["prefill_tokens_saved"] > 0
        if W.STATE_CASES[name][2] == "mix":
            assert c["prefill_chunks"] >= 2
            assert unsharded(name)["defrag_moves"] >= 1
            assert unsharded(name)["saves"] >= 1
        else:
            assert c["evicted"] >= 1


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", NAMES_22)
def test_prefix_segments_count_the_unsharded_bytes(request, mesh, name):
    """Every rank's prefix cache holds the same segments as the unsharded
    engine's and counts the same bytes (each leaf's rank bytes times its
    scale), so every rank evicts as the unsharded engine would."""
    base = unsharded(name)
    for rank in _ranks(request, mesh):
        got = rank[name]
        assert got["prefix"] == base["prefix"]
        assert got["prefix_bytes"] == base["prefix_bytes"] > 0


@pytest.mark.parametrize("mesh, name", [("1x2", n) for n in NAMES]
                         + [("2x2", n) for n in NAMES_22])
def test_each_ranks_state_rows_are_its_blocks_of_the_unsharded(
        request, mesh, name):
    """At the end of the plan each cache leaf of a rank (the wkv state on
    its heads, the Mamba state and window on its channels, K/V on its kv
    heads where they divide, the carries and ``pos`` whole) is its block
    of the unsharded engine's leaf under ``slot_cache_spec``, within the
    rows' tolerance; a leaf held whole is the same bits on every rank."""
    base = unsharded(name)["cache"]
    cfg = W.state_config(name)
    ranks = _ranks(request, mesh)
    for rank in ranks:
        m = _rank_mesh(MESHES[mesh], rank["coords"])
        for leaf, whole in base.items():
            spec = shd.slot_cache_spec(m, cfg, tuple(whole.shape), leaf)
            want = shd.shard_tensor(whole, spec, m)
            got = rank[name]["cache"][leaf]
            assert got.shape == want.shape, leaf
            torch.testing.assert_close(got, want, rtol=0, atol=ROW_ATOL,
                                       msg=leaf)
            if "model" not in spec:
                assert torch.equal(got, ranks[0][name]["cache"][leaf]), leaf


@pytest.mark.parametrize("mesh", MESHES)
def test_the_2x2_mesh_serves_as_1x2(request, mesh):
    """A 'data' axis replicates the serving state: the (2, 2) group's
    ranks give the unsharded engine's tokens and rows too."""
    for name in NAMES_22:
        base = unsharded(name)
        for rank in _ranks(request, mesh):
            assert rank[name]["tokens"] == base["tokens"]
            _rows_close(rank[name]["rows"], base["rows"])


@pytest.mark.parametrize("name", ["rwkv", "hymba", "hymba_h5"])
def test_each_rank_draws_and_holds_its_mixer_blocks(ranks12, name):
    """``init_lm(mesh=)`` keeps, of every recurrent mixer leaf, the rank's
    block of the unsharded init's (bit for bit; ``w_in`` as ``[x1_r |
    z_r]``), and the engine built from the whole tree holds the same
    shapes: a time-mix's r / k / v / g and ``w_b`` on its heads' columns,
    ``wo`` on their rows, a channel-mix's ``wk`` / ``wv`` on ``d_ff``,
    its ``wr`` whole; a Mamba mixer on ``di``.  With 5 heads hymba's
    attention stays whole on every rank."""
    from repro_torch.models import lm
    from repro_torch.tree import flatten_with_paths, path_str

    cfg = W.state_config(name)
    full = {path_str(p): t for p, t in flatten_with_paths(
        lm.init_lm(cfg, seed=0, device="cpu"))}
    for r, rank in enumerate(ranks12):
        m = _rank_mesh((1, 2), rank["coords"])
        drawn, held = rank[name]["drawn"], rank[name]["held"]
        cut = 0
        for path, t in full.items():
            spec = shd.serve_spec(path, tuple(t.shape), m, cfg)
            want = shd.shard_tensor(t, spec, m)
            assert torch.equal(drawn[path], want), path
            assert held[path] == tuple(want.shape), path
            cut += "model" in spec
        w_in = next(p for p in full if p.endswith("w_in")) \
            if cfg.parallel_ssm else None
        if w_in is not None:
            x1, z = full[w_in].chunk(2, dim=-1)
            assert torch.equal(drawn[w_in], torch.cat(
                [x1.chunk(2, dim=-1)[r], z.chunk(2, dim=-1)[r]], dim=-1))
            wq = held["layers/0/attn/wq"]
            assert wq[1] == (cfg.n_heads if cfg.n_heads % 2
                             else cfg.n_heads // 2)
        else:
            assert held["layers/0/channel_mix/wr"] == (cfg.d_model,) * 2
            assert held["layers/0/time_mix/wr"][1] == cfg.d_model // 2
        assert cut > 0
