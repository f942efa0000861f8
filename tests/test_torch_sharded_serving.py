"""Sharded serving over ``torch.distributed`` on the CPU: 2-rank gloo
groups on a (1, 2) mesh and one 4-rank group on (2, 2), started by the
port's launcher (``launch.mesh.spawn``).

One 2-rank group runs every case (``_torch_mesh_workers.CASES``); the
tests below hold what each rank returned against the port's unsharded
engine (every sampled logits row within 1e-4: f32, the K-sharded sums
reassociate) and the JAX ``Engine`` (greedy tokens) on the same weights
(the port's seeded init; the ranks draw the same values and keep their
blocks).  The reference's own sharded identity test fails on this jax,
so the JAX engine runs unsharded.  Reduced olmo-1b, deepseek-moe-16b
(ragged, and grouped once) and grok-1-314b; a mix of prompt lengths,
chunk 8, one prefix hit and one compaction.
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import _torch_mesh_workers as W  # noqa: E402
from test_torch_graphs import _jax_tree  # noqa: E402

from repro.configs.registry import ARCHS  # noqa: E402
from repro.distributed import collectives as jcoll  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro.serving.scheduler import \
    SchedulerConfig as JSchedulerConfig  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402
from repro_torch.models import lm  # noqa: E402

torch.set_num_threads(1)

SPAWN_TIMEOUT_S = 240
ROW_ATOL = 1e-4
NAMES = tuple(W.CASES)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case on each rank of one (1, 2) group, and the table case."""
    tables = str(tmp_path_factory.mktemp("tables"))
    return spawn(W.run_cases, (1, 2), device="cpu", args=(NAMES, tables),
                 timeout_s=SPAWN_TIMEOUT_S)


_UNSHARDED: dict = {}


def unsharded(name: str) -> dict:
    """The port's engine without a mesh, on the case's weights."""
    if name not in _UNSHARDED:
        _UNSHARDED[name] = W.serve(name)
    return _UNSHARDED[name]


_JAX: dict = {}


def jax_tokens(name: str) -> dict:
    """The JAX ``Engine``'s greedy tokens on the case (cases that differ
    only in ``overlap_collectives`` share a run)."""
    arch, over, kw, _, sched = W.CASES[name]
    kw = {k: v for k, v in kw.items()
          if k not in ("gemv_backend", "overlap_collectives")}
    key = (arch, tuple(sorted(over.items())), tuple(sorted(kw.items())))
    if key not in _JAX:
        tcfg = W.case_config(name)
        jcfg = dataclasses.replace(ARCHS[arch].reduced(), **over)
        tparams = lm.init_lm(tcfg, seed=0, device="cpu")
        clk = W.FakeClock()
        eng = JaxEngine(jcfg, _jax_tree(tparams), max_len=W.MAX_LEN,
                        clock=clk, scheduler=(JSchedulerConfig(**sched)
                                              if sched else "fcfs"),
                        **{"batch_slots": 4, **kw})
        reqs = W.drive(eng, JaxRequest, W.case_plan(name, tcfg.vocab), clk)
        _JAX[key] = {rid: list(r.generated) for rid, r in reqs.items()}
    return _JAX[key]


def _rows_close(got: dict, want: dict) -> float:
    assert got.keys() == want.keys()
    worst = 0.0
    for rid in want:
        assert len(got[rid]) == len(want[rid]), rid
        for a, b in zip(got[rid], want[rid]):
            worst = max(worst, float(np.abs(a - b).max()))
    assert worst <= ROW_ATOL, worst
    return worst


MODEL_CASES = ["olmo", "deepseek", "deepseek_grouped", "grok",
               "kv_replicated"]


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
    # every rank took the same host decisions, bit for bit the same rows
    for rid, rows in ranks[0][name]["rows"].items():
        for a, b in zip(rows, ranks[1][name]["rows"][rid]):
            np.testing.assert_array_equal(a, b)


def test_the_mix_hits_the_prefix_cache_compacts_and_chunks(ranks):
    """The plan does what it is for, on every rank and unsharded alike;
    the segment store counts global bytes (a rank holds half)."""
    base = unsharded("olmo")
    for rank in ranks:
        c, p = rank["olmo"]["counters"], rank["olmo"]["prefix"]
        assert c["prefill_chunks"] >= 4 and p["hits"] >= 1
        assert rank["olmo"]["defrag_moves"] == base["defrag_moves"] >= 1
        assert p == base["prefix"]
    assert base["counters"]["prefill_chunks"] >= 4


@pytest.mark.parametrize("name", ["olmo", "deepseek"])
def test_overlap_on_is_bit_equal_to_off_and_counts_deferred(ranks, name):
    cfg = W.case_config(name)
    for rank in ranks:
        on, off = rank[f"{name}_overlap"], rank[name]
        assert on["tokens"] == off["tokens"]
        for rid in off["rows"]:
            for a, b in zip(on["rows"][rid], off["rows"][rid]):
                np.testing.assert_array_equal(a, b)
        steps = on["counters"]["decode_steps"]
        assert steps > 0
        assert on["stats"]["overlap"]["deferred"]["collectives"] == \
            cfg.n_layers * steps
        assert off["stats"]["overlap"]["deferred"]["collectives"] == 0
    assert unsharded(name)["stats"]["overlap"]["deferred"][
        "collectives"] == 0


def _decisions(stats: dict) -> dict:
    return {"gemv_path": stats["gemv_path"],
            "matmul_fallback": stats["matmul_fallback"],
            "kernel_picks": sum(stats["kernel_picks"].values()),
            "program_modes": sum(stats["program_modes"].values())}


@pytest.mark.parametrize("name", ["olmo", "deepseek", "grok"])
def test_decision_counts_equal_the_unsharded_and_name_rank_shapes(ranks,
                                                                  name):
    """As many decisions as unsharded (each counted once under its
    planner axis), and ``shard_picks`` keyed by the blocks a rank runs:
    QKV over its heads, gate+up over its FFN columns (M / 2), the down
    projection over its rows (K / 2: the planner's split-K), the head
    over its vocab block, the experts E / 2 a rank."""
    cfg = W.case_config(name)
    base = unsharded(name)["stats"]
    assert not base["sharded_axes"] and not base["shard_picks"]
    d, hd, V = cfg.d_model, cfg.hd, cfg.vocab
    qkv = (f"fused[{cfg.n_heads * hd // 2}+{cfg.n_kv_heads * hd // 2}+"
           f"{cfg.n_kv_heads * hd // 2}]x{d}")
    for rank in ranks:
        st = rank[name]["stats"]
        assert _decisions(st) == _decisions(base)
        total = st["gemv_path"] + st["matmul_fallback"]
        assert sum(st["sharded_axes"].values()) == total
        picks = " ".join(st["shard_picks"])
        assert qkv in picks and f"@{V // 2}x{d}/2" in picks
        if cfg.moe is None:
            f = cfg.d_ff
            assert set(st["sharded_axes"]) == {"M", "K"}
            assert f"fused[{f // 2}+{f // 2}]x{d}" in picks
            assert f"@{d}x{f // 2}/2" in picks        # down: split-K
        else:
            E, fe = cfg.moe.n_experts, cfg.moe.d_expert
            assert "E" in st["sharded_axes"]
            assert f"ragged[{fe}]x{d}" in picks and f"_e{E // 2}_" in picks


def test_replicated_kv_runs_every_kv_head_and_the_ranks_query_heads(ranks):
    """One kv head (4 query heads over 1): the serving cache replicates
    KV; each rank computes the kv head and its own two query heads."""
    cfg = W.case_config("kv_replicated")
    assert cfg.n_kv_heads == 1
    picks = " ".join(ranks[0]["kv_replicated"]["stats"]["shard_picks"])
    hd = cfg.hd
    assert f"fused[{cfg.n_heads * hd // 2}+{hd}+{hd}]" in picks


def test_ranks_with_different_clocks_take_rank0s_decisions(ranks):
    """Rank 1's clock runs 1000 ahead (past every deadline): with rank 0's
    ``now`` broadcast each step both ranks preempt once, as the unsharded
    and the JAX engines do, and give their tokens."""
    base = unsharded("clocks")
    assert base["tokens"] == jax_tokens("clocks")
    assert base["counters"]["evicted"] == 1
    for rank in ranks:
        got = rank["clocks"]
        assert got["tokens"] == base["tokens"]
        assert got["counters"]["evicted"] == 1
        assert got["counters"]["expired"] == base["counters"]["expired"]


def test_every_rank_selects_from_rank0s_table_and_only_rank0_saves(ranks):
    """A calibration entry put on rank 0 alone prices every decision on
    every rank (the engine shares rank 0's table; the dispatcher issues no
    collective, so rank 0's tracer timing decisions no other rank meets
    deadlocks nothing), the ranks pick the same kernels, and only rank 0
    writes the table."""
    base = unsharded("olmo")
    for r, rank in enumerate(ranks):
        got = rank["tuned"]
        assert got["tokens"] == base["tokens"]
        sources = got["stats"]["cost_model_source"]
        assert sources.get("seed", 0) == 0 and sources["calibrated"] > 0
        assert got["wrote"] is got["file"] is (r == 0)
    assert ranks[0]["tuned"]["traced"] > 0
    assert ranks[0]["tuned"]["stats"]["shard_picks"] == \
        ranks[1]["tuned"]["stats"]["shard_picks"]


def test_gloo_ranks_run_eagerly_and_say_why(ranks):
    for rank in ranks:
        assert rank["olmo"]["graphs"] is None
        assert rank["olmo"]["graphs_reason"] == "not a CUDA device"
    assert [r["coords"] for r in ranks] == [{"data": 0, "model": 0},
                                            {"data": 0, "model": 1}]


def _reference_psum(method: str):
    """The reference's ``compressed_psum_mean`` over the same per-rank
    inputs, two rounds, under ``vmap`` with a named axis."""
    ins = [W.psum_inputs(r) for r in range(2)]
    ef, rounds = None, []
    for k in range(2):
        grads = {"w": np.stack([ins[r][k]["w"] for r in range(2)]),
                 "b": [np.stack([ins[r][k]["b"][0] for r in range(2)])]}
        if ef is None:
            mean, ef = jax.vmap(
                lambda g: jcoll.compressed_psum_mean(g, "i", method),
                axis_name="i")(grads)
        else:
            mean, ef = jax.vmap(
                lambda g, e: jcoll.compressed_psum_mean(g, "i", method, e),
                axis_name="i")(grads, ef)
        rounds.append((mean, ef))
    return rounds


@pytest.mark.parametrize("method", ["none", "bf16", "int8"])
def test_compressed_psum_mean_matches_the_reference(ranks, method):
    """Two rounds (the int8 residual carried), each rank's means and
    residuals against the reference's arithmetic, bit for bit."""
    want = _reference_psum(method)
    for r, rank in enumerate(ranks):
        for (mean, ef), (jmean, jef) in zip(rank["psum"][method], want):
            np.testing.assert_array_equal(mean["w"],
                                          np.asarray(jmean["w"])[r])
            np.testing.assert_array_equal(mean["b"],
                                          np.asarray(jmean["b"][0])[r])
            if method == "int8":
                np.testing.assert_array_equal(ef["w"],
                                              np.asarray(jef["w"])[r])
                np.testing.assert_array_equal(ef["b"],
                                              np.asarray(jef["b"][0])[r])
            else:
                assert ef is None


def test_a_2x2_mesh_gives_the_same_tokens():
    """Four ranks: 'data' 2 replicates the serving state (and the
    parameters), 'model' 2 shards it; every rank's tokens and rows are the
    unsharded engine's."""
    out = spawn(W.run_cases, (2, 2), device="cpu", args=(("olmo",),),
                timeout_s=SPAWN_TIMEOUT_S)
    base = unsharded("olmo")
    assert [r["coords"] for r in out] == [
        {"data": d, "model": m} for d in (0, 1) for m in (0, 1)]
    for rank in out:
        assert rank["olmo"]["tokens"] == base["tokens"]
        _rows_close(rank["olmo"]["rows"], base["rows"])


def test_a_rank_that_skips_a_collective_fails_the_spawn_in_time():
    t0 = time.monotonic()
    with pytest.raises((TimeoutError, RuntimeError)):
        spawn(W.skip_a_collective, (1, 2), device="cpu", timeout_s=8)
    assert time.monotonic() - t0 < 30


def test_a_one_process_mesh_is_the_unsharded_engine():
    """``single_device_mesh()`` (no process group): nothing is cut and no
    collective runs; the tokens and rows are the unsharded engine's, bit
    for bit, and the decisions are counted under 'replicated' nowhere
    (one shard)."""
    from repro_torch.launch.mesh import single_device_mesh

    got = W.serve("olmo", mesh=single_device_mesh(device="cpu"))
    base = unsharded("olmo")
    assert got["tokens"] == base["tokens"]
    for rid in base["rows"]:
        for a, b in zip(got["rows"][rid], base["rows"][rid]):
            np.testing.assert_array_equal(a, b)
    assert not got["stats"]["sharded_axes"]
    assert got["graphs_reason"] == "not a CUDA device"
