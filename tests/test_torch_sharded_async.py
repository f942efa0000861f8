"""``async_prefill`` and quantized weights on a mesh, over
``torch.distributed`` on the CPU: one (1, 2) gloo group, started by the
port's launcher (``launch.mesh.spawn``) on a thread when the module
starts, runs every case of ``_torch_mesh_workers.ASYNC_CASES`` and the
quantized rank blocks of ``QUANT_CASES`` while this process runs the JAX
engines.

Async on a mesh: reduced olmo-1b, deepseek-moe-16b, rwkv6-3b, hymba-1.5b
(perturbed) and whisper-small (gated) with ``Engine(async_prefill=True,
prefill_chunk=8, prefix_cache=True)``, each rank building its engine from
the whole tree.  The plan moves an in-flight chain in a compaction and
starts a chain from a prefix hit (a state snapshot for a recurrent
model); olmo-1b and hymba-1.5b also preempt an in-flight chain.  Each
rank's greedy tokens equal the unsharded JAX ``Engine(async_prefill=
True)``'s and the port's serial engine's; every sampled logits row is
within ``ROW_ATOL`` of the port's unsharded async engine (f32: the
sharded sums reassociate) and the same bits on both ranks; every issued
chunk is awaited, the same counts on both ranks.

Quantized rank blocks: int8 and int4 weights cut on M (columns of codes
and scales) and on K (whole 32-row scale blocks), dispatched with
``shard=``; the M outputs gathered and the K partials summed in f32 equal
the JAX ``quant_gemv_ref`` / ``quant4_gemv_ref`` of the whole weight
within ``QUANT_ATOL``; the picks and ``sharded_axes`` equal the JAX
dispatcher's under ``DispatchPolicy(model_shards=2)`` for the same keys;
a K cut that would split a scale block is not made.  About 45 s alone.
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
from repro.kernels import dispatch as jdispatch  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.backends import base as jbase  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro.serving.scheduler import SchedulerConfig as JaxSched  # noqa: E402
from repro_torch.bridge import params_to_numpy  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.kernels.ops import quantize_weight  # noqa: E402
from repro_torch.launch.mesh import Mesh, spawn  # noqa: E402

torch.set_num_threads(1)

SPAWN_TIMEOUT_S = 240
ROW_ATOL = 1e-4
# f32 x, codes and scales on both sides; the sums run in other orders
# (a K cut's two partials, then the all-reduce)
QUANT_ATOL = 1e-5
NAMES = tuple(W.ASYNC_CASES)
MODELS = ("olmo", "deepseek", "rwkv", "hymba", "whisper")


@pytest.fixture(scope="module", autouse=True)
def group():
    """The gloo group, started on a thread when the module starts: its
    ranks serve while this process runs the JAX engines."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        yield pool.submit(spawn, W.run_async_cases, (1, 2), device="cpu",
                          args=(NAMES,), timeout_s=SPAWN_TIMEOUT_S)


@pytest.fixture(scope="module")
def ranks(group):
    return group.result()


_PORT: dict = {}


def unsharded(name: str, async_prefill: bool = True) -> dict:
    """The port's engine without a mesh on the case's weights."""
    key = (name, async_prefill)
    if key not in _PORT:
        _PORT[key] = W.async_serve(name, async_prefill=async_prefill)
    return _PORT[key]


def jax_tokens(name: str) -> dict:
    """The JAX ``Engine(async_prefill=True)``'s greedy tokens on the
    case's weights."""
    arch, plan = W.ASYNC_CASES[name]
    tcfg = W.async_config(name)
    jcfg = ARCHS[arch].reduced()
    if arch == "whisper-small":
        jcfg = dataclasses.replace(jcfg, **W.mm_overrides(
            jcfg, W.MM_CASES["whisper"][1]))
    tree = jax.tree.map(jnp.asarray,
                        params_to_numpy(W.async_params(name), tcfg))
    clk = W.FakeClock()
    eng = JaxEngine(jcfg, tree, max_len=W.MAX_LEN, clock=clk,
                    scheduler=(JaxSched(**W.PREEMPT) if plan == "apreempt"
                               else "fcfs"),
                    **{**W.ASYNC_KW, **W.async_engine_kw(name)})
    reqs = W.drive(eng, JaxRequest, W.async_plan_of(name, tcfg.vocab), clk)
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


def _rank_mesh(coords) -> Mesh:
    return Mesh(shape={"data": 1, "model": 2}, rank=0, coords=dict(coords))


@pytest.mark.parametrize("name", NAMES)
def test_async_tokens_equal_the_jax_engine_and_rows_the_unsharded(
        request, name):
    base = unsharded(name)
    assert base["tokens"] == jax_tokens(name)
    assert base["tokens"] == unsharded(name, async_prefill=False)["tokens"]
    ranks = request.getfixturevalue("ranks")        # after the JAX engine
    for rank in ranks:
        got = rank[name]
        assert got["tokens"] == base["tokens"]
        _rows_close(got["rows"], base["rows"])
        assert got["counters"] == base["counters"]
        assert got["chains_moved"] == base["chains_moved"]
        assert got["evictions"] == base["evictions"]
    # every rank took the same host decisions: the same rows, bit for bit
    for a, b in zip(ranks[0][name]["rows"].values(),
                    ranks[1][name]["rows"].values()):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("name", NAMES)
def test_every_issued_chunk_is_awaited_alike_on_both_ranks(ranks, name):
    """Issued = awaited = the chunks the plan ran, nothing left in
    flight, the same counts on both ranks and unsharded; the chains ran
    their collectives on a 'model' group of their own."""
    want = unsharded(name)["overlap"]
    for rank in ranks:
        ap = rank[name]["overlap"]
        assert ap["issued"] == ap["awaited"] \
            == rank[name]["counters"]["prefill_chunks"] > 0
        assert ap["inflight"] == 0 and rank[name]["inflight"] == 0
        assert (ap["issued"], ap["awaited"]) == (want["issued"],
                                                 want["awaited"])
        assert rank[name]["chain_group"] is True
    assert ranks[0][name]["overlap"] == ranks[1][name]["overlap"]


@pytest.mark.parametrize("name", MODELS)
def test_chains_survive_a_compaction_and_start_from_a_prefix_hit(
        ranks, name):
    """The plan's compaction moves an in-flight chain with its slot, and
    the prefix hit's tail chains from the slot's spliced row: a recurrent
    model's from the snapshot's state blocks (not zeroed)."""
    for rank in ranks:
        got = rank[name]
        assert got["chains_moved"], name
        if name == "whisper":        # no prefix cache for the family
            assert not got["hit_chains"]
            continue
        assert got["counters"]["prefix_hits"] >= 1
        assert got["hit_chains"] and all(
            h["consumed"] == 20 and h["from_slot"]
            for h in got["hit_chains"])
        if name in ("rwkv", "hymba"):
            assert all(h["state_leaves"] > 0 and h["state_nonzero"]
                       for h in got["hit_chains"])


@pytest.mark.parametrize("name", ["olmo_preempt", "hymba_preempt"])
def test_a_preempted_chain_lands_before_its_slot_is_freed(ranks, name):
    for rank in ranks:
        assert rank[name]["evictions"][0] == 1
        assert rank[name]["counters"]["evicted"] == 1


@pytest.mark.parametrize("name", MODELS)
def test_each_ranks_sub_cache_rows_are_its_blocks(ranks, name):
    """The prefill sub-cache the chains run on holds each rank's block of
    every leaf (``slot_cache_spec``), as the slot cache does; at the end
    of the plan each slot-cache leaf is the rank's block of the unsharded
    engine's within the rows' tolerance."""
    base = unsharded(name)["cache"]
    cfg = W.async_config(name)
    for rank in ranks:
        m = _rank_mesh(rank["coords"])
        for leaf, whole in base.items():
            spec = shd.slot_cache_spec(m, cfg, tuple(whole.shape), leaf)
            want = shd.shard_tensor(whole, spec, m)
            # the sub-cache has a row more than the slots (row 0 stages
            # the chunks, row 1 + i a chain's): every other dim the same
            slots = 0 if whole.ndim == 1 else 1
            sub = list(rank[name]["sub"][leaf])
            assert sub.pop(slots) == whole.shape[slots] + 1, leaf
            assert sub == [d for i, d in enumerate(want.shape)
                           if i != slots], leaf
            torch.testing.assert_close(rank[name]["cache"][leaf], want,
                                       rtol=0, atol=ROW_ATOL, msg=leaf)


def _jax_whole(name: str) -> tuple:
    """The JAX oracle of case ``name``'s whole weight: the port's codes
    and scales (byte-equal to the JAX quantizer's)."""
    K, M, bits, _ = W.QUANT_CASES[name]
    w, x = W.quant_inputs(name)
    pw = quantize_weight(torch.from_numpy(w), bits=bits)
    codes = jnp.asarray(pw.w_t.numpy())
    scales = jnp.asarray(pw.scales.numpy())
    fn = jref.quant_gemv_ref if bits == 8 else jref.quant4_gemv_ref
    return np.asarray(fn(codes, scales, jnp.asarray(x), pw.block)), pw, x


@pytest.mark.parametrize("name", list(W.QUANT_CASES))
def test_quantized_rank_blocks_gather_or_sum_to_the_jax_reference(
        ranks, name):
    want, pw, _ = _jax_whole(name)
    K, M, bits, prefer = W.QUANT_CASES[name]
    for rank in ranks:
        got = rank["quant"][name]
        np.testing.assert_allclose(got["y"].numpy(), want, rtol=0,
                                   atol=QUANT_ATOL)
        assert got["equals_own"]
        if got["axis"] == "M":
            for y in got["fused"]:
                np.testing.assert_allclose(y.numpy(), want, rtol=0,
                                           atol=QUANT_ATOL)
    # every rank holds the same shapes: half the columns, or half the
    # scale blocks (int4: half the byte rows)
    axis = ranks[0]["quant"][name]["axis"]
    codes, scales = ranks[0]["quant"][name]["block_shape"]
    if axis == "M":
        assert codes == (pw.w_t.shape[0], M // 2)
        assert scales == (K // 32, M // 2)
    elif axis == "K":
        assert codes == (pw.w_t.shape[0] // 2, M)
        assert scales == (K // 64, M)
    else:
        assert (codes, scales) == (tuple(pw.w_t.shape),
                                   tuple(pw.scales.shape))


@pytest.mark.parametrize("name", [n for n, c in W.QUANT_CASES.items()
                                  if c[0] % 64 == 0])
def test_quantized_picks_equal_the_jax_dispatchers(ranks, name):
    """Where the reference's placement is the port's (M first, K on whole
    scale blocks), its per-shard pick of the whole weight's key equals
    the pick a rank counts for its block, in the same format, and the
    same ``sharded_axes``."""
    K, M, bits, _ = W.QUANT_CASES[name]
    jax_be = jbase.get_backend("cpu")
    jkey = jbase.GemvKey(M=M, K=K, batch=W.QUANT_B, bits=bits, block=32,
                         dtype="float32", backend="cpu")
    jdispatch.clear_plan_cache()
    jdispatch._resolve(jax_be, jkey, jdispatch.DispatchPolicy(
        model_shards=2, backend="cpu"))
    jstats = jdispatch.dispatch_stats()
    for rank in ranks:
        st = rank["quant"][name]["stats"]
        assert st["shard_picks"] == jstats["shard_picks"] != {}
        assert st["sharded_axes"] == jstats["sharded_axes"]
        assert st["kernel_picks"] == jstats["kernel_picks"]


@pytest.mark.parametrize("name", ["int8_K_to_M", "int4_whole"])
def test_a_k_cut_that_would_split_a_scale_block_is_not_made(ranks, name):
    """K 96 over 2 ranks would give each 48 rows, one and a half scale
    blocks: the placement takes M where the columns divide, else keeps
    the weight whole on every rank (the reference would cut K)."""
    K, M, bits, prefer = W.QUANT_CASES[name]
    w, _ = W.quant_inputs(name)
    pw = quantize_weight(torch.from_numpy(w), bits=bits)
    want = "M" if M % 2 == 0 else "replicated"
    assert shd.packed_axis(pw, 2, prefer) == want
    assert jbase.ShardedPlan.place(M, K, 2).axis == \
        ("M" if M % 2 == 0 else "K")
    for rank in ranks:
        assert rank["quant"][name]["axis"] == want
        assert rank["quant"][name]["stats"]["sharded_axes"] == {want: 1}
    # a float weight of the same shape takes the K cut
    assert shd.packed_axis(jops_float(w), 2, "K") == "K"


def jops_float(w: np.ndarray):
    """The float weight ``w [M, K]`` as the port's K-major PackedWeights."""
    from repro_torch.kernels.ops import pack_weight

    return pack_weight(torch.from_numpy(w))


@pytest.mark.parametrize("bits", [8, 4])
def test_a_fused_quantized_weight_is_cut_member_by_member(bits):
    """A fused weight's M cut (``wqkv``'s ``[q | k | v]``) is each
    member's block side by side, ``[q_r | k_r | v_r]``: the codes and
    scales of the rank's float block quantized on its own, bit for bit
    (whole columns keep their scales).  A member whose columns do not
    divide keeps the fused weight off M: its rows are cut on whole scale
    blocks instead."""
    rng = np.random.default_rng(bits)
    members = [torch.from_numpy(rng.standard_normal((m, 128)).astype(
        np.float32)) for m in (64, 32, 32)]
    pw = quantize_weight(torch.cat(members), bits=bits)
    for r in range(2):
        m = _rank_mesh({"data": 0, "model": r})
        block, axis = shd.shard_packed(pw, m, "M", (64, 32, 32))
        own = quantize_weight(torch.cat([w.chunk(2)[r] for w in members]),
                              bits=bits)
        assert axis == "M"
        assert torch.equal(block.w_t, own.w_t)
        assert torch.equal(block.scales, own.scales)
        block, axis = shd.shard_packed(pw, m, "M", (63, 33, 32))
        assert axis == "K" and block.shape == (64, 128)
        assert torch.equal(block.scales, pw.scales.chunk(2)[r])
