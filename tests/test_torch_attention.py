"""Decode attention: the plain version against the JAX package's
``attention_core`` (with and without a sliding window), the model's
routing rule, and the split planner.

The kernel (``csrc/decode_attention.cu``) runs only on the card; its tests
are in ``test_torch_gpu.py``.  Here both packages get the same numpy
inputs on the CPU.
"""

import math

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

# the machine with the card has no JAX: there this file skips
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import kv_quant as jkv  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.kernels import attention  # noqa: E402
from repro_torch.kernels.attention import (  # noqa: E402
    SPLITS,
    decode_attention,
    decode_attention_plain,
    kernel_applies,
    plan_splits,
    smem_bytes,
    stage_positions,
)
from repro_torch.kernels.gemv_plan import SMEM_PER_CTA  # noqa: E402
from repro_torch.kernels.kv_quant import (  # noqa: E402
    dequantize_page,
    quantize_page,
)
from repro_torch.models import layers as L  # noqa: E402

SMS = 132


def _case(B, C, Hkv, G, D, valid, seed=0):
    """q [B, 1, H, D], k / v [B, C, Hkv, D] (numpy f32), and each slot's
    q position (valid - 1, as a decode step writes its token at pos and
    attends to pos + 1 positions)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, Hkv * G, D)).astype(np.float32)
    k = rng.standard_normal((B, C, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, C, Hkv, D)).astype(np.float32)
    valid = np.asarray(valid, np.int32)
    return q, k, v, valid - 1, valid


def _tol(dtype, v):
    # f32: the score, softmax and P.V sums run in other orders than XLA's.
    # bf16: the output is rounded once (one bf16 ulp, relative 2**-7), and
    # a probability whose f32 value sits at a bf16 rounding boundary may
    # round one ulp (2**-8 relative) the other way on either side, moving
    # the output by up to 2**-8 * max|v|.
    if dtype == torch.float32:
        return dict(rtol=1e-5, atol=1e-5)
    return dict(rtol=2.0**-7, atol=2.0**-8 * float(np.abs(v).max()))


# reduced olmo-1b (4 heads of 16, one kv head each), a GQA case (G = 2),
# and olmo-1b's head shape at full width (16 kv heads of 128)
CASES = {
    "olmo_reduced": (3, 64, 4, 1, 16),
    "gqa_g2": (3, 40, 2, 2, 32),
    "olmo_heads": (3, 48, 16, 1, 128),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_attention_matches_jax(case, dtype):
    """Valid lengths 1, 17 and C, one slot each."""
    B, C, Hkv, G, D = CASES[case]
    q, k, v, qpos, valid = _case(B, C, Hkv, G, D, [1, 17, C],
                                 seed=len(case))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jlayers.attention_core(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        q_positions=jnp.asarray(qpos[:, None]),
        kv_valid_len=jnp.asarray(valid), window=None, causal=True)

    def t(a):
        return torch.from_numpy(a).to(dtype)

    got = decode_attention_plain(
        t(q), t(k), t(v), q_positions=torch.from_numpy(qpos[:, None]),
        kv_valid_len=torch.from_numpy(valid))
    assert got.dtype == dtype and got.shape == q.shape
    # the reference's values, rounded as it rounds them
    vr = np.asarray(jnp.asarray(v, jdt).astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **_tol(dtype, vr))
    # the wrapper on CPU tensors is the plain version, and launches nothing
    n0 = decode_attention.launches
    same = decode_attention(t(q), t(k), t(v),
                            q_positions=torch.from_numpy(qpos[:, None]),
                            kv_valid_len=torch.from_numpy(valid))
    assert torch.equal(same, got) and decode_attention.launches == n0
    # the model's attention_core: the same function on the CPU
    assert torch.equal(L.attention_core(
        t(q), t(k), t(v), q_positions=torch.from_numpy(qpos[:, None]),
        kv_valid_len=torch.from_numpy(valid), causal=True), got)


def test_idle_slots_past_the_end_attend_to_every_position():
    """An idle slot of the decode bucket carries an offset past C: the
    reference masks nothing there, and neither does the plain version."""
    B, C, Hkv, G, D = 2, 24, 2, 1, 16
    q, k, v, _, _ = _case(B, C, Hkv, G, D, [C, C], seed=9)
    qpos = np.array([C + 5, 3], np.int32)
    valid = qpos + 1
    want = jlayers.attention_core(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_positions=jnp.asarray(qpos[:, None]),
        kv_valid_len=jnp.asarray(valid), window=None, causal=True)
    got = decode_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        q_positions=torch.from_numpy(qpos[:, None]),
        kv_valid_len=torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# sliding windows: none (0), one position, the reduced gemma3 window (8),
# and one longer than the cache
WINDOW_C = 24


@pytest.mark.parametrize("window", [0, 1, 8, WINDOW_C + 5])
@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_attention_with_a_window_matches_jax(window, G, dtype):
    """A local layer's decode step: valid lengths below (4), at (8) and
    above (16) a window of 8, the whole cache, an idle slot past the end
    inside its last window, and one past C + window - 1 whose every
    score is masked (uniform over C, as the reference's softmax gives);
    against the JAX ``attention_core`` with the same window."""
    B, C, Hkv, D = 6, WINDOW_C, 2, 16
    qpos = np.array([3, 7, 15, C - 1, C + 2, C + window + 2], np.int32)
    q, k, v, _, _ = _case(B, C, Hkv, G, D, [C] * B, seed=window + 10 * G)
    valid = qpos + 1
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jlayers.attention_core(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        q_positions=jnp.asarray(qpos[:, None]),
        kv_valid_len=jnp.asarray(valid), window=window, causal=True)

    def t(a):
        return torch.from_numpy(a).to(dtype)

    args = dict(q_positions=torch.from_numpy(qpos[:, None]),
                kv_valid_len=torch.from_numpy(valid))
    got = decode_attention_plain(t(q), t(k), t(v), window=window, **args)
    vr = np.asarray(jnp.asarray(v, jdt).astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **_tol(dtype, vr))
    # the wrapper on CPU tensors and the model's attention_core are the
    # same function
    assert torch.equal(decode_attention(t(q), t(k), t(v), window=window,
                                        **args), got)
    assert torch.equal(L.attention_core(t(q), t(k), t(v), causal=True,
                                        window=window, **args), got)
    if 0 < window <= 8:
        # the slot past the end of every window attends uniformly
        uniform = t(v)[-1].float().mean(0)
        np.testing.assert_allclose(
            got[-1, 0].float().numpy(),
            np.repeat(uniform.numpy(), G, axis=0), **_tol(dtype, vr))
    if 0 < window < 16:
        # a row longer than the window: the window changes its output
        full = decode_attention_plain(t(q), t(k), t(v), **args)
        assert not torch.equal(full[2], got[2])
    elif window > C:
        # a window longer than the cache masks only the slot past its end
        full = decode_attention_plain(t(q), t(k), t(v), **args)
        assert torch.equal(full[:-1], got[:-1])


def test_prefill_with_a_window_matches_jax():
    """A prefill chunk of 12 queries at positions 5..16 over a cache of 24
    (the chunked seam) with a window of 8, G 4: the JAX mask."""
    B, C, Hkv, G, D, S = 2, 24, 1, 4, 16, 12
    rng = np.random.default_rng(3)
    q = rng.standard_normal((B, S, Hkv * G, D)).astype(np.float32)
    k = rng.standard_normal((B, C, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, C, Hkv, D)).astype(np.float32)
    pos = (np.array([5, 0])[:, None] + np.arange(S)[None]).astype(np.int32)
    valid = pos[:, -1] + 1
    want = jlayers.attention_core(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_positions=jnp.asarray(pos), kv_valid_len=jnp.asarray(valid),
        window=8, causal=True)
    got = L.attention_core(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v),
                           q_positions=torch.from_numpy(pos),
                           kv_valid_len=torch.from_numpy(valid),
                           causal=True, window=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_pages_take_the_window(bits):
    """int8 / int4 pages with a window of 8: the wrapper on the CPU
    dequantizes, then runs the windowed plain arithmetic."""
    B, C, Hkv, G, D = 3, 32, 1, 4, 128
    q, k, v, qpos, valid = _case(B, C, Hkv, G, D, [5, 20, 32], seed=bits)
    tq = torch.from_numpy(q).to(torch.bfloat16)
    kc, ks = quantize_page(torch.from_numpy(k).to(torch.bfloat16), bits)
    vc, vs = quantize_page(torch.from_numpy(v).to(torch.bfloat16), bits)
    args = dict(q_positions=torch.from_numpy(qpos[:, None]),
                kv_valid_len=torch.from_numpy(valid), window=8)
    got = decode_attention(tq, kc, vc, k_scale=ks, v_scale=vs, **args)
    kf = dequantize_page(kc, ks, hd=D, out_dtype=torch.bfloat16)
    vf = dequantize_page(vc, vs, hd=D, out_dtype=torch.bfloat16)
    assert torch.equal(got, decode_attention_plain(tq, kf, vf, **args))
    with pytest.raises(ValueError, match="window"):
        decode_attention(tq, kf, vf, q_positions=args["q_positions"],
                         kv_valid_len=None, window=-1)


def test_the_routing_rule_is_on_shapes_and_the_device():
    """The CPU never routes to the kernel; prefill (Sq > 1), non-causal
    calls and shapes the kernel is not built for never do either."""
    q = torch.zeros(2, 1, 4, 128, dtype=torch.bfloat16)
    k = torch.zeros(2, 64, 4, 128, dtype=torch.bfloat16)
    assert not kernel_applies(q, k, k, causal=True)       # a CPU tensor
    rule = attention._shape_rule
    assert rule(q, k, k) == ""
    assert "one token" in rule(torch.zeros(2, 3, 4, 128,
                                           dtype=torch.bfloat16), k, k)
    assert "share" in rule(q, k.float(), k.float())
    assert "query heads" in rule(torch.zeros(2, 1, 12, 128,
                                             dtype=torch.bfloat16), k, k)
    assert "head dim" in rule(torch.zeros(2, 1, 4, 96, dtype=torch.bfloat16),
                              torch.zeros(2, 64, 4, 96, dtype=torch.bfloat16),
                              torch.zeros(2, 64, 4, 96,
                                          dtype=torch.bfloat16))
    every_other = torch.zeros(2, 64, 4, 256, dtype=torch.bfloat16)[..., ::2]
    assert "contiguous" in rule(q, every_other, every_other)
    # a slot-prefix view of the cache (slots further apart) is fine
    wide = torch.zeros(8, 64, 4, 128, dtype=torch.bfloat16)
    assert rule(q, wide[:2], wide[:2]) == ""
    with pytest.raises(ValueError, match="one token"):
        decode_attention(torch.zeros(2, 3, 4, 128), k.float(), k.float(),
                         q_positions=torch.zeros(2, 3, dtype=torch.int64),
                         kv_valid_len=None)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_pages_route_to_the_kernel_only_on_the_card(bits):
    """int8 codes of D lanes (int8) or D / 2 (packed int4) with f32 scales
    [B, C, Hkv] pass the shape rule; the CPU still takes the plain path
    (dequantize_page, then the plain arithmetic) and launches nothing."""
    B, C, Hkv, G, D = 2, 64, 4, 1, 128
    q, k, v, qpos, valid = _case(B, C, Hkv, G, D, [17, 64], seed=bits)
    tq = torch.from_numpy(q).to(torch.bfloat16)
    kc, ks = quantize_page(torch.from_numpy(k).to(torch.bfloat16), bits)
    vc, vs = quantize_page(torch.from_numpy(v).to(torch.bfloat16), bits)
    assert kc.shape[-1] == (D if bits == 8 else D // 2)
    rule = attention._shape_rule
    assert rule(tq, kc, vc, ks, vs) == ""
    assert not kernel_applies(tq, kc, vc, causal=True, k_scale=ks,
                              v_scale=vs)                  # a CPU tensor
    assert rule(tq, kc, vc) != ""                          # no scales
    assert "quantized" in rule(tq, kc, vc, ks.double(), vs.double())
    assert "quantized" in rule(tq, kc.float(), vc.float(), ks, vs)
    assert "quantized" in rule(tq, kc, vc, ks[:, :-1], vs[:, :-1])
    n0 = decode_attention.launches
    tpos = torch.from_numpy(qpos[:, None])
    tvalid = torch.from_numpy(valid)
    got = decode_attention(tq, kc, vc, q_positions=tpos,
                           kv_valid_len=tvalid, k_scale=ks, v_scale=vs)
    kf = dequantize_page(kc, ks, hd=D, out_dtype=torch.bfloat16)
    vf = dequantize_page(vc, vs, hd=D, out_dtype=torch.bfloat16)
    plain = decode_attention_plain(tq, kf, vf, q_positions=tpos,
                                   kv_valid_len=tvalid)
    assert torch.equal(got, plain) and decode_attention.launches == n0
    assert torch.equal(L.attention_core(
        tq, kc, vc, q_positions=tpos, kv_valid_len=tvalid, causal=True,
        k_scale=ks, v_scale=vs), plain)
    # the JAX package's attention over its own dequantized pages
    jq = jnp.asarray(tq.float().numpy()).astype(jnp.bfloat16)
    jk, jv = (jkv.dequantize_page(jnp.asarray(c.numpy()),
                                  jnp.asarray(sc.numpy()), hd=D,
                                  out_dtype=jnp.bfloat16)
              for c, sc in ((kc, ks), (vc, vs)))
    want = jlayers.attention_core(
        jq, jk, jv, q_positions=jnp.asarray(qpos[:, None]),
        kv_valid_len=jnp.asarray(valid), window=None, causal=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               **_tol(torch.bfloat16, vf.float().numpy()))


@pytest.mark.parametrize("B,Hkv,C,G,D", [
    (8, 16, 1024, 1, 128),      # olmo-1b / deepseek-moe-16b at 8 slots
    (2, 16, 1024, 1, 128),      # a bucket of 2
    (1, 16, 1024, 1, 128),      # one slot (the grouped MoE engine)
    (4, 4, 64, 1, 16),          # reduced olmo-1b
    (8, 8, 32768, 8, 128),      # a long GQA cache
    (2, 2, 16, 2, 32),
])
def test_split_planner_rules(B, Hkv, C, G, D):
    s = plan_splits(B, Hkv, C, G, D, SMS)
    assert s in SPLITS
    assert smem_bytes(G, D, C, s) <= SMEM_PER_CTA
    # the fewest splits that put four CTAs on every SM, unless the cache is
    # too short to split that far or a split's scores need more
    fill = next((x for x in SPLITS if B * Hkv * x >= 4 * SMS), SPLITS[-1])
    short = max(x for x in SPLITS if x <= max(1, C // 64))
    want = min(fill, short)
    fits = [x for x in SPLITS if x >= want
            and smem_bytes(G, D, C, x) <= SMEM_PER_CTA]
    assert s == fits[0]
    if s > want:
        assert smem_bytes(G, D, C, want) > SMEM_PER_CTA


def test_split_planner_refuses_what_no_split_holds():
    # 8 splits of 2^20 positions for 8 heads cannot hold their scores
    assert plan_splits(1, 1, 2**20, 8, 128, SMS) is None
    assert smem_bytes(8, 128, 2**20, 8) > SMEM_PER_CTA
    # the f32 scores, the ranks' shares of the output, the warps'
    # partials, the scratch and every rank's max and sum; then 96 staged
    # bf16 V rows of 256 bytes (24 KB)
    assert math.isclose(smem_bytes(1, 128, 1024, 4),
                        16 * -(-4 * (256 + 128 + 8 + 4 * 128 + 4 + 16)
                               // 16)
                        + 96 * 256)


@pytest.mark.parametrize("D,C,splits,elem,bits,stage", [
    (128, 1024, 8, 2, 16, 96),      # olmo-1b at 8 splits: 24 KB of 128 rows
    (128, 1024, 1, 2, 16, 96),      # one split of 1024: chunks of 96
    (128, 1024, 2, 4, 16, 48),      # f32: walk steps of 16, 512-byte rows
    (128, 40, 8, 2, 16, 32),        # 5 positions: one walk step of 32
    (128, 200, 8, 4, 16, 32),       # 25 positions: two f32 steps of 16
    (32, 64, 2, 2, 16, 128),        # 2 lanes a position: steps of 128
    (128, 1024, 8, 2, 8, 128),      # int8 codes and scales: 132-byte rows
    (128, 4096, 8, 2, 4, 352),      # int4: 68-byte rows, 11 steps fit
])
def test_staged_v_rows_are_whole_walk_steps(D, C, splits, elem, bits,
                                             stage):
    """A CTA stages its split's V rows, at most the whole steps of the P.V
    walk (4 warps x 32 / lanes positions x 4 vectors in flight) that fit
    STAGE_BYTES, at least one step: a chunked walk visits positions in the
    order of one walk."""
    got = stage_positions(D, C, splits, elem, bits)
    assert got == stage
    lanes = D // (16 // elem)
    step = attention.WARPS * (32 // lanes) * attention.UNROLL
    assert got % step == 0
    row = D * elem if bits == 16 else D * bits // 8 + 4
    assert got * row <= attention.STAGE_BYTES or got == step
    assert got >= min(-(-C // splits), attention.STAGE_BYTES // row - step)


@pytest.mark.parametrize("bits,rows,row", [(16, 96, 256), (8, 128, 132),
                                           (4, 128, 68)])
def test_smem_counts_the_staged_v_of_each_store(bits, rows, row):
    """bf16 pages stage 256 bytes a position (96 of 128 fit 24 KB); int8 /
    int4 codes stage 128 / 64 bytes and one f32 scale (all 128); the
    planner takes more splits where the staging does not fit."""
    floats = 16 * -(-4 * (128 + 128 + 8 + 4 * 128 + 4 + 16) // 16)
    assert smem_bytes(1, 128, 1024, 8, bits=bits) == floats + rows * row
    # one split of 6144 positions for 8 heads: its f32 scores fit shared
    # memory, but not beside 24 KB of staged rows, so two splits
    args = (64, 16, 6144, 8, 128, SMS)
    assert 4 * (8 * 6144 + 8 * 128 * 5 + 8 + 32 + 128) <= SMEM_PER_CTA
    assert smem_bytes(8, 128, 6144, 1, bits=bits) > SMEM_PER_CTA
    assert plan_splits(*args, bits=bits) == 2


# grok-1-314b's head grouping, G 6: 12 query heads over 2 (reduced), a
# rank's 24 over 4 on a (1, 2) mesh, and the whole model's 48 over 8
G6_LAYOUTS = {"g6_reduced": (2, 16), "g6_rank": (4, 128),
              "g6_full": (8, 16)}


@pytest.mark.parametrize("layout", sorted(G6_LAYOUTS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_attention_at_g6_matches_jax(layout, dtype):
    """Valid lengths 1, 17 and C against the JAX ``attention_core`` at
    grok's groups of 6; the wrapper on CPU tensors and the model's
    ``attention_core`` are the same function."""
    Hkv, D = G6_LAYOUTS[layout]
    B, C = 3, 40
    q, k, v, qpos, valid = _case(B, C, Hkv, 6, D, [1, 17, C], seed=Hkv)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jlayers.attention_core(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        q_positions=jnp.asarray(qpos[:, None]),
        kv_valid_len=jnp.asarray(valid), window=None, causal=True)

    def t(a):
        return torch.from_numpy(a).to(dtype)

    args = dict(q_positions=torch.from_numpy(qpos[:, None]),
                kv_valid_len=torch.from_numpy(valid))
    got = decode_attention_plain(t(q), t(k), t(v), **args)
    vr = np.asarray(jnp.asarray(v, jdt).astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **_tol(dtype, vr))
    assert torch.equal(decode_attention(t(q), t(k), t(v), **args), got)
    assert torch.equal(L.attention_core(t(q), t(k), t(v), causal=True,
                                        **args), got)


def test_the_routing_rule_takes_groks_groups_of_6():
    """At grok's decode shapes (8 kv heads of 128, and a rank's 4; G 6,
    bf16) the shape rule passes and the split planner fits a 1024-position
    cache at every bucket."""
    for Hkv in (8, 4):
        for B in (1, 2, 4, 8):
            q = torch.zeros((B, 1, 6 * Hkv, 128), dtype=torch.bfloat16)
            kv = torch.zeros((B, 1024, Hkv, 128), dtype=torch.bfloat16)
            assert attention._shape_rule(q, kv, kv) == ""
            s = attention.plan_splits(B, Hkv, 1024, 6, 128, SMS)
            assert s in attention.SPLITS
            assert attention.smem_bytes(6, 128, 1024, s) <= SMEM_PER_CTA
    assert 6 in attention.GROUPS
