"""The port's quantized storage against the JAX package: int8 / packed-int4
weights through the dispatcher (``quant_gemv`` / ``quant4_gemv``) and int8
/ int4 KV pages through the engine.

Both packages get the same numpy inputs.  On the CPU the port's kernel
wrappers take their plain versions and the JAX side runs its Pallas
kernels in interpret mode, as tests/test_kernels.py does.  The CUDA
kernels themselves are held against the plain versions on the card in
tests/test_torch_gpu.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

# One intra-op thread: the suite runs in parallel worker processes, and
# these small CPU tensors gain nothing from more threads.
torch.set_num_threads(1)

# the machine with the card has no JAX: there this file skips
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import ARCHS
from repro.kernels import dispatch as jdispatch
from repro.kernels import kv_quant as jkv
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.backends import get_backend as jget_backend
from repro.kernels.quant_gemv import quant4_gemv as jax_quant4_gemv
from repro.kernels.quant_gemv import quant_gemv as jax_quant_gemv
from repro.kernels.tpu_plan import plan_tpu_gemv
from repro.models import lm as jlm
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro_torch.bridge import packed_from_numpy, params_from_numpy
from repro_torch.configs.registry import get_config
from repro_torch.kernels import dispatch, kv_quant, ref
from repro_torch.kernels.backends import DispatchPolicy
from repro_torch.kernels.backends.h100 import H100Backend
from repro_torch.kernels.gemv_plan import (
    SMEM_PER_CTA,
    plan_gemv,
    plan_quant,
    quant_applicable,
    quant_plan_fits,
    with_pipeline_depth,
)
from repro_torch.kernels.ops import (
    align_plan_to_block,
    pack_fused,
    pack_weight,
    quantize_weight,
)
from repro_torch.kernels.pim_gemv import pim_gemv
from repro_torch.kernels.quant_gemv import (
    quant4_gemv,
    quant4_gemv_plain,
    quant_gemv,
    quant_gemv_plain,
)
from repro_torch.models import lm
from repro_torch.serving.engine import Engine, Request

# as tests/test_torch_kernels.py: f32, both sides sum f32 products in other
# orders; bf16, the output is rounded to bf16 (8 significant bits)
TOL = {"float32": dict(rtol=1e-5, atol=1e-4),
       "bfloat16": dict(rtol=2e-2, atol=1e-2)}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
MAX_LEN = 64
OLMO_SHAPES = ((6144, 2048), (16384, 2048), (2048, 8192), (50304, 2048))


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _weight_with_edge_cases(M, K, seed=0):
    """[M, K] f32 with an all-zero block and exact rounding ties: column 1
    of block 0 has amax 127 (int8 scale 1.0) and holds 2.5, -3.5, 0.5;
    column 2 has amax 7 (int4 scale 1.0) and holds 2.5, -1.5, 4.5."""
    w = np.random.default_rng(seed).standard_normal((M, K)).astype(
        np.float32)
    w[0, :32] = 0.0
    w[1, :32] = 0.25
    w[1, :4] = (127.0, 2.5, -3.5, 0.5)
    w[2, :32] = 0.75
    w[2, :4] = (7.0, 2.5, -1.5, 4.5)
    return w


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("src", ["float32", "bfloat16"])
def test_quantize_weight_is_byte_equal_to_jax(bits, src):
    w = _weight_with_edge_cases(96, 128, seed=bits)
    if src == "bfloat16":
        w = np.asarray(jnp.asarray(w, jnp.bfloat16))
    jpw = jops.quantize_weight(w, bits=bits, block=32)
    tw = (torch.from_numpy(w) if src == "float32"
          else torch.from_numpy(np.array(w).view(np.uint16)).view(
              torch.bfloat16))
    pw = quantize_weight(tw, bits=bits, block=32)
    assert (pw.bits, pw.block, pw.shape) == (bits, 32, jpw.shape)
    assert pw.w_t.dtype == torch.int8 and pw.scales.dtype == torch.float32
    np.testing.assert_array_equal(pw.w_t.numpy(), np.asarray(jpw.w_t))
    np.testing.assert_array_equal(pw.scales.numpy().view(np.uint32),
                                  np.asarray(jpw.scales).view(np.uint32))
    assert pw.scales[0, 0] == 1.0                   # the all-zero block
    codes = ref.unpack_int4(pw.w_t) if bits == 4 else pw.w_t
    ties = [2, -4, 0] if bits == 8 else [2, -2, 4]  # half to even
    assert codes[1:4, 1 if bits == 8 else 2].tolist() == ties
    # a numpy input goes to the device asked for, with the same bytes
    pn = quantize_weight(w, bits=bits, block=32, device="cpu")
    assert torch.equal(pn.w_t, pw.w_t) and torch.equal(pn.scales, pw.scales)


def test_unpack_int4_matches_jax_with_leading_dims():
    packed = np.random.default_rng(1).integers(
        -128, 128, (3, 8, 16)).astype(np.int8)
    np.testing.assert_array_equal(
        ref.unpack_int4(torch.from_numpy(packed)).numpy(),
        np.asarray(jref.unpack_int4(jnp.asarray(packed))))


@pytest.mark.parametrize("M,K,B", [(256, 256, 1), (384, 512, 4),
                                   (128, 1024, 8), (256, 256, 11)])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_kernels_match_pallas(M, K, B, bits, dtype):
    rng = np.random.default_rng(M + K + B + bits)
    w = rng.standard_normal((M, K)).astype(np.float32)
    x = rng.standard_normal((B, K)).astype(np.float32)
    jpw = jops.quantize_weight(w, bits=bits, block=32)
    jplan = jops._align_plan_to_block(plan_tpu_gemv(M, K, B, w_bytes=1),
                                      M, K, B, jpw)
    jfn = jax_quant_gemv if bits == 8 else jax_quant4_gemv
    expect = jfn(jnp.asarray(x).astype(dtype), jpw.w_t, jpw.scales,
                 plan=jplan, block=32, interpret=True)
    pw = packed_from_numpy(np.asarray(jpw.w_t), np.asarray(jpw.scales),
                           bits, 32, device="cpu")
    tx = torch.from_numpy(x).to(TORCH_DT[dtype])
    plan = plan_quant(M, K, B, bits=bits, block=32)
    fn = quant_gemv if bits == 8 else quant4_gemv
    out = fn(tx, pw.w_t, pw.scales, block=32, plan=plan)
    assert out.dtype == tx.dtype and out.shape == (B, M)
    np.testing.assert_allclose(_np(out), _np(expect), **TOL[dtype])


def test_quant_plan_covers_whole_scale_blocks_and_fills_the_grid():
    for M, K in OLMO_SHAPES:
        for bits in (8, 4):
            p = plan_quant(M, K, 8, bits=bits, block=32, sms=132)
            k_part = K // p.split_k
            assert p.n_m == -(-M // p.m_blk) and p.n_k * p.k_blk == k_part
            # K parts and ring slots of whole scale blocks
            assert k_part % 32 == 0 and p.k_blk % 32 == 0
            assert p.m_blk in (128, 64) and p.split_k in (1, 2, 4, 8)
            # split and narrowed until the grid fills 132 SMs
            assert p.n_m * p.split_k >= 132
            assert p.smem_bytes <= SMEM_PER_CTA
            assert quant_plan_fits(p, M, K, 8, bits=bits, block=32)
    # no SM count (no card): one K part of 128-column blocks
    p = plan_quant(2048, 8192, 1, bits=8, block=32)
    assert p.m_blk == 128 and p.split_k == 1
    assert quant_applicable(2048, 8192, bits=4, block=32)
    assert not quant_applicable(2056 - 4, 8192, bits=8, block=32)  # M % 16
    assert not quant_applicable(2048, 8200, bits=8, block=32)      # K % 32
    # the aligned plan walks whole blocks (ops._align_plan_to_block)
    p = align_plan_to_block(plan_gemv(256, 96, 1, elem_bytes=1), 256, 96,
                            32)
    assert p.k_blk % 32 == 0 and 96 % p.k_blk == 0 and p.split_k == 1


def _block_factored(x, codes, scales, block):
    """The CUDA kernels' arithmetic in plain torch: per scale block b,
    ``s_b * sum_{k in b} q_k x_k`` in f32 (bf16 x bf16 products are exact
    in f32), the blocks added in K order, cast to x.dtype."""
    K, M = codes.shape
    xf = x.float().reshape(x.shape[0], K // block, block)
    qf = codes.float().reshape(K // block, block, M)
    acc = torch.zeros((x.shape[0], M), dtype=torch.float32)
    for b in range(K // block):
        acc = acc + scales[b].float() * (xf[:, b] @ qf[b])
    return acc.to(x.dtype)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,B", [(128, 256, 3), (256, 96, 8)])
def test_block_factored_sum_matches_pallas(M, K, B, bits, dtype):
    """The kernels take each scale out of its block (bf16 tensor-core
    products of the exact codes, then one f32 FMA a block); the reference
    multiplies q * s first.  The emulated block-factored sum holds against
    the JAX kernels in interpret mode within the kernels' tolerance, on
    codes that reach both ends of the range (int4: -8, which the quantizer
    never writes)."""
    rng = np.random.default_rng(M + K + B + bits)
    qmax = 127 if bits == 8 else 7
    codes = rng.integers(-qmax - 1, qmax + 1, (K, M)).astype(np.int8)
    codes[:2, 0] = (-qmax - 1, qmax)
    scales = rng.uniform(0.001, 0.05, (K // 32, M)).astype(np.float32)
    x = rng.standard_normal((B, K)).astype(np.float32)
    tx = torch.from_numpy(x).to(TORCH_DT[dtype])
    xj = jnp.asarray(x).astype(dtype)
    plan = jops._align_plan_to_block(plan_tpu_gemv(M, K, B, w_bytes=1), M,
                                     K, B, 32)
    if bits == 8:
        stored = codes
        expect = jax_quant_gemv(xj, jnp.asarray(codes), jnp.asarray(scales),
                                plan=plan, block=32, interpret=True)
    else:
        lo = codes[0::2].astype(np.int16) & 0xF
        hi = (codes[1::2].astype(np.int16) & 0xF) << 4
        stored = (hi | lo).astype(np.uint8).view(np.int8)
        unpacked = ref.unpack_int4(torch.from_numpy(stored)).numpy()
        assert np.array_equal(unpacked, codes)
        expect = jax_quant4_gemv(xj, jnp.asarray(stored),
                                 jnp.asarray(scales), plan=plan, block=32,
                                 interpret=True)
    got = _block_factored(tx, torch.from_numpy(codes),
                          torch.from_numpy(scales), 32)
    np.testing.assert_allclose(_np(got), _np(expect), **TOL[dtype])
    # and the plain twin the card holds the kernel against is the
    # reference's arithmetic
    plain = (quant_gemv_plain if bits == 8 else quant4_gemv_plain)(
        tx, torch.from_numpy(stored), torch.from_numpy(scales), 32)
    np.testing.assert_allclose(_np(plain), _np(expect), **TOL[dtype])


@pytest.mark.parametrize("bits", [8, 4])
def test_quant_plans_restage_and_stay_whole_blocks(bits):
    """Every ring depth the card holds is a plan of its own (an autotune
    candidate ``quant/s3``); restaging keeps the tiles, so the order of
    the sums."""
    be = H100Backend(min_parallel_blocks=132)
    for M, K in OLMO_SHAPES:
        base = plan_quant(M, K, 8, bits=bits, block=32, sms=132)
        depths = [d for d in range(1, 9) if with_pipeline_depth(
            base, d, batch=8, bits=bits, block=32) is not None]
        assert base.stages in depths and depths == list(
            range(1, len(depths) + 1))
        for d in depths:
            p = with_pipeline_depth(base, d, batch=8, bits=bits, block=32)
            assert (p.m_blk, p.k_blk, p.split_k) == (base.m_blk, base.k_blk,
                                                     base.split_k)
            assert quant_plan_fits(p, M, K, 8, bits=bits, block=32)
        key = dispatch.GemvKey(M=M, K=K, batch=8, bits=bits, block=32,
                               dtype="torch.bfloat16", backend="h100")
        labels = [be.candidate_label(*c)
                  for c in be.autotune_candidates(key, None, DispatchPolicy())]
        kname = "quant" if bits == 8 else "quant4"
        assert labels[0] == "ref" and labels[1] == f"{kname}/s{base.stages}"
        assert sorted(labels[1:]) == sorted(f"{kname}/s{d}" for d in depths)


def test_quant_wrappers_raise_on_bad_inputs_and_count_no_cpu_launch():
    pw = quantize_weight(torch.randn(256, 512), bits=8)
    x = torch.randn(2, 512)
    plan = plan_quant(256, 512, 2, bits=8, block=32)
    before = (quant_gemv.launches, quant4_gemv.launches)
    out = quant_gemv(x, pw.w_t, pw.scales, block=32, plan=plan)
    torch.testing.assert_close(
        out, quant_gemv_plain(x, pw.w_t, pw.scales, 32), rtol=0, atol=0)
    with pytest.raises(ValueError, match="contiguous"):
        quant_gemv(x, pw.w_t.t().contiguous().t(), pw.scales, block=32,
                   plan=plan)
    with pytest.raises(TypeError):
        quant_gemv(x, pw.w_t.float(), pw.scales, block=32, plan=plan)
    with pytest.raises(ValueError, match="scales"):
        quant_gemv(x, pw.w_t, pw.scales[:-1], block=32, plan=plan)
    with pytest.raises(ValueError, match="K"):
        quant4_gemv(x, pw.w_t, pw.scales, block=32, plan=plan)
    with pytest.raises(ValueError, match="tile"):
        quant_gemv(x, pw.w_t, pw.scales, block=32,
                   plan=plan_quant(128, 512, 2, bits=8, block=32))
    p4 = quantize_weight(torch.randn(256, 512), bits=4)
    out = quant4_gemv(x, p4.w_t, p4.scales, block=32, plan=plan)
    torch.testing.assert_close(
        out, quant4_gemv_plain(x, p4.w_t, p4.scales, 32), rtol=0, atol=0)
    assert (quant_gemv.launches, quant4_gemv.launches) == before


@pytest.mark.parametrize("B", [1, 4, 8, 16])
@pytest.mark.parametrize("bits", [8, 4])
def test_h100_picks_quant_wherever_the_tpu_backend_does(B, bits):
    """Quantized weights take the quant kernel whatever the batch gate
    says, as on the TPU backend (above 8 rows the port's wrapper launches
    row chunks), and every kernel pin but ``ref`` resolves to it."""
    be = H100Backend(min_parallel_blocks=132)
    tpu = jget_backend("tpu")
    for M, K in OLMO_SHAPES:
        mine = be.select_kernel(M, K, B, bits=bits, block=32)
        theirs = tpu.select_kernel(M, K, B, bits=bits, block=32)
        assert mine[0] == theirs[0] == ("quant" if bits == 8 else "quant4")
        assert mine[1].n_m * mine[1].m_blk == M
        for pin in ("ref", "pim", "splitk", "quant", "quant4"):
            got = be.select_kernel(M, K, B, bits=bits, block=32,
                                   policy=DispatchPolicy(kernel=pin))[0]
            want = tpu.select_kernel(
                M, K, B, bits=bits, block=32,
                policy=jdispatch.DispatchPolicy(kernel=pin))[0]
            assert got == want, (M, K, pin)


def test_quant_pins_on_float_weights_and_int4_tuples_are_refused():
    be = H100Backend(min_parallel_blocks=132)
    for pin in ("quant", "quant4"):
        with pytest.raises(ValueError, match="int8/int4"):
            be.select_kernel(2048, 8192, 1,
                             policy=DispatchPolicy(kernel=pin))
        with pytest.raises(ValueError, match="int8/int4"):
            jget_backend("tpu").select_kernel(
                2048, 8192, 1, policy=jdispatch.DispatchPolicy(kernel=pin))
    w = np.random.default_rng(2).standard_normal((128, 256)).astype(
        np.float32)
    p8, p4 = (quantize_weight(torch.from_numpy(w), bits=b) for b in (8, 4))
    got = dispatch.as_packed((p8.w_t, p8.scales))
    assert (got.bits, got.block) == (8, 32) and got.w_t is p8.w_t
    # nibble-packed codes in tuple form are ambiguous: refused
    with pytest.raises(ValueError, match="int8"):
        dispatch.as_packed((p4.w_t.view(torch.uint8), p4.scales))
    with pytest.raises(ValueError, match="int8"):
        jdispatch.as_packed((jnp.asarray(p4.w_t.view(torch.uint8).numpy()),
                             jnp.asarray(p4.scales.numpy())))
    with pytest.raises(ValueError, match="tile"):
        dispatch.as_packed((p8.w_t, p8.scales[:, :-1]))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 256)).astype(np.float32))
    torch.testing.assert_close(
        dispatch.dispatch_gemv(x, (p8.w_t, p8.scales)),
        dispatch.dispatch_gemv(x, p8), rtol=0, atol=0)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_fused_and_prepacked_programs_match_jax(bits):
    """QKV-like members quantized once, fused with their scales
    concatenated along M; the prepacked program slices codes and scales
    per member when it runs unfused."""
    rng = np.random.default_rng(bits)
    K, Ms, B = 256, (256, 128, 128), 3
    ws = [rng.standard_normal((m, K)).astype(np.float32) for m in Ms]
    x = rng.standard_normal((B, K)).astype(np.float32)
    jmembers = [jops.quantize_weight(w, bits=bits, block=32) for w in ws]
    expect = jdispatch.dispatch_fused(
        jnp.asarray(x), jmembers,
        policy=jdispatch.DispatchPolicy(backend="cpu"))
    members = [packed_from_numpy(np.asarray(p.w_t), np.asarray(p.scales),
                                 bits, 32, device="cpu") for p in jmembers]
    fused, splits = pack_fused(members)
    assert fused.shape == (K, sum(Ms)) and splits == Ms
    np.testing.assert_array_equal(
        fused.scales.numpy(),
        np.concatenate([np.asarray(p.scales) for p in jmembers], axis=1))
    tx = torch.from_numpy(x)
    kernel = "quant" if bits == 8 else "quant4"
    dispatch.clear_plan_cache()
    for policy in (None, DispatchPolicy(fuse_programs=False),
                   DispatchPolicy(backend="h100")):
        outs = [dispatch.dispatch_fused(tx, members, policy=policy),
                dispatch.dispatch_prepacked(tx, fused, splits,
                                            policy=policy)]
        for out in outs:
            for o, e in zip(out, expect):
                np.testing.assert_allclose(o.numpy(), np.asarray(e),
                                           **TOL["float32"])
    stats = dispatch.dispatch_stats()
    assert stats["program_kernels"] == {f"cpu:{kernel}": 1,
                                        f"h100:{kernel}": 1}
    assert stats["kernel_picks"] == {f"cpu:{kernel}": 2}   # 256- and 128-
    assert stats["program_modes"]["cpu:per_request"] == 1  # wide members


@pytest.mark.parametrize("bits,kernel", [(16, "pim"), (16, "splitk"),
                                         (8, "auto"), (4, "auto")])
def test_per_request_programs_hand_the_kernels_column_views(bits, kernel):
    """With fusing off, ``dispatch_prepacked`` gives each member a column
    view of the prepacked weight (codes and scales).  The h100 backend's
    wrappers take the row stride instead of refusing the view: the checks
    are the ones a launch on the card passes first, and on CPU tensors
    the plain versions then run on the same views."""
    rng = np.random.default_rng(bits)
    K, Ms, B = 256, (256, 128, 128), 3
    ws = [torch.from_numpy(rng.standard_normal((m, K)).astype(np.float32))
          for m in Ms]
    x = torch.from_numpy(rng.standard_normal((B, K)).astype(np.float32))
    members = [quantize_weight(w, bits=bits) if bits < 16
               else pack_weight(w) for w in ws]
    fused, splits = pack_fused(members)
    expect = dispatch.dispatch_prepacked(x, fused, splits)   # cpu, fused
    dispatch.clear_plan_cache()
    got = dispatch.dispatch_prepacked(
        x, fused, splits, policy=DispatchPolicy(
            backend="h100", kernel=kernel, min_pallas_bytes=0,
            fuse_programs=False))
    for o, e in zip(got, expect):
        np.testing.assert_allclose(o.numpy(), e.numpy(), **TOL["float32"])
    stats = dispatch.dispatch_stats()
    want = kernel if bits == 16 else ("quant" if bits == 8 else "quant4")
    assert stats["kernel_picks"] == {f"h100:{want}": 2}   # 256-, 128-wide
    assert stats["program_modes"] == {"h100:per_request": 1}
    # a view whose rows do not start on 16-byte boundaries is refused
    view = fused.columns(2, 130)
    with pytest.raises(ValueError, match="16-byte"):
        if bits == 16:
            pim_gemv(x, view.w_t, plan=plan_gemv(128, K, B, elem_bytes=4))
        else:
            (quant_gemv if bits == 8 else quant4_gemv)(
                x, view.w_t, view.scales, block=32,
                plan=plan_quant(128, K, B, bits=bits, block=32))


@pytest.mark.parametrize("bits", [8, 4])
def test_quant_applies_at_m_multiples_of_16_where_the_tpu_gate_does_not(
        bits):
    """The one deliberate selection difference on quantized weights: the
    CUDA quant kernels need M % 16 (one 16-byte code vector), the TPU
    backend's Pallas gate M % 128.  At M % 128 != 0 the h100 backend
    still picks the quant kernel and the TPU backend falls back to its
    dequant oracle (same function); below M % 16 both fall back."""
    be, tpu = H100Backend(min_parallel_blocks=132), jget_backend("tpu")
    want = "quant" if bits == 8 else "quant4"
    for M, K in ((2064, 2048), (1040, 4096), (48, 256)):
        for B in (1, 8, 16):
            kernel, plan = be.select_kernel(M, K, B, bits=bits, block=32)
            # the last column block may be ragged (the copy engine
            # zero-fills past M)
            assert kernel == want and plan.n_m == -(-M // plan.m_blk)
            assert tpu.select_kernel(M, K, B, bits=bits, block=32)[0] == "ref"
            assert be.select_kernel(M - 8, K, B, bits=bits, block=32)[0] == \
                tpu.select_kernel(M - 8, K, B, bits=bits, block=32)[0] == "ref"
    # and the port's quant path there computes the JAX package's function
    w = _weight_with_edge_cases(48, 256, seed=bits)
    x = np.random.default_rng(bits).standard_normal((5, 256)).astype(
        np.float32)
    jp = jops.quantize_weight(w, bits=bits, block=32)
    expect = jdispatch.dispatch_gemv(
        jnp.asarray(x), jp, policy=jdispatch.DispatchPolicy(backend="tpu"))
    tp = packed_from_numpy(np.asarray(jp.w_t), np.asarray(jp.scales), bits,
                           32, device="cpu")
    got = dispatch.dispatch_gemv(torch.from_numpy(x), tp,
                                 policy=DispatchPolicy(backend="h100"))
    np.testing.assert_allclose(got.numpy(), np.asarray(expect),
                               **TOL["float32"])


@pytest.mark.parametrize("bits", [8, 4])
def test_kv_codec_is_byte_equal_to_jax(bits):
    rng = np.random.default_rng(bits)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    x[0, 1, 2] = 0.0                        # an all-zero page
    x[1, 0, 0, :4] = (127.0, 2.5, -3.5, 0.5)    # ties at scale 1.0 (int8)
    x[1, 0, 1, :4] = (7.0, 2.5, -1.5, 4.5)      # ties at scale 1.0 (int4)
    x = np.asarray(jnp.asarray(x, jnp.bfloat16))
    jq, js = jkv.quantize_page(jnp.asarray(x), bits)
    tx = torch.from_numpy(np.array(x).view(np.uint16)).view(torch.bfloat16)
    q, s = kv_quant.quantize_page(tx, bits)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy().view(np.uint32),
                                  np.asarray(js).view(np.uint32))
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        y = kv_quant.dequantize_page(q, s, hd=16, out_dtype=dt)
        jy = jkv.dequantize_page(jq, js, hd=16, out_dtype=jdt)
        np.testing.assert_array_equal(_np(y), _np(jy))
    # the per-page error bound of the absmax codec: amax / (2 qmax)
    qmax = 127.0 if bits == 8 else 7.0
    y = kv_quant.dequantize_page(q, s, hd=16, out_dtype=torch.float32)
    bound = tx.float().abs().amax(-1, keepdim=True) / (2 * qmax) + 1e-6
    assert ((y - tx.float()).abs() <= bound).all()


def _cfgs(**overrides):
    jcfg = dataclasses.replace(ARCHS["olmo-1b"].reduced(), **overrides)
    tcfg = dataclasses.replace(get_config("olmo-1b").reduced(), **overrides)
    return jcfg, tcfg


@pytest.mark.parametrize("store", ["fp", "int8", "int4"])
def test_init_cache_leaves_match_jax(store):
    jcfg, tcfg = _cfgs()
    jc = jlm.init_cache(jcfg, 3, 16, per_slot_pos=True, kv_store=store)
    tc = lm.init_cache(tcfg, 3, 16, per_slot_pos=True, kv_store=store,
                       device="cpu")
    assert sorted(tc) == sorted(jc)
    for name, leaf in tc.items():
        assert tuple(leaf.shape) == jc[name].shape, name
        assert str(leaf.dtype).removeprefix("torch.") == \
            str(jc[name].dtype), name
        np.testing.assert_array_equal(_np(leaf), _np(jc[name]))
    with pytest.raises(ValueError, match="kv_store"):
        lm.init_cache(tcfg, 1, 16, kv_store="int2", device="cpu")


def test_int8_kv_fits_double_the_slots():
    """As tests/test_prefix_cache.py asserts for the JAX package: the int8
    store's per-slot KV bytes (pages + scales) are at most half the fp
    store's, and int4 is smaller still."""
    _, tcfg = _cfgs()

    def kv_bytes(store):
        cache = lm.init_cache(tcfg, 1, MAX_LEN, per_slot_pos=True,
                              kv_store=store, device="cpu")
        return kv_quant.tree_bytes({n: v for n, v in cache.items()
                                    if n != "pos"})

    fp, i8, i4 = kv_bytes("fp"), kv_bytes("int8"), kv_bytes("int4")
    assert i8 * 2 <= fp, (i8, fp)
    assert i4 < i8


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = _cfgs()
    jparams = jlm.init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                "cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.mark.parametrize("store", ["int8", "int4"])
def test_engine_quantized_kv_token_identical_to_jax(models, store):
    """The mixed-length scenario of tests/test_torch_model.py under a
    quantized KV store: greedy tokens equal the JAX Engine's with the same
    store, request by request."""
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab, n).astype(np.int32)
               for n in (5, 9, 3, 12, 7)]
    jeng = JaxEngine(jcfg, jparams, batch_slots=4, max_len=MAX_LEN,
                     kv_store=store)
    teng = Engine(tcfg, tparams, batch_slots=4, max_len=MAX_LEN,
                  kv_store=store, device="cpu")
    for i, p in enumerate(prompts):
        jeng.submit(JaxRequest(rid=i, prompt=p, max_new_tokens=6))
        teng.submit(Request(rid=i, prompt=p, max_new_tokens=6))
    jdone = {r.rid: r.generated for r in jeng.run_until_drained()}
    tdone = {r.rid: r.generated for r in teng.run_until_drained()}
    assert sorted(tdone) == list(range(5))
    assert tdone == jdone
    assert teng.kv.cache["k"].dtype == torch.int8
    assert set(teng.kv.cache) == {"pos", "k", "v", "k_scale", "v_scale"}
    with pytest.raises(ValueError, match="kv_store"):
        Engine(tcfg, tparams, kv_store="fp8", device="cpu")


def test_quantized_kv_decode_logits_match_jax(models):
    """One prefill and one decode step through an int8 cache: logits and
    the stored codes and scales agree with the JAX forward (f32)."""
    jcfg, jparams, tcfg, tparams = models
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 7))
    toks = toks.astype(np.int32)
    jc = jlm.init_cache(jcfg, 2, 16, per_slot_pos=True, kv_store="int8")
    tc = lm.init_cache(tcfg, 2, 16, per_slot_pos=True, kv_store="int8",
                       device="cpu")
    for step in range(2):
        jl, jc, _ = jlm.forward(jparams, jcfg, jnp.asarray(toks), cache=jc)
        tl, tc, _ = lm.forward(tparams, tcfg, torch.from_numpy(toks).long(),
                               cache=tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=0, err_msg=f"step {step}")
        toks = np.array(jl[:, -1:].argmax(-1), np.int32)
    for name in ("k_scale", "v_scale"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   rtol=1e-5, atol=0)
    # codes round the same f32 values: at most one step apart where the
    # two forwards' K/V differ in the last bits
    assert np.abs(tc["k"].numpy().astype(int)
                  - np.asarray(jc["k"]).astype(int)).max() <= 1
