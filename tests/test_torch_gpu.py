"""The port on the card: tests that need a CUDA device.

This file imports nothing of JAX, so it runs on the machine with the card
(``python -m pytest -m gpu tests/test_torch_*.py``); here every test skips
inside its fixture.
"""

import contextlib

import pytest
import torch

from repro_torch.kernels.gemv_plan import (
    MAX_STAGES,
    SPLITK_DEGREES,
    plan_gemv,
    plan_splitk,
    stream_smem,
    valid_splitk_degree,
    with_pipeline_depth,
)
from repro_torch.kernels.pim_gemv import pim_gemv, pim_gemv_plain
from repro_torch.kernels.splitk_gemv import splitk_gemv, splitk_gemv_plain


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("M,K", [(6144, 2048), (2048, 8192), (50304, 2048),
                                 (768, 256)])
@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_kernels_match_plain(cuda, M, K, B, dtype):
    g = torch.Generator(device=cuda).manual_seed(M + K + B)
    w_t = torch.randn((K, M), generator=g, device=cuda).to(dtype)
    x = torch.randn((B, K), generator=g, device=cuda).to(dtype)
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 else \
        dict(rtol=1e-4, atol=1e-3)
    n0 = pim_gemv.launches
    out = pim_gemv(x, w_t, plan=plan_gemv(M, K, B,
                                          elem_bytes=x.element_size()))
    torch.cuda.synchronize()
    assert pim_gemv.launches == n0 + 1
    torch.testing.assert_close(out.float(), pim_gemv_plain(x, w_t).float(),
                               **tol)
    deg = valid_splitk_degree(K)
    out = splitk_gemv(x, w_t, plan=plan_splitk(M, K, B, degree=deg,
                                               elem_bytes=x.element_size()))
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(),
                               splitk_gemv_plain(x, w_t, deg).float(), **tol)


# the streaming kernels (csrc/gemv_stream.cuh): olmo-1b's four decode
# GEMVs, and ragged edges: M = 8 mod 16 (a ragged last column block) and
# K parts of 24 rows (not whole k16 sub-tiles)
STREAM_SHAPES = [(6144, 2048), (16384, 2048), (2048, 8192), (50304, 2048),
                 (200, 48), (72, 96)]


def _stream_case(cuda, M, K, B, dtype, seed=0):
    g = torch.Generator(device=cuda).manual_seed(M + K + B + seed)
    w_t = (torch.randn((K, M), generator=g, device=cuda) / K ** 0.5).to(dtype)
    x = torch.randn((B, K), generator=g, device=cuda).to(dtype)
    return x, w_t


def _degrees(K):
    return [d for d in SPLITK_DEGREES if K % d == 0 and (K // d) % 8 == 0]


def _stream_tol(dtype):
    # the kernels and the plain versions sum f32 products in other orders;
    # bf16 output: one bf16 ulp (2^-7 relative) plus f32 noise near zero
    return (dict(rtol=2.0**-7, atol=1e-3) if dtype == torch.bfloat16
            else dict(rtol=1e-5, atol=1e-5))


@pytest.mark.gpu
@pytest.mark.parametrize("M,K", STREAM_SHAPES)
@pytest.mark.parametrize("B", range(1, 9))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_stream_kernels_match_plain_at_every_batch(cuda, M, K, B, dtype):
    """pim_gemv, and splitk_gemv at every degree that splits K, against
    their plain versions at the planner's default depth."""
    x, w_t = _stream_case(cuda, M, K, B, dtype)
    es = x.element_size()
    n0 = pim_gemv.launches
    out = pim_gemv(x, w_t, plan=plan_gemv(M, K, B, elem_bytes=es))
    torch.cuda.synchronize()
    assert pim_gemv.launches == n0 + 1 and out.shape == (B, M)
    torch.testing.assert_close(out.float(), pim_gemv_plain(x, w_t).float(),
                               **_stream_tol(dtype))
    assert _degrees(K)
    for deg in _degrees(K):
        n0 = splitk_gemv.launches
        out = splitk_gemv(x, w_t, plan=plan_splitk(M, K, B, degree=deg,
                                                   elem_bytes=es))
        torch.cuda.synchronize()
        assert splitk_gemv.launches == n0 + 1
        torch.testing.assert_close(
            out.float(), splitk_gemv_plain(x, w_t, deg).float(),
            **_stream_tol(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("M,K", STREAM_SHAPES)
@pytest.mark.parametrize("B", [3, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_stream_kernels_are_bit_identical_at_every_depth(cuda, M, K, B,
                                                         dtype):
    """The ring depth changes the copies in flight, never the order of
    the sums: every depth the planner admits gives the default's bits."""
    x, w_t = _stream_case(cuda, M, K, B, dtype, seed=1)
    es = x.element_size()
    plans = [(pim_gemv, plan_gemv(M, K, B, elem_bytes=es))] + [
        (splitk_gemv, plan_splitk(M, K, B, degree=d, elem_bytes=es))
        for d in _degrees(K)]
    for fn, base in plans:
        want = fn(x, w_t, plan=base)
        depths = 0
        for depth in range(1, MAX_STAGES + 1):
            p = with_pipeline_depth(base, depth, batch=B, elem_bytes=es)
            if p is None:
                continue
            depths += 1
            assert torch.equal(fn(x, w_t, plan=p), want), (fn, p)
        assert depths >= min(base.n_k, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("M,K", [(6144, 2048), (200, 48)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_stream_kernels_read_a_column_view_in_place(cuda, M, K, dtype):
    """A column slice of a wider weight (rows 3M apart) gives the
    contiguous copy's result bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(5)
    wide = torch.randn((K, 3 * M), generator=g, device=cuda).to(dtype)
    view = wide[:, M:2 * M]
    x = torch.randn((8, K), generator=g, device=cuda).to(dtype)
    es = x.element_size()
    deg = _degrees(K)[0]
    for fn, plan in ((pim_gemv, plan_gemv(M, K, 8, elem_bytes=es)),
                     (splitk_gemv, plan_splitk(M, K, 8, degree=deg,
                                               elem_bytes=es))):
        assert torch.equal(fn(x, view, plan=plan),
                           fn(x, view.contiguous(), plan=plan))


@pytest.mark.gpu
def test_planner_shared_memory_equals_the_kernels(cuda):
    """The plan's smem_bytes (the wrappers' fit check) is what the
    kernels ask for at launch."""
    from repro_torch.kernels import _build

    fn = _build.load("pim_gemv").gemv_stream_smem_bytes
    for B in range(1, 9):
        for m_blk in (64, 128):
            for es in (2, 4):
                for ks in (16, 32, 64, 128):
                    for stages in (1, 3, 8):
                        for deg in (1, 8):
                            assert fn(B, m_blk, ks, stages, es, deg) == \
                                stream_smem(B, m_blk, ks, stages, es, deg)


def _small(device):
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.models import lm

    cfg = dataclasses.replace(get_config("olmo-1b").reduced(), d_model=256,
                              n_heads=2, n_kv_heads=2, head_dim=128,
                              d_ff=512, vocab=512)
    params = lm.init_lm(cfg, seed=0, device="cpu")
    moved = {"embed": params["embed"].to(device), "ln_f": {},
             "layers": [{k: {n: t.to(device) for n, t in v.items()}
                         for k, v in p.items()} for p in params["layers"]]}
    return cfg, params, moved


@pytest.mark.gpu
@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("kernel", ["pim", "splitk"])
def test_decode_step_through_each_cuda_kernel_matches_cpu(cuda, kernel,
                                                          fuse):
    """f32 decode step with the kernel pinned: CUDA kernels vs the CPU
    run of the same weights (plain versions)."""
    from repro_torch.kernels.backends import DispatchPolicy
    from repro_torch.models import lm

    cfg, cpu_params, gpu_params = _small(cuda)
    pol = DispatchPolicy(backend="h100", min_pallas_bytes=0, kernel=kernel,
                         fuse_programs=fuse)
    toks = torch.randint(0, cfg.vocab, (4, 6),
                         generator=torch.Generator().manual_seed(1))
    out = {}
    for dev, params in (("cpu", cpu_params), (cuda, gpu_params)):
        cache = lm.init_cache(cfg, 4, 16, per_slot_pos=True, device=dev)
        _, cache, _ = lm.forward(params, cfg, toks.to(dev), cache=cache)
        n0 = (pim_gemv.launches, splitk_gemv.launches)
        logits, _, _ = lm.forward(lm.prepack_decode_params(params, cfg), cfg,
                                  toks[:, -1:].to(dev), cache=cache,
                                  gemv_policy=pol)
        out[str(dev)] = logits.float().cpu()
        launched = (pim_gemv.launches - n0[0], splitk_gemv.launches - n0[1])
    torch.cuda.synchronize()
    # per layer QKV, gate+up (fused programs) and down, then the head;
    # unfused, QKV is an einsum and gate, up and down are single GEMVs
    n = 3 * cfg.n_layers + 1
    assert launched == ((n, 0) if kernel == "pim" else (0, n))
    torch.testing.assert_close(out["cuda"], out["cpu"], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.gpu
def test_engine_on_the_card_matches_the_cpu_engine(cuda):
    import numpy as np

    from repro_torch.serving.engine import Engine, Request

    cfg, cpu_params, gpu_params = _small(cuda)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (5, 9, 3, 12, 7)]
    done = {}
    for dev, params in (("cpu", cpu_params), ("cuda", gpu_params)):
        eng = Engine(cfg, params, batch_slots=4, max_len=64, device=dev)
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=6))
        done[dev] = {r.rid: r.generated for r in eng.run_until_drained()}
    assert done["cuda"] == done["cpu"]


# --------------------------------------------------------------------------
# quantized weights and KV pages
# --------------------------------------------------------------------------


def _quant_case(cuda, M, K, B, bits, dtype, wide=1):
    """x [B, K] and the codes / scales of a seeded bf16 weight [M, K]; with
    ``wide`` > 1 a column view of a prepacked weight that many times as
    wide (rows ldw bytes apart), starting at column M."""
    from repro_torch.kernels.ops import quantize_weight

    g = torch.Generator(device=cuda).manual_seed(M + K + B + bits)
    w = torch.randn((M * wide, K), generator=g, device=cuda).to(
        torch.bfloat16)
    x = torch.randn((B, K), generator=g, device=cuda).to(dtype)
    pw = quantize_weight(w, bits=bits, block=32)
    assert pw.w_t.device == w.device
    if wide == 1:
        return x, pw.w_t, pw.scales
    return x, pw.w_t[:, M:2 * M], pw.scales[:, M:2 * M]


def _quant_fns(bits):
    from repro_torch.kernels.quant_gemv import (
        quant4_gemv,
        quant4_gemv_plain,
        quant_gemv,
        quant_gemv_plain,
    )

    return ((quant_gemv, quant_gemv_plain) if bits == 8
            else (quant4_gemv, quant4_gemv_plain))


def _quant_tol(dtype):
    # sums in other orders (the kernels factor each scale out of its
    # block); bf16 output: one bf16 ulp (2^-7 relative) plus f32 noise
    return (_stream_tol(dtype) if dtype == torch.bfloat16
            else dict(rtol=1e-4, atol=1e-3))


# olmo-1b's four decode GEMVs, a small one, and a ragged last column block
QUANT_SHAPES = [(6144, 2048), (16384, 2048), (2048, 8192), (50304, 2048),
                (768, 256), (2064, 2048)]


@pytest.mark.gpu
@pytest.mark.parametrize("M,K", QUANT_SHAPES)
@pytest.mark.parametrize("B", [1, 8, 11, 64])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_quant_kernels_match_plain(cuda, M, K, B, bits, dtype):
    """The streaming quant kernels (codes and scales through one TMA ring,
    bf16 on the tensor cores with each scale block factored out) against
    the plain version (dequantize, f32 product), at the plan for 132 SMs
    (split-K clusters where it splits) and at one K part."""
    from repro_torch.kernels.gemv_plan import plan_quant

    x, w_q, scales = _quant_case(cuda, M, K, B, bits, dtype)
    fn, plain = _quant_fns(bits)
    tol = _quant_tol(dtype)
    want = plain(x, w_q, scales, 32).float()
    for sms in (132, None):
        plan = plan_quant(M, K, B, bits=bits, block=32,
                          elem_bytes=x.element_size(), sms=sms)
        n0 = fn.launches
        out = fn(x, w_q, scales, block=32, plan=plan)
        torch.cuda.synchronize()
        assert fn.launches == n0 + 1
        torch.testing.assert_close(out.float(), want, **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("M,K", [(6144, 2048), (2064, 2048)])
@pytest.mark.parametrize("B", [1, 11])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_quant_kernels_read_a_column_view_in_place(cuda, M, K, B, bits,
                                                        dtype):
    """A member of a prepacked weight: codes and scales whose rows lie a
    wider weight's stride apart give the contiguous result bit for bit."""
    from repro_torch.kernels.gemv_plan import plan_quant

    x, w_q, scales = _quant_case(cuda, M, K, B, bits, dtype, wide=3)
    assert w_q.stride(0) == 3 * M
    fn, plain = _quant_fns(bits)
    plan = plan_quant(M, K, B, bits=bits, block=32,
                      elem_bytes=x.element_size(), sms=132)
    out = fn(x, w_q, scales, block=32, plan=plan)
    assert torch.equal(out, fn(x, w_q.contiguous(), scales.contiguous(),
                               block=32, plan=plan))
    torch.testing.assert_close(
        out.float(), plain(x, w_q, scales, 32).float(), **_quant_tol(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("M,K", [(6144, 2048), (2048, 8192), (2064, 2048)])
@pytest.mark.parametrize("B", [3, 8, 64])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_quant_kernels_are_bit_identical_at_every_depth(cuda, M, K, B,
                                                             bits, dtype):
    """The ring depth changes the copies in flight, never the order of the
    sums: every depth the card holds gives the default depth's bits."""
    from repro_torch.kernels.gemv_plan import plan_quant

    x, w_q, scales = _quant_case(cuda, M, K, B, bits, dtype)
    fn, _ = _quant_fns(bits)
    base = plan_quant(M, K, B, bits=bits, block=32,
                      elem_bytes=x.element_size(), sms=132)
    want = fn(x, w_q, scales, block=32, plan=base)
    depths = []
    for depth in range(1, MAX_STAGES + 1):
        plan = with_pipeline_depth(base, depth, batch=B,
                                   elem_bytes=x.element_size(), bits=bits,
                                   block=32)
        if plan is None:
            continue
        depths.append(depth)
        assert torch.equal(fn(x, w_q, scales, block=32, plan=plan), want), \
            depth
    assert base.stages in depths and len(depths) >= 2


@pytest.mark.gpu
def test_quant_planner_shared_memory_equals_the_kernels(cuda):
    """The quant plan's smem_bytes (the wrappers' fit check) is what the
    kernels ask for at launch."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.gemv_plan import quant_smem

    fn = _build.load("quant_gemv").quant_gemv_smem_bytes
    for B in (1, 3, 8, 64):
        for m_blk in (64, 128):
            for es in (2, 4):
                for bits in (8, 4):
                    for k_blk in (32, 128, 256):
                        for stages in (1, 2, 8):
                            for deg in (1, 4):
                                assert fn(B, m_blk, k_blk, stages, es, deg,
                                          bits, 32) == quant_smem(
                                    B, m_blk, k_blk, stages, es, deg, bits,
                                    32)


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [8, 4])
def test_card_quantizers_are_byte_equal_to_the_cpu(cuda, bits):
    """The CPU quantizers are byte-equal to the JAX package's
    (test_torch_quant.py); on the card they must give the same bytes."""
    from repro_torch.kernels.kv_quant import quantize_page
    from repro_torch.kernels.ops import quantize_weight

    g = torch.Generator().manual_seed(bits)
    w = torch.randn((2048, 8192), generator=g).to(torch.bfloat16)
    on_card = quantize_weight(w.to(cuda), bits=bits)
    on_host = quantize_weight(w, bits=bits)
    assert torch.equal(on_card.w_t.cpu(), on_host.w_t)
    assert torch.equal(on_card.scales.cpu(), on_host.scales)
    kv = torch.randn((4, 64, 16, 128), generator=g).to(torch.bfloat16)
    for a, b in zip(quantize_page(kv.to(cuda), bits), quantize_page(kv, bits)):
        assert torch.equal(a.cpu(), b)


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [8, 4])
def test_dispatched_quantized_program_matches_the_cpu_backend(cuda, bits):
    """A fused QKV-like program over quantized members: the h100 backend's
    quant kernel on the card against the cpu backend's dequant oracle."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.ops import pack_fused, quantize_weight
    from repro_torch.kernels.quant_gemv import quant4_gemv, quant_gemv

    g = torch.Generator().manual_seed(bits)
    K, Ms = 512, (512, 256, 256)
    members = [quantize_weight(torch.randn((m, K), generator=g), bits=bits)
               for m in Ms]
    fused, splits = pack_fused(members)
    x = torch.randn((4, K), generator=g)
    want = dispatch.dispatch_prepacked(x, fused, splits)
    on_card = type(fused)(w_t=fused.w_t.to(cuda), scales=fused.scales.to(
        cuda), bits=bits, block=32)
    fn = quant_gemv if bits == 8 else quant4_gemv
    n0 = fn.launches
    got = dispatch.dispatch_prepacked(x.to(cuda), on_card, splits)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1
    for a, b in zip(got, want):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("bits,kernel", [(16, "pim"), (16, "splitk"),
                                         (8, "auto"), (4, "auto")])
def test_per_request_programs_on_column_views_match_the_cpu_backend(
        cuda, bits, kernel):
    """Fusing off: each member of a prepacked program runs its own kernel
    on a column view of the fused weight (row stride wider than its M),
    with no copy, and agrees with the cpu backend's fused result.  The
    float kernels are pinned: at these small shapes the cost model would
    send the members to ``torch.matmul``."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.backends import DispatchPolicy
    from repro_torch.kernels.ops import (
        pack_fused,
        pack_weight,
        quantize_weight,
    )
    from repro_torch.kernels.quant_gemv import quant4_gemv, quant_gemv

    g = torch.Generator().manual_seed(bits)
    K, Ms = 512, (512, 256, 256)
    ws = [torch.randn((m, K), generator=g) for m in Ms]
    members = [quantize_weight(w, bits=bits) if bits < 16 else pack_weight(w)
               for w in ws]
    fused, splits = pack_fused(members)
    x = torch.randn((4, K), generator=g)
    want = dispatch.dispatch_prepacked(x, fused, splits)
    on_card = type(fused)(
        w_t=fused.w_t.to(cuda),
        scales=None if bits == 16 else fused.scales.to(cuda),
        bits=bits, block=32)
    fn = {"pim": pim_gemv, "splitk": splitk_gemv}.get(
        kernel, quant_gemv if bits == 8 else quant4_gemv)
    n0 = fn.launches
    got = dispatch.dispatch_prepacked(
        x.to(cuda), on_card, splits,
        policy=DispatchPolicy(kernel=kernel, min_pallas_bytes=0,
                              fuse_programs=False))
    torch.cuda.synchronize()
    assert fn.launches == n0 + len(Ms)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-3)


@pytest.mark.gpu
def test_int8_kv_engine_on_the_card_matches_the_cpu_engine(cuda):
    import numpy as np

    from repro_torch.serving.engine import Engine, Request

    cfg, cpu_params, gpu_params = _small(cuda)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (5, 9, 3, 12, 7)]
    done = {}
    for dev, params in (("cpu", cpu_params), ("cuda", gpu_params)):
        eng = Engine(cfg, params, batch_slots=4, max_len=64, device=dev,
                     kv_store="int8")
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=6))
        done[dev] = {r.rid: r.generated for r in eng.run_until_drained()}
        assert eng.kv.cache["k"].dtype == torch.int8
    assert done["cuda"] == done["cpu"]


# --------------------------------------------------------------------------
# MoE expert kernels (deepseek-moe-16b shapes) and the MoE engine
# --------------------------------------------------------------------------

MOE_E = 64


def _expert_offsets(case: str) -> tuple[int, list[int]]:
    """(T, offsets [65]) of one ragged case: chip_smoke.py's four routings
    (a top-6 routing of 8 tokens, of 1 token, every token on expert 0,
    counts short of T: tail rows), 20 and 72 rows on one expert (row
    chunks past the 32 rows one bf16 walk holds), every count zero (only the
    tail), offsets that are not monotone or lie outside [0, T] (the
    clamp: overlapping ranges, the last expert's rows win), and T = 0."""
    import numpy as np

    rng = np.random.default_rng(len(case))

    def route(n, force=None):
        top = np.stack([rng.permutation(MOE_E)[:6] for _ in range(n)])
        if force is not None:
            for row in top:
                if force not in row:
                    row[-1] = force
        return np.bincount(top.reshape(-1), minlength=MOE_E).tolist()

    def offsets(counts):
        return np.concatenate([[0], np.cumsum(counts)]).tolist()

    if case == "top6_b8":
        return 48, offsets(route(8))
    if case == "top6_b1":
        return 6, offsets(route(1))
    if case == "skewed":
        return 48, offsets(route(8, force=0))
    if case == "tail_rows":
        return 48, offsets(route(6))
    if case == "one_expert_20_rows":
        return 20, offsets([0] * 7 + [20] + [0] * (MOE_E - 8))
    if case == "one_expert_72_rows":
        return 72, offsets([0] * 3 + [72] + [0] * (MOE_E - 4))
    if case == "all_zero":
        return 48, [0] * (MOE_E + 1)
    if case == "not_monotone":
        offs = offsets(route(4))          # 24 routed rows
        offs[10] -= 5                     # expert 10 starts inside 9's rows
        offs[20] = -3                     # clamped to 0
        offs[30] = 100                    # clamped to T = 30
        return 30, offs
    return 0, [0] * (MOE_E + 1)


RAGGED_CASES = ["top6_b8", "top6_b1", "skewed", "tail_rows",
                "one_expert_20_rows", "one_expert_72_rows", "all_zero",
                "not_monotone", "empty"]


def _ragged_case(cuda, K, M, case, dtype, E=MOE_E):
    T, offs = _expert_offsets(case)
    g = torch.Generator(device=cuda).manual_seed(K + T)
    w = (torch.randn((E, K, M), generator=g, device=cuda)
         / K ** 0.5).to(dtype)
    x = torch.randn((T, K), generator=g, device=cuda).to(dtype)
    return x, torch.tensor(offs, dtype=torch.int32, device=cuda), w


def _held_rows(offsets, T):
    """Rows some expert's clamped range [off[e], max(off[e+1], off[e]))
    holds: every other row comes back zero."""
    offs = [min(max(o, 0), T) for o in offsets.tolist()]
    held = torch.zeros(T, dtype=torch.bool)
    for lo, nx in zip(offs, offs[1:]):
        held[lo:max(nx, lo)] = True
    return held


def _bf16_tol(dtype):
    # one bf16 ulp of the result (relative 2**-7) plus f32 order noise near
    # zero; f32: order noise only
    return (dict(rtol=2.0**-7, atol=1e-3) if dtype == torch.bfloat16
            else dict(rtol=1e-5, atol=1e-4))


@pytest.mark.gpu
@pytest.mark.parametrize("K,M", [(2048, 1408), (1408, 2048)])
@pytest.mark.parametrize("case", RAGGED_CASES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_ragged_gemv_matches_plain(cuda, K, M, case, dtype):
    """At the plan for the card's SMs: equal to the plain version within
    the tolerance, equal from run to run, rows no expert holds zero."""
    from repro_torch.kernels.gemv_plan import plan_ragged_stream
    from repro_torch.kernels.grouped_gemv import ragged_gemv, ragged_gemv_plain

    x, offsets, w = _ragged_case(cuda, K, M, case, dtype)
    T = x.shape[0]
    plan = plan_ragged_stream(M, K, max(T, 1), E=MOE_E,
                              elem_bytes=x.element_size())
    n0 = ragged_gemv.launches
    out = ragged_gemv(x, offsets, w, plan=plan)
    torch.cuda.synchronize()
    assert ragged_gemv.launches == n0 + (1 if T else 0)
    assert out.shape == (T, M)
    if not T:
        return
    torch.testing.assert_close(out.float(),
                               ragged_gemv_plain(x, offsets, w).float(),
                               **_bf16_tol(dtype))
    assert not out[~_held_rows(offsets, T).to(cuda)].any()
    assert torch.equal(out, ragged_gemv(x, offsets, w, plan=plan))


@pytest.mark.gpu
@pytest.mark.parametrize("K,M", [(2048, 1408), (1408, 2048)])
@pytest.mark.parametrize("case", ["top6_b1", "top6_b8", "one_expert_72_rows",
                                  "not_monotone"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_ragged_gemv_at_every_split_degree(cuda, K, M, case, dtype):
    """Every split degree the planner can choose (1, 2, 4, 8 K parts of
    whole 8-row groups) at both column blocks: within the tolerance of
    the plain version (the parts' sums meet in another order)."""
    from repro_torch.kernels.gemv_plan import (
        RAGGED_DEGREES,
        STREAM_M_BLKS,
        GemvPlan,
        ragged_box_rows,
        ragged_plan_fits,
        stream_smem,
        sub_rows,
    )
    from repro_torch.kernels.grouped_gemv import ragged_gemv, ragged_gemv_plain

    x, offsets, w = _ragged_case(cuda, K, M, case, dtype)
    T, es = x.shape[0], x.element_size()
    want = ragged_gemv_plain(x, offsets, w).float()
    ran = 0
    for deg in RAGGED_DEGREES:
        if K % deg or (K // deg) % 8:
            continue
        for m_blk in STREAM_M_BLKS:
            k_blk = sub_rows(m_blk, K // deg, es)
            n_k = -(-(K // deg) // k_blk)
            plan = GemvPlan(m_blk=m_blk, k_blk=k_blk, n_m=-(-M // m_blk),
                            n_k=n_k, split_k=deg, stages=min(2, n_k),
                            smem_bytes=stream_smem(ragged_box_rows(T, es),
                                                   m_blk, k_blk,
                                                   min(2, n_k), es, deg))
            assert ragged_plan_fits(plan, M, K, T, es)
            got = ragged_gemv(x, offsets, w, plan=plan)
            torch.testing.assert_close(got.float(), want,
                                       **_bf16_tol(dtype))
            ran += 1
    assert ran == 2 * sum(1 for d in RAGGED_DEGREES
                          if K % d == 0 and (K // d) % 8 == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["top6_b1", "top6_b8", "one_expert_72_rows"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_ragged_gemv_is_bit_identical_at_every_depth(cuda, case, dtype):
    from repro_torch.kernels.gemv_plan import (
        plan_ragged_stream,
        ragged_box_rows,
    )
    from repro_torch.kernels.grouped_gemv import ragged_gemv

    K, M = 2048, 1408
    x, offsets, w = _ragged_case(cuda, K, M, case, dtype)
    es = x.element_size()
    base = plan_ragged_stream(M, K, x.shape[0], E=MOE_E, elem_bytes=es)
    want = ragged_gemv(x, offsets, w, plan=base)
    depths = 0
    for depth in range(1, MAX_STAGES + 1):
        p = with_pipeline_depth(base, depth,
                                batch=ragged_box_rows(x.shape[0], es),
                                elem_bytes=es)
        if p is None:
            continue
        depths += 1
        assert torch.equal(ragged_gemv(x, offsets, w, plan=p), want), p
    assert depths >= 2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_ragged_rows_do_not_depend_on_the_slot(cuda, dtype):
    """An expert's rows come out bit for bit the same whichever slot finds
    it and whatever its neighbours hold: expert 5's three rows alone (slot
    0), after four other experts (slot 4), and beside 40 rows of expert 6
    (whose CTAs run five or eight n-tiles)."""
    from repro_torch.kernels.gemv_plan import plan_ragged_stream
    from repro_torch.kernels.grouped_gemv import counts_to_offsets, ragged_gemv

    K, M, E = 2048, 1408, 8
    g = torch.Generator(device=cuda).manual_seed(11)
    w = (torch.randn((E, K, M), generator=g, device=cuda)
         / K ** 0.5).to(dtype)
    mine = torch.randn((3, K), generator=g, device=cuda).to(dtype)
    rows = []
    for before, after in ((0, 0), (4, 0), (2, 40)):
        counts = [1 if e < before else 0 for e in range(E)]
        counts[5], counts[6] = 3, after
        x = torch.cat([
            torch.randn((before, K), generator=g, device=cuda).to(dtype),
            mine,
            torch.randn((after, K), generator=g, device=cuda).to(dtype)])
        offs = counts_to_offsets(torch.tensor(counts, dtype=torch.int32,
                                              device=cuda))
        # one plan for all three: the order of the sums follows from it
        plan = plan_ragged_stream(M, K, 48, E=E,
                                  elem_bytes=x.element_size())
        rows.append(ragged_gemv(x, offs, w, plan=plan)[before:before + 3])
    for got in rows[1:]:
        assert torch.equal(got, rows[0])


def _grouped_case(cuda, K, M, C, dtype, seed=0, E=MOE_E):
    g = torch.Generator(device=cuda).manual_seed(K + M + C + seed)
    w = (torch.randn((E, K, M), generator=g, device=cuda)
         / K ** 0.5).to(dtype)
    xs = torch.randn((E, C, K), generator=g, device=cuda).to(dtype)
    return xs, w


@pytest.mark.gpu
@pytest.mark.parametrize("K,M", [(2048, 1408), (1408, 2048)])
@pytest.mark.parametrize("C", [1, 3, 8, 16, 64])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_grouped_gemv_matches_plain(cuda, K, M, C, dtype):
    """deepseek-moe-16b's expert shapes: one n = 8 tile (C <= 8), several
    sharing each weight sub-tile (16, 64), f32 in row chunks of 8."""
    from repro_torch.kernels.gemv_plan import plan_grouped_stream
    from repro_torch.kernels.grouped_gemv import (
        grouped_gemv,
        grouped_gemv_plain,
    )

    xs, w = _grouped_case(cuda, K, M, C, dtype)
    plan = plan_grouped_stream(M, K, C, E=MOE_E,
                               elem_bytes=xs.element_size())
    n0 = grouped_gemv.launches
    out = grouped_gemv(xs, w, plan=plan)
    torch.cuda.synchronize()
    assert grouped_gemv.launches == n0 + 1
    assert out.shape == (MOE_E, C, M) and out.dtype == dtype
    torch.testing.assert_close(out.float(),
                               grouped_gemv_plain(xs, w).float(),
                               **_bf16_tol(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("C", [3, 8, 16])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_grouped_gemv_is_bit_identical_at_every_depth(cuda, C, dtype):
    from repro_torch.kernels.gemv_plan import (
        plan_grouped_stream,
        stream_rows,
    )
    from repro_torch.kernels.grouped_gemv import grouped_gemv

    K, M = 2048, 1408
    xs, w = _grouped_case(cuda, K, M, C, dtype, seed=1, E=8)
    es = xs.element_size()
    base = plan_grouped_stream(M, K, C, E=8, elem_bytes=es)
    want = grouped_gemv(xs, w, plan=base)
    depths = 0
    for depth in range(1, MAX_STAGES + 1):
        p = with_pipeline_depth(base, depth, batch=stream_rows(C, es),
                                elem_bytes=es)
        if p is None:
            continue
        depths += 1
        assert torch.equal(grouped_gemv(xs, w, plan=p), want), p
    assert depths >= 4


@pytest.mark.gpu
def test_cuda_expert_kernels_read_a_strided_expert_slice(cuda):
    """A column view of a wider stack (row and expert strides over M), and
    expert and row views of xs, run in place and match the contiguous
    copies bit for bit."""
    from repro_torch.kernels.gemv_plan import plan_grouped_stream
    from repro_torch.kernels.gemv_plan import plan_ragged_stream
    from repro_torch.kernels.grouped_gemv import (
        counts_to_offsets,
        grouped_gemv,
        ragged_gemv,
    )

    K, M = 1408, 2048
    g = torch.Generator(device=cuda).manual_seed(7)
    wide = torch.randn((8, K, 2 * M), generator=g, device=cuda).to(
        torch.bfloat16)
    view = wide[:, :, M:]
    plan = plan_ragged_stream(M, K, 12, E=8)
    x = torch.randn((12, K), generator=g, device=cuda).to(torch.bfloat16)
    offsets = counts_to_offsets(torch.tensor([3, 0, 2, 0, 4, 1, 0, 2],
                                             dtype=torch.int32, device=cuda))
    assert torch.equal(ragged_gemv(x, offsets, view, plan=plan),
                       ragged_gemv(x, offsets, view.contiguous(), plan=plan))
    gplan = plan_grouped_stream(M, K, 8, E=8)
    xs = torch.randn((8, 8, K), generator=g, device=cuda).to(torch.bfloat16)
    want = grouped_gemv(xs, view.contiguous(), plan=gplan)
    assert torch.equal(grouped_gemv(xs, view, plan=gplan), want)
    # expert view (every other expert of 16) and row view (rows 2..9 of 12)
    xs16 = torch.randn((16, 12, K), generator=g, device=cuda).to(
        torch.bfloat16)
    for xv in (xs16[::2, :8], xs16[:8, 2:10]):
        assert not xv.is_contiguous()
        assert torch.equal(grouped_gemv(xv, view, plan=gplan),
                           grouped_gemv(xv.contiguous(), view, plan=gplan))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["ragged", "grouped"])
def test_moe_engine_on_the_card_matches_the_cpu_engine(cuda, shape):
    """Reduced deepseek-moe-16b (f32): the card's engine launches the
    expert kernel and gives the CPU engine's greedy tokens."""
    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.grouped_gemv import grouped_gemv, ragged_gemv
    from repro_torch.models import lm
    from repro_torch.serving.engine import Engine, Request

    cfg = get_config("deepseek-moe-16b").reduced()
    cpu_params = lm.init_lm(cfg, seed=0, device="cpu")

    def move(node):
        if isinstance(node, dict):
            return {k: move(v) for k, v in node.items()}
        if isinstance(node, list):
            return [move(v) for v in node]
        return node.to(cuda)

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (5, 9, 3, 12, 7)]
    kernel = ragged_gemv if shape == "ragged" else grouped_gemv
    done = {}
    for dev, params in (("cpu", cpu_params), ("cuda", move(cpu_params))):
        eng = Engine(cfg, params, batch_slots=4 if shape == "ragged" else 1,
                     max_len=64, device=dev, gemv_backend="h100",
                     gemv_expert_shape=shape)
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=6))
        n0 = kernel.launches
        done[dev] = {r.rid: r.generated for r in eng.run_until_drained()}
        launched = kernel.launches - n0
    assert launched > 0
    assert done["cuda"] == done["cpu"]


# --------------------------------------------------------------------------
# triton_gemv (csrc/triton_gemv.cu) and the gpu backend
# --------------------------------------------------------------------------

# (M, K): olmo-1b's head (m_blk 128, n_m 393), deepseek-moe-16b's head
# (m_blk 512, n_m 200), and shapes planned at m_blk 64 and 256
TRITON_SHAPES = [(50304, 2048), (102400, 2048), (4160, 1024), (768, 512)]


@pytest.mark.gpu
@pytest.mark.parametrize("M,K", TRITON_SHAPES)
@pytest.mark.parametrize("B", [1, 3, 8, 11, 16])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_triton_gemv_matches_plain(cuda, M, K, B, dtype):
    from repro_torch.kernels.backends.gpu import plan_triton_gemv
    from repro_torch.kernels.triton_gemv import (
        triton_gemv,
        triton_gemv_plain,
    )

    plan = plan_triton_gemv(M, K, B)
    g = torch.Generator(device=cuda).manual_seed(M + K + B)
    w_t = (torch.randn((K, M), generator=g, device=cuda) / K ** 0.5).to(dtype)
    x = torch.randn((B, K), generator=g, device=cuda).to(dtype)
    n0 = triton_gemv.launches
    out = triton_gemv(x, w_t, plan=plan)
    torch.cuda.synchronize()
    assert triton_gemv.launches == n0 + 1
    assert out.shape == (B, M) and out.dtype == dtype
    torch.testing.assert_close(
        out.float(), triton_gemv_plain(x, w_t, plan.k_blk).float(),
        **_bf16_tol(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_triton_gemv_reads_a_column_view_in_place(cuda, dtype):
    """A column slice of a wider weight (rows 2M apart) gives the
    contiguous copy's result bit for bit."""
    from repro_torch.kernels.backends.gpu import plan_triton_gemv
    from repro_torch.kernels.triton_gemv import triton_gemv

    M, K = 6144, 2048
    g = torch.Generator(device=cuda).manual_seed(11)
    wide = torch.randn((K, 2 * M), generator=g, device=cuda).to(dtype)
    view = wide[:, M:]
    x = torch.randn((8, K), generator=g, device=cuda).to(dtype)
    plan = plan_triton_gemv(M, K, 8)
    assert torch.equal(triton_gemv(x, view, plan=plan),
                       triton_gemv(x, view.contiguous(), plan=plan))


@pytest.mark.gpu
def test_cuda_triton_gemv_refuses_an_unaligned_stride(cuda):
    from repro_torch.kernels.backends.gpu import plan_triton_gemv
    from repro_torch.kernels.triton_gemv import triton_gemv

    M, K = 512, 256
    wide = torch.zeros((K, M + 4), device=cuda, dtype=torch.bfloat16)
    x = torch.zeros((1, K), device=cuda, dtype=torch.bfloat16)
    n0 = triton_gemv.launches
    with pytest.raises(ValueError, match="16-byte"):
        triton_gemv(x, wide[:, :M], plan=plan_triton_gemv(M, K, 1))
    assert triton_gemv.launches == n0


@pytest.mark.gpu
def test_gpu_backend_engine_on_the_card_matches_the_cpu_engine(
        cuda, monkeypatch):
    """Reduced olmo-1b (f32) on the gpu backend with constants that make
    the reduced shapes pick triton: the card launches triton_gemv and
    gives the CPU engine's greedy tokens."""
    import dataclasses

    import numpy as np

    from repro_torch.kernels import dispatch
    from repro_torch.kernels.backends import base
    from repro_torch.kernels.backends.gpu import GpuBackend
    from repro_torch.kernels.triton_gemv import triton_gemv
    from repro_torch.serving.engine import Engine, Request

    monkeypatch.setitem(base._REGISTRY, "gpu", GpuBackend(
        min_parallel_blocks=1, bandwidth_gbps=1.0))
    cfg, cpu_params, gpu_params = _small(cuda)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (5, 9, 3, 12, 7)]
    done = {}
    for dev, params in (("cpu", cpu_params), ("cuda", gpu_params)):
        eng = Engine(cfg, params, batch_slots=4, max_len=64, device=dev,
                     gemv_backend="gpu")
        eng.gemv_policy = dataclasses.replace(eng.gemv_policy,
                                              min_pallas_bytes=0)
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=6))
        dispatch.clear_plan_cache()
        n0 = triton_gemv.launches
        done[dev] = {r.rid: r.generated for r in eng.run_until_drained()}
        assert dispatch.dispatch_stats()["kernel_picks"].get("gpu:triton")
    assert triton_gemv.launches > n0
    assert done["cuda"] == done["cpu"]


@pytest.mark.gpu
@pytest.mark.parametrize("m_blk", [64, 128, 256, 512])
@pytest.mark.parametrize("B", [1, 3, 8, 11])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_triton_gemv_at_every_column_block(cuda, m_blk, B, dtype):
    """Each JAX column block maps onto m_blk / 128 CTAs of the streaming
    body (one 64-column CTA for 64): the result holds against the plain
    version, and every ring depth the card holds gives the same bits."""
    import dataclasses

    from repro_torch.kernels.backends.gpu import plan_triton_gemv
    from repro_torch.kernels.triton_gemv import (
        plan_fits,
        triton_gemv,
        triton_gemv_plain,
    )

    M, K = 16384, 2048
    plan = plan_triton_gemv(M, K, B)
    plan = dataclasses.replace(plan, m_blk=m_blk, n_m=M // m_blk)
    g = torch.Generator(device=cuda).manual_seed(m_blk + B)
    w_t = (torch.randn((K, M), generator=g, device=cuda) / K ** 0.5).to(dtype)
    x = torch.randn((B, K), generator=g, device=cuda).to(dtype)
    want = triton_gemv(x, w_t, plan=plan)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        want.float(), triton_gemv_plain(x, w_t, plan.k_blk).float(),
        **_bf16_tol(dtype))
    depths = 0
    for depth in range(1, MAX_STAGES + 1):
        p = dataclasses.replace(plan, stages=depth)
        if not plan_fits(p, M, K, B, x.element_size()):
            continue
        depths += 1
        assert torch.equal(triton_gemv(x, w_t, plan=p), want), p
    assert depths >= 4


# --------------------------------------------------------------------------
# decode attention (csrc/decode_attention.cu)
# --------------------------------------------------------------------------


def _attention_case(cuda, B, C, Hkv, G, D, dtype, qpos, seed=0, slots=None):
    """q [B, 1, H, D] and a cache k / v that is the first B slots of a
    `slots`-slot buffer (the engine's slot-prefix view)."""
    g = torch.Generator(device=cuda).manual_seed(seed + B + C + G + D)
    n = slots or B
    q = torch.randn((B, 1, Hkv * G, D), generator=g, device=cuda).to(dtype)
    k = torch.randn((n, C, Hkv, D), generator=g, device=cuda).to(dtype)[:B]
    v = torch.randn((n, C, Hkv, D), generator=g, device=cuda).to(dtype)[:B]
    pos = torch.tensor(qpos, dtype=torch.int32, device=cuda)
    return q, k, v, pos


def _attention_tol(dtype, v):
    # sums in other orders; in bf16 a probability at a rounding boundary
    # may round one ulp apart (2**-8 * max|v| on the output), and the
    # output itself one ulp (2**-7 relative)
    if dtype == torch.float32:
        return dict(rtol=1e-5, atol=1e-5)
    return dict(rtol=2.0**-7, atol=2.0**-8 * v.float().abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("C", [1024, 4096])
@pytest.mark.parametrize("G,Hkv", [(1, 16), (2, 8), (8, 2)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_decode_attention_matches_plain(cuda, C, G, Hkv, dtype):
    """The engine's shapes (8 slots of a 1024-position cache, head dim
    128), and a 4096-position one: valid lengths 1, 17, 300, C, an idle
    slot whose offset runs past the end, and one with no valid position
    (all masked: uniform over C).  At every split count a CTA's V rows are
    staged in one chunk (8 splits of 1024) or in several (fewer splits,
    the longer cache)."""
    from repro_torch.kernels.attention import (
        decode_attention,
        decode_attention_plain,
        kernel_applies,
    )

    B, D = 8, 128
    qpos = [0, 16, 299, C - 1, C + 40, 511, 700, 5]
    q, k, v, pos = _attention_case(cuda, B, C, Hkv, G, D, dtype, qpos,
                                   slots=12)
    valid = pos + 1
    valid[7] = 0                       # every score masked
    assert kernel_applies(q, k, v, causal=True)
    n0 = decode_attention.launches
    out = decode_attention(q, k, v, q_positions=pos[:, None],
                           kv_valid_len=valid)
    torch.cuda.synchronize()
    assert decode_attention.launches == n0 + 1
    want = decode_attention_plain(q, k, v, q_positions=pos[:, None],
                                  kv_valid_len=valid)
    torch.testing.assert_close(out.float(), want.float(),
                               **_attention_tol(dtype, v))
    # every split count: the same function (sums in other orders)
    for splits in (1, 2, 4, 8):
        got = decode_attention(q, k, v, q_positions=pos[:, None],
                               kv_valid_len=valid, splits=splits)
        torch.testing.assert_close(got.float(), want.float(),
                                   **_attention_tol(dtype, v))
        # deterministic: the same split count gives the same bits
        assert torch.equal(got, decode_attention(
            q, k, v, q_positions=pos[:, None], kv_valid_len=valid,
            splits=splits))


@pytest.mark.gpu
@pytest.mark.parametrize("C", [1024, 4096])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("G,Hkv", [(1, 16), (8, 2)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_quantized_attention_equals_the_fp_kernel_bit_for_bit(
        cuda, C, bits, G, Hkv, dtype):
    """int8 / int4 pages read in place (codes and scales of a slot-prefix
    view, staged in shared memory with their scales): the output equals
    the fp kernel's over ``dequantize_page``'s tensor bit for bit at every
    split count, with idle slots past the end and an all-masked slot; no
    dequantized copy is made."""
    from repro_torch.kernels.attention import decode_attention, kernel_applies
    from repro_torch.kernels.kv_quant import dequantize_page, quantize_page

    B, D = 8, 128
    qpos = [0, 16, 299, C - 1, C + 40, 511, 700, 5]
    q, k, v, pos = _attention_case(cuda, B, C, Hkv, G, D, dtype, qpos,
                                   slots=12, seed=bits)
    valid = pos + 1
    valid[7] = 0                       # every score masked
    kc, ks = quantize_page(k, bits)
    vc, vs = quantize_page(v, bits)
    buf = torch.zeros((12,) + kc.shape[1:], dtype=torch.int8, device=cuda)
    sbuf = torch.zeros((12,) + ks.shape[1:], device=cuda)
    buf[:B], sbuf[:B] = kc, ks
    kc, ks = buf[:B], sbuf[:B]          # the engine's slot-prefix view
    assert kernel_applies(q, kc, vc, causal=True, k_scale=ks, v_scale=vs)
    kf = dequantize_page(kc, ks, hd=D, out_dtype=dtype)
    vf = dequantize_page(vc, vs, hd=D, out_dtype=dtype)
    for splits in (None, 1, 2, 4, 8):
        n0 = decode_attention.launches
        got = decode_attention(q, kc, vc, q_positions=pos[:, None],
                               kv_valid_len=valid, splits=splits,
                               k_scale=ks, v_scale=vs)
        torch.cuda.synchronize()
        assert decode_attention.launches == n0 + 1
        want = decode_attention(q, kf, vf, q_positions=pos[:, None],
                                kv_valid_len=valid, splits=splits)
        assert torch.equal(got, want), splits


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_prefill_scores_keep_bf16_operands_on_the_card(cuda, dtype):
    """The plain path's scores on the card come from one bf16 product with
    an f32 result (no f32 copy of the cache): they equal the f32 einsum
    within f32 summation error, and so does the attention output."""
    import math

    from repro_torch.kernels.attention import decode_attention_plain

    B, C, Hkv, G, D, Sq = 2, 512, 4, 2, 128, 37
    g = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn((B, Sq, Hkv * G, D), generator=g, device=cuda).to(dtype)
    k = torch.randn((B, C, Hkv, D), generator=g, device=cuda).to(dtype)
    v = torch.randn((B, C, Hkv, D), generator=g, device=cuda).to(dtype)
    pos = (torch.arange(Sq, device=cuda) + 100)[None].expand(B, Sq)
    qg = q.reshape(B, Sq, Hkv, G, D)
    f32 = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    bmm = torch.bmm(qg.permute(0, 2, 3, 1, 4).reshape(B * Hkv, G * Sq, D),
                    k.permute(0, 2, 3, 1).reshape(B * Hkv, D, C),
                    **({"out_dtype": torch.float32}
                       if dtype == torch.bfloat16 else {}))
    # f32 sums of exact products in another order: D terms of |q k|
    bound = D * 2.0**-23 * torch.einsum(
        "bqhgd,bkhd->bhgqk", qg.float().abs(), k.float().abs())
    assert bmm.dtype == torch.float32
    assert ((bmm.reshape(f32.shape) - f32).abs() <= bound + 1e-6).all()
    out = decode_attention_plain(q, k, v, q_positions=pos,
                                 kv_valid_len=None)
    scores = torch.where(
        torch.arange(C, device=cuda)[None, None, :] <= pos[:, :, None],
        0.0, 1.0)[:, None, None].bool()
    probs = torch.softmax(torch.where(scores, -2.0e9, f32 / math.sqrt(D)),
                          -1).to(dtype)
    want = torch.einsum("bhgqk,bkhd->bqhgd", probs, v).reshape(out.shape)
    torch.testing.assert_close(out.float(), want.float(),
                               **_attention_tol(dtype, v))


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [16, 8, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_smem_is_what_the_kernel_takes(cuda, bits, dtype):
    """The planner's shared memory (scores, partials, the staged V rows
    and their scales) is what the kernel asks for, at every split count."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.attention import SPLITS, smem_bytes

    fn = _build.load("decode_attention").decode_attention_smem_bytes
    es = torch.tensor([], dtype=dtype).element_size()
    for G, D, C in ((1, 128, 1024), (8, 128, 4096), (2, 64, 300)):
        for s in SPLITS:
            assert fn(G, D, C, s, es, bits) == smem_bytes(
                G, D, C, s, elem_bytes=es, bits=bits), (G, D, C, s)


@pytest.mark.gpu
def test_cuda_decode_attention_takes_int64_positions_and_no_valid_len(cuda):
    """The model's q positions are int64 and broadcast from one offset
    (stride 0); without a valid length only the causal mask applies."""
    from repro_torch.kernels.attention import (
        decode_attention,
        decode_attention_plain,
    )

    B, C, Hkv, G, D = 4, 256, 4, 2, 64
    q, k, v, _ = _attention_case(cuda, B, C, Hkv, G, D, torch.bfloat16,
                                 [0] * B)
    pos = torch.full((1, 1), 77, dtype=torch.int64, device=cuda).expand(B, 1)
    out = decode_attention(q, k, v, q_positions=pos, kv_valid_len=None)
    want = decode_attention_plain(q, k, v, q_positions=pos,
                                  kv_valid_len=None)
    torch.testing.assert_close(out.float(), want.float(),
                               **_attention_tol(torch.bfloat16, v))


@pytest.mark.gpu
@pytest.mark.parametrize("kv_store", ["fp", "int8", "int4"])
def test_engine_tokens_with_the_attention_kernel_equal_the_plain_path(
        cuda, monkeypatch, kv_store):
    """Reduced olmo-1b (f32) on the card: every decode step runs the
    attention kernel (on a quantized store it reads the codes in place),
    and the greedy tokens equal those of the same engine with attention on
    its plain path (which dequantizes the cache first)."""
    import numpy as np

    from repro_torch.kernels.attention import decode_attention
    from repro_torch.models import layers as L
    from repro_torch.serving.engine import Engine, Request

    cfg, _, params = _small(cuda)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (5, 9, 3, 12, 7)]
    done = {}
    for route in ("kernel", "plain"):
        if route == "plain":
            monkeypatch.setattr(L, "kernel_applies",
                                lambda *a, **k: False)
        eng = Engine(cfg, params, batch_slots=4, max_len=64, device=cuda,
                     kv_store=kv_store)
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=6))
        n0 = decode_attention.launches
        done[route] = {r.rid: r.generated for r in eng.run_until_drained()}
        launched = decode_attention.launches - n0
        # the step is a graph a bucket: the wrapper counts at the eager
        # first step and at the capture, never at a replay
        buckets = {st["decode_batch"] for st in eng.metrics.steps
                   if st["decode_batch"]}
        assert set(eng.graphs.replays) == buckets
        assert launched == (2 * cfg.n_layers * len(buckets)
                            if route == "kernel" else 0)
    assert done["kernel"] == done["plain"]


# --------------------------------------------------------------------------
# the decode step as one captured CUDA graph per bucket
# --------------------------------------------------------------------------


def _moved(node, device):
    if isinstance(node, dict):
        return {k: _moved(v, device) for k, v in node.items()}
    if isinstance(node, list):
        return [_moved(v, device) for v in node]
    return node.to(device)


def _graph_engine_case(cuda, arch):
    """Reduced (f32) params on the card for ``arch``: olmo-1b at the
    widths where the attention kernel applies, deepseek-moe-16b as
    registered."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import lm

    if arch == "olmo-1b":
        cfg, _, params = _small(cuda)
        return cfg, params
    cfg = get_config(arch).reduced()
    return cfg, _moved(lm.init_lm(cfg, seed=0, device="cpu"), cuda)


def _serve_logged(cfg, params, cuda, prompts, new_tokens, policy=None,
                  **kw):
    """Serve ``prompts``; returns (tokens by rid, every sampled logits row
    keyed by (rid, tokens so far), the engine).  ``policy`` overrides
    fields of the engine's DispatchPolicy."""
    import dataclasses

    from repro_torch.serving.engine import Engine, Request

    eng = Engine(cfg, params, max_len=64, device=cuda, **kw)
    if policy:
        eng.gemv_policy = dataclasses.replace(eng.gemv_policy, **policy)
    rows, sample = {}, eng._sample

    def logged(r, row):
        rows[(r.rid, len(r.generated))] = row.copy()
        return sample(r, row)

    eng._sample = logged
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=new_tokens))
    done = {r.rid: r.generated for r in eng.run_until_drained()}
    return done, rows, eng


GRAPH_CASES = [("olmo-1b", dict(kv_store=s)) for s in ("fp", "int8", "int4")
               ] + [("olmo-1b", dict(gemv_backend="gpu")),
                    ("deepseek-moe-16b", dict(gemv_backend="h100")),
                    ("deepseek-moe-16b", dict(gemv_backend="h100",
                                              gemv_expert_shape="grouped",
                                              batch_slots=1))]


@pytest.mark.gpu
@pytest.mark.parametrize("arch,kw", GRAPH_CASES,
                         ids=[f"{a}-{'-'.join(map(str, k.values()))}"
                              for a, k in GRAPH_CASES])
def test_graph_and_eager_engines_are_bit_identical(cuda, monkeypatch, arch,
                                                   kw):
    """Replayed decode steps give the eager steps' logits bit for bit, and
    so the same tokens: same kernels, same order, same plans."""
    import numpy as np

    from repro_torch.kernels import dispatch
    from repro_torch.kernels.backends import base
    from repro_torch.kernels.backends.gpu import GpuBackend
    from repro_torch.serving import disable_graphs

    policy = None
    if kw.get("gemv_backend") == "gpu":
        # constants that make the reduced shapes pick triton_gemv
        monkeypatch.setitem(base._REGISTRY, "gpu", GpuBackend(
            min_parallel_blocks=1, bandwidth_gbps=1.0))
        policy = {"min_pallas_bytes": 0}
    cfg, params = _graph_engine_case(cuda, arch)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (5, 9, 3, 12, 7)]
    kw = {"batch_slots": 4, **kw}
    out = {}
    for route in ("graph", "eager"):
        dispatch.clear_plan_cache()
        with (disable_graphs() if route == "eager"
              else contextlib.nullcontext()):
            done, rows, eng = _serve_logged(cfg, params, cuda, prompts, 6,
                                            policy, **kw)
        out[route] = (done, rows)
        steps = eng.metrics.counters["decode_steps"]
        if route == "graph":
            assert 0 < len(eng.graphs.replays) < steps
        else:
            assert not eng.graphs.replays
    assert out["graph"][0] == out["eager"][0]
    assert out["graph"][1].keys() == out["eager"][1].keys()
    for key, row in out["graph"][1].items():
        assert np.array_equal(row, out["eager"][1][key]), key


@pytest.mark.gpu
def test_a_capture_that_syncs_raises_and_does_not_fall_back(cuda):
    """A body that reads a value back to the host (``.item()``) cannot be
    captured: the step raises, no graph is kept, and no eager step stands
    in.  Run in a process of its own: a failed capture is not left to the
    tests after it."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    code = """
import dataclasses, numpy as np, torch
from repro_torch.configs.registry import get_config
from repro_torch.models import lm
from repro_torch.serving.engine import Engine, Request
cfg = dataclasses.replace(get_config("olmo-1b").reduced(), d_model=256,
                          n_heads=2, n_kv_heads=2, head_dim=128, d_ff=512,
                          vocab=512)
params = lm.init_lm(cfg, seed=0, device="cuda")
eng = Engine(cfg, params, batch_slots=2, max_len=64, device="cuda")
body = eng.graphs.body
calls = []
def syncing(b, tok):
    logits = body(b, tok)
    calls.append(float(logits.sum().item()))
    return logits
eng.graphs.body = syncing
eng.submit(Request(rid=0, prompt=np.arange(5, dtype=np.int32),
                   max_new_tokens=4))
try:
    eng.step()
except RuntimeError as e:
    # the eager step ran the body once; the capture raised inside it
    assert len(calls) == 1, calls
    assert not eng.graphs.replays
    print("raised:", str(e).splitlines()[0])
else:
    raise SystemExit("the capture did not raise")
"""
    root = Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": str(root / "src")}
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "raised:" in res.stdout


@pytest.mark.gpu
def test_a_second_engine_captures_its_own_graphs(cuda):
    """Two engines in one process, stepped in turns: each captures and
    replays its own graphs over its own cache, and both give the tokens
    of one engine alone."""
    import numpy as np

    from repro_torch.serving.engine import Engine, Request

    cfg, params = _graph_engine_case(cuda, "olmo-1b")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (5, 9, 3)]
    alone, _, _ = _serve_logged(cfg, params, cuda, prompts, 6,
                                batch_slots=4)
    engines = [Engine(cfg, params, batch_slots=4, max_len=64, device=cuda)
               for _ in range(2)]
    for eng in engines:
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=6))
    done = [{}, {}]
    while any(e.active or e.scheduler.queue for e in engines):
        for d, eng in zip(done, engines):
            d.update({r.rid: r.generated for r in eng.step()})
    assert done[0] == done[1] == alone
    a, b = (e.graphs for e in engines)
    assert a.replays and b.replays
    assert a.tok.data_ptr() != b.tok.data_ptr()
    assert not set(a.replays.values()) & set(b.replays.values())
