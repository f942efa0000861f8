"""The port on the card: tests that need a CUDA device.

This file imports nothing of JAX, so it runs on the machine with the card
(``python -m pytest -m gpu tests/test_torch_*.py``); here every test skips
inside its fixture.
"""

import pytest
import torch

from repro_torch.kernels.gemv_plan import (
    plan_gemv,
    plan_splitk,
    valid_splitk_degree,
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


@pytest.mark.gpu
@pytest.mark.parametrize("M,K", [(768, 256), (2048, 8192), (2064, 2048)])
@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_quant_kernels_match_plain(cuda, M, K, B, bits, dtype):
    from repro_torch.kernels.gemv_plan import plan_quant
    from repro_torch.kernels.ops import quantize_weight
    from repro_torch.kernels.quant_gemv import (
        quant4_gemv,
        quant4_gemv_plain,
        quant_gemv,
        quant_gemv_plain,
    )

    g = torch.Generator(device=cuda).manual_seed(M + K + B + bits)
    w = torch.randn((M, K), generator=g, device=cuda).to(torch.bfloat16)
    x = torch.randn((B, K), generator=g, device=cuda).to(dtype)
    pw = quantize_weight(w, bits=bits, block=32)
    assert pw.w_t.device == w.device
    fn, plain = ((quant_gemv, quant_gemv_plain) if bits == 8
                 else (quant4_gemv, quant4_gemv_plain))
    # the kernel and the plain version sum f32 products in other orders;
    # bf16 output: one bf16 ulp (2^-7 relative)
    tol = dict(rtol=2.0**-7, atol=1e-2) if dtype == torch.bfloat16 else \
        dict(rtol=1e-4, atol=1e-3)
    n0 = fn.launches
    out = fn(x, pw.w_t, pw.scales, block=32,
             plan=plan_quant(M, K, B, bits=bits, block=32, min_blocks=132))
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1
    torch.testing.assert_close(out.float(),
                               plain(x, pw.w_t, pw.scales, 32).float(),
                               **tol)


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


def _expert_counts(case: str) -> tuple[int, list[int]]:
    """(T, counts [64]) of one ragged case: a top-6 routing of 8 tokens,
    of 1 token, all rows on one expert (more than the 8 rows a cell holds
    in registers), counts short of T (tail rows), and T = 0."""
    import numpy as np

    rng = np.random.default_rng(len(case))

    def route(n):
        top = np.stack([rng.permutation(MOE_E)[:6] for _ in range(n)])
        return np.bincount(top.reshape(-1), minlength=MOE_E).tolist()

    if case == "top6_b8":
        return 48, route(8)
    if case == "top6_b1":
        return 6, route(1)
    if case == "one_expert_20_rows":
        return 20, [0] * 7 + [20] + [0] * (MOE_E - 8)
    if case == "tail_rows":
        return 48, route(6)
    return 0, [0] * MOE_E


def _bf16_tol(dtype):
    # one bf16 ulp of the result (relative 2**-7) plus f32 order noise near
    # zero; f32: order noise only
    return (dict(rtol=2.0**-7, atol=1e-3) if dtype == torch.bfloat16
            else dict(rtol=1e-5, atol=1e-4))


@pytest.mark.gpu
@pytest.mark.parametrize("K,M", [(2048, 1408), (1408, 2048)])
@pytest.mark.parametrize("case", ["top6_b8", "top6_b1", "one_expert_20_rows",
                                  "tail_rows", "empty"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_ragged_gemv_matches_plain(cuda, K, M, case, dtype):
    from repro_torch.kernels.grouped_gemv import (
        counts_to_offsets,
        plan_expert_gemv,
        ragged_gemv,
        ragged_gemv_plain,
    )

    T, counts = _expert_counts(case)
    g = torch.Generator(device=cuda).manual_seed(K + T)
    w = (torch.randn((MOE_E, K, M), generator=g, device=cuda)
         / K ** 0.5).to(dtype)
    x = torch.randn((T, K), generator=g, device=cuda).to(dtype)
    offsets = counts_to_offsets(torch.tensor(counts, dtype=torch.int32,
                                             device=cuda))
    plan = plan_expert_gemv(M, K, elem_bytes=x.element_size())
    n0 = ragged_gemv.launches
    out = ragged_gemv(x, offsets, w, plan=plan)
    torch.cuda.synchronize()
    assert ragged_gemv.launches == n0 + (1 if T else 0)
    assert out.shape == (T, M)
    torch.testing.assert_close(out.float(),
                               ragged_gemv_plain(x, offsets, w).float(),
                               **_bf16_tol(dtype))
    assert not out[sum(counts):].any()


@pytest.mark.gpu
@pytest.mark.parametrize("C", [1, 8, 11])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_grouped_gemv_matches_plain(cuda, C, dtype):
    from repro_torch.kernels.grouped_gemv import (
        grouped_gemv,
        grouped_gemv_plain,
        plan_expert_gemv,
    )

    K, M = 2048, 1408
    g = torch.Generator(device=cuda).manual_seed(C)
    w = (torch.randn((MOE_E, K, M), generator=g, device=cuda)
         / K ** 0.5).to(dtype)
    xs = torch.randn((MOE_E, C, K), generator=g, device=cuda).to(dtype)
    n0 = grouped_gemv.launches
    out = grouped_gemv(xs, w, plan=plan_expert_gemv(
        M, K, elem_bytes=xs.element_size()))
    torch.cuda.synchronize()
    assert grouped_gemv.launches == n0 + 1
    torch.testing.assert_close(out.float(),
                               grouped_gemv_plain(xs, w).float(),
                               **_bf16_tol(dtype))


@pytest.mark.gpu
def test_cuda_expert_kernels_read_a_strided_expert_slice(cuda):
    """A column view of a wider stack (row and expert strides over M) runs
    in place and matches the contiguous copy bit for bit."""
    from repro_torch.kernels.grouped_gemv import (
        counts_to_offsets,
        grouped_gemv,
        plan_expert_gemv,
        ragged_gemv,
    )

    K, M = 1408, 2048
    g = torch.Generator(device=cuda).manual_seed(7)
    wide = torch.randn((8, K, 2 * M), generator=g, device=cuda).to(
        torch.bfloat16)
    view = wide[:, :, M:]
    plan = plan_expert_gemv(M, K)
    x = torch.randn((12, K), generator=g, device=cuda).to(torch.bfloat16)
    offsets = counts_to_offsets(torch.tensor([3, 0, 2, 0, 4, 1, 0, 2],
                                             dtype=torch.int32, device=cuda))
    assert torch.equal(ragged_gemv(x, offsets, view, plan=plan),
                       ragged_gemv(x, offsets, view.contiguous(), plan=plan))
    xs = torch.randn((8, 8, K), generator=g, device=cuda).to(torch.bfloat16)
    assert torch.equal(grouped_gemv(xs, view, plan=plan),
                       grouped_gemv(xs, view.contiguous(), plan=plan))


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
