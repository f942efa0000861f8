"""GenAI end-to-end roofline performance model (paper §VI-A3, §VI-E).

Takes model hyperparameters + SoC peak compute/bandwidth, determines the
critical path (compute vs memory) per operator, and derives:

  * per-token latency (token-generation phase; GEMVs on PIM or SoC,
    attention + vector ops always on the SoC — paper footnote 4),
  * prompt-phase latency (compute-bound GEMMs on the SoC; PIM placement
    preserves interleaving so prompt reads are unaffected — paper §V-A2),
  * end-to-end latency for (prompt_len, n_generated) and the speedups of
    Fig. 14 (prompt 1920, 128 generated tokens).
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.opt_models import OPTModel, lm_head_gemv, token_gemvs
from repro_torch.core.pim_arch import (
    DataFormat,
    INT8,
    PIMConfig,
    ScaleFactorConfig,
)
from repro_torch.core.placement import GEMV
from repro_torch.pim.timing import pim_speedup, soc_gemv_time_ns


@dataclass(frozen=True)
class E2EResult:
    model: str
    t_token_soc_ns: float
    t_token_pim_ns: float
    t_prompt_ns: float
    t_e2e_soc_ns: float
    t_e2e_pim_ns: float

    @property
    def token_speedup(self) -> float:
        return self.t_token_soc_ns / self.t_token_pim_ns

    @property
    def e2e_speedup(self) -> float:
        return self.t_e2e_soc_ns / self.t_e2e_pim_ns

    @property
    def tokengen_fraction_soc(self) -> float:
        """Fraction of end-to-end time in token generation on the baseline."""
        return (self.t_e2e_soc_ns - self.t_prompt_ns) / self.t_e2e_soc_ns


def _attention_time_ns(
    model: OPTModel, ctx: int, cfg: PIMConfig, kv_dform: DataFormat
) -> float:
    """Per-layer attention for one generated token, mapped to the SoC
    (dynamic KV data-placement makes PIM mapping impractical — footnote 4)."""
    d = model.d_model
    kv_bytes = 2 * ctx * d * kv_dform.bits // 8          # read K and V
    flops = 4 * ctx * d                                   # qk^T + att*v
    t_mem = kv_bytes / cfg.peak_bw_gbps
    t_comp = flops / (cfg.soc_tops_8b * 1e3)
    return max(t_mem, t_comp)


def _vector_ops_time_ns(model: OPTModel, cfg: PIMConfig) -> float:
    """LayerNorms, residuals, softmax reads/writes per layer per token."""
    bytes_moved = 10 * model.d_model * 2
    return bytes_moved / cfg.peak_bw_gbps


def per_token_latency_ns(
    model: OPTModel,
    cfg: PIMConfig,
    *,
    use_pim: bool,
    ctx: int,
    in_dform: DataFormat = INT8,
    sf: ScaleFactorConfig | None = None,
    in_reg_alloc: int = 8,
    opt_cr_degree: bool = True,
    pim_lm_head: bool = True,
) -> float:
    gemvs = token_gemvs(model, in_dform)
    head = lm_head_gemv(model, in_dform)

    def gemv_time(g: GEMV) -> float:
        if not use_pim:
            return soc_gemv_time_ns(g, cfg)
        _, _, bd = pim_speedup(
            g, cfg, in_reg_alloc=in_reg_alloc,
            opt_cr_degree=opt_cr_degree, sf=sf,
        )
        return bd.total

    per_layer = sum(gemv_time(g) for g in gemvs)
    per_layer += _attention_time_ns(model, ctx, cfg, in_dform)
    per_layer += _vector_ops_time_ns(model, cfg)
    t_head = gemv_time(head) if (use_pim and pim_lm_head) else (
        soc_gemv_time_ns(head, cfg)
    )
    return model.n_layers * per_layer + t_head


def prompt_latency_ns(
    model: OPTModel,
    cfg: PIMConfig,
    prompt_len: int,
    in_dform: DataFormat = INT8,
) -> float:
    """Prompt phase: GEMMs on the SoC, per-operator critical path."""
    d, f, L = model.d_model, model.d_ff, model.n_layers
    tops = cfg.soc_tops_8b * (8.0 / max(in_dform.bits, 8)) * 1e3  # ops/ns
    total = 0.0
    # per-layer GEMMs: (M, K) x (K, prompt)
    for (m, k) in ((3 * d, d), (d, d), (f, d), (d, f)):
        flops = 2 * m * k * prompt_len
        bytes_moved = in_dform.bytes_for(m * k) + 2 * prompt_len * (m + k)
        total += max(flops / tops, bytes_moved / cfg.peak_bw_gbps) * L
    # attention: scores + values, causal
    att_flops = L * (2 * prompt_len * prompt_len * d)
    total += att_flops / tops
    # lm head on the last position only
    total += max(
        2 * model.vocab * d / tops,
        in_dform.bytes_for(model.vocab * d) / cfg.peak_bw_gbps,
    )
    return total


def e2e_latency(
    model: OPTModel,
    cfg: PIMConfig,
    *,
    prompt_len: int = 1920,
    n_gen: int = 128,
    in_dform: DataFormat = INT8,
    sf: ScaleFactorConfig | None = None,
    in_reg_alloc: int = 8,
    opt_cr_degree: bool = True,
) -> E2EResult:
    ctx = prompt_len + n_gen // 2  # average context during generation
    t_tok_soc = per_token_latency_ns(
        model, cfg, use_pim=False, ctx=ctx, in_dform=in_dform,
    )
    t_tok_pim = per_token_latency_ns(
        model, cfg, use_pim=True, ctx=ctx, in_dform=in_dform, sf=sf,
        in_reg_alloc=in_reg_alloc, opt_cr_degree=opt_cr_degree,
    )
    t_prompt = prompt_latency_ns(model, cfg, prompt_len, in_dform)
    return E2EResult(
        model=model.name,
        t_token_soc_ns=t_tok_soc,
        t_token_pim_ns=t_tok_pim,
        t_prompt_ns=t_prompt,
        t_e2e_soc_ns=t_prompt + n_gen * t_tok_soc,
        t_e2e_pim_ns=t_prompt + n_gen * t_tok_pim,
    )
