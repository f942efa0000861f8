"""The paper's GenAI workload suite (§VI-A2): OPT-style decoder models up to
30B parameters [Zhang+ 2022], and the four token-generation GEMVs each model
manifests per layer (paper Fig. 8 caption: "four GEMVs per model", attention
excluded and mapped to the SoC — footnote 4).
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.pim_arch import DataFormat, INT8
from repro_torch.core.placement import GEMV


@dataclass(frozen=True)
class OPTModel:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    vocab: int = 50272
    max_pos: int = 2048

    @property
    def params(self) -> int:
        d, f = self.d_model, self.d_ff
        per_layer = 4 * d * d + 2 * d * f  # QKV+out (4d^2) + FC1/FC2 (2df)
        return self.n_layers * per_layer + self.vocab * d + self.max_pos * d


# Open Pre-trained Transformers suite [Zhang+ 2022], models the paper sweeps
# (66B/175B excluded per §VI-A2 as impractical on client platforms).
OPT_SUITE: dict[str, OPTModel] = {
    m.name: m
    for m in (
        OPTModel("opt-125m", 12, 768, 12, 3072),
        OPTModel("opt-350m", 24, 1024, 16, 4096),
        OPTModel("opt-1.3b", 24, 2048, 32, 8192),
        OPTModel("opt-2.7b", 32, 2560, 32, 10240),
        OPTModel("opt-6.7b", 32, 4096, 32, 16384),
        OPTModel("opt-13b", 40, 5120, 40, 20480),
        OPTModel("opt-30b", 48, 7168, 56, 28672),
    )
}


def token_gemvs(
    model: OPTModel, in_dform: DataFormat = INT8, out_dform: DataFormat | None = None
) -> list[GEMV]:
    """The four per-layer token-generation GEMVs offloaded to PIM.

    Weight matrix is M x K with out[M] = W @ x[K]; 16b accumulation by default
    (paper §VI-B: "8bit data-format for weights/input-vector with 16b
    accumulation").
    """
    from repro_torch.core.pim_arch import BF16

    out_dform = out_dform or BF16
    d, f = model.d_model, model.d_ff
    return [
        GEMV(3 * d, d, in_dform, out_dform, name=f"{model.name}/qkv"),
        GEMV(d, d, in_dform, out_dform, name=f"{model.name}/out_proj"),
        GEMV(f, d, in_dform, out_dform, name=f"{model.name}/fc1"),
        GEMV(d, f, in_dform, out_dform, name=f"{model.name}/fc2"),
    ]


def lm_head_gemv(
    model: OPTModel, in_dform: DataFormat = INT8, out_dform: DataFormat | None = None
) -> GEMV:
    from repro_torch.core.pim_arch import BF16

    return GEMV(
        model.vocab, model.d_model, in_dform, out_dform or BF16,
        name=f"{model.name}/lm_head",
    )
