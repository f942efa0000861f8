"""What each rank runs for ``test_torch_sharded_serving.py`` (and what the
test runs unsharded, through the same functions).  Imports no JAX: every
process ``launch.mesh.spawn`` starts imports this module to find its
function.

A case is a reduced model, an engine configuration and a request plan;
:func:`serve` drives the port's ``Engine`` over the plan (on a mesh or
not) and returns the tokens, every sampled logits row and the
dispatcher's counters.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.registry import get_config
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import tuning
from repro_torch.kernels import dispatch
from repro_torch.kernels.backends import get_backend
from repro_torch.models import lm
from repro_torch.observability.trace import Tracer, uninstall_tracer
from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.scheduler import SchedulerConfig
from repro_torch.tree import leaves

MAX_LEN = 64
MOE_KW = {"gemv_backend": "h100"}
PREEMPT = dict(policy="gemv_aware", gemv_batch_threshold=4,
               preempt_margin=5.0)
CLOCK_OFFSET = 1000.0     # rank r's clock runs r * this ahead of rank 0's


class FakeClock:
    def __init__(self, offset: float = 0.0):
        self.t = 0.0
        self.offset = offset

    def __call__(self):
        return self.t + self.offset

    def advance(self, dt):
        self.t += dt


def prompts(vocab: int, lengths, seed: int) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lengths]


def mix_plan(vocab: int) -> list[tuple]:
    """Mixed prompt lengths, chunk 8 in the engine: a 20-token prompt, a
    short one that finishes first (its slot below a busy one: a
    compaction), a 25-token one and a 3-token one; at step 4 a prompt
    sharing the first one's 16-token prefix (a prefix hit).  Items are
    ``(step, rid, prompt, new tokens, absolute deadline)``."""
    p = prompts(vocab, [20, 5, 25, 3, 7], seed=41)
    hit = np.concatenate([p[0][:16], p[4]])
    return [(0, 0, p[0], 6, None), (0, 1, p[1], 2, None),
            (0, 2, p[2], 5, None), (0, 3, p[3], 7, None),
            (4, 4, hit, 4, None)]


def preempt_plan(vocab: int) -> list[tuple]:
    """Two slots busy decoding; at step 2 a request whose deadline (3.0,
    absolute, on rank 0's clock) is inside the margin: a preemption."""
    p = prompts(vocab, [5, 6, 4], seed=12)
    return [(0, 0, p[0], 10, None), (0, 1, p[1], 10, None),
            (2, 2, p[2], 3, 3.0)]


# name: (arch, config overrides, engine kwargs, plan, scheduler)
CASES = {
    "olmo": ("olmo-1b", {}, dict(prefill_chunk=8, prefix_cache=True),
             "mix", None),
    "olmo_overlap": ("olmo-1b", {}, dict(prefill_chunk=8, prefix_cache=True,
                                         overlap_collectives=True),
                     "mix", None),
    "deepseek": ("deepseek-moe-16b", {},
                 dict(prefill_chunk=8, prefix_cache=True, **MOE_KW),
                 "mix", None),
    "deepseek_overlap": ("deepseek-moe-16b", {},
                         dict(prefill_chunk=8, prefix_cache=True,
                              overlap_collectives=True, **MOE_KW),
                         "mix", None),
    "deepseek_grouped": ("deepseek-moe-16b", {},
                         dict(prefill_chunk=8, gemv_expert_shape="grouped",
                              **MOE_KW), "mix", None),
    "grok": ("grok-1-314b", {}, dict(prefill_chunk=8, prefix_cache=True),
             "mix", None),
    "kv_replicated": ("olmo-1b", {"n_kv_heads": 1},
                      dict(prefill_chunk=8, prefix_cache=True), "mix", None),
    "clocks": ("olmo-1b", {}, dict(batch_slots=2), "preempt", PREEMPT),
}


def case_config(name: str):
    arch, over, _, _, _ = CASES[name]
    return dataclasses.replace(get_config(arch).reduced(), **over)


def case_plan(name: str, vocab: int) -> list[tuple]:
    return mix_plan(vocab) if CASES[name][3] == "mix" \
        else preempt_plan(vocab)


def drive(eng, make_req, plan, clk, tick: float = 0.0) -> dict:
    """Serve ``plan``: each request submitted at its step; the clock
    advances ``tick`` a step.  Returns {rid: request}."""
    reqs, pending, step = {}, list(plan), 0
    while (pending or eng.active or eng._prefilling
           or eng.scheduler.queue):
        for item in [p for p in pending if p[0] <= step]:
            _, rid, prompt, n, deadline = item
            reqs[rid] = make_req(rid=rid, prompt=prompt, max_new_tokens=n,
                                 deadline=deadline)
            eng.submit(reqs[rid])
            pending.remove(item)
        eng.step()
        clk.advance(tick)
        step += 1
        if step >= 300:
            raise AssertionError("the plan did not drain")
    return reqs


def serve(name: str, mesh=None, clock_offset: float = 0.0,
          tracer=None) -> dict:
    """Case ``name`` on the port's engine (this rank's share with
    ``mesh``): tokens, sampled logits rows, counters."""
    _, _, kw, _, sched = CASES[name]
    cfg = case_config(name)
    params = lm.init_lm(cfg, seed=0, device="cpu", mesh=mesh)
    clk = FakeClock(clock_offset)
    kw = {"batch_slots": 4, **kw}
    dispatch.clear_plan_cache()
    eng = Engine(cfg, params, max_len=MAX_LEN, device="cpu", clock=clk,
                 mesh=mesh, tracer=tracer,
                 scheduler=(SchedulerConfig(**sched) if sched else "fcfs"),
                 **kw)
    rows: dict[int, list] = {}
    sample = eng._sample

    def recorded(r, row):
        rows.setdefault(r.rid, []).append(np.array(row))
        return sample(r, row)

    eng._sample = recorded
    moves, compact = [], eng.kv.compact

    def counted():
        m = compact()
        moves.append(len(m))
        return m

    eng.kv.compact = counted
    reqs = drive(eng, Request, case_plan(name, cfg.vocab), clk)
    return {"tokens": {rid: list(r.generated) for rid, r in reqs.items()},
            "rows": rows, "stats": dispatch.dispatch_stats(),
            "counters": dict(eng.metrics.counters),
            "defrag_moves": sum(moves),
            "prefix": (eng.prefix.stats() if eng.prefix is not None
                       else None),
            "graphs": eng.graphs, "graphs_reason": eng.graphs_reason}


# --------------------------------------------------------------------------
# rank functions
# --------------------------------------------------------------------------


def run_cases(mesh, names, table_dir=None) -> dict:
    """Every case in ``names`` on this rank (rank r's clock ``r *
    CLOCK_OFFSET`` ahead in the "clocks" case), then with ``table_dir``
    :func:`serve_tuned`, then the compressed gradient means."""
    out = {}
    for name in names:
        offset = mesh.rank * CLOCK_OFFSET if name == "clocks" else 0.0
        out[name] = serve(name, mesh=mesh, clock_offset=offset)
    if table_dir is not None:
        out["tuned"] = serve_tuned(mesh, table_dir)
    out["psum"] = psum_rounds(mesh)
    out["coords"] = dict(mesh.coords)
    return out


def serve_tuned(mesh, table_dir: str) -> dict:
    """The "olmo" case with a table on rank 0 alone: a calibration entry
    for the ``cpu`` backend (its bandwidth doubled), and a tracer that
    times every fresh decision (decisions no other rank meets).  The
    engine shares rank 0's table, so every rank prices with the
    calibrated constants; then each rank asks to save the table into
    ``table_dir``."""
    dispatch.clear_autotune_table()
    tracer = None
    if mesh.rank == 0:
        seed = get_backend("cpu").seed_cost_model
        dispatch.autotune_table().put_calibration("cpu", {
            "schema": 1, "constants": seed.with_constants(
                bandwidth_gbps=seed.bandwidth_gbps * 2).constants()})
        tracer = Tracer(timing=True)
    try:
        out = serve("olmo", mesh=mesh, tracer=tracer)
        path = os.path.join(table_dir, f"table{mesh.rank}.json")
        out["wrote"] = tuning.save_autotune_table(path, mesh)
        out["file"] = os.path.exists(path)
        out["traced"] = 0 if tracer is None else len(tracer.dispatches)
    finally:
        uninstall_tracer(tracer)
        dispatch.clear_autotune_table()
    out.pop("graphs")
    return out


def psum_inputs(rank: int) -> dict:
    """A rank's gradients for two rounds (a dict and a list leaf)."""
    rng = np.random.default_rng(100 + rank)
    return [{"w": rng.standard_normal((4, 6)).astype(np.float32) * 3,
             "b": [rng.standard_normal(5).astype(np.float32)]}
            for _ in range(2)]


def psum_rounds(mesh) -> dict:
    """``compressed_psum_mean`` over the 'model' group with each method,
    two rounds, the int8 residual carried: each round's means and
    residuals as numpy."""
    out = {}
    group = mesh.group("model")
    for method in ("none", "bf16", "int8"):
        ef, rounds = None, []
        for g in psum_inputs(mesh.index("model")):
            grads = {"w": torch.from_numpy(g["w"]),
                     "b": [torch.from_numpy(g["b"][0])]}
            mean, ef = coll.compressed_psum_mean(grads, group, method, ef)
            rounds.append((
                {"w": mean["w"].numpy(), "b": mean["b"][0].numpy()},
                None if ef is None else {"w": ef["w"].numpy(),
                                         "b": ef["b"][0].numpy()}))
        out[method] = rounds
    return out


def skip_a_collective(mesh) -> None:
    """Rank 1 all-reduces; rank 0 never does (and waits)."""
    if mesh.rank == 1:
        dist.all_reduce(torch.ones(1), group=mesh.group("model"))
    else:
        dist.all_gather_object([None] * mesh.world_size, "never matched")


# --------------------------------------------------------------------------
# Sharded multimodal serving (test_torch_sharded_multimodal.py)
# --------------------------------------------------------------------------

MM_GATE = 0.75      # every cross_gate (the init's zeros hide the cross path)
MM_KW = dict(prefill_chunk=8, prefix_cache=True)
# name: (arch, config overrides (``encoder``: the encoder's width), engine
# kwargs beside MM_KW); whisper also with an encoder of width 32 (``proj``)
# and with an odd vocab (embedding and head whole on every rank),
# llama-vision at 2 groups of 2 layers
MM_CASES = {
    "whisper": ("whisper-small", {}, {}),
    "whisper_overlap": ("whisper-small", {}, {"overlap_collectives": True}),
    "whisper_enc32": ("whisper-small", {"encoder": 32}, {}),
    "whisper_vocab255": ("whisper-small", {"vocab": 255}, {}),
    "vision": ("llama-3.2-vision-11b", {"n_layers": 4}, {}),
    "vision_overlap": ("llama-3.2-vision-11b", {"n_layers": 4},
                       {"overlap_collectives": True}),
    # one kv head: K / V whole on every rank, self and cross, each rank
    # projecting the kv head its query heads share
    "vision_kv1": ("llama-3.2-vision-11b", {"n_layers": 4, "n_kv_heads": 1},
                   {}),
}


def mm_overrides(cfg, over: dict) -> dict:
    """``over`` for ``cfg`` (the port's or the JAX package's reduced
    config): ``encoder=w`` sets the encoder's width."""
    over = dict(over)
    if "encoder" in over:
        over["encoder"] = dataclasses.replace(cfg.encoder,
                                              d_model=over["encoder"])
    return over


def mm_config(name: str):
    cfg = get_config(MM_CASES[name][0]).reduced()
    return dataclasses.replace(cfg, **mm_overrides(cfg, MM_CASES[name][1]))


def gated(params: dict, gate: float = MM_GATE) -> dict:
    """``params`` with every layer's ``cross_gate`` filled with ``gate``
    (in place; whole on every rank)."""
    for p in params["layers"]:
        if "cross_gate" in p:
            p["cross_gate"].fill_(gate)
    return params


def mm_params(name: str, mesh=None) -> dict:
    """Case ``name``'s weights: the port's seeded init (this rank's blocks
    with ``mesh``), gated."""
    return gated(lm.init_lm(mm_config(name), seed=0, device="cpu",
                            mesh=mesh))


def mm_blocks(params: dict) -> dict:
    """The encoder's and the cross layers' leaves of a param tree, by
    path."""
    from repro_torch.tree import flatten_with_paths, path_str

    return {path_str(p): t.clone() for p, t in flatten_with_paths(params)
            if p[0] == "encoder"
            or {"cross", "cross_gate", "ln_cross"} & set(p)}


def mm_serve(name: str, mesh=None) -> dict:
    """Case ``name`` on the port's engine (this rank's share with
    ``mesh``) over the mixed plan: tokens, sampled logits rows, counters,
    compaction moves, the feature rows before and after, and the blocks
    the rank was drawn with and the shapes its engine holds."""
    from repro_torch.tree import flatten_with_paths, path_str

    cfg = mm_config(name)
    params = mm_params(name, mesh)
    clk = FakeClock()
    dispatch.clear_plan_cache()
    eng = Engine(cfg, params, max_len=MAX_LEN, device="cpu", clock=clk,
                 mesh=mesh, batch_slots=4, **MM_KW, **MM_CASES[name][2])
    before = {k: v.clone() for k, v in eng.features.items()}
    rows: dict[int, list] = {}
    sample = eng._sample

    def recorded(r, row):
        rows.setdefault(r.rid, []).append(np.array(row))
        return sample(r, row)

    eng._sample = recorded
    moves, compact = [], eng.kv.compact

    def counted():
        m = compact()
        moves.append(len(m))
        return m

    eng.kv.compact = counted
    reqs = drive(eng, Request, mix_plan(cfg.vocab), clk)
    return {"tokens": {rid: list(r.generated) for rid, r in reqs.items()},
            "rows": rows, "stats": dispatch.dispatch_stats(),
            "counters": dict(eng.metrics.counters),
            "defrag_moves": sum(moves), "features_before": before,
            "features": {k: v.clone() for k, v in eng.features.items()},
            "prefix": eng.prefix, "graphs": eng.graphs,
            "graphs_reason": eng.graphs_reason,
            "drawn": mm_blocks(params),
            "held": {path_str(p): tuple(t.shape)
                     for p, t in flatten_with_paths(eng.params)
                     if isinstance(t, torch.Tensor)}}


def run_mm_cases(mesh, names) -> dict:
    """Every multimodal case in ``names`` on this rank."""
    out = {name: mm_serve(name, mesh) for name in names}
    out["coords"] = dict(mesh.coords)
    return out


# --------------------------------------------------------------------------
# Sharded recurrent serving (test_torch_sharded_state.py)
# --------------------------------------------------------------------------

STATE_KW = dict(prefill_chunk=8, prefix_cache=True)
# name: (arch, config overrides, plan); rwkv6 (2 heads of 32: one a rank)
# and hymba (4 heads and 4 kv heads: attention cut beside the Mamba
# channels), hymba with 5 heads (attention whole on every rank, the
# Mamba mixer cut: the full width's placement), and a preemption (hymba:
# its K/V and its state rows re-prefilled)
STATE_CASES = {
    "rwkv": ("rwkv6-3b", {}, "mix"),
    "hymba": ("hymba-1.5b", {}, "mix"),
    "hymba_h5": ("hymba-1.5b", {"n_heads": 5, "n_kv_heads": 5}, "mix"),
    "hymba_preempt": ("hymba-1.5b", {}, "preempt"),
}


def state_config(name: str):
    arch, over, _ = STATE_CASES[name]
    return dataclasses.replace(get_config(arch).reduced(), **over)


def perturb_state(params: dict, cfg, seed: int = 0) -> dict:
    """``params`` (the whole tree) with the leaves the init leaves
    constant drawn afresh from ``seed``, in place, as the state families'
    tests perturb the JAX tree: rwkv6's ``u``, every ``mu``, ``w0``,
    ``ln_scale`` (time-mix projections x4); hymba's betas, ``D``,
    ``dt_bias``, ``A_log``.  The same values on every rank."""
    rng = np.random.default_rng(seed)

    def draw(t, x):
        t.copy_(torch.from_numpy(np.asarray(x, np.float32)).to(t.dtype))

    for p in params["layers"]:
        if "time_mix" in p:
            tm, cm = p["time_mix"], p["channel_mix"]
            draw(tm["u"], rng.standard_normal(tm["u"].shape))
            draw(tm["mu"], rng.uniform(0, 1, tm["mu"].shape))
            draw(tm["w0"], rng.standard_normal(tm["w0"].shape) - 0.5)
            draw(tm["ln_scale"], rng.uniform(0.5, 1.5, tm["ln_scale"].shape))
            for k in ("wr", "wk", "wv", "wg", "wo"):
                tm[k].mul_(4)
            draw(cm["mu"], rng.uniform(0, 1, cm["mu"].shape))
        if "mamba" in p:
            m = p["mamba"]
            for k in ("beta_attn", "beta_ssm"):
                draw(p[k], rng.uniform(2, 6, p[k].shape))
            draw(m["D"], rng.standard_normal(m["D"].shape))
            draw(m["dt_bias"], rng.standard_normal(m["dt_bias"].shape) - 2)
            draw(m["A_log"], rng.standard_normal(m["A_log"].shape) - 1)
    return params


def state_params(name: str) -> dict:
    """Case ``name``'s whole weights: the port's seeded init, perturbed."""
    cfg = state_config(name)
    return perturb_state(lm.init_lm(cfg, seed=0, device="cpu"), cfg)


def state_plan(name: str, vocab: int) -> list[tuple]:
    return mix_plan(vocab) if STATE_CASES[name][2] == "mix" \
        else preempt_plan(vocab)


def state_serve(name: str, mesh=None) -> dict:
    """Case ``name`` on the port's engine from the whole perturbed tree
    (cut to this rank's blocks by the engine with ``mesh``): tokens,
    sampled logits rows, counters, compaction moves, the prefix cache's
    stats and bytes, the state rows saved and restored, the cache leaves
    at the end, the shapes the engine holds, and (with ``mesh``) the
    blocks ``init_lm(mesh=)`` draws."""
    from repro_torch.tree import flatten_with_paths, path_str

    cfg = state_config(name)
    clk = FakeClock()
    dispatch.clear_plan_cache()
    preempt = STATE_CASES[name][2] == "preempt"
    eng = Engine(cfg, state_params(name), max_len=MAX_LEN, device="cpu",
                 clock=clk, mesh=mesh, batch_slots=2 if preempt else 4,
                 scheduler=(SchedulerConfig(**PREEMPT) if preempt
                            else "fcfs"), **STATE_KW)
    rows: dict[int, list] = {}
    sample = eng._sample

    def recorded(r, row):
        rows.setdefault(r.rid, []).append(np.array(row))
        return sample(r, row)

    eng._sample = recorded
    moves, compact = [], eng.kv.compact

    def counted():
        m = compact()
        moves.append(len(m))
        return m

    eng.kv.compact = counted
    saves, save = [], eng.kv.save_state

    def saved(slots):
        saves.append(len(list(slots)))
        return save(slots)

    eng.kv.save_state = saved
    reqs = drive(eng, Request, state_plan(name, cfg.vocab), clk)
    out = {"tokens": {rid: list(r.generated) for rid, r in reqs.items()},
           "rows": rows, "counters": dict(eng.metrics.counters),
           "defrag_moves": sum(moves), "saves": sum(saves),
           "prefix": eng.prefix.stats() if eng.prefix is not None else None,
           "prefix_bytes": (eng.prefix.bytes_used if eng.prefix is not None
                            else None),
           "cache": {k: v.clone() for k, v in eng.kv.cache.items()},
           "scales": dict(eng.kv.scales),
           "held": {path_str(p): tuple(t.shape)
                    for p, t in flatten_with_paths(eng.params)
                    if isinstance(t, torch.Tensor)}}
    if mesh is not None:
        out["drawn"] = {path_str(p): t for p, t in flatten_with_paths(
            lm.init_lm(cfg, seed=0, device="cpu", mesh=mesh))}
    return out


def run_state_cases(mesh, names) -> dict:
    """Every recurrent case in ``names`` on this rank."""
    out = {name: state_serve(name, mesh) for name in names}
    out["coords"] = dict(mesh.coords)
    return out


# --------------------------------------------------------------------------
# Data-parallel training (test_torch_train_mesh.py)
# --------------------------------------------------------------------------

TRAIN_ARCHS = ("olmo-1b", "deepseek-moe-16b")
TRAIN_BATCH, TRAIN_SEQ = 4, 16      # global rows, positions


def train_one(arch: str, mesh=None, accum: int = 1) -> dict:
    """One step of the reduced ``arch`` from the port's seeded init on
    the global batch of step 0: the step's gradients (before the clip),
    loss and aux, the updated params and the metrics, on the CPU (on a
    mesh the rank steps on its stored blocks, and the gradients and
    params come back whole, gathered from every rank's)."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.distributed import sharding as shd
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import TrainConfig, build_train_step

    cfg = get_config(arch).reduced()
    params = lm.init_lm(cfg, seed=0, device="cpu", mesh=mesh, train=True)
    tcfg = TrainConfig(opt=OptConfig(name=cfg.optimizer, lr=1e-3,
                                     warmup_steps=1, total_steps=10),
                       accum_steps=accum)
    step, opt_init = build_train_step(cfg, tcfg, mesh=mesh)
    batch = SyntheticLM(cfg, DataConfig(global_batch=TRAIN_BATCH,
                                        seq_len=TRAIN_SEQ)).batch_at(0)
    if accum > 1:
        batch = {k: v.reshape((accum, -1) + v.shape[1:])
                 for k, v in batch.items()}
    grads, loss, aux = step.grads(params, batch)
    new, _, metrics = step(params, opt_init(params), batch)
    if mesh is not None:
        grads, new = shd.gather_train_tree((grads, new), mesh, cfg)
    return {"grads": grads, "loss": float(loss), "aux": float(aux),
            "params": new, "metrics": {k: float(v)
                                       for k, v in metrics.items()}}


def train_ranks(mesh, ckpt_dir: str) -> dict:
    """Every data-parallel case on this rank of a (2, 1) mesh: one step
    of each ``TRAIN_ARCHS`` model, olmo-1b with accumulation, and the
    launcher (``--mesh 2x1``) through a fault at step 3."""
    from repro_torch.launch import train as launcher

    out = {arch: train_one(arch, mesh) for arch in TRAIN_ARCHS}
    out["accum"] = train_one("olmo-1b", mesh, accum=2)
    out["launcher"] = launcher.run_on_mesh(
        mesh, train_launcher_argv(ckpt_dir) + ["--mesh", "2x1"],
        fail_at=(3,))
    out["ckpt_steps"] = sorted(os.listdir(ckpt_dir)) if mesh.rank == 0 \
        else None
    return out


def train_launcher_argv(ckpt_dir: str,
                        arch: str = "deepseek-moe-16b") -> list[str]:
    return ["--arch", arch, "--smoke", "--steps", "6",
            "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
            "--ckpt-every", "2", "--ckpt-dir", ckpt_dir, "--device", "cpu"]


# --------------------------------------------------------------------------
# Model-parallel training (test_torch_train_tp.py)
# --------------------------------------------------------------------------

# name: (arch, config overrides, OptConfig overrides); grok-1-314b's
# Adafactor factors at 8, so that leaves a cut splits factor (embed, wo,
# the experts, the router); olmo-1b with one kv head: K / V whole on
# every rank, each rank reading the kv head its query heads share;
# whisper-small (its encoder and every layer's cross-attention as rank
# blocks) and llama-vision at 2 groups (also with one kv head: the cross
# layers' K / V weights whole on every rank), every cross_gate at MM_GATE;
# rwkv6 (each time-mix on a rank's heads, each channel-mix on its d_ff
# columns) and hymba with 5 heads (attention whole on every rank beside
# the Mamba mixer's channels, w_in as [x1_r | z_r]: the full width's
# placement) under Adafactor factored at 8, so that w_in's column
# statistic is cut as the pair
TP_CASES = {"olmo": ("olmo-1b", {}, {}),
            "olmo_kv1": ("olmo-1b", {"n_kv_heads": 1}, {}),
            "deepseek": ("deepseek-moe-16b", {}, {}),
            "grok": ("grok-1-314b", {}, {"factored_min_dim": 8}),
            "whisper": ("whisper-small", {}, {}),
            "vision": ("llama-3.2-vision-11b", {"n_layers": 4}, {}),
            "vision_kv1": ("llama-3.2-vision-11b",
                           {"n_layers": 4, "n_kv_heads": 1}, {}),
            "rwkv": ("rwkv6-3b", {}, {}),
            "hymba": ("hymba-1.5b", {"n_heads": 5, "n_kv_heads": 5,
                                     "optimizer": "adafactor"},
                      {"factored_min_dim": 8})}
TP_BATCH, TP_SEQ = 4, 16        # global rows, positions
TP_CKPT_CASE = "grok"           # the state a (2, 2) mesh checkpoints
TP_MM_CKPT_CASE = "whisper"     # and of a multimodal model
TP_MM_CASES = ("whisper", "vision")
TP_STATE_CKPT_CASE = "hymba"    # and of a recurrent model (w_in's pair)
TP_STATE_CASES = ("rwkv", "hymba")


def tp_config(name: str, **over):
    arch, cfg_over, _ = TP_CASES[name]
    return dataclasses.replace(get_config(arch).reduced(),
                               **{**cfg_over, **over})


def tp_train_config(name: str, cfg, **kw):
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import TrainConfig

    return TrainConfig(opt=OptConfig(name=cfg.optimizer, lr=1e-3,
                                     warmup_steps=1, total_steps=10,
                                     **TP_CASES[name][2]), **kw)


def tp_batch(cfg, accum: int = 1) -> dict:
    from repro_torch.data.pipeline import DataConfig, SyntheticLM

    batch = SyntheticLM(cfg, DataConfig(global_batch=TP_BATCH,
                                        seq_len=TP_SEQ)).batch_at(0)
    if accum > 1:
        batch = {k: v.reshape((accum, -1) + v.shape[1:])
                 for k, v in batch.items()}
    return batch


def tp_step(name: str, mesh=None, *, params=None, accum: int = 1,
            compress: str = "none", remat: bool | None = None,
            full_step: bool = True) -> dict:
    """Case ``name``'s step from the port's seeded init (or ``params``, a
    full tree), on this rank's stored blocks with ``mesh``: the step's
    gradients (before the clip), loss and aux, and with ``full_step``
    the updated params, optimizer state and metrics.  On a mesh every
    tree comes back whole (gathered), beside the rank's own stored
    blocks (``blocks``) and the shapes it stores (``shapes``)."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.train.train_step import build_train_step

    over = {} if remat is None else {"remat": remat}
    cfg = tp_config(name, **over)
    tcfg = tp_train_config(name, cfg, accum_steps=accum,
                           grad_compress=compress)
    step, opt_init = build_train_step(cfg, tcfg, mesh=mesh)
    if params is None:
        params = gated(lm.init_lm(cfg, seed=0, device="cpu", mesh=mesh,
                                  train=True))
    elif mesh is not None:
        params = shd.shard_train_tree(params, mesh, cfg)
    batch = tp_batch(cfg, accum)
    grads, loss, aux = step.grads(params, batch)
    out = {"grads": grads, "loss": float(loss), "aux": float(aux)}
    if full_step:
        state = opt_init(params)
        new, new_state, metrics = step(params, state, batch)
        out.update(params=new, opt=new_state,
                   metrics={k: float(v) for k, v in metrics.items()})
    if mesh is None:
        return out
    trees = {k: out[k] for k in ("grads", "params", "opt") if k in out}
    out["blocks"] = trees
    out["shapes"] = {k: [tuple(t.shape) for t in leaves(v)]
                     for k, v in trees.items()}
    out.update(shd.gather_train_tree(trees, mesh, cfg))
    return out


def tp_update(name: str, grads, mesh=None) -> dict:
    """The clip and the optimizer update of case ``name`` from its seeded
    init on the full gradients ``grads``: on this rank's blocks of them
    with ``mesh`` (returned whole), else on one process.  Isolates the
    update across shards from the gradients' summation order."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.train.optimizer import clip_by_global_norm, \
        make_optimizer
    from repro_torch.train.train_step import train_layout

    cfg = tp_config(name)
    tcfg = tp_train_config(name, cfg)
    layout = train_layout(cfg, mesh)
    params = gated(lm.init_lm(cfg, seed=0, device="cpu",
                              mesh=mesh if layout is not None else None,
                              train=True))
    if layout is not None:
        grads = shd.shard_train_tree(grads, mesh, cfg)
    init, update = make_optimizer(tcfg.opt, cfg, layout)
    clipped, norm = clip_by_global_norm(grads, tcfg.opt.grad_clip, layout)
    new, state = update(tcfg.opt, clipped, init(params), params)
    out = {"params": new, "opt": state, "norm": float(norm)}
    if layout is not None:
        out.update(shd.gather_train_tree({"params": new, "opt": state},
                                         mesh, cfg))
    return out


def tp_functions(mesh) -> dict:
    """The three collectives' backwards on two ranks, each beside what its
    plain-tensor rule gives; and an MoE layer whose experts are cut over
    'model' beside whole shared experts, against the whole layer."""
    from repro_torch.distributed.axes import activation_mesh
    from repro_torch.models import layers as L

    group, r = mesh.group("model"), mesh.index("model")
    g = torch.Generator().manual_seed(7)
    x = torch.randn(3, 5, generator=g)
    w = torch.randn(2, 3, 5, generator=g)       # rank r's factor: w[r]
    c = torch.randn(3, 5, generator=g)
    z = torch.randn(2, 3, 4, generator=g)       # rank r's block: z[r]
    c2 = torch.randn(3, 8, generator=g)
    xe = x.clone().requires_grad_(True)
    y = coll.enter(xe, group) * w[r]
    y.retain_grad()
    out = coll.all_reduce_sum(y, group)
    zr = z[r].clone().requires_grad_(True)
    gathered = coll.all_gather_cat(zr, group, dim=-1)
    ((out * c).sum() + (gathered * c2).sum()).backward()
    res = {"x_grad": xe.grad, "y_grad": y.grad, "z_grad": zr.grad,
           "out": out.detach(), "gathered": gathered.detach(),
           "inputs": (x, w, c, z, c2), "rank": r}

    # experts cut, shared experts whole: the shared branch gets no enter
    cfg = get_config("deepseek-moe-16b").reduced()
    p = L.init_moe(torch.Generator().manual_seed(3), cfg, torch.float32,
                   "cpu")
    h = torch.randn(2, 6, cfg.d_model, generator=g)
    cy = torch.randn(2, 6, cfg.d_model, generator=g)
    n = mesh.size("model")
    mine = {k: (v if k not in ("w_gate", "w_up", "w_down")
                else v.chunk(n)[r].clone()) for k, v in p.items()}

    def grads_of(tree, run):
        ps = {k: (v.clone().requires_grad_(True) if k != "shared"
                  else {a: b.clone().requires_grad_(True)
                        for a, b in v.items()})
              for k, v in tree.items()}
        hx = h.clone().requires_grad_(True)
        y, aux = run(ps, hx)
        ((y * cy).sum() + aux).backward()
        return {"h": hx.grad, "router": ps["router"].grad,
                "shared": {a: b.grad for a, b in ps["shared"].items()},
                "experts": {k: ps[k].grad for k in ("w_gate", "w_up",
                                                     "w_down")},
                "y": y.detach()}

    def sharded(ps, hx):
        with activation_mesh(mesh):
            y, aux, partial = L.moe_partial(ps, hx, cfg)
        assert not partial
        return y, aux

    res["moe"] = grads_of(mine, sharded)
    res["moe_whole"] = grads_of(p, lambda ps, hx: L.apply_moe(ps, hx, cfg))
    return res


def tp_backward_in_a_thread(mesh) -> dict:
    """Case "olmo"'s loss (remat on) formed under the mesh, its gradients
    taken on another thread, where the forward's context is not set (on
    the card the autograd engine runs the backward, and so remat's
    recompute, on a device thread): the gradients, or the error."""
    import threading

    from repro_torch.distributed.axes import activation_mesh
    from repro_torch.train.train_step import loss_fn, to_device
    from repro_torch.tree import unflatten_like

    cfg = tp_config("olmo")
    tcfg = tp_train_config("olmo", cfg)
    params = lm.init_lm(cfg, seed=0, device="cpu", mesh=mesh, train=True)
    ps = [t.detach().requires_grad_(True) for t in leaves(params)]
    batch = to_device(tp_batch(cfg), "cpu")
    with activation_mesh(mesh):
        total, _ = loss_fn(unflatten_like(params, ps), cfg, batch, tcfg)
    out = {}

    def backward():
        try:
            out["grads"] = unflatten_like(params, torch.autograd.grad(
                total, ps))
        except Exception as e:      # noqa: BLE001 (the test reads it)
            out["error"] = repr(e)

    t = threading.Thread(target=backward)
    t.start()
    t.join()
    return out


def tp_save(mesh, name: str, blocks: dict, directory: str) -> None:
    """Case ``name``'s stepped params and state (this rank's blocks)
    saved into ``directory`` from this mesh: full leaves, rank 0
    writing."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.distributed import sharding as shd

    state = {"params": blocks["params"], "opt": blocks["opt"]}
    CheckpointManager(directory, group=torch.distributed.group.WORLD).save(
        1, state, shardings=shd.train_specs_of(state, mesh, tp_config(name)),
        mesh=mesh)


def tp_restore(mesh, name: str, directory: str) -> dict:
    """The state saved in ``directory`` restored onto this mesh over a
    template of case ``name`` drawn from another seed: the shapes of the
    rank's blocks and the full leaves, gathered back."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.distributed import sharding as shd
    from repro_torch.train.train_step import build_train_step

    cfg = tp_config(name)
    _, opt_init = build_train_step(cfg, tp_train_config(name, cfg),
                                   mesh=mesh)
    params = lm.init_lm(cfg, seed=1, device="cpu", mesh=mesh, train=True)
    template = {"params": params, "opt": opt_init(params)}
    mgr = CheckpointManager(directory, group=torch.distributed.group.WORLD)
    restored, _ = mgr.restore(
        template, shardings=shd.train_specs_of(template, mesh, cfg),
        mesh=mesh)
    return {"shapes": [tuple(t.shape) for t in leaves(restored)],
            "full": shd.gather_train_tree(restored, mesh, cfg)}


def tp_ranks(mesh, bridged=None, ckpt_dir: str | None = None,
             restore_from: str | None = None,
             launcher_dir: str | None = None, bridged_mm=None,
             mm_ckpt_dir: str | None = None,
             mm_restore_from: str | None = None,
             mm_launcher_dirs: dict | None = None,
             state_ckpt_dir: str | None = None,
             state_restore_from: str | None = None) -> dict:
    """Every model-parallel training case on this rank.  On any mesh:
    each ``TP_CASES`` step, and the update on the same gradients.  With
    ``bridged`` (the JAX package's deepseek-moe-16b tree as numpy) its
    gradients, and with ``bridged_mm`` ({case: the JAX package's gated
    tree}) each multimodal case's; on a (1, D) mesh also remat off,
    accumulation, bf16 compression and the collectives' backwards.  With
    ``ckpt_dir`` (``mm_ckpt_dir``) case ``TP_CKPT_CASE``'s
    (``TP_MM_CKPT_CASE``'s) stepped state is saved there from this mesh;
    with ``restore_from`` (``mm_restore_from``) the state saved there is
    restored onto this mesh.  With ``launcher_dir`` ``launch/train.py
    --mesh DxM`` runs through a fault at step 3, and with
    ``mm_launcher_dirs`` ({arch: directory}) so does each arch's.
    ``state_ckpt_dir`` / ``state_restore_from`` save and restore
    ``TP_STATE_CKPT_CASE``'s state as the others; ``bridged_mm`` may hold
    the recurrent cases' trees too."""
    from repro_torch.bridge import params_from_numpy
    from repro_torch.launch import train as launcher

    out = {"coords": dict(mesh.coords)}
    d, m = mesh.size("data"), mesh.size("model")
    for name in TP_CASES:
        out[name] = tp_step(name, mesh)
        one = tp_step(name, full_step=False)
        out[name]["same_grads"] = tp_update(name, one["grads"], mesh)
        out[name]["one_grads"] = one["grads"]
    if bridged is not None:
        cfg = tp_config("deepseek")
        out["bridged"] = tp_step("deepseek", mesh, full_step=False,
                                 params=params_from_numpy(bridged, cfg,
                                                          "cpu"))
    for name, tree in (bridged_mm or {}).items():
        out[f"bridged_{name}"] = tp_step(
            name, mesh, full_step=False,
            params=params_from_numpy(tree, tp_config(name), "cpu"))
    if mesh.size("data") == 1:
        for name in ("olmo", "deepseek"):
            out[f"{name}_remat_off"] = tp_step(name, mesh, remat=False,
                                               full_step=False)
        out["accum"] = tp_step("olmo", mesh, accum=2, full_step=False)
        out["bf16"] = tp_step("olmo", mesh, compress="bf16",
                              full_step=False)
        out["functions"] = tp_functions(mesh)
        out["thread_backward"] = tp_backward_in_a_thread(mesh)
    if ckpt_dir is not None:
        tp_save(mesh, TP_CKPT_CASE, out[TP_CKPT_CASE]["blocks"], ckpt_dir)
    if mm_ckpt_dir is not None:
        tp_save(mesh, TP_MM_CKPT_CASE, out[TP_MM_CKPT_CASE]["blocks"],
                mm_ckpt_dir)
    if restore_from is not None:
        got = tp_restore(mesh, TP_CKPT_CASE, restore_from)
        out["restored_shapes"], out["restored"] = got["shapes"], got["full"]
    if mm_restore_from is not None:
        out["mm_restored"] = tp_restore(mesh, TP_MM_CKPT_CASE,
                                        mm_restore_from)
    if state_ckpt_dir is not None:
        tp_save(mesh, TP_STATE_CKPT_CASE,
                out[TP_STATE_CKPT_CASE]["blocks"], state_ckpt_dir)
    if state_restore_from is not None:
        out["state_restored"] = tp_restore(mesh, TP_STATE_CKPT_CASE,
                                           state_restore_from)
    if launcher_dir is not None:
        out["launcher"] = launcher.run_on_mesh(
            mesh, train_launcher_argv(launcher_dir) + ["--mesh", f"{d}x{m}"],
            fail_at=(3,))
        out["ckpt_steps"] = (sorted(os.listdir(launcher_dir))
                             if mesh.rank == 0 else None)
    for arch, directory in (mm_launcher_dirs or {}).items():
        out[f"launcher {arch}"] = launcher.run_on_mesh(
            mesh, train_launcher_argv(directory, arch)
            + ["--mesh", f"{d}x{m}"], fail_at=(3,))
    return out


# --------------------------------------------------------------------------
# async_prefill and quantized rank blocks on a mesh
# (test_torch_sharded_async.py)
# --------------------------------------------------------------------------

ASYNC_KW = dict(async_prefill=True, prefill_chunk=8, prefix_cache=True)
# name: (arch, plan); every family of MESH_FAMILIES' kinds, each weight
# tree as its family's mesh tests draw it (the recurrent ones perturbed,
# whisper gated)
ASYNC_CASES = {
    "olmo": ("olmo-1b", "amix"),
    "olmo_preempt": ("olmo-1b", "apreempt"),
    "deepseek": ("deepseek-moe-16b", "amix"),
    "rwkv": ("rwkv6-3b", "amix"),
    "hymba": ("hymba-1.5b", "amix"),
    "hymba_preempt": ("hymba-1.5b", "apreempt"),
    "whisper": ("whisper-small", "amix"),
}


def async_plan(vocab: int) -> list[tuple]:
    """Chunk 8, 4 slots: a 20-token prompt (three chunks) and two short
    ones that finish at step 1, when a 30-token prompt's chain, issued in
    the slot above them, is in flight: the compaction moves it; at step 4
    a prompt that starts with the first one whole (landed at step 3) and
    7 tokens more: a prefix hit (a state snapshot for a recurrent model),
    whose tail chains from the slot's spliced row."""
    p = prompts(vocab, [20, 3, 4, 30, 7], seed=43)
    return [(0, 0, p[0], 6, None), (0, 1, p[1], 2, None),
            (0, 2, p[2], 2, None), (1, 3, p[3], 4, None),
            (4, 4, np.concatenate([p[0], p[4]]), 4, None)]


def async_preempt_plan(vocab: int) -> list[tuple]:
    """One slot, chunk 4: a 20-token prompt mid-chain when a request
    whose deadline (3.0 on rank 0's clock) is inside the margin arrives
    at step 1: the chain lands, is filed and its slot freed."""
    p = prompts(vocab, [20, 4], seed=23)
    return [(0, 0, p[0], 3, None), (1, 1, p[1], 2, 3.0)]


def async_config(name: str):
    arch = ASYNC_CASES[name][0]
    if arch == "whisper-small":
        return mm_config("whisper")
    return get_config(arch).reduced()


def async_params(name: str) -> dict:
    """Case ``name``'s whole weights: the port's seeded init (perturbed
    for a recurrent model, every ``cross_gate`` at ``MM_GATE``)."""
    cfg = async_config(name)
    params = lm.init_lm(cfg, seed=0, device="cpu")
    if cfg.family in ("ssm", "hybrid") or cfg.parallel_ssm:
        return perturb_state(params, cfg)
    return gated(params)


def async_engine_kw(name: str) -> dict:
    """The engine's arguments beside ``ASYNC_KW``: slots, chunk and
    scheduler of the case's plan (the JAX engine takes the same)."""
    if ASYNC_CASES[name][1] == "apreempt":
        return dict(batch_slots=1, prefill_chunk=4)
    return dict(batch_slots=4)


def async_plan_of(name: str, vocab: int) -> list[tuple]:
    return (async_preempt_plan(vocab) if ASYNC_CASES[name][1] == "apreempt"
            else async_plan(vocab))


def async_serve(name: str, mesh=None, async_prefill: bool = True) -> dict:
    """Case ``name`` on the port's engine with ``async_prefill`` (this
    rank's share with ``mesh``), from the whole tree: tokens, sampled
    rows, counters, the overlap counters, the chains a compaction moved,
    each chain that started past position 0 (a prefix hit) with whether
    its row started as the slot's spliced row (every state leaf and the
    landed positions, bit for bit), the sub-cache's and slot cache's leaf
    shapes."""
    cfg = async_config(name)
    kw = {**ASYNC_KW, **async_engine_kw(name),
          **(MOE_KW if cfg.moe is not None else {})}
    kw["async_prefill"] = async_prefill
    preempt = ASYNC_CASES[name][1] == "apreempt"
    clk = FakeClock()
    dispatch.clear_plan_cache()
    eng = Engine(cfg, async_params(name), max_len=MAX_LEN, device="cpu",
                 clock=clk, mesh=mesh,
                 scheduler=(SchedulerConfig(**PREEMPT) if preempt
                            else "fcfs"), **kw)
    rows: dict[int, list] = {}
    sample = eng._sample

    def recorded(r, row):
        rows.setdefault(r.rid, []).append(np.array(row))
        return sample(r, row)

    eng._sample = recorded
    moved, compact = [], eng._compact

    def spied_compact():
        before = set(eng._inflight)
        compact()
        moved.extend(sorted(before - set(eng._inflight)))

    eng._compact = spied_compact
    starts, issue = [], eng._issue_chain_chunk

    def spied_issue(slot, chunk, consumed, chunk_limit, *, final):
        fresh = slot not in eng._inflight
        if fresh and consumed > 0:
            row = eng._free_rows[0]
            run = eng._run_chunk

            def first_chunk(cache, r, features, ch, cons, limit):
                same = all(torch.equal(cache[n][:, r], eng.kv.cache[n][:, slot])
                           for n in eng.kv.state_names)
                same = same and all(
                    torch.equal(cache[n][:, r, :cons],
                                eng.kv.cache[n][:, slot, :cons])
                    for n in cache if n not in eng.kv.state_names
                    and n != "pos")
                starts.append({"consumed": consumed, "row": r,
                               "state_leaves": len(eng.kv.state_names),
                               "from_slot": bool(same),
                               "state_nonzero": all(
                                   bool(cache[n][:, r].any())
                                   for n in eng.kv.state_names)})
                eng._run_chunk = run
                return run(cache, r, features, ch, cons, limit)

            assert row >= 1
            eng._run_chunk = first_chunk
        return issue(slot, chunk, consumed, chunk_limit, final=final)

    if async_prefill:
        eng._issue_chain_chunk = spied_issue
    reqs = drive(eng, Request, async_plan_of(name, cfg.vocab), clk)
    stats = dispatch.dispatch_stats()
    return {"tokens": {rid: list(r.generated) for rid, r in reqs.items()},
            "rows": rows, "counters": dict(eng.metrics.counters),
            "overlap": stats["overlap"]["async_prefill"],
            "chains_moved": moved, "hit_chains": starts,
            "evictions": {rid: r.evictions for rid, r in reqs.items()},
            "inflight": len(eng._inflight),
            "chain_group": (eng.chain_mesh.group("model")
                            is not (mesh.group("model") if mesh else None)
                            if eng.chain_mesh is not None else None),
            "sub": {k: tuple(v.shape) for k, v in eng.sub.items()},
            "cache": {k: v.clone() for k, v in eng.kv.cache.items()}}


# quantized rank blocks: name: (K, M, bits, the float weight's axis);
# the K cuts on an odd M (a K cut or none), the last two where a K cut
# would split a 32-row scale block (K / 2 = 48): M is taken instead, or
# the weight stays whole
QUANT_CASES = {
    "int8_M": (128, 96, 8, "M"),
    "int8_K": (128, 45, 8, "K"),
    "int4_M": (128, 96, 4, "M"),
    "int4_K": (128, 45, 4, "K"),
    "int8_K_to_M": (96, 64, 8, "K"),
    "int4_whole": (96, 45, 4, "K"),
}
QUANT_B = 3


def quant_inputs(name: str) -> tuple[np.ndarray, np.ndarray]:
    """Case ``name``'s whole float weight ``w [M, K]`` and ``x [B, K]``
    (numpy, seeded by the case's shape)."""
    K, M, bits, _ = QUANT_CASES[name]
    rng = np.random.default_rng(K * 1000 + M + bits)
    return (rng.standard_normal((M, K)).astype(np.float32) / np.sqrt(K),
            rng.standard_normal((QUANT_B, K)).astype(np.float32))


def quant_blocks(mesh) -> dict:
    """Every ``QUANT_CASES`` weight quantized whole, cut to this rank's
    block (``sharding.shard_packed``) and dispatched with ``shard=`` its
    axis under a 2-shard policy on the ``cpu`` backend: through
    ``dispatch_dense`` alone, and the M cuts also as one fused program of
    two members (``dispatch_fused``); an M output gathered over 'model',
    a K partial all-reduced in f32.  Also each block against the block
    of the float weight quantized on its own."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels.backends import DispatchPolicy
    from repro_torch.kernels.ops import quantize_weight

    group = mesh.group("model")
    policy = DispatchPolicy(model_shards=2, backend="cpu")
    out = {}
    for name, (K, M, bits, prefer) in QUANT_CASES.items():
        w, x = quant_inputs(name)
        pw = quantize_weight(torch.from_numpy(w), bits=bits)
        block, axis = shd.shard_packed(pw, mesh, prefer)
        xt = torch.from_numpy(x)
        if axis == "K":
            xt = xt.chunk(2, dim=1)[mesh.index("model")]
        dispatch.clear_plan_cache()
        y = dispatch.dispatch_dense(xt[:, None], block, policy=policy,
                                    shard=axis)[:, 0]
        if axis == "M":
            y = coll.all_gather_cat(y, group, dim=-1)
        elif axis == "K":
            y = coll.all_reduce_sum(y, group)
        res = {"axis": axis, "y": y, "stats": dispatch.dispatch_stats(),
               "block_shape": (tuple(block.w_t.shape),
                               tuple(block.scales.shape))}
        # the same block as the rank's own float block quantized: a cut
        # of whole scale blocks changes no scale
        wf = torch.from_numpy(w)
        own = quantize_weight(
            wf.chunk(2, dim=0)[mesh.index("model")] if axis == "M" else
            wf.chunk(2, dim=1)[mesh.index("model")] if axis == "K" else wf,
            bits=bits)
        res["equals_own"] = (torch.equal(own.w_t, block.w_t)
                             and torch.equal(own.scales, block.scales))
        if axis == "M":
            dispatch.clear_plan_cache()
            a, b = dispatch.dispatch_fused(
                torch.from_numpy(x), [block, block], policy=policy,
                shard=axis)
            res["fused"] = (coll.all_gather_cat(a, group, dim=-1),
                            coll.all_gather_cat(b, group, dim=-1))
            res["fused_stats"] = dispatch.dispatch_stats()
        out[name] = res
    return out


def run_async_cases(mesh, names) -> dict:
    """Every async case in ``names`` on this rank, then the quantized
    rank blocks."""
    out = {name: async_serve(name, mesh) for name in names}
    out["quant"] = quant_blocks(mesh)
    out["coords"] = dict(mesh.coords)
    return out


# --------------------------------------------------------------------------
# Training on a 'pod' axis (test_torch_train_pod.py)
# --------------------------------------------------------------------------

# each case on the spawn's (2, 2, 1) mesh (pod x data: the FSDP entry
# ("pod", "data") over 4 ranks) and on a (2, 1, 2) mesh made in the same
# world (pod beside 'model'); names are TP_CASES'
POD_CASES = ("olmo", "deepseek", "hymba")
POD_MESHES = {"2x2x1": (2, 2, 1), "2x1x2": (2, 1, 2)}
POD_CKPT_CASE = "hymba"        # saved from (2, 1, 2), restored onto (1, 2)
POD_SUB_CKPT_CASE = "olmo"     # saved from (1, 2), restored onto (2, 1, 2)


def pod_sub_mesh(mesh):
    """This rank's (1, 2) mesh over ranks {0, 1} or {2, 3} of a 4-rank
    world (every rank creates both groups, in the same order)."""
    from repro_torch.launch.mesh import Mesh

    groups = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    r = mesh.rank
    return Mesh(shape={"data": 1, "model": 2}, rank=r % 2,
                coords={"data": 0, "model": r % 2},
                groups={"data": None, "model": groups[r // 2]},
                device=mesh.device, backend=mesh.backend)


def pod_counts(mesh) -> list:
    """Case "deepseek"'s gradients on ``mesh`` with ``layers._aux_loss``
    watched: each call's routing counts summed over its ``batch_group``
    (the counts ``ce`` is formed from) and that group's size."""
    from repro_torch.distributed.collectives import all_reduce_sum, \
        group_size
    from repro_torch.models import layers as L
    from repro_torch.train.train_step import build_train_step

    cfg = tp_config("deepseek")
    step, _ = build_train_step(cfg, tp_train_config("deepseek", cfg),
                               mesh=mesh)
    params = lm.init_lm(cfg, seed=0, device="cpu", mesh=mesh, train=True)
    seen, plain = [], L._aux_loss

    def watch(probs, counts, cfg, batch_group=None):
        total = (counts if batch_group is None
                 else all_reduce_sum(counts, batch_group))
        seen.append((total.clone(), 1 if batch_group is None
                     else group_size(batch_group)))
        return plain(probs, counts, cfg, batch_group)

    L._aux_loss = watch
    try:
        step.grads(params, tp_batch(cfg))
    finally:
        L._aux_loss = plain
    return seen


def pod_bf16(mesh) -> dict:
    """Case "olmo"'s gradients with and without ``grad_compress="bf16"``
    on a batch whose row blocks are the same rows on every rank of the
    data axes (so each rank's gradients are the same bits), and with it
    on the usual batch."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.train.train_step import build_train_step

    cfg = tp_config("olmo")
    params = lm.init_lm(cfg, seed=0, device="cpu", mesh=mesh, train=True)
    batch = tp_batch(cfg)
    n = mesh.size(shd.fsdp_entry(mesh))
    same = {k: np.concatenate([v[: TP_BATCH // n]] * n)
            for k, v in batch.items()}
    out = {}
    for key, how, b in (("plain", "none", same), ("bf16", "bf16", same),
                        ("bf16_batch", "bf16", batch)):
        step, _ = build_train_step(
            cfg, tp_train_config("olmo", cfg, grad_compress=how), mesh=mesh)
        grads, _, _ = step.grads(params, b)
        out[key] = shd.gather_train_tree(grads, mesh, cfg)
    return out


def pod_ranks(mesh, one_grads: dict, bridged: dict, ckpt_dir: str,
              sub_ckpt_dir: str) -> dict:
    """Every 'pod' case on this rank of the spawn's (2, 2, 1) mesh and of
    a (2, 1, 2) mesh made in the same world: each ``POD_CASES`` step
    (``tp_step``), the update of the one-process gradients ``one_grads``
    on the rank's blocks of them, the gradients of the JAX package's
    trees ``bridged`` ({case: numpy tree}), the watched routing counts
    and the bf16 rule.  Then case ``POD_CKPT_CASE``'s (2, 1, 2) state is
    saved into ``ckpt_dir`` and restored onto a (1, 2) mesh (ranks {0, 1}
    and {2, 3}), and case ``POD_SUB_CKPT_CASE``'s state, stepped and
    saved from ranks {0, 1} as a (1, 2) mesh into ``sub_ckpt_dir``, is
    restored onto (2, 1, 2)."""
    from repro_torch.bridge import params_from_numpy
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import MULTI_POD_AXES, make_mesh

    meshes = {"2x2x1": mesh,
              "2x1x2": make_mesh((2, 1, 2), MULTI_POD_AXES,
                                 device=mesh.device)}
    sub = pod_sub_mesh(mesh)
    out = {"coords": {k: dict(m.coords) for k, m in meshes.items()}}
    for key, m in meshes.items():
        res = {}
        for name in POD_CASES:
            res[name] = tp_step(name, m)
            res[name]["same_grads"] = tp_update(name, one_grads[name], m)
            res[name]["bridged"] = tp_step(
                name, m, full_step=False,
                params=params_from_numpy(bridged[name], tp_config(name),
                                         "cpu"))["grads"]
        res["counts"] = pod_counts(m)
        res["bf16"] = pod_bf16(m)
        # the data axes' group, pod-major: every member's (pod, data)
        entry = shd.fsdp_entry(m)
        me = torch.tensor([[m.index("pod"), m.index("data")]])
        res["data_group"] = coll.all_gather_cat(me, m.group(entry), dim=0)
        out[key] = res
    m212 = meshes["2x1x2"]
    tp_save(m212, POD_CKPT_CASE, out["2x1x2"][POD_CKPT_CASE]["blocks"],
            ckpt_dir)
    out["restored_12"] = tp_restore(sub, POD_CKPT_CASE, ckpt_dir)
    if mesh.rank < 2:
        blocks = tp_step(POD_SUB_CKPT_CASE, sub)["blocks"]
        state = {"params": blocks["params"], "opt": blocks["opt"]}
        CheckpointManager(sub_ckpt_dir, group=sub.group("model")).save(
            1, state, shardings=shd.train_specs_of(
                state, sub, tp_config(POD_SUB_CKPT_CASE)), mesh=sub)
        out["sub_saved"] = shd.gather_train_tree(
            state, sub, tp_config(POD_SUB_CKPT_CASE))
    dist.barrier()
    out["restored_212"] = tp_restore(m212, POD_SUB_CKPT_CASE, sub_ckpt_dir)
    return out
