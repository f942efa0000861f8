"""The port's dry run (``launch/shapes.py``, ``launch/dryrun.py``) and the
collectives' counting mode, on the CPU and the meta device.

The shapes against the reference's ``launch/shapes.py`` (its
``jax.eval_shape`` stand-ins); on reduced cells over (1, 1), (1, 2) and
(2, 1, 2) mesh descriptions: the argument bytes against the rank's block
bytes worked out here from ``train_spec`` / ``serve_spec`` /
``slot_cache_spec``, the collective bytes against a count worked out
here from the layers, the flops of a dense prefill against the analytic
product count, the roofline's extrapolation against the full-depth
count; a kernel wrapper's plain route on meta tensors and never on CUDA
ones; one ``--serve-trace --device cpu`` record, and one ``--all
--continue-on-error`` pass over the reduced configs.  The reference's
``launch/dryrun.py`` sets ``XLA_FLAGS`` when imported, so it is never
imported here.  About 45 s in one process.
"""

import json
import math

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import ARCHS as TORCH_ARCHS
from repro_torch.configs.registry import get_config
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun, shapes
from repro_torch.launch.mesh import default_axes, describe_mesh
from repro_torch.models import lm
from repro_torch.tree import flatten_with_paths, leaves

jax = pytest.importorskip("jax")

from repro.configs.registry import ARCHS  # noqa: E402
from repro.launch import shapes as jshapes  # noqa: E402

torch.set_num_threads(1)

MESHES = {"1x1": (1, 1), "1x2": (1, 2), "2x1x2": (2, 1, 2)}
KINDS = ("train_4k", "prefill_32k", "decode_32k")


def test_shapes_and_applicable_are_the_references():
    assert list(shapes.SHAPES) == list(jshapes.SHAPES)
    for name, case in shapes.SHAPES.items():
        ref = jshapes.SHAPES[name]
        assert (case.name, case.seq_len, case.global_batch, case.kind) == \
            (ref.name, ref.seq_len, ref.global_batch, ref.kind)
    for arch in ARCHS:
        for name in shapes.SHAPES:
            assert shapes.applicable(get_config(arch),
                                     shapes.SHAPES[name]) == \
                jshapes.applicable(ARCHS[arch], jshapes.SHAPES[name])
    assert get_config("olmo-1b").param_count() == \
        ARCHS["olmo-1b"].param_count()


def _sig(tree):
    """A nested dict of tensors or of the reference's ShapeDtypeStructs as
    the same dict of (shape, dtype name)."""
    if isinstance(tree, dict):
        return {k: _sig(v) for k, v in tree.items()}
    return tuple(tree.shape), str(tree.dtype).removeprefix("torch.")


@pytest.mark.parametrize("shape", list(shapes.SHAPES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_input_and_cache_specs_are_the_references(arch, shape):
    """Every arch x shape: the port's meta stand-ins have the reference's
    ``jax.eval_shape`` shapes and dtypes, leaf for leaf (the cache
    through ``lm.init_cache(device="meta")``), at full size."""
    got = shapes.input_specs(get_config(arch), shapes.SHAPES[shape])
    want = jshapes.input_specs(ARCHS[arch], jshapes.SHAPES[shape])
    assert all(t.device.type == "meta" for t in leaves(got))
    assert _sig(got) == _sig(want)


def _bytes(shape, dtype) -> int:
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


def _rank_bytes(cfg, shape, mesh) -> int:
    """What a rank of ``mesh`` holds of a cell, from the placements:
    train, each param leaf's ``train_spec`` block and its AdamW moments
    (f32) and step, and its rows of the tokens; serve, each leaf's
    ``serve_spec`` block, each cache leaf's ``slot_cache_spec`` block and
    the rank's rows of the tokens."""
    case = shapes.SHAPES[shape]
    full = lm.init_lm(cfg, device="meta")
    rows = dryrun.data_rows(mesh, case.global_batch)
    total = 0
    for path, t in flatten_with_paths(full):
        p = "/".join(map(str, path))
        if case.kind == "train":
            block = shd.block_shape(tuple(t.shape), shd.train_spec(
                p, tuple(t.shape), mesh, cfg), mesh)
            total += _bytes(block, t.dtype) + 2 * _bytes(block,
                                                         torch.float32)
        else:
            block = shd.block_shape(tuple(t.shape), shd.serve_spec(
                p, tuple(t.shape), mesh, cfg), mesh)
            total += _bytes(block, t.dtype)
    if case.kind == "train":
        return total + 4 + _bytes((rows, case.seq_len), torch.int32)
    cache = lm.init_cache(cfg, rows, case.seq_len, device="meta")
    for name, t in cache.items():
        total += _bytes(shd.block_shape(tuple(t.shape), shd.slot_cache_spec(
            mesh, cfg, tuple(t.shape), name), mesh), t.dtype)
    S = 1 if case.kind == "decode" else case.seq_len
    return total + _bytes((rows, S), torch.int32)


def _cell(shape, mesh, **kw):
    return dryrun.run_cell("olmo-1b", shape, "cell", roofline=False,
                           reduced=True, mesh_shape=MESHES[mesh], **kw)


def _mesh(name):
    shape = MESHES[name]
    return describe_mesh(shape, default_axes(shape))


@pytest.mark.parametrize("shape", KINDS)
@pytest.mark.parametrize("mesh", MESHES)
def test_argument_bytes_are_the_ranks_block_bytes(mesh, shape):
    rec = _cell(shape, mesh)
    assert rec["status"] == "ok"
    cfg = dryrun.dryrun_config("olmo-1b", reduced=True)
    assert rec["memory"]["argument_size"] == _rank_bytes(cfg, shape,
                                                         _mesh(mesh))
    assert rec["memory"]["temp_size"] is None and rec["memory"]["note"]
    assert rec["n_chips"] == math.prod(MESHES[mesh])
    assert set(rec["no_counterpart"]) == {"lower_s", "compile_s",
                                          "hlo_lines"}


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
@pytest.mark.parametrize("mesh", ["1x2", "2x1x2"])
def test_collective_bytes_are_the_layers(mesh, shape):
    """Reduced olmo-1b serving on a 'model' axis of 2 (its 4 heads, FFN
    and vocab all cut): per layer the attention output and the FFN's
    partial sum all-reduced in f32, the embedding's rows all-reduced in
    f32, the head's logits of every position all-gathered in bf16; no
    collective over the data axes (serving replicates params there)."""
    cfg = dryrun.dryrun_config("olmo-1b", reduced=True)
    case = shapes.SHAPES[shape]
    rows = dryrun.data_rows(_mesh(mesh), case.global_batch)
    S = 1 if case.kind == "decode" else case.seq_len
    act = rows * S * cfg.d_model * 4
    rec = _cell(shape, mesh)
    assert rec["collective_bytes"] == {
        "all-reduce": (1 + 2 * cfg.n_layers) * act,
        "all-gather": rows * S * cfg.vocab * 2}
    assert rec["collective_calls"] == {"all-reduce": 1 + 2 * cfg.n_layers,
                                       "all-gather": 1}
    assert rec["collective_total"] == sum(rec["collective_bytes"].values())


def test_train_collectives_on_a_pod_mesh():
    """Reduced olmo-1b's train step on (2, 1, 2), 'model' cutting its
    heads, FFN and vocab, worked out from the layout and the layers.
    All-gathers: each leaf cut over ``("pod", "data")`` gathered into its
    'model' block (2 copies), and the head's logits (bf16).  All-reduces
    (f32): each gradient's 'model' block (the port's reduce-scatter is an
    all-reduce and a slice), the loss / aux pair; the embedding's rows,
    each layer's attention output and FFN partial sum, and the attention
    output again in remat's recompute (which stops once it has every
    tensor the backward saved: the FFN's sum, the layer's last op, is not
    one); in the backward, the gradient of each layer's
    attention and FFN input and of the head's input (``enter``); the
    clip's norm across shards."""
    cfg = dryrun.dryrun_config("olmo-1b", reduced=True)
    mesh = _mesh("2x1x2")
    case = shapes.SHAPES["train_4k"]
    rows = dryrun.data_rows(mesh, case.global_batch)
    act = rows * case.seq_len * cfg.d_model * 4
    full, specs = shd.model_specs(cfg, mesh)
    gather = reduce = 0
    for t, spec in zip(leaves(full), specs):
        block = shd.block_shape(tuple(t.shape),
                                [a if a == "model" else None for a in spec],
                                mesh)
        reduce += _bytes(block, torch.float32)
        if ("pod", "data") in spec:
            gather += _bytes(block, t.dtype)
    assert gather > 0 and cfg.remat
    # the clip's norm: one f32 scalar a cut entry of each group of leaves
    layout = shd.TrainLayout(mesh, specs)
    norm = 4 * sum(len(k) for k in {layout.cut_axes(j)
                                    for j in range(len(specs))})
    L = cfg.n_layers
    rec = _cell("train_4k", "2x1x2")
    assert rec["collective_bytes"] == {
        "all-gather": gather + rows * case.seq_len * cfg.vocab * 2,
        "all-reduce": reduce + 8 + norm
        + ((1 + 2 * L) + L + (2 * L + 1)) * act}


def _dense_prefill_flops(cfg, B, S) -> int:
    """The products of a dense, gated prefill over a cache of S: per
    layer Q/K/V, scores and probabilities x V over every cache position,
    the output projection, gate, up and down; then the head."""
    d, H, Hkv, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                        cfg.d_ff)
    layer = (2 * B * S * d * (H + 2 * Hkv) * hd + 2 * (2 * B * H * S * S * hd)
             + 2 * B * S * H * hd * d + 3 * (2 * B * S * d * f))
    return cfg.n_layers * layer + 2 * B * S * d * cfg.vocab


def test_flops_of_a_dense_prefill_are_the_analytic_count():
    cfg = dryrun.dryrun_config("olmo-1b", reduced=True)
    assert cfg.act == "silu" and cfg.moe is None
    case = shapes.SHAPES["prefill_32k"]
    rec = _cell("prefill_32k", "1x1")
    assert rec["flops"] == _dense_prefill_flops(cfg, case.global_batch,
                                                case.seq_len)
    assert rec["collective_bytes"] == {}


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_the_roofline_extrapolates_to_the_full_depth_count(shape):
    """A depth-linear config (olmo-1b, one period a layer) at 4 layers:
    the L1 = 1 / L2 = 2 extrapolation gives the 4-layer cell's flops and
    collective bytes exactly."""
    rec = dryrun.run_cell("olmo-1b", shape, "single", reduced=True,
                          mesh_shape=(1, 2), n_layers=4)
    roof = rec["roofline"]
    assert (roof["L1"], roof["L2"]) == (1, 2)
    assert roof["flops"] == rec["flops"]
    assert roof["coll"] == rec["collective_total"]
    assert roof["coll_by_kind"] == rec["collective_bytes"]
    np.testing.assert_allclose(roof["bytes"], rec["bytes_accessed"],
                               rtol=1e-12)


def test_the_counting_mode_returns_shapes_and_records():
    """Over counted groups: an all-reduce keeps its input's values, an
    all-gather gives n copies, ``reduce_scatter_mean`` the rank's slice
    of its input over n (the "sum" being the input); each recorded with its result bytes.  After the block
    the groups refuse."""
    mesh = describe_mesh((2, 2, 2), ("pod", "data", "model"), rank=5)
    with coll.counting(mesh) as (m, count):
        assert m.group(("pod", "data")).size == 4
        assert m.group(("pod", "data")).rank == mesh.index(("pod", "data"))
        x = torch.arange(8.0).reshape(2, 4)
        assert torch.equal(coll.all_reduce_sum(x, m.group("model")), x)
        g = coll.all_gather_cat(x, m.group("data"), dim=0)
        assert torch.equal(g, torch.cat([x, x]))
        r = coll.reduce_scatter_mean(x, m.group(("pod", "data")), 1)
        i = m.index(("pod", "data"))
        assert i == 2 and torch.equal(r, x[:, i:i + 1] / 4)
    assert count.bytes == {"all-reduce": 2 * 32, "all-gather": 64}
    assert count.calls == {"all-reduce": 2, "all-gather": 1}
    with pytest.raises(RuntimeError, match="after its counting run"):
        coll.all_reduce_sum(x, m.group("model"))


def _wrapper_calls(device: str):
    """Each hand-kernel wrapper with valid inputs on ``device``."""
    from repro_torch.kernels.attention import decode_attention
    from repro_torch.kernels.backends.gpu import plan_triton_gemv
    from repro_torch.kernels.gemv_plan import (
        plan_gemv,
        plan_grouped_stream,
        plan_quant,
        plan_ragged_stream,
        plan_splitk,
    )
    from repro_torch.kernels.grouped_gemv import grouped_gemv, ragged_gemv
    from repro_torch.kernels.pim_gemv import pim_gemv
    from repro_torch.kernels.quant_gemv import quant4_gemv, quant_gemv
    from repro_torch.kernels.splitk_gemv import splitk_gemv
    from repro_torch.kernels.triton_gemv import triton_gemv

    def r(*shape, dtype=torch.bfloat16):
        return torch.zeros(shape, dtype=dtype, device=device)

    codes = r(64, 128, dtype=torch.int8)
    codes4 = r(32, 128, dtype=torch.int8)
    scales = r(2, 128, dtype=torch.float32)
    pos = torch.full((2, 1), 5, dtype=torch.int64, device=device)
    return {
        "pim_gemv": (pim_gemv, (r(2, 64), r(64, 128)), dict(
            plan=plan_gemv(128, 64, 2, elem_bytes=2, sms=132))),
        "splitk_gemv": (splitk_gemv, (r(2, 64), r(64, 128)), dict(
            plan=plan_splitk(128, 64, 2, degree=2, elem_bytes=2, sms=132))),
        "quant_gemv": (quant_gemv, (r(2, 64), codes, scales), dict(
            block=32, plan=plan_quant(128, 64, 2, bits=8, elem_bytes=2,
                                      sms=132))),
        "quant4_gemv": (quant4_gemv, (r(2, 64), codes4, scales), dict(
            block=32, plan=plan_quant(128, 64, 2, bits=4, elem_bytes=2,
                                      sms=132))),
        "grouped_gemv": (grouped_gemv, (r(4, 8, 64), r(4, 64, 128)), dict(
            plan=plan_grouped_stream(128, 64, 8, E=4, sms=132,
                                     elem_bytes=2))),
        "ragged_gemv": (ragged_gemv, (
            r(8, 64), torch.tensor([0, 3, 5, 5, 8], dtype=torch.int32,
                                   device=device), r(4, 64, 128)), dict(
            plan=plan_ragged_stream(128, 64, 8, E=4, sms=132,
                                    elem_bytes=2))),
        "triton_gemv": (triton_gemv, (r(2, 64), r(64, 128)), dict(
            plan=plan_triton_gemv(128, 64, 2))),
        "decode_attention": (decode_attention, (
            r(2, 1, 4, 64), r(2, 16, 2, 64), r(2, 16, 2, 64)), dict(
            q_positions=pos, kv_valid_len=torch.full(
                (2,), 6, dtype=torch.int64, device=device))),
    }


WRAPPERS = ["pim_gemv", "splitk_gemv", "quant_gemv", "quant4_gemv",
            "grouped_gemv", "ragged_gemv", "triton_gemv",
            "decode_attention"]


@pytest.mark.parametrize("name", WRAPPERS)
def test_a_wrapper_runs_its_plain_version_on_meta_never_on_cuda(name):
    """On meta tensors a wrapper gives its plain version's shape and
    dtype (the CPU's) and launches nothing; on (fake) CUDA tensors it
    goes to its kernel (here, with no build to load, it raises) and
    never returns the plain version."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels._build import runs_plain

    fn, args, kw = _wrapper_calls("cpu")[name]
    want = fn(*args, **kw)
    counter = getattr(fn, "launches", None)
    fn, args, kw = _wrapper_calls("meta")[name]
    got = fn(*args, **kw)
    assert got.device.type == "meta"
    assert (got.shape, got.dtype) == (want.shape, want.dtype)
    assert getattr(fn, "launches", None) == counter
    with FakeTensorMode():
        fn, args, kw = _wrapper_calls("cuda")[name]
        assert not runs_plain(name, args[0])
        with pytest.raises(Exception) as err:
            fn(*args, **kw)
    assert "has no backward" not in str(err.value)


def test_a_decode_cell_through_the_dispatcher_on_meta():
    """``--gemv-backend h100`` on a decode cell: the dispatcher picks as
    on the card and every wrapper runs its plain version on meta."""
    rec = _cell("decode_32k", "1x2", gemv_backend="h100")
    assert rec["status"] == "ok"
    assert rec["gemv_dispatch"] and rec["gemv_fused"]
    assert rec["flops"] > 0


def test_serve_trace_writes_its_record(tmp_path):
    assert dryrun.main(["--serve-trace", "--device", "cpu", "--arch",
                        "olmo-1b", "--serve-policies", "fcfs",
                        "--out", str(tmp_path)]) == 0
    doc = json.loads((tmp_path / "serving"
                      / "olmo-1b__serve_trace.json").read_text())
    assert [run["policy"] for run in doc["runs"]] == ["fcfs"]
    assert doc["runs"][0]["completed"] > 0


def test_all_cells_of_the_reduced_configs(tmp_path):
    """``--all --mesh both --continue-on-error`` over the reduced configs:
    one record a reference cell, every applicable one ``ok`` with real
    flops, bytes and collective bytes, the full-attention long_500k cells
    ``skipped`` with the reference's reason; no error record."""
    assert dryrun.main(["--all", "--mesh", "both", "--continue-on-error",
                        "--reduced", "--no-roofline",
                        "--out", str(tmp_path)]) == 0
    recs = [json.loads(p.read_text()) for p in tmp_path.glob("*.json")]
    assert len(recs) == len(TORCH_ARCHS) * len(shapes.SHAPES) * 2
    for rec in recs:
        cfg = dryrun.dryrun_config(rec["arch"], reduced=True)
        ok, why = jshapes.applicable(
            ARCHS[rec["arch"]].reduced(), jshapes.SHAPES[rec["shape"]])
        if not ok:
            assert (rec["status"], rec["reason"]) == ("skipped", why)
            continue
        assert rec["status"] == "ok", rec.get("error")
        assert rec["flops"] > 0 and rec["bytes_accessed"] > 0
        assert rec["collective_total"] > 0
        assert rec["model_params"] == cfg.param_count()
        assert rec["n_chips"] == (512 if rec["mesh"] == "multi" else 256)
