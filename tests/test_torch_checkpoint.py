"""Checkpoints, fault recovery and the training launcher of the port, on
the CPU (the counterparts of ``test_system.py``'s checkpoint / restart
tests, and ``examples/train_e2e_torch.py --tiny``).

The checkpoint layout is the reference's (``step_<N>/``, one ``.npy`` a
leaf, ``manifest.json``): a checkpoint the port writes from the
reference's tree is restored by the reference's ``CheckpointManager``,
bit for bit.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.launch import train as launcher  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.train.fault_tolerance import (  # noqa: E402
    FaultInjector,
    StragglerMonitor,
    run_with_recovery,
)
from repro_torch.train.optimizer import OptConfig  # noqa: E402
from repro_torch.train.train_step import (  # noqa: E402
    TrainConfig,
    build_train_step,
)
from repro_torch.tree import leaves  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _setup(arch="olmo-1b", steps=20):
    cfg = get_config(arch).reduced()
    tcfg = TrainConfig(opt=OptConfig(name=cfg.optimizer, lr=1e-2,
                                     warmup_steps=2, total_steps=steps))
    step, opt_init = build_train_step(cfg, tcfg)
    params = lm.init_lm(cfg, seed=0, device="cpu")
    return cfg, step, params, opt_init(params)


def _equal(a, b) -> bool:
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def test_checkpoint_roundtrip_keeps_every_leaf_and_dtype(tmp_path):
    """Params, the optimizer state (its int32 step on the CPU), a bf16
    leaf (saved as its uint16 bits with dtype "bfloat16") and the
    metadata come back bit for bit, each on its template's device."""
    cfg, _, params, opt = _setup()
    tree = {"params": params, "opt": opt,
            "half": torch.randn(3, 5, generator=torch.Generator()
                                .manual_seed(0)).to(torch.bfloat16)}
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(7, tree, metadata={"k": 1})
    restored, meta = mgr.restore(tree)
    assert meta == {"k": 1}
    assert _equal(tree, restored)
    d = tmp_path / "step_0000000007"
    manifest = json.loads((d / "manifest.json").read_text())
    by = {e["path"]: e for e in manifest["leaves"]}
    assert by["half"]["dtype"] == "bfloat16"
    assert np.load(d / by["half"]["file"]).dtype == np.uint16
    assert by["opt/step"] == {"path": "opt/step", "file": by["opt/step"]
                              ["file"], "shape": [], "dtype": "int32"}
    assert "params/layers/0/attn/wq" in by
    with pytest.raises(KeyError):
        mgr.restore({**tree, "extra": torch.zeros(1)})


def test_checkpoint_async_atomic_and_gc(tmp_path):
    _, _, params, _ = _setup()
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"p": params}, blocking=False)
    mgr.wait()
    assert mgr.all_steps() == [3, 4]       # keep=2, published dirs only
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))
    # a torn write (a .tmp left by a preempted writer) is never listed
    os.makedirs(tmp_path / "step_0000000009.tmp")
    assert mgr.latest_step() == 4
    restored, _ = mgr.restore({"p": params})
    assert _equal(restored["p"], params)


def test_async_writer_error_surfaces_on_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"), keep=2)
    mgr.save(1, {"x": torch.zeros(2)}, blocking=False)
    mgr.wait()
    # the directory goes away under the writer: the error comes at wait()
    mgr.dir = str(tmp_path / "missing" / "deeper")
    open(tmp_path / "missing", "w").close()
    mgr.save(2, {"x": torch.zeros(2)}, blocking=False)
    with pytest.raises(OSError):
        mgr.wait()


def test_the_reference_restores_what_the_port_wrote(tmp_path):
    """The port's manager writes the reference's layout: the reference's
    ``CheckpointManager`` restores a checkpoint of the reference's tree
    (``bridge.params_to_numpy``) that the port saved, bit for bit."""
    jax = pytest.importorskip("jax")
    from repro.checkpoint.manager import CheckpointManager as JaxManager
    from repro.configs.registry import ARCHS
    from repro.models import lm as jlm
    from repro_torch.bridge import params_from_numpy, params_to_numpy

    jcfg, tcfg = ARCHS["gemma3-1b"].reduced(), get_config(
        "gemma3-1b").reduced()
    jp = jax.tree.map(np.asarray, jlm.init_lm(jax.random.PRNGKey(0), jcfg))
    tree = params_to_numpy(params_from_numpy(jp, tcfg, "cpu"), tcfg)

    def as_tensors(node):
        if isinstance(node, dict):
            return {k: as_tensors(v) for k, v in node.items()}
        return None if node is None else torch.as_tensor(node)

    CheckpointManager(str(tmp_path)).save(3, as_tensors(tree))
    restored, _ = JaxManager(str(tmp_path)).restore(jp)
    a = jax.tree_util.tree_flatten_with_path(jp)[0]
    b = jax.tree_util.tree_flatten_with_path(restored)[0]
    assert [p for p, _ in a] == [p for p, _ in b]
    assert all(np.array_equal(np.asarray(x), np.asarray(y))
               for (_, x), (_, y) in zip(a, b))


def test_fault_recovery_resumes_and_replays(tmp_path):
    """Injected faults restore the latest checkpoint; the step-addressed
    data makes the replayed steps give the same losses, bit for bit
    (``test_system.py::test_fault_recovery_resumes_and_replays``)."""
    cfg, step, params, opt = _setup(steps=20)
    data = SyntheticLM(cfg, DataConfig(global_batch=4, seq_len=32))
    mgr = CheckpointManager(str(tmp_path), keep=3)
    state = {"params": params, "opt": opt}
    injector = FaultInjector(fail_at={7, 13})
    seen = {}

    def do_step(i):
        injector.maybe_fail(i)
        state["params"], state["opt"], m = step(state["params"],
                                                state["opt"],
                                                data.batch_at(i))
        seen.setdefault(i, []).append(float(m["loss"]))
        return {k: float(v) for k, v in m.items()}

    def save(i):
        mgr.save(i, state, blocking=True)

    def restore():
        s = mgr.latest_step()
        if s is None:
            return 0
        restored, _ = mgr.restore(state)
        state.update(restored)
        return s

    stats = run_with_recovery(n_steps=20, do_step=do_step, save=save,
                              restore=restore, ckpt_every=5, max_restarts=5)
    assert stats.restarts == 2 and stats.restored_steps == [5, 10]
    assert mgr.latest_step() == 20
    assert {i for i, v in seen.items() if len(v) > 1} == {5, 6, 10, 11, 12}
    for i, vals in seen.items():
        assert all(v == vals[0] for v in vals), (i, vals)


def test_recovery_gives_up_after_max_restarts():
    with pytest.raises(RuntimeError, match="injected fault at step 2"):
        run_with_recovery(
            n_steps=5, do_step=lambda i: FaultInjector({i}).maybe_fail(i)
            if i == 2 else {}, save=lambda i: None, restore=lambda: 0,
            ckpt_every=1, max_restarts=1)


def test_straggler_monitor_flags_outliers():
    mon = StragglerMonitor(alpha=0.5, threshold=2.0, warmup=2)
    for i in range(10):
        assert not mon.record(i, 0.1)
    assert mon.record(10, 0.5)
    assert mon.flagged[-1][0] == 10
    # the baseline does not take the straggler in
    assert not mon.record(11, 0.12)


def _argv(ckpt, *extra):
    return ["--arch", "olmo-1b", "--smoke", "--steps", "12", "--batch", "4",
            "--seq", "32", "--ckpt-every", "5", "--ckpt-dir", str(ckpt),
            "--device", "cpu", *extra]


def test_launcher_recovers_to_the_uninterrupted_params(tmp_path, capsys):
    """``launch.train.main`` with a fault at step 7: it restores step 5,
    replays, and ends with the params and optimizer state of a run with
    no fault, bit for bit; the losses fall."""
    faulted = launcher.main(_argv(tmp_path / "a"), fail_at=(7,))
    clean = launcher.main(_argv(tmp_path / "b"))
    assert faulted["stats"].restarts == 1
    assert faulted["stats"].restored_steps == [5]
    assert _equal(faulted["params"], clean["params"])
    assert _equal(faulted["opt"], clean["opt"])
    assert clean["losses"][-1] < clean["losses"][0]
    assert len(clean["step_s"]) == 12
    assert "done: 12 steps" in capsys.readouterr().out
    # a rerun over the finished checkpoint trains nothing
    again = launcher.main(_argv(tmp_path / "b"))
    assert again["losses"] == [] and _equal(again["params"],
                                            clean["params"])


def test_restore_right_after_a_non_blocking_save_returns_the_loaded_step(
        tmp_path, monkeypatch):
    """The launcher's restore (``launch.train.restore_latest``) waits for
    the writer before it reads the latest step: right after a
    non-blocking save of step 4 whose files are still being written, it
    loads step 4's state and returns 4 (reading the step first, as the
    reference does, would return 2 with step 4's state loaded)."""
    import threading
    import time

    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, {"w": torch.full((3,), 2.0)})
    write, started = mgr._write, threading.Event()

    def slow_write(*a):
        started.set()
        time.sleep(0.3)
        write(*a)

    monkeypatch.setattr(mgr, "_write", slow_write)
    mgr.save(4, {"w": torch.full((3,), 4.0)}, blocking=False)
    started.wait()
    assert mgr.latest_step() == 2       # step 4 is not published yet
    state = {"w": torch.zeros(3)}
    assert launcher.restore_latest(mgr, state) == 4
    assert torch.equal(state["w"], torch.full((3,), 4.0))


def test_launcher_accumulates_and_compresses(tmp_path):
    out = launcher.main(["--arch", "deepseek-moe-16b", "--smoke", "--steps",
                         "2", "--batch", "4", "--seq", "16", "--accum", "2",
                         "--grad-compress", "bf16", "--ckpt-every", "10",
                         "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))


def test_entry_points_raise_without_a_card(tmp_path):
    """With no ``--device`` on a host without CUDA the launcher and the
    example raise; ``--device cpu`` runs them."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launcher.main(_argv(tmp_path)[:-2] + ["--steps", "1"])
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    out = subprocess.run([sys.executable, "examples/train_e2e_torch.py",
                          "--tiny", "--steps", "1"], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=300)
    assert out.returncode != 0 and "no CUDA device" in out.stderr


def test_example_tiny_runs_on_the_cpu():
    """The example at 2 x 32 for 11 steps on one intra-op thread: the
    checkpoint of step 10 (one every 10) is written, and the loss
    falls."""
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
           "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, "examples/train_e2e_torch.py",
                          "--tiny", "--steps", "11", "--batch", "2",
                          "--seq", "32", "--device", "cpu"],
                         capture_output=True, text=True, cwd=REPO, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "'step_0000000010'" in out.stdout.split("checkpoints")[-1]
    assert "final loss" in out.stdout
