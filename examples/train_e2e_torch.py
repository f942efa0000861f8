"""End-to-end training with the PyTorch port: an OLMo-family model trained
on the synthetic stream with checkpointing and fault-tolerant resume (the
twin of ``examples/train_e2e.py``).

    python examples/train_e2e_torch.py                 # ~110M, on the card
    python examples/train_e2e_torch.py --tiny          # reduced config
    PYTHONPATH=src python examples/train_e2e_torch.py --tiny --device cpu

The full variant is the same code at d_model=768, n_layers=12, vocab=32k
(~110M params).  Without ``--device`` it runs on the card and raises
where there is none.
"""

import argparse
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--batch", type=int, default=8,
                    help="global batch of --tiny")
    ap.add_argument("--seq", type=int, default=128,
                    help="sequence length of --tiny")
    args, _ = ap.parse_known_args(argv)
    resolve_device(args.device)     # no card and no --device: raise here

    # a fresh checkpoint dir a run: a stale one would make the launcher
    # resume past --steps and train nothing
    ckpt_dir = tempfile.mkdtemp(
        prefix="repro_torch_e2e_tiny_" if args.tiny
        else "repro_torch_e2e_100m_")
    if args.tiny:
        argv = [
            "--arch", "olmo-1b", "--smoke",
            "--steps", str(args.steps or 30),
            "--batch", str(args.batch), "--seq", str(args.seq),
            "--ckpt-dir", ckpt_dir, "--ckpt-every", "10",
        ]
    else:
        # ~110M params: 12 layers x 768 with a 32k vocab (olmo family)
        argv = [
            "--arch", "olmo-1b",
            "--d-model", "768", "--n-layers", "12",
            "--d-ff", "2048", "--vocab", "32768",
            "--steps", str(args.steps or 300),
            "--batch", "8", "--seq", "512",
            "--lr", "6e-4", "--accum", "2",
            "--ckpt-dir", ckpt_dir, "--ckpt-every", "50",
        ]
    if args.device:
        argv += ["--device", args.device]
    out = train_launcher.main(argv)
    losses = out["losses"]
    print(f"checkpoints {sorted(os.listdir(ckpt_dir))}")
    print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f})")
    assert losses[-1] < losses[0], "training must reduce loss"
    # removed only on success: a failed run keeps its checkpoints
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    return out


if __name__ == "__main__":
    main()
