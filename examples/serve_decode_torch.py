"""Serving example for the PyTorch port: continuous-batching decode through
the port's ``Engine``, the GEMV-dominated regime the paper targets (the
twin of ``examples/serve_decode.py``).

Runs on the CUDA card; ``--device cpu`` serves on the CPU instead, with
the kernels' plain versions.  ``--trace-out TRACE.json`` flight-records
the run (``repro_torch.observability``): a Perfetto-loadable Chrome trace
and its summary (``TRACE.summary.json``), each fresh dispatch decision
priced and timed on the run's device.

    python examples/serve_decode_torch.py
    PYTHONPATH=src python examples/serve_decode_torch.py --device cpu \\
        --requests 3 --slots 2 --new-tokens 4 --trace-out TRACE.json
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.observability import export  # noqa: E402
from repro_torch.observability.trace import (  # noqa: E402
    Tracer,
    uninstall_tracer,
)
from repro_torch.serving.engine import Engine, Request  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--new-tokens", type=int, default=12)
    ap.add_argument("--policy", default="fcfs",
                    choices=("fcfs", "sjf", "gemv_aware"))
    ap.add_argument("--device", default=None,
                    help="device to serve on (default: the card)")
    ap.add_argument("--trace-out", metavar="PATH", default=None,
                    help="write the run's Chrome trace here, its summary "
                         "beside it")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch).reduced()
    params = lm.init_lm(cfg, seed=0, device=dev)
    tracer = Tracer(timing=True) if args.trace_out else None
    eng = Engine(cfg, params, batch_slots=args.slots, max_len=96,
                 scheduler=args.policy, device=dev, tracer=tracer)

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    try:
        for i in range(args.requests):
            # mixed prompt lengths: the slot-managed cache decodes them in
            # one batch with per-slot positions
            plen = int(rng.integers(4, 17))
            eng.submit(Request(
                rid=i,
                prompt=rng.integers(0, cfg.vocab, plen).astype(np.int32),
                max_new_tokens=args.new_tokens))
        done = eng.run_until_drained()
    finally:
        if tracer is not None:
            uninstall_tracer(tracer)
    dt = time.perf_counter() - t0
    total_tokens = sum(len(r.generated) for r in done)
    print(f"{len(done)} requests, {total_tokens} tokens in {dt:.2f}s "
          f"({total_tokens / dt:.1f} tok/s on {dev}, {args.slots} slots, "
          f"{args.policy})")
    m = eng.metrics.to_dict(include_steps=False)
    print(f"  ttft p50={m['ttft_ms'].get('p50', 0):.0f}ms "
          f"p99={m['ttft_ms'].get('p99', 0):.0f}ms | per-token "
          f"p50={m['per_token_ms'].get('p50', 0):.1f}ms | dispatch "
          f"gemv={m['dispatch']['gemv_path']} "
          f"matmul={m['dispatch']['matmul_fallback']}")
    for r in done[:3]:
        print(f"  req {r.rid}: {r.generated}")
    if tracer is not None:
        export.write_chrome_trace(tracer, args.trace_out)
        spath = export.summary_path(args.trace_out)
        drift = export.write_summary(tracer, spath)["drift"]
        print(f"  flight trace {args.trace_out}, summary {spath}: "
              f"{len(tracer.spans)} spans, {drift['n_dispatches']} dispatch "
              f"decisions ({drift['n_timed']} timed on {dev})")


if __name__ == "__main__":
    main()
