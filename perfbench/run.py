#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the card of this machine.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  The cell (``BENCHMARK.json``'s
``workloads``) names its configuration and traffic mix; everything else
is found by those names under ``perfbench/``.  The measured program is
``mega_nerf_viewer_tpu_torch``, driven through its ``Viewer``.

The last line on standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device`` and, traced,
``breakdown``; last, ``checked``: each number the output comparison
holds beside its limit.  The same numbers end standard error.

Exits 1 with no result without a CUDA card (or with fewer cards than the
cell asks for), or if a module of JAX or of the JAX package was loaded.
Build outputs and caches stay in the checkout: the kernels in
``build/kernels``, the native loader in ``build/native``, the scene files
in ``build/perfbench``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(ROOT, "build", sub)
    # the checkout's root in place of this script's folder, whose modules
    # (trace, check, ...) would shadow the standard library's
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [ROOT] + [p for p in sys.path
                            if os.path.abspath(p or ".") != here]
    import torch
    from perfbench import harness, registry

    wl = registry.workload(registry.benchmark(ROOT), args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(wl["chips"]):
        print(f"perfbench: the cell needs {wl['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " available", file=sys.stderr)
        return 1
    print(f"# card: {harness.power_limit()}", file=sys.stderr, flush=True)

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    result, lines = harness.run_cell(
        args.workload, args.seed, args.seconds, bool(args.trace),
        device="cuda", t_start=T_START, root=ROOT, log=log)
    bad = harness.forbidden_modules()
    if bad:
        log(f"perfbench: modules of JAX or of the JAX package were loaded: "
            f"{bad}")
        return 1
    for line in lines:
        log(line)
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
