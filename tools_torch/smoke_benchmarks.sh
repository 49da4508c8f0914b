#!/bin/bash
# CPU smoke of the port's entry points: bench_torch.py, every
# benchmarks_torch/ script (see benchmarks_torch/_overrides_torch.py) and
# the three motion probes of tools_torch/, at small sizes under
# BENCH_FORCE_CPU=1, where each runs the kernels' plain PyTorch versions.
# It catches latent crashes from code changes before a run on the card.
# Numbers are meaningless by design; each JSON line carries "smoke": true.
#
# The sizes and arguments are tools/smoke_benchmarks.sh's.  Left out: the
# gather probe (python -m mega_nerf_viewer_tpu_torch.probes.gather_probe),
# the counterpart of benchmarks/dma_gather_probe.py 12.  It measures the
# card's row gathers, takes no request for the CPU and raises without a
# card.
#
# Usage, from anywhere: bash tools_torch/smoke_benchmarks.sh
# Prints SMOKE FAILURE on stderr for each command that fails and exits 1
# if any did.
set -u
cd "$(dirname "$0")/.." || exit 1
export BENCH_FORCE_CPU=1
fail=0
run() {
  echo "=== $*"
  if ! timeout 900 "$@"; then
    echo "SMOKE FAILURE: $*" >&2
    fail=1
  fi
}
BENCH_WH=128x72             run python bench_torch.py 5
BENCH_WH=160x90 BENCH_DEPTH=5 run python benchmarks_torch/motion1080p.py 4 3
BENCH_WH=160x90 BENCH_DEPTH=5 run python benchmarks_torch/motion_guided1080p.py 3 3 16
BENCH_WH=160x90 BENCH_DEPTH=5 run python benchmarks_torch/motion_guided1080p.py 3 3 16 4
BENCH_WH=160x96 BENCH_DEPTH=5 run python benchmarks_torch/guided1080p.py 16
BENCH_WH=160x96 BENCH_DEPTH=5 run python benchmarks_torch/foveated1080p.py 4 4 3
BENCH_WH=256x144 BENCH_DEPTH=5 run python benchmarks_torch/orbit4k.py 3
BENCH_DEPTH=5               run python benchmarks_torch/refine_throughput.py 2
run python benchmarks_torch/parity.py 200
BENCH_WH=160x90 BENCH_DEPTH=5 run python tools_torch/motion_phase_timing.py
BENCH_WH=160x90 BENCH_DEPTH=5 run python tools_torch/motion_viewer_probe.py
BENCH_WH=160x90 BENCH_DEPTH=5 run python tools_torch/probe_motion_margin.py 5
exit $fail
