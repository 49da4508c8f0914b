"""The benchmark's own tests: ``python -m pytest perfbench/tests -q``.
Tests marked ``cuda`` need a CUDA card and skip without one (decided
inside each test)."""

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "cuda: needs a CUDA device; skips without one")


def tiny(workload: str):
    """The cell's configuration and mix cut to a CPU test's size: 64x48
    frames, a depth-5 shell or a depth-6 aerial tree; every other setting
    is the cell's."""
    from perfbench import registry
    wl = registry.workload(registry.benchmark(ROOT), workload)
    cfg = copy.deepcopy(registry.config(wl["config"]))
    mix = copy.deepcopy(registry.traffic(wl["traffic"]))
    cfg["render"] = {"width": 64, "height": 48, "focal": 37.0}
    if cfg["scene"]["generator"] == "aerial_field":
        cfg["scene"]["depth"] = 6
        cfg["viewer"]["max_tree_capacity"] = 20000
    else:
        cfg["scene"]["depth"] = 5
    mix["keep_from"] = 4
    return cfg, mix


@pytest.fixture
def cache_root(tmp_path):
    """A checkout-like root whose ``build/perfbench`` holds the scenes,
    and the repository's ``BENCHMARK.json``."""
    import shutil
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    return str(tmp_path)
