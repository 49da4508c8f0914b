"""The benchmark of ``mega_nerf_viewer_tpu_torch``, the PyTorch/CUDA port:
one command runs one cell once (``python3 perfbench/run.py --workload
<name> --seed <n> --seconds <s> --trace <0|1>``).  See ``run.py``."""
