"""The benchmark of the PyTorch and CUDA port visionx_slam_torch: run one
cell with ``python3 slambench/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` (see run.py)."""
