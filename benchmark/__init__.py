"""The benchmark of the PyTorch and CUDA port (`potato_tpu_torch`): whole
frames through `render()`, held against a plain PyTorch reference. Run one
cell with `python3 benchmark/run.py --workload <name> --seed <n> --seconds
<s> --trace <0|1>` from the root of the repository, on a machine with a
CUDA card."""
