"""The benchmark of the PyTorch and CUDA port (`repro_torch`).

`python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell; `portbench/README.md` says how cells,
configurations, traffic mixes and per-layer metrics are found by name.
Importing this package imports nothing: `run.py` sets the environment
before torch is loaded.
"""
