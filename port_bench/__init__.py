"""The benchmark of the PyTorch and CUDA port, ``aicity_action_tpu_torch``:
``python -m port_bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` (see :mod:`port_bench.run`)."""
