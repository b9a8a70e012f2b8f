"""The benchmark of the PyTorch/CUDA port (`nvsr_tpu_torch`).

`python gpubench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json on the card it is started
on. Everything that belongs to one configuration, traffic mix or metric
is a file of its own, found by its name: configs/<config>.json,
traffic/<mix>.json (whose "driver" names the loop in drivers/),
limits/<cell>.json and metrics/<metric>.py.
"""
