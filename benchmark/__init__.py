"""The benchmark of ``emqx_tpu_torch``: one cell a run, as ``BENCHMARK.json``
names them; ``python benchmark/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the repository's root."""
