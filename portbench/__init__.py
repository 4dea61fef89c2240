"""The benchmark of dfs_tpu_torch: cells, metrics and bounds in
``BENCHMARK.json``, the yardstick (traffic, reference, work counts, peaks,
the comparison that decides ``correct``) here. Run one cell with
``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout."""
