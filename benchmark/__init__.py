"""The benchmark of ``boundplanner_tpu_torch`` on an NVIDIA H100 (see
``README.md``; one run: ``python benchmark/run.py --workload <name> --seed
<n> --seconds <s> --trace <0|1>``)."""
