"""The benchmark of `rsparse_tpu_torch` on one NVIDIA H100.

`python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` once and prints one JSON
result line. Everything that belongs to one configuration, traffic mix,
per-layer metric or cell sits in a file of its own, found by its name:

- `configs/<config>.json`: the matrix (generator and sizes), the solver
  family, the precision the answers are held to and the plain reference;
- `generators/<generator>.py`: makes a configuration's CSC arrays from a seed;
- `traffic/<traffic>.json`: a traffic mix's parameters, read by the driver
  it names, `drivers/<driver>.py`;
- `metrics/<metric>.py`: the reader of one per-layer metric (or of the
  quantity that `<quantity>.<qualifier>` metrics share);
- `limits/<cell>.json`: the limits of the numbers that decide `correct`;
- `reference/<reference>.py`: a plain solver that works the answers out again.

Nothing here imports `jax` or the JAX package `rsparse_tpu`.
"""
