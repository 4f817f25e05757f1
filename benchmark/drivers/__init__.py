"""Traffic drivers. A traffic file names its driver under "driver"; the
driver `Driver(cfg, traffic, seed, device, manifest, solver)` makes the
cell's inputs from the seed and runs them through `solver`: the program
(`benchmark.program`), or in the control's and the tests' runs a stand-in
with the same interface. Its methods: `setup()` (build and warm up),
`item(i)` (one timed request or step), `end_to_end(window_s)`,
`context()` (what the per-layer readers need), `release()` (drop the
program's state) and `numbers()` (the comparison with the reference)."""
