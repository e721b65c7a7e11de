"""The benchmark of `fastvocoder_tpu_torch` on the card.

`python -m fvbench.run --workload <cell> --seed <n> --seconds <s> --trace
<0|1>` runs one cell of `BENCHMARK.json` once and prints its result as the
last line of standard output.  Nothing here imports JAX or the JAX package.
"""

import importlib


def reference_of(cell):
    """The plain reference of a cell's configuration, named by its file."""
    return importlib.import_module(f"fvbench.reference.{cell.config['reference']}")
