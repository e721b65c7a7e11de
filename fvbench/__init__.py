"""The benchmark of `fastvocoder_tpu_torch` on the card.

`python -m fvbench.run --workload <cell> --seed <n> --seconds <s> --trace
<0|1>` runs one cell of `BENCHMARK.json` once and prints its result as the
last line of standard output.  Nothing here imports JAX or the JAX package.
"""

import importlib

# the discriminator's reference of a configuration that names none
DISC_REFERENCE = "discriminators"


def reference_of(cell):
    """The plain reference of a cell's generator, named by its configuration
    file's `reference`."""
    return importlib.import_module(f"fvbench.reference.{cell.config['reference']}")


def disc_reference_of(cell):
    """The plain reference of a cell's discriminator, named by its
    configuration file's `disc_reference` (`DISC_REFERENCE` where it names
    none).  Its draw has to come from another seed stream than the
    generator's."""
    disc = importlib.import_module(
        f"fvbench.reference.{cell.config.get('disc_reference', DISC_REFERENCE)}")
    # imported here: `fvbench.run` starts its set-up clock after this package
    # is imported, and `weights` imports torch
    from fvbench.weights import stream_of

    gen = reference_of(cell)
    if stream_of(disc) == stream_of(gen):
        raise ValueError(f"{gen.__name__} and {disc.__name__} share the seed stream "
                         f"{stream_of(gen)}: the generator and the discriminator would draw "
                         f"the same numbers")
    return disc
