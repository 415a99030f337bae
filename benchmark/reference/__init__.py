"""The plain reference the benchmark holds the program's outputs against.
It imports numpy and torch only: nothing of ``neojax_torch``, ``neojax``
or ``jax``."""
