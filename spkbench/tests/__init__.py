"""CPU tests of the benchmark (``python -m pytest spkbench/tests`` from the
repo root); the test marked ``cuda`` runs the cells on a card."""
