"""CPU tests of the benchmark (``python -m pytest port_bench/tests``); the
test marked ``cuda`` runs a cell on a GPU and skips without one."""
