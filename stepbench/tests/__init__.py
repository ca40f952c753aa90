"""CPU tests of the benchmark (and, marked ``cuda``, its control on the card)."""
