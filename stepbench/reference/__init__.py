"""Plain references of the apps the benchmark runs: torch and numpy only,
nothing of the port."""
