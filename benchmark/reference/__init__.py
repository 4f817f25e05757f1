"""Plain reference solvers: torch operations only, nothing of the program."""
