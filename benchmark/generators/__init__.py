"""Matrix generators: `make(params, rng)` returns (n, p, i, x), a square
CSC matrix as numpy arrays with the rows ascending in each column."""
