"""Error taxonomy.

Mirrors the reference's `Error` enum (reference: src/lib.rs:188-205):
`NotPositiveDefinite` raised by Cholesky (src/lib.rs:325-328), `NoPivot`
raised by LU (src/lib.rs:584-586). Device factorizations signal failure
through a scalar (the smallest pivot, or a pivot margin) read back once,
and the caller raises the corresponding Python exception.
"""


class RsparseError(Exception):
    """Base class for rsparse_tpu_torch numerical errors."""


class NotPositiveDefiniteError(RsparseError):
    def __str__(self) -> str:  # message parity with src/lib.rs:200
        base = (
            "Could not complete Cholesky factorization. "
            "Please provide a positive definite matrix"
        )
        # batched raises (cholsol_vals) attach detail; argless raises keep
        # the reference's exact message
        return base if not self.args else f"{base} ({self.args[0]})"


class NoPivotError(RsparseError):
    def __str__(self) -> str:  # message parity with src/lib.rs:199
        return "Could not find a pivot"
