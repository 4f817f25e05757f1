"""Percent of the columns the multifrontal Cholesky factored in the run
that lay in wide fronts (program counters `_chol_mf_values.wide_front_cols`
over `_chol_mf_values.cols`, kept on
`rsparse_tpu_torch.factor.frontal._chol_mf_values`): the share of the
factor planned as dense fronts of a supernode's own width. A program
without the counters, or one that factored nothing on that route, reads
None."""


def read(r):
    from rsparse_tpu_torch.factor import frontal

    counted = getattr(frontal, "_chol_mf_values", None)
    wide = getattr(counted, "wide_front_cols", None)
    cols = getattr(counted, "cols", None)
    if wide is None or not cols:
        return None
    return 100.0 * wide / cols
