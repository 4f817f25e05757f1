"""Sweeps launched on the supernodal variant of the sweep kernel per request
(program counter `sptrsv_multi.supernodal`, kept on
`rsparse_tpu_torch.ops.sptrsv_cuda.sptrsv_multi`, over the run's
`serve.request` spans): a request whose sweeps all take the supernodal
schedule reads the sweeps it makes. A program without the counter reads
None."""

from benchmark import spans


def read(r):
    from rsparse_tpu_torch.ops.sptrsv_cuda import sptrsv_multi

    count = getattr(sptrsv_multi, "supernodal", None)
    req = spans._phases().get("serve.request")
    if count is None or not req or not req["calls"]:
        return None
    return count / req["calls"]
