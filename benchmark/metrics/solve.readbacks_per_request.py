"""The refinement's host reads of max|r| per request (program counter
`refine.readbacks`, kept on `rsparse_tpu_torch.solve._amax.readbacks`,
over the run's `serve.request` spans): each read empties the card's
queue."""

from benchmark import spans


def read(r):
    return spans.readbacks_per_request()
