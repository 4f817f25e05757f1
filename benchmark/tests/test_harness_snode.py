"""CPU tests of `sptrsv.supernodal_per_request`: the supernodal sweeps per
serve request, read from the program's counter over its `serve.request`
spans, and None from a program without the counter."""

from types import SimpleNamespace

from benchmark import manifest as manifest_mod

MAN = manifest_mod.Manifest()
NAME = "sptrsv.supernodal_per_request"


def test_reader_counts_per_request(monkeypatch):
    from rsparse_tpu_torch import utils
    from rsparse_tpu_torch.ops.sptrsv_cuda import sptrsv_multi

    read = MAN.metric(NAME).read
    utils.reset_metrics()
    monkeypatch.setattr(sptrsv_multi, "supernodal", 0)
    assert read(SimpleNamespace()) is None  # no request yet
    for _ in range(4):
        with utils.phase_timer("serve.request"):
            sptrsv_multi.supernodal += 6
    assert read(SimpleNamespace()) == 6.0
    monkeypatch.delattr(sptrsv_multi, "supernodal")  # a program without it
    assert read(SimpleNamespace()) is None
    utils.reset_metrics()


def test_manifest_lists_it_for_the_main_cell():
    m = [x for x in MAN.spec["per_layer"] if x["name"] == NAME]
    assert len(m) == 1 and m[0]["workloads"] == ["lap2d-256.serve-b128"]
    names = [x["name"] for x in MAN.per_layer("lap2d-256.serve-b128")]
    assert NAME in names
    assert NAME not in [x["name"] for x in MAN.per_layer("cd2d-128.serve-b128")]
