"""A cell, a configuration, a traffic mix and a per-layer metric are
added as files alone and found by name; nothing lists them."""

import json
import shutil

from portbench import spec


def test_new_files_are_found_by_name(tmp_path):
    root = tmp_path / "bench"
    for kind in ("configs", "traffic", "cells", "metrics"):
        (root / kind).mkdir(parents=True)
    cfg = dict(spec.read_json("configs", "deepseek-coder-33b"),
               name="tiny-dense", num_hidden_layers=3)
    (root / "configs" / "tiny-dense.json").write_text(json.dumps(cfg))
    # a new traffic kind (its module) and a mix that uses it
    (root / "traffic" / "burst.py").write_text(
        "def make(params, seed, vocab, clients):\n"
        "    return ('burst', params['size'], seed, vocab, clients)\n")
    (root / "traffic" / "bursty.json").write_text(
        json.dumps({"kind": "burst", "size": 7}))
    (root / "cells" / "tiny.bursty.fp8.json").write_text(json.dumps(
        {"config": "tiny-dense", "traffic": "bursty", "policy": "fp8",
         "why": "a test"}))
    (root / "metrics" / "queue_wait_ms.py").write_text(
        "def read(w):\n    return 2.5 * w\n")
    cell = spec.load_cell("tiny.bursty.fp8", root)
    assert cell.model.n_layers == 3 and cell.body["policy"] == "fp8"
    kind = spec.load_module("traffic", cell.traffic["kind"], root)
    assert kind.make(cell.traffic, 9, 10, 2) == ("burst", 7, 9, 10, 2)
    assert spec.load_module("metrics", "queue_wait_ms", root).read(2) == 5.0
    # BENCHMARK.json's entries choose which metrics a cell reports
    bench = {"per_layer": [
        {"name": "queue_wait_ms", "workloads": ["tiny.bursty.fp8"]},
        {"name": "decode_rows_mean", "workloads": ["other"]},
        {"name": "everywhere"}]}
    assert [m["name"] for m in spec.metric_entries(
        bench, "per_layer", "tiny.bursty.fp8")] == ["queue_wait_ms",
                                                   "everywhere"]


def test_every_committed_piece_is_found():
    with open(spec.ROOT.parent / "BENCHMARK.json") as f:
        bench = json.load(f)
    for c in bench["workloads"]:
        cell = spec.load_cell(c["name"])
        assert cell.body["config"] == c["config"]
        assert cell.body["traffic"] == c["traffic"]
        spec.load_module("traffic", cell.traffic["kind"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.load_module("metrics", m["name"]).read)
    for c in bench["configs"]:
        assert (spec.ROOT.parent / c["file"]).is_file()
        assert spec.read_json("configs", c["name"])["reduced"] == c["reduced"]


def test_unknown_names_are_refused(tmp_path):
    import pytest

    with pytest.raises(ValueError):
        spec.load_cell("no.such.cell")
    with pytest.raises(ValueError):
        spec.read_json("configs", "../escape")
    shutil.rmtree(tmp_path)
